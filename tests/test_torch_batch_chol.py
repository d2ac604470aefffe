"""Kernel K1 of the PyTorch port (hyperbo_tpu_torch/ops/batch_chol.py)
against the JAX package's batched Cholesky inverse (ops/pallas_batch_chol).

The JAX side runs its plain XLA reference (impl='xla'), which is the same
custom VJP the Mosaic kernel sits in; tests/test_batch_chol.py holds the
Mosaic kernel (interpret mode) equal to it. The port's CPU path is its
plain PyTorch version; the CUDA kernel itself is compared with it on the
card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: B = L^{-T} within atol 5e-6, the bound tests/test_batch_chol.py
uses for the same float32 factorization; the NLL value within rtol 1e-6 and
its gradients within atol 5e-6, the bounds of the JAX package's own value
and gradient check of nll_terms_batched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.ops import pallas_batch_chol as pbc
from hyperbo_tpu_torch.ops import batch_chol as tbc
from torch_threads import one_torch_thread  # noqa: F401


def _spd_batch(seed, t, n):
  """(t, n, n) float32 SPD batch, exactly symmetric."""
  a = np.random.default_rng(seed).normal(size=(t, n, n))
  k = a @ np.swapaxes(a, -1, -2) / n + 2.0 * np.eye(n)
  return (0.5 * (k + np.swapaxes(k, -1, -2))).astype(np.float32)


def _sweep(k):
  """The CUDA kernel's algorithm (csrc/batch_chol.cu): the outer-product
  sweep over the stacked [K; I] blocked by 32-column panels, through its
  float64 mirror ops/batch_chol.py linv_t_steps."""
  return tbc.linv_t_steps(torch.from_numpy(k)[None])[0].numpy()


@pytest.mark.parametrize('n', [40, 100, 128])
def test_linv_t_plain_matches_jax(n):
  kb = _spd_batch(n, 3, n)
  want = jax.jit(pbc._linv_t_xla)(jnp.asarray(kb))
  got = tbc.batched_linv_t(torch.from_numpy(kb))
  assert got.shape == (3, n, n)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6)


def test_kernel_sweep_matches_plain():
  """The kernel's sweep, run in float64, is the exact L^{-T}."""
  kb = _spd_batch(1, 2, 33).astype(np.float64)
  want = tbc.linv_t_plain(torch.from_numpy(kb)).numpy()
  for i in range(2):
    np.testing.assert_allclose(_sweep(kb[i]), want[i], atol=1e-12)


def test_nll_terms_value_and_grad_match_jax():
  t, n = 3, 64
  kb = _spd_batch(2, t, n)
  delta = np.random.default_rng(3).normal(size=(t, n, 1)).astype(np.float32)

  def f_jax(kb, delta):
    q, ld = pbc.nll_terms_batched(kb, delta, 'xla', False)
    return jnp.sum(0.5 * q + ld)

  v_jax, g_jax = jax.jit(jax.value_and_grad(f_jax, argnums=(0, 1)))(
      jnp.asarray(kb), jnp.asarray(delta))
  kb_t = torch.from_numpy(kb).requires_grad_(True)
  delta_t = torch.from_numpy(delta).requires_grad_(True)
  q, ld = tbc.nll_terms_batched(kb_t, delta_t)
  v_t = torch.sum(0.5 * q + ld)
  g_t = torch.autograd.grad(v_t, (kb_t, delta_t))
  np.testing.assert_allclose(float(v_t.detach()), float(v_jax), rtol=1e-6)
  for a, b in zip(g_t, g_jax):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-6)


def test_non_pd_gives_nan_in_both_packages():
  kb = _spd_batch(8, 2, 32)
  kb[1] -= 10.0 * np.eye(32, dtype=np.float32)   # task 1 indefinite
  delta = np.random.default_rng(9).normal(size=(2, 32, 1)).astype(
      np.float32)
  q_j, ld_j = jax.jit(lambda k, d: pbc.nll_terms_batched(k, d, 'xla', False))(
      jnp.asarray(kb), jnp.asarray(delta))
  q_t, ld_t = tbc.nll_terms_batched(torch.from_numpy(kb),
                                    torch.from_numpy(delta))
  for q, ld in ((np.asarray(q_j), np.asarray(ld_j)),
                (q_t.numpy(), ld_t.numpy())):
    assert np.isfinite(q[0]) and np.isfinite(ld[0])
    assert not (np.isfinite(q[1]) and np.isfinite(ld[1]))
  assert torch.isnan(tbc.batched_linv_t(torch.from_numpy(kb))[1]).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
  with pytest.raises(ValueError):
    tbc.batched_linv_t(torch.zeros((2, 129, 129)))
  with pytest.raises(ValueError):
    tbc.batched_linv_t(torch.zeros((2, 4, 5)))
  # Neither CPU nor CUDA: no silent plain path.
  with pytest.raises(ValueError):
    tbc.batched_linv_t(torch.zeros((2, 4, 4), device='meta'))
  with pytest.raises(ValueError):
    tbc.launch_linv_t(torch.eye(4)[None])

