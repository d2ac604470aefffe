"""Kernels K3 and K4's plain versions in the PyTorch port
(hyperbo_tpu_torch/ops/tri_inv.py and mll_bwd.py) against the JAX
package's Pallas kernels in interpret mode on the CPU, and the fused core's
non-PD and device contracts. K2's test, the helpers and the tolerances are
in test_torch_fused_mll.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.ops import pallas_mll_bwd
from hyperbo_tpu.ops import pallas_triinv
from hyperbo_tpu_torch.ops import fused_mll
from hyperbo_tpu_torch.ops import mll_bwd
from hyperbo_tpu_torch.ops import tri_inv
from test_torch_fused_mll import DA, SV, _factor, _inputs


def _jax_tri_inv_dense(l):
  tpm = np.asarray(pallas_triinv.tri_inv_panels(jnp.asarray(l),
                                                interpret=True))
  nb, n, b = tpm.shape
  return tpm, np.transpose(tpm, (1, 0, 2)).reshape(n, n)


@pytest.fixture(scope='module')
def factor_and_inverse():
  """An n = 512 factor, the JAX kernel's panel-major inverse and its dense
  form (one interpreted K3 trace for the module)."""
  x, y = _inputs(1, 512, 4)
  l = _factor(x)
  tpm, t_dense = _jax_tri_inv_dense(l)
  return x, y, l, tpm, t_dense


def test_k3_plain_matches_jax_kernel(factor_and_inverse):
  _, _, l, _, t_j = factor_and_inverse
  t_t = tri_inv.tri_inv(torch.from_numpy(l)).numpy()
  assert np.all(np.triu(t_t, 1) == 0)
  np.testing.assert_allclose(t_t, t_j, atol=1e-5 * np.abs(t_j).max())
  # The Hopper kernel's block substitution, given diag_inverses, is the
  # same inverse (run here in float64 on the float32 factor).
  l64 = torch.from_numpy(l).double()
  dinv = tri_inv.diag_inverses(l64)
  nb, b = dinv.shape[0], dinv.shape[1]
  t = torch.zeros_like(l64)
  for j in range(nb):
    t[j * b:(j + 1) * b, j * b:(j + 1) * b] = dinv[j]
    for i in range(j + 1, nb):
      acc = l64[i * b:(i + 1) * b, j * b:i * b] @ t[j * b:i * b,
                                                     j * b:(j + 1) * b]
      t[i * b:(i + 1) * b, j * b:(j + 1) * b] = -dinv[i] @ acc
  np.testing.assert_allclose(t.numpy(), tri_inv.tri_inv_plain(l64).numpy(),
                             atol=1e-10 * float(t.abs().max()))


@pytest.mark.parametrize('masked', [False, True])
def test_k4_plain_matches_jax_kernel(factor_and_inverse, masked):
  x, y, _, tpm, t_dense = factor_and_inverse
  n, d = x.shape
  valid = None
  if masked:
    valid = (np.arange(n) < n - 100).astype(np.float32)
    x = x * valid[:, None]
  alpha = (t_dense.T @ (t_dense @ y)).astype(np.float32)
  dx_j, dsv_j, dda_j = pallas_mll_bwd.mll_bwd_fused(
      jnp.asarray(tpm), jnp.asarray(x), jnp.asarray(alpha), SV,
      valid=None if valid is None else jnp.asarray(valid), interpret=True)
  xt = torch.from_numpy(x)
  p, dsv_t, dda_t = mll_bwd.mll_bwd_fused(
      torch.from_numpy(t_dense), xt, torch.from_numpy(alpha),
      torch.tensor(SV), 'se', None if valid is None else
      torch.from_numpy(valid))
  assert p.shape == (n, d + 1)
  dx_t = (2.0 * (p[:, :d] - p[:, d:] * xt)).numpy()
  dx_j = np.asarray(dx_j)
  assert np.max(np.abs(dx_t - dx_j)) <= 3e-3 * np.abs(dx_j).max() + 1e-5
  # The interpreted kernel's own d_sv_raw errs 2.6e-3 against float64 on
  # this input (the plain version 9e-5), so the scalars are held to the
  # gradient bound of bench.py:540 against JAX, and to rtol 1e-4 against
  # the float64 plain version.
  np.testing.assert_allclose(float(dsv_t), float(dsv_j), rtol=5e-3)
  np.testing.assert_allclose(float(dda_t), float(dda_j), rtol=5e-3)
  _, dsv64, dda64 = mll_bwd.mll_bwd_plain(
      torch.from_numpy(t_dense).double(), xt.double(),
      torch.from_numpy(alpha).double(), torch.tensor(SV).double(), 'se',
      None if valid is None else torch.from_numpy(valid).double())
  np.testing.assert_allclose(float(dsv_t), float(dsv64), rtol=1e-4)
  np.testing.assert_allclose(float(dda_t), float(dda64), rtol=1e-4)


def test_non_pd_gives_nan():
  x, y = _inputs(6, 512, 4)
  args = [torch.from_numpy(x).requires_grad_(True),
          torch.from_numpy(y).requires_grad_(True),
          torch.tensor(SV, requires_grad=True),
          torch.tensor(-0.5, requires_grad=True)]
  val = fused_mll.fused_nll_core(*args)
  assert torch.isnan(val)
  for g in torch.autograd.grad(val, args):
    assert bool((torch.isnan(g) | (g == 0)).all())


def test_launch_wrappers_refuse_cpu_tensors():
  """A CPU tensor never reaches a kernel: the launch_* entry points raise
  before building anything."""
  x, y = (torch.from_numpy(a) for a in _inputs(7, 128, 2))
  sv, da = torch.tensor(SV), torch.tensor(DA)
  eye = torch.eye(128)
  with pytest.raises(ValueError, match='CUDA'):
    fused_mll.launch_mll_fused(x, y, sv, da)
  with pytest.raises(ValueError, match='CUDA'):
    tri_inv.launch_tri_inv(eye)
  with pytest.raises(ValueError, match='CUDA'):
    mll_bwd.launch_mll_bwd(eye, x, y, sv)
