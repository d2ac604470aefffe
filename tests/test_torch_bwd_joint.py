"""The joint fused-NLL backward of the PyTorch port (hyperbo_tpu_torch/ops/
bwd_joint.py, kernel K8) and its route under HYPERBO_BWD_JOINT, against the
JAX package on the CPU.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel
itself is held against that plain version, and against the K3 + alpha + K4
route, on the card (tests/test_torch_cuda.py and chip_smoke.py). The JAX
side runs pallas_bwd_joint.mll_bwd_joint in interpret mode at n = 512 with
its cheapest tile (one 128-row block a step), and the XLA chain of
pallas_mll._se_core_bwd for the Matern families.

Tolerances: the adjoints within the bounds tests/test_pallas_bwd_joint.py
holds the JAX kernel to (d_x within 2e-3 of its largest entry; alpha atol
1e-4, rtol 1e-3; d_sv atol 5e-3, rtol 1e-2; d_da rtol 1e-3). The route:
value and gradient with the switch on within rtol 1e-5 of the switch off
(on the CPU both run float32 plain versions of the same chain), and within
the bounds of tests/test_torch_fused_mll.py of the JAX package's dense
pipeline. Training: the loss traces with the switch on and off within rtol
1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.ops import pallas_bwd_joint
from hyperbo_tpu.ops import pallas_mll
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC as TWARP
from hyperbo_tpu_torch.models import gp as tgp
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.ops import bwd_joint
from hyperbo_tpu_torch.ops import fused_mll
from test_torch_fused_mll import (_assert_close_leaves, _flat,
                                  _jax_value_and_grad, _objective_case,
                                  _torch_value_and_grad)

SV, DA = 1.3, 0.5


def _problem(seed, kfam='se', n=512, d=3, masked=False):
  """x, delta, valid (None unmasked) and the float32 factor L of the
  (masked) Gram, as numpy; padded rows zero, as the route makes them."""
  rng = np.random.default_rng(seed)
  x = rng.uniform(size=(n, d)).astype(np.float32)
  delta = rng.normal(size=(n, 1)).astype(np.float32)
  valid = None
  if masked:
    valid = (np.arange(n) < int(0.78 * n)).astype(np.float32)
    x = x * valid[:, None]
    delta = delta * valid[:, None]
  chol, _, _ = fused_mll.mll_fused_plain(
      torch.from_numpy(x).double(), torch.zeros(n, 1, dtype=torch.float64),
      torch.tensor(SV, dtype=torch.float64),
      torch.tensor(DA, dtype=torch.float64), kfam,
      None if valid is None else torch.from_numpy(valid).double())
  return x, delta, valid, chol.float().numpy()


def _port(x, delta, valid, l, kfam):
  return bwd_joint.mll_bwd_joint(
      torch.from_numpy(l), torch.from_numpy(x), torch.from_numpy(delta),
      torch.tensor(SV), kfam, None if valid is None else
      torch.from_numpy(valid))


def _check(got, want_dx, want_alpha, want_dsv, want_dda):
  """tests/test_pallas_bwd_joint.py's _check; got is the port's, with its
  raw d_sv."""
  d_x, alpha, dsv_raw, d_da = (np.asarray(v) for v in got)
  want_dx = np.asarray(want_dx)
  sc = np.abs(want_dx).max() + 1e-8
  assert np.abs(d_x - want_dx).max() / sc < 2e-3
  np.testing.assert_allclose(alpha, np.asarray(want_alpha), atol=1e-4,
                             rtol=1e-3)
  np.testing.assert_allclose(float(dsv_raw) / SV, float(want_dsv), atol=5e-3,
                             rtol=1e-2)
  np.testing.assert_allclose(float(d_da), float(want_dda), rtol=1e-3)


@pytest.mark.parametrize('masked', [False, True])
def test_plain_matches_jax_kernel(masked):
  """Against the interpreted Pallas kernel, dense-L input, 128-row tiles."""
  x, delta, valid, l = _problem(7 if masked else 0, masked=masked)
  got = _port(x, delta, valid, l, 'se')
  d_x, alpha, dsv_raw, d_da = pallas_bwd_joint.mll_bwd_joint(
      jnp.asarray(l), jnp.asarray(x), jnp.asarray(delta), SV,
      None if valid is None else jnp.asarray(valid), block=128,
      ti_chunk=128, ti_rows=1, ti_group=1, sy_chunk=128, sy_rows=1,
      sy_group=1, panel_input=False, diag_transposed=False, interpret=True)
  _check(got, d_x, alpha, float(dsv_raw) / SV, d_da)


def test_matern_matches_jax_chain():
  """The Matern families against _se_core_bwd's XLA chain (the JAX joint
  kernel serves them the same way), Matern-5/2 masked."""
  for kfam, masked, seed in (('matern32', False, 1), ('matern52', True, 2)):
    x, delta, valid, l = _problem(seed, kfam, masked=masked)
    want = pallas_mll._se_core_bwd(
        jnp.asarray(l), jnp.asarray(x), jnp.asarray(delta), jnp.float32(SV),
        None if valid is None else jnp.asarray(valid), kfam,
        bwd_cfg=(False, 'gemm', 'high', '0'))
    _check(_port(x, delta, valid, l, kfam), *want)


def _count_joint_calls(monkeypatch):
  calls = []
  real = bwd_joint.mll_bwd_joint

  def spy(*args, **kwargs):
    calls.append(True)
    return real(*args, **kwargs)

  monkeypatch.setattr(bwd_joint, 'mll_bwd_joint', spy)
  return calls


def test_route_matches_switch_off_and_jax(monkeypatch):
  """objectives.neg_log_marginal_likelihood through the fused route at a
  ragged n (700 rows, padded to 704: the masked core) with the switch on:
  the joint backward runs, and value and gradient agree with the switch off
  and with the JAX package's dense pipeline."""
  x, y, model, _ = _objective_case('matern32', n=700, seed=3)
  monkeypatch.delenv('HYPERBO_BWD_JOINT', raising=False)
  off, goff = _torch_value_and_grad('matern32', x, y, model,
                                    {'fused_mll': True})
  calls = _count_joint_calls(monkeypatch)
  monkeypatch.setenv('HYPERBO_BWD_JOINT', '1')
  on, gon = _torch_value_and_grad('matern32', x, y, model,
                                  {'fused_mll': True})
  assert len(calls) == 1
  np.testing.assert_allclose(on, off, rtol=1e-5)
  for key, want in _flat(goff).items():
    np.testing.assert_allclose(_flat(gon)[key], want, rtol=1e-5, atol=1e-8)
  want, gwant = _jax_value_and_grad('matern32', x, y, model, {})
  np.testing.assert_allclose(on, want, rtol=1e-4)
  _assert_close_leaves(_flat(gon), _flat(gwant))


def test_train_with_switch_matches_switch_off(monkeypatch):
  """3 GP.train() steps through the fused route on two tasks: with the
  switch on, each step's backward runs the joint version once per task, and
  the loss trace is the one with the switch off."""
  steps = 3
  rng = np.random.default_rng(8)
  data = {i: (rng.uniform(size=(n, 3)).astype(np.float32),
              rng.normal(size=(n, 1)).astype(np.float32))
          for i, n in enumerate((600, 530))}
  calls = _count_joint_calls(monkeypatch)
  traces = []
  for flag in ('0', '1'):
    monkeypatch.setenv('HYPERBO_BWD_JOINT', flag)
    model = tgp.GP(data, tmean.constant, tkernel.squared_exponential,
                   tdefs.GPParams(
                       model={'constant': 0., 'lengthscale': 0.,
                              'signal_variance': 0., 'noise_variance': -2.},
                       config={'method': 'adam', 'learning_rate': 1e-2,
                               'max_training_step': steps,
                               'batch_size': 1024, 'objective': 'nll',
                               'fused_mll': True, 'checkpoint_every': 1}),
                   TWARP, device='cpu')
    model.initialize_params(torch.Generator().manual_seed(0))
    losses = []
    model.train(callback=lambda s, m, l: losses.append(float(l)))
    traces.append(losses)
  assert len(calls) == steps * len(data)
  assert len(traces[1]) == steps and traces[1][-1] < traces[1][0]
  np.testing.assert_allclose(traces[1], traces[0], rtol=1e-6)


def test_switch_off_by_default_and_unknown_values_raise(monkeypatch):
  """Unset or '0': the backward never reaches the joint version. Any other
  value raises at the backward, as the port's other switches do."""
  x, delta, _, _ = _problem(4)
  called = []
  monkeypatch.setattr(bwd_joint, 'mll_bwd_joint',
                      lambda *a, **k: called.append(True) or (_ for _ in ())
                      .throw(AssertionError('joint backward without opt-in')))

  def grads():
    args = [torch.from_numpy(x).requires_grad_(True),
            torch.from_numpy(delta).requires_grad_(True),
            torch.tensor(SV, requires_grad=True),
            torch.tensor(DA, requires_grad=True)]
    return torch.autograd.grad(fused_mll.fused_nll_core(*args), args)

  for flag in (None, '0'):
    if flag is None:
      monkeypatch.delenv('HYPERBO_BWD_JOINT', raising=False)
    else:
      monkeypatch.setenv('HYPERBO_BWD_JOINT', flag)
    assert all(bool(torch.isfinite(g).all()) for g in grads())
  assert not called
  for flag in ('', 'true', '2'):
    monkeypatch.setenv('HYPERBO_BWD_JOINT', flag)
    with pytest.raises(ValueError, match='HYPERBO_BWD_JOINT'):
      grads()


def test_launch_refuses_cpu_tensors():
  """A CPU tensor never reaches the kernel: launch_mll_bwd_joint raises
  before building anything."""
  x, delta, _, l = _problem(5, n=128)
  with pytest.raises(ValueError, match='CUDA'):
    bwd_joint.launch_mll_bwd_joint(torch.from_numpy(l), torch.from_numpy(x),
                                   torch.from_numpy(delta), torch.tensor(SV))
