"""Tests of the PyTorch port that need a CUDA card (marker `cuda`).

They import no JAX, because the machine with the card has none; run them
there with

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test here skips. Tolerances: B = L^{-T} within atol
1e-5 of the float64 plain version (a float32 sweep of at most 128 steps);
the NLL terms' value within rtol 1e-6 and gradients within atol 1e-5; a
training step's loss within rtol 1e-4 of the CPU's (float32 sums in
another order on another device). The fused large-n kernels K2-K4 against
their float64 plain versions: L within atol 5e-4 (tests/test_pallas_chol.py),
quad and logdet within rtol 1e-4 (tests/test_objectives.py:313), T, P and
the two backward scalars within 5e-3 of their largest entry (bench.py:540,
the gradient parity bound). The dense-Cholesky kernels K6 and K7 against
their float64 plain versions: atol 5e-4 (tests/test_pallas_chol.py); the
model evaluation through them within rtol 1e-4 of the cuSOLVER route for
the NLL and the partial EKL, and 1e-3 for the full EKL, whose whitened
covariance amplifies the factorizations' float32 rounding. The joint
backward K8 against its float64 plain version and against the K3 + alpha +
K4 route on the card: d_x, alpha and the two scalars within 5e-3 of their
largest entry (the gradient parity bound). The Gram kernel K5 against its
float64 plain version within atol 2e-5 sv (tests/test_pallas_gram.py).
"""

import numpy as np
import pytest
import torch

from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
from hyperbo_tpu_torch.models import gp, kernel, mean
from hyperbo_tpu_torch.ops import batch_chol
from hyperbo_tpu_torch.ops import bwd_joint
from hyperbo_tpu_torch.ops import chol as chol_ops
from hyperbo_tpu_torch.ops import chol_hbm
from hyperbo_tpu_torch.ops import chol_panel
from hyperbo_tpu_torch.ops import fused_gram
from hyperbo_tpu_torch.ops import fused_mll
from hyperbo_tpu_torch.ops import mll_bwd
from hyperbo_tpu_torch.ops import tri_inv


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card')
  return torch.device('cuda', 0)


def _spd_batch(seed, t, n):
  a = np.random.default_rng(seed).normal(size=(t, n, n))
  k = a @ np.swapaxes(a, -1, -2) / n + 2.0 * np.eye(n)
  return torch.from_numpy(
      (0.5 * (k + np.swapaxes(k, -1, -2))).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize('t,n', [(23, 100), (3, 128), (5, 37), (2, 1)])
def test_kernel_matches_plain(cuda_device, t, n):
  kb = _spd_batch(t * n, t, n)
  before = batch_chol.KERNEL.launches
  got = batch_chol.batched_linv_t(kb.to(cuda_device))
  torch.cuda.synchronize()
  assert batch_chol.KERNEL.launches == before + 1
  want = batch_chol.linv_t_plain(kb.double())
  np.testing.assert_allclose(got.cpu().double().numpy(), want.numpy(),
                             atol=1e-5)


@pytest.mark.cuda
def test_kernel_gives_nan_for_non_pd(cuda_device):
  kb = _spd_batch(1, 2, 32)
  kb[1] -= 10.0 * torch.eye(32)
  b = batch_chol.batched_linv_t(kb.to(cuda_device)).cpu()
  assert torch.isfinite(b[0]).all() and not torch.isfinite(b[1]).all()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
  kb = _spd_batch(2, 2, 8).to(cuda_device)
  with pytest.raises(TypeError):
    batch_chol.batched_linv_t(kb.double())
  with pytest.raises(ValueError, match='contiguous'):
    batch_chol.batched_linv_t(kb.transpose(-1, -2))
  with pytest.raises(ValueError, match='n <= 128'):
    batch_chol.batched_linv_t(torch.eye(129, device=cuda_device)[None])


@pytest.mark.cuda
def test_nll_terms_value_and_grad(cuda_device):
  kb = _spd_batch(3, 23, 100)
  delta = torch.from_numpy(
      np.random.default_rng(4).normal(size=(23, 100, 1)).astype(np.float32))
  out = []
  for k, d in ((kb.to(cuda_device), delta.to(cuda_device)),
               (kb.double(), delta.double())):
    k, d = k.clone().requires_grad_(True), d.clone().requires_grad_(True)
    q, ld = batch_chol.nll_terms_batched(k, d)
    total = torch.sum(0.5 * q + ld)
    grads = torch.autograd.grad(total, (k, d))
    out.append((float(total.detach()),
                [g.cpu().double().numpy() for g in grads]))
  np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
  for a, b in zip(out[0][1], out[1][1]):
    np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.cuda
def test_training_runs_through_the_kernel(cuda_device):
  """GP.train on the card launches K1 once per step, and its loss trace
  matches the same training on the CPU (full batches, same parameters)."""
  rng = np.random.default_rng(5)
  data = {i: (rng.uniform(size=(60, 3)).astype(np.float32),
              rng.normal(size=(60, 1)).astype(np.float32)) for i in range(4)}
  init = None
  traces = []
  for device in ('cpu', cuda_device):
    model = gp.GP(data, mean.linear_mlp, kernel.squared_exponential_mlp,
                  defs.GPParams(
                      model={'constant': 0., 'lengthscale': 0.,
                             'signal_variance': 0., 'noise_variance': -3.},
                      config={'method': 'adam', 'learning_rate': 1e-2,
                              'max_training_step': 6, 'batch_size': 64,
                              'objective': 'nll', 'mlp_features': (4, 4),
                              'checkpoint_every': 1}),
                  DEFAULT_WARP_FUNC, device=device)
    if init is not None:  # the CPU run's parameters, kept as they are
      model.update_model_params(convert.model_from_jax(init, device))
    model.initialize_params(torch.Generator().manual_seed(0))
    init = convert.model_to_numpy(model.params.model)
    before = batch_chol.KERNEL.launches
    losses = []
    model.train(callback=lambda s, m, l: losses.append(float(l)))
    traces.append(losses)
  assert batch_chol.KERNEL.launches - before == 6
  np.testing.assert_allclose(traces[1], traces[0], rtol=1e-4)


def _fused_inputs(seed, n, d, n_valid, device, dtype):
  """x (n, d), y (n, 1), sv, da and the valid mask (None when all rows
  are valid), with padded rows zero."""
  rng = np.random.default_rng(seed)
  x = np.zeros((n, d))
  y = np.zeros((n, 1))
  x[:n_valid] = rng.uniform(size=(n_valid, d)) * 2.0
  y[:n_valid] = rng.normal(size=(n_valid, 1))
  opts = dict(dtype=dtype, device=device)
  valid = None
  if n_valid < n:
    valid = torch.tensor((np.arange(n) < n_valid).astype(np.float64), **opts)
  return (torch.tensor(x, **opts), torch.tensor(y, **opts),
          torch.tensor(1.3, **opts), torch.tensor(0.11, **opts), valid)


def _max_rel(got, want):
  return float((got.double().cpu() - want.double().cpu()).abs().max() /
               want.double().abs().max().cpu())


@pytest.mark.cuda
@pytest.mark.parametrize('n,d,n_valid,kfam', [(512, 4, 512, 'se'),
                                              (704, 3, 700, 'matern32')])
def test_fused_kernels_match_plain(cuda_device, n, d, n_valid, kfam):
  """K2, K3 and K4 against their float64 plain versions; K3 and K4 each on
  the float32 rounding of the plain version's input."""
  x, y, sv, da, v = _fused_inputs(n, n, d, n_valid, cuda_device,
                                  torch.float32)
  x64, y64, sv64, da64, v64 = _fused_inputs(n, n, d, n_valid, cuda_device,
                                            torch.float64)
  counts = [k.KERNEL.launches for k in (fused_mll, tri_inv, mll_bwd)]
  chol, quad, ld = fused_mll.mll_fused(x, y, sv, da, kfam, v)
  chol64, quad64, ld64 = fused_mll.mll_fused_plain(x64, y64, sv64, da64,
                                                   kfam, v64)
  np.testing.assert_allclose(chol.cpu().numpy(), chol64.cpu().numpy(),
                             atol=5e-4)
  np.testing.assert_allclose(float(quad), float(quad64), rtol=1e-4)
  np.testing.assert_allclose(float(ld), float(ld64), rtol=1e-4)
  l_in = chol64.float().contiguous()
  t = tri_inv.tri_inv(l_in)
  t64 = tri_inv.tri_inv_plain(l_in.double())
  assert _max_rel(t, t64) <= 5e-3
  t_in = t64.float().contiguous()
  alpha = tri_inv.alpha_from_inverse(t64, y64).float().contiguous()
  p, dsv, dda = mll_bwd.mll_bwd_fused(t_in, x, alpha, sv, kfam, v)
  p64, dsv64, dda64 = mll_bwd.mll_bwd_plain(t_in.double(), x64,
                                            alpha.double(), sv64, kfam, v64)
  assert _max_rel(p, p64) <= 5e-3
  np.testing.assert_allclose(float(dsv), float(dsv64), rtol=5e-3)
  np.testing.assert_allclose(float(dda), float(dda64), rtol=5e-3)
  torch.cuda.synchronize()
  assert [k.KERNEL.launches for k in (fused_mll, tri_inv, mll_bwd)] == [
      c + 1 for c in counts]


@pytest.mark.cuda
def test_fused_core_gives_nan_for_non_pd(cuda_device):
  x, y, sv, _, _ = _fused_inputs(6, 512, 4, 512, cuda_device, torch.float32)
  args = [x.requires_grad_(True), y.requires_grad_(True),
          sv.requires_grad_(True),
          torch.tensor(-0.5, device=cuda_device, requires_grad=True)]
  val = fused_mll.fused_nll_core(*args)
  assert bool(torch.isnan(val))
  for g in torch.autograd.grad(val, args):
    assert bool((torch.isnan(g) | (g == 0)).all())


@pytest.mark.cuda
def test_fused_wrappers_reject_what_they_do_not_take(cuda_device):
  x, y, sv, da, _ = _fused_inputs(7, 128, 2, 128, cuda_device,
                                  torch.float32)
  eye = torch.eye(128, device=cuda_device)
  cases = [
      (fused_mll.launch_mll_fused, (x.double(), y, sv, da), TypeError),
      (fused_mll.launch_mll_fused, (x.cpu(), y, sv, da), ValueError),
      (fused_mll.launch_mll_fused, (x.T.contiguous().T, y, sv, da),
       ValueError),
      (tri_inv.launch_tri_inv, (eye.double(),), TypeError),
      (tri_inv.launch_tri_inv, (eye.cpu(),), ValueError),
      (tri_inv.launch_tri_inv, (eye.t(),), ValueError),
      (mll_bwd.launch_mll_bwd, (eye.double(), x, y, sv), TypeError),
      (mll_bwd.launch_mll_bwd, (eye.cpu(), x, y, sv), ValueError),
      (mll_bwd.launch_mll_bwd, (eye.t(), x, y, sv), ValueError),
  ]
  for fn, args, err in cases:
    with pytest.raises(err):
      fn(*args)


@pytest.mark.cuda
def test_fused_training_runs_through_the_kernels(cuda_device):
  """GP.train with config['fused_mll'] on the card launches K2, K3 and K4
  once per task per step, and its loss trace matches the CPU's."""
  steps = 3
  rng = np.random.default_rng(8)
  data = {i: (rng.uniform(size=(n, 3)).astype(np.float32),
              rng.normal(size=(n, 1)).astype(np.float32))
          for i, n in enumerate((600, 530))}
  traces = []
  for device in ('cpu', cuda_device):
    model = gp.GP(data, mean.constant, kernel.squared_exponential,
                  defs.GPParams(
                      model={'constant': 0., 'lengthscale': 0.,
                             'signal_variance': 0., 'noise_variance': -2.},
                      config={'method': 'adam', 'learning_rate': 1e-2,
                              'max_training_step': steps,
                              'batch_size': 1024, 'objective': 'nll',
                              'fused_mll': True, 'checkpoint_every': 1}),
                  DEFAULT_WARP_FUNC, device=device)
    model.initialize_params(torch.Generator().manual_seed(0))
    before = [k.KERNEL.launches for k in (fused_mll, tri_inv, mll_bwd)]
    losses = []
    model.train(callback=lambda s, m, l: losses.append(float(l)))
    traces.append(losses)
  after = [k.KERNEL.launches for k in (fused_mll, tri_inv, mll_bwd)]
  assert [a - b for a, b in zip(after, before)] == [steps * 2] * 3
  np.testing.assert_allclose(traces[1], traces[0], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('module,t,n', [
    (chol_panel, 1, 1), (chol_panel, 1, 37), (chol_panel, 1, 300),
    (chol_panel, 1, 512), (chol_panel, 23, 100), (chol_hbm, 1, 1024),
    (chol_hbm, 2, 1024), (chol_hbm, 1, 2048)])
def test_dense_cholesky_kernels_match_plain(cuda_device, module, t, n):
  """K7 (chol_panel) and K6 (chol_hbm) against their float64 plain
  versions, one launch each; a non-PD matrix of the batch comes out NaN."""
  kb = _spd_batch(t + n, t, n).to(cuda_device)
  launch = (chol_panel.launch_chol_panel if module is chol_panel
            else chol_hbm.launch_chol_hbm)
  plain = (chol_panel.cholesky_panel_plain if module is chol_panel
           else chol_hbm.cholesky_hbm_plain)
  before = module.KERNEL.launches
  got = launch(kb)
  torch.cuda.synchronize()
  assert module.KERNEL.launches == before + 1
  np.testing.assert_allclose(got.cpu().double().numpy(),
                             plain(kb.double()).cpu().numpy(), atol=5e-4)
  bad = kb.clone()
  bad[-1, -1, -1] = -5.0
  got = launch(bad).cpu()
  assert torch.isnan(got[-1]).all()
  assert torch.isfinite(got[:-1]).all()


@pytest.mark.cuda
def test_stats_runs_through_the_dense_cholesky_kernels(cuda_device):
  """GP.stats() on the card through K6 and through the recursion with K7
  base cases launches them and agrees with the cuSOLVER route."""
  rng = np.random.default_rng(11)
  x = rng.uniform(size=(1024, 3)).astype(np.float32)
  w = rng.normal(size=(3, 6))
  y = (np.sin(3 * x @ w) + 0.1 * rng.normal(size=(1024, 6))).astype(
      np.float32)
  data = {'plain': (x[:200], y[:200, :1]),
          'aligned': defs.SubDataset(x, y, 'aligned')}
  model = gp.GP(data, mean.constant, kernel.squared_exponential,
                defs.GPParams(model={'constant': 0., 'lengthscale': 0.,
                                     'signal_variance': 0.,
                                     'noise_variance': -3.},
                              config={'objective': 'nll'}),
                DEFAULT_WARP_FUNC, device=cuda_device)
  model.initialize_params(torch.Generator(device=cuda_device).manual_seed(0))
  want = [float(v) for v in model.stats(verbose=False)[:4]]
  for setters, kern in (
      ((chol_ops.set_use_hbm_kernel,), chol_hbm.KERNEL),
      ((chol_ops.set_use_recursive, chol_ops.set_use_pallas_base),
       chol_panel.KERNEL)):
    before = kern.launches
    try:
      for setter in setters:
        setter(True)
      got = [float(v) for v in model.stats(verbose=False)[:4]]
    finally:
      for setter in setters:
        setter(False)
    assert kern.launches > before
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3)
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('n,d,n_valid,kfam', [(512, 4, 512, 'se'),
                                              (704, 3, 700, 'matern32')])
def test_joint_backward_matches_plain_and_route(cuda_device, n, d, n_valid,
                                                kfam):
  """K8 on the float32 rounding of the float64 factor, against its float64
  plain version and against K3 + alpha + K4 on the same input: one launch,
  the same adjoints; a NaN in L gives NaN adjoints."""
  x, y, sv, da, v = _fused_inputs(n, n, d, n_valid, cuda_device,
                                  torch.float32)
  x64, y64, sv64, da64, v64 = _fused_inputs(n, n, d, n_valid, cuda_device,
                                            torch.float64)
  chol64, _, _ = fused_mll.mll_fused_plain(x64, y64, sv64, da64, kfam, v64)
  l_in = chol64.float().contiguous()
  before = bwd_joint.KERNEL.launches
  got = bwd_joint.mll_bwd_joint(l_in, x, y, sv, kfam, v)
  torch.cuda.synchronize()
  assert bwd_joint.KERNEL.launches == before + 1
  want = bwd_joint.mll_bwd_joint_plain(l_in.double(), x64, y64, sv64, kfam,
                                       v64)
  t = tri_inv.tri_inv(l_in)
  alpha = tri_inv.alpha_from_inverse(t, y).contiguous()
  p, dsv, dda = mll_bwd.mll_bwd_fused(t, x, alpha, sv, kfam, v)
  route = (2.0 * (p[:, :d] - p[:, d:] * x), alpha, dsv, dda)
  for a, b, c in zip(got, want, route):
    assert _max_rel(a, b) <= 5e-3
    assert _max_rel(a, c) <= 5e-3
  bad = l_in.clone()
  bad[-1, 0] = float('nan')
  for out in bwd_joint.mll_bwd_joint(bad, x, y, sv, kfam, v):
    assert bool(torch.isnan(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['se', 'matern32', 'matern52'])
def test_gram_kernel_matches_plain(cuda_device, kind):
  """K5 through its three entry points at ragged shapes and d up to 40 (two
  feature chunks), against the float64 plain version: one launch each, the
  (n1, n2) shape exactly."""
  rng = np.random.default_rng(12)
  sv, ridge = 0.9, 0.05
  for n1, n2, d in ((70, 70, 4), (41, 17, 1), (1000, 333, 40)):
    x1 = torch.tensor(rng.normal(size=(n1, d)), dtype=torch.float32)
    x2 = torch.tensor(rng.normal(size=(n2, d)), dtype=torch.float32)
    ls = torch.tensor(rng.uniform(0.5, 2.0, size=d), dtype=torch.float32)
    calls = [
        lambda a, b, s: fused_gram.cross_gram(a, b, s, sv, kind),
        lambda a, b, s: fused_gram.gram(a / s, b / s, sv, ridge, kind),
    ]
    if n1 == n2:
      calls.append(lambda a, b, s: fused_gram.gram_with_ridge(a, s, sv, ridge,
                                                              kind))
    for call in calls:
      before = fused_gram.KERNEL.launches
      got = call(x1.to(cuda_device), x2.to(cuda_device), ls.to(cuda_device))
      torch.cuda.synchronize()
      assert fused_gram.KERNEL.launches == before + 1
      assert got.shape == (n1, n2)
      want = call(x1.double(), x2.double(), ls.double())
      np.testing.assert_allclose(got.cpu().double().numpy(), want.numpy(),
                                 atol=2e-5 * sv)


@pytest.mark.cuda
def test_fused_training_with_the_joint_switch(cuda_device, monkeypatch):
  """GP.train with config['fused_mll'] and HYPERBO_BWD_JOINT=1 launches K2
  and K8 once per task per step and K3 and K4 never, and its loss trace is
  the one without the switch."""
  steps = 3
  rng = np.random.default_rng(8)
  data = {i: (rng.uniform(size=(n, 3)).astype(np.float32),
              rng.normal(size=(n, 1)).astype(np.float32))
          for i, n in enumerate((600, 530))}
  modules = (fused_mll, tri_inv, mll_bwd, bwd_joint)
  traces, counts = [], []
  for flag in ('0', '1'):
    monkeypatch.setenv('HYPERBO_BWD_JOINT', flag)
    model = gp.GP(data, mean.constant, kernel.squared_exponential,
                  defs.GPParams(
                      model={'constant': 0., 'lengthscale': 0.,
                             'signal_variance': 0., 'noise_variance': -2.},
                      config={'method': 'adam', 'learning_rate': 1e-2,
                              'max_training_step': steps,
                              'batch_size': 1024, 'objective': 'nll',
                              'fused_mll': True, 'checkpoint_every': 1}),
                  DEFAULT_WARP_FUNC, device=cuda_device)
    model.initialize_params(torch.Generator().manual_seed(0))
    before = [m.KERNEL.launches for m in modules]
    losses = []
    model.train(callback=lambda s, m, l: losses.append(float(l)))
    traces.append(losses)
    counts.append([m.KERNEL.launches - b for m, b in zip(modules, before)])
  assert counts == [[steps * 2] * 3 + [0], [steps * 2, 0, 0, steps * 2]]
  np.testing.assert_allclose(traces[1], traces[0], rtol=1e-4)
