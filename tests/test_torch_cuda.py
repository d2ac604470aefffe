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
the gradient parity bound), and K2's, K3's and K4's outputs bitwise equal
across two calls (one fixed-order sum per entry). The dense-Cholesky kernels K6
and K7 against their float64 plain versions: atol 5e-4
(tests/test_pallas_chol.py); the model evaluation through them within rtol
1e-4 of the cuSOLVER route for the NLL and the partial EKL, and 1e-3 for
the full EKL, whose whitened covariance amplifies the factorizations'
float32 rounding. The joint
backward K8 against its float64 plain version and against the K3 + alpha +
K4 route on the card: d_x, alpha and the two scalars within 5e-3 of their
largest entry (the gradient parity bound), and the T it computes bitwise
K3's (the same level bodies). The Gram kernel K5 against its
float64 plain version within atol 2e-5 sv (tests/test_pallas_gram.py).
The compile-once runners (train/adam.make_fit_adam_packed,
bo/ondevice.py) run under torch.cuda.set_sync_debug_mode('error'): no
read of the device inside a call; the packed runner's loss trace within
rtol 1e-4 of the CPU's on the same injected draws; the on-device BO's
selections equal the CPU's, and its q = 1 and retrain_steps = 0 runners
repeat the plain one bitwise. The HGP runners: the fixed-sample one free of
host syncs, picking as on the CPU and, with S identical samples, as the
plain runner; the re-sampling one launching K1 once per batched corpus
evaluation, its chain-batched corpus log prob within rtol 1e-4 of the
CPU's. Multi-start Adam's stacked systems: one K1 launch over every
restart's tasks bitwise the per-restart launches, the stacked NLL within
rtol 1e-6 of each restart alone; the fused route over a Kumar embedding
within value rtol 1e-4 and gradient max rel 5e-3 of float64. The
continuous BO runner free of host syncs, its points on the same pools
the CPU's (bitwise unrefined, within 1e-4 refined); the matrix-free NLL
on the card within value rtol 1e-4 and each gradient leaf within 1e-3 of
its largest entry of the CPU's, on the same probes.
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
@pytest.mark.parametrize('t,n', [(23, 100), (3, 128), (5, 37), (2, 1),
                                 (1, 31), (1, 32), (1, 33), (1, 64), (1, 65),
                                 (1, 127), (256, 100)])
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
def test_kernel_is_deterministic_and_symmetrizes(cuda_device):
  """Two calls bitwise equal; a batch that is not symmetric gives the
  plain version of 0.5 (K + K^T), which the kernel forms as it loads."""
  kb = _spd_batch(6, 23, 100).to(cuda_device)
  assert torch.equal(batch_chol.batched_linv_t(kb),
                     batch_chol.batched_linv_t(kb))
  skew = kb + 0.01 * torch.triu(torch.ones_like(kb), diagonal=1)
  got = batch_chol.batched_linv_t(skew)
  want = batch_chol.linv_t_plain(0.5 * (skew.double() + skew.double().mT))
  np.testing.assert_allclose(got.cpu().double().numpy(), want.cpu().numpy(),
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
                                              (704, 3, 700, 'matern32'),
                                              (5056, 8, 5000, 'se')])
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
def test_tri_inv_is_deterministic(cuda_device):
  """K3 sums every entry of T in one fixed order: two calls are bitwise
  equal (n = 2048: the 128 x 128 block tiles of the top levels)."""
  x, y, sv, da, _ = _fused_inputs(8, 2048, 4, 2048, cuda_device,
                                  torch.float64)
  l = fused_mll.mll_fused_plain(x, y, sv, da)[0].float().contiguous()
  assert torch.equal(tri_inv.tri_inv(l), tri_inv.tri_inv(l))


@pytest.mark.cuda
@pytest.mark.parametrize('n,d,n_valid,kfam', [(704, 3, 700, 'matern32'),
                                              (1216, 5, 1216, 'matern52')])
def test_fused_mll_is_deterministic(cuda_device, n, d, n_valid, kfam):
  """K2 sums every entry of L, and quad and logdet_half, in one fixed order
  (per-tile counters order its persistent launch, no atomics): two calls
  are bitwise equal, one wrapper launch each, and both hold to the float64
  plain version; 704 and 1216 rows end in a 64-wide tile row."""
  x, y, sv, da, v = _fused_inputs(n, n, d, n_valid, cuda_device,
                                  torch.float32)
  x64, y64, sv64, da64, v64 = _fused_inputs(n, n, d, n_valid, cuda_device,
                                            torch.float64)
  before = fused_mll.KERNEL.launches
  first = fused_mll.launch_mll_fused(x, y, sv, da, kfam, v)
  second = fused_mll.launch_mll_fused(x, y, sv, da, kfam, v)
  torch.cuda.synchronize()
  assert fused_mll.KERNEL.launches - before == 2
  assert all(torch.equal(a, b) for a, b in zip(first, second))
  chol64, quad64, ld64 = fused_mll.mll_fused_plain(x64, y64, sv64, da64,
                                                   kfam, v64)
  np.testing.assert_allclose(first[0].cpu().numpy(), chol64.cpu().numpy(),
                             atol=5e-4)
  np.testing.assert_allclose(float(first[1]), float(quad64), rtol=1e-4)
  np.testing.assert_allclose(float(first[2]), float(ld64), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('n,d,n_valid,kfam', [(64, 2, 64, 'matern52'),
                                              (192, 5, 150, 'se'),
                                              (320, 3, 320, 'se')])
def test_mll_bwd_is_deterministic(cuda_device, n, d, n_valid, kfam):
  """K4 on one 64-wide tile and on 3 and 5 of them (a 64-wide last tile of
  its 128 x 128 pairs): two calls bitwise equal, one wrapper launch each,
  both within 5e-3 of the float64 plain version."""
  x, y, sv, da, v = _fused_inputs(n, n, d, n_valid, cuda_device,
                                  torch.float64)
  t64 = tri_inv.tri_inv_plain(fused_mll.mll_fused_plain(x, y, sv, da, kfam,
                                                        v)[0])
  alpha64 = tri_inv.alpha_from_inverse(t64, y)
  args = [a.float().contiguous() for a in (t64, x, alpha64, sv)]
  v32 = None if v is None else v.float()
  before = mll_bwd.KERNEL.launches
  first = mll_bwd.mll_bwd_fused(*args, kfam, v32)
  second = mll_bwd.mll_bwd_fused(*args, kfam, v32)
  torch.cuda.synchronize()
  assert mll_bwd.KERNEL.launches - before == 2
  assert all(torch.equal(a, b) for a, b in zip(first, second))
  want = mll_bwd.mll_bwd_plain(*[a.double() for a in args], kfam,
                               None if v is None else v)
  for got, ref in zip(first, want):
    assert _max_rel(got, ref) <= 5e-3


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
    (chol_panel, 1, 1), (chol_panel, 1, 37), (chol_panel, 1, 64),
    (chol_panel, 1, 65), (chol_panel, 1, 300), (chol_panel, 1, 511),
    (chol_panel, 1, 512), (chol_panel, 23, 100), (chol_hbm, 1, 64),
    (chol_hbm, 1, 576), (chol_hbm, 1, 1024), (chol_hbm, 2, 1024),
    (chol_hbm, 1, 2048)])
def test_dense_cholesky_kernels_match_plain(cuda_device, module, t, n):
  """K7 (chol_panel) and K6 (chol_hbm) against their float64 plain
  versions, one launch each, two calls bitwise equal; a non-PD entry in the
  last block column of the middle matrix of a batch of three makes that
  matrix NaN, and only that one."""
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
  assert torch.equal(launch(kb), got)
  bad = _spd_batch(t + n + 1, 3, n).to(cuda_device)
  bad[1, -1, -1] = -5.0
  got = launch(bad).cpu()
  assert torch.isnan(got[1]).all()
  assert torch.isfinite(got[[0, 2]]).all()


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
def test_joint_backward_inverse_is_k3s_and_deterministic(cuda_device):
  """K8 at a ragged, masked 19-tile size (1200 rows padded to 1216: 128 x
  128 products at halves of 8 and 16 tiles, a short last merge): the T it
  leaves in its scratch is bitwise K3's, and two calls, one launch each,
  give bitwise equal outputs."""
  x, y, sv, da, v = _fused_inputs(14, 1216, 8, 1200, cuda_device,
                                  torch.float32)
  chol64, _, _ = fused_mll.mll_fused_plain(x.double(), y.double(),
                                           sv.double(), da.double(), 'se',
                                           v.double())
  l_in = chol64.float().contiguous()
  before = bwd_joint.KERNEL.launches
  # pylint: disable-next=protected-access
  first, t = bwd_joint._launch(l_in, x, y, sv, 'se', v)
  second = bwd_joint.mll_bwd_joint(l_in, x, y, sv, 'se', v)
  torch.cuda.synchronize()
  assert bwd_joint.KERNEL.launches == before + 2
  assert torch.equal(t, tri_inv.tri_inv(l_in))
  for a, b in zip(first, second):
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['se', 'matern32', 'matern52'])
def test_gram_kernel_matches_plain(cuda_device, kind):
  """K5 through its three entry points at ragged shapes, d up to 40 (two
  feature chunks) and rows 16-byte aligned (130 x 256), against the float64
  plain version: one launch each, the (n1, n2) shape exactly, and two calls
  bitwise equal."""
  rng = np.random.default_rng(12)
  sv, ridge = 0.9, 0.05
  for n1, n2, d in ((70, 70, 4), (41, 17, 1), (1000, 333, 40), (130, 256, 8)):
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
      assert torch.equal(got, call(x1.to(cuda_device), x2.to(cuda_device),
                                   ls.to(cuda_device)))
      want = call(x1.double(), x2.double(), ls.double())
      np.testing.assert_allclose(got.cpu().double().numpy(), want.numpy(),
                                 atol=2e-5 * sv)
  # sv and ridge as tensors on the card: read there, the same result.
  a, b = x1.to(cuda_device), x2.to(cuda_device)
  as_tensors = fused_gram.gram(a, b, torch.tensor(sv, device=cuda_device),
                               torch.tensor(ridge, device=cuda_device), kind,
                               add_ridge=True)
  assert torch.equal(as_tensors, fused_gram.gram(a, b, sv, ridge, kind,
                                                 add_ridge=True))


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


class _NoHostSync:
  """torch.cuda.set_sync_debug_mode('error') for the duration."""

  def __enter__(self):
    torch.cuda.set_sync_debug_mode('error')

  def __exit__(self, *exc):
    torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_packed_runner_on_the_card(cuda_device, monkeypatch):
  """make_fit_adam_packed with fast_subsample on the card: K1 once a step,
  no host sync inside a call, and the CPU's loss trace (rtol 1e-4) on the
  same injected permutation and window offsets."""
  from hyperbo_tpu_torch.models import packed as packed_lib
  from hyperbo_tpu_torch.train import adam
  rng = np.random.default_rng(8)
  data = {i: defs.SubDataset(rng.uniform(size=(60, 3)).astype(np.float32),
                             rng.normal(size=(60, 1)).astype(np.float32))
          for i in range(4)}
  model = gp.GP(data, mean.linear_mlp, kernel.squared_exponential_mlp,
                defs.GPParams(
                    model={'constant': 0., 'lengthscale': 0.,
                           'signal_variance': 0., 'noise_variance': -3.},
                    config={'mlp_features': (4, 4)}),
                DEFAULT_WARP_FUNC, device='cpu')
  model.initialize_params(torch.Generator().manual_seed(0))
  config = {'learning_rate': 1e-2, 'max_training_step': 6, 'batch_size': 24,
            'fast_subsample': True, 'mlp_features': (4, 4)}
  run = adam.make_fit_adam_packed(mean.linear_mlp,
                                  kernel.squared_exponential_mlp, config,
                                  warp_func=DEFAULT_WARP_FUNC)
  order = torch.from_numpy(np.stack([np.concatenate(
      [rng.permutation(60), np.arange(60, 64)]) for _ in range(4)]))
  offsets = [torch.from_numpy(rng.integers(0, 37, 4)) for _ in range(6)]
  traces = []
  for device in ('cpu', cuda_device):
    draws = iter(offsets)
    monkeypatch.setattr(packed_lib, 'draw_permutation',
                        lambda g, p, d=device: order.to(d))
    monkeypatch.setattr(packed_lib, 'draw_window_offsets',
                        lambda g, p, b, d=device: next(draws).to(d))
    packed, _ = packed_lib.pack_dataset(model.dataset, device=device)
    _, losses = run(convert.model_to(model.params.model, device), packed,
                    torch.Generator(device=device))
    traces.append(losses.cpu().numpy())
  np.testing.assert_allclose(traces[1], traces[0], rtol=1e-4)
  monkeypatch.undo()
  packed, _ = packed_lib.pack_dataset(model.dataset, device=cuda_device)
  params = convert.model_to(model.params.model, cuda_device)
  gen = torch.Generator(device=cuda_device).manual_seed(0)
  before = batch_chol.KERNEL.launches
  with _NoHostSync():
    _, losses = run(params, packed, gen)
  assert batch_chol.KERNEL.launches - before == 6
  assert bool(torch.isfinite(losses).all())


@pytest.mark.cuda
def test_ondevice_bo_runners_on_the_card(cuda_device):
  """The plain, q = 1 and retrain_steps = 0 runners agree bitwise on the
  card, with no host sync inside; the plain runner picks what it picks on
  the CPU; the retrain runner launches K1 once a retrain step."""
  from hyperbo_tpu_torch.bo import ondevice
  from hyperbo_tpu_torch.models import packed as packed_lib
  rng = np.random.default_rng(9)
  cx = rng.uniform(size=(500, 3)).astype(np.float32)
  cy = np.sin(3 * cx @ rng.normal(size=(3, 1))).astype(np.float32)
  model = {'constant': 0., 'lengthscale': np.zeros(3, np.float32),
           'signal_variance': 0., 'noise_variance': -3.}
  corpus = {i: defs.SubDataset(
      rng.uniform(size=(40, 3)).astype(np.float32),
      rng.normal(size=(40, 1)).astype(np.float32)) for i in range(3)}
  picks = {}
  for device in ('cpu', cuda_device):
    m = convert.model_to(model, device)
    queried = defs.SubDataset(torch.from_numpy(cx).to(device),
                              torch.from_numpy(cy).to(device))
    common = (mean.constant, kernel.squared_exponential, m, {},
              DEFAULT_WARP_FUNC, queried, 12)
    pp, _ = packed_lib.pack_dataset(corpus, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    ctx = _NoHostSync() if device != 'cpu' else torch.no_grad()
    before = batch_chol.KERNEL.launches
    with ctx:
      plain = ondevice.simulated_bayesopt_ondevice(
          *common, num_train_tasks=3, generator=gen, device=device)
      q1 = ondevice.simulated_bayesopt_ondevice_qbatch(
          *common, q=1, num_train_tasks=3, generator=gen, device=device)
      r0 = ondevice.simulated_bayesopt_ondevice_retrain(
          *common, num_train_tasks=3, retrain_steps=0, generator=gen,
          device=device)
      r = ondevice.simulated_bayesopt_ondevice_retrain(
          *common, num_train_tasks=3, pretrain_packed=pp, retrain_every=4,
          retrain_steps=3, generator=gen, device=device)
    if device != 'cpu':
      # Retrains before iterations 4 and 8, 3 steps each.
      assert batch_chol.KERNEL.launches - before == 6
    assert torch.equal(plain[2], q1[2][:, 0]) and torch.equal(plain[2], r0[2])
    assert torch.equal(plain[0], r0[0]) and torch.equal(plain[1], q1[1])
    assert all(bool(torch.isfinite(v).all()) for v in r[3].values())
    picks[device if device == 'cpu' else 'cuda'] = plain[2].cpu()
  assert torch.equal(picks['cpu'], picks['cuda'])


def _hgp_case(rng):
  cx = rng.uniform(size=(400, 3)).astype(np.float32)
  cy = np.sin(3 * cx @ rng.normal(size=(3, 1))).astype(np.float32)
  model = {'constant': 0., 'lengthscale': np.zeros(3, np.float32),
           'signal_variance': 0., 'noise_variance': -3.}
  corpus = {i: defs.SubDataset(
      rng.uniform(size=(40, 3)).astype(np.float32),
      rng.normal(size=(40, 1)).astype(np.float32)) for i in range(3)}
  return cx, cy, model, corpus


@pytest.mark.cuda
def test_hgp_fixed_sample_runner_on_the_card(cuda_device):
  """The fixed-sample HGP runner reads nothing back inside, picks on the
  card what it picks on the CPU, and with S identical samples picks as
  the plain runner."""
  from hyperbo_tpu_torch.bo import ondevice
  rng = np.random.default_rng(10)
  cx, cy, model, _ = _hgp_case(rng)
  samples = [{k: np.asarray(v, np.float32) + 0.1 * i
              for k, v in model.items()} for i in range(4)]
  picks = {}
  for device in ('cpu', cuda_device):
    queried = defs.SubDataset(torch.from_numpy(cx).to(device),
                              torch.from_numpy(cy).to(device))
    common = (mean.constant, kernel.squared_exponential)
    stacked = convert.stack_models(samples, device)
    one = convert.model_to(model, device)
    same4 = convert.stack_models([model] * 4, device)
    ctx = _NoHostSync() if device != 'cpu' else torch.no_grad()
    with ctx:
      hgp = ondevice.simulated_bayesopt_ondevice_hgp(
          *common, stacked, {}, DEFAULT_WARP_FUNC, queried, 12,
          num_train_tasks=3, device=device)
      same = ondevice.simulated_bayesopt_ondevice_hgp(
          *common, same4, {}, DEFAULT_WARP_FUNC, queried, 12,
          num_train_tasks=3, device=device)
      plain = ondevice.simulated_bayesopt_ondevice(
          *common, one, {}, DEFAULT_WARP_FUNC, queried, 12,
          num_train_tasks=3, device=device)
    assert torch.equal(same[2], plain[2])
    picks[str(torch.device(device).type)] = hgp[2].cpu()
  assert torch.equal(picks['cpu'], picks['cuda'])


@pytest.mark.cuda
def test_hgp_resample_runner_launches_k1_per_batched_evaluation(
    cuda_device):
  """The corpus log prob of 4 chains in one call on the card within rtol
  1e-4 of the CPU's; the re-sampling runner launches K1 exactly once per
  batched corpus evaluation and keeps its samples finite."""
  from hyperbo_tpu_torch.bo import ondevice
  from hyperbo_tpu_torch.models import packed as packed_lib
  from hyperbo_tpu_torch.train import slice_sampler
  rng = np.random.default_rng(11)
  cx, cy, model, corpus = _hgp_case(rng)
  flat, unravel = slice_sampler.ravel_model(model)
  rows = flat + torch.from_numpy(
      0.1 * rng.normal(size=(4, flat.shape[0])).astype(np.float32))
  values = []
  for device in ('cpu', cuda_device):
    pp, _ = packed_lib.pack_dataset(corpus, device=device)
    x_buf = torch.from_numpy(cx[:8]).to(device)
    y_buf = torch.from_numpy(cy[:8]).to(device)
    before = batch_chol.KERNEL.launches
    values.append(ondevice._corpus_loss_batched(
        mean.constant, kernel.squared_exponential, {}, DEFAULT_WARP_FUNC, 8,
        unravel(rows.to(device)), x_buf, y_buf, 5, pretrain_packed=pp).cpu())
    if device != 'cpu':
      assert batch_chol.KERNEL.launches - before == 1
  np.testing.assert_allclose(values[1].numpy(), values[0].numpy(), rtol=1e-4)

  pp, _ = packed_lib.pack_dataset(corpus, device=cuda_device)
  queried = defs.SubDataset(torch.from_numpy(cx).to(cuda_device),
                            torch.from_numpy(cy).to(cuda_device))
  stats = {}
  before = batch_chol.KERNEL.launches
  _, y, sel, samples = ondevice.simulated_bayesopt_ondevice_hgp_resample(
      mean.constant, kernel.squared_exponential,
      convert.model_to(model, cuda_device), {}, DEFAULT_WARP_FUNC, queried,
      6, num_samples=4, num_train_tasks=3, pretrain_packed=pp,
      resample_every=3, sweeps=1, device=cuda_device, stats=stats)
  assert batch_chol.KERNEL.launches - before == stats['evaluations'] > 0
  assert stats['readbacks'] >= 2 * 5
  assert torch.isfinite(y).all() and sel.shape == (6,)
  assert all(bool(torch.isfinite(v).all()) for s in samples
             for v in s.values())


@pytest.mark.cuda
def test_k1_over_a_restart_stack_equals_per_restart_launches(cuda_device):
  """Multi-start Adam's systems: one K1 launch over R x T systems gives
  each restart's B = L^-T bitwise what R launches of T give; the stacked
  NLL of R restarts on their own batches within rtol 1e-6 of each alone;
  fit_adam_packed_multistart on the card reads nothing back and launches
  K1 once a step."""
  from hyperbo_tpu_torch.models import packed as packed_lib
  from hyperbo_tpu_torch.train import adam
  stack = _spd_batch(21, 4 * 5, 40).to(cuda_device)
  before = batch_chol.KERNEL.launches
  whole = batch_chol.batched_linv_t(stack)
  assert batch_chol.KERNEL.launches - before == 1
  for r in range(4):
    part = batch_chol.batched_linv_t(stack[5 * r:5 * r + 5].contiguous())
    assert torch.equal(whole[5 * r:5 * r + 5], part), r

  rng = np.random.default_rng(12)
  data = {i: defs.SubDataset(rng.uniform(size=(50, 3)).astype(np.float32),
                             rng.normal(size=(50, 1)).astype(np.float32))
          for i in range(5)}
  packed, _ = packed_lib.pack_dataset(data, device=cuda_device)
  model = {'constant': 0.1, 'lengthscale': np.full((3,), 0.4, np.float32),
           'signal_variance': 0.2, 'noise_variance': -3.0}
  stacked = convert.stack_models(
      [{k: np.asarray(v, np.float32) + 0.05 * r for k, v in model.items()}
       for r in range(4)], cuda_device)
  sel = torch.from_numpy(np.stack([np.stack(
      [rng.permutation(50)[:16] for _ in range(5)]) for _ in range(4)])).to(
          cuda_device)
  before = batch_chol.KERNEL.launches
  got = packed_lib.neg_log_marginal_likelihood_packed_batched(
      mean.constant, kernel.squared_exponential, {}, stacked,
      packed_lib.take_rows_stacked(packed, sel), warp_func=DEFAULT_WARP_FUNC)
  assert batch_chol.KERNEL.launches - before == 1
  for r in range(4):
    one = packed_lib.neg_log_marginal_likelihood_packed(
        mean.constant, kernel.squared_exponential,
        defs.GPParams(model=convert.model_at(stacked, r), config={}),
        packed_lib.take_rows(packed, sel[r]), warp_func=DEFAULT_WARP_FUNC)
    np.testing.assert_allclose(float(got[r]), float(one), rtol=1e-6)

  config = {'learning_rate': 1e-2, 'max_training_step': 6, 'batch_size': 16}
  model = convert.model_to(model, cuda_device)
  generator = torch.Generator(device=cuda_device).manual_seed(0)
  before = batch_chol.KERNEL.launches
  with _NoHostSync():
    best, best_loss, finals = adam.fit_adam_packed_multistart(
        mean.constant, kernel.squared_exponential, model, packed, config,
        warp_func=DEFAULT_WARP_FUNC, generator=generator, num_restarts=4)
  assert batch_chol.KERNEL.launches - before == 6 + 1  # steps, eval_best
  assert finals.shape == (4,) and bool(torch.isfinite(best_loss))
  assert float(best_loss) == float(finals.min())


@pytest.mark.cuda
def test_fused_route_over_kumar_embedding_matches_plain(cuda_device):
  """The fused NLL through K2-K4 over an SE-Kumar embedding (512 rows, and
  520 rows on the masked route) against the float64 dense route on the
  card: value rtol 1e-4, gradient max rel 5e-3 per leaf, the warp's a and b
  included."""
  from hyperbo_tpu_torch.models import objectives as obj
  rng = np.random.default_rng(13)
  data = {i: (rng.uniform(size=(n, 4)), rng.normal(size=(n, 1)))
          for i, n in enumerate((512, 520))}

  def value_and_grad(dtype, fused):
    opts = dict(dtype=dtype, device=cuda_device)
    leaves = [torch.tensor(0.1, **opts), torch.full((4,), 0.5, **opts),
              torch.tensor(0.2, **opts), torch.tensor(-2.0, **opts),
              torch.linspace(-0.3, 0.3, 4, **opts),
              torch.linspace(0.2, -0.2, 4, **opts)]
    for v in leaves:
      v.requires_grad_(True)
    m = dict(zip(('constant', 'lengthscale', 'signal_variance',
                  'noise_variance'), leaves[:4]),
             kumar_params={'a': leaves[4], 'b': leaves[5]})
    dataset = {k: defs.SubDataset(torch.tensor(x, **opts),
                                  torch.tensor(y, **opts))
               for k, (x, y) in data.items()}
    val = obj.neg_log_marginal_likelihood(
        mean.constant, kernel.squared_exponential_kumar,
        defs.GPParams(model=m, config={'fused_mll': fused}), dataset,
        warp_func=DEFAULT_WARP_FUNC)
    return val, torch.autograd.grad(val, leaves)

  before = fused_mll.KERNEL.launches
  val, grads = value_and_grad(torch.float32, True)
  assert fused_mll.KERNEL.launches - before == 2
  val64, grads64 = value_and_grad(torch.float64, False)
  np.testing.assert_allclose(float(val), float(val64), rtol=1e-4)
  for g, w in zip(grads, grads64):
    err = float((g.double() - w).abs().max() / w.abs().max())
    assert err <= 5e-3, err


@pytest.mark.cuda
def test_continuous_runner_on_the_card(cuda_device, monkeypatch):
  """The on-device continuous loop reads nothing back inside on the card;
  on the same pools it picks on the card what it picks on the CPU
  (bitwise with no refinement, within 1e-4 after 15 ascent steps); two
  calls on equal generators are equal."""
  from hyperbo_tpu_torch.bo import ondevice
  rng = np.random.default_rng(14)
  pools = rng.uniform(size=(6, 256, 3)).astype(np.float32)
  x0 = rng.uniform(size=(3, 3)).astype(np.float32)
  oracle = lambda x: -torch.sum((x - 0.35) ** 2, dim=-1, keepdim=True)
  model = {'constant': 0., 'lengthscale': np.full(3, -1.0, np.float32),
           'signal_variance': 0., 'noise_variance': -5.}

  def runner(device, steps, generator):
    # Everything copied to the device before the run.
    args = (convert.model_to(model, device), torch.from_numpy(x0).to(device),
            oracle(torch.from_numpy(x0)).to(device))
    return lambda: ondevice.continuous_bayesopt_ondevice(
        mean.constant, kernel.squared_exponential, args[0], {},
        DEFAULT_WARP_FUNC, oracle, 3, 6, pool_size=256, refine_steps=steps,
        init_obs=args[1:], generator=generator, device=device)

  for steps in (0, 15):
    outs = {}
    for device in ('cpu', cuda_device):
      it = iter(torch.from_numpy(pools).to(device))
      monkeypatch.setattr(ondevice, '_draw_uniform',
                          lambda g, shape, dev: next(it))
      run = runner(device, steps, torch.Generator(device=device))
      ctx = _NoHostSync() if device != 'cpu' else torch.no_grad()
      with ctx:
        x_obs, _ = run()
      outs[str(device)] = x_obs.cpu()
    if steps:
      np.testing.assert_allclose(outs['cuda:0'].numpy(), outs['cpu'].numpy(),
                                 atol=1e-4)
    else:
      assert torch.equal(outs['cuda:0'], outs['cpu'])
  monkeypatch.undo()
  runs = [runner(cuda_device, 15,
                 torch.Generator(device=cuda_device).manual_seed(1))
          for _ in range(2)]
  with _NoHostSync():
    a, b = runs[0](), runs[1]()
  assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
  assert bool(((a[0] >= 0) & (a[0] <= 1)).all())


@pytest.mark.cuda
def test_mll_iterative_on_the_card_matches_cpu(cuda_device, monkeypatch):
  """The matrix-free NLL estimate (1000 rows, padded to 1024 by row_chunk
  256) on the card against the CPU with the same injected probes: the
  value within rtol 1e-4, each gradient leaf within 1e-3 of its largest
  entry, CG's iteration counts at most one apart."""
  from hyperbo_tpu_torch.ops import iterative
  rng = np.random.default_rng(15)
  x = rng.uniform(size=(1000, 4)).astype(np.float32)
  y = np.sin(3 * x @ rng.normal(size=(4, 1))).astype(np.float32)
  probes = [np.where(rng.uniform(size=(1024, 8)) < 0.5, 1.0, -1.0).astype(
      np.float32) for _ in range(2)]
  model = {'constant': 0.1, 'lengthscale': np.full(4, -0.5, np.float32),
           'signal_variance': 0.2, 'noise_variance': -2.}
  results = []
  for device in ('cpu', cuda_device):
    it = iter(probes)
    monkeypatch.setattr(iterative, '_draw_rademacher',
                        lambda g, shape, dev: torch.from_numpy(next(it)).to(
                            dev))
    m = convert.model_to(model, device)
    for leaf in m.values():
      leaf.requires_grad_(True)
    val, info = iterative.mll_iterative(
        mean.constant, defs.GPParams(model=m), torch.from_numpy(x).to(device),
        torch.from_numpy(y).to(device), warp_func=DEFAULT_WARP_FUNC,
        cov_func=kernel.matern52, row_chunk=256, num_probes=8,
        lanczos_steps=24, key=torch.Generator(), precond_rank=64,
        return_info=True)
    grads = torch.autograd.grad(val, list(m.values()))
    results.append((float(val), int(info['cg_iters']),
                    [g.cpu().numpy() for g in grads]))
  (v0, i0, g0), (v1, i1, g1) = results
  np.testing.assert_allclose(v1, v0, rtol=1e-4)
  # float32 CG on two devices: the last iteration's residual may cross the
  # tolerance one iteration apart.
  assert abs(i1 - i0) <= 1
  for a, b in zip(g1, g0):
    assert np.max(np.abs(a - b)) <= 1e-3 * np.max(np.abs(b))
