"""Smoke run of the PyTorch/CUDA port (hyperbo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, so the script
exits non-zero and the final ok line is never printed:

  1. device: requires CUDA and prints the card's name and power limit;
  2. build: compiles all eight kernels K1-K8 (csrc/*.cu, sm_90a) from the
     checkout's sources, one nvcc process each, all at once;
  3. K1 against its plain PyTorch version on the card: max abs error
     against the float64 plain version (bound 1e-5), NaN for a non-PD
     input, and the median time of both at the PD1 training shape;
  4. the main path at PD1 width: run_bayesopt(init_model=True) on 23 tasks
     x 2048 points x 4-d inputs (50 Adam steps at batch 100, so K1 runs on
     (23, 100, 100) each step), then 20 EI iterations over 10,000
     candidates; checks the loss trace, the observations and that every
     training step launched K1, and compares one step's loss on the card
     with the CPU (plain version) from the same parameters and subsample;
  5. K2, K3 and K4 (the fused large-n NLL: forward, triangular inverse,
     backward) against their plain versions in float64 on the card, at
     n = 512 (SE, d = 4), n = 700 (Matern-3/2, masked, padded to 704) and
     n = 8192 (SE, d = 8); NaN for a non-PD input; the median time of each
     kernel and its plain version at n = 8192;
  6. the large-n training path: GP.train() with config['fused_mll'] on 2
     tasks of 8192 and 5000 rows x 8-d inputs (SE kernel, constant mean,
     batch 8192, 5 Adam steps; the second task runs masked at n = 8192);
     checks the loss trace, that K2-K4 launched once per task per step and
     that K8 did not (HYPERBO_BWD_JOINT unset);
  7. objectives.neg_log_marginal_likelihood value and gradient at n = 8192
     through the kernels against the dense route in float64 (value rtol
     1e-4, max rel 5e-3 per gradient leaf), and one value and gradient at
     n = 16384, finite, with its time;
  8. K7 and K6 (the dense Cholesky kernels) against their float64 plain
     versions on the card (atol 5e-4): K7 at n = 1, 37, 128, 300, 512 and a
     (23, 100, 100) batch, K6 at n = 1024, 2048, 4096 and a batch of two;
     NaN for a non-PD matrix; the time of each, its plain version and
     torch.linalg.cholesky at the shapes of phase 9;
  9. the EKL slice at PD1 width: one nll_regkl(1.) step's loss on the card
     against the CPU (same parameters and injected subsample, rtol 1e-4);
     GP.train() with nll_regkl(1.) on the 23 tasks plus one aligned
     sub-dataset of 1024 shared inputs x 23 draws (50 Adam steps at batch
     100: K1 on the NLL half, dense autograd Cholesky on the EKL half);
     then GP.stats() on the full data three times: routes off (cuSOLVER),
     set_use_hbm_kernel (K6 on the aligned (1, 1024, 1024) factors), and
     set_use_recursive + set_use_pallas_base (K7 on the 512 base blocks);
     the routes agree with cuSOLVER (NLL, partial EKL, EUC rtol 1e-4; full
     EKL rtol 1e-3: its whitened covariance amplifies float32 rounding);
  10. K8 (the joint backward) against its float64 plain version and against
     K3 + alpha + K4 on the card, on phase 5's inputs and the float32
     rounding of their float64 factor (max rel 5e-3 for d_x, alpha, d_sv
     and d_da); NaN outputs for a NaN in L; the median time of K8, its
     plain version and K3 + alpha + K4 at n = 8192;
  11. the K8 path: phase 6's training with HYPERBO_BWD_JOINT=1 (set here
     and restored after), which launches K2 and K8 once per task per step
     and K3 and K4 never, and whose loss trace matches phase 6's (rtol
     1e-4); then phase 7's n = 8192 value and gradient through K8 against
     float64;
  12. K5 (the Gram kernel) through gram_with_ridge, cross_gram and gram at
     ragged shapes (70 x 70, 41 x 17, 1000 x 333) with d = 1, 4, 8 and 40,
     all three families, against the float64 plain version (atol 2e-5 sv);
     the median time of the kernel and its plain version at n = 8192, d = 8
     and at 10,000 candidates x 2048 points, d = 4;
  13. one JSON line with the kernels' numbers (each with its bound from the
     bytes and operations of its inputs, and the time of one PyTorch call
     computing the same function where there is one), then the ok line.

Needs one CUDA card and nvcc; imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

TASKS, POINTS, DIM = 23, 2048, 4
BATCH = 100
STEPS = 50
BO_ITERS = 20
CANDIDATES = 10_000
K1_ATOL = 1e-5
STEP_LOSS_RTOL = 1e-4
TIMED_RUNS = 50

# The fused large-n path (phases 5-7).
FUSED_TASKS = ((8192, 'a'), (5000, 'b'))
FUSED_DIM = 8
FUSED_STEPS = 5
L_ATOL = 5e-4          # tests/test_pallas_chol.py, the TPU kernel's bound
VALUE_RTOL = 1e-4      # tests/test_objectives.py:313
GRAD_MAX_REL = 5e-3    # bench.py:540, the gradient parity bound
FUSED_TIMED_RUNS = 6   # x 2 turns = 12 timings of each
GRAM_ATOL = 2e-5       # times sv: tests/test_pallas_gram.py:50

# The EKL slice and the dense Cholesky kernels (phases 8-9).
ALIGNED_POINTS = 1024  # the least n of K6's route; the recursion's 512 blocks
DENSE_TIMED_RUNS = 10  # x 2 turns = 20 timings of each
FULL_EKL_RTOL = 1e-3

# The card's peak rates that bound a kernel (NVIDIA's H100 SXM data sheet,
# at 700 W): float32 outside the tensor cores, and device memory.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def log(msg):
  print(msg, flush=True)


def spd_batch(rng, t, n):
  """SPD batch as tests/test_batch_chol.py's _spd_batch makes it."""
  a = rng.normal(size=(t, n, n))
  return (a @ np.swapaxes(a, -1, -2) / n + 2.0 * np.eye(n)).astype(np.float32)


def median_ms(fn, runs):
  times = []
  for _ in range(runs):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    times.append(start.elapsed_time(stop))
  return times


def phase_device():
  if not torch.cuda.is_available():
    print('chip_smoke: CUDA is not available', file=sys.stderr)
    sys.exit(2)
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True,
      timeout=60)
  card = smi.stdout.strip().splitlines()[0]
  log(card)
  log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
      f'device {torch.cuda.get_device_name(0)}, '
      f'{torch.cuda.device_count()} device(s)')
  return card


def phase_build(kernels):
  from hyperbo_tpu_torch.ops import _build
  t0 = time.perf_counter()
  _build.build_all(kernels)
  for k in kernels:
    log(f'build: {k.source} in {k.build_seconds:.2f} s')
    if k.build_log:
      print(k.build_log, file=sys.stderr)
  log(f'build: all {len(kernels)} in {time.perf_counter() - t0:.2f} s')


def phase_k1(batch_chol, dev):
  rng = np.random.default_rng(0)
  worst = 0.0
  for t, n in ((23, 100), (3, 128), (5, 37), (2, 1)):
    kb = spd_batch(rng, t, n)
    got = batch_chol.batched_linv_t(torch.from_numpy(kb).to(dev))
    want = batch_chol.linv_t_plain(torch.from_numpy(kb).double().to(dev))
    err = float((got.double() - want).abs().max())
    log(f'K1 (T={t}, n={n}): max abs err vs float64 plain {err:.3e}')
    if not err <= K1_ATOL:
      raise AssertionError(f'K1 error {err} > {K1_ATOL} at ({t}, {n})')
    worst = max(worst, err)

  # Value and gradient of the NLL terms through the kernel, against the
  # plain version in float64 on the card.
  kb = torch.from_numpy(spd_batch(rng, 23, 100)).to(dev)
  delta = torch.from_numpy(rng.normal(size=(23, 100, 1)).astype(
      np.float32)).to(dev)
  outs = []
  for k, dl in ((kb, delta), (kb.double().cpu(), delta.double().cpu())):
    k = k.clone().requires_grad_(True)
    dl = dl.clone().requires_grad_(True)
    q, ld = batch_chol.nll_terms_batched(k, dl)
    total = (0.5 * q + ld).sum()
    gk, gd = torch.autograd.grad(total, (k, dl))
    outs.append([float(total.detach())] +
                [g.double().cpu() for g in (gk, gd)])
  rel = abs(outs[0][0] - outs[1][0]) / abs(outs[1][0])
  gerr = max(float((a - b).abs().max()) for a, b in zip(outs[0][1:],
                                                        outs[1][1:]))
  log(f'K1 nll_terms (23, 100): value rel err {rel:.3e}, '
      f'grad max abs err {gerr:.3e}')
  if not (rel <= 1e-6 and gerr <= K1_ATOL):
    raise AssertionError(f'nll_terms_batched disagrees: {rel}, {gerr}')

  bad = spd_batch(rng, 2, 32)
  bad[1] -= 10.0 * np.eye(32, dtype=np.float32)
  b = batch_chol.batched_linv_t(torch.from_numpy(bad).to(dev))
  torch.cuda.synchronize()
  if not (bool(torch.isfinite(b[0]).all()) and
          not bool(torch.isfinite(b[1]).all())):
    raise AssertionError('K1 must give NaN for the non-PD task only')
  log('K1 non-PD input: NaN out, as the TPU kernel')

  kb = torch.from_numpy(spd_batch(rng, TASKS, BATCH)).to(dev)
  kb = 0.5 * (kb + kb.transpose(-1, -2))
  ms = _turns(TIMED_RUNS, plain=lambda: batch_chol.linv_t_plain(kb),
              kernel=lambda: batch_chol.launch_linv_t(kb))
  log(f'K1 time at (T={TASKS}, n={BATCH}): kernel {ms["kernel"]:.4f} ms, '
      f'plain {ms["plain"]:.4f} ms (median of {2 * TIMED_RUNS} each)')
  return worst, ms


def make_data(seed=0):
  """23 tasks of y = sin(3 x @ w) + 0.1 noise (bench.py's synthetic PD1
  shape), a 24th task of candidates for BO, and one aligned sub-dataset:
  ALIGNED_POINTS shared inputs with one draw of each training task's
  function a column, (x, y, tag)."""
  rng = np.random.default_rng(seed)
  dataset = {}
  ws = []
  for i in range(TASKS):
    x = rng.uniform(size=(POINTS, DIM))
    w = rng.normal(size=(DIM, 1))
    y = np.sin(3 * x @ w) + 0.1 * rng.normal(size=(POINTS, 1))
    dataset[f'workload{i}'] = (x.astype(np.float32), y.astype(np.float32))
    ws.append(w)
  cx = rng.uniform(size=(CANDIDATES, DIM))
  w = rng.normal(size=(DIM, 1))
  cy = np.sin(3 * cx @ w) + 0.1 * rng.normal(size=(CANDIDATES, 1))
  ax = rng.uniform(size=(ALIGNED_POINTS, DIM))
  ay = (np.sin(3 * ax @ np.concatenate(ws, axis=1)) +
        0.1 * rng.normal(size=(ALIGNED_POINTS, TASKS)))
  return (dataset, (cx.astype(np.float32), cy.astype(np.float32)),
          (ax.astype(np.float32), ay.astype(np.float32), 'aligned'))


def init_params(steps):
  from hyperbo_tpu_torch.core import defs
  return defs.GPParams(
      model={'constant': 0., 'lengthscale': torch.zeros(8),
             'signal_variance': 0., 'noise_variance': -4.},
      config={'method': 'adam', 'learning_rate': 1e-2,
              'max_training_step': steps, 'batch_size': BATCH,
              'objective': 'nll', 'mlp_features': (8, 8), 'retrain': 0})


def phase_step_parity(dataset, dev):
  """One step's loss on the card (kernel) and on the CPU (plain version),
  from the same parameters and the same injected subsample."""
  from hyperbo_tpu_torch.core import convert
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean
  from hyperbo_tpu_torch.models import packed as packed_lib

  model = gp.GP(dataset, mean.linear_mlp, kernel.squared_exponential_mlp,
                init_params(1), DEFAULT_WARP_FUNC, device='cpu')
  model.initialize_params(torch.Generator().manual_seed(1))
  rng = np.random.default_rng(2)
  sel = torch.from_numpy(np.stack(
      [rng.permutation(POINTS)[:BATCH] for _ in range(TASKS)]))
  losses = []
  for device in ('cpu', dev):
    packed, _ = packed_lib.pack_dataset(model.dataset, device=device)
    batch = packed_lib.take_rows(packed, sel.to(device))
    shim = gp.GPParams(model=convert.model_to(model.params.model, device),
                       config=model.params.config)
    losses.append(float(packed_lib.neg_log_marginal_likelihood_packed(
        mean.linear_mlp, kernel.squared_exponential_mlp, shim, batch,
        warp_func=DEFAULT_WARP_FUNC)))
  rel = abs(losses[1] - losses[0]) / abs(losses[0])
  log(f'first-step loss: card {losses[1]:.6f}, cpu {losses[0]:.6f}, '
      f'rel diff {rel:.3e}')
  if not rel <= STEP_LOSS_RTOL:
    raise AssertionError(f'card/cpu loss differ by {rel}')


def phase_slice(dataset, candidates, batch_chol, dev, card):
  from hyperbo_tpu_torch.bo import acfun, bayesopt
  from hyperbo_tpu_torch.core import defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import kernel, mean

  params = init_params(STEPS)
  params.config['checkpoint_every'] = 1
  losses, marks = [], {}

  def on_step(step, model, loss):
    losses.append(loss)
    if step in (1, STEPS):
      torch.cuda.synchronize()
      marks[step] = time.perf_counter()

  batch_chol.KERNEL.launches = 0
  (xo, yo), best, _ = bayesopt.run_bayesopt(
      dataset, 'test', defs.SubDataset(*candidates), mean.linear_mlp,
      kernel.squared_exponential_mlp, params, acfun.ei, BO_ITERS,
      warp_func=DEFAULT_WARP_FUNC,
      init_random_key=torch.Generator(device=dev).manual_seed(0),
      init_model=True, callback=on_step, device=dev)
  torch.cuda.synchronize()
  t_end = time.perf_counter()
  launches = batch_chol.KERNEL.launches

  trace = torch.stack(losses).cpu().numpy()
  log(f'training loss: first {trace[0]:.4f}, last {trace[-1]:.4f} '
      f'over {len(trace)} steps')
  if len(trace) != STEPS or not np.isfinite(trace).all():
    raise AssertionError(f'loss trace not finite or short: {trace}')
  if not trace[-10:].mean() < trace[:10].mean():
    raise AssertionError('training loss did not decrease')
  if launches < STEPS:
    raise AssertionError(f'K1 launched {launches} times in {STEPS} steps')
  log(f'K1 launches in the main path: {launches}')
  xo, yo = xo.cpu(), yo.cpu()
  if tuple(xo.shape) != (BO_ITERS, DIM) or tuple(yo.shape) != (BO_ITERS, 1):
    raise AssertionError(f'observations of shape {xo.shape}, {yo.shape}')
  if not (torch.isfinite(xo).all() and torch.isfinite(yo).all()):
    raise AssertionError('non-finite observations')
  if torch.unique(xo, dim=0).shape[0] != BO_ITERS:
    raise AssertionError('BO repeated an observation')
  cand_x = torch.from_numpy(candidates[0])
  if not all(bool((cand_x == row).all(dim=1).any()) for row in xo):
    raise AssertionError('an observation is not one of the candidates')
  log(f'BO: {BO_ITERS} distinct observations, best y {float(yo.max()):.4f} '
      f'(best candidate {float(best[1][0]):.4f})')
  step_ms = (marks[STEPS] - marks[1]) * 1e3 / (STEPS - 1)
  bo_ms = (t_end - marks[STEPS]) * 1e3 / BO_ITERS
  log(f'PD1-shape training ({TASKS}x{POINTS}x{DIM}, batch {BATCH}): '
      f'{step_ms:.3f} ms/step; BO over {CANDIDATES} candidates: '
      f'{bo_ms:.3f} ms/iter [{card}]')
  return launches


def _rel(a, b):
  """max |a - b| / max |b| over the entries (b the float64 reference)."""
  a = torch.as_tensor(a).double()
  b = torch.as_tensor(b).double()
  return float((a - b).abs().max() / b.abs().max())


def _turns(runs, **fns):
  """Median ms of each function, timed in turns: in the order given, then
  in reverse (plain, kernel, kernel, plain for two), `runs` each turn."""
  for fn in fns.values():
    fn()
  torch.cuda.synchronize()
  times = {name: [] for name in fns}
  for name in list(fns) + list(reversed(fns)):
    times[name] += median_ms(fns[name], runs)
  return {name: statistics.median(t) for name, t in times.items()}


def fused_inputs(dev, n, d, seed, sv=1.3, da=0.11):
  """The fused path's test input: n rows (padded with masked rows to a
  multiple of 64) of x uniform on [0, 2)^d and y standard normal, from a
  numpy seed; (x, y, sv, da, valid) in float32 and in float64 on the card
  (valid None when no row is padded)."""
  from hyperbo_tpu_torch.ops import fused_mll
  rng = np.random.default_rng(seed)
  n_pad = -(-n // fused_mll.TILE) * fused_mll.TILE
  x = np.zeros((n_pad, d))
  y = np.zeros((n_pad, 1))
  x[:n] = rng.uniform(size=(n, d)) * 2.0
  y[:n] = rng.normal(size=(n, 1))
  valid = None
  if n_pad != n:
    valid = (np.arange(n_pad) < n).astype(np.float64)
  ins = []
  for dtype in (torch.float32, torch.float64):
    opts = dict(dtype=dtype, device=dev)
    ins.append((torch.tensor(x, **opts), torch.tensor(y, **opts),
                torch.tensor(sv, **opts), torch.tensor(da, **opts),
                None if valid is None else torch.tensor(valid, **opts)))
  return ins


def input_factor(ins64, kfam):
  """The float32 rounding of the float64 plain factor: the input on which
  K3, K4 and K8 are each held alone against their plain versions. (cuSOLVER
  returns a column-major result: made contiguous.)"""
  from hyperbo_tpu_torch.ops import fused_mll
  x64, y64, sv64, da64, v64 = ins64
  chol64, quad64, ld64 = fused_mll.mll_fused_plain(x64, y64, sv64, da64,
                                                   kfam, v64)
  return chol64, quad64, ld64, chol64.float().contiguous()


def fused_case(dev, n, d, kfam, seed=0):
  """K2, K3 and K4 on one input against their float64 plain versions on
  the card. Returns the errors and the float32 inputs for timing."""
  from hyperbo_tpu_torch.ops import fused_mll, mll_bwd, tri_inv
  ins32, ins64 = fused_inputs(dev, n, d, seed)
  x32, y32, sv32, da32, v32 = ins32
  x64, y64, sv64, da64, v64 = ins64

  chol, quad, ld = fused_mll.launch_mll_fused(x32, y32, sv32, da32, kfam,
                                              v32)
  chol64, quad64, ld64, l_in = input_factor(ins64, kfam)
  t = tri_inv.launch_tri_inv(l_in)
  t64 = tri_inv.tri_inv_plain(l_in.double())
  t_in = t64.float().contiguous()
  alpha_in = tri_inv.alpha_from_inverse(t64, y64).float().contiguous()
  p, dsv, dda = mll_bwd.launch_mll_bwd(t_in, x32, alpha_in, sv32, kfam, v32)
  p64, dsv64, dda64 = mll_bwd.mll_bwd_plain(
      t_in.double(), x64, alpha_in.double(), sv64, kfam, v64)
  torch.cuda.synchronize()
  errs = {
      'L_abs': float((chol.double() - chol64).abs().max()),
      'quad_rel': abs(float(quad) - float(quad64)) / abs(float(quad64)),
      'logdet_rel': abs(float(ld) - float(ld64)) / abs(float(ld64)),
      'T_rel': _rel(t, t64),
      'T_abs': float((t.double() - t64).abs().max()),
      'P_rel': _rel(p, p64),
      'P_abs': float((p.double() - p64).abs().max()),
      'dsv_rel': abs(float(dsv) - float(dsv64)) / abs(float(dsv64)),
      'dda_rel': abs(float(dda) - float(dda64)) / abs(float(dda64)),
  }
  log(f'K2-K4 n={n} d={d} {kfam}' + (' masked' if v32 is not None else '')
      + ': ' + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()))
  bounds = (('L_abs', L_ATOL), ('quad_rel', VALUE_RTOL),
            ('logdet_rel', VALUE_RTOL), ('T_rel', GRAD_MAX_REL),
            ('P_rel', GRAD_MAX_REL), ('dsv_rel', GRAD_MAX_REL),
            ('dda_rel', GRAD_MAX_REL))
  for key, bound in bounds:
    if not errs[key] <= bound:
      raise AssertionError(f'{key} = {errs[key]} > {bound} at n={n} {kfam}')
  timing_inputs = dict(x=x32, y=y32, sv=sv32, da=da32, l=l_in, t=t_in,
                       alpha=alpha_in, kfam=kfam)
  return errs, timing_inputs


def phase_fused_kernels(dev):
  """Phase 5: K2-K4 parity, NaN on non-PD, timing at n = 8192."""
  from hyperbo_tpu_torch.ops import fused_mll, mll_bwd, tri_inv
  worst = {'fused_mll': 0.0, 'tri_inv': 0.0, 'mll_bwd': 0.0}
  big = None
  for n, d, kfam, seed in ((512, 4, 'se', 1), (700, 3, 'matern32', 2),
                           (8192, FUSED_DIM, 'se', 3)):
    errs, inputs = fused_case(dev, n, d, kfam, seed=seed)
    worst['fused_mll'] = max(worst['fused_mll'], errs['L_abs'])
    worst['tri_inv'] = max(worst['tri_inv'], errs['T_abs'])
    worst['mll_bwd'] = max(worst['mll_bwd'], errs['P_abs'])
    big = inputs

  # Not positive definite (da < 0): NaN value, NaN-or-zero gradients.
  rng = np.random.default_rng(4)
  x = torch.tensor(rng.uniform(size=(512, 4)) * 2.0, dtype=torch.float32,
                   device=dev, requires_grad=True)
  y = torch.tensor(rng.normal(size=(512, 1)), dtype=torch.float32,
                   device=dev, requires_grad=True)
  sv = torch.tensor(1.3, device=dev, requires_grad=True)
  da = torch.tensor(-0.5, device=dev, requires_grad=True)
  val = fused_mll.fused_nll_core(x, y, sv, da)
  grads = torch.autograd.grad(val, (x, y, sv, da))
  if not bool(torch.isnan(val)):
    raise AssertionError(f'non-PD value {float(val)} is not NaN')
  for g in grads:
    if not bool((torch.isnan(g) | (g == 0)).all()):
      raise AssertionError('non-PD gradient is neither NaN nor zero')
  log('K2-K4 non-PD input (da = -0.5): NaN value, NaN gradients')

  b = big
  # One library call computes K3's function: the n-RHS triangular solve.
  eye = torch.eye(b['l'].shape[0], device=dev)
  times = {
      'fused_mll': _turns(
          FUSED_TIMED_RUNS,
          plain=lambda: fused_mll.mll_fused_plain(b['x'], b['y'], b['sv'],
                                                  b['da'], b['kfam']),
          kernel=lambda: fused_mll.launch_mll_fused(b['x'], b['y'], b['sv'],
                                                    b['da'], b['kfam'])),
      'tri_inv': _turns(
          FUSED_TIMED_RUNS, plain=lambda: tri_inv.tri_inv_plain(b['l']),
          kernel=lambda: tri_inv.launch_tri_inv(b['l']),
          library=lambda: torch.linalg.solve_triangular(b['l'], eye,
                                                        upper=False)),
      'mll_bwd': _turns(
          FUSED_TIMED_RUNS,
          plain=lambda: mll_bwd.mll_bwd_plain(b['t'], b['x'], b['alpha'],
                                              b['sv'], b['kfam']),
          kernel=lambda: mll_bwd.launch_mll_bwd(b['t'], b['x'], b['alpha'],
                                                b['sv'], b['kfam'])),
  }
  for name, ms in times.items():
    log(f'{name} time at n=8192 (median of {2 * FUSED_TIMED_RUNS} each): ' +
        ', '.join(f'{k} {v:.3f} ms' for k, v in ms.items()))
  return worst, times


def fused_data(seed=5):
  """The large-n tasks: y = sin(3 x @ w) + 0.1 noise on 8-d inputs."""
  rng = np.random.default_rng(seed)
  dataset = {}
  for n, key in FUSED_TASKS:
    x = rng.uniform(size=(n, FUSED_DIM))
    w = rng.normal(size=(FUSED_DIM, 1))
    y = np.sin(3 * x @ w) + 0.1 * rng.normal(size=(n, 1))
    dataset[key] = (x.astype(np.float32), y.astype(np.float32))
  return dataset


def fused_model(dtype=torch.float32, device='cpu'):
  """bench.py's large-n parameters, plus the constant mean."""
  opts = dict(dtype=dtype, device=device)
  return {'constant': torch.tensor(0.0, **opts),
          'lengthscale': torch.full((FUSED_DIM,), 0.5, **opts),
          'signal_variance': torch.tensor(0.0, **opts),
          'noise_variance': torch.tensor(-2.0, **opts)}


def train_fused(dev, kernels):
  """GP.train() through the fused route at full width (bench.py's large-n
  parameters). Returns the loss trace, each kernel's launches in the run,
  the first step's and the mean later step's ms."""
  from hyperbo_tpu_torch.core import defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean
  model = gp.GP(fused_data(), mean.constant, kernel.squared_exponential,
                defs.GPParams(model=fused_model(), config={
                    'method': 'adam', 'learning_rate': 1e-2,
                    'max_training_step': FUSED_STEPS, 'batch_size': 8192,
                    'objective': 'nll', 'fused_mll': True,
                    'checkpoint_every': 1}),
                DEFAULT_WARP_FUNC, device=dev)
  model.initialize_params(torch.Generator(device=dev).manual_seed(0))
  losses, marks = [], {}

  def on_step(step, params, loss):
    losses.append(loss)
    torch.cuda.synchronize()
    marks[step] = time.perf_counter()

  for k in kernels.values():
    k.launches = 0
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  model.train(callback=on_step)
  launches = {name: k.launches for name, k in kernels.items()}
  trace = torch.stack(losses).cpu().numpy()
  if len(trace) != FUSED_STEPS or not np.isfinite(trace).all():
    raise AssertionError(f'fused loss trace not finite or short: {trace}')
  if not trace[-1] < trace[0]:
    raise AssertionError('fused training loss did not decrease')
  first_ms = (marks[1] - t0) * 1e3
  step_ms = (marks[FUSED_STEPS] - marks[1]) * 1e3 / (FUSED_STEPS - 1)
  return trace, launches, first_ms, step_ms


def check_launches(launches, want):
  for name, count in launches.items():
    if count != want[name]:
      raise AssertionError(f'{name} launched {count} times, want '
                           f'{want[name]}')


def phase_fused_train(dev, card, kernels):
  """Phase 6: GP.train() through K2-K4 at full width; K8 stays off."""
  trace, launches, first_ms, step_ms = train_fused(dev, kernels)
  log(f'fused training loss: {" ".join(f"{v:.4f}" for v in trace)}')
  want = FUSED_STEPS * len(FUSED_TASKS)
  check_launches(launches, {'fused_mll': want, 'tri_inv': want,
                            'mll_bwd': want, 'mll_bwd_joint': 0})
  log(f'fused launches in the main path: {launches}')
  log(f'large-n training (tasks of 8192 and 5000 rows x {FUSED_DIM}, '
      f'fused_mll): {step_ms:.3f} ms/step (first step {first_ms:.3f} ms) '
      f'[{card}]')
  return launches, trace


def _value_and_grad(dataset, dtype, dev, fused):
  from hyperbo_tpu_torch.core import defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import kernel, mean
  from hyperbo_tpu_torch.models import objectives as obj
  model = fused_model(dtype, dev)
  leaves = list(model.values())
  for v in leaves:
    v.requires_grad_(True)
  data = {k: defs.SubDataset(torch.tensor(x, dtype=dtype, device=dev),
                             torch.tensor(y, dtype=dtype, device=dev))
          for k, (x, y) in dataset.items()}
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  val = obj.neg_log_marginal_likelihood(
      mean.constant, kernel.squared_exponential,
      defs.GPParams(model=model, config={'fused_mll': fused}), data,
      warp_func=DEFAULT_WARP_FUNC)
  grads = torch.autograd.grad(val, leaves)
  torch.cuda.synchronize()
  ms = (time.perf_counter() - t0) * 1e3
  return float(val.detach()), [g.double().cpu() for g in grads], ms


def objective_parity(dev, card, route):
  """Value and gradient at n = 8192 through the fused route against the
  dense route in float64 (value rtol 1e-4, max rel 5e-3 per leaf)."""
  rng = np.random.default_rng(6)
  data = {'t': (rng.uniform(size=(8192, FUSED_DIM)),
                rng.normal(size=(8192, 1)))}
  _value_and_grad(data, torch.float32, dev, True)  # warm-up
  val, grads, ms = _value_and_grad(data, torch.float32, dev, True)
  val64, grads64, ms64 = _value_and_grad(data, torch.float64, dev, False)
  rel = abs(val - val64) / abs(val64)
  leaf_rel = [_rel(a, b) for a, b in zip(grads, grads64)]
  log(f'n=8192 value+grad through {route}: {ms:.3f} ms; value rel err '
      f'{rel:.3e}; gradient max rel per leaf '
      f'{" ".join(f"{v:.3e}" for v in leaf_rel)} (float64 dense: '
      f'{ms64:.3f} ms) [{card}]')
  if not (rel <= VALUE_RTOL and max(leaf_rel) <= GRAD_MAX_REL):
    raise AssertionError(f'n=8192 parity: value {rel}, grads {leaf_rel}')
  return rng


def phase_fused_objective(dev, card):
  """Phase 7: value and gradient at n = 8192 against float64, and n = 16384."""
  rng = objective_parity(dev, card, 'K2-K4')
  data = {'t': (rng.uniform(size=(16384, FUSED_DIM)),
                rng.normal(size=(16384, 1)))}
  val, grads, ms = _value_and_grad(data, torch.float32, dev, True)
  if not (np.isfinite(val) and all(bool(torch.isfinite(g).all())
                                   for g in grads)):
    raise AssertionError(f'n=16384 value+grad not finite: {val}')
  log(f'n=16384 value+grad through K2-K4: {ms:.3f} ms (first call), value '
      f'{val:.4f} [{card}]')
  return ms


def joint_route(l, x, delta, sv, kfam, valid=None):
  """The backward K8 replaces, on the card: K3, alpha, K4, then d_x."""
  from hyperbo_tpu_torch.ops import mll_bwd, tri_inv
  t = tri_inv.launch_tri_inv(l)
  alpha = tri_inv.alpha_from_inverse(t, delta).contiguous()
  p, dsv, dda = mll_bwd.launch_mll_bwd(t, x, alpha, sv, kfam, valid)
  d = x.shape[1]
  return 2.0 * (p[:, :d] - p[:, d:] * x), alpha, dsv, dda


def phase_joint_kernel(dev):
  """Phase 10: K8 against its float64 plain version and against K3 +
  alpha + K4 on the same float32 factor, NaN for a NaN factor, timing at
  n = 8192."""
  from hyperbo_tpu_torch.ops import bwd_joint
  names = ('d_x', 'alpha', 'dsv_raw', 'd_da')
  worst = 0.0
  for n, d, kfam, seed in ((512, 4, 'se', 1), (700, 3, 'matern32', 2),
                           (8192, FUSED_DIM, 'se', 3)):
    ins32, ins64 = fused_inputs(dev, n, d, seed)
    x32, y32, sv32, _, v32 = ins32
    x64, y64, sv64, _, v64 = ins64
    l_in = input_factor(ins64, kfam)[3]
    got = bwd_joint.launch_mll_bwd_joint(l_in, x32, y32, sv32, kfam, v32)
    want = bwd_joint.mll_bwd_joint_plain(l_in.double(), x64, y64, sv64, kfam,
                                         v64)
    route = joint_route(l_in, x32, y32, sv32, kfam, v32)
    torch.cuda.synchronize()
    rel = {k: _rel(a, b) for k, a, b in zip(names, got, want)}
    rel_route = {k: _rel(a, b) for k, a, b in zip(names, got, route)}
    worst = max([worst] + [float((a.double() - b).abs().max())
                           for a, b in zip(got[:2], want[:2])])
    log(f'K8 n={n} d={d} {kfam}' + (' masked' if v32 is not None else '') +
        ': max rel vs float64 ' +
        ', '.join(f'{k} {v:.3e}' for k, v in rel.items()) +
        '; vs K3 + alpha + K4 ' +
        ', '.join(f'{k} {v:.3e}' for k, v in rel_route.items()))
    for key in names:
      if not (rel[key] <= GRAD_MAX_REL and rel_route[key] <= GRAD_MAX_REL):
        raise AssertionError(f'K8 {key} at n={n} {kfam}: {rel[key]} vs '
                             f'float64, {rel_route[key]} vs K3 + K4')
    if n == 512:
      bad = l_in.clone()
      bad[-1, 0] = float('nan')
      outs = bwd_joint.launch_mll_bwd_joint(bad, x32, y32, sv32, kfam, v32)
      if not all(bool(torch.isnan(o).all()) for o in outs):
        raise AssertionError('K8 must give NaN outputs for a NaN factor')
      log('K8 NaN in L: NaN outputs')
  ms = _turns(
      FUSED_TIMED_RUNS,
      plain=lambda: bwd_joint.mll_bwd_joint_plain(l_in, x32, y32, sv32, kfam),
      kernel=lambda: bwd_joint.launch_mll_bwd_joint(l_in, x32, y32, sv32,
                                                    kfam),
      route=lambda: joint_route(l_in, x32, y32, sv32, kfam))
  log(f'mll_bwd_joint time at n=8192 (median of {2 * FUSED_TIMED_RUNS} '
      f'each): kernel {ms["kernel"]:.3f} ms, plain {ms["plain"]:.3f} ms, '
      f'K3 + alpha + K4 {ms["route"]:.3f} ms')
  return worst, ms


def phase_joint_path(dev, card, kernels, trace_k3k4):
  """Phase 11: phase 6's training and phase 7's n = 8192 value+grad with
  HYPERBO_BWD_JOINT=1 (the environment is restored after it): K8 once per
  task per step, K3 and K4 never."""
  with mock.patch.dict(os.environ, {'HYPERBO_BWD_JOINT': '1'}):
    trace, launches, first_ms, step_ms = train_fused(dev, kernels)
    log(f'fused training loss through K8: '
        f'{" ".join(f"{v:.4f}" for v in trace)}')
    want = FUSED_STEPS * len(FUSED_TASKS)
    check_launches(launches, {'fused_mll': want, 'tri_inv': 0, 'mll_bwd': 0,
                              'mll_bwd_joint': want})
    log(f'K8 path launches: {launches}')
    rel = np.abs(trace - trace_k3k4) / np.abs(trace_k3k4)
    log(f'large-n training through K8: {step_ms:.3f} ms/step (first step '
        f'{first_ms:.3f} ms); loss trace max rel diff vs K3 + K4 '
        f'{rel.max():.3e} [{card}]')
    if not rel.max() <= STEP_LOSS_RTOL:
      raise AssertionError(f'K8 loss trace differs from K3 + K4: {rel}')
    objective_parity(dev, card, 'K2 + K8')
  return launches


def phase_gram(dev, dataset, candidates):
  """Phase 12: K5 through its entry points (gram_with_ridge, cross_gram,
  gram) at ragged shapes against the float64 plain version, then timing of
  the kernel and its plain version at the large-n Gram and the PD1
  candidates' cross-Gram."""
  from hyperbo_tpu_torch.ops import fused_gram
  rng = np.random.default_rng(9)
  sv, ridge = 0.9, 0.05
  # Each entry point on inputs a (70, 41, 17, 1000 and 333 rows, uniform
  # on [0, 1)^d as the repo's BO inputs are) and lengthscales s.
  calls = (
      lambda a, s, k: fused_gram.gram_with_ridge(a[0], s, sv, ridge, k),
      lambda a, s, k: fused_gram.cross_gram(a[1], a[2], s, sv, k),
      lambda a, s, k: fused_gram.cross_gram(a[3], a[4], s, sv, k),
      lambda a, s, k: fused_gram.gram(a[3] / s, a[4] / s, sv, ridge, k))
  cases = []
  for d in (1, 4, 8, 40):
    xs = [torch.tensor(rng.uniform(size=(m, d)), dtype=torch.float32)
          for m in (70, 41, 17, 1000, 333)]
    ls = torch.tensor(rng.uniform(0.5, 2.0, size=d), dtype=torch.float32)
    cases += [(call, xs, ls, kind) for kind in ('se', 'matern32', 'matern52')
              for call in calls]
  fused_gram.KERNEL.launches = 0
  got = [call([x.to(dev) for x in xs], ls.to(dev), kind)
         for call, xs, ls, kind in cases]
  torch.cuda.synchronize()
  launches = fused_gram.KERNEL.launches
  worst = 0.0
  for out, (call, xs, ls, kind) in zip(got, cases):
    want = call([x.double() for x in xs], ls.double(), kind)
    err = float((out.cpu().double() - want).abs().max())
    worst = max(worst, err)
    if out.shape != want.shape or not err <= GRAM_ATOL * sv:
      raise AssertionError(f'K5 {kind} d={ls.shape[0]} {tuple(out.shape)}: '
                           f'max abs err {err} > {GRAM_ATOL * sv}')
  if launches != len(cases):
    raise AssertionError(f'K5 launched {launches} times in {len(cases)} '
                         'calls')
  log(f'K5: {len(cases)} calls (gram_with_ridge 70 x 70, cross_gram 41 x 17 '
      f'and 1000 x 333, gram 1000 x 333; d = 1, 4, 8, 40; three families), '
      f'{launches} launches, max abs err vs float64 {worst:.3e}')

  xb = torch.tensor(fused_data()['a'][0], device=dev) / 0.5
  xb = xb - xb.mean(dim=0, keepdim=True)
  c1 = torch.tensor(candidates[0], device=dev)
  c2 = torch.tensor(dataset['workload0'][0], device=dev)
  center = torch.cat([c1, c2]).mean(dim=0, keepdim=True)
  c1, c2 = c1 - center, c2 - center
  times = {}
  for name, a, b, add in (('gram_with_ridge', xb, xb, True),
                          ('cross_gram', c1, c2, False)):
    times[name] = _turns(
        DENSE_TIMED_RUNS,
        plain=lambda: fused_gram.gram_plain(a, b, sv, ridge, 'se', add),
        kernel=lambda: fused_gram.launch_gram(a, b, sv, ridge, 'se', add))
    log(f'K5 {name} time at {tuple(a.shape)} x {tuple(b.shape)} (median of '
        f'{2 * DENSE_TIMED_RUNS} each): kernel {times[name]["kernel"]:.4f} '
        f'ms, plain {times[name]["plain"]:.4f} ms')
  return worst, launches, times


def bound(flops, nbytes):
  """(bound_ms, bound_by): the least time the card could take for `flops`
  float32 operations on `nbytes` bytes read and written once."""
  ops_ms = flops / PEAK_FP32_FLOPS * 1e3
  bytes_ms = nbytes / PEAK_BYTES * 1e3
  return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms,
                                                               'bytes')


def phase_dense_kernels(dev):
  """Phase 8: K7 and K6 against float64, NaN on non-PD, timing."""
  from hyperbo_tpu_torch.ops import chol_hbm, chol_panel
  rng = np.random.default_rng(7)
  worst = {'chol_panel': 0.0, 'chol_hbm': 0.0}
  cases = [('chol_panel', 1, n) for n in (1, 37, 128, 300, 512)]
  cases += [('chol_panel', TASKS, BATCH)]
  cases += [('chol_hbm', 1, n) for n in (1024, 2048, 4096)]
  cases += [('chol_hbm', 2, 1024)]
  launch = {'chol_panel': chol_panel.launch_chol_panel,
            'chol_hbm': chol_hbm.launch_chol_hbm}
  plain = {'chol_panel': chol_panel.cholesky_panel_plain,
           'chol_hbm': chol_hbm.cholesky_hbm_plain}
  for name, t, n in cases:
    a = torch.from_numpy(spd_batch(rng, t, n)).to(dev)
    got = launch[name](a)
    want = plain[name](a.double())
    err = float((got.double() - want).abs().max())
    log(f'{name} ({t}, {n}, {n}): max abs err vs float64 plain {err:.3e}')
    if not err <= L_ATOL:
      raise AssertionError(f'{name} error {err} > {L_ATOL} at ({t}, {n})')
    worst[name] = max(worst[name], err)
  for name, n in (('chol_panel', 300), ('chol_hbm', 1024)):
    bad = spd_batch(rng, 2, n)
    bad[1, -1, -1] = -5.0
    got = launch[name](torch.from_numpy(bad).to(dev))
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(got[0]).all()) and
            bool(torch.isnan(got[1]).all())):
      raise AssertionError(f'{name} must give NaN for the non-PD matrix only')
    log(f'{name} non-PD input: NaN for that matrix only')

  times = {}
  for name, n in (('chol_panel', 512), ('chol_hbm', ALIGNED_POINTS)):
    a = torch.from_numpy(spd_batch(rng, 1, n)).to(dev)
    a = 0.5 * (a + a.transpose(-1, -2))
    times[name] = _turns(DENSE_TIMED_RUNS, plain=lambda: plain[name](a),
                         kernel=lambda: launch[name](a),
                         library=lambda: torch.linalg.cholesky(a))
    ms = times[name]
    log(f'{name} time at (1, {n}, {n}) (median of {2 * DENSE_TIMED_RUNS} '
        f'each): kernel {ms["kernel"]:.4f} ms, plain {ms["plain"]:.4f} ms, '
        f'torch.linalg.cholesky {ms["library"]:.4f} ms')
  return worst, times


def ekl_params(steps):
  params = init_params(steps)
  params.config['objective'] = 'nll_regkl1'
  return params


def phase_ekl_step_parity(dataset, dev):
  """One nll_regkl(1.) step's loss on the card and on the CPU, from the same
  parameters and the same injected subsample of both halves."""
  from hyperbo_tpu_torch.core import convert
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean
  from hyperbo_tpu_torch.models import packed as packed_lib

  model = gp.GP(dataset, mean.linear_mlp, kernel.squared_exponential_mlp,
                ekl_params(1), DEFAULT_WARP_FUNC, device='cpu')
  model.initialize_params(torch.Generator().manual_seed(1))
  rng = np.random.default_rng(3)
  sel = torch.from_numpy(np.stack(
      [rng.permutation(POINTS)[:BATCH] for _ in range(TASKS)]))
  sel_al = torch.from_numpy(rng.permutation(ALIGNED_POINTS)[:BATCH][None])
  losses = []
  for device in ('cpu', dev):
    loss_fn, (pnll, pekl), _ = gp._build_packed_training(
        model.params.config['objective'], model.dataset, model.params.config,
        mean.linear_mlp, kernel.squared_exponential_mlp, DEFAULT_WARP_FUNC,
        device)
    batch = (packed_lib.take_rows(pnll, sel.to(device)),
             packed_lib.take_aligned_rows(pekl, sel_al.to(device)))
    losses.append(float(loss_fn(
        convert.model_to(model.params.model, device), batch)))
  rel = abs(losses[1] - losses[0]) / abs(losses[0])
  log(f'first nll_regkl step loss: card {losses[1]:.6f}, cpu '
      f'{losses[0]:.6f}, rel diff {rel:.3e}')
  if not rel <= STEP_LOSS_RTOL:
    raise AssertionError(f'card/cpu nll_regkl loss differ by {rel}')


def _stats_values(model):
  nll, ekl, ekl_partial, euc, _ = model.stats(verbose=False)
  return {'nll': float(nll), 'ekl': float(ekl),
          'ekl_partial': float(ekl_partial), 'euc': float(euc)}


def phase_ekl(dataset, dev, card, kernels):
  """Phase 9: nll_regkl training at PD1 width, then GP.stats() through
  cuSOLVER, K6 and the recursion with K7. Returns the launches of each
  kernel in this path's run."""
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean
  from hyperbo_tpu_torch.ops import chol as chol_ops

  params = ekl_params(STEPS)
  params.config['checkpoint_every'] = 1
  model = gp.GP(dataset, mean.linear_mlp, kernel.squared_exponential_mlp,
                params, DEFAULT_WARP_FUNC, device=dev)
  model.initialize_params(torch.Generator(device=dev).manual_seed(0))
  losses, marks = [], {}

  def on_step(step, _, loss):
    losses.append(loss)
    if step in (1, STEPS):
      torch.cuda.synchronize()
      marks[step] = time.perf_counter()

  for k in kernels.values():
    k.launches = 0
  model.train(callback=on_step)
  trace = torch.stack(losses).cpu().numpy()
  step_ms = (marks[STEPS] - marks[1]) * 1e3 / (STEPS - 1)
  log(f'nll_regkl training loss: first {trace[0]:.4f}, last {trace[-1]:.4f} '
      f'over {len(trace)} steps; {step_ms:.3f} ms/step [{card}]')
  if len(trace) != STEPS or not np.isfinite(trace).all():
    raise AssertionError(f'nll_regkl loss trace not finite or short: {trace}')
  if not trace[-10:].mean() < trace[:10].mean():
    raise AssertionError('nll_regkl training loss did not decrease')
  if kernels['batched_linv_t'].launches < STEPS:
    raise AssertionError('K1 did not run every nll_regkl training step')

  torch.cuda.synchronize()
  t0 = time.perf_counter()
  nll, _ = model.neg_log_marginal_likelihood()
  float(nll)
  log(f'SVD NLL over {TASKS} x {POINTS}: '
      f'{(time.perf_counter() - t0) * 1e3:.3f} ms [{card}]')
  routes = {'cusolver': (),
            'chol_hbm': (chol_ops.set_use_hbm_kernel,),
            'chol_panel': (chol_ops.set_use_recursive,
                           chol_ops.set_use_pallas_base)}
  results = {}
  for route, setters in routes.items():
    before = {name: k.launches for name, k in kernels.items()}
    try:
      for setter in setters:
        setter(True)
      _stats_values(model)  # warm-up
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      values = _stats_values(model)
      stats_ms = (time.perf_counter() - t0) * 1e3
      t0 = time.perf_counter()
      with torch.no_grad():
        float(model.empirical_divergence_packed(partial=False) +
              model.empirical_divergence_packed(partial=True))
      ekl_ms = (time.perf_counter() - t0) * 1e3
    finally:
      for setter in setters:
        setter(False)
    used = {name: k.launches - before[name] for name, k in kernels.items()
            if name in ('chol_hbm', 'chol_panel')}
    results[route] = values
    log(f'GP.stats() via {route}: ' +
        ', '.join(f'{k} {v:.6f}' for k, v in values.items()) +
        f'; {stats_ms:.3f} ms per stats(), {ekl_ms:.3f} ms for the two '
        f'packed EKLs; launches {used} [{card}]')
    if not all(np.isfinite(v) for v in values.values()):
      raise AssertionError(f'GP.stats() via {route} is not finite: {values}')
    if route != 'cusolver' and used[route] == 0:
      raise AssertionError(f'GP.stats() via {route} did not launch it')
  launches = {name: k.launches for name, k in kernels.items()}
  want = results['cusolver']
  for route in ('chol_hbm', 'chol_panel'):
    rel = {k: abs(v - want[k]) / abs(want[k])
           for k, v in results[route].items()}
    log(f'{route} route vs cuSOLVER, rel diff: ' +
        ', '.join(f'{k} {v:.3e}' for k, v in rel.items()))
    bounds = dict(nll=STEP_LOSS_RTOL, ekl=FULL_EKL_RTOL,
                  ekl_partial=STEP_LOSS_RTOL, euc=STEP_LOSS_RTOL)
    for key, b in bounds.items():
      if not rel[key] <= b:
        raise AssertionError(f'{route} {key} differs by {rel[key]} > {b}')
  return launches


def main():
  # The port first: without the repo's sources there is nothing to run.
  from hyperbo_tpu_torch.ops import (batch_chol, bwd_joint, chol_hbm,
                                     chol_panel, fused_gram, fused_mll,
                                     mll_bwd, tri_inv)
  card = phase_device()
  dev = torch.device('cuda', 0)
  fused_kernels = {'fused_mll': fused_mll.KERNEL, 'tri_inv': tri_inv.KERNEL,
                   'mll_bwd': mll_bwd.KERNEL}
  # The large-n training path's kernels, counted on both of its backwards.
  path_kernels = dict(fused_kernels, mll_bwd_joint=bwd_joint.KERNEL)
  dense_kernels = {'chol_panel': chol_panel.KERNEL,
                   'chol_hbm': chol_hbm.KERNEL}
  phase_build([batch_chol.KERNEL, *path_kernels.values(),
               *dense_kernels.values(), fused_gram.KERNEL])
  err, k1_times = phase_k1(batch_chol, dev)
  dataset, candidates, aligned = make_data()
  phase_step_parity(dataset, dev)
  launches = phase_slice(dataset, candidates, batch_chol, dev, card)
  worst, times = phase_fused_kernels(dev)
  fused_launches, trace_k3k4 = phase_fused_train(dev, card, path_kernels)
  phase_fused_objective(dev, card)
  dense_worst, dense_times = phase_dense_kernels(dev)
  ekl_data = dict(dataset, aligned=aligned)
  phase_ekl_step_parity(ekl_data, dev)
  ekl_launches = phase_ekl(ekl_data, dev, card,
                           {'batched_linv_t': batch_chol.KERNEL,
                            **dense_kernels})
  joint_worst, joint_times = phase_joint_kernel(dev)
  joint_launches = phase_joint_path(dev, card, path_kernels, trace_k3k4)
  gram_worst, gram_launches, gram_times = phase_gram(dev, dataset,
                                                     candidates)

  # Work of each kernel at the shapes timed above: minimal float32
  # operations, and bytes of its inputs read and outputs written once.
  n, d, t, b = 8192, FUSED_DIM, TASKS, BATCH
  work = {
      # Cholesky and triangular inverse, 2 n^3 / 3 a task; K in, B out.
      'batched_linv_t': (t * 2 * b**3 / 3, 8 * t * b * b),
      # Gram n^2 (d + 1), Cholesky n^3 / 3, forward solve n^2; x, y in,
      # L and z out.
      'fused_mll': (n**3 / 3 + n * n * (d + 2), 4 * (n * d + 2 * n + n * n)),
      # L^{-1}: n^3 / 3; L in, T out.
      'tri_inv': (n**3 / 3, 8 * n * n),
      # T^T T on the lower half n^3 / 3, G, W and P = [W x | W 1]
      # 2 n^2 (d + 1); T, x, alpha in, P out.
      'mll_bwd': (n**3 / 3 + 2 * n * n * (d + 1),
                  4 * (n * n + n * d + n + n * (d + 1))),
      # Cholesky n^3 / 3 of one matrix; A in, L out.
      'chol_panel': (512**3 / 3, 8 * 512 * 512),
      'chol_hbm': (ALIGNED_POINTS**3 / 3, 8 * ALIGNED_POINTS**2),
      # L^{-1} n^3 / 3, T^T T on the lower half n^3 / 3, u = T delta and
      # alpha = T^T u 2 n^2, G, W and P 2 n^2 (d + 1); L, x, delta in, P and
      # alpha out.
      'mll_bwd_joint': (2 * n**3 / 3 + 2 * n * n + 2 * n * n * (d + 1),
                        4 * (n * n + n * d + n + n * (d + 1) + n)),
      # The large-n Gram: n^2 (2 d + 3); x in twice, K out.
      'gram': (n * n * (2 * d + 3), 4 * (n * n + 2 * n * d)),
  }
  # The float32 matmul rate the card reaches, beside the data sheet's.
  x = torch.randn((n, n), device=dev)
  matmul_tflops = 2 * n**3 / statistics.median(
      median_ms(lambda: x @ x, 10)) / 1e9
  log(f'float32 matmul (TF32 off) at {n}: {matmul_tflops:.2f} TFLOP/s '
      f'measured, {PEAK_FP32_FLOPS / 1e12:.0f} on the data sheet [{card}]')
  for name, (flops, nbytes) in work.items():
    ms_dsheet, by = bound(flops, nbytes)
    ms_meas = max(flops / matmul_tflops / 1e9, nbytes / PEAK_BYTES * 1e3)
    log(f'{name} bound: {ms_dsheet:.5f} ms by {by} ({ms_meas:.5f} ms at the '
        'measured matmul rate)')
  del x
  rows = [{
      'name': 'batched_linv_t',
      'route': 'cuda',
      'source': 'hyperbo_tpu_torch/csrc/batch_chol.cu',
      'replaces': 'hyperbo_tpu/ops/pallas_batch_chol.py:131',
      'launches': launches,
      'max_abs_err': err,
      'ms': k1_times['kernel'],
      'plain_ms': k1_times['plain'],
      'library_ms': None,
  }]
  replaces = {'fused_mll': 'hyperbo_tpu/ops/pallas_mll.py:922',
              'tri_inv': 'hyperbo_tpu/ops/pallas_triinv.py:543',
              'mll_bwd': 'hyperbo_tpu/ops/pallas_mll_bwd.py:417'}
  for name, k in fused_kernels.items():
    rows.append({
        'name': name,
        'route': 'cuda',
        'source': f'hyperbo_tpu_torch/csrc/{k.source}',
        'replaces': replaces[name],
        'launches': fused_launches[name],
        'max_abs_err': worst[name],
        'ms': times[name]['kernel'],
        'plain_ms': times[name]['plain'],
        'library_ms': times[name].get('library'),
    })
  replaces = {'chol_panel': 'hyperbo_tpu/ops/pallas_chol.py:121',
              'chol_hbm': 'hyperbo_tpu/ops/pallas_chol_hbm.py:825'}
  for name, k in dense_kernels.items():
    rows.append({
        'name': name,
        'route': 'cuda',
        'source': f'hyperbo_tpu_torch/csrc/{k.source}',
        'replaces': replaces[name],
        'launches': ekl_launches[name],
        'max_abs_err': dense_worst[name],
        'ms': dense_times[name]['kernel'],
        'plain_ms': dense_times[name]['plain'],
        'library_ms': dense_times[name]['library'],
    })
  rows.append({
      'name': 'mll_bwd_joint',
      'route': 'cuda',
      'source': 'hyperbo_tpu_torch/csrc/bwd_joint.cu',
      'replaces': 'hyperbo_tpu/ops/pallas_bwd_joint.py:272',
      'launches': joint_launches['mll_bwd_joint'],
      'max_abs_err': joint_worst,
      'ms': joint_times['kernel'],
      'plain_ms': joint_times['plain'],
      'library_ms': None,
  })
  rows.append({
      'name': 'gram',
      'route': 'cuda',
      'source': 'hyperbo_tpu_torch/csrc/gram.cu',
      'replaces': 'hyperbo_tpu/ops/pallas_gram.py:119',
      'launches': gram_launches,
      'max_abs_err': gram_worst,
      'ms': gram_times['gram_with_ridge']['kernel'],
      'plain_ms': gram_times['gram_with_ridge']['plain'],
      'library_ms': None,
  })
  for row in rows:
    row['bound_ms'], row['bound_by'] = bound(*work[row['name']])
  print(json.dumps({'kernels': rows}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
  main()
