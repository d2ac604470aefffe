"""Smoke run of the PyTorch/CUDA port (hyperbo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, so the script
exits non-zero and the final ok line is never printed:

  1. device: requires CUDA and prints the card's name and power limit;
  2. build: compiles kernels K1-K4 (csrc/*.cu, sm_90a) from the checkout's
     sources, one nvcc process each, all at once;
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
     checks the loss trace and that K2-K4 launched once per task per step;
  7. objectives.neg_log_marginal_likelihood value and gradient at n = 8192
     through the kernels against the dense route in float64 (value rtol
     1e-4, max rel 5e-3 per gradient leaf), and one value and gradient at
     n = 16384, finite, with its time;
  8. one JSON line with the kernels' numbers, then the ok line.

Needs one CUDA card and nvcc; imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time

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
  for _ in range(5):
    batch_chol.launch_linv_t(kb)
    batch_chol.linv_t_plain(kb)
  torch.cuda.synchronize()
  plain, kern = [], []
  for order in ('plain', 'kernel', 'kernel', 'plain'):
    if order == 'plain':
      plain += median_ms(lambda: batch_chol.linv_t_plain(kb), TIMED_RUNS)
    else:
      kern += median_ms(lambda: batch_chol.launch_linv_t(kb), TIMED_RUNS)
  ms, plain_ms = statistics.median(kern), statistics.median(plain)
  log(f'K1 time at (T={TASKS}, n={BATCH}): kernel {ms:.4f} ms, '
      f'plain {plain_ms:.4f} ms (median of {2 * TIMED_RUNS} each)')
  return worst, ms, plain_ms


def make_data(seed=0):
  """23 tasks of y = sin(3 x @ w) + 0.1 noise (bench.py's synthetic PD1
  shape), plus a 24th task of candidates for BO."""
  rng = np.random.default_rng(seed)
  dataset = {}
  for i in range(TASKS):
    x = rng.uniform(size=(POINTS, DIM))
    w = rng.normal(size=(DIM, 1))
    y = np.sin(3 * x @ w) + 0.1 * rng.normal(size=(POINTS, 1))
    dataset[f'workload{i}'] = (x.astype(np.float32), y.astype(np.float32))
  cx = rng.uniform(size=(CANDIDATES, DIM))
  w = rng.normal(size=(DIM, 1))
  cy = np.sin(3 * cx @ w) + 0.1 * rng.normal(size=(CANDIDATES, 1))
  return dataset, (cx.astype(np.float32), cy.astype(np.float32))


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


def _turns(kernel_fn, plain_fn, runs):
  """Median ms of both, timed in turns plain, kernel, kernel, plain."""
  kernel_fn()
  plain_fn()
  torch.cuda.synchronize()
  plain, kern = [], []
  for order in ('plain', 'kernel', 'kernel', 'plain'):
    if order == 'plain':
      plain += median_ms(plain_fn, runs)
    else:
      kern += median_ms(kernel_fn, runs)
  return statistics.median(kern), statistics.median(plain)


def fused_case(dev, n, d, kfam, count=None, sv=1.3, da=0.11, seed=0):
  """K2, K3 and K4 on one input against their float64 plain versions on
  the card. Returns the errors and the float32 inputs for timing."""
  from hyperbo_tpu_torch.ops import fused_mll, mll_bwd, tri_inv
  rng = np.random.default_rng(seed)
  n_pad = -(-n // fused_mll.TILE) * fused_mll.TILE
  x = np.zeros((n_pad, d))
  y = np.zeros((n_pad, 1))
  x[:n] = rng.uniform(size=(n, d)) * 2.0
  y[:n] = rng.normal(size=(n, 1))
  f32 = dict(dtype=torch.float32, device=dev)
  f64 = dict(dtype=torch.float64, device=dev)
  valid = None
  if count is not None or n_pad != n:
    valid = (np.arange(n_pad) < (n if count is None else count)).astype(
        np.float64)
  ins = {}
  for key, opts in (('32', f32), ('64', f64)):
    ins[key] = (torch.tensor(x, **opts), torch.tensor(y, **opts),
                torch.tensor(sv, **opts), torch.tensor(da, **opts),
                None if valid is None else torch.tensor(valid, **opts))
  x32, y32, sv32, da32, v32 = ins['32']
  x64, y64, sv64, da64, v64 = ins['64']

  chol, quad, ld = fused_mll.launch_mll_fused(x32, y32, sv32, da32, kfam,
                                              v32)
  chol64, quad64, ld64 = fused_mll.mll_fused_plain(x64, y64, sv64, da64,
                                                   kfam, v64)
  # K3 and K4 on the float32 rounding of the float64 factor, so that each
  # kernel is held alone against its plain version on the same input.
  # (cuSOLVER and cuBLAS return column-major results: made contiguous.)
  l_in = chol64.float().contiguous()
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
  log(f'K2-K4 n={n} d={d} {kfam}' + (' masked' if valid is not None else '')
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
  times = {
      'fused_mll': _turns(
          lambda: fused_mll.launch_mll_fused(b['x'], b['y'], b['sv'],
                                             b['da'], b['kfam']),
          lambda: fused_mll.mll_fused_plain(b['x'], b['y'], b['sv'],
                                            b['da'], b['kfam']),
          FUSED_TIMED_RUNS),
      'tri_inv': _turns(lambda: tri_inv.launch_tri_inv(b['l']),
                        lambda: tri_inv.tri_inv_plain(b['l']),
                        FUSED_TIMED_RUNS),
      'mll_bwd': _turns(
          lambda: mll_bwd.launch_mll_bwd(b['t'], b['x'], b['alpha'],
                                         b['sv'], b['kfam']),
          lambda: mll_bwd.mll_bwd_plain(b['t'], b['x'], b['alpha'],
                                        b['sv'], b['kfam']),
          FUSED_TIMED_RUNS),
  }
  for name, (ms, plain_ms) in times.items():
    log(f'{name} time at n=8192 (median of {4 * FUSED_TIMED_RUNS // 2} '
        f'each): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms')
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


def phase_fused_train(dev, card, kernels):
  """Phase 6: GP.train() through K2-K4 at full width."""
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
  log(f'fused training loss: {" ".join(f"{v:.4f}" for v in trace)}')
  if len(trace) != FUSED_STEPS or not np.isfinite(trace).all():
    raise AssertionError(f'fused loss trace not finite or short: {trace}')
  if not trace[-1] < trace[0]:
    raise AssertionError('fused training loss did not decrease')
  want = FUSED_STEPS * len(FUSED_TASKS)
  for name, count in launches.items():
    if count < want:
      raise AssertionError(f'{name} launched {count} times, want {want}')
  first_ms = (marks[1] - t0) * 1e3
  step_ms = (marks[FUSED_STEPS] - marks[1]) * 1e3 / (FUSED_STEPS - 1)
  log(f'fused launches in the main path: {launches}')
  log(f'large-n training (tasks of 8192 and 5000 rows x {FUSED_DIM}, '
      f'fused_mll): {step_ms:.3f} ms/step (first step {first_ms:.3f} ms) '
      f'[{card}]')
  return launches


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


def phase_fused_objective(dev, card):
  """Phase 7: value and gradient at n = 8192 against float64, and n = 16384."""
  rng = np.random.default_rng(6)
  data = {'t': (rng.uniform(size=(8192, FUSED_DIM)),
                rng.normal(size=(8192, 1)))}
  _value_and_grad(data, torch.float32, dev, True)  # warm-up
  val, grads, ms = _value_and_grad(data, torch.float32, dev, True)
  val64, grads64, ms64 = _value_and_grad(data, torch.float64, dev, False)
  rel = abs(val - val64) / abs(val64)
  leaf_rel = [_rel(a, b) for a, b in zip(grads, grads64)]
  log(f'n=8192 value+grad through K2-K4: {ms:.3f} ms; value rel err '
      f'{rel:.3e}; gradient max rel per leaf '
      f'{" ".join(f"{v:.3e}" for v in leaf_rel)} (float64 dense: '
      f'{ms64:.3f} ms) [{card}]')
  if not (rel <= VALUE_RTOL and max(leaf_rel) <= GRAD_MAX_REL):
    raise AssertionError(f'n=8192 parity: value {rel}, grads {leaf_rel}')
  data = {'t': (rng.uniform(size=(16384, FUSED_DIM)),
                rng.normal(size=(16384, 1)))}
  val, grads, ms = _value_and_grad(data, torch.float32, dev, True)
  if not (np.isfinite(val) and all(bool(torch.isfinite(g).all())
                                   for g in grads)):
    raise AssertionError(f'n=16384 value+grad not finite: {val}')
  log(f'n=16384 value+grad through K2-K4: {ms:.3f} ms (first call), value '
      f'{val:.4f} [{card}]')
  return ms


def main():
  # The port first: without the repo's sources there is nothing to run.
  from hyperbo_tpu_torch.ops import batch_chol, fused_mll, mll_bwd, tri_inv
  card = phase_device()
  dev = torch.device('cuda', 0)
  fused_kernels = {'fused_mll': fused_mll.KERNEL, 'tri_inv': tri_inv.KERNEL,
                   'mll_bwd': mll_bwd.KERNEL}
  phase_build([batch_chol.KERNEL, *fused_kernels.values()])
  err, ms, plain_ms = phase_k1(batch_chol, dev)
  dataset, candidates = make_data()
  phase_step_parity(dataset, dev)
  launches = phase_slice(dataset, candidates, batch_chol, dev, card)
  worst, times = phase_fused_kernels(dev)
  fused_launches = phase_fused_train(dev, card, fused_kernels)
  phase_fused_objective(dev, card)
  rows = [{
      'name': 'batched_linv_t',
      'route': 'cuda',
      'source': 'hyperbo_tpu_torch/csrc/batch_chol.cu',
      'replaces': 'hyperbo_tpu/ops/pallas_batch_chol.py:131',
      'launches': launches,
      'max_abs_err': err,
      'ms': ms,
      'plain_ms': plain_ms,
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
        'ms': times[name][0],
        'plain_ms': times[name][1],
    })
  print(json.dumps({'kernels': rows}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
  main()
