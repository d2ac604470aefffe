"""Smoke run of the PyTorch/CUDA port (hyperbo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, so the script
exits non-zero and the final ok line is never printed:

  1. device: requires CUDA and prints the card's name and power limit;
  2. build: compiles all eight kernels K1-K8 (csrc/*.cu, sm_90a) from the
     checkout's sources, one nvcc process each, all at once;
  3. K1 against its plain PyTorch version on the card: max abs error
     against the float64 plain version (bound 1e-5) at (T, n) = (23, 100),
     (3, 128), (5, 37), (2, 1), n = 31, 32, 33, 64, 65, 127 and (256, 100),
     each one launch, and on a batch that is not symmetric (the plain
     version of 0.5 (K + K^T)); the NLL terms' value and gradient; NaN for
     a non-PD task only; two calls bitwise equal, with their digest; the
     median time of both at the PD1 training shape, the kernel's per call
     and its device time (calls back to back);
  4. the main path at PD1 width: run_bayesopt(init_model=True) on 23 tasks
     x 2048 points x 4-d inputs (50 Adam steps at batch 100, so K1 runs on
     (23, 100, 100) each step), then 20 EI iterations over 10,000
     candidates; checks the loss trace, the observations and that every
     training step launched K1, and compares one step's loss on the card
     with the CPU (plain version) from the same parameters and subsample;
  5. K2, K3 and K4 (the fused large-n NLL: forward, triangular inverse,
     backward) against their plain versions in float64 on the card, at
     n = 512 (SE, d = 4), n = 700 (Matern-3/2, masked, padded to 704),
     n = 5000 (SE, d = 8, masked, padded to 5056: 79 tiles, the ragged
     level schedule of K3) and n = 8192 (SE, d = 8); two K3 calls at
     n = 8192 bitwise equal, and the digest of that T (the same on every
     build of K3's arithmetic); NaN for a non-PD input; two K2 calls at
     n = 8192 bitwise equal, one wrapper launch each, and the digest of
     that L; the same for K4 (the digest of its P, d_sv_raw and d_da);
     the median time of each kernel and its plain version at
     n = 8192, and beside K2 torch.linalg.cholesky of the same K (the Gram
     built outside the timing) as the factor's yardstick;
  6. the large-n training path: GP.train() with config['fused_mll'] on 2
     tasks of 8192 and 5000 rows x 8-d inputs (SE kernel, constant mean,
     batch 8192, 5 Adam steps; the second task runs masked at n = 8192);
     checks the loss trace, that K2-K4 launched once per task per step and
     that K8 did not (HYPERBO_BWD_JOINT unset);
  7. objectives.neg_log_marginal_likelihood value and gradient at n = 8192
     through the kernels against the dense route in float64 (value rtol
     1e-4, max rel 5e-3 per gradient leaf), and one value and gradient at
     n = 16384, finite, with the time of a first and a second call;
  8. K7 and K6 (the dense Cholesky kernels) against their float64 plain
     versions on the card (atol 5e-4): K7 at n = 1, 37, 64, 65, 128, 300,
     511, 512 (clusters of 1 to 8 blocks, ragged last block columns) and a
     (23, 100, 100) batch, K6 at n = 64, 576, 1024, 2048, 4096 and a batch
     of two at 1024; NaN for a non-PD middle matrix of a batch of three,
     and only there; each one launch a call and two calls bitwise equal,
     with that output's digest (K7 at (1, 512, 512), K6 at
     (1, 1024, 1024)); the time of each, its
     plain version and torch.linalg.cholesky at the shapes of phase 9, and
     of K6 also at (2, 1024, 1024), (1, 2048, 2048) and (1, 4096, 4096);
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
     K3 + alpha + K4 on the card, on the float32 rounding of the float64
     factor of phase 5's inputs at n = 512, 704 (700 rows, masked), 5056
     (5000 rows, masked: 79 tiles) and 8192, each for SE and a Matern
     family (max rel 5e-3 for d_x, alpha, d_sv and d_da); each call one
     launch, and the T it leaves in its scratch bitwise equal to K3's; NaN
     outputs for a NaN in L; two calls at n = 8192 bitwise equal, with
     the digest of their outputs; the median time of K8, its plain version
     and K3 + alpha + K4 at n = 8192, in the same turns;
  11. the K8 path: phase 6's training with HYPERBO_BWD_JOINT=1 (set here
     and restored after), which launches K2 and K8 once per task per step
     and K3 and K4 never, and whose loss trace matches phase 6's (rtol
     1e-4); then phase 7's n = 8192 value and gradient through K8 against
     float64;
  12. K5 (the Gram kernel) through gram_with_ridge, cross_gram and gram at
     ragged shapes (70 x 70, 41 x 17, 1000 x 333) with d = 1, 4, 8 and 40,
     all three families, against the float64 plain version (atol 2e-5 sv);
     at 8192 x 8192, d = 8, against float64, two calls bitwise equal (with
     their digest) and one launch a call; the median time of the kernel
     and its plain version at n = 8192, d = 8 and at 10,000 candidates x
     2048 points, d = 4, the kernel's per call and its device time;
  13. the packed runner at PD1 width (bench.py's PD1 leg):
     train/adam.make_fit_adam_packed with config['fast_subsample'] on
     phase 4's 23 tasks packed with pad_to_multiple=128 (50 Adam steps at
     batch 100, linear_mlp mean, squared_exponential_mlp kernel, features
     (8, 8)); two calls of one runner on two generators: a finite, falling
     loss and K1 once a step, the second call under
     torch.cuda.set_sync_debug_mode('error') (no read of the device
     between its first step and its last) and timed; one step's loss on
     the card against the CPU from the same parameters and the same
     injected permutation and window offsets (rtol 1e-4);
  14. the plain on-device BO at bench.py's configuration (constant mean,
     SE kernel, d = 4, EI, 10,000 candidates, 100 iterations, buffer 100,
     23 training tasks): two calls, both sync-free, equal; the posterior
     from the final W = L^-1 buffer against a fresh float64 Cholesky of the
     same 100 observations at every candidate (max error over the largest
     value, 1e-4); the first 10 selections against the host loop
     bayesopt.simulated_bayesopt on the same model (where they part, the
     two candidates' EI within 1e-5 relative: a near-tie); ms/iter of the
     second call and of the host loop;
  15. the q-batch and retrain runners (bench.py's variant legs): q = 1 and
     retrain_steps = 0 give phase 14's selections bitwise; q = 4 (25
     iterations, 8 training tasks) and retraining every 5 iterations
     with 10 Adam steps on a corpus of 8 tasks x 100 points packed to
     128 rows (K1 once a step: 19 retrains x 10 launches), all sync-free,
     the retrained leaves finite; ms/iter of each;
  16. run_bayesopt_ondevice on phase 4's pre-trained GP: 20 EI iterations
     over its candidates through the GP branch's dispatcher, with how many
     of its first selections are phase 4's host loop's;
  17. the fixed-sample HGP runner at bench.py's BO configuration (phase
     14's candidates and model, 100 EI iterations, 23 training tasks) with
     S = 8 samples (phase 14's model jittered in unconstrained space): two
     calls, both sync-free, equal; S identical samples give phase 14's
     selections bitwise; sample 0's posterior from its final W against a
     fresh float64 Cholesky (1e-4 of the largest value); ms/iter;
  18. the re-sampling HGP runner at bench.py's hgp_resample configuration
     (8 chains jittered from phase 14's model, 8 training tasks, phase
     15's corpus of 8 tasks x 100 points packed to 128 rows, a sweep every
     5 iterations, 100 iterations): sweeps = 0 without jitter gives phase
     14's selections bitwise; the samples finite and moved from their
     starts; K1 launched once per batched corpus evaluation (all chains
     and stepping-out edges in one launch); the flags read back per
     re-sampling; ms/iter; one corpus log prob batched over the 8 chains
     on the card against the CPU's plain route (rtol 1e-4);
  19. the hyperbo_ss method: run_bayesopt(method='hyperbo_ss',
     init_model=True) on phase 4's 23 tasks with constant mean and SE
     kernel, the device sampler (2 burn-in sweeps, 4 samples: the sampling
     config forced by bayesopt cut to burnin = 2, nsamples = 2), then 20
     EI iterations over the 10,000 candidates through
     HGP.predict_stacked; the samples' log probs finite, the observations
     distinct candidates; run_bayesopt_ondevice on the same HGP (fixed
     samples, 20 iterations) and with config['retrain'] = 1 on phase 15's
     corpus (the re-sampling runner, 5 iterations); HGP.stats() on the
     8-task corpus;
  20. multi-start Adam (train/adam.fit_adam_packed_multistart) at PD1
     width: 4 restarts of phase 13's model and packing, 50 steps at batch
     100, each restart with a batch of its own: K1 once a step over all
     4 x 23 systems, the best final loss below the start's, a second call
     under torch.cuda.set_sync_debug_mode('error') and timed beside phase
     13's single run; one step's per-restart losses on the card against
     the CPU from the same perturbation and batches (rtol 1e-4);
  21. GP.train with method 'lbfgs' and 'bfgs' on the 23 tasks subsampled
     once to 100 points, 20 iterations each on the per-task NLL: the loss
     falls, the final value on the card matches the CPU's at the same
     parameters (rtol 1e-4); ms per evaluation;
  22. GP.train(method='lbfgs') through config['fused_mll'] on phase 6's two
     tasks, 5 iterations: K2, K3 and K4 once per task per evaluation, then
     with HYPERBO_BWD_JOINT=1 K2 and K8 (K3 and K4 never); the loss falls;
  23. the host-loop Adam (train/adam.fit_adam) through GP.train with
     nll_regeuc(1.) on phase 9's data, 20 steps at batch 100: the loss
     finite and falling; ms/step;
  24. the SE-Kumar kernel: packed Adam at PD1 width (20 steps, K1 once a
     step, the warp moved), and value and gradient at n = 8192 through
     K2-K4 over the Kumar embedding against the float64 dense route (value
     rtol 1e-4, max rel 5e-3 per leaf, the warp's a and b included);
  25. GP.train(get_params_path=...) at PD1 width with a checkpoint every
     25 of 50 steps into a temporary directory: the hook at 25 and 50, the
     file's state and leaves; loaded on the CPU, its GP.stats() equals the
     trained GP's (rtol 1e-5); 50 steps resumed from it;
  27. the continuous-oracle BO at PD1 width: run_bayesopt(init_model=True)
     with an oracle (-sum((x - 0.35)^2) on [0, 1]^4, on the card) and
     data_loader_name 'uniform' on phase 4's 23 tasks (K1 once a
     pre-training step), then 20 EI iterations, each over a pool of 1000
     refined by L-BFGS-B: 20 rows, finite, in the box; a 2-iteration
     Thompson-sampling run proposes only members of its pools; one
     refinement from the same start and model on the card and on the CPU
     reaches EI values within rtol 1e-4; ms/iter, L-BFGS-B evaluations an
     iteration;
  28. the on-device continuous runner on phase 4's trained GP (EI, pools
     of 1024, 20 ascent steps at lr 0.02, 100 iterations, 5 initial
     points): two calls on equal seeds under
     torch.cuda.set_sync_debug_mode('error'), bitwise equal; with
     refine_steps = 0 each pick is a member of its pool with its EI within
     1e-4 of the pool's maximum (a fresh factor); the best observation
     beats the initial ones; ms/iter, and a profiled 10-iteration run's
     device activities an iteration and busy share;
  29. the matrix-free NLL (ops/iterative) at benchmarks/r9_iterative_probe.py's
     configuration (SE, constant mean, d = 8, 8 probes, 24 Lanczos steps,
     preconditioner rank 512): value and gradient at n = 65536 (row_chunk
     4096) and n = 131072 (clamped to 2048), a first and a second call,
     with CG's iterations (capped at 200 there) and residual and the peak
     device memory; at
     n = 8192 against the float64 dense value and gradient
     (tests/test_iterative.py's bounds at its 64 probes, three seeds); at
     n = 4096 the card against the CPU on the same injected probes (rtol
     1e-4); predict_iterative for 1,000 queries at n = 8192 against
     GP.predict; GP.train() through config['iterative_mll'] at n = 16384
     on the host-loop Adam (the JAX package's route), 5 steps, the loss
     finite and falling;
  26, last: one JSON line with the kernels' numbers (each with its bound from the
     bytes and operations of its inputs, and the time of one PyTorch call
     computing the same function where there is one; K1 and K5 also with
     their device time, device_ms; K1, K2-K4 and K8 with their launches on
     each path: the re-sampling runner's, multi-start Adam's, the fused
     L-BFGS's, the Kumar paths' and phase 27's pre-training among them),
     then the ok line.

Needs one CUDA card and nvcc; imports nothing of JAX.
"""

import hashlib
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
# Device time: calls enqueued back to back behind a sleep of the stream
# (~10 ms at the H100's 1.98 GHz boost clock) and timed as one span.
BACK_TO_BACK = 50
QUEUE_SLEEP_CYCLES = 20_000_000

# The compile-once paths (phases 13-16): bench.py's on-device BO and its
# variants.
BO_LOOP_ITERS = 100
HOST_BO_ITERS = 10
BO_POSTERIOR_RTOL = 1e-4
QBATCH = 4
RETRAIN_TASKS, RETRAIN_EVERY, RETRAIN_STEPS = 8, 5, 10
# The HGP paths (phases 17-19): bench.py's hgp_resample leg.
HGP_SAMPLES, RESAMPLE_EVERY, RESAMPLE_SWEEPS = 8, 5, 1
HGP_JITTER = 0.1
SS_BURNIN, SS_NSAMPLES, SS_BO_ITERS, SS_RESAMPLE_ITERS = 2, 2, 20, 5

# The other trainers, checkpoints and the Kumar kernels (phases 20-25).
MS_RESTARTS = 4
QN_ITERS, FUSED_QN_ITERS = 20, 5
HOST_ADAM_STEPS, KUMAR_STEPS, KUMAR_N = 20, 20, 8192
CKPT_EVERY, CKPT_STEPS = 25, 50
STATS_RTOL = 1e-5

# The continuous BO and the matrix-free NLL (phases 27-29).
CONT_ITERS, CONT_POOL = 20, 1000
CONT_LOOP_ITERS, CONT_LOOP_POOL, CONT_REFINE, CONT_LR = 100, 1024, 20, 0.02
CONT_INIT, CONT_PROFILE_ITERS = 5, 10
REFINE_RTOL = 1e-4
# EI of an unrefined pick within 1e-4 (+ 1e-6 absolute) of its pool's
# maximum recomputed from a fresh factor: two float32 factorizations.
PICK_GAP, PICK_ATOL = 1e-4, 1e-6
# benchmarks/r9_iterative_probe.py:49-80: SE, constant mean, d = 8, 8
# probes, 24 Lanczos steps, preconditioner rank 512.
IT_DIM, IT_PROBES, IT_STEPS, IT_RANK = 8, 8, 24, 512
IT_SIZES = ((65536, 4096), (131072, 4096))   # the second clamped to 2048
IT_CHECK_N, IT_PARITY_N, IT_TRAIN_N, IT_TRAIN_STEPS = 8192, 4096, 16384, 5
IT_QUERIES = 1000
# tests/test_iterative.py: value 0.05 (:85), at 64 probes and 30 Lanczos
# steps a leaf's gradient 0.6 of its scale a draw and 0.25 averaged over
# three (:91-133), the constant's rtol 1e-3; the posterior's mean atol 2e-3
# rtol 1e-3, variance atol 2e-3 rtol 2e-2 (:235-297).
IT_VALUE_REL, IT_LEAF_DRAW, IT_LEAF_MEAN, IT_CONST_RTOL = 0.05, 0.6, 0.25, 1e-3
IT_CHECK_PROBES, IT_CHECK_STEPS, IT_SEEDS = 64, 30, (3, 5, 7)
IT_CHUNK = 4096        # row_chunk of the checks and of the training
# CG's iteration cap at the two large sizes (the JAX default is 1000): a
# run that needs more fails in minutes instead of running out the clock.
IT_MAXITER = 200

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
  # The training shape, one panel and partial ones (31-33), two panels and
  # a ragged third (64, 65), n = 127 and 128, and more tasks than SMs.
  for t, n in ((23, 100), (3, 128), (5, 37), (2, 1), (1, 31), (1, 32),
               (1, 33), (1, 64), (1, 65), (1, 127), (256, 100)):
    kb = spd_batch(rng, t, n)
    before = batch_chol.KERNEL.launches
    got = batch_chol.batched_linv_t(torch.from_numpy(kb).to(dev))
    launches = batch_chol.KERNEL.launches - before
    # The plain version of what the kernel factors, 0.5 (K + K^T).
    want = batch_chol.linv_t_plain(symmetrized(torch.from_numpy(kb).double()
                                                .to(dev)))
    err = float((got.double() - want).abs().max())
    log(f'K1 (T={t}, n={n}): max abs err vs float64 plain {err:.3e}, '
        f'{launches} launch')
    if not (err <= K1_ATOL and launches == 1):
      raise AssertionError(f'K1 error {err} > {K1_ATOL} at ({t}, {n}), or '
                           f'{launches} launches')
    worst = max(worst, err)
  # A batch that is not symmetric: the kernel symmetrizes as it loads.
  kb = torch.from_numpy(spd_batch(rng, 4, 100)).to(dev)
  kb = kb + 0.01 * torch.triu(torch.ones_like(kb), diagonal=1)
  err = float((batch_chol.batched_linv_t(kb).double() -
               batch_chol.linv_t_plain(symmetrized(kb.double()))).abs().max())
  log(f'K1 (T=4, n=100) not symmetric: max abs err vs the float64 plain '
      f'version of 0.5 (K + K^T) {err:.3e}')
  if not err <= K1_ATOL:
    raise AssertionError(f'K1 error {err} on a batch that is not symmetric')
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
  first = batch_chol.batched_linv_t(kb)
  if not torch.equal(first, batch_chol.batched_linv_t(kb)):
    raise AssertionError('K1: two calls differ')
  log(f'K1 two calls at (T={TASKS}, n={BATCH}): bitwise equal; output '
      f'digest {digest(first)}')
  fns = dict(plain=lambda: batch_chol.linv_t_plain(symmetrized(kb)),
             kernel=lambda: batch_chol.batched_linv_t(kb))
  ms = _turns(TIMED_RUNS, **fns)
  ms['device'], spans = device_turns(5, kernel=fns['kernel'])['kernel']
  log(f'K1 time at (T={TASKS}, n={BATCH}): kernel {ms["kernel"]:.4f} ms '
      f'per call, {ms["device"]:.4f} ms device time; plain '
      f'{ms["plain"]:.4f} ms (per call: median of {2 * TIMED_RUNS}, one call '
      f'a pair of events; device: median of {spans} measured of 10 spans of '
      f'{BACK_TO_BACK} calls back to back)')
  return worst, ms


def symmetrized(kb):
  """0.5 (K + K^T), as batched_linv_t takes its input."""
  return 0.5 * (kb + kb.transpose(-1, -2))


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
  (xo, yo), best, trained = bayesopt.run_bayesopt(
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
  return launches, trained, xo


def _rel(a, b):
  """max |a - b| / max |b| over the entries (b the float64 reference)."""
  a = torch.as_tensor(a).double()
  b = torch.as_tensor(b).double()
  return float((a - b).abs().max() / b.abs().max())


def digest(t):
  """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
  return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


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


def device_ms(fn, launches=BACK_TO_BACK):
  """The device's own ms a call: CUDA events around `launches` calls back
  to back, divided by their count. The calls are enqueued while the stream
  waits in torch.cuda._sleep, so the host's work between calls leaves the
  device no gap. NaN, with a line saying why, where the host took longer
  to enqueue than the sleep lasted (a call that waits on the device)."""
  fn()
  ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
  torch.cuda.synchronize()
  ev[0].record()
  torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
  ev[1].record()
  t0 = time.perf_counter()
  for _ in range(launches):
    fn()
  host_ms = (time.perf_counter() - t0) * 1e3
  ev[2].record()
  ev[2].synchronize()
  slept = ev[0].elapsed_time(ev[1])
  if not host_ms < slept:
    log(f'device time not measured: enqueueing {launches} calls took '
        f'{host_ms:.3f} ms, the sleep that kept them queued {slept:.3f} ms')
    return float('nan')
  return ev[1].elapsed_time(ev[2]) / launches


def device_turns(runs, **fns):
  """{name: (median ms, spans measured)} over `runs` device_ms readings of
  each function, in turns as _turns takes them: the median of the readings
  that measured something (NaN if none did)."""
  times = {name: [] for name in fns}
  for name in list(fns) + list(reversed(fns)):
    times[name] += [device_ms(fns[name]) for _ in range(runs)]
  out = {}
  for name, t in times.items():
    got = [v for v in t if v == v]
    out[name] = (statistics.median(got or [float('nan')]), len(got))
  return out


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
                           (5000, FUSED_DIM, 'se', 4),
                           (8192, FUSED_DIM, 'se', 3)):
    errs, inputs = fused_case(dev, n, d, kfam, seed=seed)
    worst['fused_mll'] = max(worst['fused_mll'], errs['L_abs'])
    worst['tri_inv'] = max(worst['tri_inv'], errs['T_abs'])
    worst['mll_bwd'] = max(worst['mll_bwd'], errs['P_abs'])
    big = inputs
  # K3 sums in a fixed order (no atomics, no split-k).
  t_big = tri_inv.launch_tri_inv(big['l'])
  if not torch.equal(t_big, tri_inv.launch_tri_inv(big['l'])):
    raise AssertionError('K3: two calls at n=8192 differ')
  log(f'K3 two calls at n=8192: bitwise equal; output digest '
      f'{digest(t_big)}')

  fused_nonpd_check(dev)
  # K2's entries are each one sum in a fixed order (no atomics): two calls
  # give the same bits, through one wrapper launch each.
  b = big
  before = fused_mll.KERNEL.launches
  first = fused_mll.launch_mll_fused(b['x'], b['y'], b['sv'], b['da'])
  k2_launches = fused_mll.KERNEL.launches - before
  second = fused_mll.launch_mll_fused(b['x'], b['y'], b['sv'], b['da'])
  if not (all(torch.equal(u, v) for u, v in zip(first, second)) and
          k2_launches == 1):
    raise AssertionError(f'K2: two calls at n=8192 differ, or '
                         f'{k2_launches} launches a call')
  log(f'K2 two calls at n=8192: bitwise equal, one launch each; output '
      f'digest {digest(first[0])}')
  del first, second
  # K4's entries are each one sum in a fixed order (no atomics) too.
  before = mll_bwd.KERNEL.launches
  first = mll_bwd.launch_mll_bwd(b['t'], b['x'], b['alpha'], b['sv'])
  k4_launches = mll_bwd.KERNEL.launches - before
  second = mll_bwd.launch_mll_bwd(b['t'], b['x'], b['alpha'], b['sv'])
  if not (all(torch.equal(u, v) for u, v in zip(first, second)) and
          k4_launches == 1):
    raise AssertionError(f'K4: two calls at n=8192 differ, or '
                         f'{k4_launches} launches a call')
  log(f'K4 two calls at n=8192: bitwise equal, one launch each; output '
      f'digest {digest(torch.cat([o.reshape(-1) for o in first]))}')
  del first, second

  # One library call computes K3's function: the n-RHS triangular solve.
  # None computes K2's (Gram, Cholesky, solve and logdet): the Cholesky of
  # the same K (built outside the timing) is timed beside it as the
  # factor's yardstick.
  eye = torch.eye(b['l'].shape[0], device=dev)
  gram = fused_gram(b['x'], b['sv'], b['da'])
  times = {
      'fused_mll': _turns(
          FUSED_TIMED_RUNS,
          plain=lambda: fused_mll.mll_fused_plain(b['x'], b['y'], b['sv'],
                                                  b['da'], b['kfam']),
          kernel=lambda: fused_mll.launch_mll_fused(b['x'], b['y'], b['sv'],
                                                    b['da'], b['kfam']),
          cholesky=lambda: torch.linalg.cholesky(gram)),
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
  del gram
  for name, ms in times.items():
    log(f'{name} time at n=8192 (median of {2 * FUSED_TIMED_RUNS} each): ' +
        ', '.join(f'{k} {v:.3f} ms' for k, v in ms.items()))
  return worst, times


def fused_gram(x, sv, da):
  """The SE Gram K = sv k + da I of x as K2 builds it (unmasked)."""
  from hyperbo_tpu_torch.ops import fused_mll, mll_bwd
  # pylint: disable-next=protected-access
  kmat = fused_mll._gram_transform(mll_bwd.raw_sqdist(x), sv, 'se')
  return kmat + da * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)


def fused_nonpd_check(dev):
  """Not positive definite (da < 0): NaN value, NaN-or-zero gradients
  through K2 and the default backward."""
  from hyperbo_tpu_torch.ops import fused_mll
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
  again = _value_and_grad(data, torch.float32, dev, True)[2]
  log(f'n=16384 value+grad through K2-K4: {ms:.3f} ms (first call), '
      f'{again:.3f} ms (second), value {val:.4f} [{card}]')
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
  alpha + K4 on the same float32 factor, its T against K3's, one launch a
  call, NaN for a NaN factor, two calls bitwise equal, timing at
  n = 8192."""
  from hyperbo_tpu_torch.ops import bwd_joint, tri_inv
  names = ('d_x', 'alpha', 'dsv_raw', 'd_da')
  worst = 0.0
  for n, d, kfam, seed in ((512, 4, 'se', 1), (512, 4, 'matern52', 5),
                           (700, 3, 'matern32', 2),
                           (5000, FUSED_DIM, 'se', 4),
                           (5000, FUSED_DIM, 'matern32', 6),
                           (8192, FUSED_DIM, 'matern52', 7),
                           (8192, FUSED_DIM, 'se', 3)):
    ins32, ins64 = fused_inputs(dev, n, d, seed)
    x32, y32, sv32, _, v32 = ins32
    x64, y64, sv64, _, v64 = ins64
    l_in = input_factor(ins64, kfam)[3]
    before = bwd_joint.KERNEL.launches
    # pylint: disable-next=protected-access
    got, t_joint = bwd_joint._launch(l_in, x32, y32, sv32, kfam, v32)
    launches = bwd_joint.KERNEL.launches - before
    t_same = torch.equal(t_joint, tri_inv.launch_tri_inv(l_in))
    want = bwd_joint.mll_bwd_joint_plain(l_in.double(), x64, y64, sv64, kfam,
                                         v64)
    route = joint_route(l_in, x32, y32, sv32, kfam, v32)
    torch.cuda.synchronize()
    rel = {k: _rel(a, b) for k, a, b in zip(names, got, want)}
    rel_route = {k: _rel(a, b) for k, a, b in zip(names, got, route)}
    worst = max([worst] + [float((a.double() - b).abs().max())
                           for a, b in zip(got[:2], want[:2])])
    log(f'K8 n={l_in.shape[0]} d={d} {kfam}' +
        (' masked' if v32 is not None else '') + ': max rel vs float64 ' +
        ', '.join(f'{k} {v:.3e}' for k, v in rel.items()) +
        '; vs K3 + alpha + K4 ' +
        ', '.join(f'{k} {v:.3e}' for k, v in rel_route.items()) +
        f'; launches {launches}; T bitwise K3\'s {t_same}')
    for key in names:
      if not (rel[key] <= GRAD_MAX_REL and rel_route[key] <= GRAD_MAX_REL):
        raise AssertionError(f'K8 {key} at n={n} {kfam}: {rel[key]} vs '
                             f'float64, {rel_route[key]} vs K3 + K4')
    if not (launches == 1 and t_same):
      raise AssertionError(f'K8 at n={n} {kfam}: {launches} launches, T '
                           f'equal to K3\'s {t_same}')
    if n in (512, 5000) and kfam == 'se':
      bad = l_in.clone()
      bad[-1, 0] = float('nan')
      outs = bwd_joint.launch_mll_bwd_joint(bad, x32, y32, sv32, kfam, v32)
      if not all(bool(torch.isnan(o).all()) for o in outs):
        raise AssertionError('K8 must give NaN outputs for a NaN factor')
      log(f'K8 NaN in L at n={l_in.shape[0]}: NaN outputs')
  # The SE case at n = 8192 is the last: deterministic, then timed.
  again = bwd_joint.launch_mll_bwd_joint(l_in, x32, y32, sv32, kfam, v32)
  if not all(torch.equal(a, b) for a, b in zip(got, again)):
    raise AssertionError('K8: two calls at n=8192 differ')
  log(f'K8 two calls at n=8192: bitwise equal; output digest '
      f'{digest(torch.cat([o.reshape(-1) for o in got]))}')
  ms = _turns(
      FUSED_TIMED_RUNS,
      plain=lambda: bwd_joint.mll_bwd_joint_plain(l_in, x32, y32, sv32, kfam),
      kernel=lambda: bwd_joint.launch_mll_bwd_joint(l_in, x32, y32, sv32,
                                                    kfam),
      route=lambda: joint_route(l_in, x32, y32, sv32, kfam))
  log(f'mll_bwd_joint time at n=8192 (median of {2 * FUSED_TIMED_RUNS} '
      f'each, in the same turns): kernel {ms["kernel"]:.3f} ms, plain '
      f'{ms["plain"]:.3f} ms, K3 + alpha + K4 {ms["route"]:.3f} ms; kernel '
      f'/ K3 + alpha + K4 {ms["kernel"] / ms["route"]:.3f}')
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
  # The large-n Gram (rows 16-byte aligned: the float4 stores) against
  # float64, two calls bitwise equal, one launch a call.
  before = fused_gram.KERNEL.launches
  first = fused_gram.gram(xb, xb, sv, ridge, 'se', add_ridge=True)
  second = fused_gram.gram(xb, xb, sv, ridge, 'se', add_ridge=True)
  big_launches = fused_gram.KERNEL.launches - before
  err = float((first.double() - fused_gram.gram_plain(
      xb.double(), xb.double(), sv, ridge, 'se', True)).abs().max())
  log(f'K5 gram {tuple(first.shape)} d={xb.shape[1]}: max abs err vs float64 '
      f'{err:.3e}; two calls bitwise equal {torch.equal(first, second)}, '
      f'{big_launches} launches; output digest {digest(first)}')
  if not (err <= GRAM_ATOL * sv and torch.equal(first, second) and
          big_launches == 2):
    raise AssertionError('K5 at 8192 x 8192: error past the bound, two '
                         'calls differ, or not one launch a call')
  worst = max(worst, err)
  del first, second
  c1 = torch.tensor(candidates[0], device=dev)
  c2 = torch.tensor(dataset['workload0'][0], device=dev)
  center = torch.cat([c1, c2]).mean(dim=0, keepdim=True)
  c1, c2 = c1 - center, c2 - center
  times = {}
  for name, a, b, add in (('gram_with_ridge', xb, xb, True),
                          ('cross_gram', c1, c2, False)):
    fns = dict(
        plain=lambda: fused_gram.gram_plain(a, b, sv, ridge, 'se', add),
        kernel=lambda: fused_gram.launch_gram(a, b, sv, ridge, 'se', add))
    times[name] = _turns(DENSE_TIMED_RUNS, **fns)
    times[name]['device'], spans = device_turns(
        5, kernel=fns['kernel'])['kernel']
    log(f'K5 {name} time at {tuple(a.shape)} x {tuple(b.shape)}: kernel '
        f'{times[name]["kernel"]:.4f} ms per call, '
        f'{times[name]["device"]:.4f} ms device time; plain '
        f'{times[name]["plain"]:.4f} ms (per call: median of '
        f'{2 * DENSE_TIMED_RUNS}, one call a pair of events; device: median '
        f'of {spans} measured of 10 spans of {BACK_TO_BACK} calls back to '
        'back)')
  return worst, launches, times


def measured(ms):
  """ms, or None where it was not measured (NaN): JSON has no NaN."""
  return ms if ms == ms else None


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
  # K7: one block (n <= 64), ragged block columns (37, 65, 300, 511), the
  # full cluster of eight (511, 512) and the packed training batch.
  cases = [('chol_panel', 1, n) for n in (1, 37, 64, 65, 128, 300, 511, 512)]
  cases += [('chol_panel', TASKS, BATCH)]
  # K6: one diagonal factor (64), n not a multiple of 512 (576), the
  # route's 1024 alone and side by side, and longer chains.
  cases += [('chol_hbm', 1, n) for n in (64, 576, 1024, 2048, 4096)]
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
  # A negative pivot in the last block column of the middle matrix fails
  # late, while the other matrices' factors finish.
  for name, n in (('chol_panel', 300), ('chol_panel', 512),
                  ('chol_hbm', 1024)):
    bad = spd_batch(rng, 3, n)
    bad[1, -1, -1] = -5.0
    got = launch[name](torch.from_numpy(bad).to(dev))
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(got[[0, 2]]).all()) and
            bool(torch.isnan(got[1]).all())):
      raise AssertionError(f'{name} must give NaN for the non-PD matrix only')
    log(f'{name} non-PD middle matrix of (3, {n}, {n}): NaN for that matrix '
        'only')
  kernels = {'chol_panel': chol_panel.KERNEL, 'chol_hbm': chol_hbm.KERNEL}
  for name, n in (('chol_panel', 512), ('chol_hbm', ALIGNED_POINTS)):
    a = torch.from_numpy(spd_batch(rng, 1, n)).to(dev)
    before = kernels[name].launches
    first = launch[name](a)
    if kernels[name].launches != before + 1:
      raise AssertionError(f'{name} must be one launch a call')
    if not torch.equal(first, launch[name](a)):
      raise AssertionError(f'{name}: two calls at (1, {n}, {n}) differ')
    log(f'{name} (1, {n}, {n}): one launch a call, two calls bitwise equal; '
        f'output digest {digest(first)}')

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
  for t, n in ((2, 1024), (1, 2048), (1, 4096)):
    a = torch.from_numpy(spd_batch(rng, t, n)).to(dev)
    a = 0.5 * (a + a.transpose(-1, -2))
    ms = _turns(DENSE_TIMED_RUNS, kernel=lambda: chol_hbm.launch_chol_hbm(a),
                library=lambda: torch.linalg.cholesky(a))
    log(f'chol_hbm time at ({t}, {n}, {n}) (median of {2 * DENSE_TIMED_RUNS} '
        f'each): kernel {ms["kernel"]:.4f} ms, torch.linalg.cholesky '
        f'{ms["library"]:.4f} ms')
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
    loss_fn, (pnll, pekl), _, _ = gp._build_packed_training(
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


class no_host_sync:
  """torch.cuda.set_sync_debug_mode('error') for the duration: any
  operation that waits for the device (a read back, a blocking copy)
  raises inside the block."""

  def __enter__(self):
    torch.cuda.set_sync_debug_mode('error')

  def __exit__(self, *exc):
    torch.cuda.set_sync_debug_mode(0)


def bo_model(dev):
  """bench.py's on-device BO model (constant mean, SE kernel, d = 4), its
  leaves on the card before any run (so that no run copies them there)."""
  from hyperbo_tpu_torch.core import convert
  return convert.model_to({'constant': 0.0, 'lengthscale': np.zeros(DIM),
                           'signal_variance': 0.0, 'noise_variance': -3.0},
                          dev)


def phase_packed_runner(dataset, batch_chol, dev, card):
  """Phase (a): make_fit_adam_packed at PD1 width with fast_subsample (the
  window sampler), two calls of one runner on two generators: K1 once a
  step, a falling loss, the second call free of host syncs; one step's
  loss on the card against the CPU from the same parameters and the same
  injected permutation and offsets. Returns K1's launches of one call."""
  from unittest import mock
  from hyperbo_tpu_torch.core import convert
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean
  from hyperbo_tpu_torch.models import packed as packed_lib
  from hyperbo_tpu_torch.train import adam

  params = init_params(STEPS)
  params.config['fast_subsample'] = True
  model = gp.GP(dataset, mean.linear_mlp, kernel.squared_exponential_mlp,
                params, DEFAULT_WARP_FUNC, device=dev)
  model.initialize_params(torch.Generator(device=dev).manual_seed(1))
  model0 = model.params.model
  packed, _ = packed_lib.pack_dataset(model.dataset, pad_to_multiple=128,
                                      device=dev)
  config = model.params.config
  run = adam.make_fit_adam_packed(mean.linear_mlp,
                                  kernel.squared_exponential_mlp, config,
                                  warp_func=DEFAULT_WARP_FUNC)
  batch_chol.KERNEL.launches = 0
  _, losses = run(model0, packed, torch.Generator(device=dev).manual_seed(0))
  trace = losses.cpu().numpy()
  launches = batch_chol.KERNEL.launches
  log(f'packed runner: loss first {trace[0]:.4f}, last {trace[-1]:.4f} over '
      f'{len(trace)} steps; K1 launches {launches}')
  if not (len(trace) == STEPS and np.isfinite(trace).all() and
          trace[-10:].mean() < trace[:10].mean()):
    raise AssertionError(f'packed runner loss trace: {trace}')
  if launches != STEPS:
    raise AssertionError(f'K1 launched {launches} times in {STEPS} steps')
  gen = torch.Generator(device=dev).manual_seed(1)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  with no_host_sync():
    trained, losses = run(model0, packed, gen)
  torch.cuda.synchronize()
  step_ms = (time.perf_counter() - t0) * 1e3 / STEPS
  if not torch.isfinite(losses).all():
    raise AssertionError('packed runner: non-finite loss on the 2nd call')
  log(f'packed runner (make_fit_adam_packed, fast_subsample, {TASKS}x'
      f'{POINTS}x{DIM}, batch {BATCH}): second call {step_ms:.3f} ms/step, '
      f'no host sync between its first step and its last [{card}]')

  # One step on the card and on the CPU, the draws injected.
  rng = np.random.default_rng(4)
  order = torch.from_numpy(np.stack([rng.permutation(packed.x.shape[1])
                                     for _ in range(TASKS)]))
  offsets = torch.from_numpy(rng.integers(0, POINTS - BATCH + 1, TASKS))
  one = adam.make_fit_adam_packed(
      mean.linear_mlp, kernel.squared_exponential_mlp,
      dict(config, max_training_step=1), warp_func=DEFAULT_WARP_FUNC)
  step_losses = []
  for device in ('cpu', dev):
    with mock.patch.object(packed_lib, 'draw_permutation',
                           lambda g, p: order.to(device)), \
         mock.patch.object(packed_lib, 'draw_window_offsets',
                           lambda g, p, b: offsets.to(device)):
      _, loss = one(convert.model_to(model0, device),
                    packed_lib.PackedDataset(*[t.to(device) for t in packed]),
                    torch.Generator(device=device))
    step_losses.append(float(loss[0]))
  rel = abs(step_losses[1] - step_losses[0]) / abs(step_losses[0])
  log(f'packed runner first-step loss: card {step_losses[1]:.6f}, cpu '
      f'{step_losses[0]:.6f}, rel diff {rel:.3e}')
  if not rel <= STEP_LOSS_RTOL:
    raise AssertionError(f'card/cpu packed-runner loss differ by {rel}')
  return launches, step_ms


def float64_posterior(x_obs, y_obs, cand_x, model, scale):
  """GP posterior (mu, noisy var x scale) at the candidates from a fresh
  float64 Cholesky of the observations (constant mean, SE kernel)."""
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC, retrieve_params
  from hyperbo_tpu_torch.models import kernel
  m64 = {k: v.double() for k, v in model.items()}
  const, nv = retrieve_params(m64, ['constant', 'noise_variance'],
                              DEFAULT_WARP_FUNC)
  x, cx = x_obs.double(), cand_x.double()
  kmat = kernel.squared_exponential(m64, x, warp_func=DEFAULT_WARP_FUNC)
  kmat = kmat + (nv + 1e-6) * torch.eye(len(x), dtype=kmat.dtype,
                                         device=kmat.device)
  chol = torch.linalg.cholesky(kmat)
  cross = kernel.squared_exponential(m64, x, cx, warp_func=DEFAULT_WARP_FUNC)
  mu = cross.T @ torch.cholesky_solve(y_obs.double() - const, chol) + const
  v = torch.linalg.solve_triangular(chol, cross, upper=False)
  kdiag = kernel.squared_exponential(m64, cx, warp_func=DEFAULT_WARP_FUNC,
                                     diag=True)
  var = torch.clamp(kdiag - (v * v).sum(0), min=1e-12)[:, None]
  return mu, (var + nv) * scale


def phase_ondevice_bo(candidates, dev, card):
  """Phase (b): the plain on-device BO at bench.py's configuration, both
  calls free of host syncs; the final W's posterior against float64; the
  first selections against the host loop. Returns (selections, ms/iter,
  host ms/iter)."""
  from hyperbo_tpu_torch.bo import acfun, bayesopt, ondevice
  from hyperbo_tpu_torch.core import defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean
  from hyperbo_tpu_torch.ops import chol as chol_ops

  model = bo_model(dev)
  config = {'learning_rate': 1e-2}
  cand_x = torch.from_numpy(candidates[0]).to(dev)
  cand_y = torch.from_numpy(candidates[1]).to(dev)
  queried = defs.SubDataset(cand_x, cand_y)
  run = ondevice.make_bo_runner(mean.constant, kernel.squared_exponential,
                                config, DEFAULT_WARP_FUNC, 'ei', BO_LOOP_ITERS,
                                0, BO_LOOP_ITERS, TASKS)
  x0 = cand_x.new_zeros((0, DIM))
  gen = torch.Generator(device=dev).manual_seed(0)
  with no_host_sync():
    x_buf, y_buf, sel, winv = run(
        model, cand_x.new_zeros((BO_LOOP_ITERS, DIM)),
        cand_x.new_zeros((BO_LOOP_ITERS, 1)),
        chol_ops.init_chol_buffer(BO_LOOP_ITERS, device=dev), 0, x0,
        x0[:, :1], cand_x, cand_y, gen, return_factor=True)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  with no_host_sync():
    xo, yo, sel2 = ondevice.simulated_bayesopt_ondevice(
        mean.constant, kernel.squared_exponential, model, config,
        DEFAULT_WARP_FUNC, queried, BO_LOOP_ITERS, acquisition='ei',
        num_train_tasks=TASKS, generator=gen, device=dev)
  torch.cuda.synchronize()
  iter_ms = (time.perf_counter() - t0) * 1e3 / BO_LOOP_ITERS
  if not (torch.equal(sel, sel2) and torch.equal(xo, x_buf)):
    raise AssertionError('two on-device BO calls differ')
  if not (torch.isfinite(xo).all() and torch.isfinite(yo).all()):
    raise AssertionError('on-device BO: non-finite observations')

  # The final W's posterior at every candidate against float64.
  scale = ondevice._unbiased_scale(TASKS)
  shim = defs.GPParams(model=model, config=config)
  mu, var = ondevice._masked_posterior(
      mean.constant, kernel.squared_exponential, shim, DEFAULT_WARP_FUNC,
      ondevice._noise(shim, DEFAULT_WARP_FUNC), scale, x_buf, y_buf, winv,
      BO_LOOP_ITERS, cand_x)
  mu64, var64 = float64_posterior(x_buf, y_buf, cand_x, model, scale)
  errs = {'mu': _rel(mu, mu64), 'var': _rel(var, var64)}
  log(f'on-device BO after {BO_LOOP_ITERS} appends: posterior from W vs a '
      f'fresh float64 Cholesky at {CANDIDATES} candidates: max rel err mu '
      f'{errs["mu"]:.3e}, var {errs["var"]:.3e} (of the largest value)')
  if not max(errs.values()) <= BO_POSTERIOR_RTOL:
    raise AssertionError(f'W posterior differs from float64: {errs}')

  # The host loop on the same model and training tasks (so the same
  # unbiased rescale): the same first selections, or a near-tie where
  # they part.
  def host_gp():
    return gp.GP(make_data()[0], mean.constant, kernel.squared_exponential,
                 defs.GPParams(model=dict(model), config=dict(config)),
                 DEFAULT_WARP_FUNC, device=dev)

  t0 = time.perf_counter()
  obs = bayesopt.simulated_bayesopt(host_gp(), 'test', queried, acfun.ei,
                                    HOST_BO_ITERS)
  torch.cuda.synchronize()
  host_ms = (time.perf_counter() - t0) * 1e3 / HOST_BO_ITERS
  picks = sel[:HOST_BO_ITERS].cpu().tolist()
  host_picks = [int(torch.nonzero((cand_x == row).all(dim=1))[0, 0])
                for row in obs.x]
  log(f'host loop picks {host_picks}, on-device {picks}')
  if host_picks != picks:
    j = next(i for i, (a, b) in enumerate(zip(host_picks, picks)) if a != b)
    again = host_gp()
    bayesopt.simulated_bayesopt(again, 'test', queried, acfun.ei, j)
    ei = acfun.ei(model=again, sub_dataset_key='test',
                  x_queries=cand_x[[host_picks[j], picks[j]]])[:, 0]
    rel = float((ei[0] - ei[1]).abs() / ei.abs().max())
    log(f'selections part at iteration {j}: host EI {float(ei[0]):.9g}, '
        f'on-device pick EI {float(ei[1]):.9g}, rel diff {rel:.3e}')
    if not rel <= 1e-5:
      raise AssertionError(f'on-device BO parts from the host loop at {j}')
  log(f'on-device BO (ei, {CANDIDATES} candidates, {BO_LOOP_ITERS} '
      f'iterations, buffer {BO_LOOP_ITERS}): second call {iter_ms:.3f} '
      f'ms/iter, no host sync inside; host loop {host_ms:.3f} ms/iter over '
      f'{HOST_BO_ITERS} iterations [{card}]')
  return sel, iter_ms, host_ms


def corpus_tasks():
  """bench.py's retrain corpus: 8 tasks x 100 points of y = sin(3 x @ w)."""
  from hyperbo_tpu_torch.core import defs
  rng = np.random.default_rng(100)
  corpus = {}
  for i in range(RETRAIN_TASKS):
    x = rng.uniform(size=(100, DIM)).astype(np.float32)
    y = np.sin(3 * x @ rng.normal(size=(DIM, 1))).astype(np.float32)
    corpus[i] = defs.SubDataset(x, y)
  return corpus


def retrain_corpus(dev):
  """The retrain corpus packed with pad_to_multiple=128 (K1's regime)."""
  from hyperbo_tpu_torch.models import packed as packed_lib
  return packed_lib.pack_dataset(corpus_tasks(), pad_to_multiple=128,
                                 device=dev)[0]


def phase_bo_variants(candidates, sel_plain, batch_chol, dev, card):
  """Phase (c): q-batch and retrain runners at bench.py's configuration:
  q = 1 and retrain_steps = 0 give phase (b)'s selections bitwise; q = 4
  and retraining every 5 iterations (10 steps, K1 on the corpus) timed.
  Returns (K1 launches of the retrain run, {name: ms/iter})."""
  from hyperbo_tpu_torch.bo import ondevice
  from hyperbo_tpu_torch.core import defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import kernel, mean

  model = bo_model(dev)
  config = {'learning_rate': 1e-2}
  queried = defs.SubDataset(torch.from_numpy(candidates[0]).to(dev),
                            torch.from_numpy(candidates[1]).to(dev))
  common = (mean.constant, kernel.squared_exponential, model, config,
            DEFAULT_WARP_FUNC, queried)
  gen = torch.Generator(device=dev).manual_seed(0)
  with no_host_sync():
    _, _, sel_q1 = ondevice.simulated_bayesopt_ondevice_qbatch(
        *common, BO_LOOP_ITERS, q=1, num_train_tasks=TASKS, generator=gen,
        device=dev)
    _, _, sel_r0, _ = ondevice.simulated_bayesopt_ondevice_retrain(
        *common, BO_LOOP_ITERS, num_train_tasks=TASKS, retrain_steps=0,
        generator=gen, device=dev)
  if not (torch.equal(sel_q1[:, 0], sel_plain) and
          torch.equal(sel_r0, sel_plain)):
    raise AssertionError('q = 1 or retrain_steps = 0 parts from the plain '
                         'runner')
  log(f'q-batch q = 1 and retrain_steps = 0: the plain runner\'s '
      f'{BO_LOOP_ITERS} selections, bitwise')

  ms = {}
  q_iters = BO_LOOP_ITERS // QBATCH
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  with no_host_sync():
    xq, yq, sel_q = ondevice.simulated_bayesopt_ondevice_qbatch(
        *common, q_iters, q=QBATCH, num_train_tasks=RETRAIN_TASKS,
        generator=gen, device=dev)
  torch.cuda.synchronize()
  ms['qbatch'] = (time.perf_counter() - t0) * 1e3 / q_iters
  if not (tuple(sel_q.shape) == (q_iters, QBATCH) and
          torch.isfinite(yq).all()):
    raise AssertionError('q-batch output malformed')

  pp = retrain_corpus(dev)
  events = sum(1 for i in range(BO_LOOP_ITERS)
               if i % RETRAIN_EVERY == 0 and i > 0)
  batch_chol.KERNEL.launches = 0
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  with no_host_sync():
    _, yr, sel_r, trained = ondevice.simulated_bayesopt_ondevice_retrain(
        *common, BO_LOOP_ITERS, num_train_tasks=RETRAIN_TASKS,
        pretrain_packed=pp, retrain_every=RETRAIN_EVERY,
        retrain_steps=RETRAIN_STEPS, generator=gen, device=dev)
  torch.cuda.synchronize()
  ms['retrain'] = (time.perf_counter() - t0) * 1e3 / BO_LOOP_ITERS
  launches = batch_chol.KERNEL.launches
  want = events * RETRAIN_STEPS
  log(f'retrain runner: {events} retrains x {RETRAIN_STEPS} steps x 1 K1 '
      f'call a step = {want}; K1 counted {launches}')
  if launches != want:
    raise AssertionError(f'K1 launched {launches} times, want {want}')
  leaves = [v for v in trained.values()]
  if not all(bool(torch.isfinite(v).all()) for v in leaves):
    raise AssertionError('retrained model has non-finite leaves')
  if not torch.isfinite(yr).all():
    raise AssertionError('retrain run: non-finite observations')
  log(f'q-batch (q = {QBATCH}, {q_iters} iterations, {CANDIDATES} '
      f'candidates): {ms["qbatch"]:.3f} ms/iter '
      f'({ms["qbatch"] / QBATCH:.3f} ms an evaluation); retrain (every '
      f'{RETRAIN_EVERY}, {RETRAIN_STEPS} steps, corpus {RETRAIN_TASKS} x '
      f'100): {ms["retrain"]:.3f} ms/iter; no host sync inside either '
      f'[{card}]')
  return launches, ms


def phase_dispatcher(dataset, candidates, trained_params, host_obs, dev,
                     card):
  """Phase (d): run_bayesopt_ondevice on phase 4's pre-trained GP, 20 EI
  iterations over its candidates through the GP branch's dispatcher."""
  from hyperbo_tpu_torch.bo import ondevice
  from hyperbo_tpu_torch.core import defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean

  model = gp.GP(dataset, mean.linear_mlp, kernel.squared_exponential_mlp,
                defs.GPParams(model=trained_params.model,
                              config=dict(trained_params.config)),
                DEFAULT_WARP_FUNC, device=dev)
  queried = defs.SubDataset(torch.from_numpy(candidates[0]).to(dev),
                            torch.from_numpy(candidates[1]).to(dev))
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  # Not sync-free as a whole: the dispatcher reads the best candidate
  # back after the loop, as bayesopt.run_bayesopt does.
  (xo, yo), _, _ = ondevice.run_bayesopt_ondevice(model, 'test', queried,
                                                  BO_ITERS)
  torch.cuda.synchronize()
  iter_ms = (time.perf_counter() - t0) * 1e3 / BO_ITERS
  xo = xo.cpu()
  cand_x = torch.from_numpy(candidates[0])
  if tuple(xo.shape) != (BO_ITERS, DIM) or not torch.isfinite(yo).all():
    raise AssertionError(f'dispatcher output of shape {tuple(xo.shape)}')
  if not all(bool((cand_x == row).all(dim=1).any()) for row in xo):
    raise AssertionError('an observation is not one of the candidates')
  same = 0
  for a, b in zip(xo, host_obs):
    if not torch.equal(a, b):
      break
    same += 1
  log(f'run_bayesopt_ondevice on the pre-trained GP ({BO_ITERS} EI '
      f'iterations, {CANDIDATES} candidates): {iter_ms:.3f} ms/iter; its '
      f'first {same} selections are the host loop\'s of phase 4 [{card}]')
  return iter_ms


def hgp_samples(dev, count=HGP_SAMPLES):
  """`count` samples of bench.py's BO model: sample 0 the model, the others
  jittered by N(0, 0.1^2) in unconstrained space (numpy seed 7)."""
  from hyperbo_tpu_torch.train import slice_sampler
  flat, unravel = slice_sampler.ravel_model(bo_model(dev))
  noise = np.random.default_rng(7).normal(size=(count, flat.shape[0]))
  noise[0] = 0.0
  rows = flat + HGP_JITTER * torch.from_numpy(noise.astype(np.float32)).to(
      dev)
  return [unravel(row.clone()) for row in rows]


def phase_hgp_fixed(candidates, sel_plain, dev, card):
  """Phase 17: the fixed-sample HGP runner at bench.py's configuration.
  Returns ms/iter of its second call."""
  from hyperbo_tpu_torch.bo import ondevice
  from hyperbo_tpu_torch.core import convert, defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import kernel, mean

  config = {'learning_rate': 1e-2}
  cand_x = torch.from_numpy(candidates[0]).to(dev)
  cand_y = torch.from_numpy(candidates[1]).to(dev)
  samples = hgp_samples(dev)
  stacked = convert.stack_models(samples, dev)
  run = ondevice.make_bo_hgp_runner(
      mean.constant, kernel.squared_exponential, config, DEFAULT_WARP_FUNC,
      'ei', BO_LOOP_ITERS, 0, BO_LOOP_ITERS, HGP_SAMPLES, TASKS)
  x0 = cand_x.new_zeros((0, DIM))
  gen = torch.Generator(device=dev).manual_seed(0)
  with no_host_sync():
    x_buf, y_buf, sel, facs = run(stacked, x0, x0[:, :1], cand_x, cand_y,
                                  gen, return_factor=True)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  with no_host_sync():
    _, _, sel2 = ondevice.simulated_bayesopt_ondevice_hgp(
        mean.constant, kernel.squared_exponential, samples, config,
        DEFAULT_WARP_FUNC, defs.SubDataset(cand_x, cand_y), BO_LOOP_ITERS,
        num_train_tasks=TASKS, generator=gen, device=dev)
  torch.cuda.synchronize()
  iter_ms = (time.perf_counter() - t0) * 1e3 / BO_LOOP_ITERS
  if not torch.equal(sel, sel2):
    raise AssertionError('two HGP runner calls differ')
  if not (torch.isfinite(x_buf).all() and torch.isfinite(y_buf).all()):
    raise AssertionError('HGP runner: non-finite observations')

  same = convert.stack_models([bo_model(dev)] * HGP_SAMPLES, dev)
  with no_host_sync():
    _, _, sel_same = run(same, x0, x0[:, :1], cand_x, cand_y, gen)
  if not torch.equal(sel_same, sel_plain):
    j = int(torch.nonzero(sel_same != sel_plain)[0, 0])
    raise AssertionError(f'{HGP_SAMPLES} identical samples part from the '
                         f'plain runner at iteration {j}')
  log(f'HGP runner with {HGP_SAMPLES} identical samples: phase 14\'s '
      f'{BO_LOOP_ITERS} selections, bitwise')

  scale = ondevice._unbiased_scale(TASKS)
  shim = defs.GPParams(model=samples[0], config=config)
  mu, var = ondevice._masked_posterior(
      mean.constant, kernel.squared_exponential, shim, DEFAULT_WARP_FUNC,
      ondevice._noise(shim, DEFAULT_WARP_FUNC), scale, x_buf, y_buf,
      facs[0], BO_LOOP_ITERS, cand_x)
  mu64, var64 = float64_posterior(x_buf, y_buf, cand_x, samples[0], scale)
  errs = {'mu': _rel(mu, mu64), 'var': _rel(var, var64)}
  log(f'HGP runner: sample 0\'s posterior from its final W vs a fresh '
      f'float64 Cholesky: max rel err mu {errs["mu"]:.3e}, var '
      f'{errs["var"]:.3e} (of the largest value)')
  if not max(errs.values()) <= BO_POSTERIOR_RTOL:
    raise AssertionError(f'HGP W posterior differs from float64: {errs}')
  log(f'HGP runner (fixed samples, S = {HGP_SAMPLES}, ei, {CANDIDATES} '
      f'candidates, {BO_LOOP_ITERS} iterations): second call '
      f'{iter_ms:.3f} ms/iter, no host sync inside [{card}]')
  return iter_ms


def phase_hgp_resample(candidates, sel_plain, batch_chol, dev, card):
  """Phase 18: the re-sampling HGP runner at bench.py's hgp_resample
  configuration. Returns (K1 launches of the timed run, ms/iter)."""
  from hyperbo_tpu_torch.bo import ondevice
  from hyperbo_tpu_torch.core import defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import kernel, mean
  from hyperbo_tpu_torch.models import packed as packed_lib
  from hyperbo_tpu_torch.train import slice_sampler

  config = {'learning_rate': 1e-2}
  queried = defs.SubDataset(torch.from_numpy(candidates[0]).to(dev),
                            torch.from_numpy(candidates[1]).to(dev))
  pp = retrain_corpus(dev)
  common = (mean.constant, kernel.squared_exponential, bo_model(dev), config,
            DEFAULT_WARP_FUNC, queried, BO_LOOP_ITERS)
  gen = torch.Generator(device=dev).manual_seed(0)
  _, _, sel0, _ = ondevice.simulated_bayesopt_ondevice_hgp_resample(
      *common, num_samples=HGP_SAMPLES, num_train_tasks=TASKS,
      pretrain_packed=pp, resample_every=RESAMPLE_EVERY, sweeps=0,
      init_jitter=0.0, generator=gen, device=dev)
  if not torch.equal(sel0, sel_plain):
    raise AssertionError('sweeps = 0 without jitter parts from the plain '
                         'runner')
  log(f'HGP re-sampling runner, sweeps = 0, no jitter: phase 14\'s '
      f'{BO_LOOP_ITERS} selections, bitwise')

  stats = {}
  batch_chol.KERNEL.launches = 0
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  _, y, sel, samples = ondevice.simulated_bayesopt_ondevice_hgp_resample(
      *common, num_samples=HGP_SAMPLES, num_train_tasks=RETRAIN_TASKS,
      pretrain_packed=pp, resample_every=RESAMPLE_EVERY,
      sweeps=RESAMPLE_SWEEPS, generator=gen, device=dev, stats=stats)
  torch.cuda.synchronize()
  iter_ms = (time.perf_counter() - t0) * 1e3 / BO_LOOP_ITERS
  launches = batch_chol.KERNEL.launches
  resamplings = len(range(0, BO_LOOP_ITERS, RESAMPLE_EVERY))
  log(f'HGP re-sampling runner: {resamplings} re-samplings, '
      f'{stats["evaluations"]} batched corpus evaluations, K1 counted '
      f'{launches}; {stats["readbacks"]} flags read back, '
      f'{stats["readbacks"] / resamplings:.1f} per re-sampling '
      f'({stats["evaluations"] / resamplings:.1f} evaluations per '
      're-sampling)')
  if launches != stats['evaluations']:
    raise AssertionError(f'K1 launched {launches} times for '
                         f'{stats["evaluations"]} batched evaluations')
  rows = torch.stack([slice_sampler.ravel_model(m)[0] for m in samples])
  start = slice_sampler.ravel_model(bo_model(dev))[0]
  if not (torch.isfinite(rows).all() and torch.isfinite(y).all()):
    raise AssertionError('re-sampling run: non-finite samples or values')
  # The chains start within a few jitters (0.1) of the model; sampling
  # takes them beyond 4 jitters and apart.
  moved = float((rows - start).abs().max())
  spread = float(rows.std(dim=0).max())
  log(f'HGP re-sampling runner: samples finite, largest distance of a '
      f'coordinate from the model {moved:.4f}, largest spread across '
      f'chains {spread:.4f}')
  if not (moved > 4 * HGP_JITTER and
          torch.unique(rows, dim=0).shape[0] == HGP_SAMPLES):
    raise AssertionError('the chains did not move apart')

  # One corpus log prob of the 8 final chains: the card against the CPU.
  _, unravel = slice_sampler.ravel_model(samples[0])
  x_buf = queried.x.index_select(0, sel[:10])
  y_buf = queried.y.index_select(0, sel[:10])
  values = []
  for device in (dev, 'cpu'):
    pp_d = packed_lib.PackedDataset(*[t.to(device) for t in pp])
    values.append(ondevice._corpus_loss_batched(
        mean.constant, kernel.squared_exponential, config,
        DEFAULT_WARP_FUNC, 10, unravel(rows.to(device)), x_buf.to(device),
        y_buf.to(device), 10, pretrain_packed=pp_d).cpu())
  rel = float(((values[0] - values[1]).abs() / values[1].abs()).max())
  log(f'corpus log prob of {HGP_SAMPLES} chains in one call: card vs cpu '
      f'max rel diff {rel:.3e}')
  if not rel <= STEP_LOSS_RTOL:
    raise AssertionError(f'card/cpu corpus log prob differ by {rel}')
  log(f'HGP re-sampling runner ({HGP_SAMPLES} chains, a sweep every '
      f'{RESAMPLE_EVERY} iterations, corpus {RETRAIN_TASKS} x 100, ei, '
      f'{CANDIDATES} candidates, {BO_LOOP_ITERS} iterations): '
      f'{iter_ms:.3f} ms/iter [{card}]')
  return launches, iter_ms, stats, resamplings


def phase_hyperbo_ss(dataset, candidates, batch_chol, dev, card):
  """Phase 19: the hyperbo_ss method end to end, then the dispatcher on
  its HGP. Returns K1's launches in the dispatcher's re-sampling run."""
  from hyperbo_tpu_torch.bo import acfun, bayesopt, ondevice
  from hyperbo_tpu_torch.core import convert, defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean
  from hyperbo_tpu_torch.models import packed as packed_lib

  queried = defs.SubDataset(*candidates)
  params = defs.GPParams(
      model={'constant': 0., 'lengthscale': np.zeros(DIM, np.float32),
             'signal_variance': 0., 'noise_variance': -4.},
      config={'max_training_step': 0, 'retrain': 0})
  times = {}
  sampling = dict(bayesopt._HGP_SAMPLING_CONFIG, burnin=SS_BURNIN,
                  nsamples=SS_NSAMPLES)
  with mock.patch.object(bayesopt, '_HGP_SAMPLING_CONFIG', sampling), \
       mock.patch.object(gp.HGP, 'train', _timed(gp.HGP.train, times)):
    t0 = time.perf_counter()
    (xo, yo), best, trained = bayesopt.run_bayesopt(
        dataset, 'test', queried, mean.constant, kernel.squared_exponential,
        params, acfun.ei, SS_BO_ITERS, warp_func=DEFAULT_WARP_FUNC,
        init_random_key=torch.Generator(device=dev).manual_seed(0),
        method='hyperbo_ss', init_model=True, device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
  samples = trained.samples
  packed, _ = packed_lib.pack_dataset(
      {k: defs.SubDataset(*v) for k, v in dataset.items()}, device=dev)
  with torch.no_grad():
    nll = packed_lib.neg_log_marginal_likelihood_packed_batched(
        mean.constant, kernel.squared_exponential, trained.config,
        convert.stack_models(samples, dev), packed,
        warp_func=DEFAULT_WARP_FUNC).cpu()
  log(f'hyperbo_ss: {len(samples)} samples, their NLL with priors '
      f'{[round(float(v), 4) for v in nll]}')
  if len(samples) != 2 * SS_NSAMPLES or not torch.isfinite(nll).all():
    raise AssertionError('hyperbo_ss samples missing or not finite')
  xo, yo = xo.cpu(), yo.cpu()
  cand_x = torch.from_numpy(candidates[0])
  if (tuple(xo.shape) != (SS_BO_ITERS, DIM) or
      not torch.isfinite(yo).all() or
      torch.unique(xo, dim=0).shape[0] != SS_BO_ITERS or
      not all(bool((cand_x == row).all(dim=1).any()) for row in xo)):
    raise AssertionError('hyperbo_ss: observations are not distinct '
                         'candidates')
  bo_ms = (total_s - times['train']) * 1e3 / SS_BO_ITERS
  log(f'hyperbo_ss at PD1 width ({TASKS} x {POINTS} x {DIM}, constant mean, '
      f'SE): slice sampling {2 * SS_NSAMPLES} samples ({SS_BURNIN} burn-in '
      f'sweeps, device sampler, 1 chain) {times["train"]:.2f} s; then '
      f'{SS_BO_ITERS} EI iterations through predict_stacked, best y '
      f'{float(yo.max()):.4f} (best candidate {float(best[1][0]):.4f}): '
      f'{bo_ms:.3f} ms/iter [{card}]')

  hgp = gp.HGP(dataset, mean.constant, kernel.squared_exponential,
               defs.GPParams(model=trained.model, config=dict(trained.config),
                             samples=samples), DEFAULT_WARP_FUNC, device=dev)
  queried_d = defs.SubDataset(torch.from_numpy(candidates[0]).to(dev),
                              torch.from_numpy(candidates[1]).to(dev))
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  (xf, yf), _, _ = ondevice.run_bayesopt_ondevice(hgp, 'test', queried_d,
                                                  SS_BO_ITERS)
  torch.cuda.synchronize()
  fixed_ms = (time.perf_counter() - t0) * 1e3 / SS_BO_ITERS
  hgp.params.config['retrain'] = 1
  batch_chol.KERNEL.launches = 0
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  (xr, yr), _, resampled = ondevice.run_bayesopt_ondevice(
      hgp, 'test', queried_d, SS_RESAMPLE_ITERS,
      pretrain_packed=retrain_corpus(dev))
  torch.cuda.synchronize()
  resample_ms = (time.perf_counter() - t0) * 1e3 / SS_RESAMPLE_ITERS
  launches = batch_chol.KERNEL.launches
  if not (tuple(xf.shape) == (SS_BO_ITERS, DIM) and
          tuple(xr.shape) == (SS_RESAMPLE_ITERS, DIM) and
          torch.isfinite(yf).all() and torch.isfinite(yr).all() and
          len(resampled.samples) == 2 * SS_NSAMPLES and launches > 0):
    raise AssertionError('run_bayesopt_ondevice on the HGP failed')
  log(f'run_bayesopt_ondevice on the hyperbo_ss HGP: fixed samples '
      f'{SS_BO_ITERS} iterations {fixed_ms:.3f} ms/iter; retrain = 1 (the '
      f're-sampling runner on the {RETRAIN_TASKS}-task corpus) '
      f'{SS_RESAMPLE_ITERS} iterations {resample_ms:.3f} ms/iter, K1 '
      f'{launches} launches [{card}]')

  corpus_hgp = gp.HGP(corpus_tasks(), mean.constant,
                      kernel.squared_exponential,
                      defs.GPParams(model=trained.model, samples=samples),
                      DEFAULT_WARP_FUNC, device=dev)
  t0 = time.perf_counter()
  stats = corpus_hgp.stats(verbose=False)
  stats_s = time.perf_counter() - t0
  if not np.isfinite(stats[0]):
    raise AssertionError(f'HGP.stats: nll {stats[0]}')
  log(f'HGP.stats() over {len(samples)} samples on the {RETRAIN_TASKS}-task '
      f'corpus: nll {stats[0]:.4f}, {stats_s:.2f} s [{card}]')
  return launches


def _counted(objective):
  """The objective, counting its calls in .calls (one a value and
  gradient evaluation in the quasi-Newton trainers)."""
  def counted(**kwargs):
    counted.calls += 1
    return objective(**kwargs)

  counted.calls = 0
  return counted


def _to_cpu(dataset):
  from hyperbo_tpu_torch.core import defs
  return {k: defs.SubDataset(v.x.cpu(), v.y.cpu(), v.aligned)
          for k, v in dataset.items()}


def phase_multistart(dataset, batch_chol, dev, card, packed_step_ms):
  """Phase 20: multi-start Adam (train/adam.fit_adam_packed_multistart)
  at PD1 width, MS_RESTARTS restarts of phase 13's model and packing, 50
  steps at batch 100 with a batch of its own a restart: K1 once a step over
  all R x T systems, the second call free of host syncs and timed; one
  step's per-restart loss on the card against the CPU, from the same
  perturbation and batches (rtol 1e-4). Returns K1's launches of one
  call."""
  from hyperbo_tpu_torch.core import convert
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean
  from hyperbo_tpu_torch.models import packed as packed_lib
  from hyperbo_tpu_torch.train import adam

  model = gp.GP(dataset, mean.linear_mlp, kernel.squared_exponential_mlp,
                init_params(STEPS), DEFAULT_WARP_FUNC, device=dev)
  model.initialize_params(torch.Generator(device=dev).manual_seed(1))
  model0, config = model.params.model, model.params.config
  packed, _ = packed_lib.pack_dataset(model.dataset, pad_to_multiple=128,
                                      device=dev)

  def run(seed):
    return adam.fit_adam_packed_multistart(
        mean.linear_mlp, kernel.squared_exponential_mlp, model0, packed,
        config, warp_func=DEFAULT_WARP_FUNC,
        generator=torch.Generator(device=dev).manual_seed(seed),
        num_restarts=MS_RESTARTS)

  sizes = []
  launch = batch_chol.KERNEL.launch

  def recorded(*args):
    sizes.append(args[2])
    return launch(*args)

  batch_chol.KERNEL.launches = 0
  with mock.patch.object(batch_chol.KERNEL, 'launch', recorded):
    _, best_loss, finals = run(0)
  launches = batch_chol.KERNEL.launches
  start = float(packed_lib.neg_log_marginal_likelihood_packed(
      mean.linear_mlp, kernel.squared_exponential_mlp,
      gp.GPParams(model=model0, config=config), packed,
      warp_func=DEFAULT_WARP_FUNC))
  finals = finals.cpu().numpy()
  log(f'multi-start: full-set loss at the start {start:.4f}, restarts\' '
      f'finals {" ".join(f"{v:.4f}" for v in finals)}, best '
      f'{float(best_loss):.4f}; K1 launches {launches}, systems a launch '
      f'{sorted(set(sizes))}')
  if launches != STEPS or sizes != [MS_RESTARTS * TASKS] * STEPS:
    raise AssertionError(f'K1 launched {launches} times ({sizes}), want '
                         f'{STEPS} of {MS_RESTARTS * TASKS} systems')
  if not (np.isfinite(finals[0]) and float(best_loss) == np.nanmin(
      np.where(np.isfinite(finals), finals, np.inf)) and
          float(best_loss) < start):
    raise AssertionError(f'multi-start finals {finals}, best {best_loss}')
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  with no_host_sync():
    run(1)
  torch.cuda.synchronize()
  step_ms = (time.perf_counter() - t0) * 1e3 / STEPS
  log(f'multi-start Adam (fit_adam_packed_multistart, {MS_RESTARTS} '
      f'restarts x {TASKS}x{POINTS}x{DIM}, batch {BATCH}): second call '
      f'{step_ms:.3f} ms/step, no host sync between its first step and its '
      f'last (phase 13\'s single run: {packed_step_ms:.3f} ms/step) [{card}]')

  # One step's loss of every restart on the card and on the CPU, the
  # perturbation and the batches injected.
  rng = np.random.default_rng(8)
  noise = {k: rng.normal(size=(MS_RESTARTS,) + tuple(v.shape))
           for k, v in convert.model_to_numpy(model0).items()
           if not isinstance(v, dict)}
  sel = torch.from_numpy(np.stack([np.stack(
      [rng.permutation(POINTS)[:BATCH] for _ in range(TASKS)])
      for _ in range(MS_RESTARTS)]))
  losses = []
  for device in ('cpu', dev):
    m0 = convert.model_to(model0, device)
    stacked = convert.stack_models([m0] * MS_RESTARTS, device)
    for k, v in noise.items():
      v = torch.tensor(v, dtype=torch.float32, device=device)
      v[0] = 0.0
      stacked[k] = stacked[k] + v
    pk = packed_lib.PackedDataset(*[t.to(device) for t in packed])
    losses.append(packed_lib.neg_log_marginal_likelihood_packed_batched(
        mean.linear_mlp, kernel.squared_exponential_mlp, config, stacked,
        packed_lib.take_rows_stacked(pk, sel.to(device)),
        warp_func=DEFAULT_WARP_FUNC).cpu().numpy())
  rel = np.abs(losses[1] - losses[0]) / np.abs(losses[0])
  log(f'multi-start first-step losses: card {losses[1]}, cpu {losses[0]}, '
      f'max rel diff {rel.max():.3e}')
  if not rel.max() <= STEP_LOSS_RTOL:
    raise AssertionError(f'card/cpu multi-start losses differ by {rel}')
  return launches, step_ms


def phase_quasi_newton(dataset, dev, card):
  """Phase 21: GP.train with method 'lbfgs' and 'bfgs' at PD1 width: the
  23 tasks subsampled once to 100 points (sub_sample_dataset_iterator on
  the card), QN_ITERS iterations of each on the per-task NLL (a dense
  Cholesky a task an evaluation); the loss falls, and the final value on
  the card matches the CPU's at the same parameters (rtol 1e-4)."""
  from hyperbo_tpu_torch.core import convert
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import divergences, gp, kernel, mean
  from hyperbo_tpu_torch.models import objectives as obj

  base = gp.GP(dataset, mean.linear_mlp, kernel.squared_exponential_mlp,
               init_params(QN_ITERS), DEFAULT_WARP_FUNC, device=dev)
  sub = next(divergences.sub_sample_dataset_iterator(
      torch.Generator(device=dev).manual_seed(3), base.dataset, BATCH))
  ms = {}
  for method in ('lbfgs', 'bfgs'):
    params = init_params(QN_ITERS)
    objective = _counted(obj.neg_log_marginal_likelihood)
    params.config.update(method=method, objective=objective, tol=1e-6)
    model = gp.GP(sub, mean.linear_mlp, kernel.squared_exponential_mlp,
                  params, DEFAULT_WARP_FUNC, device=dev)
    model.initialize_params(torch.Generator(device=dev).manual_seed(1))

    def value(m, data):
      return float(obj.neg_log_marginal_likelihood(
          mean.linear_mlp, kernel.squared_exponential_mlp,
          gp.GPParams(model=m, config=params.config), data,
          warp_func=DEFAULT_WARP_FUNC))

    first = value(model.params.model, model.dataset)
    objective.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.train()
    torch.cuda.synchronize()
    ms[method] = (time.perf_counter() - t0) * 1e3 / objective.calls
    last = value(model.params.model, model.dataset)
    last_cpu = value(convert.model_to(model.params.model, 'cpu'),
                     _to_cpu(model.dataset))
    rel = abs(last - last_cpu) / abs(last_cpu)
    log(f'{method} at PD1 width ({TASKS} tasks x {BATCH} points): loss '
        f'{first:.4f} -> {last:.4f} in {objective.calls} evaluations, '
        f'{ms[method]:.3f} ms per evaluation; final value card vs cpu rel '
        f'diff {rel:.3e} [{card}]')
    if not (np.isfinite(last) and last < first):
      raise AssertionError(f'{method}: loss {first} -> {last}')
    if not rel <= STEP_LOSS_RTOL:
      raise AssertionError(f'{method}: card/cpu final value differ by {rel}')
  return ms


def phase_fused_lbfgs(dev, card, kernels):
  """Phase 22: GP.train(method='lbfgs') through config['fused_mll'] on
  phase 6's two tasks (8192 and 5000 rows x 8-d), FUSED_QN_ITERS
  iterations: K2, K3 and K4 once per task per evaluation (K8 never), then
  again with HYPERBO_BWD_JOINT=1: K2 and K8 once per task per evaluation
  (K3 and K4 never). Returns each run's launches."""
  from hyperbo_tpu_torch.core import defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean
  from hyperbo_tpu_torch.models import objectives as obj

  out = {}
  for joint in ('0', '1'):
    objective = _counted(obj.neg_log_marginal_likelihood)
    model = gp.GP(fused_data(), mean.constant, kernel.squared_exponential,
                  defs.GPParams(model=fused_model(), config={
                      'method': 'lbfgs', 'max_training_step': FUSED_QN_ITERS,
                      'batch_size': 8192, 'objective': objective,
                      'fused_mll': True}),
                  DEFAULT_WARP_FUNC, device=dev)
    model.initialize_params(torch.Generator(device=dev).manual_seed(0))
    losses = []
    for k in kernels.values():
      k.launches = 0
    with mock.patch.dict(os.environ, {'HYPERBO_BWD_JOINT': joint}):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      model.train(callback=lambda step, model_params, loss: losses.append(
          float(loss)))
      torch.cuda.synchronize()
    evals = objective.calls
    eval_ms = (time.perf_counter() - t0) * 1e3 / evals
    launches = {name: k.launches for name, k in kernels.items()}
    per = evals * len(FUSED_TASKS)
    check_launches(launches, {'fused_mll': per,
                              'tri_inv': 0 if joint == '1' else per,
                              'mll_bwd': 0 if joint == '1' else per,
                              'mll_bwd_joint': per if joint == '1' else 0})
    route = 'K2 + K8' if joint == '1' else 'K2-K4'
    log(f'fused L-BFGS through {route}: loss {" ".join(f"{v:.4f}" for v in losses)}; '
        f'{evals} evaluations, {eval_ms:.3f} ms each; launches {launches} '
        f'[{card}]')
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
      raise AssertionError(f'fused L-BFGS losses {losses}')
    out[joint] = launches
  return out['0'], out['1']


def phase_host_adam(ekl_data, dev, card):
  """Phase 23: the host-loop Adam (train/adam.fit_adam, per-step host
  subsamples from sub_sample_dataset_iterator) through GP.train with
  nll_regeuc(1.), an objective the packed trainer does not serve, on
  phase 9's data (23 tasks plus the aligned 1024 x 23), HOST_ADAM_STEPS
  steps at batch 100: the loss finite and falling."""
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean

  params = init_params(HOST_ADAM_STEPS)
  params.config['objective'] = 'nll_regeuc1'
  model = gp.GP(ekl_data, mean.linear_mlp, kernel.squared_exponential_mlp,
                params, DEFAULT_WARP_FUNC, device=dev)
  model.initialize_params(torch.Generator(device=dev).manual_seed(0))
  losses = []
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  model.train(callback=lambda i, m, loss: losses.append(float(loss)))
  torch.cuda.synchronize()
  step_ms = (time.perf_counter() - t0) * 1e3 / HOST_ADAM_STEPS
  log(f'host-loop Adam with nll_regeuc1: loss {losses[0]:.4f} -> '
      f'{losses[-1]:.4f} over {len(losses)} steps, {step_ms:.3f} ms/step '
      f'(op by op, the host\'s speed) [{card}]')
  if not (len(losses) == HOST_ADAM_STEPS and np.isfinite(losses).all() and
          np.mean(losses[-5:]) < np.mean(losses[:5])):
    raise AssertionError(f'host-loop Adam losses {losses}')
  return step_ms


def kumar_model(dtype=torch.float32, device='cpu'):
  """fused_model with Kumaraswamy warp parameters away from the identity."""
  model = fused_model(dtype, device)
  opts = dict(dtype=dtype, device=device)
  model['kumar_params'] = {
      'a': torch.linspace(-0.4, 0.4, FUSED_DIM, **opts),
      'b': torch.linspace(0.3, -0.3, FUSED_DIM, **opts)}
  return model


def phase_kumar(dataset, batch_chol, dev, card, kernels):
  """Phase 24: the SE-Kumar kernel. Packed Adam training at PD1 width
  (KUMAR_STEPS steps at batch 100, the warp initialized at zero): K1 once
  a step, the loss falling and the warp moved. Value and gradient at
  n = 8192 through K2-K4 over the Kumar embedding against the float64
  dense route (value rtol 1e-4, max rel 5e-3 per leaf, a and b included).
  Returns K1's launches in training and K2-K4's in the value+grad."""
  from hyperbo_tpu_torch.core import defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import basis, gp, kernel, mean
  from hyperbo_tpu_torch.models import objectives as obj

  params = defs.GPParams(
      model={'constant': 0., 'lengthscale': torch.zeros(DIM),
             'signal_variance': 0., 'noise_variance': -4.},
      config={'method': 'adam', 'learning_rate': 1e-2,
              'max_training_step': KUMAR_STEPS, 'batch_size': BATCH,
              'objective': 'nll', 'checkpoint_every': 1})
  basis.init_kumar_warp_with_shape(None, params, (0, DIM), device=dev)
  model = gp.GP(dataset, mean.constant, kernel.squared_exponential_kumar,
                params, DEFAULT_WARP_FUNC, device=dev)
  model.initialize_params(torch.Generator(device=dev).manual_seed(0))
  losses, marks = [], {}

  def on_step(step, _, loss):
    losses.append(loss)
    if step in (1, KUMAR_STEPS):
      torch.cuda.synchronize()
      marks[step] = time.perf_counter()

  batch_chol.KERNEL.launches = 0
  model.train(callback=on_step)
  step_ms = (marks[KUMAR_STEPS] - marks[1]) * 1e3 / (KUMAR_STEPS - 1)
  train_launches = batch_chol.KERNEL.launches
  trace = torch.stack(losses).cpu().numpy()
  warp = {k: v.cpu().numpy() for k, v in
          model.params.model['kumar_params'].items()}
  log(f'SE-Kumar packed training: loss {trace[0]:.4f} -> {trace[-1]:.4f} '
      f'over {len(trace)} steps, {step_ms:.3f} ms/step (as phase 4 times '
      f'it); K1 launches {train_launches}; warp a '
      f'{np.round(warp["a"], 4)}, b {np.round(warp["b"], 4)} [{card}]')
  if not (len(trace) == KUMAR_STEPS and np.isfinite(trace).all() and
          trace[-5:].mean() < trace[:5].mean()):
    raise AssertionError(f'SE-Kumar loss trace {trace}')
  if train_launches != KUMAR_STEPS:
    raise AssertionError(f'K1 launched {train_launches} times in '
                         f'{KUMAR_STEPS} SE-Kumar steps')
  if not all(np.abs(v).max() > 0 for v in warp.values()):
    raise AssertionError('the Kumar warp did not move')

  rng = np.random.default_rng(9)
  x = rng.uniform(size=(KUMAR_N, FUSED_DIM))
  y = rng.normal(size=(KUMAR_N, 1))
  if not (x.min() > 0 and x.max() < 1):
    raise AssertionError('Kumar inputs outside (0, 1)')

  def value_and_grad(dtype, fused):
    m = kumar_model(dtype, dev)
    leaves = [m['constant'], m['lengthscale'], m['signal_variance'],
              m['noise_variance'], m['kumar_params']['a'],
              m['kumar_params']['b']]
    for v in leaves:
      v.requires_grad_(True)
    data = {'t': defs.SubDataset(torch.tensor(x, dtype=dtype, device=dev),
                                 torch.tensor(y, dtype=dtype, device=dev))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = obj.neg_log_marginal_likelihood(
        mean.constant, kernel.squared_exponential_kumar,
        defs.GPParams(model=m, config={'fused_mll': fused}), data,
        warp_func=DEFAULT_WARP_FUNC)
    grads = torch.autograd.grad(val, leaves)
    torch.cuda.synchronize()
    return (float(val.detach()), [g.double().cpu() for g in grads],
            (time.perf_counter() - t0) * 1e3)

  value_and_grad(torch.float32, True)  # warm-up
  for k in kernels.values():
    k.launches = 0
  val, grads, ms = value_and_grad(torch.float32, True)
  vg_launches = {name: k.launches for name, k in kernels.items()}
  val64, grads64, _ = value_and_grad(torch.float64, False)
  rel = abs(val - val64) / abs(val64)
  leaf_rel = [_rel(a, b) for a, b in zip(grads, grads64)]
  log(f'n={KUMAR_N} SE-Kumar value+grad through K2-K4: {ms:.3f} ms; value rel '
      f'err {rel:.3e}; gradient max rel per leaf (constant, lengthscale, '
      f'sv, noise, kumar a, kumar b) {" ".join(f"{v:.3e}" for v in leaf_rel)}'
      f'; launches {vg_launches} [{card}]')
  check_launches(vg_launches, {'fused_mll': 1, 'tri_inv': 1, 'mll_bwd': 1,
                               'mll_bwd_joint': 0})
  if not (rel <= VALUE_RTOL and max(leaf_rel) <= GRAD_MAX_REL):
    raise AssertionError(f'SE-Kumar n=8192 parity: value {rel}, grads '
                         f'{leaf_rel}')
  return train_launches, vg_launches


def phase_checkpoint(dataset, batch_chol, dev, card):
  """Phase 25: GP.train(get_params_path=...) at PD1 width into a
  temporary directory, CKPT_EVERY steps a checkpoint over CKPT_STEPS: the
  hook at steps 25 and 50, the file's state (50, final loss) and its
  leaves the trained ones; loaded on the CPU, its GP.stats() on the card
  equals the trained GP's (rtol 1e-5); then CKPT_STEPS more steps resumed
  from it, finite. Returns K1's launches in the checkpointed run."""
  import tempfile
  from hyperbo_tpu_torch.core import convert, params_io
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean

  params = init_params(CKPT_STEPS)
  params.config['checkpoint_every'] = CKPT_EVERY
  model = gp.GP(dataset, mean.linear_mlp, kernel.squared_exponential_mlp,
                params, DEFAULT_WARP_FUNC, device=dev)
  model.initialize_params(torch.Generator(device=dev).manual_seed(2))
  steps = []
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, 'pd1', 'ckpt.pkl')
    batch_chol.KERNEL.launches = 0
    model.train(get_params_path=lambda x=0: path,
                callback=lambda s, m, loss: steps.append(s))
    launches = batch_chol.KERNEL.launches
    loaded, (step, loss) = params_io.load_params(path, include_state=True,
                                                 device='cpu')
  trained = convert.model_to_numpy(model.params.model)
  same = all(np.array_equal(a, b) for a, b in zip(
      _leaves(trained), _leaves(convert.model_to_numpy(loaded.model))))
  log(f'checkpoint: hook at steps {steps}, saved state step {step}, loss '
      f'{float(loss):.4f}; loaded leaves on the CPU equal the trained: '
      f'{same}; K1 launches {launches}')
  if steps != [CKPT_EVERY, CKPT_STEPS] or step != CKPT_STEPS or not same:
    raise AssertionError(f'checkpoint steps {steps}, state {step}, same '
                         f'{same}')
  if launches != CKPT_STEPS:
    raise AssertionError(f'K1 launched {launches} times in {CKPT_STEPS}')
  want = _stats_values(model)
  resumed = gp.GP(dataset, mean.linear_mlp, kernel.squared_exponential_mlp,
                  gp.GPParams(model=loaded.model,
                              config=init_params(CKPT_STEPS).config),
                  DEFAULT_WARP_FUNC, device=dev)
  got = _stats_values(resumed)
  rel = {k: abs(got[k] - v) / max(abs(v), 1e-30) for k, v in want.items()}
  log(f'checkpoint GP.stats(): trained {want}, loaded {got} [{card}]')
  if not all(v <= STATS_RTOL for v in rel.values()):
    raise AssertionError(f'loaded stats differ: {rel}')
  resumed.initialize_params(torch.Generator(device=dev).manual_seed(3))
  losses = []
  resumed.params.config['checkpoint_every'] = 1
  resumed.train(callback=lambda s, m, loss: losses.append(loss))
  trace = torch.stack(losses).cpu().numpy()
  log(f'resumed {len(trace)} steps from the checkpoint: loss '
      f'{trace[0]:.4f} -> {trace[-1]:.4f}')
  if not (len(trace) == CKPT_STEPS and np.isfinite(trace).all()):
    raise AssertionError(f'resumed loss trace {trace}')
  return launches


def cont_oracle(x):
  """The continuous oracle: a smooth closed form on [0, 1]^4, evaluated on
  the input's device, best at x = 0.35 (PD1 has no continuous oracle)."""
  return -torch.sum((x - 0.35) ** 2, dim=-1, keepdim=True)


def phase_continuous_host(dataset, batch_chol, dev, card):
  """Phase 27: run_bayesopt(init_model=True) with the oracle at PD1 width
  (phase 4's pre-training: 50 Adam steps, K1 once a step), then CONT_ITERS
  EI iterations, each over a uniform pool of CONT_POOL refined by
  L-BFGS-B; a 2-iteration Thompson-sampling run proposes only members of
  its pools; one refinement from the same start and model on the card and
  on the CPU reaches EI values within REFINE_RTOL. Returns K1's launches
  and the trained parameters."""
  from hyperbo_tpu_torch.bo import acfun, bayesopt, input_samplers
  from hyperbo_tpu_torch.core import convert, defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean

  params = init_params(STEPS)
  params.config['checkpoint_every'] = STEPS
  marks = {}

  def on_step(step, model, loss):
    torch.cuda.synchronize()
    marks['trained'] = time.perf_counter()

  evals = []
  refine = bayesopt._lbfgsb_refine

  def counted(fun, x_init, input_dim):
    evals.append(0)

    def f(x):
      evals[-1] += 1
      return fun(x)
    return refine(f, x_init, input_dim)

  batch_chol.KERNEL.launches = 0
  with mock.patch.object(bayesopt, '_lbfgsb_refine', counted):
    (xo, yo), best, trained = bayesopt.run_bayesopt(
        dataset, 'test', cont_oracle, mean.linear_mlp,
        kernel.squared_exponential_mlp, params, acfun.ei, CONT_ITERS,
        warp_func=DEFAULT_WARP_FUNC,
        init_random_key=torch.Generator(device=dev).manual_seed(0),
        init_model=True, data_loader_name='uniform', callback=on_step,
        device=dev)
  torch.cuda.synchronize()
  iter_ms = (time.perf_counter() - marks['trained']) * 1e3 / CONT_ITERS
  launches = batch_chol.KERNEL.launches
  xo, yo = xo.cpu(), yo.cpu()
  if tuple(xo.shape) != (CONT_ITERS, DIM) or tuple(yo.shape) != (
      CONT_ITERS, 1) or best is not None:
    raise AssertionError(f'continuous BO gave {tuple(xo.shape)}, '
                         f'{tuple(yo.shape)}, best {best}')
  if not (torch.isfinite(xo).all() and torch.isfinite(yo).all() and
          ((xo >= 0) & (xo <= 1)).all()):
    raise AssertionError('a continuous observation is not finite or leaves '
                         '[0, 1]^4')
  if launches < STEPS or len(evals) != CONT_ITERS:
    raise AssertionError(f'K1 launched {launches} times, {len(evals)} '
                         'refinements')
  log(f'continuous BO at PD1 width (n_init 0 + {CONT_ITERS} rows, EI over '
      f'{CONT_POOL} uniform inputs + L-BFGS-B): {iter_ms:.3f} ms/iter, '
      f'{statistics.mean(evals):.1f} L-BFGS-B evaluations/iter '
      f'(min {min(evals)}, max {max(evals)}), K1 launches {launches} in '
      f'the pre-training; best y {float(yo.max()):.5f} (optimum 0) [{card}]')

  def gp_at(device):
    model = gp.GP(dataset, mean.linear_mlp, kernel.squared_exponential_mlp,
                  defs.GPParams(model=convert.model_to(trained.model, device),
                                config=dict(trained.config)),
                  DEFAULT_WARP_FUNC, device=device)
    model.update_sub_dataset((xo, yo), 'test')
    return model

  model = gp_at(dev)
  model.rng = torch.Generator(device=dev).manual_seed(5)
  pools = []

  def recording(generator, input_dim):
    pools.append(input_samplers.INPUT_SAMPLERS['uniform'](generator,
                                                          input_dim))
    return pools[-1]

  obs = bayesopt.bayesopt(torch.Generator(device=dev).manual_seed(6), model,
                          'test', cont_oracle, acfun.ts, 2, recording)
  new = obs.x[CONT_ITERS:]
  if not (len(pools) == 2 and len(new) == 2 and all(
      bool((p == x).all(dim=1).any()) for p, x in zip(pools, new))):
    raise AssertionError('Thompson sampling proposed a point off its pool')

  pool = np.random.default_rng(27).uniform(size=(CONT_POOL, DIM)).astype(
      np.float32)
  start, refined = None, {}
  for device in ('cpu', dev):
    model = gp_at(device)
    ei = lambda x, m=model: acfun.ei(model=m, sub_dataset_key='test',
                                     x_queries=x)
    cand = torch.from_numpy(pool).to(device)
    with torch.no_grad():
      if start is None:
        start = int(ei(cand).argmax())
    x_ref = bayesopt._lbfgsb_refine(
        lambda x, f=ei: -f(x[None, :]).flatten()[0], cand[start], DIM)
    with torch.no_grad():
      refined[str(device)] = (x_ref.cpu().numpy(),
                              float(ei(x_ref[None, :])),
                              float(ei(cand[start:start + 1])))
  (x_cpu, ac_cpu, ac0), (x_card, ac_card, _) = (refined['cpu'],
                                                refined[str(dev)])
  rel = abs(ac_card - ac_cpu) / abs(ac_cpu)
  log(f'L-BFGS-B refinement from pool index {start}: EI {ac0:.6e} -> card '
      f'{ac_card:.6e}, CPU {ac_cpu:.6e} (rel {rel:.3e}); points apart by '
      f'{np.abs(x_card - x_cpu).max():.3e}')
  if not rel <= REFINE_RTOL:
    raise AssertionError(f'card and CPU refinements part: EI rel {rel}')
  log('Thompson sampling: 2 proposals, each a member of its pool')
  return launches, trained


def phase_continuous_ondevice(trained, dev, card):
  """Phase 28: the on-device continuous runner on phase 4's trained GP
  (EI, pools of CONT_LOOP_POOL, CONT_REFINE ascent steps at CONT_LR,
  CONT_LOOP_ITERS iterations, CONT_INIT initial observations): two calls
  on equal seeds under set_sync_debug_mode('error'), bitwise equal;
  refine_steps = 0 picks each pool's EI argmax (recomputed from a fresh
  factor, within PICK_GAP and PICK_ATOL); the best observation beats the
  initial ones;
  ms/iter, and device activities and busy share a profiled iteration."""
  from torch.profiler import ProfilerActivity, profile

  from hyperbo_tpu_torch.bo import ondevice
  from hyperbo_tpu_torch.core import convert, defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import kernel, mean

  model = convert.model_to(trained.model, dev)
  config = dict(trained.config)
  x0 = torch.from_numpy(np.random.default_rng(28).uniform(
      size=(CONT_INIT, DIM)).astype(np.float32)).to(dev)
  y0 = cont_oracle(x0)
  funcs = (mean.linear_mlp, kernel.squared_exponential_mlp)

  def runner(steps, seed, iters=CONT_LOOP_ITERS):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lambda: ondevice.continuous_bayesopt_ondevice(
        *funcs, model, config, DEFAULT_WARP_FUNC, cont_oracle, DIM, iters,
        acquisition='ei', pool_size=CONT_LOOP_POOL, refine_steps=steps,
        refine_lr=CONT_LR, num_train_tasks=TASKS, init_obs=(x0, y0),
        generator=gen, device=dev)

  outs, times = [], []
  for run in (runner(CONT_REFINE, 0), runner(CONT_REFINE, 0)):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_host_sync():
      outs.append(run())
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3 / CONT_LOOP_ITERS)
  (xa, ya), (xb, yb) = outs
  if not (torch.equal(xa, xb) and torch.equal(ya, yb)):
    raise AssertionError('two continuous runs on equal seeds differ')
  xa, ya = xa.cpu(), ya.cpu()
  if tuple(xa.shape) != (CONT_INIT + CONT_LOOP_ITERS, DIM) or not (
      torch.isfinite(ya).all() and ((xa >= 0) & (xa <= 1)).all()):
    raise AssertionError(f'continuous runner output {tuple(xa.shape)}')
  best, start = float(ya[CONT_INIT:].max()), float(ya[:CONT_INIT].max())
  if not best > start:
    raise AssertionError(f'best {best} does not beat the initial {start}')

  pools = []
  draw = ondevice._draw_uniform

  def recording(generator, shape, device):
    pools.append(draw(generator, shape, device))
    return pools[-1]

  run = runner(0, 1)
  with mock.patch.object(ondevice, '_draw_uniform', recording), \
      no_host_sync():
    x_buf, y_buf = run()
  shim = defs.GPParams(model=model, config=config)
  nv = ondevice._noise(shim, DEFAULT_WARP_FUNC)
  acq_sub, kind = ondevice._ACQ_SUBS['ei']
  scale = ondevice._unbiased_scale(TASKS)
  exact, worst = 0, 0.0
  with torch.no_grad():
    for i, pool in enumerate(pools):
      count = CONT_INIT + i
      fac = ondevice._masked_refactor(*funcs, config, DEFAULT_WARP_FUNC,
                                      model, x_buf, count)
      scores = ondevice._acq_values(
          *funcs, DEFAULT_WARP_FUNC, acq_sub, kind, shim, nv, scale,
          (x_buf, y_buf, fac, count), pool).flatten()
      member = (pool == x_buf[count]).all(dim=1)
      if not bool(member.any()):
        raise AssertionError(f'pick {i} with refine_steps = 0 is off its '
                             'pool')
      top = float(scores.max())
      got = float(scores[member].max())
      exact += int(got == top)
      worst = max(worst, (top - got - PICK_ATOL) / max(abs(top), 1e-30))
  if not worst <= PICK_GAP:
    raise AssertionError(f'a refine_steps = 0 pick is {worst} below its '
                         "pool's EI maximum")

  torch.cuda.synchronize()
  run = runner(CONT_REFINE, 2, CONT_PROFILE_ITERS)
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
  spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
  busy, end = 0, None
  for a, b in spans:
    if end is None or a > end:
      busy, end = busy + b - a, b
    elif b > end:
      busy, end = busy + b - end, b
  log(f'on-device continuous BO ({CONT_LOOP_ITERS} EI iterations, pool '
      f'{CONT_LOOP_POOL}, {CONT_REFINE} ascent steps): {times[0]:.3f} / '
      f'{times[1]:.3f} ms/iter (first / second call), both sync-free and '
      f'bitwise equal; best y {best:.5f} from the initial {start:.5f}; '
      f'refine_steps = 0: {exact} of {len(pools)} picks its pool\'s EI '
      f'argmax exactly, the others within {worst:.2e}; profiled '
      f'{CONT_PROFILE_ITERS} iterations: {len(spans) / CONT_PROFILE_ITERS:.1f} '
      f'device activities/iter, device busy '
      f'{100 * busy / wall_us:.1f}% [{card}]')
  return times[1]


def it_data(n, seed):
  """benchmarks/r9_iterative_probe.py's data: x uniform on [0, 1]^8,
  y = sin(3 x @ w), w normal; numpy, seeded."""
  rng = np.random.default_rng(seed)
  x = rng.uniform(size=(n, IT_DIM)).astype(np.float32)
  return x, np.sin(3 * x @ rng.normal(size=(IT_DIM, 1))).astype(np.float32)


def it_model(dtype=torch.float32, device='cpu'):
  """The reference probe's parameters (unwarped): constant 0, lengthscale,
  signal variance 0, noise variance -2."""
  opts = dict(dtype=dtype, device=device)
  leaves = {'constant': torch.tensor(0.0, **opts),
            'lengthscale': torch.zeros((IT_DIM,), **opts),
            'signal_variance': torch.tensor(0.0, **opts),
            'noise_variance': torch.tensor(-2.0, **opts)}
  for v in leaves.values():
    v.requires_grad_(True)
  return leaves


def it_value_grad(x, y, dtype=torch.float32, iterative=True, **kwargs):
  """The NLL and its gradient on (x, y) through mll_iterative, or
  (iterative False) the dense route; with the run's info and ms."""
  from hyperbo_tpu_torch.core import defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import kernel, mean
  from hyperbo_tpu_torch.models import objectives as obj
  from hyperbo_tpu_torch.ops import iterative as it

  model = it_model(dtype, x.device)
  params = defs.GPParams(model=model)
  if x.is_cuda:
    torch.cuda.synchronize()
  t0 = time.perf_counter()
  info = {}
  if iterative:
    val, info = it.mll_iterative(
        mean.constant, params, x.to(dtype), y.to(dtype),
        warp_func=DEFAULT_WARP_FUNC, cov_func=kernel.squared_exponential,
        return_info=True, **kwargs)
  else:
    val = obj.neg_log_marginal_likelihood(
        mean.constant, kernel.squared_exponential, params,
        {'t': defs.SubDataset(x.to(dtype), y.to(dtype))},
        warp_func=DEFAULT_WARP_FUNC)
  grads = torch.autograd.grad(val, list(model.values()))
  if x.is_cuda:
    torch.cuda.synchronize()
  ms = (time.perf_counter() - t0) * 1e3
  return (float(val.detach()), [g.detach().double().cpu() for g in grads],
          {k: float(v) for k, v in info.items()}, ms)


def phase_iterative(dev, card):
  """Phase 29: the matrix-free NLL at the reference probe's configuration
  (IT_PROBES probes, IT_STEPS Lanczos steps, preconditioner rank IT_RANK):
  value and gradient at n = 65536 (row_chunk 4096) and n = 131072
  (clamped to 2048), the second call timed, with CG's iterations and
  residual and the peak device memory; at n = IT_CHECK_N against the
  float64 dense value and gradient (tests/test_iterative.py's bounds, at
  its 64 probes and 30 Lanczos steps, three probe seeds); at n =
  IT_PARITY_N the card against the CPU on the same injected probes (value
  rtol 1e-4); predict_iterative at n = IT_CHECK_N for IT_QUERIES queries
  against GP.predict's dense posterior; GP.train() through
  config['iterative_mll'] at n = IT_TRAIN_N (the host-loop Adam, as the
  JAX package routes it), the loss finite and falling."""
  from hyperbo_tpu_torch.core import defs
  from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC
  from hyperbo_tpu_torch.models import gp, kernel, mean
  from hyperbo_tpu_torch.models import objectives as obj
  from hyperbo_tpu_torch.ops import iterative as it

  ref = dict(num_probes=IT_PROBES, lanczos_steps=IT_STEPS,
             precond_rank=IT_RANK)
  for n, chunk in IT_SIZES:
    x, y = (torch.from_numpy(a).to(dev) for a in it_data(n, n))
    runs = []
    for _ in range(2):
      torch.cuda.reset_peak_memory_stats()
      val, grads, info, ms = it_value_grad(x, y, row_chunk=chunk,
                                           cg_maxiter=IT_MAXITER, **ref)
      runs.append((val, ms, torch.cuda.max_memory_allocated() / 2**30))
      if not (np.isfinite(val) and all(bool(torch.isfinite(g).all())
                                       for g in grads)):
        raise AssertionError(f'n={n}: value or gradient not finite')
      if info['cg_iters'] >= IT_MAXITER:
        raise AssertionError(f'n={n}: CG did not converge: {info}')
    log(f'matrix-free NLL value+grad n={n} (row_chunk {chunk} -> '
        f'{it._clamp_row_chunk(chunk, n)}): {runs[1][1]:.1f} ms (first '
        f'call {runs[0][1]:.1f} ms), value {runs[1][0]:.4f}, cg_iters '
        f'{info["cg_iters"]:.0f}, cg_residual {info["cg_residual"]:.3e}, '
        f'peak memory {runs[1][2]:.2f} GiB [{card}]')
    del x, y

  x, y = (torch.from_numpy(a).to(dev) for a in it_data(IT_CHECK_N, 29))
  val64, grads64, _, ms64 = it_value_grad(x, y, torch.float64, False)
  check = dict(num_probes=IT_CHECK_PROBES, lanczos_steps=IT_CHECK_STEPS,
               precond_rank=IT_RANK, row_chunk=IT_CHUNK)
  draws = []
  for seed in IT_SEEDS:
    val, grads, info, ms = it_value_grad(
        x, y, key=torch.Generator(device=dev).manual_seed(seed), **check)
    rel = abs(val - val64) / abs(val64)
    leaf = [float((g - w).abs().max() / (w.abs().max() + 1e-6))
            for g, w in zip(grads, grads64)]
    const = abs(float(grads[0]) - float(grads64[0])) / abs(float(grads64[0]))
    log(f'n={IT_CHECK_N} estimate (seed {seed}): value rel err {rel:.3e}, '
        f'constant grad rel {const:.3e}, leaves '
        f'{" ".join(f"{v:.3f}" for v in leaf)} of scale, cg_iters '
        f'{info["cg_iters"]:.0f}; {ms:.1f} ms (float64 dense {ms64:.1f} ms)')
    if not (rel < IT_VALUE_REL and const <= IT_CONST_RTOL and
            max(leaf) < IT_LEAF_DRAW):
      raise AssertionError(f'n={IT_CHECK_N} estimate: value {rel}, '
                           f'constant {const}, leaves {leaf}')
    draws.append(grads)
  mean_leaf = [float((torch.stack(gs).mean(0) - w).abs().max() /
                     (w.abs().max() + 1e-6))
               for gs, w in zip(zip(*draws), grads64)]
  if not max(mean_leaf) < IT_LEAF_MEAN:
    raise AssertionError(f'seed-averaged gradient off: {mean_leaf}')

  rng = np.random.default_rng(290)
  probes = [np.where(rng.uniform(size=(IT_PARITY_N, IT_PROBES)) < 0.5,
                     1.0, -1.0).astype(np.float32) for _ in range(2)]
  xp, yp = it_data(IT_PARITY_N, 291)
  vals = {}
  for device in ('cpu', dev):
    draws_it = iter(probes)
    with mock.patch.object(it, '_draw_rademacher',
                           lambda g, shape, d: torch.from_numpy(
                               next(draws_it)).to(d)), torch.no_grad():
      vals[str(device)] = float(it.mll_iterative(
          mean.constant, defs.GPParams(model=it_model(device=device)),
          torch.from_numpy(xp).to(device), torch.from_numpy(yp).to(device),
          warp_func=DEFAULT_WARP_FUNC, cov_func=kernel.squared_exponential,
          key=torch.Generator(), row_chunk=IT_CHUNK, **ref))
  rel = abs(vals[str(dev)] - vals['cpu']) / abs(vals['cpu'])
  log(f'n={IT_PARITY_N} on the same probes: card {vals[str(dev)]:.6f}, CPU '
      f'{vals["cpu"]:.6f}, rel {rel:.3e}')
  if not rel <= VALUE_RTOL:
    raise AssertionError(f'card and CPU estimates differ by {rel}')

  xq = torch.from_numpy(np.random.default_rng(292).uniform(
      size=(IT_QUERIES, IT_DIM)).astype(np.float32)).to(dev)
  params = defs.GPParams(model={k: v.detach() for k, v in
                                it_model(device=dev).items()})
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  mu, var, info = it.predict_iterative(
      mean.constant, params, x, y, xq, warp_func=DEFAULT_WARP_FUNC,
      cov_func=kernel.squared_exponential, row_chunk=IT_CHUNK,
      precond_rank=IT_RANK, return_info=True)
  torch.cuda.synchronize()
  p_ms = (time.perf_counter() - t0) * 1e3
  with torch.no_grad():
    mu_d, var_d = gp.predict(mean.constant, kernel.squared_exponential,
                             params, x, y, xq, warp_func=DEFAULT_WARP_FUNC)
  mu_err = float(((mu - mu_d).abs() - 1e-3 * mu_d.abs()).max())
  var_err = float(((var - var_d).abs() - 2e-2 * var_d.abs()).max())
  log(f'predict_iterative n={IT_CHECK_N}, {IT_QUERIES} queries: {p_ms:.1f} '
      f'ms, mean cg_iters {float(info["cg_iters"]):.0f}; against GP.predict: '
      f'mean max |err| - 1e-3 |mu| {mu_err:.3e}, variance max |err| - 2e-2 '
      f'|var| {var_err:.3e} (bounds 2e-3) [{card}]')
  if not (mu_err <= 2e-3 and var_err <= 2e-3):
    raise AssertionError(f'predict_iterative off: {mu_err}, {var_err}')
  del x, y

  xt, yt = it_data(IT_TRAIN_N, 293)
  config = {'method': 'adam', 'learning_rate': 0.05,
            'max_training_step': IT_TRAIN_STEPS, 'batch_size': IT_TRAIN_N,
            'objective': obj.nll, 'pack_tasks': False,
            'iterative_mll': dict(ref, row_chunk=IT_CHUNK)}
  model = gp.GP({'t': (xt, yt)}, mean.constant, kernel.squared_exponential,
                defs.GPParams(model={k: v.detach() for k, v in
                                     it_model().items()}, config=config),
                DEFAULT_WARP_FUNC, device=dev)
  losses = []
  calls = []
  real = it.mll_iterative
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  with mock.patch.object(it, 'mll_iterative',
                         lambda *a, **k: calls.append(1) or real(*a, **k)):
    model.train(torch.Generator(device=dev).manual_seed(0),
                callback=lambda s, m, loss: losses.append(float(loss)))
  torch.cuda.synchronize()
  step_ms = (time.perf_counter() - t0) * 1e3 / IT_TRAIN_STEPS
  log(f'GP.train through config["iterative_mll"] at n={IT_TRAIN_N} (host '
      f'loop, pack_tasks False): loss {" ".join(f"{v:.2f}" for v in losses)}; '
      f'{len(calls)} estimates, {step_ms:.1f} ms/step [{card}]')
  if not (len(losses) == IT_TRAIN_STEPS and np.isfinite(losses).all() and
          losses[-1] < losses[0] and len(calls) == IT_TRAIN_STEPS + 1):
    raise AssertionError(f'iterative training: {losses}, {len(calls)} calls')


def _leaves(tree):
  if isinstance(tree, dict):
    return [x for k in sorted(tree) for x in _leaves(tree[k])]
  return [tree]


def _timed(fn, times):
  """fn, recording its wall time (synchronized) under times['train']."""
  def wrapper(*args, **kwargs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    times['train'] = time.perf_counter() - t0
    return out
  return wrapper


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
  launches, trained, host_obs = phase_slice(dataset, candidates, batch_chol,
                                            dev, card)
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
  packed_launches, packed_step_ms = phase_packed_runner(dataset, batch_chol,
                                                       dev, card)
  sel_plain, _, _ = phase_ondevice_bo(candidates, dev, card)
  retrain_launches, _ = phase_bo_variants(candidates, sel_plain, batch_chol,
                                          dev, card)
  phase_dispatcher(dataset, candidates, trained, host_obs, dev, card)
  phase_hgp_fixed(candidates, sel_plain, dev, card)
  resample_launches, _, _, _ = phase_hgp_resample(candidates, sel_plain,
                                                  batch_chol, dev, card)
  ss_launches = phase_hyperbo_ss(dataset, candidates, batch_chol, dev, card)
  ms_launches, _ = phase_multistart(dataset, batch_chol, dev, card,
                                    packed_step_ms)
  phase_quasi_newton(dataset, dev, card)
  lbfgs_launches, lbfgs_joint_launches = phase_fused_lbfgs(dev, card,
                                                           path_kernels)
  phase_host_adam(ekl_data, dev, card)
  kumar_launches, kumar_vg_launches = phase_kumar(dataset, batch_chol, dev,
                                                  card, path_kernels)
  ckpt_launches = phase_checkpoint(dataset, batch_chol, dev, card)
  cont_launches, _ = phase_continuous_host(dataset, batch_chol,
                                                      dev, card)
  phase_continuous_ondevice(trained, dev, card)
  phase_iterative(dev, card)

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
      # K1's launches on the other paths: one call of the packed runner
      # (phase 13), the retrain runner's run (phase 15), the HGP
      # re-sampling runner's run (phase 18), the dispatcher's
      # re-sampling run on the hyperbo_ss HGP (phase 19), one call of
      # multi-start Adam (phase 20: a launch a step over all restarts'
      # systems), the SE-Kumar training (phase 24) and the checkpointed
      # training (phase 25).
      'launches_by_path': {'run_bayesopt_pretraining': launches,
                           'make_fit_adam_packed': packed_launches,
                           'ondevice_retrain': retrain_launches,
                           'ondevice_hgp_resample': resample_launches,
                           'hyperbo_ss_resample_dispatch': ss_launches,
                           'multistart_adam': ms_launches,
                           'kumar_packed_adam': kumar_launches,
                           'checkpointed_adam': ckpt_launches,
                           'continuous_bayesopt_pretraining': cont_launches},
      'max_abs_err': err,
      'ms': k1_times['kernel'],
      'device_ms': measured(k1_times['device']),
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
        # Phase 22's L-BFGS through the fused route and phase 24's n = 8192
        # SE-Kumar value and gradient.
        'launches_by_path': {'fused_adam': fused_launches[name],
                             'fused_lbfgs': lbfgs_launches[name],
                             'kumar_value_grad': kumar_vg_launches[name]},
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
      'launches_by_path': {
          'fused_adam_joint': joint_launches['mll_bwd_joint'],
          'fused_lbfgs_joint': lbfgs_joint_launches['mll_bwd_joint']},
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
      'device_ms': measured(gram_times['gram_with_ridge']['device']),
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
