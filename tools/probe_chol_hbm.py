"""Probe of kernel K6 (hyperbo_tpu_torch/csrc/chol_hbm.cu) alone on one CUDA
card.

    python3 tools/probe_chol_hbm.py

Builds K6 and prints nvcc's register, spill and shared-memory report, and
the persistent launch: blocks of the grid, blocks a multiprocessor,
threads and dynamic shared memory a block. Holds K6 against the float64
plain version at chip_smoke.py phase 8's shapes (max abs, bound 5e-4),
checks NaN for a non-PD middle matrix of a batch and only there, two calls
at (1, 1024, 1024) bitwise equal and one launch a call. Times the wrapper,
its plain version and torch.linalg.cholesky at (1, 1024, 1024),
(2, 1024, 1024), (1, 2048, 2048) and (1, 4096, 4096) (medians of CUDA-event
timings, in turns), and the kernel alone back to back. Splits one launch
at (1, 1024, 1024) and one at (1, 4096, 4096) by part from the clock64()
laps of hyperbo_chol_hbm_stamped: the chain block's diagonal factors, the
wait beyond them, its panel solves and lookahead updates, what its warps
4-7 spent waiting on the workers, and the workers' waits, loads, panel
solves, updates, stores and releases. With the card's name and power
limit.
"""

import ctypes
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# pylint: disable=wrong-import-position,protected-access
import chip_smoke
from hyperbo_tpu_torch.ops import chol_hbm

SHAPES = ((1, 64), (1, 576), (1, 1024), (2, 1024), (1, 2048), (1, 4096))
TIMED = ((1, 1024), (2, 1024), (1, 2048), (1, 4096))
STAMP_SLOTS = 16  # csrc/chol_hbm.cu kStampSlots
CHAIN_PARTS = ('first load', 'diagonal factors', 'waits and loads beyond '
               'the factor', 'panel solves', 'lookahead updates beside the '
               'releases')
WORKER_PARTS = ('waits on counters', 'waits on loads', 'panel solves',
                'updates', 'upper zeros', 'stores and releases')
SPLIT = ('first sub-block factors', 'row solves',
         'trailing updates with the next sub-block factors')
BACK_TO_BACK = 100


def library():
  lib = ctypes.CDLL(chol_hbm.KERNEL.library_path())
  lib.hyperbo_chol_hbm_info.argtypes = [ctypes.c_void_p]
  lib.hyperbo_chol_hbm_info.restype = ctypes.c_int
  args = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int]
  lib.hyperbo_chol_hbm_stamped.argtypes = args + [ctypes.c_void_p] * 2
  lib.hyperbo_chol_hbm_stamped.restype = ctypes.c_int
  return lib


def check(err, what):
  if err != 0:
    raise RuntimeError(f'{what} failed: CUDA error {err}')


def scratch(a):
  n = a.shape[-1]
  batch = a.numel() // (n * n)
  nb = n // chol_hbm.TILE
  panel = torch.empty((batch, nb, chol_hbm.PANEL), dtype=torch.float32,
                      device=a.device)
  counts = torch.zeros((batch, nb, nb), dtype=torch.int32, device=a.device)
  return n, batch, panel, counts


def kernel_alone_ms(a, fn, runs=5):
  """Median over `runs` of the mean time of BACK_TO_BACK launches of the C
  entry point fn (no wrapper, no poison; the counters zeroed before
  each)."""
  n, batch, panel, counts = scratch(a)
  out = torch.empty_like(a)
  stream = torch.cuda.current_stream().cuda_stream

  def burst():
    for _ in range(BACK_TO_BACK):
      counts.zero_()
      check(fn(a.data_ptr(), out.data_ptr(), panel.data_ptr(),
               counts.data_ptr(), n, batch, stream), 'K6')

  burst()
  torch.cuda.synchronize()
  return statistics.median(chip_smoke.median_ms(burst, runs)) / BACK_TO_BACK


def split_by_part(lib, a, grid, kernel_ms):
  """One stamped launch of one matrix: the chain block's parts along the
  chain, each as a share of its span and in microseconds at the kernel's
  time alone, and the workers' parts summed over all workers."""
  n, batch, panel, counts = scratch(a)
  stamps = torch.zeros((grid, STAMP_SLOTS), dtype=torch.int64,
                       device=a.device)
  out = torch.empty_like(a)
  stream = torch.cuda.current_stream().cuda_stream
  for _ in range(3):
    counts.zero_()
    stamps.zero_()
    check(lib.hyperbo_chol_hbm_stamped(
        a.data_ptr(), out.data_ptr(), panel.data_ptr(), counts.data_ptr(), n,
        batch, stamps.data_ptr(), stream), 'stamped K6')
  torch.cuda.synchronize()
  s = stamps.cpu().numpy().astype(np.int64)
  span = int(s[0, 0])
  chip_smoke.log(f'K6 (1, {n}, {n}) by part, {span} cycles in the chain '
                 f'block ({span / kernel_ms / 1e6:.3f} GHz at the kernel\'s '
                 f'time alone, {kernel_ms:.4f} ms):')
  for name, cycles in zip(CHAIN_PARTS, s[0, 1:6]):
    chip_smoke.log(f'  chain {name}: {int(cycles)} cycles, '
                   f'{cycles / span:.1%}, '
                   f'{cycles / span * kernel_ms * 1e3:.2f} us')
  chip_smoke.log('  chain diagonal factors split: ' + ', '.join(
      f'{k} {int(v)} cycles' for k, v in zip(SPLIT, s[0, 12:15])))
  chip_smoke.log(f'  chain warps 4-7 waiting on the workers\' counters '
                 f'(beside the factors): {int(s[0, 15])} cycles, '
                 f'{s[0, 15] / span:.1%}')
  workers = s[1:]
  total = workers[:, 0].sum()
  chip_smoke.log(f'  workers ({len(workers)} blocks, {int(total)} cycles in '
                 'all):')
  for name, cycles in zip(WORKER_PARTS, workers[:, 6:12].sum(axis=0)):
    chip_smoke.log(f'    {name}: {int(cycles)} cycles, {cycles / total:.1%}')


def main():
  card = chip_smoke.phase_device()
  dev = torch.device('cuda', 0)
  chip_smoke.phase_build([chol_hbm.KERNEL])
  for line in chol_hbm.KERNEL.build_log.splitlines():
    if 'registers' in line or 'spill' in line or 'smem' in line:
      chip_smoke.log(f'ptxas: {line.strip()}')
  lib = library()
  info = (ctypes.c_int * 5)()
  check(lib.hyperbo_chol_hbm_info(info), 'hyperbo_chol_hbm_info')
  grid = info[0]
  chip_smoke.log(f'K6 launch: a cooperative grid of {info[0]} blocks '
                 f'({info[1]} a multiprocessor, {info[2]} multiprocessors) '
                 f'of {info[4]} threads, {info[3]} bytes of dynamic shared '
                 'memory a block')

  rng = np.random.default_rng(7)
  for t, n in SHAPES:
    a = torch.from_numpy(chip_smoke.spd_batch(rng, t, n)).to(dev)
    got = chol_hbm.launch_chol_hbm(a)
    err = float((got.double() - chol_hbm.cholesky_hbm_plain(
        a.double())).abs().max())
    chip_smoke.log(f'K6 ({t}, {n}, {n}): max abs err vs float64 plain '
                   f'{err:.3e}')
    if not err <= chip_smoke.L_ATOL:
      raise AssertionError(f'K6 error {err} at ({t}, {n})')
  bad = chip_smoke.spd_batch(rng, 3, 1024)
  bad[1, -1, -1] = -5.0
  got = chol_hbm.launch_chol_hbm(torch.from_numpy(bad).to(dev))
  nan_only = (bool(torch.isnan(got[1]).all()) and
              bool(torch.isfinite(got[[0, 2]]).all()))
  chip_smoke.log(f'K6 non-PD middle matrix of (3, 1024, 1024): NaN there '
                 f'only {nan_only}')
  if not nan_only:
    raise AssertionError('K6 must give NaN for the non-PD matrix only')
  a = torch.from_numpy(chip_smoke.spd_batch(rng, 1, 1024)).to(dev)
  before = chol_hbm.KERNEL.launches
  first = chol_hbm.launch_chol_hbm(a)
  launches = chol_hbm.KERNEL.launches - before
  same = torch.equal(first, chol_hbm.launch_chol_hbm(a))
  chip_smoke.log(f'K6 two calls at (1, 1024, 1024) bitwise equal: {same}; '
                 f'launches a call: {launches}')
  if not (same and launches == 1):
    raise AssertionError(f'K6 determinism {same}, launches {launches}')

  splits = []
  for t, n in TIMED:
    a = torch.from_numpy(chip_smoke.spd_batch(rng, t, n)).to(dev)
    a = 0.5 * (a + a.transpose(-1, -2))
    ms = chip_smoke._turns(
        chip_smoke.DENSE_TIMED_RUNS,
        plain=lambda: chol_hbm.cholesky_hbm_plain(a),
        kernel=lambda: chol_hbm.launch_chol_hbm(a),
        library=lambda: torch.linalg.cholesky(a))
    alone = kernel_alone_ms(a, chol_hbm.KERNEL.build())
    chip_smoke.log(f'K6 time at ({t}, {n}, {n}) (median of '
                   f'{2 * chip_smoke.DENSE_TIMED_RUNS} each): ' +
                   ', '.join(f'{k} {v:.4f} ms' for k, v in ms.items()) +
                   f'; the kernel alone {alone:.4f} ms (mean of '
                   f'{BACK_TO_BACK} back to back) [{card}]')
    if t == 1 and n in (1024, 4096):
      splits.append((a, alone))
    if (t, n) == (1, 1024):
      one = a

  calls = 5
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      chol_hbm.launch_chol_hbm(one)
    torch.cuda.synchronize()
  for event in prof.key_averages():
    device_us = getattr(event, 'device_time_total', 0.0)
    if device_us > 0:
      chip_smoke.log(f'K6 wrapper (1, 1024, 1024) per call: '
                     f'{device_us / calls / 1e3:.4f} ms in '
                     f'{event.count // calls} launches of {event.key[:72]}')
  for a, kernel_ms in splits:
    split_by_part(lib, a, grid, kernel_ms)


if __name__ == '__main__':
  main()
