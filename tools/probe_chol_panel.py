"""Probe of kernel K7 (hyperbo_tpu_torch/csrc/chol_panel.cu) alone on one
CUDA card.

    python3 tools/probe_chol_panel.py

Builds K7 and prints nvcc's register, spill and shared-memory report, and
the launch at n = 512: cluster size, threads and dynamic shared memory a
block, and how many such clusters the card holds at once. Holds K7 against
the float64 plain version at chip_smoke.py phase 8's shapes (max abs,
bound 5e-4) and prints a digest of those outputs (equal digests from two
checkouts: bitwise equal factors), checks NaN for a non-PD middle matrix
of a batch and only there, two calls at (1, 512, 512) bitwise equal and
one launch a call.
Times the wrapper, its plain version and torch.linalg.cholesky at
(1, 512, 512) and (2, 512, 512) (medians of CUDA-event timings, in turns),
the kernel alone back to back, and the device time of each kernel of one
wrapper call (torch.profiler). Splits one launch at (1, 512, 512) by part
from the clock64() laps of hyperbo_chol_panel_stamped: the load, then
step by step the update, diagonal factor, panel solve and barrier of the
block on the chain, then the store, and the diagonal factors by their
first sub-block factors, row solves, and trailing updates with the next
sub-block's factor beside them. With the card's name and power limit.
"""

import ctypes
import hashlib
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# pylint: disable=wrong-import-position,protected-access
import chip_smoke
from hyperbo_tpu_torch.ops import chol_panel

SHAPES = ((1, 1), (1, 37), (1, 64), (1, 65), (1, 128), (1, 300), (1, 511),
          (1, 512), (chip_smoke.TASKS, chip_smoke.BATCH))
STAMP_SLOTS = 38  # csrc/chol_panel.cu kStampSlots
SPLIT_SLOTS = 35  # kSplitSlots: the diagonal factors' split
BACK_TO_BACK = 200


def library():
  lib = ctypes.CDLL(chol_panel.KERNEL.library_path())
  lib.hyperbo_chol_panel_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
  lib.hyperbo_chol_panel_info.restype = ctypes.c_int
  lib.hyperbo_chol_panel_stamped.argtypes = [
      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
      ctypes.c_void_p, ctypes.c_void_p]
  lib.hyperbo_chol_panel_stamped.restype = ctypes.c_int
  return lib


def check(err, what):
  if err != 0:
    raise RuntimeError(f'{what} failed: CUDA error {err}')


def kernel_alone_ms(a, runs=5):
  """Median over `runs` of the mean time of BACK_TO_BACK launches of the C
  entry point (no wrapper, no poison)."""
  fn = chol_panel.KERNEL.build()
  n = a.shape[-1]
  batch = a.numel() // (n * n)
  out = torch.empty_like(a)
  stream = torch.cuda.current_stream().cuda_stream

  def burst():
    for _ in range(BACK_TO_BACK):
      check(fn(a.data_ptr(), out.data_ptr(), n, batch, stream), 'K7')

  burst()
  torch.cuda.synchronize()
  return statistics.median(chip_smoke.median_ms(burst, runs)) / BACK_TO_BACK


def split_by_part(lib, a, kernel_ms):
  """One stamped launch: each part's cycles along the chain (in step s,
  block s updates and then factors; its update counts what its warps 4-7
  take beyond the diagonal factor of warps 0-3), and its share of block
  0's span times the kernel's time alone; then the diagonal factors' split
  into their first sub-block factors, row solves, and trailing updates with
  the next sub-block's factor beside them."""
  n = a.shape[-1]
  nc = -(-n // chol_panel.BLOCK)
  stamps = torch.zeros((nc, STAMP_SLOTS), dtype=torch.int64, device=a.device)
  out = torch.empty_like(a)
  stream = torch.cuda.current_stream().cuda_stream
  for _ in range(3):
    check(lib.hyperbo_chol_panel_stamped(a.data_ptr(), out.data_ptr(), n, 1,
                                         stamps.data_ptr(), stream),
          'stamped K7')
  torch.cuda.synchronize()
  s = stamps.cpu().numpy().astype(np.int64)
  names = ('update', 'diagonal', 'panel', 'barrier')
  parts = dict(load=int(s[0, 0]), **{k: 0 for k in names},
               store=int(s[0, 1]))
  for step in range(nc):
    laps = s[step, 3 + 4 * step:7 + 4 * step]
    for name, cycles in zip(names, laps):
      parts[name] += int(cycles)
    chip_smoke.log(f'  step {step}, block {step}: ' + ', '.join(
        f'{k} {v}' for k, v in zip(names, laps)) + ' cycles')
  span = int(s[0, 2])
  chip_smoke.log(f'K7 (1, {n}, {n}) by part, {span} cycles in block 0 '
                 f'({span / kernel_ms / 1e6:.3f} GHz at the kernel\'s time '
                 f'alone):')
  for name, cycles in parts.items():
    chip_smoke.log(f'  {name}: {cycles} cycles, {cycles / span:.1%}, '
                   f'{cycles / span * kernel_ms * 1e3:.2f} us')
  other = span - sum(parts.values())
  chip_smoke.log(f'  unassigned: {other} cycles ({other / span:.1%})')
  split = s[:, SPLIT_SLOTS:SPLIT_SLOTS + 3].sum(axis=0)
  chip_smoke.log('  diagonal factors: ' + ', '.join(
      f'{k} {int(v)} cycles' for k, v in zip(
          ('first sub-block factors', 'row solves',
           'trailing updates with the next sub-block factors'), split)))


def main():
  card = chip_smoke.phase_device()
  dev = torch.device('cuda', 0)
  chip_smoke.phase_build([chol_panel.KERNEL])
  log = chol_panel.KERNEL.build_log
  for line in log.splitlines():
    if 'registers' in line or 'spill' in line or 'smem' in line:
      chip_smoke.log(f'ptxas: {line.strip()}')
  lib = library()
  info = (ctypes.c_int * 4)()
  check(lib.hyperbo_chol_panel_info(512, info), 'hyperbo_chol_panel_info')
  chip_smoke.log(f'K7 launch at n = 512: clusters of {info[0]} blocks of '
                 f'{info[1]} threads, {info[2]} bytes of dynamic shared '
                 f'memory a block; {info[3]} such clusters fit on the card')

  rng = np.random.default_rng(7)
  digest = hashlib.sha256()
  for t, n in SHAPES:
    a = torch.from_numpy(chip_smoke.spd_batch(rng, t, n)).to(dev)
    got = chol_panel.launch_chol_panel(a)
    digest.update(got.cpu().numpy().tobytes())
    err = float((got.double() - chol_panel.cholesky_panel_plain(
        a.double())).abs().max())
    chip_smoke.log(f'K7 ({t}, {n}, {n}): max abs err vs float64 plain '
                   f'{err:.3e}')
    if not err <= chip_smoke.L_ATOL:
      raise AssertionError(f'K7 error {err} at ({t}, {n})')
  chip_smoke.log(f'K7 output digest at the shapes above: '
                 f'{digest.hexdigest()}')
  bad = chip_smoke.spd_batch(rng, 3, 300)
  bad[1, -1, -1] = -5.0
  got = chol_panel.launch_chol_panel(torch.from_numpy(bad).to(dev))
  nan_only = (bool(torch.isnan(got[1]).all()) and
              bool(torch.isfinite(got[[0, 2]]).all()))
  chip_smoke.log(f'K7 non-PD middle matrix of (3, 300, 300): NaN there only '
                 f'{nan_only}')
  if not nan_only:
    raise AssertionError('K7 must give NaN for the non-PD matrix only')
  a = torch.from_numpy(chip_smoke.spd_batch(rng, 1, 512)).to(dev)
  before = chol_panel.KERNEL.launches
  first = chol_panel.launch_chol_panel(a)
  launches = chol_panel.KERNEL.launches - before
  same = torch.equal(first, chol_panel.launch_chol_panel(a))
  chip_smoke.log(f'K7 two calls at (1, 512, 512) bitwise equal: {same}; '
                 f'launches a call: {launches}')
  if not (same and launches == 1):
    raise AssertionError(f'K7 determinism {same}, launches {launches}')

  for t in (1, 2):
    a = torch.from_numpy(chip_smoke.spd_batch(rng, t, 512)).to(dev)
    a = 0.5 * (a + a.transpose(-1, -2))
    ms = chip_smoke._turns(
        chip_smoke.DENSE_TIMED_RUNS,
        plain=lambda: chol_panel.cholesky_panel_plain(a),
        kernel=lambda: chol_panel.launch_chol_panel(a),
        library=lambda: torch.linalg.cholesky(a))
    alone = kernel_alone_ms(a)
    chip_smoke.log(f'K7 time at ({t}, 512, 512) (median of '
                   f'{2 * chip_smoke.DENSE_TIMED_RUNS} each): ' +
                   ', '.join(f'{k} {v:.4f} ms' for k, v in ms.items()) +
                   f'; the kernel alone {alone:.4f} ms (mean of '
                   f'{BACK_TO_BACK} back to back) [{card}]')
    if t == 1:
      kernel_ms = alone
      one = a

  calls = 5
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      chol_panel.launch_chol_panel(one)
    torch.cuda.synchronize()
  for event in prof.key_averages():
    device_us = getattr(event, 'device_time_total', 0.0)
    if device_us > 0:
      chip_smoke.log(f'K7 wrapper (1, 512, 512) per call: '
                     f'{device_us / calls / 1e3:.4f} ms in '
                     f'{event.count // calls} launches of {event.key[:72]}')
  split_by_part(lib, one, kernel_ms)


if __name__ == '__main__':
  main()
