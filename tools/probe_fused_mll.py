"""Probe of kernel K2 (hyperbo_tpu_torch/csrc/fused_mll.cu) alone on one CUDA
card.

    python3 tools/probe_fused_mll.py [--parent DIR]

Builds K2 and prints nvcc's register, spill and shared-memory report, and
the persistent launch: blocks of the grid, blocks a multiprocessor, threads
and dynamic shared memory a block. Holds K2 against the float64 plain
version at n = 64, 512, 704 (700 rows, Matern-3/2, masked), 1216 (1170
rows, Matern-5/2, masked), 5056 (5000 rows, masked) and 8192 (L max abs,
bound 5e-4; quad and logdet_half relative, bound 1e-4), checks NaN value
and gradients for a non-PD input, two calls at n = 8192 bitwise equal (with
the output's digest), one wrapper launch a call, and lists the kernel
launches of one call with their device times (torch.profiler). Times the
wrapper, its plain version and torch.linalg.cholesky of the same K (the
Gram built outside the timing) at n = 4096, 8192 and 16384 (medians of
CUDA-event timings, in turns). With --parent DIR (a checkout of an earlier
tree), also builds that tree's csrc/fused_mll.cu, holds it to the same
float64 result at n = 8192 and times it in the same turns there. Then
builds K2 once more with -DHYPERBO_MLL_LAPS into a temporary directory
under build/ (deleted after the run) and splits one launch at n = 8192 by
part from the clock64() laps of thread 0 of each block: the chain block's
diagonal factors, the solve and update between a step's two, its waits on
its warps 4-7, its right-half solves and its lookahead, and what its warps
4-7 spent waiting on the workers; the workers' waits, loads, panel solves,
held updates, trailing updates, stores and releases. Last, the launch's
timeline: the chain's steps in groups of eight, each group's time and what
the chain spent waiting on the workers in it, and when the workers ended.
With the card's name and power limit.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# pylint: disable=wrong-import-position,protected-access
import chip_smoke
from hyperbo_tpu_torch.ops import _build
from hyperbo_tpu_torch.ops import fused_mll
from hyperbo_tpu_torch.ops import mll_bwd

CASES = ((64, 64, 4, 'se', 1), (512, 512, 4, 'se', 1),
         (704, 700, 3, 'matern32', 2), (1216, 1170, 5, 'matern52', 6),
         (5056, 5000, chip_smoke.FUSED_DIM, 'se', 4),
         (8192, 8192, chip_smoke.FUSED_DIM, 'se', 3))
TIMED = (4096, 8192, 16384)
LAP_SLOTS = 17  # csrc/fused_mll.cu kLapSlots
CHAIN_PARTS = ('first load', 'diagonal factors',
               'L1\'s solve and D1\'s update between them',
               'waits on warps 4-7 (loads, left solves)',
               'right solves beside the releases',
               'lookahead beside the releases')
SPLIT = ('first sub-block factors', 'row solves',
         'trailing updates with the next sub-block factors')
WORKER_PARTS = ('waits on counters', 'waits on a solve\'s loads',
                'panel solves and their stores', 'held updates',
                'trailing updates', 'stores, partials and releases')


def check(err, what):
  if err != 0:
    raise RuntimeError(f'{what} failed: CUDA error {err}')


def nvcc(source, out, *flags):
  """Builds `source` into the shared library `out`; returns nvcc's log."""
  proc = subprocess.run(
      [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, '-o', out, source],
      capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f'nvcc failed for {source}:\n{proc.stdout}'
                       f'{proc.stderr}')
  return proc.stdout + proc.stderr


def report(log, what):
  for line in log.splitlines():
    if 'registers' in line or 'spill' in line or 'smem' in line:
      chip_smoke.log(f'ptxas ({what}): {line.strip()}')


def scratch(n, dev):
  ns = -(-n // fused_mll.SUPER)
  opts = dict(dtype=torch.float32, device=dev)
  return (torch.empty((n, n), **opts), torch.empty((ns, fused_mll.PANEL),
                                                    **opts),
          torch.empty((ns, ns, fused_mll.SUPER), **opts),
          torch.zeros((ns, ns), dtype=torch.int32, device=dev),
          torch.empty((2,), **opts))


def run_entry(fn, ins, kfam='se'):
  """One call of a build of this tree's C entry point on float32 inputs."""
  x, y, sv, da, valid = ins
  n, d = x.shape
  chol, panel, partial, counts, out = scratch(n, x.device)
  z = y.reshape(n).clone()
  sv_da = torch.cat([sv.reshape(1), da.reshape(1)])
  tasks = fused_mll.task_table(n, x.device)
  check(fn(x.data_ptr(), None if valid is None else valid.data_ptr(),
           sv_da.data_ptr(), z.data_ptr(), n, d, mll_bwd.KFAM_CODE[kfam],
           chol.data_ptr(), panel.data_ptr(), partial.data_ptr(),
           counts.data_ptr(), tasks.data_ptr(), tasks.numel(),
           out.data_ptr(), torch.cuda.current_stream().cuda_stream), 'K2')
  return chol, out


def parent_entry(tmp, parent):
  """The parent tree's K2 (Gram, then three launches a 64-wide panel),
  built from its own sources; a function of the float32 inputs returning
  (L, quad, logdet_half)."""
  lib_path = os.path.join(tmp, 'libfused_mll_parent.so')
  report(nvcc(os.path.join(parent, 'hyperbo_tpu_torch', 'csrc',
                           'fused_mll.cu'), lib_path), 'parent K2')
  fn = ctypes.CDLL(lib_path).hyperbo_mll_fused
  fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
      ctypes.c_void_p] * 5
  fn.restype = ctypes.c_int

  def call(x, y, sv, da):
    n, d = x.shape
    z = y.reshape(n).clone()
    sv_da = torch.cat([sv.reshape(1), da.reshape(1)])
    chol = torch.empty((n, n), dtype=torch.float32, device=x.device)
    dinv = torch.empty((64, 64), dtype=torch.float32, device=x.device)
    parts = torch.empty((2 * (n // 64),), dtype=torch.float64,
                        device=x.device)
    out = torch.empty((2,), dtype=torch.float32, device=x.device)
    check(fn(x.data_ptr(), None, sv_da.data_ptr(), z.data_ptr(), n, d, 0,
             chol.data_ptr(), dinv.data_ptr(), parts.data_ptr(),
             out.data_ptr(), torch.cuda.current_stream().cuda_stream),
          'parent K2')
    return chol, out[0], out[1]

  return call


def errors(got, ins64, kfam):
  chol, quad, ld = got
  x64, y64, sv64, da64, v64 = ins64
  chol64, quad64, ld64 = fused_mll.mll_fused_plain(x64, y64, sv64, da64,
                                                   kfam, v64)
  return (float((chol.double() - chol64).abs().max()),
          abs(float(quad) - float(quad64)) / abs(float(quad64)),
          abs(float(ld) - float(ld64)) / abs(float(ld64)))


def check_errors(what, errs):
  l_abs, quad_rel, ld_rel = errs
  chip_smoke.log(f'{what}: L max abs {l_abs:.3e}, quad rel {quad_rel:.3e}, '
                 f'logdet rel {ld_rel:.3e}')
  if not (l_abs <= chip_smoke.L_ATOL and quad_rel <= chip_smoke.VALUE_RTOL
          and ld_rel <= chip_smoke.VALUE_RTOL):
    raise AssertionError(f'{what}: errors {errs} past their bounds')


def split_by_part(fn_laps, set_laps, grid, ins, kernel_ms):
  """One laps launch at n = 8192: the chain block's parts as shares of its
  span and in microseconds at the kernel's time, the workers' parts summed
  over all workers; then the timeline: the chain's steps in groups of
  eight, each group's time and what the chain spent waiting on the
  workers in it, and when the workers ended."""
  ns = -(-ins[0].shape[0] // fused_mll.SUPER)
  laps = torch.zeros((grid, LAP_SLOTS), dtype=torch.int64,
                     device=ins[0].device)
  trace = torch.zeros((1 + 2 * ns + grid,), dtype=torch.int64,
                      device=ins[0].device)
  check(set_laps(laps.data_ptr(), trace.data_ptr()),
        'hyperbo_mll_fused_laps')
  for _ in range(3):
    laps.zero_()
    trace.zero_()
    run_entry(fn_laps, ins)
  torch.cuda.synchronize()
  s = laps.cpu().numpy().astype(np.int64)
  tr = trace.cpu().numpy().astype(np.int64)
  span = int(s[0, 0])
  n = ins[0].shape[0]
  chip_smoke.log(f'K2 n={n} by part (laps build), {span} cycles in the chain '
                 f'block ({span / kernel_ms / 1e6:.3f} GHz at the kernel\'s '
                 f'time, {kernel_ms:.3f} ms):')
  for name, cycles in zip(CHAIN_PARTS, s[0, 1:7]):
    chip_smoke.log(f'  chain {name}: {int(cycles)} cycles, '
                   f'{cycles / span:.1%}, '
                   f'{cycles / span * kernel_ms * 1e3:.1f} us')
  chip_smoke.log('  chain diagonal factors split: ' + ', '.join(
      f'{k} {int(v)} cycles' for k, v in zip(SPLIT, s[0, 7:10])))
  chip_smoke.log(f'  chain warps 4-7 waiting on the workers\' counters '
                 f'(beside the factors): {int(s[0, 10])} cycles, '
                 f'{s[0, 10] / span:.1%}')
  workers = s[1:]
  total = workers[:, 0].sum()
  chip_smoke.log(f'  workers ({len(workers)} blocks, {int(total)} cycles in '
                 'all):')
  for name, cycles in zip(WORKER_PARTS, workers[:, 11:17].sum(axis=0)):
    chip_smoke.log(f'    {name}: {int(cycles)} cycles, {cycles / total:.1%}')
  ghz = span / kernel_ms / 1e6
  ends = tr[1:1 + ns] - tr[0]
  spins = tr[1 + ns:1 + 2 * ns]
  chip_smoke.log(f'  timeline (global ns from the chain\'s start; its waits '
                 f'at {ghz:.3f} GHz):')
  for k0 in range(0, ns, 8):
    k1 = min(k0 + 8, ns)
    t0 = ends[k0 - 1] if k0 else 0
    w0 = spins[k0 - 1] if k0 else 0
    took = (ends[k1 - 1] - t0) / 1e3
    waited = (spins[k1 - 1] - w0) / ghz / 1e3
    chip_smoke.log(f'    chain steps {k0}-{k1 - 1}: end at '
                   f'{ends[k1 - 1] / 1e3:.1f} us, {took:.1f} us, of it '
                   f'waiting {waited:.1f} us')
  wend = np.sort(tr[2 + 2 * ns:1 + 2 * ns + grid] - tr[0])
  chip_smoke.log('  workers end at (us): min {:.1f}, median {:.1f}, max '
                 '{:.1f}; the chain at {:.1f}'.format(
                     wend[0] / 1e3, wend[len(wend) // 2] / 1e3,
                     wend[-1] / 1e3, ends[-1] / 1e3))


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument('--parent', help='a checkout of an earlier tree whose '
                      'K2 is timed beside this one')
  args = parser.parse_args()
  card = chip_smoke.phase_device()
  dev = torch.device('cuda', 0)
  chip_smoke.phase_build([fused_mll.KERNEL])
  report(fused_mll.KERNEL.build_log, 'K2')
  lib = ctypes.CDLL(fused_mll.KERNEL.library_path())
  lib.hyperbo_mll_fused_info.argtypes = [ctypes.c_void_p]
  lib.hyperbo_mll_fused_info.restype = ctypes.c_int
  info = (ctypes.c_int * 5)()
  check(lib.hyperbo_mll_fused_info(info), 'hyperbo_mll_fused_info')
  grid = info[0]
  chip_smoke.log(f'K2 launch: a cooperative grid of {info[0]} blocks '
                 f'({info[1]} a multiprocessor, {info[2]} multiprocessors) '
                 f'of {info[4]} threads, {info[3]} bytes of dynamic shared '
                 'memory a block')

  inputs = {}
  for n, rows, d, kfam, seed in CASES:
    ins32, ins64 = chip_smoke.fused_inputs(dev, rows, d, seed)
    x, y, sv, da, v = ins32
    got = fused_mll.launch_mll_fused(x, y, sv, da, kfam, v)
    check_errors(f'K2 n={n} ({rows} rows) d={d} {kfam}', errors(
        got, ins64, kfam))
    inputs[n] = (ins32, ins64)
  chip_smoke.fused_nonpd_check(dev)

  ins32, ins64 = inputs[8192]
  x, y, sv, da, _ = ins32
  before = fused_mll.KERNEL.launches
  first = fused_mll.launch_mll_fused(x, y, sv, da)
  launches = fused_mll.KERNEL.launches - before
  second = fused_mll.launch_mll_fused(x, y, sv, da)
  same = all(torch.equal(a, b) for a, b in zip(first, second))
  chip_smoke.log(f'K2 two calls at n=8192 bitwise equal: {same}; wrapper '
                 f'launches a call: {launches}; output digest '
                 f'{chip_smoke.digest(first[0])}')
  if not (same and launches == 1):
    raise AssertionError(f'K2 determinism {same}, launches {launches}')
  calls = 3
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      fused_mll.launch_mll_fused(x, y, sv, da)
    torch.cuda.synchronize()
  for event in prof.key_averages():
    device_us = getattr(event, 'device_time_total', 0.0)
    if device_us > 0:
      chip_smoke.log(f'K2 call at n=8192, per call: {event.count / calls:g} '
                     f'launches of {event.key[:60]}, '
                     f'{device_us / calls / 1e3:.4f} ms')

  os.makedirs(_build.BUILD_DIR, exist_ok=True)
  with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
    parent = parent_entry(tmp, args.parent) if args.parent else None
    if parent is not None:
      check_errors('parent K2 n=8192', errors(parent(x, y, sv, da), ins64,
                                              'se'))
    kernel_ms = None
    for n in TIMED:
      if n not in inputs:
        inputs[n] = chip_smoke.fused_inputs(dev, n, chip_smoke.FUSED_DIM, 3)
      xs, ys, svs, das, _ = inputs[n][0]
      gram = chip_smoke.fused_gram(xs, svs, das)
      fns = dict(
          plain=lambda: fused_mll.mll_fused_plain(xs, ys, svs, das),
          kernel=lambda: fused_mll.launch_mll_fused(xs, ys, svs, das),
          cholesky=lambda: torch.linalg.cholesky(gram))
      if parent is not None and n == 8192:
        fns['parent'] = lambda: parent(xs, ys, svs, das)
      ms = chip_smoke._turns(chip_smoke.FUSED_TIMED_RUNS, **fns)
      chip_smoke.log(f'K2 time at n={n} (median of '
                     f'{2 * chip_smoke.FUSED_TIMED_RUNS} each, in turns): ' +
                     ', '.join(f'{k} {v:.3f} ms' for k, v in ms.items()) +
                     f' [{card}]')
      if n == 8192:
        kernel_ms = ms['kernel']
      del gram

    lib_path = os.path.join(tmp, 'libfused_mll_laps.so')
    report(nvcc(fused_mll.KERNEL.source_path, lib_path, '-DHYPERBO_MLL_LAPS'),
           'laps build')
    laps_lib = ctypes.CDLL(lib_path)
    laps_lib.hyperbo_mll_fused_laps.argtypes = [ctypes.c_void_p] * 2
    laps_lib.hyperbo_mll_fused_laps.restype = ctypes.c_int
    fn_laps = laps_lib.hyperbo_mll_fused
    fn_laps.argtypes = fused_mll.KERNEL.argtypes
    fn_laps.restype = ctypes.c_int
    split_by_part(fn_laps, laps_lib.hyperbo_mll_fused_laps, grid,
                  inputs[8192][0], kernel_ms)


if __name__ == '__main__':
  main()
