"""Probe of kernel K4 (hyperbo_tpu_torch/csrc/mll_bwd.cu) alone on one CUDA
card.

    python3 tools/probe_mll_bwd.py [--parent DIR]

Builds K4 and prints nvcc's register, spill and shared-memory report and
how many of its pair blocks fit a multiprocessor. On chip_smoke.py's inputs
(the float32 rounding of the float64 factor's inverse T and of alpha) it
holds K4 against the float64 plain version at n = 64 (Matern-5/2), 512,
704 (700 rows, Matern-3/2, masked), 5056 (5000 rows, masked) and 8192 (SE,
d = 8): P, d_sv_raw and d_da within max rel 5e-3; checks two calls at n = 8192
bitwise equal, with the output's digest, and one wrapper launch a call.
Times the wrapper at n = 8192 (medians of CUDA-event timings, in turns)
and, with --parent DIR (an unpacked earlier tree), that tree's
csrc/mll_bwd.cu built from its own sources and held to the same float64
result, in the same turns; nvidia-smi samples the SM clock and the power
draw every 100 ms through the timed turns. Then it builds K4 once more
with -DHYPERBO_BWD_LAPS into a temporary directory under build/ (deleted
after the run) and splits one launch at n = 8192: the pair blocks' cycles
waiting on the ring, multiplying chunks and in the epilogue, their FMA rate
in the chunks, the balance of the grid (the blocks' busy time over the
launch's span times the slots), and the reduction launch's span. With
--parent, last, it holds K3 (csrc/tri_inv.cu), the joint backward K8
(csrc/bwd_joint.cu, which keeps the 64 x 64 SYRK body of
csrc/bwd_core.cuh) and K6 (csrc/chol_hbm.cu) to the parent tree's, built
from its own sources: outputs bitwise equal (K3 and K8 at n = 8192, SE,
d = 8; K6 at chip_smoke.py's (1, 1024, 1024)), with their digest, and both
timed in turns in one process while nvidia-smi samples the clocks. With
the card's name and power limit.
"""

import argparse
import ctypes
import os
import statistics
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
from hyperbo_tpu_torch.ops import bwd_joint
from hyperbo_tpu_torch.ops import chol_hbm
from hyperbo_tpu_torch.ops import mll_bwd
from hyperbo_tpu_torch.ops import tri_inv

N = 8192
CASES = ((64, 2, 'matern52', 5), (512, 4, 'se', 1), (700, 3, 'matern32', 2),
         (5000, chip_smoke.FUSED_DIM, 'se', 4),
         (N, chip_smoke.FUSED_DIM, 'se', 3))
LAP_SLOTS = 6  # csrc/syrk128_core.cuh kLapSlots
INFO = ('pair blocks a multiprocessor', 'multiprocessors',
        'dynamic shared bytes a block', 'threads a block')


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


def load_entry(lib_path):
  fn = ctypes.CDLL(lib_path).hyperbo_mll_bwd
  fn.argtypes = mll_bwd.KERNEL.argtypes
  fn.restype = ctypes.c_int
  return fn


def parent_call(fn, t, x, alpha, sv):
  """One call of the parent tree's K4 (64 x 64 tile pairs) on SE inputs."""
  n, d = x.shape
  nb = n // mll_bwd.TILE
  opts = dict(dtype=torch.float32, device=t.device)
  p_part = torch.empty((nb, nb, mll_bwd.TILE, d + 1), **opts)
  s_part = torch.empty((nb * (nb + 1),), dtype=torch.float64,
                       device=t.device)
  p = torch.empty((n, d + 1), **opts)
  out = torch.empty((2,), **opts)
  check(fn(t.data_ptr(), x.data_ptr(), alpha.data_ptr(), None,
           sv.data_ptr(), n, d, 0, p_part.data_ptr(), s_part.data_ptr(),
           p.data_ptr(), out.data_ptr(),
           torch.cuda.current_stream().cuda_stream), 'parent K4')
  return p, out[0], out[1]


def case_inputs(dev, n, d, kfam, seed):
  """chip_smoke.fused_case's K4 inputs: float32 T, x, alpha, sv, valid and
  their float64 counterparts."""
  ins32, ins64 = chip_smoke.fused_inputs(dev, n, d, seed)
  x32, _, sv32, _, v32 = ins32
  x64, y64, sv64, _, v64 = ins64
  l_in = chip_smoke.input_factor(ins64, kfam)[3]
  t64 = tri_inv.tri_inv_plain(l_in.double())
  t = t64.float().contiguous()
  alpha = tri_inv.alpha_from_inverse(t64, y64).float().contiguous()
  return (t, x32, alpha, sv32, v32), (t.double(), x64, alpha.double(), sv64,
                                      v64)


def errors(got, want):
  (p, dsv, dda), (p64, dsv64, dda64) = got, want
  return (chip_smoke._rel(p, p64),
          abs(float(dsv) - float(dsv64)) / abs(float(dsv64)),
          abs(float(dda) - float(dda64)) / abs(float(dda64)))


def check_errors(what, errs):
  chip_smoke.log(f'{what}: max rel vs float64 P {errs[0]:.3e}, d_sv_raw '
                 f'{errs[1]:.3e}, d_da {errs[2]:.3e}')
  if not max(errs) <= chip_smoke.GRAD_MAX_REL:
    raise AssertionError(f'{what}: errors {errs} past '
                         f'{chip_smoke.GRAD_MAX_REL}')


class ClockSampler:
  """nvidia-smi sampling the SM clock (MHz) and power draw (W) every 100 ms
  while the `with` block runs; the process is stopped at its end."""

  def __enter__(self):
    self.proc = subprocess.Popen(
        ['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
         '--format=csv,noheader,nounits', '-lms', '100'],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    return self

  def __exit__(self, *exc):
    self.proc.terminate()
    out, _ = self.proc.communicate(timeout=10)
    rows = []
    for line in out.splitlines():
      try:
        rows.append([float(v) for v in line.split(',')])
      except ValueError:
        continue
    self.samples = np.array(rows).reshape(-1, 2)

  def summary(self):
    if not len(self.samples):
      return 'no nvidia-smi samples'
    clk, pw = self.samples[:, 0], self.samples[:, 1]
    return (f'{len(clk)} nvidia-smi samples: SM clock min {clk.min():.0f}, '
            f'median {np.median(clk):.0f}, max {clk.max():.0f} MHz; power '
            f'median {np.median(pw):.1f}, max {pw.max():.1f} W')


def split_launch(fn_laps, set_laps, inputs, kernel_ms, info):
  """One laps launch at n = 8192, split by part and checked for balance."""
  t, x, alpha, sv, _ = inputs
  n, d = x.shape
  tasks = mll_bwd.mll_bwd_tasks(n)
  pairs = len(tasks)
  red_blocks = -(-n * (d + 1) // mll_bwd.REDUCE_THREADS) + 1
  laps = torch.zeros((pairs + red_blocks, LAP_SLOTS), dtype=torch.int64,
                     device=t.device)
  check(set_laps(laps.data_ptr()), 'hyperbo_mll_bwd_laps')
  real = mll_bwd.KERNEL._fn
  mll_bwd.KERNEL._fn = fn_laps
  try:
    ms = chip_smoke._turns(
        chip_smoke.FUSED_TIMED_RUNS,
        laps=lambda: mll_bwd.launch_mll_bwd(t, x, alpha, sv))['laps']
    laps.zero_()
    mll_bwd.launch_mll_bwd(t, x, alpha, sv)
    torch.cuda.synchronize()
  finally:
    mll_bwd.KERNEL._fn = real
  s = laps.cpu().numpy().astype(np.int64)
  pr, red = s[:pairs], s[pairs:]
  t0 = pr[:, 0].min()
  span = (pr[:, 1].max() - t0) / 1e6
  busy_ns = (pr[:, 1] - pr[:, 0]).astype(np.float64)
  slots = info[0] * info[1]
  cyc = pr[:, 3:6].astype(np.float64)
  ghz = np.median(cyc.sum(axis=1) / busy_ns)
  chip_smoke.log(f'K4 n={n} laps build: {ms:.3f} ms a call (this build, '
                 f'{kernel_ms:.3f} without laps); pair launch span '
                 f'{span:.3f} ms over {pairs} blocks on '
                 f'{len(set(pr[:, 2]))} multiprocessors, '
                 f'{ghz:.3f} GHz (median block cycles / ns)')
  total = cyc.sum()
  chip_smoke.log('  (thread 0\'s cycles a block; a block in its epilogue '
                 'leaves the multiprocessor to the other block\'s SYRK)')
  for k, name in enumerate(('waiting on the ring (copies, barrier)',
                            'multiplying chunks', 'epilogue')):
    chip_smoke.log(f'  {name}: {cyc[:, k].sum() / total:.1%} of the pair '
                   f'blocks\' cycles, {cyc[:, k].sum() / ghz / 1e6 / slots:.3f}'
                   f' ms a slot')
  fma = np.array([mll_bwd.tile_width(n, p.i) * mll_bwd.tile_width(n, p.j) *
                  p.chunks * mll_bwd.CHUNK for p in tasks], dtype=np.float64)
  rate = fma / np.maximum(cyc[:, 1], 1)
  chip_smoke.log(f'  FMA a cycle in the chunks, a block: median '
                 f'{np.median(rate):.1f}, heaviest pair {rate[0]:.1f}, '
                 f'{np.percentile(rate, 10):.1f}-{np.percentile(rate, 90):.1f}'
                 f' (10-90%; 128 an SM at most, {info[0]} blocks an SM)')
  chip_smoke.log(f'  balance: blocks busy {busy_ns.sum() / 1e6:.3f} ms in '
                 f'all, {busy_ns.sum() / 1e6 / (span * slots):.1%} of '
                 f'{slots} slots x the span; the last block starts at '
                 f'{(pr[-1, 0] - t0) / 1e6:.3f} ms, the last ends at '
                 f'{span:.3f} ms; the first {slots} blocks end at '
                 f'{(np.sort(pr[:slots, 1]) - t0)[[0, slots // 2, -1]] / 1e6}'
                 ' ms (min, median, max)')
  start = red[:, 0].min()
  chip_smoke.log(f'  reduction launch: starts {(start - t0) / 1e6:.3f} ms, '
                 f'span {(red[:, 1].max() - start) / 1e6:.3f} ms '
                 f'({red_blocks} blocks)')


def against_parent(tmp, parent, kernel, what, call, card):
  """`call()` through this tree's build of `kernel` and through the parent
  tree's, built from its own sources: outputs bitwise equal, with their
  digest, and both timed in turns while nvidia-smi samples the clocks."""
  stem = os.path.splitext(kernel.source)[0]
  path = os.path.join(tmp, f'lib{stem}_parent.so')
  report(nvcc(os.path.join(parent, 'hyperbo_tpu_torch', 'csrc',
                           kernel.source), path), f'parent {stem}')
  fn = getattr(ctypes.CDLL(path), kernel.symbol)
  fn.argtypes = kernel.argtypes
  fn.restype = ctypes.c_int
  own = kernel.build()

  def run(entry):
    kernel._fn = entry
    try:
      outs = call()
    finally:
      kernel._fn = own
    return outs if isinstance(outs, tuple) else (outs,)

  mine, theirs = run(own), run(fn)
  same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
  dig = [chip_smoke.digest(torch.cat([o.reshape(-1) for o in outs]))
         for outs in (mine, theirs)]
  chip_smoke.log(f'{what}: outputs bitwise the parent\'s {same}; '
                 f'digest {dig[0]} (parent {dig[1]})')
  if not same:
    raise AssertionError(f'{what} differs from the parent tree\'s')
  with ClockSampler() as clocks:
    ms = chip_smoke._turns(2 * chip_smoke.FUSED_TIMED_RUNS,
                           parent=lambda: run(fn), kernel=lambda: run(own))
  chip_smoke.log(f'{what} (median of {4 * chip_smoke.FUSED_TIMED_RUNS} '
                 'each, in turns): ' +
                 ', '.join(f'{k} {v:.3f} ms' for k, v in ms.items()) +
                 f' [{card}]; {clocks.summary()}')


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument('--parent', help='an unpacked earlier tree whose K4 '
                      'is timed beside this one')
  args = parser.parse_args()
  card = chip_smoke.phase_device()
  dev = torch.device('cuda', 0)
  chip_smoke.phase_build([mll_bwd.KERNEL] + (
      [tri_inv.KERNEL, bwd_joint.KERNEL, chol_hbm.KERNEL]
      if args.parent else []))
  report(mll_bwd.KERNEL.build_log, 'K4')
  lib = ctypes.CDLL(mll_bwd.KERNEL.library_path())
  lib.hyperbo_mll_bwd_info.argtypes = [ctypes.c_void_p]
  lib.hyperbo_mll_bwd_info.restype = ctypes.c_int
  info = (ctypes.c_int * len(INFO))()
  check(lib.hyperbo_mll_bwd_info(info), 'hyperbo_mll_bwd_info')
  chip_smoke.log('K4 pair launch: ' + ', '.join(
      f'{k} {v}' for k, v in zip(INFO, info)))

  for n, d, kfam, seed in CASES:
    ins, ins64 = case_inputs(dev, n, d, kfam, seed)
    got = mll_bwd.launch_mll_bwd(*ins[:4], kfam, ins[4])
    want = mll_bwd.mll_bwd_plain(*ins64[:4], kfam, ins64[4])
    check_errors(f'K4 n={ins[0].shape[0]} d={d} {kfam}' +
                 (' masked' if ins[4] is not None else ''),
                 errors(got, want))
  big, big64 = ins, ins64
  before = mll_bwd.KERNEL.launches
  first = mll_bwd.launch_mll_bwd(*big[:4])
  launches = mll_bwd.KERNEL.launches - before
  second = mll_bwd.launch_mll_bwd(*big[:4])
  same = all(torch.equal(a, b) for a, b in zip(first, second))
  dig = chip_smoke.digest(torch.cat([o.reshape(-1) for o in first]))
  chip_smoke.log(f'K4 n={N}: two calls bitwise equal {same}, {launches} '
                 f'wrapper launch a call; output digest {dig}')
  if not (same and launches == 1):
    raise AssertionError('K4: two calls differ, or not one launch a call')

  fns = {'kernel': lambda: mll_bwd.launch_mll_bwd(*big[:4])}
  os.makedirs(_build.BUILD_DIR, exist_ok=True)
  with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
    if args.parent:
      path = os.path.join(tmp, 'libmll_bwd_parent.so')
      report(nvcc(os.path.join(args.parent, 'hyperbo_tpu_torch', 'csrc',
                               'mll_bwd.cu'), path), 'parent K4')
      parent = load_entry(path)
      check_errors(f'parent K4 n={N}',
                   errors(parent_call(parent, *big[:4]),
                          mll_bwd.mll_bwd_plain(*big64[:4])))
      fns['parent'] = lambda: parent_call(parent, *big[:4])
    with ClockSampler() as clocks:
      ms = chip_smoke._turns(2 * chip_smoke.FUSED_TIMED_RUNS, **fns)
    chip_smoke.log(f'K4 n={N} (median of {4 * chip_smoke.FUSED_TIMED_RUNS} '
                   'each, in turns): ' +
                   ', '.join(f'{k} {v:.3f} ms' for k, v in ms.items()) +
                   f' [{card}]')
    chip_smoke.log(f'  during the turns: {clocks.summary()}')
    times = [statistics.median(chip_smoke.median_ms(fns['kernel'], 5))
             for _ in range(3)]
    chip_smoke.log(f'  three more medians of the kernel: '
                   f'{", ".join(f"{v:.3f}" for v in times)} ms')

    path = os.path.join(tmp, 'libmll_bwd_laps.so')
    report(nvcc(mll_bwd.KERNEL.source_path, path, '-DHYPERBO_BWD_LAPS'),
           'K4 laps build')
    lap_lib = ctypes.CDLL(path)
    lap_lib.hyperbo_mll_bwd_laps.argtypes = [ctypes.c_void_p]
    lap_lib.hyperbo_mll_bwd_laps.restype = ctypes.c_int
    fn_laps = lap_lib.hyperbo_mll_bwd
    fn_laps.argtypes = mll_bwd.KERNEL.argtypes
    fn_laps.restype = ctypes.c_int
    split_launch(fn_laps, lap_lib.hyperbo_mll_bwd_laps, big, ms['kernel'],
                 info)
    if args.parent:
      ins32, ins64 = chip_smoke.fused_inputs(dev, N, chip_smoke.FUSED_DIM, 3)
      x, y, sv, _, _ = ins32
      l = chip_smoke.input_factor(ins64, 'se')[3]
      against_parent(tmp, args.parent, tri_inv.KERNEL, f'K3 n={N}',
                     lambda: tri_inv.launch_tri_inv(l), card)
      against_parent(tmp, args.parent, bwd_joint.KERNEL, f'K8 n={N}',
                     lambda: bwd_joint.launch_mll_bwd_joint(l, x, y, sv),
                     card)
      a = torch.from_numpy(chip_smoke.spd_batch(
          np.random.default_rng(0), 1, chip_smoke.ALIGNED_POINTS)).to(dev)
      a = 0.5 * (a + a.transpose(-1, -2))
      against_parent(tmp, args.parent, chol_hbm.KERNEL,
                     f'K6 (1, {a.shape[1]}, {a.shape[2]})',
                     lambda: chol_hbm.launch_chol_hbm(a), card)


if __name__ == '__main__':
  main()
