"""Probe of kernel K1 (hyperbo_tpu_torch/csrc/batch_chol.cu) alone on one
CUDA card.

    python3 tools/probe_batch_chol.py [--parent DIR]

Builds K1 and prints nvcc's register, shared-memory and spill report and
its code size (cuobjdump's SASS, which every block fetches). Holds
`batched_linv_t` against the float64 plain version (atol 1e-5) at
(T, n) = (23, 100), (3, 128), (5, 37), (2, 1), n = 31, 32, 33, 64, 65 and
127, and (256, 100), more tasks than the card has multiprocessors; on a
batch that is not symmetric, against the plain version of 0.5 (K + K^T);
checks NaN for a non-PD task of a batch and only there, two calls bitwise
equal with their digest, and one launch a call. Then it times
`batched_linv_t` at the PD1 training shape (23, 100, 100) in three ways:
the device time (CUDA events around chip_smoke.BACK_TO_BACK calls queued
back to back, over their count), the kernels' times in torch.profiler, and
the per-call time (one call between a pair of events, as chip_smoke.py
times its phases). Last, it builds K1 again with -DHYPERBO_K1_LAPS into a
temporary directory under build/ and splits one launch at (23, 100, 100)
by phase (the load, the symmetrization, each panel's solve, and its update
beside the next panel's factor, the store) from
thread 0's clock64() stamps in each block.

With --parent DIR (an unpacked earlier tree, e.g. `git archive` of the
parent under build/), it builds that tree's csrc/batch_chol.cu from its own
source, holds it to the same float64 results, and times it in the same
turns through a copy of that tree's wrapper, which symmetrized the batch
in a torch kernel of its own before the launch; its C entry point was
hyperbo_batched_linv_t(kb, out, t, n, stream) on a symmetric kb. With the
card's name and power limit.
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

# pylint: disable=wrong-import-position
import chip_smoke
import probe_timing
from hyperbo_tpu_torch.ops import _build
from hyperbo_tpu_torch.ops import batch_chol

SHAPES = ((23, 100), (3, 128), (5, 37), (2, 1), (1, 31), (1, 32), (1, 33),
          (1, 64), (1, 65), (1, 127), (256, 100))
PARENT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
TURN_RUNS = 5
LAP_SLOTS = 16  # csrc/batch_chol.cu kLapSlots


def nvcc(source, out, *flags):
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


def code_size(lib_path, what):
  """The SASS instructions of each kernel in a built library (cuobjdump,
  beside nvcc), 16 bytes each."""
  tool = os.path.join(os.path.dirname(_build.find_nvcc()), 'cuobjdump')
  proc = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                        text=True)
  if proc.returncode != 0:
    chip_smoke.log(f'code size ({what}): cuobjdump failed')
    return
  counts, name = {}, None
  for line in proc.stdout.splitlines():
    if 'Function :' in line:
      name = line.split('Function :')[1].strip()
      counts[name] = 0
    elif name and line.strip().startswith('/*') and '*/' in line and (
        line.strip()[2:6].isalnum()) and ';' in line:
      counts[name] += 1
  for name, count in counts.items():
    chip_smoke.log(f'code size ({what}): {name[:60]} {count} instructions, '
                   f'{16 * count} bytes')


class Parent:
  """The parent tree's K1, built from its own source, called as its
  wrapper called it."""

  def __init__(self, tmp, parent_dir):
    path = os.path.join(tmp, 'libbatch_chol_parent.so')
    report(nvcc(os.path.join(parent_dir, 'hyperbo_tpu_torch', 'csrc',
                             'batch_chol.cu'), path), 'parent K1')
    code_size(path, 'parent K1')
    self.fn = ctypes.CDLL(path).hyperbo_batched_linv_t
    self.fn.argtypes = PARENT_ARGTYPES
    self.fn.restype = ctypes.c_int

  def __call__(self, kb):
    kb_sym = 0.5 * (kb + kb.transpose(-1, -2))
    out = torch.empty_like(kb_sym)
    err = self.fn(kb_sym.data_ptr(), out.data_ptr(), kb.shape[0],
                  kb.shape[1], torch.cuda.current_stream().cuda_stream)
    if err != 0:
      raise RuntimeError(f'parent hyperbo_batched_linv_t: CUDA error {err}')
    return out


def check(name, got, want, what):
  err = float((got.double() - want).abs().max())
  chip_smoke.log(f'K1 {name} {what}: max abs err vs float64 plain '
                 f'{err:.3e} (bound {chip_smoke.K1_ATOL:.0e})')
  if not err <= chip_smoke.K1_ATOL:
    raise AssertionError(f'K1 {name} disagrees at {what}')


def split_launch(tmp, kb, device_ms):
  """One launch of a -DHYPERBO_K1_LAPS build at kb's shape, split by phase
  from thread 0's clock64() stamps in each block (medians over blocks)."""
  path = os.path.join(tmp, 'libbatch_chol_laps.so')
  report(nvcc(batch_chol.KERNEL.source_path, path, '-DHYPERBO_K1_LAPS'),
         'K1 laps build')
  lib = ctypes.CDLL(path)
  fn = lib.hyperbo_batched_linv_t
  fn.argtypes = batch_chol.KERNEL.argtypes
  fn.restype = ctypes.c_int
  lib.hyperbo_batched_linv_t_laps.argtypes = [ctypes.c_void_p]
  lib.hyperbo_batched_linv_t_laps.restype = ctypes.c_int
  t, n, _ = kb.shape
  laps = torch.zeros((t, LAP_SLOTS), dtype=torch.int64, device=kb.device)
  if lib.hyperbo_batched_linv_t_laps(laps.data_ptr()) != 0:
    raise RuntimeError('hyperbo_batched_linv_t_laps failed')
  own = batch_chol.KERNEL.build()
  batch_chol.KERNEL._fn = fn  # pylint: disable=protected-access
  try:
    batch_chol.batched_linv_t(kb)
    laps_ms = chip_smoke.device_ms(lambda: batch_chol.batched_linv_t(kb))
    laps.zero_()
    batch_chol.batched_linv_t(kb)
    torch.cuda.synchronize()
  finally:
    batch_chol.KERNEL._fn = own  # pylint: disable=protected-access
  s = laps.cpu().numpy().astype(np.float64)
  panels = batch_chol.panels(n)
  marks = [('load K and I', 0, 1), ('symmetrize', 1, 2),
           ('panel 0 factor', 2, 3)]
  prev = 3
  for p, (p0, pw) in enumerate(panels):
    marks.append((f'panel {p} ({p0}..{p0 + pw - 1}) solve', prev, 4 + 2 * p))
    prev = 4 + 2 * p
    if p + 1 < len(panels):
      marks.append((f'panel {p} update, panel {p + 1} factor', prev,
                    5 + 2 * p))
      prev = 5 + 2 * p
  marks.append(('store B', prev, LAP_SLOTS - 1))
  total = np.median(s[:, -1] - s[:, 0])
  chip_smoke.log(f'K1 laps build at (T={t}, n={n}): {laps_ms:.4f} ms device '
                 f'time ({device_ms:.4f} without laps), a block {total:.0f} cycles from its '
                 f'first stamp to its last (median; {total / laps_ms / 1e6:.2f}'
                 ' GHz if the blocks span the launch)')
  for what, a, b in marks:
    cyc = np.median(s[:, b] - s[:, a])
    chip_smoke.log(f'  {what}: {cyc:.0f} cycles, {cyc / total:.1%}')


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument('--parent', help='an unpacked earlier tree whose K1 '
                      'is timed beside this one')
  args = parser.parse_args()
  card = chip_smoke.phase_device()
  dev = torch.device('cuda', 0)
  chip_smoke.phase_build([batch_chol.KERNEL])
  report(batch_chol.KERNEL.build_log, 'K1')
  code_size(batch_chol.KERNEL.library_path(), 'K1')
  rng = np.random.default_rng(0)
  os.makedirs(_build.BUILD_DIR, exist_ok=True)
  with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
    calls = {'kernel': batch_chol.batched_linv_t}
    if args.parent:
      calls['parent'] = Parent(tmp, args.parent)
    for t, n in SHAPES:
      kb = torch.from_numpy(chip_smoke.spd_batch(rng, t, n)).to(dev)
      want = batch_chol.linv_t_plain(
          0.5 * (kb.double() + kb.double().transpose(-1, -2)))
      for name, call in calls.items():
        before = batch_chol.KERNEL.launches
        check(name, call(kb), want, f'(T={t}, n={n})')
        if name == 'kernel' and batch_chol.KERNEL.launches != before + 1:
          raise AssertionError('K1: not one launch a call')

    # A batch that is not symmetric: the kernel factors 0.5 (K + K^T).
    kb = torch.from_numpy(chip_smoke.spd_batch(rng, 4, 100)).to(dev)
    kb = kb + 0.01 * torch.triu(torch.ones_like(kb), diagonal=1)
    want = batch_chol.linv_t_plain(
        0.5 * (kb.double() + kb.double().transpose(-1, -2)))
    for name, call in calls.items():
      check(name, call(kb), want, '(T=4, n=100), not symmetric')

    bad = torch.from_numpy(chip_smoke.spd_batch(rng, 3, 100)).to(dev)
    bad[1] -= 10.0 * torch.eye(100, device=dev)
    for name, call in calls.items():
      finite = torch.isfinite(call(bad)).flatten(1).all(dim=1).tolist()
      chip_smoke.log(f'K1 {name} non-PD middle task of three: tasks finite '
                     f'{finite}')
      if finite != [True, False, True]:
        raise AssertionError(f'K1 {name}: NaN must mark the non-PD task only')

    kb = torch.from_numpy(chip_smoke.spd_batch(
        rng, chip_smoke.TASKS, chip_smoke.BATCH)).to(dev)
    first = batch_chol.batched_linv_t(kb)
    second = batch_chol.batched_linv_t(kb)
    same = torch.equal(first, second)
    chip_smoke.log(f'K1 (T={chip_smoke.TASKS}, n={chip_smoke.BATCH}): two '
                   f'calls bitwise equal {same}; digest '
                   f'{chip_smoke.digest(first)}')
    if not same:
      raise AssertionError('K1: two calls differ')

    work = {name: (lambda call=call: call(kb)) for name, call in
            calls.items()}
    per_call = chip_smoke._turns(chip_smoke.TIMED_RUNS, **work)
    device = chip_smoke.device_turns(TURN_RUNS, **work)
    for name, fn in work.items():
      ms, spans = device[name]
      chip_smoke.log(
          f'K1 {name} (T={chip_smoke.TASKS}, n={chip_smoke.BATCH}): device '
          f'time {ms:.4f} ms (median of {spans} measured of {2 * TURN_RUNS} '
          f'spans of {chip_smoke.BACK_TO_BACK} calls back to back), per-call '
          'time '
          f'{per_call[name]:.4f} ms (median of {2 * chip_smoke.TIMED_RUNS}, '
          f'one call a pair of events), in turns [{card}]')
      prof = probe_timing.profiled_ms(fn)
      chip_smoke.log(f'  torch.profiler, {name}: ' + '; '.join(
          f'{k[:60]} {v:.4f} ms a call' for k, v in prof.items()))
    split_launch(tmp, kb, device['kernel'][0])


if __name__ == '__main__':
  main()
