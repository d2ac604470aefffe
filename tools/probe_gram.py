"""Probe of kernel K5 (hyperbo_tpu_torch/csrc/gram.cu) alone on one CUDA
card.

    python3 tools/probe_gram.py [--parent DIR]

Builds K5 and prints nvcc's register, shared-memory and spill report. Holds
`launch_gram` against the float64 plain version (atol 2e-5 sv) at 70 x 70,
41 x 17 (d = 1), 1000 x 333 (d = 40, two feature chunks), 130 x 256 and
257 x 1028 (rows 16-byte aligned), the PD1 candidates' cross-Gram
10,000 x 2048 (d = 4) and the large-n Gram 8192 x 8192 (d = 8, the ridge
on), each for one of the three families; checks two calls at 8192 bitwise
equal, with their digest, and one launch a call. Then it times the kernel
at chip_smoke.py's two shapes in three ways: the device time (CUDA events
around chip_smoke.BACK_TO_BACK calls queued back to back, over their
count), the kernel's time in torch.profiler, and the per-call time (one
call between a pair of events, as chip_smoke.py times its phases), all in
turns; beside them, the device time of `fill_` on an output of the same
size, the rate a plain stream of stores reaches.

With --parent DIR (an unpacked earlier tree, e.g. `git archive` of the
parent under build/), it builds that tree's csrc/gram.cu from its own
source, holds it to the same float64 result, and times it in the same
turns: its per-call time through a copy of its wrapper (a (sv, ridge)
device tensor made from the Python numbers each call, as that wrapper did)
and its device time on a tensor made once. The parent's C entry point is
the one of the tree before the kernel's redesign:
hyperbo_gram(x1, x2, scalars, n1, n2, d, fam, add_ridge, out, stream).
With --same-abi DIR (repeatable), a tree whose gram.cu takes this tree's
entry point (a step of the redesign, or a trial: another tile or warp
height) is built, held to float64 and timed in the same turns. With the
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
from hyperbo_tpu_torch.ops import fused_gram
from hyperbo_tpu_torch.ops import mll_bwd

SV, RIDGE = 0.9, 0.05
# (n1, n2, d, family); the last two are chip_smoke.py's timed shapes.
CASES = ((70, 70, 4, 'matern32'), (41, 17, 1, 'matern52'),
         (1000, 333, 40, 'se'), (130, 256, 8, 'se'),
         (257, 1028, 8, 'matern52'), (10_000, 2048, 4, 'matern32'),
         (8192, 8192, 8, 'se'))
PARENT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p] * 2
TURN_RUNS = 5


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


def inputs(dev, n1, n2, d, seed):
  """x1 (n1, d) and x2 (n2, d) uniform on [0, 2)^d, centered as
  gram_with_ridge and cross_gram center them; x2 is x1 when n1 == n2."""
  rng = np.random.default_rng(seed)
  x1 = torch.tensor(rng.uniform(size=(n1, d)) * 2.0, device=dev)
  x2 = x1 if n1 == n2 else torch.tensor(rng.uniform(size=(n2, d)) * 2.0,
                                        device=dev)
  center = torch.cat([x1, x2]).mean(dim=0, keepdim=True)
  return (x1 - center).float().contiguous(), (x2 - center).float().contiguous()


class Parent:
  """The parent tree's K5, built from its own source, called as its
  wrapper called it."""

  def __init__(self, tmp, parent_dir):
    path = os.path.join(tmp, 'libgram_parent.so')
    report(nvcc(os.path.join(parent_dir, 'hyperbo_tpu_torch', 'csrc',
                             'gram.cu'), path), 'parent K5')
    self.fn = ctypes.CDLL(path).hyperbo_gram
    self.fn.argtypes = PARENT_ARGTYPES
    self.fn.restype = ctypes.c_int
    self.staged = {}

  def launch(self, x1, x2, scalars, kind, add_ridge):
    out = torch.empty((x1.shape[0], x2.shape[0]), dtype=torch.float32,
                      device=x1.device)
    err = self.fn(x1.data_ptr(), x2.data_ptr(), scalars.data_ptr(),
                  x1.shape[0], x2.shape[0], x1.shape[1],
                  mll_bwd.KFAM_CODE[kind], int(add_ridge), out.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
      raise RuntimeError(f'parent hyperbo_gram: CUDA error {err}')
    return out

  def call(self, x1, x2, sv, ridge, kind, add_ridge):
    """Its wrapper's work: the (sv, ridge) tensor from Python numbers."""
    scalars = torch.stack([
        torch.as_tensor(v, dtype=torch.float32, device=x1.device).reshape(())
        for v in (sv, ridge)])
    return self.launch(x1, x2, scalars, kind, add_ridge)

  def kernel(self, x1, x2, sv, ridge, kind, add_ridge):
    """The kernel alone: the (sv, ridge) tensor made once."""
    key = (sv, ridge)
    if key not in self.staged:
      self.staged[key] = torch.tensor([sv, ridge], dtype=torch.float32,
                                      device=x1.device)
    return self.launch(x1, x2, self.staged[key], kind, add_ridge)


def same_abi(tmp, tree):
  """The entry point of `tree`'s gram.cu, which takes this tree's
  arguments, held to float64 at 8192 x 8192 and 257 x 1028."""
  name = os.path.basename(os.path.normpath(tree))
  path = os.path.join(tmp, f'libgram_{name}.so')
  report(nvcc(os.path.join(tree, 'hyperbo_tpu_torch', 'csrc', 'gram.cu'),
              path), f'K5 {name}')
  fn = getattr(ctypes.CDLL(path), fused_gram.KERNEL.symbol)
  fn.argtypes = fused_gram.KERNEL.argtypes
  fn.restype = ctypes.c_int
  dev = torch.device('cuda', 0)
  for seed, (n1, n2) in enumerate(((8192, 8192), (257, 1028))):
    x1, x2 = inputs(dev, n1, n2, 8, 100 + seed)
    got = with_entry(fn, lambda: fused_gram.launch_gram(
        x1, x2, SV, RIDGE, 'matern52', n1 == n2))
    want = fused_gram.gram_plain(x1.double(), x2.double(), SV, RIDGE,
                                 'matern52', n1 == n2)
    err = float((got.double() - want).abs().max())
    chip_smoke.log(f'K5 {name} {n1} x {n2}: max abs err vs float64 '
                   f'{err:.3e}')
    if not err <= chip_smoke.GRAM_ATOL * SV:
      raise AssertionError(f'K5 {name} disagrees')
  return name, fn


def with_entry(fn, call):
  """call() with the kernel's entry point swapped for fn."""
  own = fused_gram.KERNEL.build()
  fused_gram.KERNEL._fn = fn  # pylint: disable=protected-access
  try:
    return call()
  finally:
    fused_gram.KERNEL._fn = own  # pylint: disable=protected-access


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument('--parent', help='an unpacked earlier tree whose K5 '
                      'is timed beside this one')
  parser.add_argument('--same-abi', action='append',
                      help='an unpacked tree whose gram.cu has this entry '
                      'point, built and timed beside this one (repeatable)')
  args = parser.parse_args()
  card = chip_smoke.phase_device()
  dev = torch.device('cuda', 0)
  chip_smoke.phase_build([fused_gram.KERNEL])
  report(fused_gram.KERNEL.build_log, 'K5')
  os.makedirs(_build.BUILD_DIR, exist_ok=True)
  with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
    parent = Parent(tmp, args.parent) if args.parent else None
    builds = dict(same_abi(tmp, tree) for tree in args.same_abi or ())
    for seed, (n1, n2, d, kind) in enumerate(CASES):
      x1, x2 = inputs(dev, n1, n2, d, seed)
      add = n1 == n2
      want = fused_gram.gram_plain(x1.double(), x2.double(), SV, RIDGE, kind,
                                   add)
      outs = {'kernel': lambda: fused_gram.launch_gram(x1, x2, SV, RIDGE,
                                                       kind, add)}
      if parent:
        outs['parent'] = lambda: parent.call(x1, x2, SV, RIDGE, kind, add)
      for name, call in outs.items():
        before = fused_gram.KERNEL.launches
        got = call()
        torch.cuda.synchronize()
        err = float((got.double() - want).abs().max())
        chip_smoke.log(f'K5 {name} {n1} x {n2} d={d} {kind}'
                       f'{" +ridge" if add else ""}: max abs err vs float64 '
                       f'{err:.3e} (bound {chip_smoke.GRAM_ATOL * SV:.1e})')
        if got.shape != want.shape or not err <= chip_smoke.GRAM_ATOL * SV:
          raise AssertionError(f'K5 {name} disagrees at {n1} x {n2}')
        if name == 'kernel' and fused_gram.KERNEL.launches != before + 1:
          raise AssertionError('K5: not one launch a call')
      del want

    x1, x2 = inputs(dev, 8192, 8192, 8, len(CASES))
    first = fused_gram.launch_gram(x1, x2, SV, RIDGE, 'se', True)
    second = fused_gram.launch_gram(x1, x2, SV, RIDGE, 'se', True)
    same = torch.equal(first, second)
    chip_smoke.log(f'K5 8192 x 8192: two calls bitwise equal {same}; digest '
                   f'{chip_smoke.digest(first)}')
    if not same:
      raise AssertionError('K5: two calls differ')
    del first, second

    dataset, candidates, _ = chip_smoke.make_data()
    xb = torch.tensor(chip_smoke.fused_data()['a'][0], device=dev) / 0.5
    xb = xb - xb.mean(dim=0, keepdim=True)
    c1 = torch.tensor(candidates[0], device=dev)
    c2 = torch.tensor(dataset['workload0'][0], device=dev)
    center = torch.cat([c1, c2]).mean(dim=0, keepdim=True)
    c1, c2 = c1 - center, c2 - center
    for what, a, b, add in (('gram_with_ridge', xb, xb, True),
                            ('cross_gram', c1, c2, False)):
      n1, n2, d = a.shape[0], b.shape[0], a.shape[1]
      work = {'kernel': lambda: fused_gram.launch_gram(a, b, SV, RIDGE, 'se',
                                                       add)}
      alone = dict(work)
      if parent:
        work['parent'] = lambda: parent.call(a, b, SV, RIDGE, 'se', add)
        alone['parent'] = lambda: parent.kernel(a, b, SV, RIDGE, 'se', add)
      for name, fn in builds.items():
        work[name] = alone[name] = (
            lambda fn=fn: with_entry(fn, lambda: fused_gram.launch_gram(
                a, b, SV, RIDGE, 'se', add)))
      buf = torch.empty((n1, n2), device=dev)
      alone['fill'] = lambda: buf.fill_(0.5)
      per_call = chip_smoke._turns(chip_smoke.DENSE_TIMED_RUNS, **work)
      device = chip_smoke.device_turns(TURN_RUNS, **alone)
      nbytes = 4 * (n1 * n2 + (n1 + n2) * d)
      bound = nbytes / chip_smoke.PEAK_BYTES * 1e3
      fill_ms, spans = device['fill']
      chip_smoke.log(f'fill_ of the same {n1} x {n2} float32: device time '
                     f'{fill_ms:.4f} ms ({spans} spans measured), the rate of '
                     f'a plain store stream ({4 * n1 * n2 / fill_ms / 1e6:.0f}'
                     ' GB/s)')
      for name in work:
        ms, spans = device[name]
        chip_smoke.log(
            f'K5 {name} {what} {n1} x {n2} d={d}: device time '
            f'{ms:.4f} ms ({bound / ms:.1%} of the {bound:.4f} ms bytes '
            f'bound; median of {spans} measured of {2 * TURN_RUNS} spans of '
            f'{chip_smoke.BACK_TO_BACK} calls back to back), '
            f'per-call time {per_call[name]:.4f} ms (median of '
            f'{2 * chip_smoke.DENSE_TIMED_RUNS}, one call a pair of events), '
            f'in turns [{card}]')
        prof = probe_timing.profiled_ms(alone[name])
        chip_smoke.log(f'  torch.profiler, {name}: ' + '; '.join(
            f'{k[:60]} {v:.4f} ms a call' for k, v in prof.items()))


if __name__ == '__main__':
  main()
