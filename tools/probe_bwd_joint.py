"""Probe of kernel K8 (hyperbo_tpu_torch/csrc/bwd_joint.cu) alone on one CUDA
card.

    python3 tools/probe_bwd_joint.py

Builds K3, K4 and K8 and prints nvcc's register, spill and shared-memory
report for K8 and its cooperative grid (blocks, blocks a multiprocessor,
registers a thread, local and static shared bytes). On chip_smoke.py's
n = 8192 input (SE, d = 8; the float32 rounding of the float64 factor)
it holds K8 against K3 + alpha + K4 (max rel 5e-3 per output), checks
that K8's T is bitwise K3's and that two calls are bitwise equal, and
times K8, K3 + alpha + K4, K3 alone and K4 alone (medians of CUDA-event
timings, in turns). Then it builds K8 once more with -DHYPERBO_JOINT_LAPS
into a temporary directory (deleted after the run) and splits one launch
by phase from the clock64() stamps of thread 0 of each block (and shows
on which multiprocessor each block ran): level 0,
each level's W and T phases, u, alpha, the SYRK pairs and the reductions,
each phase's span (median over the blocks, from barrier to barrier) and
the share of it the blocks spent waiting at its barrier. With the card's
name and power limit.
"""

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
from hyperbo_tpu_torch.ops import bwd_joint
from hyperbo_tpu_torch.ops import mll_bwd
from hyperbo_tpu_torch.ops import tri_inv

N = 8192
LAP_SLOTS = 64  # csrc/bwd_joint.cu kLapSlots
INFO = ('grid blocks', 'blocks a multiprocessor', 'multiprocessors',
        'registers a thread', 'local (spill) bytes a thread',
        'static shared bytes a block')


def check(err, what):
  if err != 0:
    raise RuntimeError(f'{what} failed: CUDA error {err}')


def phase_names(n):
  levels = len(tri_inv.merges(n // bwd_joint.TILE))
  return (['level 0'] +
          [f'level {k} {p}' for k in range(1, levels + 1) for p in 'WT'] +
          ['u', 'alpha', 'SYRK', 'reductions'])


def build_with_laps(tmp):
  """K8 built with -DHYPERBO_JOINT_LAPS into tmp, loaded."""
  lib_path = os.path.join(tmp, 'libbwd_joint_laps.so')
  proc = subprocess.run(
      [_build.find_nvcc(), *_build.NVCC_FLAGS, '-DHYPERBO_JOINT_LAPS', '-o',
       lib_path, bwd_joint.KERNEL.source_path], capture_output=True,
      text=True)
  if proc.returncode != 0:
    raise RuntimeError(f'nvcc failed:\n{proc.stdout}{proc.stderr}')
  for line in (proc.stdout + proc.stderr).splitlines():
    if 'registers' in line or 'spill' in line:
      chip_smoke.log(f'ptxas (laps build): {line.strip()}')
  lib = ctypes.CDLL(lib_path)
  lib.hyperbo_mll_bwd_joint_laps.argtypes = [ctypes.c_void_p]
  lib.hyperbo_mll_bwd_joint_laps.restype = ctypes.c_int
  fn = lib.hyperbo_mll_bwd_joint
  fn.argtypes = bwd_joint.KERNEL.argtypes
  fn.restype = ctypes.c_int
  return lib, fn


def split_by_phase(lib, fn, inputs):
  """One stamped launch: each phase's span and barrier wait, with the
  kernel's time from the same build."""
  l, x, y, sv, kfam = inputs
  lib.hyperbo_mll_bwd_joint_info.argtypes = [ctypes.c_void_p]
  lib.hyperbo_mll_bwd_joint_info.restype = ctypes.c_int
  info = (ctypes.c_int * len(INFO))()
  check(lib.hyperbo_mll_bwd_joint_info(info), 'laps build info')
  chip_smoke.log('K8 laps build grid: ' + ', '.join(
      f'{k} {v}' for k, v in zip(INFO, info)))
  grid = info[0]
  laps = torch.zeros((grid, LAP_SLOTS), dtype=torch.int64, device=l.device)
  check(lib.hyperbo_mll_bwd_joint_laps(laps.data_ptr()), 'laps symbol')
  real = bwd_joint.KERNEL._fn
  bwd_joint.KERNEL._fn = fn
  try:
    ms = chip_smoke._turns(
        chip_smoke.FUSED_TIMED_RUNS,
        laps=lambda: bwd_joint.launch_mll_bwd_joint(l, x, y, sv, kfam))
    laps.zero_()
    bwd_joint.launch_mll_bwd_joint(l, x, y, sv, kfam)
    torch.cuda.synchronize()
  finally:
    bwd_joint.KERNEL._fn = real
  s = laps.cpu().numpy().astype(np.int64)
  sm = s[:, -1]
  sms = info[2]
  chip_smoke.log(f'K8 placement: blocks 0-{sms - 1} on {len(set(sm[:sms]))} '
                 f'distinct multiprocessors; block b and block b + {sms} '
                 f'share one for {int((sm[:sms] == sm[sms:2 * sms]).sum())} '
                 f'of {min(sms, grid - sms)} b')
  names = phase_names(l.shape[0])
  total = np.median(s[:, 2 * len(names) - 1] - s[:, 0])
  ghz = total / (ms['laps'] * 1e6)
  chip_smoke.log(f'K8 n={l.shape[0]} by phase: {int(total)} cycles a block '
                 f'(median), the laps build {ms["laps"]:.3f} ms (wrapper) '
                 f'-> {ghz:.3f} GHz')
  for p, name in enumerate(names):
    end = 2 * p + 2 if p + 1 < len(names) else 2 * p + 1
    span = s[:, end] - s[:, 2 * p]
    busy = s[:, 2 * p + 1] - s[:, 2 * p]
    med = float(np.median(span))
    chip_smoke.log(
        f'  {name}: {med:.0f} cycles, {med / total:.1%}, '
        f'{med / ghz / 1e6:.3f} ms; waiting at the barrier '
        f'{1.0 - busy.mean() / span.mean():.1%} of the blocks\' time '
        f'(busiest block {busy.max():.0f} cycles)')


def main():
  card = chip_smoke.phase_device()
  dev = torch.device('cuda', 0)
  chip_smoke.phase_build([tri_inv.KERNEL, mll_bwd.KERNEL, bwd_joint.KERNEL])
  for line in bwd_joint.KERNEL.build_log.splitlines():
    if 'registers' in line or 'spill' in line or 'smem' in line:
      chip_smoke.log(f'ptxas: {line.strip()}')
  lib = ctypes.CDLL(bwd_joint.KERNEL.library_path())
  lib.hyperbo_mll_bwd_joint_info.argtypes = [ctypes.c_void_p]
  lib.hyperbo_mll_bwd_joint_info.restype = ctypes.c_int
  info = (ctypes.c_int * len(INFO))()
  check(lib.hyperbo_mll_bwd_joint_info(info), 'hyperbo_mll_bwd_joint_info')
  chip_smoke.log('K8 cooperative grid: ' + ', '.join(
      f'{k} {v}' for k, v in zip(INFO, info)))

  ins32, ins64 = chip_smoke.fused_inputs(dev, N, chip_smoke.FUSED_DIM, 3)
  x, y, sv, _, _ = ins32
  l = chip_smoke.input_factor(ins64, 'se')[3]
  got, t_joint = bwd_joint._launch(l, x, y, sv, 'se', None)
  t = tri_inv.launch_tri_inv(l)
  route = chip_smoke.joint_route(l, x, y, sv, 'se')
  again = bwd_joint.launch_mll_bwd_joint(l, x, y, sv, 'se')
  torch.cuda.synchronize()
  rel = [chip_smoke._rel(a, b) for a, b in zip(got, route)]
  same_t = torch.equal(t_joint, t)
  same = all(torch.equal(a, b) for a, b in zip(got, again))
  chip_smoke.log(f'K8 n={N}: max rel vs K3 + alpha + K4 '
                 f'{" ".join(f"{v:.3e}" for v in rel)}; T bitwise K3\'s '
                 f'{same_t}; two calls bitwise equal {same}; K3 digest '
                 f'{chip_smoke.digest(t)}')
  if not (max(rel) <= chip_smoke.GRAD_MAX_REL and same_t and same):
    raise AssertionError(f'K8: rel {rel}, T {same_t}, determinism {same}')

  alpha = tri_inv.alpha_from_inverse(t, y).contiguous()
  ms = chip_smoke._turns(
      chip_smoke.FUSED_TIMED_RUNS,
      kernel=lambda: bwd_joint.launch_mll_bwd_joint(l, x, y, sv, 'se'),
      route=lambda: chip_smoke.joint_route(l, x, y, sv, 'se'),
      k3=lambda: tri_inv.launch_tri_inv(l),
      k4=lambda: mll_bwd.launch_mll_bwd(t, x, alpha, sv, 'se'))
  chip_smoke.log(f'K8 n={N} (median of {2 * chip_smoke.FUSED_TIMED_RUNS} '
                 'each, in turns): ' +
                 ', '.join(f'{k} {v:.3f} ms' for k, v in ms.items()) +
                 f' [{card}]')

  os.makedirs(_build.BUILD_DIR, exist_ok=True)
  with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
    lap_lib, fn = build_with_laps(tmp)
    split_by_phase(lap_lib, fn, (l, x, y, sv, 'se'))


if __name__ == '__main__':
  main()
