"""Probe of kernel K3 (hyperbo_tpu_torch/csrc/tri_inv.cu) alone on one
CUDA card.

    python3 tools/probe_tri_inv.py

Builds K3 and prints nvcc's register and spill report; holds T = L^{-1}
against the float64 plain version on chip_smoke.py's fused-path factors at
n = 512, 704 (700 rows, masked), 5056 (5000 rows, masked) and 8192 (max
|T - T64| / max |T64|, bound 5e-3); checks that two calls at n = 8192 are
bitwise equal; and times K3, its plain version and
torch.linalg.solve_triangular(L, I) at n = 8192 (medians of CUDA-event
timings, in turns) and the device time of each of its kernels in one call
(torch.profiler), with the card's name and power limit.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# pylint: disable=wrong-import-position,protected-access
import chip_smoke
from hyperbo_tpu_torch.ops import tri_inv


def main():
  card = chip_smoke.phase_device()
  dev = torch.device('cuda', 0)
  chip_smoke.phase_build([tri_inv.KERNEL])
  big = None
  for n, d, kfam, seed in ((512, 4, 'se', 1), (700, 3, 'matern32', 2),
                           (5000, chip_smoke.FUSED_DIM, 'se', 4),
                           (8192, chip_smoke.FUSED_DIM, 'se', 3)):
    _, ins64 = chip_smoke.fused_inputs(dev, n, d, seed)
    l_in = chip_smoke.input_factor(ins64, kfam)[3]
    t = tri_inv.launch_tri_inv(l_in)
    t64 = tri_inv.tri_inv_plain(l_in.double())
    torch.cuda.synchronize()
    rel = chip_smoke._rel(t, t64)
    upper = bool((torch.triu(t, 1) == 0).all())
    chip_smoke.log(f'K3 n={l_in.shape[0]} {kfam}: T max rel {rel:.3e}, '
                   f'abs {float((t.double() - t64).abs().max()):.3e}, '
                   f'upper triangle zero {upper}')
    if not (rel <= chip_smoke.GRAD_MAX_REL and upper):
      raise AssertionError(f'K3 at n={l_in.shape[0]}: {rel}, {upper}')
    big = l_in
  same = torch.equal(tri_inv.launch_tri_inv(big), tri_inv.launch_tri_inv(big))
  chip_smoke.log(f'K3 two calls at n=8192 bitwise equal: {same}')
  if not same:
    raise AssertionError('K3 is not deterministic')
  eye = torch.eye(big.shape[0], device=dev)
  ms = chip_smoke._turns(
      chip_smoke.FUSED_TIMED_RUNS, plain=lambda: tri_inv.tri_inv_plain(big),
      kernel=lambda: tri_inv.launch_tri_inv(big),
      library=lambda: torch.linalg.solve_triangular(big, eye, upper=False))
  chip_smoke.log(f'K3 time at n=8192 (median of '
                 f'{2 * chip_smoke.FUSED_TIMED_RUNS} each): ' +
                 ', '.join(f'{k} {v:.3f} ms' for k, v in ms.items()) +
                 f' [{card}]')
  # Device time by kernel of one call: the diagonal level, and the two
  # products of the 64 x 64 (lower) and 128 x 128 (upper) levels.
  calls = 5
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      tri_inv.launch_tri_inv(big)
    torch.cuda.synchronize()
  for event in prof.key_averages():
    device_us = getattr(event, 'device_time_total', 0.0)
    if device_us > 0:
      chip_smoke.log(f'K3 n=8192 per call: {device_us / calls / 1e3:.3f} ms '
                     f'in {event.count // calls} launches of {event.key}')


if __name__ == '__main__':
  main()
