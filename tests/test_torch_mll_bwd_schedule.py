"""The schedule of kernel K4 (hyperbo_tpu_torch/csrc/mll_bwd.cu), settled on
the CPU: `mll_bwd_tasks`, its blocks in launch order (one lower pair of
128-wide tiles each) with the partial slots each writes, and
`mll_bwd_steps`, its float64 mirror of the pairs' chunked SYRK, epilogue
and partials and of the reductions' fixed order, held to the plain version
`mll_bwd_plain`.

Imports no JAX: the oracle is the port's float64 plain chain (LAPACK's
Cholesky and triangular solve, then the dense products), as strict as the
JAX kernel here (tests/test_torch_fused_mll_kernels.py holds the plain
version to the JAX kernel). Tolerance: 1e-10 of each output's largest
entry (float64 sums in another order).
"""

import collections

import numpy as np
import pytest
import torch

from hyperbo_tpu_torch.ops import fused_mll
from hyperbo_tpu_torch.ops import mll_bwd
from hyperbo_tpu_torch.ops import tri_inv
from torch_threads import one_torch_thread  # noqa: F401

SV, DA = 1.3, 0.5
# 64-wide tiles: 3 and 5 (odd: a 64-wide last pair tile), 8 (even); then
# the main path's ragged 5056 and its 8192.
SIZES = (64, 192, 320, 512, 5056, 8192)


def _problem(seed, n, kfam, masked, d=3):
  """float64 T = L^{-1} of the (masked) Gram, x, alpha = K^{-1} y, sv and
  valid (None unmasked), padded rows zero as the route makes them."""
  rng = np.random.default_rng(seed)
  x = torch.from_numpy(rng.uniform(size=(n, d)))
  y = torch.from_numpy(rng.normal(size=(n, 1)))
  valid = None
  if masked:
    valid = (torch.arange(n) < int(0.78 * n)).double()
    x = x * valid[:, None]
    y = y * valid[:, None]
  sv = torch.tensor(SV, dtype=torch.float64)
  chol, _, _ = fused_mll.mll_fused_plain(
      x, y, sv, torch.tensor(DA, dtype=torch.float64), kfam, valid)
  t = tri_inv.tri_inv_plain(chol)
  return t, x, tri_inv.alpha_from_inverse(t, y), sv, valid


@pytest.mark.parametrize('n,kfam,masked', [(192, 'se', False),
                                           (320, 'matern32', True),
                                           (512, 'matern52', False),
                                           (512, 'se', True)])
def test_mirror_matches_plain(n, kfam, masked):
  """The pairs run in order, then the reductions, give the plain version's
  P, d_sv_raw and d_da; the partials start as NaN, so a reduction reading
  a slot that no pair wrote would show."""
  t, x, alpha, sv, valid = _problem(n, n, kfam, masked)
  got = mll_bwd.mll_bwd_steps(t, x, alpha, sv, kfam, valid)
  want = mll_bwd.mll_bwd_plain(t, x, alpha, sv, kfam, valid)
  for g, w in zip(got, want):
    assert g.shape == w.shape
    err = float((g - w).abs().max() / w.abs().max())
    assert err <= 1e-10, err


def test_every_pair_once_heaviest_first():
  """Block b takes the lower pair with b = i (i + 1) / 2 + j, so every
  lower pair of 128-wide tiles comes exactly once; its chunks are the rows
  of T from 128 i to n, CHUNK at a time, and never grow along the launch."""
  for n in SIZES:
    ns = -(-n // mll_bwd.PAIR)
    tasks = mll_bwd.mll_bwd_tasks(n)
    assert [(p.i, p.j) for p in tasks] == [
        (i, j) for i in range(ns) for j in range(i + 1)]
    for b, p in enumerate(tasks):
      assert b == p.i * (p.i + 1) // 2 + p.j
      assert p.chunks * mll_bwd.CHUNK == n - mll_bwd.PAIR * p.i
    chunks = [p.chunks for p in tasks]
    assert chunks == sorted(chunks, reverse=True)
    assert chunks[-1] * mll_bwd.CHUNK == mll_bwd.tile_width(n, ns - 1)


def test_every_partial_slot_written_exactly_once():
  """Each (row tile, other tile) slot of p_part and each entry of s_part
  is written by exactly one pair, and together the pairs write all of
  them: the scratch the wrapper allocates, with nothing left over."""
  for n in SIZES:
    ns = -(-n // mll_bwd.PAIR)
    counts = collections.Counter(
        key for p in mll_bwd.mll_bwd_tasks(n) for key in p.writes)
    want = {('p_part', r, o): 1 for r in range(ns) for o in range(ns)}
    want.update({('s_part', q): 1 for q in range(ns * (ns + 1))})
    assert counts == want


def test_scalar_reduction_order():
  """The scalars' reduction in the kernel's order (a thread a strided run
  of pairs, then a halving tree) sums every partial once: on integers it
  is exact, at any count of pairs."""
  for pairs in (1, 3, 10, 255, 256, 257, 2080):
    parts = torch.arange(2 * pairs, dtype=torch.float64)
    # pylint: disable-next=protected-access
    out = mll_bwd._reduce_scalars(parts)
    assert out.tolist() == [float(parts[0::2].sum()),
                            float(parts[1::2].sum())]
