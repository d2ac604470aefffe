"""The schedule of kernel K8 (hyperbo_tpu_torch/csrc/bwd_joint.cu), settled
on the CPU: `joint_schedule`, the phases of the persistent launch with the
tiles each work item reads and writes, and `mll_bwd_joint_steps`, its
float64 mirror, held to the plain version `mll_bwd_joint_plain`.

Imports no JAX: the oracle is the port's float64 plain chain (LAPACK's
triangular solve, then the dense products). Tolerance: 1e-10 of each
output's largest entry (float64 sums in another order, on factors of Grams
with a 0.5 diagonal add).
"""

import collections

import numpy as np
import pytest
import torch

from hyperbo_tpu_torch.ops import bwd_joint
from hyperbo_tpu_torch.ops import fused_mll
from hyperbo_tpu_torch.ops import tri_inv
from torch_threads import one_torch_thread  # noqa: F401

SV, DA = 1.3, 0.5
# Tile counts: one tile (no level), 5 (ragged), 8 (64 x 64 products only)
# and 19 (ragged, with 128 x 128 products at halves of 8 and 16 tiles).
SIZES = (64, 320, 512, 1216)


def _problem(seed, n, kfam, masked, d=3):
  """float64 x, delta, sv, valid (None unmasked) and the factor L of the
  (masked) Gram, padded rows zero as the route makes them."""
  rng = np.random.default_rng(seed)
  x = torch.from_numpy(rng.uniform(size=(n, d)))
  delta = torch.from_numpy(rng.normal(size=(n, 1)))
  valid = None
  if masked:
    valid = (torch.arange(n) < int(0.78 * n)).double()
    x = x * valid[:, None]
    delta = delta * valid[:, None]
  sv = torch.tensor(SV, dtype=torch.float64)
  chol, _, _ = fused_mll.mll_fused_plain(
      x, torch.zeros(n, 1, dtype=torch.float64), sv,
      torch.tensor(DA, dtype=torch.float64), kfam, valid)
  return x, delta, sv, valid, chol


@pytest.mark.parametrize('n,kfam,masked', [(64, 'se', False),
                                           (320, 'matern32', True),
                                           (512, 'se', True),
                                           (1216, 'matern52', True)])
def test_mirror_matches_plain(n, kfam, masked):
  """The items run in order give the plain chain's four adjoints; every
  buffer starts as NaN, so a read of an entry not yet written would show."""
  x, delta, sv, valid, l = _problem(n, n, kfam, masked)
  got = bwd_joint.mll_bwd_joint_steps(l, x, delta, sv, kfam, valid)
  want = bwd_joint.mll_bwd_joint_plain(l, x, delta, sv, kfam, valid)
  for g, w in zip(got, want):
    assert g.shape == w.shape
    err = float((g - w).abs().max() / w.abs().max())
    assert err <= 1e-10, err


def test_no_item_reads_a_tile_before_an_earlier_phase_wrote_it():
  """Each item reads only inputs and tiles written in earlier phases, and
  no tile is written twice in a phase or read in the phase that writes it:
  the grid-wide barrier between phases is the only order the kernel
  has."""
  for n in SIZES:
    written = set()
    for name, items in bwd_joint.joint_schedule(n):
      reads = set().union(*(it.reads for it in items))
      writes = [key for it in items for key in it.writes]
      assert len(writes) == len(set(writes)), (n, name)
      assert not reads & set(writes), (n, name)
      for it in items:
        early = {k for k in it.reads if k[0] not in bwd_joint.INPUTS}
        assert early <= written, (n, name, it.op, sorted(early - written))
      written |= set(writes)
    nb = n // bwd_joint.TILE
    assert {('P', i) for i in range(nb)} | {('out',)} <= written


def test_every_tile_of_t_is_written_exactly_once():
  """Level 0 writes the diagonal tiles and the zeros above them; the
  levels' T products write each tile below the diagonal once, and the
  levels' products are those that tri_inv_levels, K3's mirror, runs."""
  for n in SIZES:
    nb = n // bwd_joint.TILE
    counts = collections.Counter(
        key for _, items in bwd_joint.joint_schedule(n) for it in items
        for key in it.writes if key[0] == 'T')
    assert counts == {('T', i, j): 1 for i in range(nb) for j in range(nb)}
    levels = tri_inv.level_products(nb)
    products = [it.arg for _, items in bwd_joint.joint_schedule(n)
                for it in items if it.op in ('w', 't')]
    assert sorted(products) == sorted(p for w, t in levels for p in w + t)


def test_w_regions_of_a_level_do_not_overlap():
  """Within a level every merge's W lies in its own stretch of the scratch
  (ops/tri_inv.scratch_floats floats), so a level's merges never overwrite
  each other's W; the scratch is reused from level to level, which the
  barrier after each level's T phase allows."""
  for n in SIZES + (5056, 8192):
    nb = n // bwd_joint.TILE
    size = tri_inv.scratch_floats(n)
    assert size <= n * n // 4
    for w_items, _ in tri_inv.level_products(nb):
      spans = {}
      for p in w_items:
        a0, c0, c1 = (v * bwd_joint.TILE for v in p.merge)
        spans[p.z] = (p.w_base, p.w_base + (c1 - c0) * (c0 - a0))
        assert p.rows[1] <= c1 - c0 and p.cols[1] <= c0 - a0
      ordered = sorted(spans.values())
      assert ordered[-1][1] <= size
      assert all(a[1] <= b[0] for a, b in zip(ordered, ordered[1:]))
