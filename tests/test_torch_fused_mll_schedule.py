"""The schedule of kernel K2 (hyperbo_tpu_torch/csrc/fused_mll.cu), settled on
the CPU: `fused_schedule`, the parts each block of the persistent launch runs
with the counters they wait on and set, and `mll_fused_steps`, its float64
mirror of the Gram tiles, diagonal factors, panel solves, 128-deep trailing
updates, lookahead and the forward solve's partials, held to the plain
version `mll_fused_plain`.

Imports no JAX: the oracle is the port's float64 plain version (LAPACK's
Cholesky and triangular solve). Tolerance: 1e-10, absolute for L and
relative for quad and logdet_half (float64 sums in another order).
"""

import collections
import random

import numpy as np
import pytest
import torch

from hyperbo_tpu_torch.ops import fused_mll
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-10


def _problem(seed, n, masked, d=3, da=0.11):
  """float64 x, y, sv, da and valid (None unmasked; else the last 40 rows
  padded, zero as the route makes them)."""
  rng = np.random.default_rng(seed)
  x = torch.from_numpy(rng.uniform(size=(n, d)) * 2.0)
  y = torch.from_numpy(rng.normal(size=(n, 1)))
  valid = None
  if masked:
    valid = (torch.arange(n) < n - 40).double()
    x = x * valid[:, None]
    y = y * valid[:, None]
  return (x, y, torch.tensor(1.3, dtype=torch.float64),
          torch.tensor(da, dtype=torch.float64), valid)


@pytest.mark.parametrize('n,kfam,masked', [(64, 'se', False),
                                           (512, 'se', False),
                                           (704, 'matern32', True),
                                           (1216, 'matern52', True)])
def test_mirror_matches_plain(n, kfam, masked):
  """One 64-wide tile (n = 64), four 128-wide steps (512), and ragged
  masked n whose last tile row is 64 wide (704 = 11 x 64, 1216 = 19 x 64,
  with trailing updates of a 64-row tile): L, quad and logdet_half within
  1e-10, the upper triangle exactly 0. On a grid of three blocks the mirror
  gives the same bits: each entry is one sum in a fixed order."""
  x, y, sv, da, valid = _problem(n, n, masked)
  l, quad, ld = fused_mll.mll_fused_steps(x, y, sv, da, kfam, valid)
  l64, quad64, ld64 = fused_mll.mll_fused_plain(x, y, sv, da, kfam, valid)
  assert l.dtype == torch.float64
  assert torch.equal(torch.triu(l, 1), torch.zeros_like(l))
  assert float((l - l64).abs().max()) <= TOL
  assert abs(float(quad - quad64)) <= TOL * abs(float(quad64))
  assert abs(float(ld - ld64)) <= TOL * abs(float(ld64))
  small = fused_mll.mll_fused_steps(x, y, sv, da, kfam, valid, blocks=3)
  assert all(torch.equal(a, b) for a, b in zip(small, (l, quad, ld)))


def test_non_pd_gives_nan():
  """A negative diagonal add: the mirror's factor is not finite, and the
  wrapper's _poison_non_pd turns factor and value into NaN."""
  x, y, sv, _, _ = _problem(3, 576, False)
  da = torch.tensor(-0.5, dtype=torch.float64)
  l, quad, ld = fused_mll.mll_fused_steps(x, y, sv, da)
  assert not torch.isfinite(l).all()
  # pylint: disable-next=protected-access
  chol, nll = fused_mll._poison_non_pd(l, 0.5 * quad + ld)
  assert torch.isnan(chol).all() and torch.isnan(nll)


def _run(schedule, ns, rng):
  """Runs the blocks' parts in a random interleaving that the counters
  allow: a part reads when its waits are met and writes at some later
  move, other blocks' moves in between; a worker may read its next update
  before it writes the current one, as the kernel loads the next update's
  first chunk once its counters are met. A block keeps the turn with
  probability 0.9, so that some run far ahead of others. Checks every read
  and write against the tiles' versions (the steps' updates each holds,
  j + 1 once final) and that the published panels, z_k and the partials
  L_ik z_k are written once and before they are read."""
  ver = collections.Counter()
  counts = collections.Counter()
  panels, zs, partials = set(), set(), collections.Counter()
  local = {}
  pos = [0] * len(schedule)
  loaded = [set() for _ in schedule]
  last = 0
  updates = ('update', 'update2')

  def read(w):
    i, j, k = w.i, w.j, w.k
    if w.op == 'load':
      assert ver[0, 0] == 0, w
    elif w.op == 'prefetch':
      assert ver[i, k] == k and ver[i, i] == k, w
      local['next'] = k
    elif w.op == 'factor':
      assert local['diag'] == k, w
      assert all(partials[k, m] == 1 for m in range(k)), w
    elif w.op == 'solve':
      assert k in panels and ver[i, k] == k, w
    elif w.op == 'update_held':
      assert ver[j, k] == k + 1 and k in zs and ver[i, j] == k, w
    elif w.op in ('update', 'update2'):
      for s in range(2 if w.op == 'update2' else 1):
        assert ver[i, k + s] == k + s + 1 and ver[j, k + s] == k + s + 1, w
      assert ver[i, j] == k, w

  def write(w):
    i, j, k = w.i, w.j, w.k
    if w.op == 'load':
      local['diag'] = 0
    elif w.op == 'factor':
      assert ver[k, k] == max(k - 1, 0), w  # untouched since the prefetch
      ver[k, k] = k + 1
      panels.add(k)
    elif w.op == 'solve_next' and i == ns:
      zs.add(k)
    elif w.op == 'lookahead':
      assert local['next'] == k and ver[i, k] == k, w
      local['diag'] = k + 1
      ver[i, k] = k + 1
      zs.add(k)
      partials[i, k] += 1
    elif w.op == 'solve':
      assert ver[i, k] == k, w
      ver[i, k] = k + 1
    elif w.op == 'update_held':
      assert ver[i, k] == k + 1 and ver[i, j] == k, w
      ver[i, j] = k + 1
      partials[i, k] += 1
    elif w.op in ('update', 'update2'):
      assert ver[i, j] == k, w
      ver[i, j] = k + (2 if w.op == 'update2' else 1)
    for c, v in w.sets:
      counts[c] = v

  def met(w):
    return all(counts[c] >= v for c, v in w.waits)

  while any(p < len(s) for p, s in zip(pos, schedule)):
    moves = []
    for blk, work in enumerate(schedule):
      p = pos[blk]
      if p == len(work):
        continue
      if p not in loaded[blk]:
        if met(work[p]):
          moves.append((blk, p, read))
        continue
      moves.append((blk, p, write))
      if (work[p].op in updates and p + 1 < len(work) and
          work[p + 1].op in updates and p + 1 not in loaded[blk] and
          met(work[p + 1])):
        moves.append((blk, p + 1, read))
    assert moves, 'the schedule deadlocks'
    mine = [m for m in moves if m[0] == last]
    blk, p, move = (mine[0] if mine and rng.random() < 0.9 else
                    rng.choice(moves))
    last = blk
    move(schedule[blk][p])
    if move is read:
      loaded[blk].add(p)
    else:
      pos[blk] += 1
  for i in range(ns):
    for j in range(i + 1):
      assert ver[i, j] == j + 1, (i, j)
  assert sorted(zs) == list(range(ns))
  assert all(partials[i, k] == 1 for i in range(ns) for k in range(i))
  assert sum(partials.values()) == ns * (ns - 1) // 2


def test_schedule_has_no_race():
  """In random interleavings of fused_schedule on grids of 2 to 132 blocks,
  even and ragged tile counts: no tile is read before every update it needs
  is written, updates land in step order, no tile is written after it is
  final, a panel, z_k or partial is read only once written, and no
  interleaving deadlocks. The chain takes no worker task and the workers
  no chain part."""
  rng = random.Random(0)
  chain_ops = {'load', 'prefetch', 'factor', 'solve_next', 'lookahead'}
  for n, blocks in ((64, 2), (704, 2), (704, 5), (1216, 7), (1216, 132),
                    (2048, 132), (2048, 9)):
    ns = -(-n // fused_mll.SUPER)
    schedule = fused_mll.fused_schedule(n, blocks)
    assert len(schedule) == blocks
    for blk, work in enumerate(schedule):
      assert all((w.op in chain_ops) == (blk == 0) for w in work)
    for _ in range(2):
      _run(schedule, ns, rng)


def test_every_tile_and_partial_is_final_once():
  """Across the schedule, each lower tile of L is made final by exactly one
  part (its factor or its solve's release), each partial L_ik z_k (i > k)
  comes from exactly one part, and every part that sets a counter names a
  lower tile; the Gram launch's zeros above the 64 x 64 diagonal tiles are
  what the mirror returns there."""
  for n in (512, 704, 5056):
    ns = -(-n // fused_mll.SUPER)
    final = collections.Counter()
    partials = collections.Counter()
    for work in fused_mll.fused_schedule(n, 132):
      for w in work:
        for (i, j), v in w.sets:
          assert 0 <= j <= i < ns, w
          if v == j + 1:
            final[i, j] += 1
        if w.op == 'lookahead':
          partials[w.i, w.k] += 1
        elif w.op == 'update_held':
          partials[w.i, w.k] += 1
    lower = [(i, j) for i in range(ns) for j in range(i + 1)]
    assert sorted(final) == lower and set(final.values()) == {1}
    assert sorted(partials) == [(i, k) for i, k in lower if k < i]
    assert set(partials.values()) == {1}
  x, y, sv, da, valid = _problem(7, 704, True)
  l, _, _ = fused_mll.mll_fused_steps(x, y, sv, da, 'se', valid)
  assert torch.equal(torch.triu(l, 1), torch.zeros_like(l))
  assert torch.isfinite(l).all()
