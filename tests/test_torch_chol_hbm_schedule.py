"""The schedule of kernel K6 (hyperbo_tpu_torch/csrc/chol_hbm.cu), settled on
the CPU: `hbm_schedule`, the parts each block of the persistent grid runs
with the counters they wait on and set, and `cholesky_hbm_steps`, its
float64 mirror of the kernel's load, diagonal factors, panel solves,
trailing updates and lookahead, held to torch.linalg.cholesky.

Imports no JAX: the mirror's oracle is float64 LAPACK. Tolerance: 1e-12 of
the factor's largest entry (float64 sums in another order).
"""

import collections
import random

import numpy as np
import pytest
import torch

from hyperbo_tpu_torch.ops import chol_hbm
from hyperbo_tpu_torch.ops.chol import poison_non_pd
from torch_threads import one_torch_thread  # noqa: F401


def _spd(seed, t, n):
  a = np.random.default_rng(seed).normal(size=(t, n, n))
  return torch.from_numpy(a @ np.swapaxes(a, -1, -2) / n + 2.0 * np.eye(n))


def _assert_matches_cholesky(got, a):
  want = torch.linalg.cholesky(a)
  assert got.dtype == torch.float64
  assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
  err = float((got - want).abs().max() / want.abs().max())
  assert err <= 1e-12, err


@pytest.mark.parametrize('n', [64, 128, 576, 1024, 1536])
def test_mirror_matches_cholesky(n):
  """One diagonal factor (64), two block columns, n not a multiple of 512
  (576), the route's 1024 and 24 block columns; NaN above the diagonal of
  the input never reaches the factor: only the lower triangle is read."""
  a = _spd(n, 1, n)
  upper = torch.triu(torch.full((n, n), float('nan'), dtype=a.dtype), 1)
  _assert_matches_cholesky(chol_hbm.cholesky_hbm_steps(a + upper), a)


def test_mirror_on_a_batch_and_a_non_pd_matrix():
  """A batch of two matrices side by side, and in rounds on a grid of three
  blocks (one chain); every tile's sums are in the same order, so the two
  schedules give the same bits. A negative pivot in the last block column
  of the middle matrix of three: its factor is not finite and, after the
  wrapper's poison, all NaN; the others are untouched."""
  a = _spd(2, 2, 256)
  got = chol_hbm.cholesky_hbm_steps(a)
  _assert_matches_cholesky(got, a)
  assert torch.equal(chol_hbm.cholesky_hbm_steps(a, blocks=3), got)
  bad = _spd(3, 3, 192)
  bad[1, -1, -1] = -5.0
  got = chol_hbm.cholesky_hbm_steps(bad, blocks=5)
  assert not torch.isfinite(got[1]).all()
  poisoned = poison_non_pd(got)
  assert torch.isnan(poisoned[1]).all()
  _assert_matches_cholesky(poisoned[[0, 2]], bad[[0, 2]])


def _run(schedule, nb, batch, chains, rng):
  """Runs the blocks' parts in a random interleaving that the counters
  allow. A part reads its tiles when its waits are met and writes after;
  a worker may read its next task's tiles before writing its current one,
  as the kernel's double buffering does. Checks every read and write
  against the tiles' versions (the updates each holds, j + 1 once final)."""
  ver = collections.Counter()    # tile (b, i, j) as it stands in memory
  local = collections.defaultdict(dict)  # a chain's tiles in shared memory
  held = {}  # a worker's solved tile in shared memory
  counts = collections.Counter()
  pos = [0] * len(schedule)
  loaded = [set() for _ in schedule]

  def met(w):
    return all(counts[c] >= v for c, v in w.waits)

  def read(w):
    b, i, j, k = w.b, w.i, w.j, w.k
    if w.op == 'prefetch':
      assert all(ver[c] == k for c, _ in w.waits), w
      local[b]['below'] = local[b]['next'] = k
    elif w.op == 'solve':
      assert ver[b, k, k] == k + 1 and ver[b, i, k] == k, w
    elif w.op == 'update_held':
      assert held[b, i, k] and ver[b, k + 1, k] == k + 1, w
      assert ver[b, i, j] == k, w
    elif w.op == 'update':
      assert ver[b, i, k] == k + 1 and ver[b, j, k] == k + 1, w
      assert ver[b, i, j] == k, w

  def write(w):
    b, i, j, k = w.b, w.i, w.j, w.k
    if w.op == 'load':
      local[b]['diag'] = 0
    elif w.op == 'prefetch':
      pass  # a read only
    elif w.op == 'factor':
      assert local[b]['diag'] == k and ver[b, k, k] == max(k - 1, 0), w
      ver[b, k, k] = k + 1
    elif w.op == 'solve_next':
      assert local[b]['below'] == k, w
    elif w.op == 'lookahead':
      assert local[b]['next'] == k, w
      local[b]['diag'] = k + 1
      for c, v in w.sets:  # the solved tiles: no update after the load
        assert ver[c] == k, w
        ver[c] = v
    elif w.op == 'solve':  # held in shared memory until update_held
      held[b, i, k] = True
    elif w.op in ('update', 'update_held'):
      for c, v in w.sets:
        assert ver[c] == k <= c[2], w  # never after the tile is final
        ver[c] = v
    else:
      assert w.op == 'zero' and i < j and ver[b, i, j] == 0, w
      ver[b, i, j] = -1
    for c, v in w.sets:
      counts[c] = v

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
      # The next task's tiles; a solve's held update is part of its task.
      nxt = p + 1 + (p + 1 < len(work) and work[p + 1].op == 'update_held')
      if (blk >= chains and work[p].op != 'update_held' and
          nxt < len(work) and nxt not in loaded[blk] and met(work[nxt])):
        moves.append((blk, nxt, read))
    assert moves, 'the schedule deadlocks'
    blk, p, move = rng.choice(moves)
    move(schedule[blk][p])
    if move is read:
      loaded[blk].add(p)
    else:
      pos[blk] += 1
  for b in range(batch):
    for i in range(nb):
      for j in range(nb):
        assert ver[b, i, j] == (j + 1 if j <= i else -1), (b, i, j)


def test_schedule_has_no_race():
  """In random interleavings of hbm_schedule on grids of 2 to 132 blocks
  (batches in rounds where chains are fewer than matrices): no tile is read
  before every update it needs is written, updates land in k order, no tile
  is written after it is factored, every upper tile is zeroed once, and no
  interleaving deadlocks. The chain takes no worker task and the workers no
  chain part."""
  rng = random.Random(0)
  for n, blocks, batch in ((64, 2, 1), (128, 2, 3), (576, 5, 2),
                           (640, 7, 3), (1024, 132, 1), (256, 132, 2)):
    nb = n // chol_hbm.TILE
    chains = min(batch, blocks // 2)
    schedule = chol_hbm.hbm_schedule(n, blocks, batch)
    assert len(schedule) == blocks
    chain_ops = {'load', 'prefetch', 'factor', 'solve_next', 'lookahead'}
    for blk, work in enumerate(schedule):
      assert all((w.op in chain_ops) == (blk < chains) for w in work)
    for _ in range(2):
      _run(schedule, nb, batch, chains, rng)
