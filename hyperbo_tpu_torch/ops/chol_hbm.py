"""Blocked Cholesky of dense SPD matrices, kernel K6 (port of
hyperbo_tpu/ops/pallas_chol_hbm.py).

`ops/chol.py` routes a factorization here when `set_use_hbm_kernel(True)`
is set and n >= 1024 with n % 512 == 0. Only the lower triangle of the
input is read, as LAPACK's potrf reads it.

`cholesky_hbm` dispatches on the tensor's device: a CUDA tensor goes
through the hand-written Hopper kernel (csrc/chol_hbm.cu) or raises; a CPU
tensor goes through the plain PyTorch version `cholesky_hbm_plain`. There
is no fallback from one to the other. The kernel is one persistent
cooperative launch a call, whatever the batch. It factors right-looking in
64-wide block columns: for each matrix one chain block factors the diagonal
tiles (K7's diagonal factor, csrc/chol_diag64.cuh), solves the tile below
each and updates the next diagonal tile ahead of the rest (lookahead),
while every other block solves the panel's other tiles and runs the
trailing updates from a fixed list, ordered by per-tile counters in global
memory. `hbm_schedule` is that list and `cholesky_hbm_steps` its float64
mirror, which only the tests run. Its time is the chain of n / 64 diagonal
factors, far above its bound of n^3/3 operations and 8 n^2 bytes. A
thread-block cluster a matrix, as K7 has, does not fit: n = 1024 is 16 block
columns, more than the portable cluster of 8, and one block column (256 KB)
is more than a block's shared memory.

The JAX module's `cholesky_hbm_halves`, `cholesky_hbm_wide` and
`cholesky_hbm_halfwide` compute the same factor with other VMEM layouts;
here they are aliases of `cholesky_hbm` that check the same shape
conditions. Their Mosaic probe `mode`s, the `wstore` layout and the bf16
product emulation (`_pdot`, `_dekker_split`) have no counterpart. The
block, chunk, half and tw sizes only gate the shapes taken: the kernel's
own tile is 64.

A matrix that is not positive definite comes out NaN (the TPU kernel
clamps the pivot and returns finite garbage instead).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from hyperbo_tpu_torch.ops import _build
from hyperbo_tpu_torch.ops.chol import plain_cholesky, poison_non_pd
from hyperbo_tpu_torch.ops.chol_panel import factor_block_column, solve_rows

TILE = 64
PANEL = TILE * TILE + TILE  # a step's published L_kk^T and 1 / sqrt(pivots)

KERNEL = _build.CudaKernel(
    'chol_hbm.cu', 'hyperbo_chol_hbm',
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

# One part of the kernel's schedule, run by one block: `op` on tile (i, j)
# of matrix b at step k, after every counter in `waits` ((b, i, j), value)
# has reached its value; it then sets the counters in `sets`.
Work = collections.namedtuple('Work', 'op b i j k waits sets')


def cholesky_hbm_plain(a: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch factor of the symmetric matrix that A's lower triangle
  defines (any device, float32 or float64); NaN where not positive
  definite."""
  return plain_cholesky(torch.tril(a) + torch.tril(a, -1).transpose(-1, -2))


def _chain_work(b: int, nb: int) -> list:
  """The chain block's parts for matrix b: the first diagonal tile from A,
  then for each step k the loads of tiles (k + 1, k), (k + 2, k) and
  (k + 1, k + 1) (warps 4-7, beside the factor), the factor of (k, k),
  the solve of the tiles below it (warps 0-3, beside the release of (k, k)
  by warps 4-7), and the lookahead update of (k + 1, k + 1) in shared
  memory (warps 0-3) beside the stores and releases of the solved tiles
  (warps 4-7)."""
  work = [Work('load', b, 0, 0, 0, (), ())]
  for k in range(nb):
    below = range(k + 1, min(k + 3, nb))
    if below:
      work.append(Work('prefetch', b, k + 1, k, k,
                       tuple(((b, i, k), k) for i in below) +
                       (((b, k + 1, k + 1), k),), ()))
    work.append(Work('factor', b, k, k, k, (), (((b, k, k), k + 1),)))
    if below:
      work.append(Work('solve_next', b, k + 1, k, k, (), ()))
      work.append(Work('lookahead', b, k + 1, k + 1, k, (),
                       tuple(((b, i, k), k + 1) for i in below)))
  return work


def _phase_work(nb: int, first: int, mats: int, p: int) -> list:
  """The workers' tasks of phase p (as the kernel's `decode` numbers them),
  each the list of its parts:
  2 k the panel solves of step k by row from k + 3 (the chain solves the
  two above), each followed by the update of (i, k + 1) in the same block;
  2 k + 1 the rest of its trailing update in column-major order from block
  column k + 1, without the chain's tile (k + 1, k + 1); 2 (nb - 1) the
  upper tiles by column, then row. The matrices of a round side by side."""
  if p == 2 * (nb - 1):
    tiles = [('zero', i, j, 0) for j in range(1, nb) for i in range(j)]
  elif p % 2 == 0:
    k = p // 2
    tiles = [('solve', i, k, k) for i in range(k + 3, nb)]
  else:
    k = p // 2
    m = nb - 1 - k
    tiles = [('update', k + 1 + r, k + 1 + c, k) for c in range(m)
             for r in range(c, m) if (r, c) != (0, 0) and (c or r < 2)]
  tasks = []
  for op, i, j, k in tiles:
    for b in range(first, first + mats):
      if op == 'solve':
        # The solve holds L_ik until (i, k + 1) has taken its product.
        tasks.append([
            Work('solve', b, i, k, k, (((b, k, k), k + 1), ((b, i, k), k)),
                 ()),
            Work('update_held', b, i, k + 1, k,
                 (((b, k + 1, k), k + 1), ((b, i, k + 1), k)),
                 (((b, i, k), k + 1), ((b, i, k + 1), k + 1)))])
      elif op == 'update':
        tasks.append([Work(op, b, i, j, k,
                           (((b, i, k), k + 1), ((b, j, k), k + 1),
                            ((b, i, j), k)), (((b, i, j), k + 1),))])
      else:
        tasks.append([Work(op, b, i, j, k, (), ())])
  return tasks


def hbm_schedule(n: int, blocks: int, batch: int = 1) -> list:
  """The kernel's schedule on a grid of `blocks` blocks: for each block the
  list of parts it runs, in order, each with the counters it waits on and
  the counters it sets. Blocks 0 .. chains - 1 (chains = min(batch,
  blocks // 2)) run the chains of matrices b, b + chains, ...; the other
  blocks, the workers, take each step's tasks round robin from worker 0,
  its solves first, round by round (a round is the next `chains`
  matrices)."""
  nb = n // TILE
  if n <= 0 or n % TILE or blocks < 2 or batch < 1:
    raise ValueError(f'hbm_schedule takes n a positive multiple of {TILE}, '
                     f'blocks >= 2, batch >= 1; got {n}, {blocks}, {batch}')
  chains = min(batch, blocks // 2)
  workers = blocks - chains
  schedule = [[] for _ in range(blocks)]
  for c in range(chains):
    for b in range(c, batch, chains):
      schedule[c] += _chain_work(b, nb)
  off = 0
  for first in range(0, batch, chains):
    mats = min(chains, batch - first)
    for p in range(2 * nb - 1):
      if p % 2 == 0:
        off = 0  # each step, and the upper tiles, start at worker 0
      tasks = _phase_work(nb, first, mats, p)
      for t, task in enumerate(tasks):
        schedule[chains + (off + t) % workers] += task
      off = (off + len(tasks)) % workers
  return schedule


def cholesky_hbm_steps(a: torch.Tensor, blocks: int = 132) -> torch.Tensor:
  """Plain mirror of the kernel's algorithm (tests run it in float64): the
  factor of the symmetric matrix that A's lower triangle defines, by
  `hbm_schedule`'s parts, run block by block as their counters allow. A
  diagonal factor is `factor_block_column` of the 64 x 64 tile, a panel
  solve `solve_rows` against L_kk and its pivots, an update one 64-deep
  product subtracted; a tile's first update reads A, a diagonal tile its
  lower triangle only. NaN (or inf) where not positive definite, as the
  kernel gives before the wrapper's poison."""
  n = a.shape[-1]
  shape = a.shape
  a = a.reshape(-1, n, n)
  out = torch.zeros_like(a)
  t = TILE

  def tile(m, b, i, j):
    return m[b, i * t:(i + 1) * t, j * t:(j + 1) * t]

  def source(b, i, j, version):
    if version:
      return tile(out, b, i, j).clone()
    src = tile(a, b, i, j)
    return torch.tril(src) if i == j else src.clone()

  local = collections.defaultdict(dict)
  pivots = {}
  schedule = hbm_schedule(n, blocks, a.shape[0])
  counts = collections.Counter()
  done = [0] * len(schedule)
  while any(d < len(w) for d, w in zip(done, schedule)):
    moved = False
    for blk, work in enumerate(schedule):
      while done[blk] < len(work) and all(
          counts[c] >= v for c, v in work[done[blk]].waits):
        w = work[done[blk]]
        b, i, j, k = w.b, w.i, w.j, w.k
        own = local[b]
        if w.op == 'load':
          own['diag'] = source(b, 0, 0, 0)
        elif w.op == 'prefetch':
          own['below'] = torch.cat([source(b, r, k, k) for (_, r, _), _ in
                                    w.waits[:-1]])
          own['next'] = source(b, i, i, k)
        elif w.op == 'factor':
          pivots[b, k] = factor_block_column(own['diag'])
          tile(out, b, k, k).copy_(torch.tril(own['diag']))
        elif w.op == 'solve_next':
          solve_rows(own['below'], tile(out, b, k, k), pivots[b, k])
        elif w.op == 'lookahead':
          first = own['below'][:t]
          own['next'] -= first @ first.T
          own['diag'] = own['next']
          for r in range(own['below'].shape[0] // t):
            tile(out, b, k + 1 + r, k).copy_(own['below'][r * t:(r + 1) * t])
        elif w.op == 'solve':
          x = source(b, i, j, k)
          solve_rows(x, tile(out, b, k, k), pivots[b, k])
          tile(out, b, i, j).copy_(x)
        elif w.op in ('update', 'update_held'):
          target = source(b, i, j, k)
          target -= tile(out, b, i, k) @ tile(out, b, j, k).T
          tile(out, b, i, j).copy_(target)
        else:
          tile(out, b, i, j).zero_()
        for c, v in w.sets:
          counts[c] = v
        done[blk] += 1
        moved = True
    if not moved:
      raise RuntimeError('hbm_schedule deadlocks')
  return out.reshape(shape)


def launch_chol_hbm(a: torch.Tensor) -> torch.Tensor:
  """Run the Hopper kernel on a contiguous float32 CUDA batch (..., n, n),
  n a multiple of 64: one cooperative launch, with the counters (zeroed
  here) and the published panels as scratch."""
  _build.check_cuda_f32('launch_chol_hbm', a=a)
  n = a.shape[-1]
  if a.ndim < 2 or a.shape[-2] != n or n == 0 or n % TILE:
    raise ValueError(f'launch_chol_hbm takes (..., n, n) with n a multiple '
                     f'of {TILE}, got {tuple(a.shape)}')
  out = torch.empty_like(a)
  batch = a.numel() // (n * n)
  if batch == 0:
    return out
  nb = n // TILE
  panel = torch.empty((batch, nb, PANEL), dtype=torch.float32,
                      device=a.device)
  counts = torch.zeros((batch, nb, nb), dtype=torch.int32, device=a.device)
  with torch.cuda.device(a.device):
    stream = torch.cuda.current_stream(a.device).cuda_stream
    KERNEL.launch(a.data_ptr(), out.data_ptr(), panel.data_ptr(),
                  counts.data_ptr(), n, batch, stream)
  return poison_non_pd(out)


def _factor(name: str, a: torch.Tensor, ok: bool, **sizes) -> torch.Tensor:
  """Raise unless the shape conditions `ok` hold and n is a multiple of the
  kernel's tile (on either device, so that both take the same shapes);
  then the kernel (CUDA) or the plain version (CPU)."""
  n = a.shape[-1]
  if not (ok and n > 0 and n % TILE == 0):
    raise ValueError(f'{name} does not take n={n} with {sizes} (n must '
                     f'also be a positive multiple of {TILE})')
  if a.device.type == 'cuda':
    return launch_chol_hbm(a)
  if a.device.type == 'cpu':
    return cholesky_hbm_plain(a)
  raise ValueError(f'{name} runs on cpu or cuda, got {a.device}')


def cholesky_hbm(a: torch.Tensor, block: int = 256,
                 chunk: int = 512) -> torch.Tensor:
  """Lower Cholesky factor of SPD matrices (..., n, n); n % block == 0 and
  n % min(chunk, n) == 0, as the JAX kernel asserts."""
  n = a.shape[-1]
  chunk = min(chunk, n)
  return _factor('cholesky_hbm', a, n % block == 0 and n % chunk == 0,
                 block=block, chunk=chunk)


def cholesky_hbm_halves(a: torch.Tensor, block: int = 256,
                        chunk: int = 2048, half: int = 4096) -> torch.Tensor:
  """`cholesky_hbm` under the half-panel variant's shape conditions."""
  n = a.shape[-1]
  half = min(half, n)
  chunk = min(chunk, half)
  return _factor('cholesky_hbm_halves', a,
                 n % block == 0 and n % half == 0 and half % chunk == 0,
                 block=block, chunk=chunk, half=half)


def cholesky_hbm_wide(a: torch.Tensor, block: int = 256, chunk: int = 512,
                      tw: int = 512) -> torch.Tensor:
  """`cholesky_hbm` under the wide-strip variant's shape conditions."""
  n = a.shape[-1]
  chunk = min(chunk, n)
  return _factor('cholesky_hbm_wide', a,
                 n % block == 0 and n % chunk == 0 and tw % block == 0 and
                 n % tw == 0, block=block, chunk=chunk, tw=tw)


def cholesky_hbm_halfwide(a: torch.Tensor, block: int = 256,
                          chunk: int = 512, tw: int = 1024,
                          half: int = 2048) -> torch.Tensor:
  """`cholesky_hbm` under the half-panel, wide-strip variant's shape
  conditions."""
  n = a.shape[-1]
  half = min(half, n)
  chunk = min(chunk, half)
  tw = min(tw, n)
  return _factor('cholesky_hbm_halfwide', a,
                 n % block == 0 and n % half == 0 and half % chunk == 0 and
                 tw % block == 0 and n % tw == 0 and half % block == 0,
                 block=block, chunk=chunk, tw=tw, half=half)
