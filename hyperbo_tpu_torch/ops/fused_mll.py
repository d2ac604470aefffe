"""Fused GP marginal likelihood for large n, kernel K2 and its custom
backward (port of hyperbo_tpu/ops/pallas_mll.py: the route, the wrappers
and the differentiable core).

For scaled inputs x (n, d) and delta = y - mu (n, 1) the forward computes

    K = sv k(|x_i - x_j|^2) + da I,   L = chol(K),   z = L^{-1} delta,
    nll_core = |z|^2 / 2 + sum_j log L_jj

in one call (`mll_fused`), for the SE, Matern-3/2 and Matern-5/2 families.
The kernel (csrc/fused_mll.cu) is two launches: the Gram tiles, then one
persistent cooperative launch that factors right-looking in 128-wide steps.
A chain block factors each 128 x 128 diagonal tile, solves the tile below
it and updates the next diagonal tile ahead of the rest (lookahead), and
forms z and the float64 sums of |z|^2 and log L_jj on the way; every other
block solves the panel's other tiles and runs the 128- and 256-deep
trailing updates from a fixed list, ordered by per-tile counters in global
memory. `fused_tasks` is that list (the wrapper passes it to the kernel as
a table, `task_table`), `fused_schedule` the blocks' shares of it beside
the chain's parts, and `mll_fused_steps` its float64 mirror, which only the
tests run.

The backward is the JAX package's closed form (_se_core_bwd) from the saved
factor: T = L^{-1} (ops/tri_inv, kernel K3), alpha = T^T (T delta), then
P = [W x | W 1], d_sv_raw and d_da from kernel K4 (ops/mll_bwd), and

    d_x = 2 [(W x) - (W 1) o x],   d_delta = alpha,
    d_sv = d_sv_raw / sv,          d_da = tr G.

With HYPERBO_BWD_JOINT=1 in the environment (read at each backward) and
d + 2 <= 127 (the JAX package's condition), the backward instead computes
all of this in one call of ops/bwd_joint (kernel K8), as the JAX package's
_se_core_bwd does under the same variable. Unset or '0' leaves it off; any
other value raises.

Every wrapper dispatches on the tensor's device: a CUDA tensor launches the
hand-written Hopper kernel (csrc/fused_mll.cu, csrc/tri_inv.cu,
csrc/mll_bwd.cu, csrc/bwd_joint.cu) or raises; a CPU tensor runs the plain
PyTorch version. There is no fallback from one to the other, and no switch
besides the device and HYPERBO_BWD_JOINT: config['fused_mll'] takes True,
False or None, and the JAX package's 'interpret' raises. The Mosaic tuning
knobs of the JAX module (block, half, group, pivot modes, the other
HYPERBO_* variables, the 128-lane feature limit) have no counterpart.

Padded rows (a `valid` mask) are exact: the kernels zero every Gram entry
touching a padded row and keep its diagonal at da, and the wrapper removes
the padded rows' log(da)/2 from the log-determinant. A task whose n is not
a multiple of the kernels' 64-row tile is padded up to one this way.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from hyperbo_tpu_torch.core.warp import retrieve_params
from hyperbo_tpu_torch.models import basis as bf
from hyperbo_tpu_torch.ops import _build
from hyperbo_tpu_torch.ops import bwd_joint
from hyperbo_tpu_torch.ops import chol as chol_ops
from hyperbo_tpu_torch.ops import mll_bwd
from hyperbo_tpu_torch.ops import tri_inv as tri_inv_ops
from hyperbo_tpu_torch.ops.chol_panel import factor_block_column, solve_rows

TILE = mll_bwd.TILE
# The persistent launch's tile: 128 x 128, the last row and column of tiles
# 64 wide where n / 64 is odd.
SUPER = 2 * TILE
# What the chain publishes at each step for the workers' panel solves: the
# diagonal tile's two 64 x 64 factors transposed, the 64 x 64 tile between
# them and 1 / sqrt of its 128 pivots.
PANEL = 3 * TILE * TILE + 2 * TILE
# The smallest n the route takes: the JAX package's group * block, so that
# both packages send the same configurations down the fused route.
MIN_N = 512

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)
_LOG_2PI = math.log(2 * math.pi)

KERNEL = _build.CudaKernel(
    'fused_mll.cu', 'hyperbo_mll_fused',
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 +
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

# One part of the kernel's schedule, run by one block: `op` on tile (i, j)
# (of 128 x 128 tiles) at step k, after every counter in `waits` ((i, j),
# value) has reached its value; it then sets the counters in `sets`.
Work = collections.namedtuple('Work', 'op i j k waits sets')


def _gram_transform(sqd, sv, kfam: str):
  """sv k(r2) of a squared-distance matrix; r2 floored at 0, so exactly
  coincident points give k(0) = sv."""
  r2 = torch.clamp(sqd, min=0.0)
  if kfam == 'se':
    return sv * torch.exp(-0.5 * r2)
  if kfam == 'matern32':
    r = _SQRT3 * torch.sqrt(r2)
    return sv * ((1.0 + r) * torch.exp(-r))
  if kfam == 'matern52':
    r = _SQRT5 * torch.sqrt(r2)
    return sv * ((1.0 + r + (r * r) * (1.0 / 3.0)) * torch.exp(-r))
  raise ValueError(f'unknown fused kernel family: {kfam!r}')


def mll_fused_plain(x: torch.Tensor, y: torch.Tensor, sv, da,
                    kfam: str = 'se', valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Plain PyTorch (L, quad, logdet_half) (any device, float32 or
  float64): dense Gram as the kernel builds it (entries touching a padded
  row 0, its diagonal da), Cholesky (NaN where not positive definite) and
  a triangular solve."""
  kmat = _gram_transform(mll_bwd.raw_sqdist(x), sv, kfam)
  if valid is not None:
    kmat = kmat * (valid[:, None] * valid[None, :])
  kmat = kmat + da * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
  chol = chol_ops.cholesky(kmat)
  z = torch.linalg.solve_triangular(chol, y.reshape(-1, 1), upper=False)
  return (chol, torch.sum(z * z),
          torch.sum(torch.log(torch.diagonal(chol))))


def _chain_work(ns: int) -> list:
  """The chain block's parts: the first diagonal tile, then for each step k
  the loads of tiles (k + 1, k) and (k + 1, k + 1) (beside the factor), the
  factor of (k, k) with its release, the solve of (k + 1, k) beside z_k, and
  the lookahead update of (k + 1, k + 1) beside the release of the solved
  tile, z_k and its partial."""
  work = [Work('load', 0, 0, 0, (), ())]
  for k in range(ns):
    if k + 1 < ns:
      work.append(Work('prefetch', k + 1, k, k,
                       (((k + 1, k), k), ((k + 1, k + 1), k)), ()))
    work.append(Work('factor', k, k, k, (), (((k, k), k + 1),)))
    work.append(Work('solve_next', k + 1, k, k, (), ()))
    if k + 1 < ns:
      work.append(Work('lookahead', k + 1, k + 1, k, (),
                       (((k + 1, k), k + 1),)))
  return work


def _task_columns(ns: int) -> list:
  """fused_tasks' columns in order, each (op, j, k, first row)."""
  columns = []
  for front in range(1, 2 * ns - 2):
    for last in range((front - 1) // 2, -1, -1):
      j = front - last
      if j >= ns:
        continue
      if j == last + 1:
        columns.append(('solve', last, last, last + 2))
      elif j == last + 2 or (last % 2 == 0 and j == last + 3):
        columns.append(('update', j, last, j))
      elif last % 2 == 1 and j >= last + 3:
        columns.append(('update2', j, last - 1, j))
  return columns


def fused_tasks(n: int) -> list:
  """The workers' tasks in the kernel's order, each (op, i, j, k):
    'solve'   tile (i, k) of step k (j = k), followed in the same block by
              the update of (i, k + 1) with the chain's L_{k+1,k} and the
              partial L_ik z_k;
    'update'  tile (i, j) by step k alone (128 deep): the columns
              j = k + 2 and, for an even k, k + 3, so that the diagonal
              tile the chain factors next waits on one 128-deep product;
    'update2' tile (i, j) by steps k and k + 1 at once (256 deep), k even,
              j >= k + 4: every other update.
  A task belongs to the column it writes and to the last step it applies
  (the solves of step k to column k + 1); the columns go in wavefronts of
  step + column, the newest step's first, each column's tiles from the
  diagonal down. A column needs only the wavefronts before its own, so the
  solves of step k + 1 and the first columns of its update come before
  the far columns of step k's: the chain's next tiles never wait behind
  the bulk of a step."""
  ns = -(-n // SUPER)
  return [(op, i, j, k) for op, j, k, first in _task_columns(ns)
          for i in range(first, ns)]


def _task_work(op: str, i: int, j: int, k: int) -> list:
  """A task's parts with their waits and sets: a solve releases (i, k) as
  soon as it is stored, then waits for the chain's L_{k+1,k} and z_k."""
  if op == 'solve':
    return [Work('solve', i, k, k, (((k, k), k + 1), ((i, k), k)),
                 (((i, k), k + 1),)),
            Work('update_held', i, k + 1, k,
                 (((k + 1, k), k + 1), ((i, k + 1), k)),
                 (((i, k + 1), k + 1),))]
  steps = 2 if op == 'update2' else 1
  return [Work(op, i, j, k,
               tuple(((r, k + s), k + s + 1) for s in range(steps)
                     for r in (i, j)) + (((i, j), k),),
               (((i, j), k + steps),))]


def fused_schedule(n: int, blocks: int) -> list:
  """The persistent launch's schedule on a grid of `blocks` blocks: for
  each block the list of parts it runs, in order, each with the counters
  it waits on and the counters it sets. Block 0 runs the chain; the
  workers, blocks 1 .. blocks - 1, take `fused_tasks` round robin. Tiles
  are 128 x 128 (the last row and column 64 wide where n / 64 is odd);
  counter (i, j) counts the steps whose update tile (i, j) holds, and is
  j + 1 once the tile is final."""
  if n <= 0 or n % TILE or blocks < 2:
    raise ValueError(f'fused_schedule takes n a positive multiple of {TILE} '
                     f'and blocks >= 2; got {n}, {blocks}')
  workers = blocks - 1
  schedule = [_chain_work(-(-n // SUPER))] + [[] for _ in range(workers)]
  for t, task in enumerate(fused_tasks(n)):
    schedule[1 + t % workers] += _task_work(*task)
  return schedule


def _solve_panel(x: torch.Tensor, pan: dict):
  """In place: x <- x L_kk^-T for the rows of x, as a thread solves its row:
  the first 64 columns against L_kk's first factor, their products off the
  other 64, those against its second factor."""
  solve_rows(x[:, :TILE], pan['l00'], pan['rd0'])
  if 'l11' in pan:
    x[:, TILE:] -= x[:, :TILE] @ pan['l1'].T
    solve_rows(x[:, TILE:], pan['l11'], pan['rd1'])


def mll_fused_steps(x: torch.Tensor, y: torch.Tensor, sv, da,
                    kfam: str = 'se', valid: Optional[torch.Tensor] = None,
                    blocks: int = 132
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Plain mirror of the kernel's algorithm (tests run it in float64):
  (L, quad, logdet_half) by `fused_schedule`'s parts, run block by block as
  their counters allow, on NaN-initialised scratch. The Gram launch writes
  K's lower 64 x 64 tiles and zeros above; a diagonal factor is two
  `factor_block_column`s with the 64-deep update between them, a panel
  solve `_solve_panel`, an update one 128- or 256-deep product subtracted
  (a diagonal tile's upper 64 x 64 quarter left as it is); z_k is the chain's
  solve of y_k less the partials L_km z_m of its row, and quad and
  logdet_half are summed on the chain in step order. NaN (or inf) where not
  positive definite, as the kernel gives before the wrapper's poison."""
  n = x.shape[0]
  t, s = TILE, SUPER
  ns = -(-n // s)
  kmat = _gram_transform(mll_bwd.raw_sqdist(x), sv, kfam)
  if valid is not None:
    kmat = kmat * (valid[:, None] * valid[None, :])
  kmat = kmat + da * torch.eye(n, dtype=x.dtype, device=x.device)
  tiles = torch.arange(n, device=x.device) // t
  out = torch.where(tiles[:, None] >= tiles[None, :], kmat,
                    torch.zeros((), dtype=x.dtype, device=x.device))
  nan = float('nan')
  z = torch.full((n,), nan, dtype=x.dtype, device=x.device)
  partial = torch.full((ns, ns, s), nan, dtype=x.dtype, device=x.device)
  y = y.reshape(n)

  def rows(i):
    return slice(i * s, min((i + 1) * s, n))

  def tile(i, j):
    return out[rows(i), rows(j)]

  def lower(i):
    """Diagonal tile i as a factor reads it: its upper 64 x 64 quarter 0."""
    d = tile(i, i).clone()
    d[:t, t:] = 0.0
    return d

  local = {}  # the chain block's shared memory
  held = {}   # a worker's solved tile, until its held update
  panels = {}
  sums = [0.0, 0.0]
  schedule = fused_schedule(n, blocks)
  counts = collections.Counter()
  done = [0] * len(schedule)
  while any(p < len(w) for p, w in zip(done, schedule)):
    moved = False
    for blk, work in enumerate(schedule):
      while done[blk] < len(work) and all(
          counts[c] >= v for c, v in work[done[blk]].waits):
        w = work[done[blk]]
        i, j, k = w.i, w.j, w.k
        if w.op == 'load':
          local['diag'] = lower(0)
        elif w.op == 'prefetch':
          local['below'] = tile(i, k).clone()
          local['next'] = lower(i)
        elif w.op == 'factor':
          d = local['diag']
          pan = {'rd0': factor_block_column(d[:, :t])}
          pan['l00'] = d[:t, :t]
          if d.shape[0] > t:
            pan['l1'] = d[t:, :t]
            d[t:, t:] -= pan['l1'] @ pan['l1'].T
            pan['rd1'] = factor_block_column(d[t:, t:])
            pan['l11'] = d[t:, t:]
          panels[k] = pan
          tile(k, k).copy_(torch.tril(d))
          b = y[rows(k)].clone()
          for m in range(k):
            b -= partial[k, m, :b.shape[0]]
          local['b'] = b
        elif w.op == 'solve_next':
          zk = local['b'][None, :]
          _solve_panel(zk, panels[k])
          local['z'] = zk[0]
          sums[0] += float(torch.sum(zk * zk))
          sums[1] += float(torch.sum(torch.log(torch.diagonal(tile(k, k)))))
          if k + 1 < ns:
            _solve_panel(local['below'], panels[k])
          else:
            z[rows(k)] = local['z']
        elif w.op == 'lookahead':
          below = local['below']
          local['next'] -= below @ below.T
          local['diag'] = local['next']
          tile(i, k).copy_(below)
          z[rows(k)] = local['z']
          partial[i, k, :below.shape[0]] = below @ local['z']
        elif w.op == 'solve':
          x_ik = tile(i, k).clone()
          _solve_panel(x_ik, panels[k])
          tile(i, k).copy_(x_ik)
          held[i, k] = x_ik
        elif w.op == 'update_held':
          x_ik = held.pop((i, k))
          tile(i, j).sub_(x_ik @ tile(j, k).T)
          partial[i, k, :x_ik.shape[0]] = x_ik @ z[rows(k)]
        else:
          cols = slice(k * s, (k + (2 if w.op == 'update2' else 1)) * s)
          prod = out[rows(i), cols] @ out[rows(j), cols].T
          if i == j:
            prod[:t, t:] = 0.0
          tile(i, j).sub_(prod)
        for c, v in w.sets:
          counts[c] = v
        done[blk] += 1
        moved = True
    if not moved:
      raise RuntimeError('fused_schedule deadlocks')
  return (out, torch.tensor(sums[0], dtype=x.dtype),
          torch.tensor(sums[1], dtype=x.dtype))


@functools.lru_cache(maxsize=16)
def task_table(n: int, device: torch.device) -> torch.Tensor:
  """`fused_tasks(n)` as the kernel reads it: one int32 a task,
  pair << 30 | k << 20 | j << 10 | i (a solve has j == k; pair is 1 for
  'update2'), on the device."""
  ns = -(-n // SUPER)
  columns = _task_columns(ns)
  heads = np.array([(op == 'update2') << 30 | k << 20 | j << 10 | first
                    for op, j, k, first in columns], dtype=np.int64)
  sizes = np.array([ns - first for _, _, _, first in columns],
                   dtype=np.int64)
  starts = np.cumsum(sizes) - sizes
  rows = np.arange(int(sizes.sum()), dtype=np.int64) - np.repeat(starts,
                                                                 sizes)
  codes = np.repeat(heads, sizes) + rows
  return torch.tensor(codes.astype(np.int32), device=device)


def launch_mll_fused(x: torch.Tensor, y: torch.Tensor, sv: torch.Tensor,
                     da: torch.Tensor, kfam: str = 'se',
                     valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Run the Hopper kernel: x (n, d), y (n, 1), sv and da one-element
  tensors, valid (n,) 0/1 or None, all float32 and contiguous on one CUDA
  device; n a multiple of 64. One call, two kernel launches (the Gram
  tiles, then the persistent factorization), with the workers' task list,
  the counters (zeroed here), the published panels and the partials
  L_ik z_k as scratch."""
  sv_da = torch.cat([sv.reshape(1), da.reshape(1)])
  _build.check_cuda_f32('launch_mll_fused', x=x, y=y, sv_da=sv_da,
                        valid=valid)
  n, d = x.shape
  if y.shape != (n, 1) or n == 0 or n % TILE:
    raise ValueError(f'launch_mll_fused takes x (n, d) and y (n, 1) with n '
                     f'a multiple of {TILE}; got {tuple(x.shape)}, '
                     f'{tuple(y.shape)}')
  if valid is not None and valid.shape != (n,):
    raise ValueError(f'valid must be ({n},), got {tuple(valid.shape)}')
  ns = -(-n // SUPER)
  z = y.reshape(n).clone()
  opts = dict(dtype=torch.float32, device=x.device)
  chol = torch.empty((n, n), **opts)
  panel = torch.empty((ns, PANEL), **opts)
  partial = torch.empty((ns, ns, SUPER), **opts)
  counts = torch.zeros((ns, ns), dtype=torch.int32, device=x.device)
  out = torch.empty((2,), **opts)
  tasks = task_table(n, x.device)
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(x.data_ptr(),
                  valid.data_ptr() if valid is not None else None,
                  sv_da.data_ptr(), z.data_ptr(), n, d,
                  mll_bwd.KFAM_CODE[kfam], chol.data_ptr(), panel.data_ptr(),
                  partial.data_ptr(), counts.data_ptr(), tasks.data_ptr(),
                  tasks.numel(), out.data_ptr(), stream)
  return chol, out[0], out[1]


def mll_fused(x: torch.Tensor, y: torch.Tensor, sv, da, kfam: str = 'se',
              valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """(L, quad, logdet_half) = (chol K, y^T K^{-1} y, sum log diag L).

  L is dense lower triangular (n, n). Where K is not positive definite,
  the kernel leaves a diagonal entry of L that is not > 0 (or NaN: there is
  no pivot clamp) and the plain version returns NaN; _poison_non_pd makes
  either a NaN factor and value.
  """
  if x.device.type == 'cuda':
    return launch_mll_fused(x, y, sv, da, kfam, valid)
  if x.device.type == 'cpu':
    return mll_fused_plain(x, y, sv, da, kfam, valid)
  raise ValueError(f'mll_fused runs on cpu or cuda, got {x.device}')


def _poison_non_pd(chol, nll):
  """NaN factor and value where the factorization failed.

  A failed pivot leaves a diagonal entry of L that is <= 0 or NaN, in the
  kernel and in the plain version; either way min(diag L) > 0 is false.
  Poisoning L makes every backward product NaN too, so the trainer's
  isfinite-freeze trips as on the dense path. Unlike the JAX package, whose value-only primal keeps
  its pivot clamp's finite garbage, every call is poisoned here.
  """
  bad = ~(torch.min(torch.diagonal(chol)) > 0)
  nan = torch.full((), float('nan'), dtype=chol.dtype, device=chol.device)
  return torch.where(bad, nan, chol), torch.where(bad, nan, nll)


def bwd_joint_requested() -> bool:
  """Whether HYPERBO_BWD_JOINT asks for the joint backward (kernel K8):
  '1' on, unset or '0' off; any other value raises."""
  flag = os.environ.get('HYPERBO_BWD_JOINT', '0')
  if flag not in ('0', '1'):
    raise ValueError(f'HYPERBO_BWD_JOINT = {flag!r}: the port takes 1 (the '
                     'joint backward, kernel K8) or 0 / unset (K3, alpha '
                     'and K4).')
  return flag == '1'


class _FusedNllCore(torch.autograd.Function):
  """nll_core(x_scaled, delta, sv, da[, valid]) = quad / 2 + logdet_half,
  with the closed-form backward of pallas_mll._se_core_bwd."""

  @staticmethod
  def forward(ctx, x_scaled, delta, sv, da, valid, kfam):
    chol, quad, ld = mll_fused(x_scaled, delta, sv, da, kfam, valid)
    chol, nll = _poison_non_pd(chol, 0.5 * quad + ld)
    ctx.kfam = kfam
    ctx.save_for_backward(chol, x_scaled, delta, sv, valid)
    return nll

  @staticmethod
  def backward(ctx, g):
    chol, x_scaled, delta, sv, valid = ctx.saved_tensors
    d = x_scaled.shape[1]
    if bwd_joint_requested() and d + 2 <= bwd_joint.ULANE:
      d_x, alpha, dsv_raw, d_da = bwd_joint.mll_bwd_joint(
          chol, x_scaled, delta, sv, ctx.kfam, valid)
    else:
      t = tri_inv_ops.tri_inv(chol)
      alpha = tri_inv_ops.alpha_from_inverse(t, delta)
      p, dsv_raw, d_da = mll_bwd.mll_bwd_fused(t, x_scaled, alpha, sv,
                                               ctx.kfam, valid)
      d_x = 2.0 * (p[:, :d] - p[:, d:] * x_scaled)
    return g * d_x, g * alpha, g * dsv_raw / sv, g * d_da, None, None


def fused_nll_core(x_scaled: torch.Tensor, delta: torch.Tensor, sv, da,
                   kfam: str = 'se',
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Differentiable quad / 2 + logdet_half (the 0.5 n log 2 pi constant
  stays with the caller); NaN when K is not positive definite."""
  return _FusedNllCore.apply(x_scaled, delta, sv, da, valid, kfam)


def _fused_kernel_table():
  """cov_func -> (family, embedding) for every kernel the route serves:
  the SE and Matern families, raw, over the MLP or over the Kumaraswamy
  warp. dot_product's Gram (one rank-d product) stays on the dense path,
  as in the JAX package."""
  from hyperbo_tpu_torch.models import kernel as kl
  return {
      kl.squared_exponential: ('se', None),
      kl.squared_exponential_mlp: ('se', 'mlp'),
      kl.squared_exponential_kumar: ('se', 'kumar'),
      kl.matern32: ('matern32', None),
      kl.matern32_mlp: ('matern32', 'mlp'),
      kl.matern32_kumar: ('matern32', 'kumar'),
      kl.matern52: ('matern52', None),
      kl.matern52_mlp: ('matern52', 'mlp'),
      kl.matern52_kumar: ('matern52', 'kumar'),
  }


def kernel_family(cov_func) -> str:
  """Family name of a library kernel; 'se' for None."""
  if cov_func is None:
    return 'se'
  entry = _fused_kernel_table().get(cov_func)
  if entry is None:
    raise ValueError(
        f'{getattr(cov_func, "__name__", cov_func)!r} is not served by the '
        'fused MLL route (gate with se_nll_fused_applicable)')
  return entry[0]


def _se_embed(params, x, cov_func, warp_func):
  """The inputs the base kernel sees: raw, MLP- or Kumar-embedded. The
  embedding runs outside the autograd Function, so its parameters get
  their gradients from autograd, as from jax.grad in the JAX package."""
  name = getattr(cov_func, '__name__', '') if cov_func is not None else ''
  if name.endswith('_mlp'):
    mlp_params, = retrieve_params(params, ['mlp_params'],
                                  warp_func=warp_func)
    return bf.mlp_apply(mlp_params, x)
  if name.endswith('_kumar'):
    kumar_params, = retrieve_params(params, ['kumar_params'],
                                    warp_func=warp_func)
    return bf.kumar_warp_apply(kumar_params, x)
  return x


def fused_requested(params) -> bool:
  """Whether config['fused_mll'] asks for the fused route: True, or
  False/None/absent. Any other value raises; in particular the JAX
  package's 'interpret' has no meaning here, since the tensor's device
  picks the implementation."""
  flag = (params.config or {}).get('fused_mll')
  if flag is None or flag is False:
    return False
  if flag is True:
    return True
  raise ValueError(f"config['fused_mll'] = {flag!r}: the port takes True, "
                   'False or None (the device picks kernel or plain '
                   'version).')


def se_nll_fused(mean_func, params, x, y, warp_func=None, eps=1e-6,
                 cov_func=None):
  """NLL of one (n, 1) task through the fused route; the value of the
  dense pipeline (objectives.neg_log_marginal_likelihood) for the kernels
  of _fused_kernel_table, with diag add = warped noise_variance + eps.
  An n that is not a multiple of 64 goes through the masked core."""
  lengthscale, signal_variance, noise_variance = retrieve_params(
      params, ['lengthscale', 'signal_variance', 'noise_variance'],
      warp_func=warp_func)
  n = x.shape[0]
  mu = mean_func(params, x, warp_func=warp_func)
  delta = y - torch.atleast_2d(mu)
  x_scaled = _se_embed(params, x, cov_func, warp_func) / lengthscale
  kfam = kernel_family(cov_func)
  sv = torch.squeeze(torch.as_tensor(signal_variance))
  da = torch.squeeze(torch.as_tensor(noise_variance)) + eps
  if n % TILE:
    return se_nll_fused_masked(x_scaled, delta, sv, da, n, kfam)
  nll_core = fused_nll_core(x_scaled.contiguous(), delta.contiguous(), sv,
                            da, kfam)
  return nll_core + 0.5 * n * _LOG_2PI


def se_nll_fused_masked(x_scaled, delta_masked, sv, da, count,
                        kfam: str = 'se'):
  """Fused NLL of one padded task: rows >= count are padding.

  x_scaled is zero-padded to a multiple of 64 rows first. Padded rows leave
  the Gram matrix (exactly), their delta is zeroed, and their surplus
  log(da)/2 each is subtracted here, outside the autograd Function, so
  autograd carries its d/d(da). `count` is an int or a 0-d tensor.
  """
  n_in = x_scaled.shape[0]
  n = -(-n_in // TILE) * TILE
  if n != n_in:
    x_scaled = torch.nn.functional.pad(x_scaled, (0, 0, 0, n - n_in))
    delta_masked = torch.nn.functional.pad(delta_masked, (0, 0, 0, n - n_in))
  keep = torch.arange(n, device=x_scaled.device) < count
  valid = keep.to(x_scaled.dtype)
  xs = torch.where(keep[:, None], x_scaled, 0.0)
  delta = torch.where(keep[:, None], delta_masked, 0.0)
  nll_core = fused_nll_core(xs.contiguous(), delta.contiguous(), sv, da,
                            kfam, valid)
  surplus = 0.5 * torch.log(da) * (n - count)
  return nll_core - surplus + 0.5 * count * _LOG_2PI


def se_nll_fused_applicable(cov_func, x, params=None, y=None) -> bool:
  """True when the fused route can replace the dense NLL pipeline: a
  served kernel family (with its MLP or Kumar parameters present), x of
  at least MIN_N rows and a single-column y. The same conditions as the JAX
  package's, without its TPU feature-width limit."""
  if y is not None and y.ndim == 2 and y.shape[1] != 1:
    return False
  if not (x.ndim == 2 and x.shape[0] >= MIN_N):
    return False
  entry = _fused_kernel_table().get(cov_func)
  if entry is None:
    return False
  if entry[1] == 'kumar':
    if params is None or 'kumar_params' not in params.model:
      return False
  if entry[1] == 'mlp':
    if params is None or 'mlp_params' not in params.model:
      return False
    if not (params.config or {}).get('mlp_features'):
      return False
  return True
