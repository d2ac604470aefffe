"""Joint fused-NLL backward, kernel K8 (port of
hyperbo_tpu/ops/pallas_bwd_joint.py).

From the forward's factor L, one call computes every adjoint of the fused
NLL (ops/fused_mll): T = L^{-1}, u = T delta, alpha = T^T u = K^{-1} delta,
then K4's SYRK consumption P = [W x | W 1], d_sv_raw and d_da (ops/mll_bwd),
and d_x = 2 (P[:, :d] - P[:, d:] o x). It is what ops/tri_inv (K3), alpha
and ops/mll_bwd (K4) compute one after another; the route of ops/fused_mll
takes it under HYPERBO_BWD_JOINT=1, as the JAX package does.

`mll_bwd_joint` dispatches on the tensor's device: a CUDA tensor goes
through the hand-written Hopper kernel (csrc/bwd_joint.cu: one persistent
cooperative launch that runs K3's recursive block-inverse levels from
csrc/tri_inv_core.cuh, u = T delta, alpha, then the 64 x 64 tile-pair
SYRK bodies of csrc/bwd_core.cuh, phase after phase) or raises; a CPU tensor goes through
the plain PyTorch version `mll_bwd_joint_plain`, the chain of the three
plain versions. There is no fallback from one to the other, and never from
the kernel to K3 + K4. The Mosaic knobs of the JAX function (tile shapes,
panel layouts, `precise`, MAX_N) have no counterpart.

`joint_schedule` lists the kernel's phases in order, each with its work
items and the tiles each item reads and writes; `mll_bwd_joint_steps` runs
those items in order in plain PyTorch (the tests run it in float64).
"""

from __future__ import annotations

import ctypes
from typing import FrozenSet, List, NamedTuple, Optional, Tuple

import torch

from hyperbo_tpu_torch.ops import _build
from hyperbo_tpu_torch.ops import mll_bwd
from hyperbo_tpu_torch.ops import tri_inv as tri_inv_ops

TILE = mll_bwd.TILE
# The JAX kernel reserves lane 127 of its 128-lane feature tiles for delta,
# so its route needs d + 2 <= ULANE; the port's route keeps the condition so
# that both packages send the same configurations through the joint kernel.
ULANE = 127
SLAB = 32        # csrc/bwd_core.cuh kSlab: the alpha phase's columns an item
_COUNTERS = 64   # csrc/bwd_joint.cu kCounters
# Buffers the kernel reads and never writes.
INPUTS = ('L', 'dinv', 'delta', 'x')

KERNEL = _build.CudaKernel(
    'bwd_joint.cu', 'hyperbo_mll_bwd_joint',
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 10)


def mll_bwd_joint_plain(l: torch.Tensor, x_scaled: torch.Tensor,
                        delta: torch.Tensor, sv: torch.Tensor,
                        kfam: str = 'se',
                        valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
  """Plain PyTorch (d_x, alpha, d_sv_raw, d_da) (any device, float32 or
  float64)."""
  t = tri_inv_ops.tri_inv_plain(l)
  alpha = tri_inv_ops.alpha_from_inverse(t, delta)
  p, dsv_raw, d_da = mll_bwd.mll_bwd_plain(t, x_scaled, alpha, sv, kfam,
                                           valid)
  d = x_scaled.shape[1]
  return 2.0 * (p[:, :d] - p[:, d:] * x_scaled), alpha, dsv_raw, d_da


def _launch(l: torch.Tensor, x_scaled: torch.Tensor, delta: torch.Tensor,
            sv: torch.Tensor, kfam: str, valid: Optional[torch.Tensor]):
  """launch_mll_bwd_joint's outputs, and T = L^{-1} as the kernel left it
  in its scratch."""
  sv = sv.reshape(1)
  _build.check_cuda_f32('launch_mll_bwd_joint', l=l, x_scaled=x_scaled,
                        delta=delta, sv=sv, valid=valid)
  n, d = x_scaled.shape
  if l.shape != (n, n) or delta.shape != (n, 1) or n == 0 or n % TILE:
    raise ValueError(f'launch_mll_bwd_joint takes l (n, n), x_scaled (n, d) '
                     f'and delta (n, 1) with n a multiple of {TILE}; got '
                     f'{tuple(l.shape)}, {tuple(x_scaled.shape)}, '
                     f'{tuple(delta.shape)}')
  if valid is not None and valid.shape != (n,):
    raise ValueError(f'valid must be ({n},), got {tuple(valid.shape)}')
  nb = n // TILE
  dinv = tri_inv_ops.diag_inverses(l).contiguous()
  f32 = dict(dtype=torch.float32, device=l.device)
  t = torch.empty((n, n), **f32)
  w = torch.empty((tri_inv_ops.scratch_floats(n),), **f32)
  u = torch.empty((n,), **f32)
  alpha = torch.empty((n, 1), **f32)
  p_part = torch.empty((nb, nb, TILE, d + 1), **f32)
  s_part = torch.empty((nb * (nb + 1),), dtype=torch.float64,
                       device=l.device)
  counters = torch.empty((_COUNTERS,), dtype=torch.int32, device=l.device)
  p = torch.empty((n, d + 1), **f32)
  out = torch.empty((2,), **f32)
  with torch.cuda.device(l.device):
    stream = torch.cuda.current_stream(l.device).cuda_stream
    KERNEL.launch(l.data_ptr(), dinv.data_ptr(), x_scaled.data_ptr(),
                  delta.data_ptr(),
                  valid.data_ptr() if valid is not None else None,
                  sv.data_ptr(), n, d, mll_bwd.KFAM_CODE[kfam], t.data_ptr(),
                  w.data_ptr(), u.data_ptr(), alpha.data_ptr(),
                  p_part.data_ptr(), s_part.data_ptr(), counters.data_ptr(),
                  p.data_ptr(), out.data_ptr(), stream)
  d_x = 2.0 * (p[:, :d] - p[:, d:] * x_scaled)
  return (d_x, alpha, out[0], out[1]), t


def launch_mll_bwd_joint(l: torch.Tensor, x_scaled: torch.Tensor,
                         delta: torch.Tensor, sv: torch.Tensor,
                         kfam: str = 'se',
                         valid: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
  """Run the Hopper kernel: l (n, n), x_scaled (n, d), delta (n, 1), sv a
  one-element tensor, valid (n,) 0/1 or None, all float32 and contiguous on
  one CUDA device; n a multiple of 64."""
  return _launch(l, x_scaled, delta, sv, kfam, valid)[0]


class Item(NamedTuple):
  """One work item of the kernel: op and its argument ('diag' a row tile,
  'w' and 't' a tri_inv.Product, 'u' a row tile, 'alpha' a slab, 'pair' a
  tile pair (i, j), 'p' a row tile, 'scalars' None), and the tiles it reads
  and writes: (buffer, index...) with 64-row tiles, W's tiles by (level,
  merge, row tile, column tile) within the merge's W."""
  op: str
  arg: object
  reads: FrozenSet[tuple]
  writes: FrozenSet[tuple]


def _tiles(name, rows, cols, r_off=0, c_off=0, prefix=()):
  """The 64 x 64 tiles of buffer `name` that rows x cols (element ranges,
  offset by r_off, c_off) cover."""
  (r0, r1), (c0, c1) = rows, cols
  return {(name, *prefix, i, j)
          for i in range((r_off + r0) // TILE, -(-(r_off + r1) // TILE))
          for j in range((c_off + c0) // TILE, -(-(c_off + c1) // TILE))}


def _product_item(level: int, p: tri_inv_ops.Product) -> Item:
  a0, c0, _ = (v * TILE for v in p.merge)
  w_key = (level, p.z)
  if p.kind == 'w':
    reads = (_tiles('L', p.rows, p.ks, c0, a0) |
             _tiles('T', p.ks, p.cols, a0, a0))
    writes = _tiles('W', p.rows, p.cols, prefix=w_key)
  else:
    reads = (_tiles('T', p.rows, p.ks, c0, c0) |
             _tiles('W', p.ks, p.cols, prefix=w_key))
    writes = _tiles('T', p.rows, p.cols, c0, a0)
  return Item(p.kind, p, frozenset(reads), frozenset(writes))


def joint_schedule(n: int) -> List[Tuple[str, List[Item]]]:
  """The kernel's phases in order (a grid-wide barrier after each), each
  with its items: level 0, each level's W tiles then T tiles (K3's
  products), u, alpha, the SYRK tile pairs, the reductions."""
  nb = n // TILE
  phases = [('level 0', [
      Item('diag', i, frozenset({('dinv', i)}),
           frozenset(('T', i, j) for j in range(i, nb))) for i in range(nb)])]
  # A level's tiles in the kernel's order, heaviest first across its
  # merges: W by column tile, T by row tile from the last.
  for level, (w_items, t_items) in enumerate(
      tri_inv_ops.level_products(nb), 1):
    w_items = sorted(w_items, key=lambda p: (p.cols[0], p.z, p.rows[0]))
    t_items = sorted(t_items, key=lambda p: (-p.rows[0], p.z, p.cols[0]))
    phases.append((f'level {level} W',
                   [_product_item(level, p) for p in w_items]))
    phases.append((f'level {level} T',
                   [_product_item(level, p) for p in t_items]))
  phases.append(('u', [
      Item('u', i, frozenset({('T', i, j) for j in range(i + 1)} |
                             {('delta', j) for j in range(i + 1)}),
           frozenset({('u', i)})) for i in range(nb)]))
  slabs = TILE // SLAB
  phases.append(('alpha', [
      Item('alpha', s, frozenset({('T', i, s // slabs) for i in
                                  range(s // slabs, nb)} |
                                 {('u', i) for i in range(s // slabs, nb)}),
           frozenset({('alpha', s)})) for s in range(nb * slabs)]))
  pairs = []
  for i in range(nb):
    for j in range(i + 1):
      reads = ({('T', k, i) for k in range(i, nb)} |
               {('T', k, j) for k in range(i, nb)} |
               {('alpha', c * slabs + h) for c in (i, j)
                for h in range(slabs)} | {('x', i), ('x', j)})
      writes = {('p_part', i, j), ('p_part', j, i), ('s_part', i, j)}
      pairs.append(Item('pair', (i, j), frozenset(reads), frozenset(writes)))
  phases.append(('SYRK', pairs))
  phases.append(('reductions', [
      Item('p', i, frozenset(('p_part', i, o) for o in range(nb)),
           frozenset({('P', i)})) for i in range(nb)] + [
               Item('scalars', None, frozenset(
                   ('s_part', i, j) for i in range(nb) for j in range(i + 1)),
                    frozenset({('out',)}))]))
  return phases


def mll_bwd_joint_steps(l: torch.Tensor, x_scaled: torch.Tensor,
                        delta: torch.Tensor, sv: torch.Tensor,
                        kfam: str = 'se',
                        valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
  """The kernel's items (joint_schedule) run in order in plain PyTorch:
  (d_x, alpha, d_sv_raw, d_da) as mll_bwd_joint gives them. Every buffer
  starts as NaN, so a read of an entry no earlier item wrote shows in the
  outputs."""
  n, d = x_scaled.shape
  nb, b, slabs = n // TILE, TILE, TILE // SLAB
  opts = dict(dtype=l.dtype, device=l.device)
  nan = float('nan')
  t = torch.full((n, n), nan, **opts)
  w = torch.full((tri_inv_ops.scratch_floats(n),), nan, **opts)
  u = torch.full((n,), nan, **opts)
  alpha = torch.full((n, 1), nan, **opts)
  p_part = torch.full((nb, nb, b, d + 1), nan, **opts)
  s_part = torch.full((nb, nb, 2), nan, **opts)
  p = torch.full((n, d + 1), nan, **opts)
  dinv = tri_inv_ops.diag_inverses(l)
  sqn = torch.sum(x_scaled * x_scaled, dim=1)
  out = None

  def tile(i):
    return slice(i * b, (i + 1) * b)

  for _, items in joint_schedule(n):
    for it in items:
      if it.op == 'diag':
        i = it.arg
        t[tile(i), i * b:] = 0.0
        t[tile(i), tile(i)] = dinv[i]
      elif it.op in ('w', 't'):
        tri_inv_ops.apply_product(l, t, w, it.arg)
      elif it.op == 'u':
        top = (it.arg + 1) * b
        u[tile(it.arg)] = t[tile(it.arg), :top] @ delta[:top, 0]
      elif it.op == 'alpha':
        cols = slice(it.arg * SLAB, (it.arg + 1) * SLAB)
        top = it.arg // slabs * b
        alpha[cols, 0] = t[top:, cols].T @ u[top:]
      elif it.op == 'pair':
        i, j = it.arg
        ri, rj = tile(i), tile(j)
        kinv = t[i * b:, ri].T @ t[i * b:, rj]
        g = 0.5 * kinv - 0.5 * (alpha[ri] @ alpha[rj].T)
        r2 = torch.clamp(sqn[ri, None] + sqn[None, rj] -
                         2.0 * (x_scaled[ri] @ x_scaled[rj].T), min=0.0)
        km, nm = mll_bwd._km_nm(r2, sv, kfam)  # pylint: disable=protected-access
        if valid is not None:
          pr = valid[ri, None] * valid[None, rj]
          km, nm = km * pr, nm * pr
        wt = g * nm
        p_part[i, j] = torch.cat([wt @ x_scaled[rj], wt.sum(1, True)], 1)
        if i != j:
          p_part[j, i] = torch.cat([wt.T @ x_scaled[ri],
                                    wt.sum(0)[:, None]], 1)
        gk = torch.sum(g * km)
        s_part[i, j, 0] = gk if i == j else 2.0 * gk
        s_part[i, j, 1] = torch.trace(g) if i == j else 0.0
      elif it.op == 'p':
        p[tile(it.arg)] = p_part[it.arg].sum(0)
      else:
        lower = torch.tril(torch.ones(nb, nb, dtype=torch.bool,
                                      device=l.device))
        out = s_part[lower].sum(0)
  d_x = 2.0 * (p[:, :d] - p[:, d:] * x_scaled)
  return d_x, alpha, out[0], out[1]


def mll_bwd_joint(l: torch.Tensor, x_scaled: torch.Tensor,
                  delta: torch.Tensor, sv: torch.Tensor, kfam: str = 'se',
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
  """(d_x, alpha, d_sv_raw, d_da) of the fused NLL from its factor L.

  d_x is the (n, d) input adjoint, alpha = K^{-1} delta (n, 1) the delta
  adjoint; the caller divides d_sv_raw by sv. A NaN in L gives NaN outputs.
  """
  if l.device.type == 'cuda':
    return launch_mll_bwd_joint(l, x_scaled, delta, sv, kfam, valid)
  if l.device.type == 'cpu':
    return mll_bwd_joint_plain(l, x_scaled, delta, sv, kfam, valid)
  raise ValueError(f'mll_bwd_joint runs on cpu or cuda, got {l.device}')
