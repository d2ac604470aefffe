"""Fused NLL backward, kernel K4 (port of hyperbo_tpu/ops/pallas_mll_bwd.py).

From T = L^{-1} (ops/tri_inv) and alpha = K^{-1} delta, the adjoints of the
fused NLL (ops/fused_mll) need

    G = (T^T T - alpha alpha^T) / 2,    W = G o N(r2),
    P = [W x | W 1]  (n, d + 1),   d_sv_raw = sum G o Kf,   d_da = tr G,

with Kf = sv k(r2) and N = -2 sv dk/dr2 per kernel family (`_km_nm`), both
masked by valid_i valid_j for padded rows. The caller forms
d_x = 2 (Wx - (W1) o x) and d_sv = d_sv_raw / sv.

`mll_bwd_fused` dispatches on the tensor's device: a CUDA tensor goes
through the hand-written Hopper kernel (csrc/mll_bwd.cu), which never
writes K^{-1}, G or W to device memory, or raises; a CPU tensor goes
through the plain PyTorch version `mll_bwd_plain`, the dense chain of
hyperbo_tpu/ops/pallas_mll.py:1383-1405 written from T. There is no
fallback from one to the other.

The kernel's schedule is settled here on the CPU: `mll_bwd_tasks` lists its
blocks, one lower pair of 128-wide tiles each, in launch order with the
partial slots each writes, and `mll_bwd_steps` is its float64 mirror: the
pairs' chunked SYRK, epilogue and partials in that order, then the
reduction's fixed summation order.
"""

from __future__ import annotations

import ctypes
import math
from typing import FrozenSet, List, NamedTuple, Optional, Tuple

import torch

from hyperbo_tpu_torch.ops import _build

TILE = 64
# The kernel's tile pairs are 2 TILE wide (csrc/syrk128_core.cuh kW), its
# ring stages CHUNK rows of T deep (kBk); its reduction block has
# REDUCE_THREADS threads (tile_common.cuh kThreads).
PAIR = 2 * TILE
CHUNK = 16
REDUCE_THREADS = 256
KFAM_CODE = {'se': 0, 'matern32': 1, 'matern52': 2}

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)

KERNEL = _build.CudaKernel(
    'mll_bwd.cu', 'hyperbo_mll_bwd',
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5)


def raw_sqdist(x: torch.Tensor) -> torch.Tensor:
  """|x_i|^2 + |x_j|^2 - 2 x_i.x_j floored at 0: the kernels' distance
  form (one product plus the row norms, not centered)."""
  sqn = torch.sum(x * x, dim=1)
  return torch.clamp(sqn[:, None] + sqn[None, :] - 2.0 * (x @ x.T), min=0.0)


def _km_nm(r2, sv, kfam: str):
  """(kmat, neg2kp) = (sv k(r2), -2 sv dk/dr2) per kernel family, with
  the r^2 floor under the Matern square root (the exact coincident-point
  limit of the adjoint is 0, and the floor realizes it without inf * 0)."""
  if kfam == 'se':
    km = sv * torch.exp(-0.5 * r2)
    return km, km
  if kfam == 'matern32':
    r = _SQRT3 * torch.sqrt(torch.clamp(r2, min=1e-36))
    e = torch.exp(-r)
    return sv * (1.0 + r) * e, 3.0 * sv * e
  if kfam == 'matern52':
    r = _SQRT5 * torch.sqrt(torch.clamp(r2, min=1e-36))
    e = torch.exp(-r)
    return (sv * (1.0 + r + (r * r) * (1.0 / 3.0)) * e,
            (5.0 / 3.0) * sv * (1.0 + r) * e)
  raise ValueError(f'unknown fused kernel family: {kfam!r}')


def mll_bwd_plain(t: torch.Tensor, x: torch.Tensor, alpha: torch.Tensor,
                  sv: torch.Tensor, kfam: str = 'se',
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Plain PyTorch (P, d_sv_raw, d_da) (any device, float32 or float64)."""
  kinv = t.T @ t
  gmat = 0.5 * (kinv - alpha @ alpha.T)
  kmat, neg2kp = _km_nm(raw_sqdist(x), sv, kfam)
  if valid is not None:
    pair = valid[:, None] * valid[None, :]
    kmat = kmat * pair
    neg2kp = neg2kp * pair
  w = gmat * neg2kp
  p = torch.cat([w @ x, torch.sum(w, dim=1, keepdim=True)], dim=1)
  return p, torch.sum(gmat * kmat), torch.trace(gmat)


def tile_width(n: int, i: int) -> int:
  """Rows of 128-wide tile i: 64 for the last where n / 64 is odd."""
  return min(PAIR, n - PAIR * i)


class Pair(NamedTuple):
  """One block of the kernel: lower tile pair (i, j), j <= i, the chunks
  of its SYRK (CHUNK rows of T each, from row 128 i to n), and the partial
  slots it writes: ('p_part', row tile, other tile) and ('s_part', index)."""
  i: int
  j: int
  chunks: int
  writes: FrozenSet[tuple]


def mll_bwd_tasks(n: int) -> List[Pair]:
  """The kernel's blocks in launch order: block b takes the pair with
  b = i (i + 1) / 2 + j (tile_common.cuh decode_pair), i ascending, so the
  heaviest pairs (the most rows of T) come first."""
  ns = -(-n // PAIR)
  tasks = []
  for i in range(ns):
    for j in range(i + 1):
      b = len(tasks)
      writes = {('p_part', i, j), ('s_part', 2 * b), ('s_part', 2 * b + 1)}
      if i != j:
        writes.add(('p_part', j, i))
      tasks.append(Pair(i, j, (n - PAIR * i) // CHUNK, frozenset(writes)))
  return tasks


def _reduce_scalars(s_part: torch.Tensor) -> torch.Tensor:
  """(d_sv_raw, d_da) from the pairs' partials in bwd_core.cuh
  reduce_scalars' order: thread h of one block sums pairs h, h + 256, ...
  ascending, then a halving tree over the threads."""
  parts = s_part.reshape(-1, 2)
  red = torch.zeros((REDUCE_THREADS, 2), dtype=s_part.dtype,
                    device=s_part.device)
  for q0 in range(0, parts.shape[0], REDUCE_THREADS):
    rows = parts[q0:q0 + REDUCE_THREADS]
    red[:rows.shape[0]] = red[:rows.shape[0]] + rows
  w = REDUCE_THREADS // 2
  while w > 0:
    red[:w] = red[:w] + red[w:2 * w]
    w //= 2
  return red[0]


def mll_bwd_steps(t: torch.Tensor, x: torch.Tensor, alpha: torch.Tensor,
                  sv: torch.Tensor, kfam: str = 'se',
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """The kernel's blocks (mll_bwd_tasks) run in order in plain PyTorch, then
  its reductions: (P, d_sv_raw, d_da) as mll_bwd_fused gives them. Each
  pair's K^{-1} tile is summed chunk by chunk from row 128 i, its r2 in the
  kernels' distance form; the partials start as NaN, so a reduction that
  read a slot no pair wrote would show in the outputs."""
  n, d = x.shape
  ns, f1 = -(-n // PAIR), d + 1
  opts = dict(dtype=t.dtype, device=t.device)
  p_part = torch.full((ns, ns, PAIR, f1), float('nan'), **opts)
  s_part = torch.full((ns * (ns + 1),), float('nan'), **opts)
  sqn = torch.sum(x * x, dim=1)
  ones = torch.ones((n, 1), **opts)
  xo = torch.cat([x, ones], dim=1)
  for b, pair in enumerate(mll_bwd_tasks(n)):
    i, j = pair.i, pair.j
    wi, wj = tile_width(n, i), tile_width(n, j)
    ri = slice(PAIR * i, PAIR * i + wi)
    rj = slice(PAIR * j, PAIR * j + wj)
    kinv = torch.zeros((wi, wj), **opts)
    for c in range(pair.chunks):
      k = slice(PAIR * i + CHUNK * c, PAIR * i + CHUNK * (c + 1))
      kinv = kinv + t[k, ri].T @ t[k, rj]
    r2 = torch.clamp(sqn[ri, None] + sqn[None, rj] - 2.0 * (x[ri] @ x[rj].T),
                     min=0.0)
    km, nm = _km_nm(r2, sv, kfam)
    if valid is not None:
      pr = valid[ri, None] * valid[None, rj]
      km, nm = km * pr, nm * pr
    g = 0.5 * kinv - 0.5 * (alpha[ri] @ alpha[rj].T)
    w = g * nm
    p_part[i, j, :wi] = w @ xo[rj]
    if i != j:
      p_part[j, i, :wj] = w.T @ xo[ri]
    gk = torch.sum(g * km)
    s_part[2 * b] = gk if i == j else 2.0 * gk
    s_part[2 * b + 1] = torch.trace(g) if i == j else 0.0
  p = torch.empty((n, f1), **opts)
  for r in range(ns):
    rows = slice(PAIR * r, PAIR * r + tile_width(n, r))
    acc = p_part[r, 0, :tile_width(n, r)]
    for o in range(1, ns):
      acc = acc + p_part[r, o, :tile_width(n, r)]
    p[rows] = acc
  out = _reduce_scalars(s_part)
  return p, out[0], out[1]


def launch_mll_bwd(t: torch.Tensor, x: torch.Tensor, alpha: torch.Tensor,
                   sv: torch.Tensor, kfam: str = 'se',
                   valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Run the Hopper kernel: t (n, n), x (n, d), alpha (n, 1), sv a
  one-element tensor, valid (n,) 0/1 or None; n a multiple of 64."""
  sv = sv.reshape(1)
  _build.check_cuda_f32('launch_mll_bwd', t=t, x=x, alpha=alpha, sv=sv,
                        valid=valid)
  n, d = x.shape
  if t.shape != (n, n) or alpha.shape != (n, 1) or n % TILE or n == 0:
    raise ValueError(f'launch_mll_bwd takes t (n, n), x (n, d), alpha '
                     f'(n, 1) with n a multiple of {TILE}; got '
                     f'{tuple(t.shape)}, {tuple(x.shape)}, '
                     f'{tuple(alpha.shape)}')
  if valid is not None and valid.shape != (n,):
    raise ValueError(f'valid must be ({n},), got {tuple(valid.shape)}')
  ns = -(-n // PAIR)
  p_part = torch.empty((ns, ns, PAIR, d + 1), dtype=torch.float32,
                       device=t.device)
  s_part = torch.empty((ns * (ns + 1),), dtype=torch.float64,
                       device=t.device)
  p = torch.empty((n, d + 1), dtype=torch.float32, device=t.device)
  out = torch.empty((2,), dtype=torch.float32, device=t.device)
  with torch.cuda.device(t.device):
    stream = torch.cuda.current_stream(t.device).cuda_stream
    KERNEL.launch(t.data_ptr(), x.data_ptr(), alpha.data_ptr(),
                  valid.data_ptr() if valid is not None else None,
                  sv.data_ptr(), n, d, KFAM_CODE[kfam], p_part.data_ptr(),
                  s_part.data_ptr(), p.data_ptr(), out.data_ptr(), stream)
  return p, out[0], out[1]


def mll_bwd_fused(t: torch.Tensor, x: torch.Tensor, alpha: torch.Tensor,
                  sv: torch.Tensor, kfam: str = 'se',
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """(P, d_sv_raw, d_da) of the fused NLL from T = L^{-1}.

  P = [W x | W 1] is (n, d + 1); d_sv_raw = sum G o Kf over the full
  matrix (the caller divides by sv); d_da = tr G.
  """
  if t.device.type == 'cuda':
    return launch_mll_bwd(t, x, alpha, sv, kfam, valid)
  if t.device.type == 'cpu':
    return mll_bwd_plain(t, x, alpha, sv, kfam, valid)
  raise ValueError(f'mll_bwd_fused runs on cpu or cuda, got {t.device}')
