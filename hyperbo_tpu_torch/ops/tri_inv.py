"""Triangular inverse T = L^{-1}, kernel K3 (port of
hyperbo_tpu/ops/pallas_triinv.py).

The fused NLL's backward (ops/fused_mll) needs T = L^{-1} of the forward's
factor, then alpha = K^{-1} delta = T^T (T delta) and kernel K4
(ops/mll_bwd) on T. L and T are dense (n, n) lower-triangular tensors, the
layout the forward kernel writes and K4 reads; the TPU's panel-major
(nb, n, B) layout was a DMA choice and has no counterpart here.

`tri_inv` dispatches on the tensor's device: a CUDA tensor goes through
the hand-written Hopper kernel (csrc/tri_inv.cu: the recursive 2 x 2 block
inverse run level by level, `merges`, on tiled FP32 products, given the
diagonal tiles' inverses from `diag_inverses`) or raises; a CPU tensor goes
through the plain PyTorch version `tri_inv_plain`, the n-RHS triangular
solve that the JAX package's CPU default takes (pallas_mll._tri_inv).
There is no fallback from one to the other. `tri_inv_levels` is the
kernel's algorithm in plain PyTorch, for the tests: `level_products`, the
block tiles of each level in the kernel's order, each run by
`apply_product`. The joint backward's mirror (ops/bwd_joint) runs the same
products.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

from hyperbo_tpu_torch.ops import _build

TILE = 64
# csrc/tri_inv_core.cuh kBigHalf: merges of halves at least this many tiles
# wide use block tiles of 2 x 2 tiles.
BIG_HALF = 8

KERNEL = _build.CudaKernel(
    'tri_inv.cu', 'hyperbo_tri_inv',
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_void_p])


def tri_inv_plain(l: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch L^{-1} (any device, float32 or float64)."""
  eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
  return torch.linalg.solve_triangular(l, eye, upper=False)


def diag_inverses(l: torch.Tensor, block: int = TILE) -> torch.Tensor:
  """(nb, block, block) inverses of L's diagonal tiles: one batched
  triangular solve, O(n block^2)."""
  nb = l.shape[-1] // block
  diag = torch.diagonal(l.reshape(nb, block, nb, block), dim1=0,
                        dim2=2).permute(2, 0, 1)
  eye = torch.eye(block, dtype=l.dtype, device=l.device).expand_as(diag)
  return torch.tril(torch.linalg.solve_triangular(diag, eye, upper=False))


def merges(nb: int) -> List[List[Tuple[int, int, int]]]:
  """The kernel's level schedule over nb diagonal tiles: one list per level
  l = 1, 2, ... (run in order), of the merges (a0, c0, c1) in tiles. A
  merge joins the inverted ranges A = [a0, c0) and C = [c0, c1): the
  aligned range [a0, a0 + 2^l) clipped to nb, when its right half C is not
  empty."""
  levels = []
  half = 1
  while half < nb:
    levels.append([(s, s + half, min(s + 2 * half, nb))
                   for s in range(0, nb - half, 2 * half)])
    half *= 2
  return levels


class Product(NamedTuple):
  """One block tile of a level's products (csrc/tri_inv_core.cuh), in
  elements of its merge (a0, c0, c1) (in tiles: A = [a0, c0), C = [c0, c1)):

    'w'  W[rows, cols] = L[C, A][rows, ks] @ T_A[ks, cols]
    't'  T[C, A][rows, cols] = -T_C[rows, ks] @ W[ks, cols]

  W of merge z is the row-major (|C|, |A|) block of the scratch at
  w_base."""
  kind: str
  merge: Tuple[int, int, int]
  z: int
  w_base: int
  rows: Tuple[int, int]
  cols: Tuple[int, int]
  ks: Tuple[int, int]


def level_products(nb: int, block: int = TILE
                   ) -> List[Tuple[List[Product], List[Product]]]:
  """Per level (run in order): its W tiles, then its T tiles, each in the
  kernel's block order (heaviest first; W by row tile, then column tile,
  then merge; T by column tile, then row tile from the last, then merge).
  Block tiles are 2 x 2 tiles where the half is at least BIG_HALF tiles,
  one tile below; a row tile past C's last row has no product."""
  levels = []
  for level in merges(nb):
    half = level[0][1] - level[0][0]
    bm = 2 * block if half >= BIG_HALF else block
    width = half * block
    rows, cols = -(-width // bm), width // bm
    w_items, t_items = [], []
    for z, merge in enumerate(level):
      m = (merge[2] - merge[1]) * block
      base = z * width * width
      for y in range(cols):
        for x in range(rows):
          if x * bm < m:
            w_items.append(Product(
                'w', merge, z, base, (x * bm, min(x * bm + bm, m)),
                (y * bm, y * bm + bm), (y * bm, width)))
      for y in range(rows):
        r0 = (rows - 1 - y) * bm
        for x in range(cols):
          if r0 < m:
            r1 = min(r0 + bm, m)
            t_items.append(Product('t', merge, z, base, (r0, r1),
                                   (x * bm, x * bm + bm), (0, r1)))
    levels.append((w_items, t_items))
  return levels


def apply_product(l: torch.Tensor, t: torch.Tensor, w: torch.Tensor,
                  p: Product, block: int = TILE):
  """Runs one block tile p on L, T (updated in place) and the flat W
  scratch w (tiles of `block` rows)."""
  a0, c0, c1 = (v * block for v in p.merge)
  wz = w[p.w_base:p.w_base + (c1 - c0) * (c0 - a0)].view(c1 - c0, c0 - a0)
  (r0, r1), (q0, q1), (k0, k1) = p.rows, p.cols, p.ks
  if p.kind == 'w':
    wz[r0:r1, q0:q1] = (l[c0 + r0:c0 + r1, a0 + k0:a0 + k1] @
                        t[a0 + k0:a0 + k1, a0 + q0:a0 + q1])
  else:
    t[c0 + r0:c0 + r1, a0 + q0:a0 + q1] = -(
        t[c0 + r0:c0 + r1, c0 + k0:c0 + k1] @ wz[k0:k1, q0:q1])


def tri_inv_levels(l: torch.Tensor, block: int = TILE) -> torch.Tensor:
  """Plain mirror of the kernel's algorithm (tests run it in float64):
  T_jj = D_j (diag_inverses), zeros elsewhere, then each level's W tiles
  and T tiles (level_products), each product skipping the zero triangle
  of its triangular factor by its k range, as the kernel does."""
  b = block
  n = l.shape[-1]
  t = torch.zeros_like(l)
  for j, d in enumerate(diag_inverses(l, b)):
    t[j * b:(j + 1) * b, j * b:(j + 1) * b] = d
  w = torch.empty(scratch_floats(n, b), dtype=l.dtype, device=l.device)
  for w_items, t_items in level_products(n // b, b):
    for p in w_items + t_items:
      apply_product(l, t, w, p, b)
  return t


def scratch_floats(n: int, block: int = TILE) -> int:
  """Floats of the kernel's scratch: the largest level's W = L[C, A] T_A
  over all its merges (at most n^2 / 4)."""
  sizes = [sum((c1 - c0) * (c0 - a0) for a0, c0, c1 in level)
           for level in merges(n // block)]
  return max(sizes, default=0) * block * block


def launch_tri_inv(l: torch.Tensor) -> torch.Tensor:
  """Run the Hopper kernel on a contiguous float32 CUDA (n, n) factor, n a
  multiple of 64: one call of its C entry point, which enqueues every
  level on the current stream."""
  _build.check_cuda_f32('launch_tri_inv', l=l)
  n = l.shape[-1]
  if l.shape != (n, n) or n == 0 or n % TILE:
    raise ValueError(f'launch_tri_inv takes (n, n) with n a multiple of '
                     f'{TILE}, got {tuple(l.shape)}')
  dinv = diag_inverses(l).contiguous()
  t = torch.empty_like(l)
  scratch = torch.empty(scratch_floats(n), dtype=l.dtype, device=l.device)
  with torch.cuda.device(l.device):
    stream = torch.cuda.current_stream(l.device).cuda_stream
    KERNEL.launch(l.data_ptr(), dinv.data_ptr(), t.data_ptr(),
                  scratch.data_ptr(), n, stream)
  return t


def tri_inv(l: torch.Tensor) -> torch.Tensor:
  """T = L^{-1} of a lower-triangular (n, n) factor. A NaN in L gives NaN
  in T (the non-PD poison of the fused forward propagates)."""
  if l.device.type == 'cuda':
    return launch_tri_inv(l)
  if l.device.type == 'cpu':
    return tri_inv_plain(l)
  raise ValueError(f'tri_inv runs on cpu or cuda, got {l.device}')


def alpha_from_inverse(t: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
  """alpha = K^{-1} delta = T^T (T delta): two O(n^2) products."""
  return t.T @ (t @ delta)
