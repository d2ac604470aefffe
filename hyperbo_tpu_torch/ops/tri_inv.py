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
kernel's algorithm in plain PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from hyperbo_tpu_torch.ops import _build

TILE = 64

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


def tri_inv_levels(l: torch.Tensor, block: int = TILE) -> torch.Tensor:
  """Plain mirror of the kernel's algorithm (tests run it in float64):
  T_jj = D_j (diag_inverses), then, level by level, each merge writes
  T[C, A] = -T_C (L[C, A] T_A), each product skipping the zero triangle
  of its triangular factor one `block` of columns (rows) at a time, as the
  kernel does one block tile at a time."""
  b = block
  t = torch.zeros_like(l)
  for j, d in enumerate(diag_inverses(l, b)):
    t[j * b:(j + 1) * b, j * b:(j + 1) * b] = d
  for level in merges(l.shape[-1] // b):
    for a0, c0, c1 in level:
      a = slice(a0 * b, c0 * b)
      c = slice(c0 * b, c1 * b)
      l_ca, t_a, t_c = l[c, a], t[a, a], t[c, c]
      w = torch.cat([l_ca[:, k:] @ t_a[k:, k:k + b]
                     for k in range(0, t_a.shape[0], b)], dim=1)
      t[c, a] = -torch.cat([t_c[r:r + b, :r + b] @ w[:r + b]
                            for r in range(0, t_c.shape[0], b)])
  return t


def scratch_floats(n: int) -> int:
  """Floats of the kernel's scratch: the largest level's W = L[C, A] T_A
  over all its merges (at most n^2 / 4)."""
  sizes = [sum((c1 - c0) * (c0 - a0) for a0, c0, c1 in level)
           for level in merges(n // TILE)]
  return max(sizes, default=0) * TILE * TILE


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
