"""Triangular inverse T = L^{-1}, kernel K3 (port of
hyperbo_tpu/ops/pallas_triinv.py).

The fused NLL's backward (ops/fused_mll) needs T = L^{-1} of the forward's
factor, then alpha = K^{-1} delta = T^T (T delta) and kernel K4
(ops/mll_bwd) on T. L and T are dense (n, n) lower-triangular tensors, the
layout the forward kernel writes and K4 reads; the TPU's panel-major
(nb, n, B) layout was a DMA choice and has no counterpart here.

`tri_inv` dispatches on the tensor's device: a CUDA tensor goes through
the hand-written Hopper kernel (csrc/tri_inv.cu; block forward
substitution given the diagonal tiles' inverses from `diag_inverses`) or
raises; a CPU tensor goes through the plain PyTorch version `tri_inv_plain`,
the n-RHS triangular solve that the JAX package's CPU default takes
(pallas_mll._tri_inv). There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from hyperbo_tpu_torch.ops import _build

TILE = 64

KERNEL = _build.CudaKernel(
    'tri_inv.cu', 'hyperbo_tri_inv',
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p])


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


def launch_tri_inv(l: torch.Tensor) -> torch.Tensor:
  """Run the Hopper kernel on a contiguous float32 CUDA (n, n) factor, n a
  multiple of 64."""
  _build.check_cuda_f32('launch_tri_inv', l=l)
  n = l.shape[-1]
  if l.shape != (n, n) or n == 0 or n % TILE:
    raise ValueError(f'launch_tri_inv takes (n, n) with n a multiple of '
                     f'{TILE}, got {tuple(l.shape)}')
  dinv = diag_inverses(l).contiguous()
  t = torch.empty_like(l)
  with torch.cuda.device(l.device):
    stream = torch.cuda.current_stream(l.device).cuda_stream
    KERNEL.launch(l.data_ptr(), dinv.data_ptr(), t.data_ptr(), n, stream)
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
