"""Blocked Cholesky of dense SPD matrices, kernel K6 (port of
hyperbo_tpu/ops/pallas_chol_hbm.py).

`ops/chol.py` routes a factorization here when `set_use_hbm_kernel(True)`
is set and n >= 1024 with n % 512 == 0. Only the lower triangle of the
input is read, as LAPACK's potrf reads it.

`cholesky_hbm` dispatches on the tensor's device: a CUDA tensor goes
through the hand-written Hopper kernel (csrc/chol_hbm.cu: the 64-wide
right-looking factorization of kernel K2, csrc/chol_core.cuh, on a batch
of matrices) or raises; a CPU tensor goes through the plain PyTorch version
`cholesky_hbm_plain`. There is no fallback from one to the other.

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

import ctypes

import torch

from hyperbo_tpu_torch.ops import _build
from hyperbo_tpu_torch.ops.chol import plain_cholesky, poison_non_pd

TILE = 64

KERNEL = _build.CudaKernel(
    'chol_hbm.cu', 'hyperbo_chol_hbm',
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p])


def cholesky_hbm_plain(a: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch factor of the symmetric matrix that A's lower triangle
  defines (any device, float32 or float64); NaN where not positive
  definite."""
  return plain_cholesky(torch.tril(a) + torch.tril(a, -1).transpose(-1, -2))


def launch_chol_hbm(a: torch.Tensor) -> torch.Tensor:
  """Run the Hopper kernel on a contiguous float32 CUDA batch (..., n, n),
  n a multiple of 64."""
  _build.check_cuda_f32('launch_chol_hbm', a=a)
  n = a.shape[-1]
  if a.ndim < 2 or a.shape[-2] != n or n == 0 or n % TILE:
    raise ValueError(f'launch_chol_hbm takes (..., n, n) with n a multiple '
                     f'of {TILE}, got {tuple(a.shape)}')
  out = torch.empty_like(a)
  batch = a.numel() // (n * n)
  if batch == 0:
    return out
  dinv = torch.empty((batch, TILE, TILE), dtype=torch.float32,
                     device=a.device)
  with torch.cuda.device(a.device):
    stream = torch.cuda.current_stream(a.device).cuda_stream
    KERNEL.launch(a.data_ptr(), out.data_ptr(), dinv.data_ptr(), n, batch,
                  stream)
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
