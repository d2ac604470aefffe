"""Cholesky of small SPD matrices (n <= 512), kernel K7 (port of
hyperbo_tpu/ops/pallas_chol.py).

`ops/chol.py` routes its base cases here when `set_use_pallas_base(True)` is
set: directly for n <= 512, and as the base case of the blocked recursion
(`set_use_recursive`). Every matrix is symmetrized as 0.5 (A + A^T) first,
as both Pallas kernels do.

The wrappers dispatch on the tensor's device: a CUDA tensor goes through
the hand-written Hopper kernel (csrc/chol_panel.cu: one block a matrix,
64-wide left-looking panels in shared memory) or raises; a CPU tensor goes
through the plain PyTorch version `cholesky_panel_plain`. There is no
fallback from one to the other. The three JAX entry points compute the
same factor and share the one kernel here: the Hopper kernel takes any
n <= 512, so `cholesky_panel_padded` needs no identity padding, and
`cholesky_panel_blocked` keeps only its shape check. Every entry point takes
a batch (..., n, n). The route of ops/chol.py calls `cholesky_panel`.

A matrix that is not positive definite comes out NaN, on both versions (the
TPU kernels clamp the pivot and return finite garbage instead).
"""

from __future__ import annotations

import ctypes

import torch

from hyperbo_tpu_torch.ops import _build
from hyperbo_tpu_torch.ops.chol import plain_cholesky, poison_non_pd

MAX_N = 512

KERNEL = _build.CudaKernel(
    'chol_panel.cu', 'hyperbo_chol_panel',
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p])


def cholesky_panel_plain(a: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch factor of 0.5 (A + A^T) (any device, float32 or
  float64); NaN where not positive definite."""
  return plain_cholesky(0.5 * (a + a.transpose(-1, -2)))


def launch_chol_panel(a: torch.Tensor) -> torch.Tensor:
  """Run the Hopper kernel on a contiguous float32 CUDA batch (..., n, n),
  n <= 512."""
  _build.check_cuda_f32('launch_chol_panel', a=a)
  n = a.shape[-1]
  if a.ndim < 2 or a.shape[-2] != n or not 1 <= n <= MAX_N:
    raise ValueError(f'launch_chol_panel takes (..., n, n) with 1 <= n <= '
                     f'{MAX_N}, got {tuple(a.shape)}')
  out = torch.empty_like(a)
  batch = a.numel() // (n * n)
  if batch == 0:
    return out
  with torch.cuda.device(a.device):
    stream = torch.cuda.current_stream(a.device).cuda_stream
    KERNEL.launch(a.data_ptr(), out.data_ptr(), n, batch, stream)
  return poison_non_pd(out)


def cholesky_panel(a: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky factor of SPD matrices (..., n, n), n <= 512."""
  if a.shape[-1] > MAX_N:
    raise ValueError(f'cholesky_panel takes n <= {MAX_N}, got '
                     f'{a.shape[-1]}')
  if a.device.type == 'cuda':
    return launch_chol_panel(a)
  if a.device.type == 'cpu':
    return cholesky_panel_plain(a)
  raise ValueError(f'cholesky_panel runs on cpu or cuda, got {a.device}')


def cholesky_panel_blocked(a: torch.Tensor,
                           block_width: int = 128) -> torch.Tensor:
  """`cholesky_panel` with the JAX kernel's shape check: the TPU's
  left-looking sweep covers only whole panels of `block_width` columns."""
  n = a.shape[-1]
  if n % block_width:
    raise ValueError(
        f'cholesky_panel_blocked needs n % block_width == 0, got n={n}, '
        f'block_width={block_width}; use cholesky_panel_padded or '
        'cholesky_panel.')
  return cholesky_panel(a)


def cholesky_panel_padded(a: torch.Tensor) -> torch.Tensor:
  """`cholesky_panel` of any n <= 512. The TPU kernel padded n up to a
  multiple of 128 (`pad_to`) with an identity block; the factor of that
  padded matrix restricted to [:n, :n] is the factor of `a`, which the
  Hopper kernel computes directly."""
  return cholesky_panel(a)
