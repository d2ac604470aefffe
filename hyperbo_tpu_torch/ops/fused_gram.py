"""Fused Gram matrix, kernel K5 (port of hyperbo_tpu/ops/pallas_gram.py).

`gram` computes the SE / Matern-3/2 / Matern-5/2 Gram matrix of pre-scaled
inputs from one product plus the row norms, with an optional ridge on the
global diagonal; `gram_with_ridge` (K(x, x) + ridge I) and `cross_gram`
(K(x1, x2)) scale and center their inputs first, as the JAX functions do.
As in the JAX package, nothing else calls these functions: the port's GP
builds its Gram matrices in models/kernel.py.

`gram` dispatches on the tensor's device: a CUDA tensor goes through the
hand-written Hopper kernel (csrc/gram.cu) or raises; a CPU tensor goes
through the plain PyTorch version `gram_plain`. There is no fallback from
one to the other. The JAX function's block sizes and `interpret` have no
counterpart.

The kernel is bound by its stores: one block per 128 x 128 output tile,
each warp writing whole 512-byte row segments, a float4 a lane, where the
rows start 16-byte aligned, and the same lanes' four floats one at a time
where they do not; ragged edges are guarded in the kernel, so the (n1, n2)
result needs no padding copy. `gram_store_plan` mirrors that map for the
CPU tests. signal_variance and ridge reach the kernel by value when they
are numbers, and as device pointers when they are CUDA tensors: no call
copies them to the card or waits on it.

The functions are forward-only, as the JAX kernel has no VJP: asking for a
gradient through them raises NotImplementedError.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hyperbo_tpu_torch.ops import _build
from hyperbo_tpu_torch.ops import mll_bwd
from hyperbo_tpu_torch.ops.fused_mll import _gram_transform

KERNEL = _build.CudaKernel(
    'gram.cu', 'hyperbo_gram',
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
     ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 5 +
    [ctypes.c_void_p] * 2)

# csrc/gram.cu's output tile: a block's rows and columns.
TILE_ROWS = 128
TILE_COLS = 128


def gram_plain(x1: torch.Tensor, x2: torch.Tensor, signal_variance, ridge,
               kind: str = 'se', add_ridge: bool = False) -> torch.Tensor:
  """Plain PyTorch Gram matrix (any device, float32 or float64): the
  kernel's distance form, family transform and diagonal ridge."""
  sqn1 = torch.sum(x1 * x1, dim=1)
  sqn2 = torch.sum(x2 * x2, dim=1)
  r2 = torch.clamp(sqn1[:, None] + sqn2[None, :] - 2.0 * (x1 @ x2.T),
                   min=0.0)
  out = _gram_transform(r2, signal_variance, kind)
  if add_ridge:
    out = out + ridge * torch.eye(x1.shape[0], x2.shape[0], dtype=out.dtype,
                                  device=out.device)
  return out


def gram_store_plan(n1: int, n2: int, aligned: bool = True):
  """The stores csrc/gram.cu makes for an (n1, n2) output, as int64 arrays
  (row, col, width): one a lane and row of a block's tile, width 4 for a
  16-byte store of columns col .. col + 3, width 1 for a 4-byte store. The
  16-byte path is taken where every row starts 16-byte aligned: n2 % 4 == 0
  and an `aligned` output pointer."""
  vec = aligned and n2 % 4 == 0
  rows = np.arange(-(-n1 // TILE_ROWS) * TILE_ROWS)   # block row, warp, p
  cols = np.arange(0, -(-n2 // TILE_COLS) * TILE_COLS, 4)  # block col, lane
  r, c = (a.ravel() for a in np.meshgrid(rows, cols, indexing='ij'))
  keep = (r < n1) & (c < n2)
  r, c = r[keep], c[keep]
  if vec:
    return r, c, np.full_like(r, 4)
  r, c = np.repeat(r, 4), (c[:, None] + np.arange(4)).ravel()
  keep = c < n2
  return r[keep], c[keep], np.ones(int(keep.sum()), dtype=r.dtype)


def _scalar_arg(v, name):
  """(device pointer or None, value) for a scalar the kernel takes: a CUDA
  tensor by pointer (read on the card, no host sync), else by value."""
  if isinstance(v, torch.Tensor) and v.device.type == 'cuda':
    if v.numel() != 1:
      raise ValueError(f'launch_gram takes a scalar {name}, got shape '
                       f'{tuple(v.shape)}')
    v = v.detach().to(torch.float32).reshape(()).contiguous()
    return v, 0.0
  return None, float(v)


def launch_gram(x1: torch.Tensor, x2: torch.Tensor, signal_variance, ridge,
                kind: str = 'se', add_ridge: bool = False) -> torch.Tensor:
  """Run the Hopper kernel: x1 (n1, d) and x2 (n2, d) float32 and
  contiguous on one CUDA device; signal_variance and ridge numbers or
  one-element tensors (a CUDA tensor on x1's device)."""
  _build.check_cuda_f32('launch_gram', x1=x1, x2=x2)
  if (x1.ndim != 2 or x2.ndim != 2 or x1.shape[1] != x2.shape[1] or
      x1.shape[1] == 0):
    raise ValueError(f'launch_gram takes x1 (n1, d) and x2 (n2, d) with '
                     f'd >= 1, got {tuple(x1.shape)}, {tuple(x2.shape)}')
  if kind not in mll_bwd.KFAM_CODE:
    raise ValueError(f'unknown fused kernel family: {kind!r}')
  (n1, d), n2 = x1.shape, x2.shape[0]
  out = torch.empty((n1, n2), dtype=torch.float32, device=x1.device)
  if n1 == 0 or n2 == 0:
    return out
  sv_t, sv = _scalar_arg(signal_variance, 'signal_variance')
  ridge_t, ridge = _scalar_arg(ridge, 'ridge')
  for t in (sv_t, ridge_t):
    if t is not None and t.device != x1.device:
      raise ValueError(f'launch_gram: a scalar on {t.device}, inputs on '
                       f'{x1.device}')
  with torch.cuda.device(x1.device):
    stream = torch.cuda.current_stream(x1.device).cuda_stream
    KERNEL.launch(x1.data_ptr(), x2.data_ptr(),
                  None if sv_t is None else sv_t.data_ptr(), sv,
                  None if ridge_t is None else ridge_t.data_ptr(), ridge,
                  n1, n2, d, mll_bwd.KFAM_CODE[kind], int(add_ridge),
                  out.data_ptr(), stream)
  return out


class _ForwardOnly(torch.autograd.Function):
  """The Gram matrix of `gram`, with a backward that fails loudly."""

  @staticmethod
  def forward(ctx, x1, x2, signal_variance, ridge, kind, add_ridge):
    if x1.device.type == 'cuda':
      return launch_gram(x1, x2, signal_variance, ridge, kind, add_ridge)
    if x1.device.type == 'cpu':
      return gram_plain(x1, x2, signal_variance, ridge, kind, add_ridge)
    raise ValueError(f'gram runs on cpu or cuda, got {x1.device}')

  @staticmethod
  def backward(ctx, grad):
    raise NotImplementedError(
        'ops/fused_gram is forward-only, as the JAX kernel has no VJP: '
        'differentiate through models/kernel.py instead')


def gram(x1: torch.Tensor, x2: torch.Tensor, signal_variance, ridge,
         kind: str = 'se', add_ridge: bool = False) -> torch.Tensor:
  """(n1, n2) Gram matrix of inputs already divided by the lengthscale
  (and centered); `ridge` goes on entries whose row equals their column
  when add_ridge."""
  return _ForwardOnly.apply(x1.contiguous(), x2.contiguous(),
                            signal_variance, ridge, kind, add_ridge)


def gram_with_ridge(x: torch.Tensor, lengthscale, signal_variance, ridge,
                    kind: str = 'se') -> torch.Tensor:
  """K(x, x) + ridge I in one pass; x is scaled by the lengthscale and
  centered on its mean here (`ridge` is noise_variance + jitter)."""
  xs = x / lengthscale
  xs = xs - torch.mean(xs, dim=0, keepdim=True)
  return gram(xs, xs, signal_variance, ridge, kind=kind, add_ridge=True)


def cross_gram(x1: torch.Tensor, x2: torch.Tensor, lengthscale,
               signal_variance, kind: str = 'se') -> torch.Tensor:
  """K(x1, x2), scaled by the lengthscale and centered on the pooled mean
  of both inputs here."""
  s1 = x1 / lengthscale
  s2 = x2 / lengthscale
  center = (torch.sum(s1, dim=0, keepdim=True) +
            torch.sum(s2, dim=0, keepdim=True)) / (x1.shape[0] + x2.shape[0])
  return gram(s1 - center, s2 - center, signal_variance, 0.0, kind=kind,
              add_ridge=False)
