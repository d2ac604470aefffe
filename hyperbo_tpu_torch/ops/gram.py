"""Gram (kernel) matrix construction (port of hyperbo_tpu/ops/gram.py).

Pairwise squared distances as one matmul plus row norms,

    ||a - b||^2 = ||a||^2 + ||b||^2 - 2 a.b,

on inputs centered first so the cancellation error stays small for tiny
lengthscales. The JAX package leaves this to XLA; here it is plain
torch.matmul, which runs in full float32 (the package pins TF32 off).
Every function takes leading batch dimensions: (..., n, d) inputs give
(..., n1, n2) outputs, so the packed multi-task objectives call them on
all tasks at once.
"""

from __future__ import annotations

from typing import Optional

import torch


def sqdist(x1: torch.Tensor, x2: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
  """Pairwise squared Euclidean distances, (..., n1, n2).

  With x2 None (x2 = x1) the diagonal is exactly zero. Clamped to >= 0.
  """
  symmetric = x2 is None
  if symmetric:
    x1c = x1 - x1.mean(dim=-2, keepdim=True)
    x2c = x1c
  else:
    # Center by the pooled mean: translation leaves distances unchanged but
    # shrinks the norms whose difference the matmul form computes.
    denom = max(x1.shape[-2] + x2.shape[-2], 1)
    center = (x1.sum(dim=-2, keepdim=True) +
              x2.sum(dim=-2, keepdim=True)) / denom
    x1c = x1 - center
    x2c = x2 - center
  r1 = (x1c * x1c).sum(dim=-1)[..., :, None]
  r2 = (r1.transpose(-1, -2) if symmetric
        else (x2c * x2c).sum(dim=-1)[..., None, :])
  inner = torch.matmul(x1c, x2c.transpose(-1, -2))
  d2 = torch.clamp(r1 + r2 - 2.0 * inner, min=0.0)
  if symmetric:
    n = x1.shape[-2]
    d2 = d2 * (1.0 - torch.eye(n, dtype=d2.dtype, device=d2.device))
  return d2


def sqdist_direct(x1: torch.Tensor, x2: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
  """Exact elementwise pairwise squared distances, (..., n1, n2), with
  O(n1 n2 d) memory: the numerical oracle of the tests."""
  if x2 is None:
    x2 = x1
  diff = x1[..., :, None, :] - x2[..., None, :, :]
  return torch.sum(diff * diff, dim=-1)


def inner_product(x1: torch.Tensor, x2: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
  """Pairwise inner products x1 @ x2^T, (..., n1, n2)."""
  if x2 is None:
    x2 = x1
  return torch.matmul(x1, x2.transpose(-1, -2))
