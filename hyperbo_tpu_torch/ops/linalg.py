"""Dense linear algebra for GP inference (port of hyperbo_tpu/ops/linalg.py).

The GP system (K + sigma^2 I) v = y - mu and its factorization, the SPD
inverse-vector product with the JAX package's custom VJP (a
torch.autograd.Function here), the SVD square root of a PSD matrix, and the
square root with a clamped gradient at 0. Every factorization goes through
ops/chol.cholesky and so takes its opt-in routes. `tri_inv_blocked` is
the inverse the on-device BO loops refactor with (bo/ondevice.py); the
fused backward runs kernel K3 (ops/tri_inv.py) instead.
"""

from __future__ import annotations

import os

import torch

from hyperbo_tpu_torch.core.warp import retrieve_params
from hyperbo_tpu_torch.ops import chol as chol_ops


def solve_linear_system(coeff, b):
  """Solve Ax = b with A = coeff SPD. Returns (chol, x)."""
  chol = chol_ops.cholesky(coeff)
  kinvy = inverse_spdmatrix_vector_product(coeff, b, cached_cholesky=chol)
  return chol, kinvy


def svd_matrix_sqrt(cov, jit_safe: bool = False):
  """Square root of a PSD matrix via SVD with rank truncation.

  Returns A with A A^T = cov. With jit_safe False (the reference), columns
  beyond the numerical rank are dropped; with True they are zeroed instead,
  so the result keeps the shape of cov.
  """
  u, s, _ = torch.linalg.svd(cov)
  factor = u * torch.sqrt(torch.clamp(s, min=0.0))[..., None, :]
  tol = (s.max() * torch.finfo(s.dtype).eps / 2. *
         (2 * cov.shape[0] + 1.) ** 0.5)
  if jit_safe:
    return factor * (s > tol).to(factor.dtype)[None, :]
  rank = int(torch.count_nonzero(s > tol))
  return factor[:, :rank]


def cholesky_cache(spd_matrix, cached_cholesky):
  """Cholesky factor of `spd_matrix` unless one is already given."""
  if cached_cholesky is not None:
    return cached_cholesky
  return chol_ops.cholesky(spd_matrix)


class _InverseSpdVectorProduct(torch.autograd.Function):
  """K^{-1} x from K's factor, with the JAX package's VJP: for a cotangent
  g, grad_K = -(K^{-1} g)(K^{-1} x)^T and grad_x = K^{-1} g. The factor
  gets no gradient (the JAX VJP returns None for it)."""

  @staticmethod
  def forward(ctx, spd_matrix, x, chol):
    out = chol_ops.cho_solve(chol, x)
    ctx.save_for_backward(chol, out)
    return out

  @staticmethod
  def backward(ctx, g):
    chol, out = ctx.saved_tensors
    ginv = chol_ops.cho_solve(chol, g)
    # Shape-aware: n-vector and n x m right-hand sides alike.
    a = out[:, None] if out.ndim == 1 else out
    b = ginv[:, None] if ginv.ndim == 1 else ginv
    return -torch.matmul(b, a.T), ginv, None


def inverse_spdmatrix_vector_product(spd_matrix, x, cached_cholesky=None):
  """spd_matrix^{-1} x for SPD spd_matrix (n, n) and x (n,) or (n, m).

  The backward costs two triangular solves against the forward's factor
  instead of differentiating through the factorization.
  """
  chol = cholesky_cache(spd_matrix, cached_cholesky)
  return _InverseSpdVectorProduct.apply(spd_matrix, x, chol)


class _SafeSqrt(torch.autograd.Function):
  """sqrt whose gradient at 0 is 1e6 instead of inf (the reference's
  _safe_sqrt)."""

  @staticmethod
  def forward(ctx, x):
    out = torch.sqrt(x)
    ctx.save_for_backward(x, out)
    return out

  @staticmethod
  def backward(ctx, g):
    x, out = ctx.saved_tensors
    return torch.where(x != 0., g * 0.5 / out, torch.full_like(x, 1e6))


def safe_sqrt(x):
  return _SafeSqrt.apply(x)


def safe_l2norm(x):
  """L2 norm of x without a NaN gradient at 0."""
  return safe_sqrt(torch.sum(x**2))


def tri_inv_blocked(l: torch.Tensor, block: int = 512) -> torch.Tensor:
  """L^{-1} for lower-triangular L (n x n) by the top-down recursion

    [[A, 0], [B, C]]^{-1} = [[A^{-1}, 0], [-C^{-1} B A^{-1}, C^{-1}]]:

  a triangular solve against the identity at or below `block`, products
  above it, split at half of n rounded up to a multiple of `block`.

  HYPERBO_TRIINV_DOUBLING=1 selects the JAX package's bottom-up batched
  variant, a probe of one TPU toolchain that the port does not have; it
  raises rather than run the recursion in its place.
  """
  if os.environ.get('HYPERBO_TRIINV_DOUBLING', '0') == '1':
    raise NotImplementedError(
        'HYPERBO_TRIINV_DOUBLING=1 (the bottom-up batched inverse) is not '
        'ported: see ROADMAP Queue C')
  n = l.shape[-1]
  if n <= block:
    eye = torch.eye(n, dtype=l.dtype, device=l.device)
    return torch.linalg.solve_triangular(l, eye, upper=False)
  m = (n // 2 + block - 1) // block * block
  if m >= n:
    m = n // 2
  a_inv = tri_inv_blocked(l[:m, :m], block)
  c_inv = tri_inv_blocked(l[m:, m:], block)
  off = -torch.matmul(c_inv, torch.matmul(l[m:, :m], a_inv))
  top = torch.cat([a_inv, l.new_zeros((m, n - m))], dim=1)
  return torch.cat([top, torch.cat([off, c_inv], dim=1)], dim=0)


def compute_delta_y_and_cov(mean_func,
                            cov_func,
                            params,
                            x,
                            y,
                            warp_func=None,
                            eps=1e-6):
  """Compute y - mu(x) and cov(x, x) + I * (noise_variance + eps)."""
  y = y - torch.atleast_2d(mean_func(params, x, warp_func=warp_func))
  noise_variance, = retrieve_params(
      params, ['noise_variance'], warp_func=warp_func)
  eye = torch.eye(x.shape[-2], dtype=y.dtype, device=y.device)
  cov = cov_func(params, x, warp_func=warp_func) + eye * (
      noise_variance + eps)
  return y, cov


def solve_gp_linear_system(mean_func,
                           cov_func,
                           params,
                           x,
                           y,
                           warp_func=None,
                           eps=1e-6):
  """Solve the GP linear system (K + sigma^2 I) v = y - mu(x).

  Returns:
    chol: lower Cholesky factor of K + (noise_variance + eps) I.
    kinvy: K^{-1} (y - mu).
    y: y with the mean subtracted.
  """
  y, cov = compute_delta_y_and_cov(
      mean_func, cov_func, params, x, y, warp_func, eps)
  chol, kinvy = solve_linear_system(cov, y)
  return chol, kinvy, y
