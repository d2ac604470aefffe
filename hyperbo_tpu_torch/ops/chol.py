"""Cholesky factorization and triangular solves (port of
hyperbo_tpu/ops/chol.py).

`cholesky` keeps the JAX package's failure contract: lax.linalg.cholesky
returns NaN for a matrix that is not positive definite, and the trainer's
NaN-freeze (train/adam.py) relies on that. torch.linalg.cholesky raises
instead, so this uses torch.linalg.cholesky_ex and fills every batch entry
whose factorization failed with NaN. Every route below keeps the same
contract (where the TPU kernels clamp the pivot and return finite garbage).

Three opt-in routes, as in the JAX module, off by default and taken in its
order of precedence:
  * set_use_hbm_kernel: n >= 1024 with n % 512 == 0 goes through kernel K6
    (ops/chol_hbm.py);
  * set_use_recursive: n > base_block goes through the explicit 2 x 2 block
    recursion `_blocked_cholesky`, whose Schur products are torch.matmul in
    full float32 (the package pins TF32 off);
  * set_use_pallas_base: the base cases (n <= 512, directly or inside the
    recursion) go through kernel K7 (ops/chol_panel.py).
The JAX module applies them to one matrix (a.ndim == 2), which is what each
matrix of its vmapped callers is; here the same n conditions apply to every
matrix of a (..., n, n) batch, and the kernels take the batch.

A routed factor is forward-only, as in the JAX package, where jax.grad
through the Pallas kernels fails: asking for its gradient raises
NotImplementedError. The default route (all off) stays differentiable.
`set_schur_precision` picks an XLA dot algorithm for the Schur products;
it has no counterpart here, where every float32 product is full float32.
"""

from __future__ import annotations

import torch

# Below this size, the base-case factorization is used directly.
_BASE_BLOCK = 512

_USE_PALLAS_BASE = False
_USE_RECURSIVE = False
_USE_HBM_KERNEL = False


def set_use_pallas_base(value: bool):
  """Route base-case factorizations (n <= 512) through kernel K7."""
  global _USE_PALLAS_BASE
  _USE_PALLAS_BASE = bool(value)


def set_use_recursive(value: bool):
  """Route large factorizations through the explicit blocked recursion."""
  global _USE_RECURSIVE
  _USE_RECURSIVE = bool(value)


def set_use_hbm_kernel(value: bool):
  """Route large factorizations (n >= 1024, n % 512 == 0) through kernel
  K6."""
  global _USE_HBM_KERNEL
  _USE_HBM_KERNEL = bool(value)


def plain_cholesky(a: torch.Tensor) -> torch.Tensor:
  """torch.linalg.cholesky_ex, NaN for every matrix whose factorization
  failed (the plain version of every route)."""
  chol, info = torch.linalg.cholesky_ex(a)
  failed = (info != 0)[..., None, None]
  return torch.where(failed, torch.full_like(chol, float('nan')), chol)


def poison_non_pd(chol: torch.Tensor) -> torch.Tensor:
  """NaN for every matrix of the batch whose factor has a diagonal entry
  that is not > 0: a failed pivot (negative, zero or NaN) of a kernel, or
  a failed block of the recursion."""
  diag = torch.diagonal(chol, dim1=-2, dim2=-1)
  bad = ~(diag > 0).all(dim=-1)
  return torch.where(bad[..., None, None],
                     torch.full_like(chol, float('nan')), chol)


def _base_cholesky(a: torch.Tensor) -> torch.Tensor:
  from hyperbo_tpu_torch.ops import chol_panel
  if _USE_PALLAS_BASE and a.shape[-1] <= chol_panel.MAX_N:
    # The kernels take contiguous tensors; the recursion's blocks are views.
    return chol_panel.cholesky_panel(a.contiguous())
  return plain_cholesky(a)


def _blocked_cholesky(a: torch.Tensor, base_block: int = _BASE_BLOCK
                      ) -> torch.Tensor:
  """Recursive blocked Cholesky; `a` is (..., n, n) SPD, returns lower L."""
  n = a.shape[-1]
  # The split point is always >= 128, so recursion needs n > 256.
  if n <= max(base_block, 256):
    return _base_cholesky(a)
  # Split point: half, rounded down to a multiple of 128.
  k = max(128, (n // 2 // 128) * 128)
  l11 = _blocked_cholesky(a[..., :k, :k], base_block)
  # L21 L11^T = A21: a right-side solve against L11^T.
  l21 = torch.linalg.solve_triangular(
      l11.transpose(-1, -2), a[..., k:, :k], upper=True, left=False)
  s22 = a[..., k:, k:] - torch.matmul(l21, l21.transpose(-1, -2))
  l22 = _blocked_cholesky(s22, base_block)
  top = torch.cat([l11, l11.new_zeros(a.shape[:-2] + (k, n - k))], dim=-1)
  return torch.cat([top, torch.cat([l21, l22], dim=-1)], dim=-2)


class _ForwardOnly(torch.autograd.Function):
  """The factor of a route, with a backward that fails loudly."""

  @staticmethod
  def forward(ctx, a, route):
    return poison_non_pd(route(a.contiguous()))

  @staticmethod
  def backward(ctx, grad):
    raise NotImplementedError(
        'the Cholesky routes of set_use_hbm_kernel, set_use_recursive and '
        'set_use_pallas_base are forward-only: turn them off to '
        'differentiate through the factorization')


def cholesky(a: torch.Tensor, base_block: int = _BASE_BLOCK) -> torch.Tensor:
  """Lower Cholesky factor of SPD matrices (..., n, n); NaN where not PD."""
  # The kernels' modules import this one, so they are imported here.
  from hyperbo_tpu_torch.ops import chol_hbm, chol_panel
  n = a.shape[-1]
  if _USE_HBM_KERNEL and n >= 1024 and n % 512 == 0:
    return _ForwardOnly.apply(a, chol_hbm.cholesky_hbm)
  if _USE_RECURSIVE and n > base_block:
    return _ForwardOnly.apply(
        a, lambda m: _blocked_cholesky(m, base_block))
  if _USE_PALLAS_BASE and n <= chol_panel.MAX_N:
    return _ForwardOnly.apply(a, chol_panel.cholesky_panel)
  return plain_cholesky(a)


def logdet_from_chol(chol: torch.Tensor) -> torch.Tensor:
  """log det K = 2 sum log diag L."""
  return 2.0 * torch.sum(
      torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)


def solve_triangular(a: torch.Tensor,
                     b: torch.Tensor,
                     lower: bool = True,
                     trans: int = 0) -> torch.Tensor:
  """Solve a x = b (trans=0) or a^T x = b (trans=1) with triangular a.

  b may be a matrix (..., n, k) or a vector (..., n).
  """
  vector = b.ndim == a.ndim - 1
  b2 = b[..., None] if vector else b
  if trans:
    out = torch.linalg.solve_triangular(a.transpose(-1, -2), b2,
                                        upper=lower)
  else:
    out = torch.linalg.solve_triangular(a, b2, upper=not lower)
  return out[..., 0] if vector else out


def cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve K x = b given the lower Cholesky factor of K."""
  z = solve_triangular(chol, b, lower=True, trans=0)
  return solve_triangular(chol, z, lower=True, trans=1)


def chol_append(chol: torch.Tensor, k_vec: torch.Tensor,
                kappa: torch.Tensor) -> torch.Tensor:
  """Grow a Cholesky factor by one row and column in O(n^2).

  Given L with L L^T = K (n x n), the factor of [[K, k], [k^T, kappa]] is
  [[L, 0], [w^T, sqrt(kappa - w^T w)]] with w = L^{-1} k. `k_vec` is an
  n-vector (or n x 1) and `kappa` the scalar self covariance (noise and
  jitter included). Returns the (n + 1) x (n + 1) factor.
  """
  n = chol.shape[-1]
  w = solve_triangular(chol, k_vec.reshape(n), lower=True, trans=0)
  d = torch.sqrt(torch.clamp(kappa - torch.dot(w, w), min=1e-12))
  top = torch.cat([chol, chol.new_zeros((n, 1))], dim=1)
  bottom = torch.cat([w, d.reshape(1)])[None, :]
  return torch.cat([top, bottom], dim=0)


def _write_row(buf: torch.Tensor, num_obs, row: torch.Tensor
               ) -> torch.Tensor:
  """A copy of `buf` with row num_obs replaced by `row`. num_obs may be a
  Python int or a 0-d tensor on buf's device: the row is picked by a mask,
  so nothing is read back to the host."""
  idx = torch.arange(buf.shape[-1], device=buf.device)
  return torch.where((idx == num_obs)[:, None], row[None, :], buf)


def chol_append_padded(chol_buf: torch.Tensor, num_obs,
                       k_vec: torch.Tensor,
                       kappa: torch.Tensor) -> torch.Tensor:
  """Rank-1 append into a preallocated max-size factor.

  `chol_buf` is N x N holding a valid num_obs x num_obs factor in its top
  left corner, with ones on the diagonal of the unused part (so triangular
  solves against the full buffer are well defined). `k_vec` is an N-vector
  whose first num_obs entries are the cross covariances (the rest are
  ignored). num_obs is a Python int or a 0-d tensor on the buffer's device
  (no host read either way). Returns a new buffer with row num_obs written.
  """
  n_max = chol_buf.shape[-1]
  idx = torch.arange(n_max, device=chol_buf.device)
  valid = idx < num_obs
  k_masked = torch.where(valid, k_vec.reshape(n_max), 0.0)
  # Rows >= num_obs have identity diagonal and zero right-hand side, so
  # they solve to zeros.
  w = solve_triangular(chol_buf, k_masked, lower=True, trans=0)
  new_row = torch.where(valid, w, 0.0)
  d = torch.sqrt(torch.clamp(kappa - torch.dot(new_row, new_row),
                             min=1e-12))
  new_row = torch.where(idx == num_obs, d, new_row)
  return _write_row(chol_buf, num_obs, new_row)


def winv_append_padded(winv_buf: torch.Tensor, num_obs,
                       k_vec: torch.Tensor,
                       kappa: torch.Tensor) -> torch.Tensor:
  """Rank-1 append of W = L^{-1} in a preallocated buffer: the BO state of
  the on-device loops (bo/ondevice.py), whose posteriors and appends are
  then products only, with no triangular solve. The growth identity:

    [[L, 0], [r^T, l]]^{-1} = [[W, 0], [-(r^T W) / l, 1 / l]],
    r = W k,  l = sqrt(kappa - r^T r).

  The buffer contract is chol_append_padded's: N x N with a valid
  num_obs x num_obs W in the top left corner and an identity diagonal on
  the unused part (W of the identity-padded factor is identity-padded).
  The products run in full float32 (the package pins TF32 off).
  """
  n_max = winv_buf.shape[-1]
  idx = torch.arange(n_max, device=winv_buf.device)
  valid = idx < num_obs
  k_masked = torch.where(valid, k_vec.reshape(n_max), 0.0)
  # r = W k: unused rows of W are identity with a zero right-hand side.
  r = torch.where(valid, torch.matmul(winv_buf, k_masked), 0.0)
  l = torch.sqrt(torch.clamp(kappa - torch.dot(r, r), min=1e-12))
  new_row = torch.where(valid, -torch.matmul(r, winv_buf) / l, 0.0)
  new_row = torch.where(idx == num_obs, 1.0 / l, new_row)
  return _write_row(winv_buf, num_obs, new_row)


def init_chol_buffer(n_max: int, dtype=torch.float32,
                     device='cpu') -> torch.Tensor:
  """Identity-initialized preallocated Cholesky buffer."""
  return torch.eye(n_max, dtype=dtype, device=device)
