"""Fused GP marginal likelihood for large n, kernel K2 and its custom
backward (port of hyperbo_tpu/ops/pallas_mll.py: the route, the wrappers
and the differentiable core).

For scaled inputs x (n, d) and delta = y - mu (n, 1) the forward computes

    K = sv k(|x_i - x_j|^2) + da I,   L = chol(K),   z = L^{-1} delta,
    nll_core = |z|^2 / 2 + sum_j log L_jj

in one call (`mll_fused`: Gram tiles generated on the device, blocked
Cholesky, forward solve and log-determinant), for the SE, Matern-3/2 and
Matern-5/2 families. The backward is the JAX package's closed form
(_se_core_bwd) from the saved factor: T = L^{-1} (ops/tri_inv, kernel K3),
alpha = T^T (T delta), then P = [W x | W 1], d_sv_raw and d_da from kernel
K4 (ops/mll_bwd), and

    d_x = 2 [(W x) - (W 1) o x],   d_delta = alpha,
    d_sv = d_sv_raw / sv,          d_da = tr G.

With HYPERBO_BWD_JOINT=1 in the environment (read at each backward) and
d + 2 <= 127 (the JAX package's condition), the backward instead computes
all of this in one call of ops/bwd_joint (kernel K8), as the JAX package's
_se_core_bwd does under the same variable. Unset or '0' leaves it off; any
other value raises.

Every wrapper dispatches on the tensor's device: a CUDA tensor launches the
hand-written Hopper kernel (csrc/fused_mll.cu, csrc/tri_inv.cu,
csrc/mll_bwd.cu, csrc/bwd_joint.cu) or raises; a CPU tensor runs the plain
PyTorch version. There is no fallback from one to the other, and no switch
besides the device and HYPERBO_BWD_JOINT: config['fused_mll'] takes True,
False or None, and the JAX package's 'interpret' raises. The Mosaic tuning
knobs of the JAX module (block, half, group, pivot modes, the other
HYPERBO_* variables, the 128-lane feature limit) have no counterpart.

Padded rows (a `valid` mask) are exact: the kernels zero every Gram entry
touching a padded row and keep its diagonal at da, and the wrapper removes
the padded rows' log(da)/2 from the log-determinant. A task whose n is not
a multiple of the kernels' 64-row tile is padded up to one this way.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional, Tuple

import torch

from hyperbo_tpu_torch.core.warp import retrieve_params
from hyperbo_tpu_torch.models import basis as bf
from hyperbo_tpu_torch.ops import _build
from hyperbo_tpu_torch.ops import bwd_joint
from hyperbo_tpu_torch.ops import chol as chol_ops
from hyperbo_tpu_torch.ops import mll_bwd
from hyperbo_tpu_torch.ops import tri_inv as tri_inv_ops

TILE = mll_bwd.TILE
# The smallest n the route takes: the JAX package's group * block, so that
# both packages send the same configurations down the fused route.
MIN_N = 512

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)
_LOG_2PI = math.log(2 * math.pi)

KERNEL = _build.CudaKernel(
    'fused_mll.cu', 'hyperbo_mll_fused',
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5)


def _gram_transform(sqd, sv, kfam: str):
  """sv k(r2) of a squared-distance matrix; r2 floored at 0, so exactly
  coincident points give k(0) = sv."""
  r2 = torch.clamp(sqd, min=0.0)
  if kfam == 'se':
    return sv * torch.exp(-0.5 * r2)
  if kfam == 'matern32':
    r = _SQRT3 * torch.sqrt(r2)
    return sv * ((1.0 + r) * torch.exp(-r))
  if kfam == 'matern52':
    r = _SQRT5 * torch.sqrt(r2)
    return sv * ((1.0 + r + (r * r) * (1.0 / 3.0)) * torch.exp(-r))
  raise ValueError(f'unknown fused kernel family: {kfam!r}')


def mll_fused_plain(x: torch.Tensor, y: torch.Tensor, sv, da,
                    kfam: str = 'se', valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Plain PyTorch (L, quad, logdet_half) (any device, float32 or
  float64): dense Gram as the kernel builds it (entries touching a padded
  row 0, its diagonal da), Cholesky (NaN where not positive definite) and
  a triangular solve."""
  kmat = _gram_transform(mll_bwd.raw_sqdist(x), sv, kfam)
  if valid is not None:
    kmat = kmat * (valid[:, None] * valid[None, :])
  kmat = kmat + da * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
  chol = chol_ops.cholesky(kmat)
  z = torch.linalg.solve_triangular(chol, y.reshape(-1, 1), upper=False)
  return (chol, torch.sum(z * z),
          torch.sum(torch.log(torch.diagonal(chol))))


def launch_mll_fused(x: torch.Tensor, y: torch.Tensor, sv: torch.Tensor,
                     da: torch.Tensor, kfam: str = 'se',
                     valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Run the Hopper kernel: x (n, d), y (n, 1), sv and da one-element
  tensors, valid (n,) 0/1 or None, all float32 and contiguous on one CUDA
  device; n a multiple of 64."""
  sv_da = torch.cat([sv.reshape(1), da.reshape(1)])
  _build.check_cuda_f32('launch_mll_fused', x=x, y=y, sv_da=sv_da,
                        valid=valid)
  n, d = x.shape
  if y.shape != (n, 1) or n == 0 or n % TILE:
    raise ValueError(f'launch_mll_fused takes x (n, d) and y (n, 1) with n '
                     f'a multiple of {TILE}; got {tuple(x.shape)}, '
                     f'{tuple(y.shape)}')
  if valid is not None and valid.shape != (n,):
    raise ValueError(f'valid must be ({n},), got {tuple(valid.shape)}')
  z = y.reshape(n).clone()
  chol = torch.empty((n, n), dtype=torch.float32, device=x.device)
  dinv = torch.empty((TILE, TILE), dtype=torch.float32, device=x.device)
  parts = torch.empty((2 * (n // TILE),), dtype=torch.float64,
                      device=x.device)
  out = torch.empty((2,), dtype=torch.float32, device=x.device)
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(x.data_ptr(),
                  valid.data_ptr() if valid is not None else None,
                  sv_da.data_ptr(), z.data_ptr(), n, d,
                  mll_bwd.KFAM_CODE[kfam], chol.data_ptr(), dinv.data_ptr(),
                  parts.data_ptr(), out.data_ptr(), stream)
  return chol, out[0], out[1]


def mll_fused(x: torch.Tensor, y: torch.Tensor, sv, da, kfam: str = 'se',
              valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """(L, quad, logdet_half) = (chol K, y^T K^{-1} y, sum log diag L).

  L is dense lower triangular (n, n). The kernel clamps non-positive
  pivots (L_jj <= 0 marks them); the plain version returns NaN there.
  """
  if x.device.type == 'cuda':
    return launch_mll_fused(x, y, sv, da, kfam, valid)
  if x.device.type == 'cpu':
    return mll_fused_plain(x, y, sv, da, kfam, valid)
  raise ValueError(f'mll_fused runs on cpu or cuda, got {x.device}')


def _poison_non_pd(chol, nll):
  """NaN factor and value where the factorization failed.

  A clamped pivot leaves a diagonal entry of L <= 0, and the plain version
  leaves NaN; either way min(diag L) > 0 is false. Poisoning L makes every
  backward product NaN too, so the trainer's isfinite-freeze trips as on
  the dense path. Unlike the JAX package, whose value-only primal keeps
  the clamp's finite garbage, every call is poisoned here.
  """
  bad = ~(torch.min(torch.diagonal(chol)) > 0)
  nan = torch.full((), float('nan'), dtype=chol.dtype, device=chol.device)
  return torch.where(bad, nan, chol), torch.where(bad, nan, nll)


def bwd_joint_requested() -> bool:
  """Whether HYPERBO_BWD_JOINT asks for the joint backward (kernel K8):
  '1' on, unset or '0' off; any other value raises."""
  flag = os.environ.get('HYPERBO_BWD_JOINT', '0')
  if flag not in ('0', '1'):
    raise ValueError(f'HYPERBO_BWD_JOINT = {flag!r}: the port takes 1 (the '
                     'joint backward, kernel K8) or 0 / unset (K3, alpha '
                     'and K4).')
  return flag == '1'


class _FusedNllCore(torch.autograd.Function):
  """nll_core(x_scaled, delta, sv, da[, valid]) = quad / 2 + logdet_half,
  with the closed-form backward of pallas_mll._se_core_bwd."""

  @staticmethod
  def forward(ctx, x_scaled, delta, sv, da, valid, kfam):
    chol, quad, ld = mll_fused(x_scaled, delta, sv, da, kfam, valid)
    chol, nll = _poison_non_pd(chol, 0.5 * quad + ld)
    ctx.kfam = kfam
    ctx.save_for_backward(chol, x_scaled, delta, sv, valid)
    return nll

  @staticmethod
  def backward(ctx, g):
    chol, x_scaled, delta, sv, valid = ctx.saved_tensors
    d = x_scaled.shape[1]
    if bwd_joint_requested() and d + 2 <= bwd_joint.ULANE:
      d_x, alpha, dsv_raw, d_da = bwd_joint.mll_bwd_joint(
          chol, x_scaled, delta, sv, ctx.kfam, valid)
    else:
      t = tri_inv_ops.tri_inv(chol)
      alpha = tri_inv_ops.alpha_from_inverse(t, delta)
      p, dsv_raw, d_da = mll_bwd.mll_bwd_fused(t, x_scaled, alpha, sv,
                                               ctx.kfam, valid)
      d_x = 2.0 * (p[:, :d] - p[:, d:] * x_scaled)
    return g * d_x, g * alpha, g * dsv_raw / sv, g * d_da, None, None


def fused_nll_core(x_scaled: torch.Tensor, delta: torch.Tensor, sv, da,
                   kfam: str = 'se',
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Differentiable quad / 2 + logdet_half (the 0.5 n log 2 pi constant
  stays with the caller); NaN when K is not positive definite."""
  return _FusedNllCore.apply(x_scaled, delta, sv, da, valid, kfam)


def _fused_kernel_table():
  """cov_func -> (family, embedding) for every kernel the route serves:
  the SE and Matern families, raw or over the MLP. The Kumaraswamy
  variants wait for KumarWarp, and dot_product's Gram (one rank-d
  product) stays on the dense path, as in the JAX package."""
  from hyperbo_tpu_torch.models import kernel as kl
  return {
      kl.squared_exponential: ('se', None),
      kl.squared_exponential_mlp: ('se', 'mlp'),
      kl.matern32: ('matern32', None),
      kl.matern32_mlp: ('matern32', 'mlp'),
      kl.matern52: ('matern52', None),
      kl.matern52_mlp: ('matern52', 'mlp'),
  }


def kernel_family(cov_func) -> str:
  """Family name of a library kernel; 'se' for None."""
  if cov_func is None:
    return 'se'
  entry = _fused_kernel_table().get(cov_func)
  if entry is None:
    raise ValueError(
        f'{getattr(cov_func, "__name__", cov_func)!r} is not served by the '
        'fused MLL route (gate with se_nll_fused_applicable)')
  return entry[0]


def _se_embed(params, x, cov_func, warp_func):
  """The inputs the base kernel sees: raw or MLP-embedded. The MLP runs
  outside the autograd Function, so its parameters get their gradients
  from autograd, as from jax.grad in the JAX package."""
  name = getattr(cov_func, '__name__', '') if cov_func is not None else ''
  if name.endswith('_mlp'):
    mlp_params, = retrieve_params(params, ['mlp_params'],
                                  warp_func=warp_func)
    return bf.mlp_apply(mlp_params, x)
  return x


def fused_requested(params) -> bool:
  """Whether config['fused_mll'] asks for the fused route: True, or
  False/None/absent. Any other value raises; in particular the JAX
  package's 'interpret' has no meaning here, since the tensor's device
  picks the implementation."""
  flag = (params.config or {}).get('fused_mll')
  if flag is None or flag is False:
    return False
  if flag is True:
    return True
  raise ValueError(f"config['fused_mll'] = {flag!r}: the port takes True, "
                   'False or None (the device picks kernel or plain '
                   'version).')


def se_nll_fused(mean_func, params, x, y, warp_func=None, eps=1e-6,
                 cov_func=None):
  """NLL of one (n, 1) task through the fused route; the value of the
  dense pipeline (objectives.neg_log_marginal_likelihood) for the kernels
  of _fused_kernel_table, with diag add = warped noise_variance + eps.
  An n that is not a multiple of 64 goes through the masked core."""
  lengthscale, signal_variance, noise_variance = retrieve_params(
      params, ['lengthscale', 'signal_variance', 'noise_variance'],
      warp_func=warp_func)
  n = x.shape[0]
  mu = mean_func(params, x, warp_func=warp_func)
  delta = y - torch.atleast_2d(mu)
  x_scaled = _se_embed(params, x, cov_func, warp_func) / lengthscale
  kfam = kernel_family(cov_func)
  sv = torch.squeeze(torch.as_tensor(signal_variance))
  da = torch.squeeze(torch.as_tensor(noise_variance)) + eps
  if n % TILE:
    return se_nll_fused_masked(x_scaled, delta, sv, da, n, kfam)
  nll_core = fused_nll_core(x_scaled.contiguous(), delta.contiguous(), sv,
                            da, kfam)
  return nll_core + 0.5 * n * _LOG_2PI


def se_nll_fused_masked(x_scaled, delta_masked, sv, da, count,
                        kfam: str = 'se'):
  """Fused NLL of one padded task: rows >= count are padding.

  x_scaled is zero-padded to a multiple of 64 rows first. Padded rows leave
  the Gram matrix (exactly), their delta is zeroed, and their surplus
  log(da)/2 each is subtracted here, outside the autograd Function, so
  autograd carries its d/d(da). `count` is an int or a 0-d tensor.
  """
  n_in = x_scaled.shape[0]
  n = -(-n_in // TILE) * TILE
  if n != n_in:
    x_scaled = torch.nn.functional.pad(x_scaled, (0, 0, 0, n - n_in))
    delta_masked = torch.nn.functional.pad(delta_masked, (0, 0, 0, n - n_in))
  keep = torch.arange(n, device=x_scaled.device) < count
  valid = keep.to(x_scaled.dtype)
  xs = torch.where(keep[:, None], x_scaled, 0.0)
  delta = torch.where(keep[:, None], delta_masked, 0.0)
  nll_core = fused_nll_core(xs.contiguous(), delta.contiguous(), sv, da,
                            kfam, valid)
  surplus = 0.5 * torch.log(da) * (n - count)
  return nll_core - surplus + 0.5 * count * _LOG_2PI


def se_nll_fused_applicable(cov_func, x, params=None, y=None) -> bool:
  """True when the fused route can replace the dense NLL pipeline: a
  served kernel family (with its MLP parameters present), x of at least
  MIN_N rows and a single-column y. The same conditions as the JAX
  package's, without its TPU feature-width limit."""
  if y is not None and y.ndim == 2 and y.shape[1] != 1:
    return False
  if not (x.ndim == 2 and x.shape[0] >= MIN_N):
    return False
  entry = _fused_kernel_table().get(cov_func)
  if entry is None:
    return False
  if entry[1] == 'mlp':
    if params is None or 'mlp_params' not in params.model:
      return False
    if not (params.config or {}).get('mlp_features'):
      return False
  return True
