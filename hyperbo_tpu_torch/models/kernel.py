"""GP kernel library (port of hyperbo_tpu/models/kernel.py).

Every kernel is a matrix-valued function

    kernel(params, vx1, vx2=None, warp_func=None, diag=False) -> (..., n1, n2)

with the JAX package's parameterizations and its `diag=True` path (honored
only when vx2 is None). Inputs may carry leading batch dimensions. The
`*_mlp` and `*_kumar` kernels apply the MLP or the Kumaraswamy warp
(models/basis) to the inputs first; `covariance_matrix` lifts a user's
scalar kernel to this API.
"""

from __future__ import annotations

import functools
import math

import torch

from hyperbo_tpu_torch.core.warp import retrieve_params
from hyperbo_tpu_torch.models import basis as bf
from hyperbo_tpu_torch.ops import gram


def covariance_matrix(kernel_scalar):
  """Lift a scalar kernel k(params, x1, x2, warp_func=None) to the matrix
  API f(params, vx1, vx2=None, warp_func=None, diag=False) -> n1 x n2
  (diag, (n1,), honored only when vx2 is None), by torch.func.vmap over
  the rows. For user-defined kernels; the built-ins below compute their
  Gram matrices directly."""

  @functools.wraps(kernel_scalar)
  def matrix_map(params, vx1, vx2=None, warp_func=None, diag=False):
    cov = functools.partial(kernel_scalar, params, warp_func=warp_func)
    if vx2 is None:
      if diag:
        return torch.func.vmap(lambda x: cov(x, x))(vx1)
      vx2 = vx1
    return torch.func.vmap(
        lambda a: torch.func.vmap(lambda b: cov(a, b))(vx2))(vx1)

  return matrix_map


def _scaled_sqdist(vx1, vx2, lengthscale):
  """Squared distances of lengthscale-scaled inputs."""
  x1 = vx1 / lengthscale
  x2 = None if vx2 is None else vx2 / lengthscale
  return gram.sqdist(x1, x2)


# Floor under squared distances before the Matern sqrt (as in the JAX
# package): at coincident points the exact derivative of the kernel is 0,
# and flooring r^2 realizes that limit with no inf * 0 intermediates.
_R2_FLOOR = 1e-36


def _safe_r(r2, scale):
  return scale * torch.sqrt(torch.clamp(r2, min=_R2_FLOOR))


def _diag_ones(vx1, sig):
  return sig * torch.ones(vx1.shape[:-1], dtype=vx1.dtype, device=vx1.device)


def squared_exponential(params, vx1, vx2=None, warp_func=None, diag=False):
  """Squared exponential kernel: Eq.(4.9/13) of the GPML book."""
  lengthscale, signal_variance = retrieve_params(
      params, ['lengthscale', 'signal_variance'], warp_func)
  sig = torch.squeeze(torch.as_tensor(signal_variance))
  if vx2 is None and diag:
    return _diag_ones(vx1, sig)
  r2 = _scaled_sqdist(vx1, vx2, lengthscale)
  return sig * torch.exp(-r2 / 2)


def matern32(params, vx1, vx2=None, warp_func=None, diag=False):
  """Matern 3/2 kernel: Eq.(4.17) of the GPML book."""
  lengthscale, signal_variance = retrieve_params(
      params, ['lengthscale', 'signal_variance'], warp_func)
  sig = torch.squeeze(torch.as_tensor(signal_variance))
  if vx2 is None and diag:
    return _diag_ones(vx1, sig)
  r2 = _scaled_sqdist(vx1, vx2, lengthscale)
  r = _safe_r(r2, math.sqrt(3.0))
  return sig * (1 + r) * torch.exp(-r)


def matern52(params, vx1, vx2=None, warp_func=None, diag=False):
  """Matern 5/2 kernel: Eq.(4.17) of the GPML book."""
  lengthscale, signal_variance = retrieve_params(
      params, ['lengthscale', 'signal_variance'], warp_func)
  if vx2 is None and diag:
    return _diag_ones(vx1, torch.squeeze(torch.as_tensor(signal_variance)))
  r2 = _scaled_sqdist(vx1, vx2, lengthscale)
  r = _safe_r(r2, math.sqrt(5.0))
  return signal_variance * (1 + r + r**2 / 3) * torch.exp(-r)


def dot_product(params, vx1, vx2=None, warp_func=None, diag=False):
  """Dot product kernel k(x, x') = b^2 + x^T x' / s^2."""
  sigma, bias = retrieve_params(
      params, ['dot_prod_sigma', 'dot_prod_bias'], warp_func)
  if vx2 is None and diag:
    return (torch.sum(vx1 * vx1, dim=-1) / torch.square(sigma)
            + torch.square(bias))
  return (gram.inner_product(vx1, vx2) / torch.square(sigma)
          + torch.square(bias))


def with_mlp_bases(kernel):
  """Wrapper applying the tanh-Dense MLP to inputs before the kernel."""

  def kernel_mlp(params, vx1, vx2=None, warp_func=None, diag=False):
    mlp_params, = retrieve_params(params, ['mlp_params'], warp_func)
    vx1 = bf.mlp_apply(mlp_params, vx1)
    if vx2 is not None:
      vx2 = bf.mlp_apply(mlp_params, vx2)
    return kernel(params, vx1, vx2, warp_func=warp_func, diag=diag)

  kernel_mlp.__name__ = kernel.__name__ + '_mlp'
  return kernel_mlp


dot_product_mlp = with_mlp_bases(dot_product)
squared_exponential_mlp = with_mlp_bases(squared_exponential)
matern32_mlp = with_mlp_bases(matern32)
matern52_mlp = with_mlp_bases(matern52)


def with_kumar_bases(kernel):
  """Wrapper applying the Kumaraswamy CDF warp to inputs before the
  kernel."""

  def kernel_kumar(params, vx1, vx2=None, warp_func=None, diag=False):
    kumar_params, = retrieve_params(params, ['kumar_params'], warp_func)
    vx1 = bf.kumar_warp_apply(kumar_params, vx1)
    if vx2 is not None:
      vx2 = bf.kumar_warp_apply(kumar_params, vx2)
    return kernel(params, vx1, vx2, warp_func=warp_func, diag=diag)

  kernel_kumar.__name__ = kernel.__name__ + '_kumar'
  return kernel_kumar


dot_product_kumar = with_kumar_bases(dot_product)
squared_exponential_kumar = with_kumar_bases(squared_exponential)
matern32_kumar = with_kumar_bases(matern32)
matern52_kumar = with_kumar_bases(matern52)
