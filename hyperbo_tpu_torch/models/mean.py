"""Mean function library (port of hyperbo_tpu/models/mean.py).

Every mean maps (params, vx, warp_func) -> (..., n, 1), with the Flax
Dense(1) layout ('kernel': (d, 1), 'bias': (1,)) for the linear means.
"""

from __future__ import annotations

import functools

import torch

from hyperbo_tpu_torch.core.warp import retrieve_params
from hyperbo_tpu_torch.models import basis as bf


def mean_vector(mean_scalar):
  """Lift a scalar mean m(params, x, warp_func) of one input row to the
  vector API f(params, vx, warp_func=None) -> (n, 1), by torch.func.vmap
  over the rows. For user-defined means; the built-ins below are already
  matrix-level."""

  @functools.wraps(mean_scalar)
  def vector_map(params, vx, warp_func=None):
    return torch.func.vmap(lambda x: mean_scalar(params, x, warp_func))(vx)

  return vector_map


def zero(params, vx, warp_func=None):
  """Zero mean function: n x 1 zeros."""
  del params, warp_func
  return torch.zeros(vx.shape[:-1] + (1,), dtype=vx.dtype, device=vx.device)


def constant(params, vx, warp_func=None):
  """Constant mean function: n x 1 filled with the (warped) constant."""
  val, = retrieve_params(params, ['constant'], warp_func)
  return torch.ones(vx.shape[:-1] + (1,), dtype=vx.dtype,
                    device=vx.device) * val


def linear(params, x, warp_func=None):
  """Linear mean: x @ W + b."""
  linear_mean, = retrieve_params(params, ['linear_mean'], warp_func)
  return torch.matmul(x, linear_mean['kernel']) + linear_mean['bias']


def linear_mlp(params, x, warp_func=None):
  """Fully connected neural net (MLP -> Dense(1)) as a mean function."""
  mlp_params, = retrieve_params(params, ['mlp_params'], warp_func)
  return linear(params, bf.mlp_apply(mlp_params, x), warp_func=warp_func)
