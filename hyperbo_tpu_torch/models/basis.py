"""Neural basis functions (port of hyperbo_tpu/models/basis.py).

The tanh-Dense MLP as a functional apply over the Flax parameter layout,
{'Dense_i': {'kernel': (in, out), 'bias': (out,)}}, and the Kumaraswamy
CDF warp over its layout {'a': (d,), 'b': (d,)}, so that parameters map
name for name between the two packages.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from hyperbo_tpu_torch.core.warp import squareplus_warp

# Flax's lecun_normal draws from a normal truncated to [-2, 2] standard
# deviations, rescaled by this factor (the truncated distribution's std)
# so that the variance is exactly 1 / fan_in.
_TRUNC_NORMAL_STD = 0.87962566103423978


def dense_init(generator: torch.Generator, in_features: int,
               out_features: int, device='cpu') -> Dict[str, torch.Tensor]:
  """Flax nn.Dense default init: lecun_normal kernel, zero bias."""
  std = math.sqrt(1.0 / max(in_features, 1)) / _TRUNC_NORMAL_STD
  kernel = torch.empty((in_features, out_features), dtype=torch.float32,
                       device=generator.device)
  torch.nn.init.trunc_normal_(kernel, mean=0.0, std=std, a=-2.0 * std,
                              b=2.0 * std, generator=generator)
  return {'kernel': kernel.to(device),
          'bias': torch.zeros((out_features,), dtype=torch.float32,
                              device=device)}


def mlp_apply(mlp_params: Dict[str, Dict[str, torch.Tensor]],
              x: torch.Tensor) -> torch.Tensor:
  """x -> tanh(... tanh(x @ W_0 + b_0) ... @ W_k + b_k), (..., n, d)."""
  for i in range(len(mlp_params)):
    layer = mlp_params[f'Dense_{i}']
    x = torch.tanh(torch.matmul(x, layer['kernel']) + layer['bias'])
  return x


def init_mlp_with_shape(generator: torch.Generator, params,
                        input_shape: Sequence[int], device='cpu'):
  """Initialize params.model['mlp_params'] for inputs of width
  input_shape[-1] and layer widths config['mlp_features']."""
  widths = [int(input_shape[-1])] + list(params.config['mlp_features'])
  params.model['mlp_params'] = {
      f'Dense_{i}': dense_init(generator, widths[i], widths[i + 1], device)
      for i in range(len(widths) - 1)}


def kumar_warp_apply(kumar_params: Dict[str, torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
  """Kumaraswamy CDF warp 1 - (1 - x^a)^b of each input dimension, with a
  and b stored unconstrained and squareplus-warped to positive values.
  Inputs are assumed to lie in [0, 1] (at x = 0 the gradient in x is
  infinite for a < 1)."""
  a = squareplus_warp(kumar_params['a'])
  b = squareplus_warp(kumar_params['b'])
  return 1 - (1 - x**a)**b


def init_kumar_warp_with_shape(generator, params, input_shape: Sequence[int],
                               device='cpu'):
  """Initialize params.model['kumar_params']: zero a and b of the input
  width input_shape[-1] (Flax's zeros initializer; the generator is not
  drawn from, as the JAX package's key is not)."""
  del generator
  d = int(input_shape[-1])
  params.model['kumar_params'] = {
      'a': torch.zeros((d,), dtype=torch.float32, device=device),
      'b': torch.zeros((d,), dtype=torch.float32, device=device)}
