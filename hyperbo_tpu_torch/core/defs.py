"""Core GP data structures (port of hyperbo_tpu/core/defs.py).

Same names and fields as the JAX package: `SubDataset` is a NamedTuple of
tensors, `GPParams.model` is a nested dict of tensors (the trainable
leaves, same keys as the Flax/JAX layout), `GPCache` carries the Cholesky
factor and K^{-1}(y - mu), with `num_obs` marking the valid prefix of a
preallocated (bucket-padded) factor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch


class SubDataset(NamedTuple):
  """Sub dataset with x: n x d and y: n x m; d, m >= 1.

  `aligned` tags sub-datasets whose y columns are matched-input function
  evaluations (EKL objective); `None` means not aligned.
  """
  x: torch.Tensor
  y: torch.Tensor
  aligned: Optional[Union[int, str, bool, Tuple[str, ...]]] = None


@dataclasses.dataclass
class GPCache:
  """Cached intermediate results for GP posterior inference."""
  chol: torch.Tensor
  kinvy: torch.Tensor
  needs_update: bool
  # Number of valid observations when chol/kinvy live in preallocated
  # bucket-size buffers. None => dense, fully valid.
  num_obs: Optional[int] = None


@dataclasses.dataclass
class GPParams:
  """Parameters of a (pre-trained) GP.

  Attributes:
    config: static configuration (method, learning_rate, max_training_step,
      batch_size, objective, mlp_features, retrain, ...).
    model: trainable parameters (lengthscale, signal_variance,
      noise_variance, constant, mlp_params, linear_mean, ...), a nested dict
      of tensors that the trainer differentiates through.
    cache: mapping sub-dataset key -> GPCache.
    samples: posterior samples of `model` (method 'slice_sample'; an HGP
      averages over them).
  """
  config: Dict[str, Any] = dataclasses.field(default_factory=dict)
  model: Dict[str, Any] = dataclasses.field(default_factory=dict)
  cache: Dict[Union[int, str], GPCache] = dataclasses.field(
      default_factory=dict)
  samples: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


AllowedDatasetTypes = Union[
    List[Union[Tuple[Any, ...], SubDataset]],
    Dict[Union[str, int], Union[Tuple[Any, ...], SubDataset]],
]

WarpFuncType = Optional[Dict[str, Callable[[Any], Any]]]
