"""Model-parameter conversion between the JAX package's layout and the port.

Both packages keep `GPParams.model` as a nested dict with the same keys:
scalars and vectors at the top level ('constant', 'lengthscale', ...) and
Flax Dense layouts below ('mlp_params': {'Dense_i': {'kernel': (in, out),
'bias': (out,)}}, 'linear_mean': {'kernel': (in, 1), 'bias': (1,)}). The
conversion maps leaf for leaf: numpy (or anything numpy can read, such as
a JAX array) to float32 tensors, and back. No JAX import is needed.

A stack of models (the HGP's posterior samples, the slice sampler's
chains) is one such dict whose leaves carry a leading axis: `stack_models`
makes it, `model_at` takes one model out and `stack_size` reads its
length.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch


def _map_tree(fn, tree):
  if isinstance(tree, dict):
    return {k: _map_tree(fn, v) for k, v in tree.items()}
  return fn(tree)


def model_from_jax(tree: Dict[str, Any],
                   device: Union[str, torch.device] = 'cpu'
                   ) -> Dict[str, Any]:
  """Nested dict of numpy-convertible leaves -> same dict of float32 tensors."""
  return _map_tree(
      lambda leaf: torch.as_tensor(np.array(leaf, np.float32),
                                   device=device), tree)


def model_to_numpy(model: Dict[str, Any]) -> Dict[str, Any]:
  """Nested dict of tensors -> same dict of float32 numpy arrays."""
  return _map_tree(
      lambda leaf: (leaf.detach().cpu().numpy() if torch.is_tensor(leaf)
                    else np.asarray(leaf, np.float32)), model)


def model_to(model: Dict[str, Any],
             device: Union[str, torch.device]) -> Dict[str, Any]:
  """Every leaf as a float32 tensor on `device` (tensors already there are
  returned as they are)."""
  return _map_tree(
      lambda leaf: torch.as_tensor(leaf, dtype=torch.float32, device=device),
      model)


def stack_models(models, device=None) -> Dict[str, Any]:
  """Models of the same layout -> one dict of float32 leaves stacked on a
  leading axis."""
  first = models[0]
  if isinstance(first, dict):
    return {k: stack_models([m[k] for m in models], device) for k in first}
  return torch.stack([torch.as_tensor(m, dtype=torch.float32, device=device)
                      for m in models])


def model_at(stacked: Dict[str, Any], r) -> Dict[str, Any]:
  """Model r of a stack; r an int, a slice (a smaller stack) or a 0-d
  int64 tensor (a device index, taken with index_select, never read
  back)."""
  if torch.is_tensor(r):
    return _map_tree(lambda leaf: leaf.index_select(0, r.reshape(1))[0],
                     stacked)
  return _map_tree(lambda leaf: leaf[r], stacked)


def stack_size(stacked: Dict[str, Any]) -> int:
  """The length of a stack of models."""
  leaf = stacked
  while isinstance(leaf, dict):
    leaf = next(iter(leaf.values()))
  return leaf.shape[0]
