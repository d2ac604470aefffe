"""GPParams checkpoint save/load and experiment filename encoding (port of
hyperbo_tpu/core/params_io.py).

A checkpoint is the JAX package's pickle: the tuple (params_dict, state),
where params_dict is GPParams.__dict__ with every tensor as a numpy array
(the model leaves float32, in the JAX layout of core/convert) and every
callable stringified, and state is the optional (step, loss) pair. So a
checkpoint written by either package loads in the other: `load_params`
gives tensors on the requested device (the CUDA card unless the caller
asks for the CPU).

Loading never imports the JAX package: a GPCache pickled by it is read as
this package's GPCache. The Orbax pair raises (ROADMAP Queue C: the card's
machine has no Orbax), and `encode_model_filename` reads an
ml_collections-style config by attribute and `in` without importing
ml_collections.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import os
import pickle
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs
from hyperbo_tpu_torch.core.warp import retrieve_params

GPParams = defs.GPParams
FINAL_PARAM_FILE_INFO = 'FINAL'

# Hook for alternative filesystems: maps a path prefix to an
# open(path, mode) callable.
_FILESYSTEMS: Dict[str, Callable[..., Any]] = {}


def register_filesystem(prefix: str, opener: Callable[..., Any]):
  _FILESYSTEMS[prefix] = opener


def _open(path: str, mode: str):
  for prefix, opener in _FILESYSTEMS.items():
    if path.startswith(prefix):
      return opener(path, mode)
  return open(path, mode)


def to_list_or_float(x):
  """A tensor or numpy array as a (nested) Python list, a numpy scalar as
  a float; anything else as it is."""
  if torch.is_tensor(x):
    return x.detach().cpu().numpy().tolist()
  if isinstance(x, np.ndarray):
    return x.tolist()
  if isinstance(x, (np.float32, np.float64)):
    return float(x)
  return x


def save_to_file(filenm: str, state: Any = None):
  """Pickle `state` to `filenm`, creating parent directories."""
  if not state:
    return
  dirnm = os.path.dirname(filenm)
  if dirnm and not os.path.exists(dirnm):
    os.makedirs(dirnm, exist_ok=True)
  with _open(filenm, 'wb') as f:
    pickle.dump(state, f)


class _Unpickler(pickle.Unpickler):
  """Reads the JAX package's core/defs classes as this package's."""

  def find_class(self, module, name):
    if module == 'hyperbo_tpu.core.defs':
      return getattr(defs, name)
    return super().find_class(module, name)


def load_from_file(filenm: str):
  if not os.path.exists(filenm):
    raise FileNotFoundError(f'{filenm} does not exist.')
  with _open(filenm, 'rb') as f:
    return _Unpickler(io.BytesIO(f.read())).load()


def _host_and_stringify(tree):
  """Tensors as numpy arrays and callables as strings, through dicts,
  lists, tuples and GPCaches, so that the pickle holds no tensor."""
  if isinstance(tree, dict):
    return {k: _host_and_stringify(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)) and not hasattr(tree, '_fields'):
    return type(tree)(_host_and_stringify(v) for v in tree)
  if isinstance(tree, defs.GPCache):
    return dataclasses.replace(tree, chol=_host_and_stringify(tree.chol),
                               kinvy=_host_and_stringify(tree.kinvy))
  if torch.is_tensor(tree):
    return tree.detach().cpu().numpy()
  if callable(tree):
    return str(tree)
  return tree


def save_params(filenm: str,
                params: Union[GPParams, Dict[str, Any]],
                state: Any = None):
  """Save GPParams (or a dict) plus an optional training state."""
  if not isinstance(params, dict):
    params = dict(params.__dict__)
    params['model'] = convert.model_to_numpy(params['model'])
    params['samples'] = [convert.model_to_numpy(m)
                         for m in params.get('samples') or []]
  params = _host_and_stringify(params)
  if state:
    state = _host_and_stringify(state)
  save_to_file(filenm, (params, state))


def _on_device(params: Dict[str, Any], device) -> Dict[str, Any]:
  """The loaded model, samples and caches as float32 tensors on device."""
  params = dict(params)
  if isinstance(params.get('model'), dict):
    params['model'] = convert.model_from_jax(params['model'], device)
  if params.get('samples'):
    params['samples'] = [convert.model_from_jax(m, device)
                         for m in params['samples']]
  if params.get('cache'):
    params['cache'] = {
        k: dataclasses.replace(
            c, chol=torch.as_tensor(np.asarray(c.chol), device=device),
            kinvy=torch.as_tensor(np.asarray(c.kinvy), device=device))
        for k, c in params['cache'].items()}
  return params


def load_params(filenm: str,
                use_gpparams: bool = True,
                include_state: bool = False,
                device: Union[str, torch.device] = 'cuda'):
  """Load params saved by save_params (either package's) with the model
  leaves as tensors on `device`."""
  from hyperbo_tpu_torch.models import gp
  params_dict, state = load_from_file(filenm)
  params_dict = _on_device(params_dict, gp.resolve_device(device))
  params = GPParams(**params_dict) if use_gpparams else params_dict
  if include_state:
    return params, state
  return params


def encode_model_filename(config):
  """Encode an experiment config (ml_collections-style: read by attribute
  and `in`) into a path factory, in the JAX package's scheme."""
  model_key = ''
  if config.data_loader_name == 'pd1':
    model_key = '-'.join(
        (config.test_dataset_index, str(config.seed), config.mean_func_name,
         config.cov_func_name, str(config.init_params.config['mlp_features']),
         config.init_params.config['objective'],
         config.init_params.config['method'],
         str(config.init_params.config['max_training_step']),
         str(config.init_params.config['batch_size']), str(config.num_remove),
         str(config.p_observed), str(config.p_remove)))
    if 'num_irrelevant' in config and config.num_irrelevant:
      model_key = '-'.join((model_key, config.num_irrelevant))
  elif 'hpob' in config.data_loader_name:
    model_key = '-'.join(
        (config.search_space_index, str(config.seed), config.mean_func_name,
         config.cov_func_name, config.init_params.config['method']))
    if isinstance(config.init_params.config['mlp_features'], tuple):
      model_key = '-'.join(
          (model_key, str(config.init_params.config['mlp_features'])))
    if config.use_surrogate_train:
      model_key = '-'.join((model_key, 'use_surrogate_train'))
    if config.wild_card_train:
      model_key = '-'.join(
          (model_key, f'wild_card_train={config.wild_card_train}'))
    if config.normalize_y:
      model_key = '-'.join((model_key, 'normalize_y'))
    if config.output_log_warp:
      model_key = '-'.join((model_key, 'output_log_warp'))
  else:
    raise NotImplementedError(
        f'Filename encoder not implemented for {config.data_loader_name}')

  def get_path(additional_info=FINAL_PARAM_FILE_INFO, model_key_only=False):
    if model_key_only:
      return model_key
    if not isinstance(config.model_dir, str):
      raise ValueError(f'config.model_dir={config.model_dir} is not valid.')
    if not isinstance(additional_info, str):
      additional_info = str(additional_info)
    if config.method == 'stbo':
      model_spec = '-'.join((model_key, config.ac_func_name, config.method,
                             config.test_dataset_index, config.test_seed))
    else:
      model_spec = model_key
    if config.data_loader_name == 'pd1':
      return os.path.join(config.model_dir, model_spec,
                          f'{additional_info}.pkl')
    elif 'hpob' in config.data_loader_name:
      return os.path.join(config.model_dir,
                          '-'.join((model_spec, additional_info)) + '.pkl')

  return get_path


def _orbax_not_ported(what: str):
  return NotImplementedError(
      f'{what} is not ported: the card\'s machine has no Orbax (ROADMAP '
      'Queue C); use save_params / load_params')


def save_params_orbax(ckpt_dir: str, params, step: int = 0):
  """Orbax checkpoint of params.model: raises (see _orbax_not_ported)."""
  raise _orbax_not_ported('save_params_orbax')


def load_params_orbax(ckpt_dir: str, step: int = 0, template=None):
  """Orbax checkpoint load: raises (see _orbax_not_ported)."""
  raise _orbax_not_ported('load_params_orbax')


def log_params_loss(step: int,
                    params: GPParams,
                    loss,
                    warp_func: Optional[Dict[str, Callable[[Any],
                                                           Any]]] = None,
                    params_save_file: Optional[str] = None):
  """Log warped params and loss at a training step; optionally
  checkpoint (params and the state (step, loss))."""
  if logging.getLogger().isEnabledFor(logging.INFO):
    # The warped values are computed only to be logged: the training
    # loops call this between steps, where it should launch nothing.
    keys = list(params.model.keys())
    retrieved = dict(zip(keys, retrieve_params(params, keys,
                                               warp_func=warp_func)))
    logging.info('logging iter=%s, loss=%s, params.model after warping=%s',
                 step, loss, retrieved)
  if params_save_file is not None:
    logging.info('Saving params to %s.', params_save_file)
    save_params(params_save_file, params, state=(step, loss))
