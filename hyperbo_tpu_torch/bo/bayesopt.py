"""Bayesian-optimization loops (port of hyperbo_tpu/bo/bayesopt.py).

Ported: `simulated_bayesopt` over a finite candidate set, the shared
sequential loop `_bo_iterations`, `retrain_model`,
`get_best_datapoint`, and the finite-candidate branch of `run_bayesopt`,
for a GP or (method 'hyperbo_ss') an HGP sampled by the slice sampler.
The continuous-oracle `bayesopt` (L-BFGS-B refinement, input samplers)
and the contextual helpers wait (ROADMAP Queue A).

Randomness comes from one torch.Generator threaded through the loop
instead of split JAX keys.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional, Tuple, Union

import torch

from hyperbo_tpu_torch.bo import const
from hyperbo_tpu_torch.core import defs
from hyperbo_tpu_torch.models import gp
from hyperbo_tpu_torch.models import objectives as obj
from hyperbo_tpu_torch.models import priors

SubDataset = defs.SubDataset

# Config forced onto HGP methods: posterior sampling by the slice sampler.
_HGP_SAMPLING_CONFIG = {
    'objective': 'nll',
    'method': 'slice_sample',
    'burnin': 50,
    'nsamples': 50,
}


def get_best_datapoint(sub_dataset):
  """Return the (x, y) pair with maximal y, or None if empty."""
  if sub_dataset.y.shape[0] == 0:
    return None
  best_idx = int(torch.argmax(torch.as_tensor(sub_dataset.y)))
  return (sub_dataset.x[best_idx], sub_dataset.y[best_idx])


def retrain_model(model: gp.GP,
                  sub_dataset_key: Union[int, str],
                  generator: Optional[torch.Generator] = None,
                  get_params_path: Optional[Callable[..., Any]] = None,
                  callback: Optional[Callable[..., Any]] = None):
  """Retrain on the growing test sub-dataset if config['retrain'] > 0.

  The temporary `max_training_step` override is restored afterwards.
  """
  config = model.params.config
  if not (config.get('retrain', 0) > 0 and
          model.dataset[sub_dataset_key].x.shape[0] > 0):
    return
  if config['objective'] in [obj.regkl, obj.regeuc]:
    raise ValueError('Objective must include NLL to retrain.')
  logging.info('Retraining with max_training_step = %d.',
               config['retrain'])
  saved = config.get('max_training_step')
  config['max_training_step'] = config['retrain']
  try:
    model.train(generator, get_params_path=get_params_path,
                callback=callback)
  finally:
    if saved is None:
      config.pop('max_training_step', None)
    else:
      config['max_training_step'] = saved


def _is_random_search(ac_func) -> bool:
  return getattr(ac_func, '__name__', '') in ('rand', 'random_search')


def _bo_iterations(model: gp.GP,
                   sub_dataset_key: Union[int, str],
                   iters: int,
                   propose: Callable[[Optional[torch.Generator], int],
                                     Tuple[torch.Tensor, torch.Tensor]],
                   generator: Optional[torch.Generator],
                   get_params_path: Optional[Callable[..., Any]] = None,
                   callback: Optional[Callable[..., Any]] = None
                   ) -> SubDataset:
  """Shared sequential BO loop: retrain -> propose -> append.

  The proposal runs under no_grad: the acquisition and the posterior it
  reads build no autograd graph in the loop.
  """
  for i in range(iters):
    retrain_model(model, sub_dataset_key=sub_dataset_key,
                  generator=generator, get_params_path=get_params_path,
                  callback=callback)
    with torch.no_grad():
      datapoint = propose(generator, i)
    model.update_sub_dataset(
        datapoint, sub_dataset_key=sub_dataset_key, is_append=True)
  empty = torch.empty(0, device=model.device)
  return model.dataset.get(sub_dataset_key, SubDataset(empty, empty))


def _argmax_or_random(model, sub_dataset_key, ac_func, x_queries,
                      generator):
  """Candidate index: acquisition argmax, or uniform for random search."""
  if _is_random_search(ac_func):
    if generator is None:
      raise ValueError('Must specify a random generator for random search.')
    return torch.randint(x_queries.shape[0], (), generator=generator,
                         device=generator.device).to(x_queries.device)
  evals = ac_func(model=model, sub_dataset_key=sub_dataset_key,
                  x_queries=x_queries)
  return evals.argmax()


def simulated_bayesopt(
    model: gp.GP,
    sub_dataset_key: Union[int, str],
    queried_sub_dataset: SubDataset,
    ac_func: Callable[..., torch.Tensor],
    iters: int,
    generator: Optional[torch.Generator] = None,
    get_params_path: Optional[Callable[..., Any]] = None,
    callback: Optional[Callable[..., Any]] = None,
) -> SubDataset:
  """Offline BO over a finite pre-evaluated candidate set."""
  cand_x = model._tensor(queried_sub_dataset.x)
  cand_y = model._tensor(queried_sub_dataset.y)

  def propose(gen, _):
    select_idx = _argmax_or_random(model, sub_dataset_key, ac_func, cand_x,
                                   gen)
    return cand_x[select_idx], cand_y[select_idx]

  return _bo_iterations(model, sub_dataset_key, iters, propose, generator,
                        get_params_path=get_params_path, callback=callback)


def _build_model(method, dataset, mean_func, cov_func, init_params,
                 warp_func, device):
  """GP or HGP by the method; an HGP method forces the sampling config
  and the default hyperpriors."""
  if method in const.USE_HGP:
    init_params.config.update(_HGP_SAMPLING_CONFIG,
                              priors=priors.DEFAULT_PRIORS)
    model_class = gp.HGP
  else:
    model_class = gp.GP
  return model_class(dataset=dataset, mean_func=mean_func,
                     cov_func=cov_func, params=init_params,
                     warp_func=warp_func, device=device)


def run_bayesopt(
    dataset: defs.AllowedDatasetTypes,
    sub_dataset_key: str,
    queried_sub_dataset: Union[SubDataset, Callable[[Any], Any]],
    mean_func: Callable[..., torch.Tensor],
    cov_func: Callable[..., torch.Tensor],
    init_params: defs.GPParams,
    ac_func: Callable[..., torch.Tensor],
    iters: int,
    warp_func: defs.WarpFuncType = None,
    init_random_key: Optional[torch.Generator] = None,
    method: str = 'hyperbo',
    init_model: bool = False,
    data_loader_name: str = '',
    get_params_path: Optional[Callable[..., Any]] = None,
    callback: Optional[Callable[..., Any]] = None,
    save_retrain_model: bool = False,
    device: Union[str, torch.device] = 'cuda',
):
  """BO experiment entry point: build the GP on `device` (the CUDA card
  unless the caller passes 'cpu'), optionally
  initialize and pre-train it, then run BO over the candidate set.

  `init_random_key` is a torch.Generator on `device`; it draws the
  initial parameters, the training subsamples and any random proposals.
  Returns ((x_observed, y_observed), best_query, model_params).
  """
  del data_loader_name  # Used by the continuous-oracle branch only.
  if not isinstance(queried_sub_dataset, SubDataset):
    raise NotImplementedError('the continuous-oracle bayesopt is not '
                              'ported yet: see ROADMAP Queue A')
  logging.info('run_bayesopt is using method %s.', method)
  model = _build_model(method, dataset, mean_func, cov_func, init_params,
                       warp_func, device)
  if init_model:
    if init_random_key is None:
      raise ValueError('Cannot initialize with init_random_key == None.')
    model.initialize_params(init_random_key)
    model.train(init_random_key, get_params_path, callback=callback)
  else:
    model.rng = init_random_key

  sub_dataset = simulated_bayesopt(
      model=model,
      sub_dataset_key=sub_dataset_key,
      queried_sub_dataset=queried_sub_dataset,
      ac_func=ac_func,
      iters=iters,
      generator=init_random_key,
      get_params_path=get_params_path if save_retrain_model else None,
      callback=callback if save_retrain_model else None)
  return ((sub_dataset.x, sub_dataset.y),
          get_best_datapoint(queried_sub_dataset), model.params)
