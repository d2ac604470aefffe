"""Bayesian-optimization loops (port of hyperbo_tpu/bo/bayesopt.py).

`simulated_bayesopt` over a finite candidate set and the continuous-oracle
`bayesopt` (a pool from an input sampler, its acquisition argmax refined by
scipy's L-BFGS-B in [0, 1]^d), both on the shared sequential loop
`_bo_iterations`; `retrain_model`, `get_best_datapoint`, `run_bayesopt`
(either branch) for a GP or (method 'hyperbo_ss') an HGP sampled by the
slice sampler, and the contextual helper `with_task_context`.

Randomness comes from one torch.Generator threaded through the loop
instead of split JAX keys.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import scipy.optimize
import torch

from hyperbo_tpu_torch.bo import const
from hyperbo_tpu_torch.bo import input_samplers
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


def _skips_refinement(ac_func) -> bool:
  """Acquisitions whose scores are no smooth surrogate to ascend: random
  search (a refined random baseline is no longer random) and Thompson
  sampling (a per-point draw is not a coherent function)."""
  return (_is_random_search(ac_func) or
          getattr(ac_func, '__name__', '') in ('ts', 'thompson_sampling'))


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


def _lbfgsb_refine(fun, x_init, input_dim):
  """Bounded L-BFGS-B refinement of an acquisition argmax in [0, 1]^d.

  scipy drives the search in float64; each evaluation takes its point as
  float32 on x_init's device, computes fun's value and gradient there
  with autograd, and reads both back in one transfer.
  """
  device = x_init.device

  def f_np(x):
    xt = torch.tensor(x, dtype=torch.float32, device=device,
                      requires_grad=True)
    with torch.enable_grad():
      v = fun(xt)
      # A posterior constant in x (the prior of a stationary kernel and a
      # constant mean) has the zero gradient and no graph.
      g = (torch.autograd.grad(v, xt)[0] if v.requires_grad
           else torch.zeros_like(xt))
    vg = torch.cat([v.detach().reshape(1), g]).cpu()
    return float(vg[0]), vg[1:].numpy().astype(np.float64)

  res = scipy.optimize.minimize(
      f_np, x_init.detach().cpu().numpy().astype(np.float64), jac=True,
      method='L-BFGS-B', bounds=[(0., 1.)] * input_dim)
  return torch.as_tensor(res.x, dtype=torch.float32, device=device)


def bayesopt(
    generator: torch.Generator,
    model: gp.GP,
    sub_dataset_key: Union[int, str],
    query_oracle: Callable[[Any], Any],
    ac_func: Callable[..., torch.Tensor],
    iters: int,
    input_sampler: Callable[..., torch.Tensor],
) -> SubDataset:
  """Continuous-domain BO against a query oracle.

  Per iteration: sample a candidate pool (input_sampler(generator, d)),
  take the acquisition argmax as the start point, refine it with bounded
  L-BFGS-B in [0, 1]^d, query the oracle at it ((1, d) -> (1, 1)) and
  append the observation. Random search and Thompson sampling are not
  refined: their proposal is a member of its pool.
  """
  if generator is None:
    raise ValueError('bayesopt draws its pools from a generator; got None.')
  input_dim = model.input_dim

  def propose(gen, i):
    start_time = time.time()
    x_samples = model._tensor(input_sampler(gen, input_dim))
    select_idx = _argmax_or_random(model, sub_dataset_key, ac_func,
                                   x_samples, gen)
    x_init = x_samples[select_idx]

    def neg_ac(x):
      return -ac_func(model=model, sub_dataset_key=sub_dataset_key,
                      x_queries=x[None, :]).flatten()[0]

    x_opt = (x_init if _skips_refinement(ac_func)
             else _lbfgsb_refine(neg_ac, x_init, input_dim))
    datapoint = (x_opt, model._tensor(query_oracle(x_opt[None, :])))
    logging.info('%d-th iter, x_init=%s, eval_datapoint=%s, elapsed=%f',
                 i, x_init, datapoint, time.time() - start_time)
    return datapoint

  return _bo_iterations(model, sub_dataset_key, iters, propose, generator)


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
  initialize and pre-train it, then run BO over the candidate set (a
  SubDataset) or against an oracle (a callable, with the input sampler
  INPUT_SAMPLERS[data_loader_name]; an unknown name raises
  NotImplementedError).

  `init_random_key` is a torch.Generator on `device`; it draws the
  initial parameters, the training subsamples, the oracle branch's pools
  and any random proposals. Returns ((x_observed, y_observed),
  best_query, model_params); best_query is None on the oracle branch.
  """
  continuous = not isinstance(queried_sub_dataset, SubDataset)
  if continuous and data_loader_name not in input_samplers.INPUT_SAMPLERS:
    raise NotImplementedError(
        f'Input sampler for {data_loader_name} not found.')
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

  if continuous:
    sub_dataset = bayesopt(
        generator=init_random_key,
        model=model,
        sub_dataset_key=sub_dataset_key,
        query_oracle=queried_sub_dataset,
        ac_func=ac_func,
        iters=iters,
        input_sampler=input_samplers.INPUT_SAMPLERS[data_loader_name])
    return (sub_dataset.x, sub_dataset.y), None, model.params

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


def with_task_context(x, task_id: int, num_tasks: int) -> torch.Tensor:
  """Each input row with a one-hot task indicator appended, (n, d +
  num_tasks): the contextual/MTBO baselines model all tasks with one GP
  whose inputs carry the task's identity."""
  x = torch.as_tensor(x)
  ctx = torch.zeros((x.shape[0], num_tasks), dtype=x.dtype, device=x.device)
  ctx[:, task_id] = 1
  return torch.cat([x, ctx], dim=1)
