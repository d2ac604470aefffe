"""(Multi-task) Gaussian process model: training, evaluation and
prediction (port of hyperbo_tpu/models/gp.py).

`infer_parameters` trains with every method of the JAX package: 'adam'
on the packed route (NLL, EKL and NLL + c EKL objectives; with
config['num_restarts'] > 1 and the plain NLL, multi-start Adam), or
through the host loop `fit_adam` for whatever the packed route does not
serve (other objectives such as euc and nll_regeuc*, multi-output NLL
data, config['pack_tasks'] False); 'lbfgs' and 'bfgs' (train/optimizers)
on the per-task objective; 'slice_sample' (the host or the device sampler
of train/slice_sampler). `get_params_path` checkpoints the parameters
(core/params_io) at the JAX package's steps. Also ported:
`sample_from_gp` (Cholesky, eigh or SVD factor), the functional
`predict`, the `GP` class (initialize_params, train, the model evaluation
`stats` with its SVD NLL and EKL/EUC divergences, setup_predictor with
the bucket-padded incremental Cholesky cache, update_sub_dataset,
predict) and the `HGP` class, which averages over the posterior samples
(predict_stacked: every sample's posterior with one batched
factorization). The mesh routes raise (ROADMAP Queue A).

Every GP lives on one device (`device=`, the CUDA card unless the caller
asks for the CPU); its data, parameters and random generator are kept
there. A CUDA device on a machine without CUDA raises: nothing falls back
to the CPU.
"""

from __future__ import annotations

import collections
import logging
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs
from hyperbo_tpu_torch.core import params_io
from hyperbo_tpu_torch.core.warp import retrieve_params
from hyperbo_tpu_torch.models import basis as bf
from hyperbo_tpu_torch.models import divergences
from hyperbo_tpu_torch.models import objectives as obj
from hyperbo_tpu_torch.models import packed as packed_lib
from hyperbo_tpu_torch.ops import chol as chol_ops
from hyperbo_tpu_torch.ops import linalg
from hyperbo_tpu_torch.train import adam as adam_lib
from hyperbo_tpu_torch.train import optimizers as qn
from hyperbo_tpu_torch.train import slice_sampler as slice_lib

GPCache = defs.GPCache
SubDataset = defs.SubDataset
GPParams = defs.GPParams


def _not_ported(what: str):
  return NotImplementedError(f'{what} is not ported yet: see ROADMAP '
                             'Queue A')


def resolve_device(device: Union[str, torch.device]) -> torch.device:
  """torch.device(device); raises for CUDA when CUDA is unavailable."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'device {device} requested but CUDA is not '
                       'available (pass device="cpu" to run on the CPU)')
  return device


def _build_packed_training(objective, dataset, config, mean_func,
                           cov_func, warp_func, device):
  """(loss_fn, data, subsample_fn, is_pure_nll) of the packed trainer, or
  None where the JAX package sends the objective to its host loop.

  The objectives tagged with `_packed_spec` are served: the plain NLL, the
  plain partial-KL EKL and NLL + c EKL. `data` is the pair (NLL pack, EKL
  pack), either None when its half is not needed. Other objectives,
  multi-output NLL data, an EKL objective without aligned data and
  config['pack_tasks'] False give None.
  """
  if not config.get('pack_tasks', True):
    return None
  spec = getattr(objective, '_packed_spec', None)
  if spec is None:
    return None
  kind, weight = spec
  need_nll = kind in ('nll', 'nll_regkl')
  need_kl = kind in ('kl', 'nll_regkl')
  nll_subs = [s for s in dataset.values()
              if s.aligned is None and s.x.shape[0] > 0]
  kl_subs = [s for s in dataset.values()
             if s.aligned is not None and s.x.shape[0] > 0]
  if need_nll and (not nll_subs or any(s.y.shape[1] != 1 for s in nll_subs)):
    return None
  if need_kl and not kl_subs:
    # The divergence over no aligned sub-dataset is 0: the combined
    # objective reduces to the NLL.
    if kind == 'kl':
      return None
    need_kl = False

  batch_size = int(config.get('batch_size', 1 << 30))
  pad = int(config.get('train_pad_to_multiple', 8))
  pnll = (packed_lib.pack_dataset(dataset, pad_to_multiple=pad,
                                  device=device)[0] if need_nll else None)
  pekl = (packed_lib.pack_aligned_dataset(dataset, pad_to_multiple=pad,
                                          device=device)[0]
          if need_kl else None)

  def loss_fn(model, batch):
    bn, bk = batch
    shim = GPParams(model=model, config=config)
    total = 0.0
    if bn is not None:
      total = total + packed_lib.neg_log_marginal_likelihood_packed(
          mean_func, cov_func, shim, bn, warp_func=warp_func)
    if bk is not None:
      val = packed_lib.multivariate_normal_divergence_packed(
          mean_func, cov_func, shim, bk, warp_func=warp_func)
      total = total + (val if kind == 'kl' else weight * val)
    return total

  def subsample_fn(generator, d):
    bn, bk = d
    if bn is not None:
      bn = packed_lib.subsample_packed(generator, bn, batch_size)
    if bk is not None:
      bk = packed_lib.subsample_aligned_packed(generator, bk, batch_size)
    return bn, bk

  return loss_fn, (pnll, pekl), subsample_fn, kind == 'nll'


def infer_parameters(mean_func,
                     cov_func,
                     init_params: GPParams,
                     dataset,
                     warp_func=None,
                     objective=obj.neg_log_marginal_likelihood,
                     generator: Optional[torch.Generator] = None,
                     get_params_path=None,
                     callback=None,
                     device: Union[str, torch.device] = 'cuda') -> GPParams:
  """Fit GP (hyper)parameters to a multi-task dataset on `device`.

  config['method']: 'adam' (the packed route, multi-start with
  config['num_restarts'] > 1 and the plain NLL, else the host loop),
  'lbfgs' (on one subsample of batch_size rows a sub-dataset), 'bfgs' or
  'slice_sample'. Returns init_params with the trained model (Adam keeps
  it only where the final loss is finite) or the samples (params.samples,
  params.model the last one), and an emptied cache.

  `get_params_path()` names the checkpoint file: Adam saves the params
  and (step, loss) after every config['checkpoint_every'] steps and at
  the end, L-BFGS and the host-loop Adam at the end (core/params_io,
  the JAX package's pickle). With config['return_state'], the packed
  Adam run's optimizer state is kept in config['opt_state'], from which
  the next run resumes.
  """
  if not get_params_path:
    get_params_path = lambda x=0: None
  if not dataset:
    logging.info('No dataset present to train GP.')
    return init_params
  params = init_params
  config = params.config
  method = config['method']
  if method not in ('adam', 'lbfgs', 'bfgs', 'slice_sample'):
    raise ValueError(f'Optimization method {method} is not supported.')
  device = resolve_device(device)

  if method == 'lbfgs':
    # Subsample once so very large sub-datasets fit one factorization.
    dataset = next(divergences.sub_sample_dataset_iterator(
        generator, dataset, config['batch_size']))

  max_training_step = int(config['max_training_step'])
  if max_training_step <= 0 and method != 'slice_sample':
    return init_params
  model = convert.model_to(params.model, device)

  if method == 'adam':
    for route in ('distributed_mesh', 'task_mesh'):
      if config.get(route) is not None:
        raise _not_ported(f"config['{route}']")
    save_every = config.get('checkpoint_every', 0)
    periodic = callback is not None or bool(
        save_every and get_params_path() is not None)

    def chunk_hook(step, model, loss):
      # Snapshot the live parameters so that a crashed pre-training can
      # resume from the last checkpoint.
      params.model = model
      params_io.log_params_loss(
          step=step, params=params, loss=loss, warp_func=warp_func,
          params_save_file=get_params_path())
      if callback is not None:
        callback(step, model, loss)

    hook = chunk_hook if periodic else None
    packed_build = _build_packed_training(
        objective, dataset, config, mean_func, cov_func, warp_func, device)
    if packed_build is not None:
      loss_fn, data, subsample_fn, pure_nll = packed_build
      num_restarts = int(config.get('num_restarts', 1))
      if num_restarts > 1 and pure_nll:
        model, final_loss, _ = adam_lib.fit_adam_packed_multistart(
            mean_func, cov_func, model, data[0], config,
            warp_func=warp_func, generator=generator,
            num_restarts=num_restarts,
            perturb_scale=config.get('restart_perturb_scale', 1.0),
            callback=hook)
      else:
        out = adam_lib.fit_adam_scan(loss_fn, model, data, subsample_fn,
                                     config, generator=generator,
                                     callback=hook)
        model, final_loss = out[0], out[1][-1]
        if config.get('return_state'):
          config['opt_state'] = out[2]
      if bool(torch.isfinite(final_loss)):
        params.model = model
    else:
      def loss_func(model_params, batch):
        return objective(
            mean_func=mean_func, cov_func=cov_func,
            params=GPParams(model=model_params, config=config),
            dataset=batch, warp_func=warp_func)

      dataset_iter = divergences.sub_sample_dataset_iterator(
          generator, dataset, config['batch_size'])
      params.model, final_loss = adam_lib.fit_adam(
          loss_func, model, dataset_iter,
          learning_rate=config['learning_rate'],
          max_training_step=max_training_step, callback=callback)
    params_io.log_params_loss(
        step=max_training_step, params=params, loss=final_loss,
        warp_func=warp_func, params_save_file=get_params_path())
  elif method in ('lbfgs', 'bfgs'):
    def loss_func(model_params):
      return objective(
          mean_func=mean_func, cov_func=cov_func,
          params=GPParams(model=model_params, config=config),
          dataset=dataset, warp_func=warp_func)

    if method == 'bfgs':
      params.model, _ = qn.bfgs(loss_func, model, tol=config['tol'],
                                max_training_step=max_training_step)
    else:
      current_loss, params.model, _ = qn.lbfgs(
          loss_func, model, steps=max_training_step,
          alpha=config.get('alpha', 1.0), callback=callback)
      params_io.log_params_loss(
          step=max_training_step, params=params, loss=current_loss,
          warp_func=warp_func, params_save_file=get_params_path())
  else:
    # Sampling runs whatever max_training_step is, as in the JAX package.
    params.samples = _slice_sample(objective, params, dataset, mean_func,
                                   cov_func, warp_func, generator, callback,
                                   device)
    if params.samples:
      params.model = params.samples[-1]
  params.cache = {}
  return params


def _batched_nll(objective, dataset, config, mean_func, cov_func,
                 warp_func, device):
  """The packed NLL of a stack of models in one batched call (K1 for
  tasks of <= 128 rows), or None where the objective is not the plain NLL
  or the data does not pack (multi-output tasks, pack_tasks False)."""
  if getattr(objective, '_packed_spec', None) != ('nll', None):
    return None
  if not config.get('pack_tasks', True) or any(
      s.y.shape[1] != 1 for s in dataset.values()
      if s.aligned is None and s.x.shape[0] > 0):
    return None
  try:
    packed, _ = packed_lib.pack_dataset(
        dataset, pad_to_multiple=int(config.get('train_pad_to_multiple', 8)),
        device=device)
  except ValueError:
    return None

  def batched(stacked):
    return packed_lib.neg_log_marginal_likelihood_packed_batched(
        mean_func, cov_func, config, stacked, packed, warp_func=warp_func)

  return batched


def _slice_sample(objective, params, dataset, mean_func, cov_func,
                  warp_func, generator, callback, device):
  """params.samples of method 'slice_sample': the host sampler when a
  callback is given or config['slice_sampler'] is 'host', else the device
  sampler, whose evaluations batch over the chains through the packed NLL
  where the objective is the plain NLL."""
  config = params.config

  def loss_func(model_params):
    return objective(mean_func=mean_func, cov_func=cov_func,
                     params=GPParams(model=model_params, config=config),
                     dataset=dataset, warp_func=warp_func)

  model = convert.model_to(params.model, device)
  burnin = config.get('burnin', 50)
  nsamples = config.get('nsamples', 50)
  if callback is not None or config.get('slice_sampler',
                                        'ondevice') == 'host':
    return slice_lib.slice_sample(
        loss_func, model, generator, burnin=burnin, nsamples=nsamples,
        callback=callback,
        logging_interval=config.get('logging_interval', 10))
  return slice_lib.slice_sample_ondevice(
      loss_func, model, generator, burnin=burnin, nsamples=nsamples,
      num_chains=config.get('num_chains', 1),
      init_jitter=config.get('chain_init_jitter', 0.0),
      batched_objective_fn=_batched_nll(objective, dataset, config,
                                        mean_func, cov_func, warp_func,
                                        device))


def sample_from_gp(generator: Optional[torch.Generator],
                   mean_func,
                   cov_func,
                   params,
                   x,
                   warp_func=None,
                   num_samples=1,
                   method='cholesky',
                   eps=1e-6):
  """Draw function evaluations on x (n x d) from the GP: n x num_samples.

  `method` picks the factor F with F F^T = cov, as in
  jax.random.multivariate_normal: 'cholesky' (L), 'eigh' (V sqrt(w)) or
  'svd' (U sqrt(s)); the draws are mean + F z with z standard normal
  (_draw_normal).
  """
  if method not in ('cholesky', 'eigh', 'svd'):
    raise ValueError("method must be one of {'svd', 'eigh', 'cholesky'}, "
                     f'got {method!r}')
  mean = mean_func(params, x, warp_func=warp_func)
  noise_variance, = retrieve_params(
      params, ['noise_variance'], warp_func=warp_func)
  cov = cov_func(params, x, warp_func=warp_func)
  cov = cov + torch.eye(x.shape[0], dtype=cov.dtype, device=cov.device) * (
      noise_variance + eps)
  if method == 'cholesky':
    factor = chol_ops.cholesky(cov)
  elif method == 'eigh':
    w, v = torch.linalg.eigh(cov)
    factor = v * torch.sqrt(w)[None, :]
  else:
    u, s, _ = torch.linalg.svd(cov)
    factor = u * torch.sqrt(s)[None, :]
  z = _draw_normal(generator, (x.shape[0], num_samples), x.device)
  return mean.reshape(-1, 1) + torch.matmul(factor, z)


def _draw_normal(generator: Optional[torch.Generator], shape,
                 device) -> torch.Tensor:
  """Standard normal draws of `shape` on `device` (drawn on the
  generator's device)."""
  return torch.randn(shape, generator=generator,
                     device=generator.device if generator is not None
                     else device).to(device)


def predict(mean_func,
            cov_func,
            params,
            x_observed,
            y_observed,
            x_query,
            warp_func=None,
            full_cov=False,
            cache=None):
  """GP posterior at x_query given observations (prior if none).

  Returns (mu, cov): n' x 1 mean and n' x n' covariance (full_cov) or
  n' x 1 variances.
  """
  if x_observed is None or x_observed.shape[0] == 0:
    mu = mean_func(params, x_query, warp_func=warp_func)
    cov = cov_func(params, x_query, warp_func=warp_func, diag=not full_cov)
    return (mu, cov) if full_cov else (mu, cov[:, None])

  num_obs = cache.num_obs if cache is not None else None
  if cache is None:
    chol, kinvy, _ = linalg.solve_gp_linear_system(
        mean_func=mean_func, cov_func=cov_func, params=params,
        x=x_observed, y=y_observed, warp_func=warp_func)
  else:
    chol, kinvy = cache.chol, cache.kinvy
  if num_obs is not None:
    # Bucket-padded cache: chol/kinvy live in an N x N buffer with identity
    # rows beyond num_obs. Pad x_observed to match and mask the cross
    # covariance; padded rows then add exactly zero to the posterior.
    n_buf = chol.shape[0]
    pad = n_buf - x_observed.shape[0]
    if pad > 0:
      x_observed = torch.cat(
          [x_observed, x_observed.new_zeros((pad, x_observed.shape[1]))])
    valid = (torch.arange(n_buf, device=chol.device) < num_obs)[:, None]
    cross = cov_func(params, x_observed, x_query, warp_func=warp_func)
    cross = torch.where(valid, cross, 0.0)
  else:
    cross = cov_func(params, x_observed, x_query, warp_func=warp_func)
  mu = torch.matmul(cross.T, kinvy) + mean_func(
      params, x_query, warp_func=warp_func)
  v = chol_ops.solve_triangular(chol, cross, lower=True)
  if full_cov:
    cov = cov_func(params, x_query, warp_func=warp_func) - torch.matmul(
        v.T, v)
    return mu, cov
  var = cov_func(params, x_query, warp_func=warp_func,
                 diag=True) - torch.sum(v * v, dim=0)
  return mu, var[:, None]


def _append_rows(mean_func, cov_func, params, warp_func, buf, x_buf, y_buf,
                 start: int, stop: int):
  """Append rows [start, stop) to the padded Cholesky buffer with rank-1
  updates, then recompute the padded K^{-1}(y - mu). Rows >= stop keep an
  identity diagonal and a zero kinvy, so the padded posterior in
  `predict` is exact."""
  noise_variance, = retrieve_params(params, ['noise_variance'],
                                    warp_func=warp_func)
  for i in range(start, stop):
    xi = x_buf[i:i + 1]
    k_vec = cov_func(params, x_buf, xi, warp_func=warp_func)[:, 0]
    kappa = cov_func(params, xi, warp_func=warp_func,
                     diag=True)[0] + noise_variance + 1e-6
    buf = chol_ops.chol_append_padded(buf, i, k_vec, kappa)
  valid = (torch.arange(x_buf.shape[0], device=buf.device) < stop)[:, None]
  mu = torch.atleast_2d(mean_func(params, x_buf, warp_func=warp_func))
  delta = torch.where(valid, y_buf - mu, 0.0)
  kinvy = torch.where(valid, chol_ops.cho_solve(buf, delta), 0.0)
  return buf, kinvy


class GP:
  """A Gaussian process that supports pre-training on historical data.

  Attributes mirror the JAX class: dataset dict, mean_func, cov_func,
  params, warp_func, input_dim, rng (a torch.Generator on `device`).
  """

  dataset: Dict[Union[int, str], SubDataset]

  def __init__(self,
               dataset: defs.AllowedDatasetTypes,
               mean_func: Callable[..., torch.Tensor],
               cov_func: Callable[..., torch.Tensor],
               params: GPParams,
               warp_func: defs.WarpFuncType = None,
               device: Union[str, torch.device] = 'cuda'):
    self.device = resolve_device(device)
    self.mean_func = mean_func
    self.cov_func = cov_func
    self.params = params if params is not None else GPParams()
    self.warp_func = warp_func
    self.set_dataset(dataset)
    if 'objective' not in self.params.config:
      self.params.config['objective'] = obj.neg_log_marginal_likelihood
    self.rng: Optional[torch.Generator] = None

  def _tensor(self, a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=self.device)

  def _uses_mlp(self) -> bool:
    return ('mlp' in self.mean_func.__name__ or
            'mlp' in self.cov_func.__name__)

  def _embedding_dim(self) -> int:
    """Width of the kernel-input embedding: mlp output or raw inputs.

    Also fills in a default config['mlp_features'] when an mlp mean or
    kernel is used without one.
    """
    config = self.params.config
    if not self._uses_mlp():
      return self.input_dim
    if not isinstance(config.get('mlp_features'), tuple):
      config['mlp_features'] = (2 * self.input_dim,)
    return config['mlp_features'][-1]

  def _new_generator(self, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=self.device).manual_seed(seed)

  def initialize_params(self, generator: torch.Generator):
    """Initialize the parameters that depend on dataset shapes.

    Same contract as the JAX package: an objective string resolves to a
    function, mlp/linear-mean parameters are created unless present
    (Flax's lecun_normal kernels and zero biases, drawn from `generator`),
    and a float lengthscale broadcasts to one per embedding dimension.
    """
    if not self.dataset:
      raise ValueError('Cannot initialize GPParams without dataset.')
    config = self.params.config
    model = self.params.model
    if isinstance(config['objective'], str):
      if not hasattr(obj, config['objective']):
        raise _not_ported(f"objective {config['objective']!r}")
      config['objective'] = getattr(obj, config['objective'])

    emb_dim = self._embedding_dim()
    if self._uses_mlp() and 'mlp_params' not in model:
      bf.init_mlp_with_shape(generator, self.params, (0, self.input_dim),
                             device=self.device)
    if 'linear' in self.mean_func.__name__ and 'linear_mean' not in model:
      model['linear_mean'] = bf.dense_init(generator, emb_dim, 1,
                                           device=self.device)
    if isinstance(model.get('lengthscale'), float):
      ls_dim = emb_dim if 'mlp' in self.cov_func.__name__ else self.input_dim
      model['lengthscale'] = torch.ones(ls_dim) * model['lengthscale']
    self.params.model = convert.model_to(model, self.device)
    self.rng = generator

  def set_dataset(self, dataset):
    """Reset the GP dataset (list entries get integer keys); the data is
    moved to the GP's device as float32."""
    self.dataset = {}
    self.params.cache = {}
    if isinstance(dataset, list):
      dataset = {i: dataset[i] for i in range(len(dataset))}
    for key, val in dataset.items():
      sub = SubDataset(*val)
      self.dataset[key] = SubDataset(self._tensor(sub.x), self._tensor(sub.y),
                                     sub.aligned)

  @property
  def input_dim(self) -> int:
    key = list(self.dataset.keys())[0]
    return self.dataset[key].x.shape[1]

  def update_sub_dataset(self,
                         sub_dataset,
                         sub_dataset_key: Union[int, str] = 0,
                         is_append: bool = False):
    """Replace or append to a sub-dataset; marks its cache dirty."""
    sub_dataset = SubDataset(*sub_dataset)
    x = self._tensor(sub_dataset.x)
    y = self._tensor(sub_dataset.y)
    if is_append:
      if sub_dataset_key not in self.dataset:
        assert self.dataset, 'dataset cannot be empty.'
        self.dataset[sub_dataset_key] = SubDataset(
            x=x.new_empty((0, self.input_dim)), y=x.new_empty((0, 1)))
      old = self.dataset[sub_dataset_key]
      self.dataset[sub_dataset_key] = SubDataset(
          x=torch.vstack((old.x, x.reshape(-1, old.x.shape[1]))),
          y=torch.vstack((old.y, y.reshape(-1, 1))))
    else:
      self.dataset[sub_dataset_key] = SubDataset(x, y, sub_dataset.aligned)
      # Replacement invalidates the factor: the incremental path extends a
      # cached prefix, valid only when the old rows are a prefix of the new.
      self.params.cache.pop(sub_dataset_key, None)
      return
    if sub_dataset_key in self.params.cache:
      self.params.cache[sub_dataset_key].needs_update = True

  def train(self, generator: Optional[torch.Generator] = None,
            get_params_path=None, callback=None) -> GPParams:
    """Fit the GP to its dataset with the configured method/objective.

    `generator` draws the per-step subsamples; by default the GP's own
    `rng` (seeded with 0 when there is none).
    """
    if generator is None:
      if self.rng is None:
        self.rng = self._new_generator()
        logging.info('Using default random state in GP.train.')
      generator = self.rng
    self.params = infer_parameters(
        mean_func=self.mean_func,
        cov_func=self.cov_func,
        init_params=self.params,
        dataset=self.dataset,
        warp_func=self.warp_func,
        objective=self.params.config['objective'],
        generator=generator,
        get_params_path=get_params_path,
        callback=callback,
        device=self.device)
    return self.params

  def update_model_params(self, model_params: Dict[str, Any]):
    """Swap params.model; invalidates all caches."""
    self.params.model = model_params
    self.params.cache = {}

  @torch.no_grad()
  def setup_predictor(self, sub_dataset_key: Union[int, str] = 0):
    """Compute (or incrementally update) the Cholesky cache.

    When observations were appended to a cached sub-dataset (the BO
    loop's access pattern), the factor is extended with O(n^2) rank-1
    appends inside a power-of-two bucket buffer (GPCache.num_obs marks the
    valid prefix) instead of an O(n^3) refactorization. Replacement or new
    parameters recompute it in full. The cached factor and K^{-1} y carry
    no autograd graph.
    """
    cache = self.params.cache.get(sub_dataset_key)
    if cache is not None and not cache.needs_update:
      return
    self.params.model = convert.model_to(self.params.model, self.device)
    x = self.dataset[sub_dataset_key].x
    y = self.dataset[sub_dataset_key].y
    n_new = x.shape[0]
    n_old = 0 if cache is None else (
        cache.num_obs if cache.num_obs is not None else cache.chol.shape[0])
    if (cache is not None and cache.needs_update and
        self.params.config.get('incremental_cache', True) and
        0 < n_old < n_new and
        n_new - n_old <= max(64, n_old) and y.shape[1] == 1):
      bucket = max(64, 1 << (n_new - 1).bit_length())
      if cache.num_obs is not None and cache.chol.shape[0] >= n_new:
        bucket = cache.chol.shape[0]
        buf = cache.chol
      else:
        buf = chol_ops.init_chol_buffer(bucket, device=self.device)
        buf[:n_old, :n_old] = cache.chol[:n_old, :n_old]
      x_buf = x.new_zeros((bucket, x.shape[1]))
      x_buf[:n_new] = x
      y_buf = y.new_zeros((bucket, 1))
      y_buf[:n_new] = y
      buf, kinvy = _append_rows(self.mean_func, self.cov_func, self.params,
                                self.warp_func, buf, x_buf, y_buf, n_old,
                                n_new)
      self.params.cache[sub_dataset_key] = GPCache(
          chol=buf, kinvy=kinvy, needs_update=False, num_obs=n_new)
    else:
      chol, kinvy, _ = linalg.solve_gp_linear_system(
          mean_func=self.mean_func,
          cov_func=self.cov_func,
          params=self.params,
          x=x,
          y=y,
          warp_func=self.warp_func)
      self.params.cache[sub_dataset_key] = GPCache(
          chol=chol, kinvy=kinvy, needs_update=False)

  def predict(self,
              queried_inputs,
              sub_dataset_key: Union[int, str] = 0,
              full_cov: bool = False,
              with_noise: bool = True,
              unbiased: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior (mu, cov-or-var) at queried inputs for one sub-dataset.

    Differentiable with respect to `queried_inputs`, as the JAX package's
    is; the cached factor and K^{-1} y it reads are constants.
    """
    queried_inputs = self._tensor(queried_inputs)
    if sub_dataset_key not in self.dataset:
      self.params.model = convert.model_to(self.params.model, self.device)
      mu, cov = predict(
          mean_func=self.mean_func, cov_func=self.cov_func,
          params=self.params, x_observed=None, y_observed=None,
          x_query=queried_inputs, warp_func=self.warp_func,
          full_cov=full_cov)
    else:
      self.setup_predictor(sub_dataset_key)
      mu, cov = predict(
          mean_func=self.mean_func, cov_func=self.cov_func,
          params=self.params,
          x_observed=self.dataset[sub_dataset_key].x,
          y_observed=self.dataset[sub_dataset_key].y,
          x_query=queried_inputs, warp_func=self.warp_func,
          full_cov=full_cov, cache=self.params.cache[sub_dataset_key])

    if with_noise:
      noise_variance, = retrieve_params(
          self.params, ['noise_variance'], warp_func=self.warp_func)
      if full_cov:
        cov = cov + torch.eye(cov.shape[0], device=cov.device) * (
            noise_variance)
      else:
        cov = cov + noise_variance
    if unbiased:
      # Rescale by N/(N-1) over the number of unaligned sub-datasets: the
      # pre-trained covariance is a biased estimate of task covariance.
      len_dataset = len(
          [k for k, v in self.dataset.items() if v.aligned is None])
      if len_dataset > 1:
        cov = cov * (len_dataset / (len_dataset - 1.))
    return mu, cov

  def neg_log_marginal_likelihood(self):
    """(total_nll, key -> nll dict) through the SVD evaluation."""
    return obj.neg_log_marginal_likelihood(
        mean_func=self.mean_func,
        cov_func=self.cov_func,
        params=self.params,
        dataset=self.dataset,
        warp_func=self.warp_func,
        return_key2nll=True,
        use_cholesky=False)

  def empirical_divergence(
      self, distance=divergences.kl_multivariate_normal):
    """Divergence between sample MVN stats and the model on aligned data,
    one aligned sub-dataset after another."""
    return obj.multivariate_normal_divergence(
        mean_func=self.mean_func,
        cov_func=self.cov_func,
        params=self.params,
        dataset=self.dataset,
        warp_func=self.warp_func,
        distance=distance)

  def empirical_divergence_packed(self, partial: bool = True,
                                  eps: float = 1e-6):
    """EKL (full or partial) over the aligned sub-datasets in one batched
    pass; 0 when there is no aligned data."""
    try:
      packed, _ = packed_lib.pack_aligned_dataset(self.dataset,
                                                  device=self.device)
    except ValueError:
      return 0.
    return packed_lib.multivariate_normal_divergence_packed(
        self.mean_func, self.cov_func, self.params, packed,
        warp_func=self.warp_func, partial=partial, eps=eps)

  @torch.no_grad()
  def stats(self, verbose=True):
    """(nll, ekl, ekl_partial, euc, key2nll) of the current model.

    Every dense factorization in it goes through ops/chol.cholesky, so the
    routes set there (kernels K6 and K7) serve it.
    """
    self.params.model = convert.model_to(self.params.model, self.device)
    nll, key2nll = self.neg_log_marginal_likelihood()
    ekl = self.empirical_divergence_packed(partial=False, eps=1e-6)
    ekl_partial = self.empirical_divergence_packed(partial=True, eps=1e-6)
    euc = self.empirical_divergence(
        distance=divergences.euclidean_multivariate_normal)
    msg = (f'nll = {nll}, ekl = {ekl}, ekl_partial = {ekl_partial}, '
           f'euc = {euc}')
    if verbose:
      print(msg)
    logging.info(msg)
    return nll, ekl, ekl_partial, euc, key2nll


class HGP(GP):
  """Hierarchical GP: averages stats and predictions over the posterior
  samples of its parameters (params.samples, from method
  'slice_sample')."""

  def get_model_params_samples(self):
    """params.samples if present, else the single point estimate."""
    if self.params.samples:
      return self.params.samples
    return [self.params.model]

  def stats(self, verbose: bool = True):
    """GP.stats of every sample: the mean (nll, ekl, ekl_partial, euc) and
    the per-key NLL averaged over the samples."""
    samples = self.get_model_params_samples()
    all_stats = []
    all_key2nll = collections.defaultdict(float)
    key2nll = {}
    for model_params in samples:
      self.update_model_params(model_params)
      nll, ekl, ekl_partial, euc, key2nll = super().stats(verbose=False)
      all_stats.append([float(v) for v in (nll, ekl, ekl_partial, euc)])
      for k in key2nll:
        all_key2nll[k] += float(key2nll[k])
    for k in key2nll:
      all_key2nll[k] /= len(samples)
    nll, ekl, ekl_partial, euc = torch.tensor(
        all_stats, dtype=torch.float64).mean(dim=0).tolist()
    msg = (f'HGP nll = {nll}, ekl = {ekl}, ekl_partial = {ekl_partial}, '
           f'euc = {euc}')
    if verbose:
      print(msg)
    logging.info(msg)
    return nll, ekl, ekl_partial, euc, dict(all_key2nll)

  def predict(self,  # pylint: disable=arguments-differ
              queried_inputs,
              sub_dataset_key: Union[int, str] = 0,
              full_cov: bool = False,
              with_noise: bool = True):
    """One (mu, cov) pair per posterior sample, each through GP.predict;
    params.model is left at the last sample."""
    results = []
    for model_params in self.get_model_params_samples():
      self.update_model_params(model_params)
      results.append(super().predict(
          queried_inputs=queried_inputs,
          sub_dataset_key=sub_dataset_key,
          full_cov=full_cov,
          with_noise=with_noise))
    return results

  def predict_stacked(self,
                      queried_inputs,
                      sub_dataset_key: Union[int, str] = 0,
                      with_noise: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every sample's posterior (mu, var), each (S, n', 1), in one pass.

    The S samples are stacked on a leading axis: their systems are built
    at once (torch.func.vmap), factored by ONE batched call of
    ops/chol.cholesky and solved batched. The variances carry the noise
    (with_noise) and GP.predict's N/(N-1) rescale over the unaligned
    sub-datasets.
    """
    x_query = self._tensor(queried_inputs)
    stacked = convert.stack_models(self.get_model_params_samples(),
                                   self.device)
    config = self.params.config
    mean_func, cov_func, warp_func = (self.mean_func, self.cov_func,
                                      self.warp_func)

    def shim(model):
      return GPParams(model=model, config=config)

    sub = self.dataset.get(sub_dataset_key)
    if sub is not None and sub.x.shape[0] > 0:
      delta, cov = torch.func.vmap(
          lambda m: linalg.compute_delta_y_and_cov(
              mean_func, cov_func, shim(m), sub.x, sub.y, warp_func))(stacked)
      chol = chol_ops.cholesky(cov)
      kinvy = chol_ops.cho_solve(chol, delta)

      def one(model, chol, kinvy):
        return predict(mean_func, cov_func, shim(model), sub.x, sub.y,
                       x_query, warp_func=warp_func,
                       cache=GPCache(chol=chol, kinvy=kinvy,
                                     needs_update=False))

      mu, var = torch.func.vmap(one)(stacked, chol, kinvy)
    else:
      mu, var = torch.func.vmap(lambda m: predict(
          mean_func, cov_func, shim(m), None, None, x_query,
          warp_func=warp_func))(stacked)
    if with_noise:
      noise_variance, = retrieve_params(stacked, ['noise_variance'],
                                        warp_func=warp_func)
      var = var + noise_variance.reshape(-1, 1, 1)
    n_unaligned = len(
        [k for k, v in self.dataset.items() if v.aligned is None])
    if n_unaligned > 1:
      var = var * (n_unaligned / (n_unaligned - 1.))
    return mu, var
