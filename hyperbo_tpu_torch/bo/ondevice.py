"""On-device Bayesian-optimization loops, GP branch (port of
hyperbo_tpu/bo/ondevice.py).

The simulated BO loop over a finite candidate set runs with no read of the
device until it ends:

  * preallocated observation buffers of n_max rows and an identity-padded
    factor buffer, all of fixed shape;
  * the factor is W = L^{-1}, grown by one row a step
    (ops/chol.winv_append_padded), so the posterior and the append are
    products only, with no triangular solve;
  * every candidate is scored each step (cross-Gram, posterior,
    acquisition) and the argmax stays a device tensor; the picked row is
    taken with index_select, never read back.

The JAX package runs each loop as one compiled lax.scan. Here each is a
Python loop of fixed-shape steps: the observation count and the retrain
schedule depend only on the step index (count = n_init + i q), so they are
Python ints, and the only values that depend on the data, the selected
indices, stay on the device.

Five runners, as in the JAX package: the plain loop (`make_bo_runner`),
kriging-believer q-batch selection (`make_bo_qbatch_runner`), periodic
in-loop retraining with plain Adam on the corpus NLL
(`make_bo_retrain_runner`), and under an HGP the S posterior samples on a
leading axis: fixed (`make_bo_hgp_runner`) or advanced by slice-sampling
sweeps on the corpus posterior between selections
(`make_bo_resample_runner`). The HGP runners build every sample's
posterior and append with torch.func.vmap over the GP runners' pieces, and
average the acquisition over the samples. `run_bayesopt_ondevice`
dispatches a built GP or HGP to one of them. The continuous-domain runner
(`make_bo_continuous_runner`, `continuous_bayesopt_ondevice`) draws a
pool of inputs each iteration and refines its acquisition argmax by
projected gradient ascent, for an oracle that is a torch function. The
mesh routes wait (ROADMAP Queue A) and raise. Only the default factor of
HYPERBO_BO_SOLVER, 'winv', is ported.

The re-sampling runner alone reads the device inside its loop: its slice
sampler reads one flag a chunk of shrinkage trips (train/slice_sampler).
Its corpus log prob is evaluated for every chain (and every stepping-out
edge) in one batched call, so one launch of kernel K1 factors all of their
corpus tasks.

Randomness ('rand' and 'ts', the HGP's sample index, the continuous
pools) comes from a torch.Generator on the device, through `_draw_index`,
`_draw_normal` and `_draw_uniform`,
and the re-sampling's through train/slice_sampler's draws, the one place
each draw is made, so that a test can substitute the JAX package's draws.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch

from hyperbo_tpu_torch.bo import acfun
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs
from hyperbo_tpu_torch.core.warp import retrieve_params
from hyperbo_tpu_torch.models import gp as gp_lib
from hyperbo_tpu_torch.models import packed as packed_lib
from hyperbo_tpu_torch.ops import chol as chol_ops
from hyperbo_tpu_torch.ops import linalg
from hyperbo_tpu_torch.train import adam as adam_lib
from hyperbo_tpu_torch.train import slice_sampler as slice_lib

SubDataset = defs.SubDataset

_ACQ_SUBS = {
    'ei': (acfun.expected_improvement_sub, 'best_y'),
    'pi': (acfun.probability_of_improvement_sub, 'best_y_zeta'),
    'pi2': (acfun.probability_of_improvement_sub, 'best_y_zeta_std'),
    'pi3': (acfun.probability_of_improvement_sub, 'best_y_zeta05'),
    'ucb': (acfun.ucb_sub, 'beta3'),
    'ucb2': (acfun.ucb_sub, 'beta2'),
    'ucb3': (acfun.ucb_sub, 'beta3'),
    'ucb4': (acfun.ucb_sub, 'beta4'),
    'rand': (None, 'rand'),
    # Thompson sampling over the finite candidate set: argmax of one
    # posterior draw per candidate (diagonal covariance).
    'ts': (None, 'ts'),
}


def _draw_index(generator: torch.Generator, n: int, device) -> torch.Tensor:
  """0-d int64 index, uniform on [0, n) ('rand')."""
  return torch.randint(n, (), generator=generator,
                       device=generator.device).to(device)


def _draw_normal(generator: torch.Generator, shape, device) -> torch.Tensor:
  """Standard normals of `shape` (the 'ts' draw)."""
  return torch.randn(shape, generator=generator,
                     device=generator.device).to(device)


def _draw_uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
  """Uniforms on [0, 1) of `shape` (the continuous loop's pool)."""
  return torch.rand(shape, generator=generator,
                    device=generator.device).to(device)


def _acq_param(kind: str, y_buf, mask, count: int):
  """The acquisition's target or coefficient from the first `count` rows of
  y_buf (0 with no observations, as the host callbacks)."""
  if kind in ('best_y', 'best_y_zeta', 'best_y_zeta05', 'best_y_zeta_std'):
    if count == 0:
      return 0.0
    y = y_buf[:, 0]
    best = torch.max(torch.where(mask, y, float('-inf')))
    if kind == 'best_y':
      return best
    if kind == 'best_y_zeta':
      return best + 0.1
    if kind == 'best_y_zeta05':
      return best + 0.05
    # pi2: best + 0.1 std(y), the population std (as jnp.std).
    mean = torch.sum(torch.where(mask, y, 0.0)) / count
    var = torch.sum(torch.where(mask, (y - mean)**2, 0.0)) / count
    return best + 0.1 * torch.sqrt(var)
  if kind == 'beta2':
    return 2.0
  if kind == 'beta4':
    return 4.0
  return 3.0


def _ts_index(mu, var_noisy, noise_variance, scale, normal):
  """Thompson-sampling index from ONE posterior draw of the latent f.

  _masked_posterior returns the noisy predictive variance
  ((var_f + noise) scale); the draw is of f, so the offset and scale are
  taken back out: var_f = max(var_noisy / scale - noise, 1e-12).
  """
  var_f = torch.clamp(var_noisy / scale - noise_variance, min=1e-12)
  return torch.argmax((mu + torch.sqrt(var_f) * normal).flatten())


def _acq_scores(acq_sub, kind, mu, var, y_buf, count: int):
  """The closed-form acquisition of the posterior (mu, var)."""
  mask = torch.arange(y_buf.shape[0], device=y_buf.device) < count
  return acq_sub(mu, torch.sqrt(var), _acq_param(kind, y_buf, mask, count))


def _greedy_index(acq_sub, kind, mu, var, y_buf, count: int):
  """argmax of the closed-form acquisition (shared by every loop)."""
  return torch.argmax(_acq_scores(acq_sub, kind, mu, var, y_buf,
                                  count).flatten())


def _select(acq_sub, kind, generator, cand_x, mu, var, noise_variance,
            scale, y_buf, count: int):
  """The candidate one pick takes, as a 0-d index on the device: a uniform
  draw ('rand', which reads neither mu nor var), the argmax of one
  posterior draw ('ts') or of the closed-form acquisition. 'rand' and 'ts'
  draw once a pick, in every runner."""
  if kind == 'rand':
    return _draw_index(generator, cand_x.shape[0], cand_x.device)
  if kind == 'ts':
    return _ts_index(mu, var, noise_variance, scale,
                     _draw_normal(generator, tuple(mu.shape), mu.device))
  return _greedy_index(acq_sub, kind, mu, var, y_buf, count)


def _unbiased_scale(num_train_tasks: int) -> float:
  """GP.predict's N/(N-1) rescale with N = train tasks + the test task."""
  n_tasks = num_train_tasks + 1
  return n_tasks / (n_tasks - 1.0) if n_tasks > 1 else 1.0


def _bo_solver() -> str:
  """The factor the loops carry: 'winv' (W = L^{-1}), the JAX package's
  default and the only one ported."""
  solver = os.environ.get('HYPERBO_BO_SOLVER', 'winv')
  if solver != 'winv':
    raise NotImplementedError(
        f'HYPERBO_BO_SOLVER={solver!r}: the port carries W = L^-1 only '
        "('winv'); the L buffer was a TPU A/B probe: see ROADMAP Queue C")
  return solver


def _masked_posterior(mean_func, cov_func, shim, warp_func,
                      noise_variance, scale, x_buf, y_buf, fac_buf,
                      count: int, cand_x):
  """GP posterior (mu, var) at cand_x from the buffers' first `count` rows:
  GP.predict's semantics with the noise added and the unbiased rescale
  (`noise_variance` 0 and `scale` 1 leave either out), and the prior with
  no observations. `fac_buf` is W = L^{-1}, identity-padded."""
  _bo_solver()
  kdiag = cov_func(shim, cand_x, warp_func=warp_func, diag=True)
  if count == 0:
    mu = mean_func(shim, cand_x, warp_func=warp_func)
    return mu, (kdiag[:, None] + noise_variance) * scale
  mask = (torch.arange(x_buf.shape[0], device=x_buf.device) < count)[:, None]
  delta = torch.where(mask, y_buf - mean_func(shim, x_buf,
                                              warp_func=warp_func), 0.0)
  cross = torch.where(mask, cov_func(shim, x_buf, cand_x,
                                     warp_func=warp_func), 0.0)
  kinvy = torch.matmul(fac_buf.T, torch.matmul(fac_buf, delta))
  v = torch.matmul(fac_buf, cross)
  mu = (torch.matmul(cross.T, kinvy) +
        mean_func(shim, cand_x, warp_func=warp_func))
  var = torch.clamp(kdiag - torch.sum(v * v, dim=0), min=1e-12)[:, None]
  return mu, (var + noise_variance) * scale


def _make_corpus_loss(mean_func, cov_func, config, warp_func, n_max,
                      pretrain_packed=None, aligned_packed=None,
                      ekl_weight: float = 0.0, ekl_partial: bool = True,
                      eps: float = 1e-6):
  """loss(model, x_buf, y_buf, count): _corpus_loss over a fixed corpus
  (the retrain runner's objective)."""
  def loss(model, x_buf, y_buf, count):
    return _corpus_loss(mean_func, cov_func, config, warp_func, n_max,
                        model, x_buf, y_buf, count,
                        pretrain_packed=pretrain_packed,
                        aligned_packed=aligned_packed,
                        ekl_weight=ekl_weight, ekl_partial=ekl_partial,
                        eps=eps)

  return loss


def _corpus_loss(mean_func, cov_func, config, warp_func, n_max, model,
                 x_buf, y_buf, count: int, pretrain_packed=None,
                 aligned_packed=None, ekl_weight: float = 0.0,
                 ekl_partial: bool = True, eps: float = 1e-6):
  """The host training objective in buffer form: the mean per-task NLL over
  the packed pre-training corpus and the masked test task (its first
  `count` rows), plus ekl_weight * EKL over the aligned pack when both are
  given, minus the hyperprior log-probs once."""
  config = dict(config or {})
  config_nopriors = {k: v for k, v in config.items() if k != 'priors'}
  p = defs.GPParams(model=model, config=config_nopriors)
  mask = torch.arange(n_max, device=x_buf.device) < count
  nll_test = packed_lib.nll_one_task(
      mean_func, cov_func, p, x_buf, y_buf, mask, count,
      warp_func=warp_func, eps=eps)
  w_test = 1.0 if count > 0 else 0.0
  if pretrain_packed is not None:
    t_real = torch.sum(pretrain_packed.task_mask).to(nll_test.dtype)
    mean_pre = packed_lib.neg_log_marginal_likelihood_packed(
        mean_func, cov_func, p, pretrain_packed, warp_func=warp_func,
        eps=eps)
    total = ((mean_pre * t_real + w_test * nll_test) /
             torch.clamp(t_real + w_test, min=1.0))
  else:
    total = w_test * nll_test
  if aligned_packed is not None and ekl_weight:
    total = total + ekl_weight * (
        packed_lib.multivariate_normal_divergence_packed(
            mean_func, cov_func, p, aligned_packed, warp_func=warp_func,
            partial=ekl_partial))
  if 'priors' in config:
    total = _minus_priors(config, warp_func, model, total)
  return total


def _corpus_loss_batched(mean_func, cov_func, config, warp_func, n_max,
                         stacked, x_buf, y_buf, count: int,
                         pretrain_packed=None, aligned_packed=None,
                         ekl_weight: float = 0.0, ekl_partial: bool = True,
                         eps: float = 1e-6) -> torch.Tensor:
  """_corpus_loss of every model of a stack (leaves with a leading axis B)
  in one pass: (B,). The corpus tasks of all B models go to one batched
  factorization (one launch of kernel K1 in its regime), the test task's B
  systems to one batched Cholesky; each value equals _corpus_loss's."""
  config = dict(config or {})
  config_nopriors = {k: v for k, v in config.items() if k != 'priors'}
  mask = torch.arange(n_max, device=x_buf.device) < count
  kmat, delta = packed_lib.batched_masked_system(
      mean_func, cov_func, config_nopriors, stacked, x_buf, y_buf, mask,
      warp_func=warp_func, eps=eps)
  nll_test = packed_lib.dense_nll(kmat, delta, count)
  w_test = 1.0 if count > 0 else 0.0
  if pretrain_packed is not None:
    t_real = torch.sum(pretrain_packed.task_mask).to(nll_test.dtype)
    mean_pre = packed_lib.neg_log_marginal_likelihood_packed_batched(
        mean_func, cov_func, config_nopriors, stacked, pretrain_packed,
        warp_func=warp_func, eps=eps)
    total = ((mean_pre * t_real + w_test * nll_test) /
             torch.clamp(t_real + w_test, min=1.0))
  else:
    total = w_test * nll_test
  if aligned_packed is not None and ekl_weight:
    total = total + ekl_weight * torch.stack([
        packed_lib.multivariate_normal_divergence_packed(
            mean_func, cov_func,
            defs.GPParams(model=convert.model_at(stacked, r),
                          config=config_nopriors),
            aligned_packed, warp_func=warp_func, partial=ekl_partial)
        for r in range(convert.stack_size(stacked))])
  if 'priors' in config:
    total = torch.func.vmap(
        lambda m, t: _minus_priors(config, warp_func, m, t))(stacked, total)
  return total


def _minus_priors(config, warp_func, model, total):
  """total minus the hyperprior log-probs of the model, one after another
  in the model's key order."""
  pw = defs.GPParams(model=model, config=config)
  for k in model:
    if k in config['priors']:
      val, = retrieve_params(pw, [k], warp_func)
      total = total - config['priors'][k](val)
  return total


def _test_system(cov_func, config, warp_func, model, x_buf, count: int,
                 eps: float = 1e-6):
  """The test task's masked K on the first `count` rows (padded rows
  identity)."""
  p = defs.GPParams(model=model, config=config)
  nv, = retrieve_params(p, ['noise_variance'], warp_func=warp_func)
  n_max = x_buf.shape[0]
  mask = torch.arange(n_max, device=x_buf.device) < count
  kmat = cov_func(p, x_buf, warp_func=warp_func)
  pair = mask[:, None] & mask[None, :]
  eye = torch.eye(n_max, dtype=kmat.dtype, device=kmat.device)
  return torch.where(pair, kmat, 0.0) + eye * torch.where(mask, nv + eps,
                                                          1.0)


def _masked_refactor(mean_func, cov_func, config, warp_func, model,
                     x_buf, count: int, eps: float = 1e-6):
  """From-scratch W = L^{-1} of the test task's system on the first `count`
  rows (padded rows identity, so later appends extend it)."""
  del mean_func
  _bo_solver()
  kmat = _test_system(cov_func, config, warp_func, model, x_buf, count, eps)
  return linalg.tri_inv_blocked(chol_ops.cholesky(kmat))


def _masked_refactor_all(cov_func, config, warp_func, stacked, x_buf,
                         count: int, eps: float = 1e-6):
  """_masked_refactor of every model of a stack: the S systems built at
  once, factored by one batched Cholesky, each inverted."""
  _bo_solver()
  kmat = torch.func.vmap(lambda m: _test_system(
      cov_func, config, warp_func, m, x_buf, count, eps))(stacked)
  return torch.func.vmap(linalg.tri_inv_blocked)(chol_ops.cholesky(kmat))


def _append_factor(cov_func, shim, warp_func, noise_variance, eps,
                   x_buf, fac_buf, count, x_new):
  """Rank-1 append of W for one new observation x_new (1, d)."""
  _bo_solver()
  k_vec = cov_func(shim, x_buf, x_new, warp_func=warp_func)[:, 0]
  kappa = cov_func(shim, x_new, warp_func=warp_func,
                   diag=True)[0] + noise_variance + eps
  return chol_ops.winv_append_padded(fac_buf, count, k_vec, kappa)


def _append(cov_func, shim, warp_func, noise_variance, eps, state, x_new,
            y_new):
  """The state with observation (x_new (1, d), y_new (1, 1)) appended: the
  factor grown and the buffers' row `count` written in place (the runners
  own their buffers)."""
  x_buf, y_buf, fac_buf, count = state
  fac_buf = _append_factor(cov_func, shim, warp_func, noise_variance, eps,
                           x_buf, fac_buf, count, x_new)
  x_buf[count:count + 1] = x_new
  y_buf[count:count + 1] = y_new.reshape(1, 1)
  return x_buf, y_buf, fac_buf, count + 1


def _append_pick(cov_func, shim, warp_func, noise_variance, eps, state,
                 cand_x, y_src, idx):
  """The state with candidate `idx` appended: its x from cand_x and its y
  from the rows of y_src (the candidates' true values, or the posterior
  mean a q-batch believes), gathered on the device."""
  row = idx.reshape(1)
  return _append(cov_func, shim, warp_func, noise_variance, eps, state,
                 cand_x.index_select(0, row), y_src.index_select(0, row))


def _noise(shim, warp_func):
  nv, = retrieve_params(shim, ['noise_variance'], warp_func=warp_func)
  return nv


def build_bo_step(mean_func, cov_func, config, warp_func,
                  acquisition: str, n_max: int, num_train_tasks: int,
                  eps: float = 1e-6):
  """The per-iteration BO step over preallocated buffers:
  step(model, state, generator, cand_x, cand_y) -> (state, select_idx).

  State: (x_buf (N, d), y_buf (N, 1), fac_buf (N, N), count), count a
  Python int. The candidates (n_c, d) with their y values (n_c, 1) are
  passed whole; select_idx is a 0-d int64 tensor on the device.
  """
  del n_max  # The buffers carry it.
  acq_sub, kind = _ACQ_SUBS[acquisition]
  scale = _unbiased_scale(num_train_tasks)

  def step(model, state, generator, cand_x, cand_y):
    shim = defs.GPParams(model=model, config=config)
    nv = _noise(shim, warp_func)
    x_buf, y_buf, fac_buf, count = state
    mu = var = None
    if kind != 'rand':
      mu, var = _masked_posterior(mean_func, cov_func, shim, warp_func, nv,
                                  scale, x_buf, y_buf, fac_buf, count,
                                  cand_x)
    idx = _select(acq_sub, kind, generator, cand_x, mu, var, nv, scale,
                  y_buf, count)
    state = _append_pick(cov_func, shim, warp_func, nv, eps, state, cand_x,
                         cand_y, idx)
    return state, idx

  return step


def _seed(cov_func, config, warp_func, eps, model, state, x0, y0):
  """Append the initial observations (x0 (n_init, d), y0 (n_init, 1))."""
  shim = defs.GPParams(model=model, config=config)
  nv = _noise(shim, warp_func)
  for i in range(x0.shape[0]):
    state = _append(cov_func, shim, warp_func, nv, eps, state,
                    x0[i:i + 1], y0[i:i + 1])
  return state


def _check_capacity(n_max: int, n_obs: int):
  if n_obs > n_max:
    raise ValueError(f'the buffers hold n_max = {n_max} observations, the '
                     f'run makes {n_obs}')


def make_bo_runner(mean_func, cov_func, config, warp_func,
                   acquisition: str, iters: int, n_init: int,
                   n_max: int, num_train_tasks: int):
  """The plain BO runner, run(model, x_buf, y_buf, fac_buf, count, x0, y0,
  cand_x, cand_y, generator, return_factor=False) -> (x_buf, y_buf,
  select_idx[, fac_buf]): the n_init rows of (x0, y0) appended, then
  `iters` steps of build_bo_step. The input buffers are not changed.

  The JAX package compiles this runner once for all same-shaped calls; an
  eager runner has nothing to compile, and the factory keeps the JAX API's
  call shape.
  """
  _bo_solver()
  _check_capacity(n_max, n_init + iters)
  step = build_bo_step(mean_func, cov_func, config, warp_func,
                       acquisition, n_max, num_train_tasks)

  @torch.no_grad()
  def run(model, x_buf, y_buf, fac_buf, count, x0, y0, cand_x, cand_y,
          generator, return_factor=False):
    state = (x_buf.clone(), y_buf.clone(), fac_buf.clone(), count)
    state = _seed(cov_func, config, warp_func, 1e-6, model, state, x0, y0)
    select_idx = torch.empty((iters,), dtype=torch.int64,
                             device=cand_x.device)
    for i in range(iters):
      state, select_idx[i] = step(model, state, generator, cand_x, cand_y)
    out = (state[0], state[1], select_idx)
    return out + (state[2],) if return_factor else out

  return run


def _device_of(x, device) -> torch.device:
  """The device of tensor inputs, else `device` resolved (CUDA raises
  without a card)."""
  if torch.is_tensor(x):
    return x.device
  return gp_lib.resolve_device(device)


def _inputs(queried_sub_dataset, init_obs, device):
  """(cand_x, cand_y, x0, y0) as float32 tensors on `device`."""
  def f32(a):
    return torch.as_tensor(a, dtype=torch.float32, device=device)

  cand_x, cand_y = f32(queried_sub_dataset.x), f32(queried_sub_dataset.y)
  d = cand_x.shape[1]
  if init_obs is None:
    return (cand_x, cand_y, cand_x.new_zeros((0, d)),
            cand_x.new_zeros((0, 1)))
  return cand_x, cand_y, f32(init_obs[0]), f32(init_obs[1]).reshape(-1, 1)


def _generator(generator, device) -> torch.Generator:
  """The caller's generator, or one on `device` seeded 0 (the JAX
  package's PRNGKey(0) default)."""
  if generator is not None:
    return generator
  return torch.Generator(device=device).manual_seed(0)


def _no_mesh(mesh):
  if mesh is not None:
    raise gp_lib._not_ported('the on-device BO loops over a mesh (mesh=)')


def simulated_bayesopt_ondevice(
    mean_func,
    cov_func,
    model_params,
    config,
    warp_func,
    queried_sub_dataset: SubDataset,
    iters: int,
    acquisition: str = 'ei',
    num_train_tasks: int = 0,
    init_obs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    n_max: Optional[int] = None,
    mesh=None,
    mesh_axis: str = 'task',
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device] = 'cuda',
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Run `iters` BO iterations on the device, with no read back until the
  loop ends.

  Args:
    mean_func / cov_func / model_params / config / warp_func: the GP.
    queried_sub_dataset: finite candidate set (x: n_c x d, y: n_c x 1).
    iters: number of sequential selections.
    acquisition: any _ACQ_SUBS key: 'ei', 'pi', 'pi2', 'pi3', 'ucb',
      'ucb2', 'ucb3', 'ucb4', 'ts' (Thompson sampling) or 'rand'.
    num_train_tasks: number of unaligned pre-training tasks (the unbiased
      predictive rescale, as GP.predict).
    init_obs: optional (x0, y0) initial observations of the test task.
    n_max: observation buffer capacity; defaults to init + iters.
    mesh / mesh_axis: the multi-device route, not ported (raises).
    generator: draws 'rand' and 'ts' (default: seeded 0 on the device).
    device: where to run when the candidates are not tensors (the CUDA
      card unless the caller asks for the CPU); tensors keep their device.

  Returns:
    (x_observed, y_observed, selected_indices): the init and selected
    observations in order, and the per-iteration candidate indices.
  """
  del mesh_axis
  _no_mesh(mesh)
  device = _device_of(queried_sub_dataset.x, device)
  cand_x, cand_y, x0, y0 = _inputs(queried_sub_dataset, init_obs, device)
  n_init = x0.shape[0]
  if n_max is None:
    n_max = n_init + iters
  d = cand_x.shape[1]
  run = make_bo_runner(mean_func, cov_func, config, warp_func,
                       acquisition, iters, n_init, n_max, num_train_tasks)
  x_out, y_out, select_idx = run(
      convert.model_to(model_params, device),
      cand_x.new_zeros((n_max, d)), cand_x.new_zeros((n_max, 1)),
      chol_ops.init_chol_buffer(n_max, device=device), 0, x0, y0, cand_x,
      cand_y, _generator(generator, device))
  total = n_init + iters
  return x_out[:total], y_out[:total], select_idx


def make_bo_qbatch_runner(mean_func, cov_func, config, warp_func,
                          acquisition: str, iters: int, q: int,
                          n_init: int, n_max: int,
                          num_train_tasks: int, eps: float = 1e-6):
  """The q-batch runner, run(model, x0, y0, cand_x, cand_y, generator) ->
  (x_buf, y_buf, select_idx (iters, q)).

  Each iteration picks q points in turn by the kriging believer: each pick
  conditions on the earlier ones with their posterior mean believed as the
  observation; after the batch the true y values replace the believed
  ones. The factor depends only on x, so the reveal keeps it exact. Each
  pick draws once for 'rand' and 'ts', so q = 1 repeats the plain runner
  exactly, draws included.
  """
  _bo_solver()
  _check_capacity(n_max, n_init + iters * q)
  acq_sub, kind = _ACQ_SUBS[acquisition]
  scale = _unbiased_scale(num_train_tasks)

  @torch.no_grad()
  def run(model, x0, y0, cand_x, cand_y, generator):
    device = cand_x.device
    shim = defs.GPParams(model=model, config=config)
    nv = _noise(shim, warp_func)
    state = (cand_x.new_zeros((n_max, cand_x.shape[1])),
             cand_x.new_zeros((n_max, 1)),
             chol_ops.init_chol_buffer(n_max, device=device), 0)
    state = _seed(cov_func, config, warp_func, eps, model, state, x0, y0)
    select_idx = torch.empty((iters, q), dtype=torch.int64, device=device)
    for i in range(iters):
      for j in range(q):
        x_buf, y_buf, fac_buf, count = state
        mu, var = _masked_posterior(mean_func, cov_func, shim, warp_func,
                                    nv, scale, x_buf, y_buf, fac_buf,
                                    count, cand_x)
        idx = _select(acq_sub, kind, generator, cand_x, mu, var, nv, scale,
                      y_buf, count)
        # Believe the posterior mean until the batch completes.
        state = _append_pick(cov_func, shim, warp_func, nv, eps, state,
                             cand_x, mu, idx)
        select_idx[i, j] = idx
      count = state[3]
      state[1][count - q:count] = cand_y.index_select(0, select_idx[i])
    return state[0], state[1], select_idx

  return run


def simulated_bayesopt_ondevice_qbatch(
    mean_func,
    cov_func,
    model_params,
    config,
    warp_func,
    queried_sub_dataset: SubDataset,
    iters: int,
    q: int = 2,
    acquisition: str = 'ei',
    num_train_tasks: int = 0,
    init_obs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    n_max: Optional[int] = None,
    eps: float = 1e-6,
    mesh=None,
    mesh_axis: str = 'task',
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device] = 'cuda',
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Batch BO: q points an iteration by the kriging believer
  (make_bo_qbatch_runner), `iters` iterations; the other arguments as
  simulated_bayesopt_ondevice. q = 1 reproduces it.

  Returns (x_observed, y_observed, selected_indices (iters, q)).
  """
  del mesh_axis
  _no_mesh(mesh)
  device = _device_of(queried_sub_dataset.x, device)
  cand_x, cand_y, x0, y0 = _inputs(queried_sub_dataset, init_obs, device)
  n_init = x0.shape[0]
  if n_max is None:
    n_max = n_init + iters * q
  run = make_bo_qbatch_runner(mean_func, cov_func, config, warp_func,
                              acquisition, iters, q, n_init, n_max,
                              num_train_tasks, eps=eps)
  x_out, y_out, select_idx = run(convert.model_to(model_params, device),
                                 x0, y0, cand_x, cand_y,
                                 _generator(generator, device))
  total = n_init + iters * q
  return x_out[:total], y_out[:total], select_idx


def _acq_values(mean_func, cov_func, warp_func, acq_sub, kind, shim, nv,
                scale, state, cand_x):
  """The closed-form acquisition (n_c, 1) at cand_x from the state's
  posterior; differentiable in cand_x."""
  x_buf, y_buf, fac_buf, count = state
  mu, var = _masked_posterior(mean_func, cov_func, shim, warp_func, nv,
                              scale, x_buf, y_buf, fac_buf, count, cand_x)
  return _acq_scores(acq_sub, kind, mu, var, y_buf, count)


def make_bo_continuous_runner(mean_func, cov_func, config, warp_func,
                              oracle_fn, input_dim: int, iters: int,
                              acquisition: str, pool_size: int,
                              refine_steps: int, refine_lr: float,
                              num_train_tasks: int, n_init: int,
                              eps: float = 1e-6):
  """The continuous-domain runner, run(model, x0, y0, generator) ->
  (x_buf, y_buf) of n_init + iters rows: the n_init rows of (x0, y0)
  appended, then per iteration a uniform pool of `pool_size` inputs in
  [0, 1]^d, its acquisition argmax, `refine_steps` steps of normalized
  projected gradient ascent on the acquisition (torch.autograd.grad at
  one point, clamped to [0, 1]) kept only where its score is at least the
  pool's maximum, the oracle's value, and the rank-1 append. 'rand' takes
  a uniform member of the pool and 'ts' the argmax of one posterior draw
  over it, unrefined (a per-point draw is not a coherent function to
  ascend). Nothing is read back: the refined point's choice is a
  torch.where and the picks index_select.

  The JAX package's scan appends through its BO step over a one-row
  candidate set, whose pick is always that row; here the row is appended
  directly, with no posterior or draw for it.
  """
  _bo_solver()
  n_max = n_init + iters
  acq_sub, kind = _ACQ_SUBS[acquisition]
  scale = _unbiased_scale(num_train_tasks)

  def acq_at(shim, nv, state, x):
    return _acq_values(mean_func, cov_func, warp_func, acq_sub, kind, shim,
                       nv, scale, state, x)

  def one_iter(shim, nv, state, generator):
    x_buf, y_buf, fac_buf, count = state
    pool = _draw_uniform(generator, (pool_size, input_dim), x_buf.device)
    mu = var = None
    if kind != 'rand':
      mu, var = _masked_posterior(mean_func, cov_func, shim, warp_func, nv,
                                  scale, x_buf, y_buf, fac_buf, count, pool)
    idx = _select(acq_sub, kind, generator, pool, mu, var, nv, scale, y_buf,
                  count)
    x_new = pool.index_select(0, idx.reshape(1))
    if kind not in ('rand', 'ts') and refine_steps > 0:
      best = torch.max(_acq_scores(acq_sub, kind, mu, var, y_buf, count))
      x_ref = x_new
      with torch.enable_grad():
        for _ in range(refine_steps):
          x = x_ref.detach().requires_grad_(True)
          score = acq_at(shim, nv, state, x).sum()
          # A posterior constant in x has the zero gradient and no graph.
          g = (torch.autograd.grad(score, x)[0] if score.requires_grad
               else torch.zeros_like(x))
          norm = torch.clamp(torch.linalg.vector_norm(g), min=1e-12)
          x_ref = torch.clamp(x + refine_lr * g / norm, 0.0, 1.0)
      x_ref = x_ref.detach()
      better = acq_at(shim, nv, state, x_ref).flatten()[0] >= best
      x_new = torch.where(better, x_ref, x_new)
    y_new = oracle_fn(x_new).reshape(1, 1)
    return _append(cov_func, shim, warp_func, nv, eps, state, x_new, y_new)

  @torch.no_grad()
  def run(model, x0, y0, generator):
    shim = defs.GPParams(model=model, config=config)
    nv = _noise(shim, warp_func)
    state = (x0.new_zeros((n_max, input_dim)), x0.new_zeros((n_max, 1)),
             chol_ops.init_chol_buffer(n_max, device=x0.device), 0)
    state = _seed(cov_func, config, warp_func, eps, model, state, x0, y0)
    for _ in range(iters):
      state = one_iter(shim, nv, state, generator)
    return state[0], state[1]

  return run


def continuous_bayesopt_ondevice(
    mean_func,
    cov_func,
    model_params,
    config,
    warp_func,
    oracle_fn,
    input_dim: int,
    iters: int,
    acquisition: str = 'ei',
    pool_size: int = 1024,
    refine_steps: int = 20,
    refine_lr: float = 0.02,
    num_train_tasks: int = 0,
    init_obs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device] = 'cuda',
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Continuous-domain BO on the device, for an oracle that is a torch
  function: `iters` iterations of make_bo_continuous_runner with no read of
  the device until the loop ends.

  Args:
    oracle_fn: (1, d) -> (1, 1) torch function on the device.
    pool_size: inputs drawn an iteration for the argmax start.
    refine_steps / refine_lr: projected gradient ascent's schedule; 0
      steps takes the pool's argmax.
    init_obs: optional (x0, y0) initial observations.
    generator: draws the pools and the 'rand' and 'ts' picks (default:
      seeded 0 on the device).
    device: where to run when init_obs holds no tensor (the CUDA card
      unless the caller asks for the CPU).

  Returns:
    (x_observed, y_observed) including the initial observations, in order.
  """
  device = _device_of(None if init_obs is None else init_obs[0], device)
  if init_obs is None:
    x0 = torch.zeros((0, input_dim), device=device)
    y0 = torch.zeros((0, 1), device=device)
  else:
    x0 = torch.as_tensor(init_obs[0], dtype=torch.float32, device=device)
    y0 = torch.as_tensor(init_obs[1], dtype=torch.float32,
                         device=device).reshape(-1, 1)
  run = make_bo_continuous_runner(
      mean_func, cov_func, config, warp_func, oracle_fn, input_dim, iters,
      acquisition, pool_size, refine_steps, refine_lr, num_train_tasks,
      x0.shape[0])
  return run(convert.model_to(model_params, device), x0, y0,
             _generator(generator, device))


def make_bo_retrain_runner(mean_func, cov_func, config, warp_func,
                           acquisition: str, iters: int, n_init: int,
                           n_max: int, num_train_tasks: int,
                           retrain_every: int = 1,
                           retrain_steps: int = 10,
                           learning_rate: float = 1e-2,
                           ekl_weight: float = 0.0,
                           ekl_partial: bool = True,
                           eps: float = 1e-6):
  """The in-loop retraining runner, run(model, x0, y0, cand_x, cand_y,
  pretrain_packed, aligned_packed, generator) -> (x_buf, y_buf,
  select_idx, final_model).

  Before iteration i, when i % retrain_every == 0 and there are
  observations, the model takes `retrain_steps` Adam steps on
  _corpus_loss, then W is refactored from scratch (_masked_refactor);
  between retrains the appends stay rank-1. The Adam is optax.adam's rule
  with no NaN-freeze, its state made once a run and carried across the
  retrains. retrain_steps = 0 reproduces the plain runner exactly.
  pretrain_packed / aligned_packed may be None.
  """
  _bo_solver()
  _check_capacity(n_max, n_init + iters)
  config = dict(config or {})
  config_nopriors = {k: v for k, v in config.items() if k != 'priors'}
  step = build_bo_step(mean_func, cov_func, config_nopriors, warp_func,
                       acquisition, n_max, num_train_tasks, eps=eps)

  def retrain(state, corpus_loss, x_buf, y_buf, count):
    def loss(model, _):
      return corpus_loss(model, x_buf, y_buf, count)

    for _ in range(retrain_steps):
      _, grads = adam_lib.value_and_grads(loss, state, None)
      new = adam_lib.adam_update(learning_rate, state, grads)
      state.params = [p for p, _, _ in new]
      state.m = [m for _, m, _ in new]
      state.v = [v for _, _, v in new]
      state.step += 1

  @torch.no_grad()
  def run(model, x0, y0, cand_x, cand_y, pp, ap, generator):
    device = cand_x.device
    corpus_loss = _make_corpus_loss(
        mean_func, cov_func, config, warp_func, n_max, pretrain_packed=pp,
        aligned_packed=ap, ekl_weight=ekl_weight, ekl_partial=ekl_partial,
        eps=eps)
    opt = adam_lib.AdamState(model)
    state = (cand_x.new_zeros((n_max, cand_x.shape[1])),
             cand_x.new_zeros((n_max, 1)),
             chol_ops.init_chol_buffer(n_max, device=device), 0)
    state = _seed(cov_func, config_nopriors, warp_func, eps, opt.model(),
                  state, x0, y0)
    select_idx = torch.empty((iters,), dtype=torch.int64, device=device)
    for i in range(iters):
      x_buf, y_buf, fac_buf, count = state
      if retrain_steps > 0 and i % retrain_every == 0 and count > 0:
        retrain(opt, corpus_loss, x_buf, y_buf, count)
        fac_buf = _masked_refactor(mean_func, cov_func, config_nopriors,
                                   warp_func, opt.model(), x_buf, count,
                                   eps=eps)
        state = (x_buf, y_buf, fac_buf, count)
      state, select_idx[i] = step(opt.model(), state, generator, cand_x,
                                  cand_y)
    return state[0], state[1], select_idx, opt.model()

  return run


def simulated_bayesopt_ondevice_retrain(
    mean_func,
    cov_func,
    model_params,
    config,
    warp_func,
    queried_sub_dataset: SubDataset,
    iters: int,
    acquisition: str = 'ei',
    num_train_tasks: int = 0,
    init_obs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    n_max: Optional[int] = None,
    pretrain_packed=None,
    aligned_packed=None,
    ekl_weight: float = 0.0,
    ekl_partial: bool = True,
    retrain_every: int = 1,
    retrain_steps: int = 10,
    learning_rate: Optional[float] = None,
    eps: float = 1e-6,
    mesh=None,
    mesh_axis: str = 'task',
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device] = 'cuda',
):
  """BO with periodic in-loop retraining (make_bo_retrain_runner): every
  `retrain_every` iterations, `retrain_steps` Adam steps on the mean
  per-task NLL of pretrain_packed (a models.packed.PackedDataset, or None
  for the test task alone) and the test task, plus ekl_weight * EKL over
  aligned_packed (a PackedAlignedDataset; partial or full KL by
  ekl_partial), priors subtracted once. learning_rate defaults to
  config['learning_rate'] or 1e-2. The other arguments as
  simulated_bayesopt_ondevice.

  Returns (x_observed, y_observed, selected_indices, final_model_params).
  """
  del mesh_axis
  _no_mesh(mesh)
  device = _device_of(queried_sub_dataset.x, device)
  cand_x, cand_y, x0, y0 = _inputs(queried_sub_dataset, init_obs, device)
  n_init = x0.shape[0]
  if n_max is None:
    n_max = n_init + iters
  config = dict(config or {})
  lr = learning_rate if learning_rate is not None else config.get(
      'learning_rate', 1e-2)
  run = make_bo_retrain_runner(
      mean_func, cov_func, config, warp_func, acquisition, iters, n_init,
      n_max, num_train_tasks, retrain_every=retrain_every,
      retrain_steps=retrain_steps, learning_rate=lr, ekl_weight=ekl_weight,
      ekl_partial=ekl_partial, eps=eps)
  x_out, y_out, select_idx, model_out = run(
      convert.model_to(dict(model_params), device), x0, y0, cand_x, cand_y,
      pretrain_packed, aligned_packed, _generator(generator, device))
  total = n_init + iters
  return x_out[:total], y_out[:total], select_idx, model_out


def _hgp_pieces(mean_func, cov_func, config, warp_func, acquisition,
                num_samples: int, num_train_tasks: int, eps: float):
  """(select, append_all) of the HGP runners over S models stacked on a
  leading axis (`stacked`) and their S W buffers (`facs`, (S, N, N)).

  select(stacked, facs, generator, cand_x, x_buf, y_buf, count) -> the
  0-d index of the pick: a uniform draw ('rand'), one posterior draw of
  the latent f under a uniformly drawn sample ('ts'), or the argmax of the
  acquisition averaged over the samples' posteriors. append_all grows
  every W by the new observation."""
  acq_sub, kind = _ACQ_SUBS[acquisition]
  scale = _unbiased_scale(num_train_tasks)

  def shim(model):
    return defs.GPParams(model=model, config=config)

  def posterior(model, fac, x_buf, y_buf, count, cand_x):
    return _masked_posterior(mean_func, cov_func, shim(model), warp_func,
                             _noise(shim(model), warp_func), scale, x_buf,
                             y_buf, fac, count, cand_x)

  def select(stacked, facs, generator, cand_x, x_buf, y_buf, count):
    if kind == 'rand':
      return _draw_index(generator, cand_x.shape[0], cand_x.device)
    if kind == 'ts':
      s = _draw_index(generator, num_samples, cand_x.device)
      model = convert.model_at(stacked, s)
      mu, var = posterior(model, facs.index_select(0, s.reshape(1))[0],
                          x_buf, y_buf, count, cand_x)
      return _ts_index(mu, var, _noise(shim(model), warp_func), scale,
                       _draw_normal(generator, tuple(mu.shape), mu.device))
    mu_s, var_s = torch.func.vmap(
        lambda m, f: posterior(m, f, x_buf, y_buf, count, cand_x))(stacked,
                                                                   facs)
    mask = torch.arange(y_buf.shape[0], device=y_buf.device) < count
    target = _acq_param(kind, y_buf, mask, count)
    scores = acfun.sample_mean(acq_sub(mu_s, torch.sqrt(var_s), target))
    return torch.argmax(scores.flatten())

  def append_all(stacked, facs, x_buf, count, x_new):
    return torch.func.vmap(lambda m, f: _append_factor(
        cov_func, shim(m), warp_func, _noise(shim(m), warp_func), eps,
        x_buf, f, count, x_new))(stacked, facs)

  return select, append_all


def _hgp_buffers(cand_x, n_max: int, num_samples: int):
  """Empty observation buffers and S identity W buffers."""
  eye = chol_ops.init_chol_buffer(n_max, device=cand_x.device)
  return (cand_x.new_zeros((n_max, cand_x.shape[1])),
          cand_x.new_zeros((n_max, 1)),
          eye.expand(num_samples, n_max, n_max).clone())


def _hgp_observe(append_all, stacked, facs, x_buf, y_buf, count, x_new,
                 y_new):
  """Every W grown by (x_new (1, d), y_new (1, 1)), written at row count."""
  facs = append_all(stacked, facs, x_buf, count, x_new)
  x_buf[count:count + 1] = x_new
  y_buf[count:count + 1] = y_new.reshape(1, 1)
  return facs


def make_bo_hgp_runner(mean_func, cov_func, config, warp_func,
                       acquisition: str, iters: int, n_init: int,
                       n_max: int, num_samples: int,
                       num_train_tasks: int):
  """The HGP runner with fixed samples, run(stacked, x0, y0, cand_x,
  cand_y, generator, return_factor=False) -> (x_buf, y_buf, select_idx[,
  facs]): `stacked` holds the S posterior samples on a leading axis. Every
  iteration builds the S posteriors at once (torch.func.vmap over the GP
  runner's posterior), picks by the acquisition averaged over them, and
  grows the S W buffers at once. Nothing is read back inside the loop."""
  _bo_solver()
  _check_capacity(n_max, n_init + iters)
  select, append_all = _hgp_pieces(mean_func, cov_func, config, warp_func,
                                   acquisition, num_samples,
                                   num_train_tasks, 1e-6)

  @torch.no_grad()
  def run(stacked, x0, y0, cand_x, cand_y, generator, return_factor=False):
    x_buf, y_buf, facs = _hgp_buffers(cand_x, n_max, num_samples)
    for i in range(n_init):
      facs = _hgp_observe(append_all, stacked, facs, x_buf, y_buf, i,
                          x0[i:i + 1], y0[i:i + 1])
    select_idx = torch.empty((iters,), dtype=torch.int64,
                             device=cand_x.device)
    for i in range(iters):
      count = n_init + i
      idx = select(stacked, facs, generator, cand_x, x_buf, y_buf, count)
      row = idx.reshape(1)
      facs = _hgp_observe(append_all, stacked, facs, x_buf, y_buf, count,
                          cand_x.index_select(0, row),
                          cand_y.index_select(0, row))
      select_idx[i] = idx
    out = (x_buf, y_buf, select_idx)
    return out + (facs,) if return_factor else out

  return run


def simulated_bayesopt_ondevice_hgp(
    mean_func,
    cov_func,
    model_params_samples,
    config,
    warp_func,
    queried_sub_dataset: SubDataset,
    iters: int,
    acquisition: str = 'ei',
    num_train_tasks: int = 0,
    init_obs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    n_max: Optional[int] = None,
    mesh=None,
    mesh_axis: str = 'task',
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device] = 'cuda',
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """On-device BO under an HGP (make_bo_hgp_runner): S posterior samples,
  their posteriors and W appends batched, the acquisition the mean of the
  per-sample acquisitions ('ts': a sample drawn, then the function).

  Args:
    model_params_samples: list of model dicts (params.samples) or a dict
      already stacked on a leading sample axis S.
    The others as simulated_bayesopt_ondevice.

  Returns:
    (x_observed, y_observed, selected_indices) as the GP variant.
  """
  del mesh_axis
  _no_mesh(mesh)
  device = _device_of(queried_sub_dataset.x, device)
  cand_x, cand_y, x0, y0 = _inputs(queried_sub_dataset, init_obs, device)
  if isinstance(model_params_samples, (list, tuple)):
    stacked = convert.stack_models(list(model_params_samples), device)
  else:
    stacked = convert.model_to(model_params_samples, device)
  n_init = x0.shape[0]
  if n_max is None:
    n_max = n_init + iters
  run = make_bo_hgp_runner(mean_func, cov_func, config, warp_func,
                           acquisition, iters, n_init, n_max,
                           convert.stack_size(stacked), num_train_tasks)
  x_out, y_out, select_idx = run(stacked, x0, y0, cand_x, cand_y,
                                 _generator(generator, device))
  total = n_init + iters
  return x_out[:total], y_out[:total], select_idx


def make_bo_resample_runner(mean_func, cov_func, config, warp_func,
                            template_model, acquisition: str,
                            iters: int, n_init: int, n_max: int,
                            num_samples: int, num_train_tasks: int,
                            resample_every: int = 1, sweeps: int = 2,
                            width: float = 1.0, max_steps_out: int = 10,
                            max_shrink: int = 100,
                            init_jitter: float = 0.1,
                            init_mode: str = 'jitter',
                            ekl_weight: float = 0.0,
                            eps: float = 1e-6):
  """The HGP runner with in-loop re-sampling.

  Returns (run, unravel): run(init_arr, x0_obs, y0_obs, cand_x, cand_y,
  pretrain_packed, aligned_packed, generator, stats=None) -> (x_buf,
  y_buf, select_idx, xs_final). The S samples are the rows of xs (S, p),
  the models raveled (slice_sampler.ravel_model of template_model; unravel
  maps rows back). init_arr is the raveled start model (init_mode
  'jitter': sample s > 0 adds N(0, init_jitter^2) noise) or the (S, p)
  chain starts (init_mode 'samples').

  Before iteration i, when i % resample_every == 0, every chain advances
  `sweeps` slice-sampling sweeps (train/slice_sampler.run_chains) on the
  posterior of the corpus and the test task's first `count` rows
  (_corpus_loss: pretrain_packed, aligned_packed with ekl_weight, the
  priors of config), each evaluation one batched call over the chains and
  stepping-out edges; then every sample's W is refactored. A target that
  is flat with no observation (no corpus, no priors) is not sampled until
  the first observation. Selection and appends are the fixed-sample
  runner's. `stats` counts the batched evaluations and the flags the
  sampler read back.
  """
  _bo_solver()
  _check_capacity(n_max, n_init + iters)
  config = dict(config or {})
  config_nopriors = {k: v for k, v in config.items() if k != 'priors'}
  _, unravel = slice_lib.ravel_model(template_model)
  select, append_all = _hgp_pieces(mean_func, cov_func, config_nopriors,
                                   warp_func, acquisition, num_samples,
                                   num_train_tasks, eps)

  @torch.no_grad()
  def run(init_arr, x0_obs, y0_obs, cand_x, cand_y, pp, ap, generator,
          stats=None):
    if init_mode == 'samples':
      xs = init_arr
    else:
      noise = slice_lib._draw_jitter(generator, num_samples,
                                     init_arr.shape[0], init_arr.device)
      jitter = torch.where(
          torch.arange(num_samples, device=init_arr.device) > 0,
          init_jitter, 0.0)
      xs = init_arr + jitter[:, None] * noise
    flat_target = not (pp is not None or (ap is not None and ekl_weight)
                       or 'priors' in config)
    x_buf, y_buf, facs = _hgp_buffers(cand_x, n_max, num_samples)
    for i in range(n_init):
      facs = _hgp_observe(append_all, unravel(xs), facs, x_buf, y_buf, i,
                          x0_obs[i:i + 1], y0_obs[i:i + 1])
    select_idx = torch.empty((iters,), dtype=torch.int64,
                             device=cand_x.device)
    for i in range(iters):
      count = n_init + i
      if (sweeps > 0 and i % resample_every == 0 and
          not (flat_target and count == 0)):
        def log_prob(v, count=count):
          return -_corpus_loss_batched(
              mean_func, cov_func, config, warp_func, n_max, unravel(v),
              x_buf, y_buf, count, pretrain_packed=pp, aligned_packed=ap,
              ekl_weight=ekl_weight, eps=eps)

        ll = log_prob(xs)
        if stats is not None:
          stats['evaluations'] = stats.get('evaluations', 0) + 1
        xs, _, _ = slice_lib.run_chains(
            log_prob, xs, ll, generator, sweeps, width=width,
            max_steps_out=max_steps_out, max_shrink=max_shrink,
            stats=stats)
        facs = _masked_refactor_all(cov_func, config_nopriors, warp_func,
                                    unravel(xs), x_buf, count, eps=eps)
      stacked = unravel(xs)
      idx = select(stacked, facs, generator, cand_x, x_buf, y_buf, count)
      row = idx.reshape(1)
      facs = _hgp_observe(append_all, stacked, facs, x_buf, y_buf, count,
                          cand_x.index_select(0, row),
                          cand_y.index_select(0, row))
      select_idx[i] = idx
    return x_buf, y_buf, select_idx, xs

  return run, unravel


def simulated_bayesopt_ondevice_hgp_resample(
    mean_func,
    cov_func,
    model_params,
    config,
    warp_func,
    queried_sub_dataset: SubDataset,
    iters: int,
    acquisition: str = 'ei',
    num_samples: int = 8,
    num_train_tasks: int = 0,
    init_obs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    n_max: Optional[int] = None,
    pretrain_packed=None,
    aligned_packed=None,
    ekl_weight: float = 0.0,
    resample_every: int = 1,
    sweeps: int = 2,
    width: float = 1.0,
    max_steps_out: int = 10,
    max_shrink: int = 100,
    init_jitter: float = 0.1,
    init_samples=None,
    eps: float = 1e-6,
    mesh=None,
    mesh_axis: str = 'task',
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device] = 'cuda',
    stats=None,
):
  """On-device HGP BO with in-loop posterior re-sampling
  (make_bo_resample_runner).

  Args:
    model_params: starting model dict (sample 0 starts here; samples s > 0
      add N(0, init_jitter^2) noise in unconstrained space).
    num_samples: S parallel chains, one posterior sample each.
    init_samples: optional list of S model dicts (e.g. an HGP's
      params.samples) the chains start from instead of the jitter.
    pretrain_packed / aligned_packed / ekl_weight: the sampling target's
      corpus, as simulated_bayesopt_ondevice_retrain.
    resample_every / sweeps: cadence and sweeps a re-sampling (sweeps = 0
      keeps the samples fixed).
    width / max_steps_out / max_shrink: the slice sampler's.
    stats: counts of batched evaluations and flags read back, if given.
    The others as simulated_bayesopt_ondevice.

  Returns:
    (x_observed, y_observed, selected_indices, samples): samples the final
    list of S model dicts (the HGP params.samples contract).
  """
  del mesh_axis
  _no_mesh(mesh)
  device = _device_of(queried_sub_dataset.x, device)
  cand_x, cand_y, x0, y0 = _inputs(queried_sub_dataset, init_obs, device)
  n_init = x0.shape[0]
  if n_max is None:
    n_max = n_init + iters
  config = dict(config or {})
  template = init_samples[0] if init_samples is not None else model_params
  if init_samples is not None:
    num_samples = len(init_samples)
    init_arr = torch.stack([slice_lib.ravel_model(s, device)[0]
                            for s in init_samples])
    init_mode = 'samples'
  else:
    init_arr = slice_lib.ravel_model(template, device)[0]
    init_mode = 'jitter'
  run, unravel = make_bo_resample_runner(
      mean_func, cov_func, config, warp_func, template, acquisition, iters,
      n_init, n_max, num_samples, num_train_tasks,
      resample_every=resample_every, sweeps=sweeps, width=width,
      max_steps_out=max_steps_out, max_shrink=max_shrink,
      init_jitter=init_jitter, init_mode=init_mode, ekl_weight=ekl_weight,
      eps=eps)
  x_out, y_out, select_idx, xs = run(init_arr, x0, y0, cand_x, cand_y,
                                     pretrain_packed, aligned_packed,
                                     _generator(generator, device),
                                     stats=stats)
  total = n_init + iters
  return (x_out[:total], y_out[:total], select_idx,
          [unravel(row) for row in xs])


def default_retrain_corpus(dataset, sub_dataset_key):
  """(corpus, dropped_keys): the sub-datasets the in-loop retraining
  objective can pack (single-output, unaligned, non-empty) and the keys it
  must leave out."""
  corpus = {k: v for k, v in dataset.items()
            if k != sub_dataset_key and v.aligned is None
            and v.x.shape[0] > 0 and v.y.shape[1] == 1}
  dropped = [k for k in dataset
             if k != sub_dataset_key and k not in corpus]
  return corpus, dropped


def run_bayesopt_ondevice(
    model,
    sub_dataset_key,
    queried_sub_dataset: SubDataset,
    iters: int,
    acquisition: str = 'ei',
    q: int = 1,
    retrain_every: int = 1,
    pretrain_packed=None,
    aligned_packed=None,
    ekl_weight: float = 0.0,
    mesh=None,
    generator: Optional[torch.Generator] = None,
):
  """On-device counterpart of bayesopt.run_bayesopt for a built GP, on the
  GP's device.

  Dispatches as the JAX package does: an HGP -> the fixed-sample HGP
  runner, or with config['retrain'] > 0 the re-sampling runner (chains
  from its samples, `retrain` sweeps every `retrain_every` iterations);
  a GP with config['retrain'] > 0 -> in-loop retraining; q > 1 ->
  kriging-believer batches of q (iters counts evaluations and must divide
  by q; an HGP raises); else the plain loop. The corpus of the retraining
  and the re-sampling defaults to the model's single-output unaligned
  sub-datasets, packed with pad_to_multiple=8. Observations already on
  `sub_dataset_key` seed the buffers. `mesh=` raises (not ported).

  Returns ((x_observed, y_observed), best_datapoint_of_queried, params);
  with retraining the params hold the retrained model, with re-sampling
  the final samples.
  """
  from hyperbo_tpu_torch.bo import bayesopt as bayesopt_lib

  _no_mesh(mesh)
  retrain = (model.params.config or {}).get('retrain', 0)
  n_unaligned = len(
      [k for k, v in model.dataset.items() if v.aligned is None])
  in_dataset = sub_dataset_key in model.dataset
  num_train_tasks = n_unaligned - 1 if in_dataset else n_unaligned
  init_obs = None
  if in_dataset and model.dataset[sub_dataset_key].x.shape[0] > 0:
    sub = model.dataset[sub_dataset_key]
    init_obs = (sub.x, sub.y)
  device = model.device
  queried = SubDataset(
      torch.as_tensor(queried_sub_dataset.x, dtype=torch.float32,
                      device=device),
      torch.as_tensor(queried_sub_dataset.y, dtype=torch.float32,
                      device=device))
  common = dict(queried_sub_dataset=queried, iters=iters,
                acquisition=acquisition, num_train_tasks=num_train_tasks,
                init_obs=init_obs, generator=generator, device=device)
  if retrain > 0 and pretrain_packed is None:
    corpus, _ = default_retrain_corpus(model.dataset, sub_dataset_key)
    pretrain_packed = (
        packed_lib.pack_dataset(corpus, pad_to_multiple=8,
                                device=device)[0] if corpus else None)

  if isinstance(model, gp_lib.HGP):
    if q > 1:
      raise ValueError('HGP on-device BO does not support q-batch '
                       'selection; use the host loop.')
    if retrain > 0:
      xo, yo, _, samples = simulated_bayesopt_ondevice_hgp_resample(
          model.mean_func, model.cov_func, model.params.model,
          model.params.config, model.warp_func,
          pretrain_packed=pretrain_packed, aligned_packed=aligned_packed,
          ekl_weight=ekl_weight, resample_every=retrain_every,
          sweeps=retrain, init_samples=model.get_model_params_samples(),
          **common)
      model.params.samples = samples
      model.params.cache = {}
    else:
      xo, yo, _ = simulated_bayesopt_ondevice_hgp(
          model.mean_func, model.cov_func,
          model.get_model_params_samples(), model.params.config,
          model.warp_func, **common)
  elif retrain > 0:
    if q > 1:
      raise ValueError('q-batch selection does not compose with '
                       'in-scan retraining yet.')
    xo, yo, _, model_out = simulated_bayesopt_ondevice_retrain(
        model.mean_func, model.cov_func, model.params.model,
        model.params.config, model.warp_func,
        pretrain_packed=pretrain_packed, aligned_packed=aligned_packed,
        ekl_weight=ekl_weight, retrain_every=retrain_every,
        retrain_steps=retrain, **common)
    model.params.model = model_out
    model.params.cache = {}
  elif q > 1:
    # Budget parity with run_bayesopt: iters counts oracle evaluations, so
    # q-batch runs iters / q batches of q.
    if iters % q:
      raise ValueError(f'iters={iters} must divide by q={q} (iters '
                       'counts total evaluations, as run_bayesopt).')
    common['iters'] = iters // q
    xo, yo, _ = simulated_bayesopt_ondevice_qbatch(
        model.mean_func, model.cov_func, model.params.model,
        model.params.config, model.warp_func, q=q, **common)
  else:
    xo, yo, _ = simulated_bayesopt_ondevice(
        model.mean_func, model.cov_func, model.params.model,
        model.params.config, model.warp_func, **common)
  return ((xo, yo), bayesopt_lib.get_best_datapoint(queried_sub_dataset),
          model.params)
