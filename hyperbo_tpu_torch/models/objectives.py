"""Training objectives: multi-task NLL and EKL (port of
hyperbo_tpu/models/objectives.py).

`neg_log_marginal_likelihood` is the mean NLL over the non-aligned
sub-datasets, through the Cholesky path or (use_cholesky=False) a full SVD.
With config['fused_mll'] = True each large enough sub-dataset of a served
kernel goes through the fused route (ops/fused_mll: kernels K2-K4).
`multivariate_normal_divergence` is the mean divergence between the sample
MVN of each aligned sub-dataset and the model (KL by default, Euclidean for
`euc`). Objectives tagged with `_packed_spec` ('nll', None), ('kl', None)
and ('nll_regkl', c) train on the packed route (models/packed.py).

As in the JAX package, `nll_regeuc01` and `nll_regeuc10` use the Euclidean
regularizer their names state (the reference aliases them to the KL one).
"""

from __future__ import annotations

import functools
import logging
import math

import torch

from hyperbo_tpu_torch.core.warp import retrieve_params
from hyperbo_tpu_torch.models import divergences
from hyperbo_tpu_torch.ops import fused_mll
from hyperbo_tpu_torch.ops import iterative
from hyperbo_tpu_torch.ops import linalg


def _objective_items(dataset, aligned_only=False, exclude_aligned=False):
  """Non-empty sub-datasets an objective runs over, in dataset order."""
  for key, sub in dataset.items():
    if aligned_only and sub.aligned is None:
      continue
    if exclude_aligned and sub.aligned is not None:
      continue
    if sub.x.shape[0] == 0:
      continue
    yield key, sub


def multivariate_normal_divergence(
    mean_func,
    cov_func,
    params,
    dataset,
    warp_func=None,
    distance=divergences.kl_multivariate_normal,
):
  """Mean divergence between sample MVN stats and the model, over aligned
  sub-datasets.

  Each aligned sub-dataset has y of shape (n, m): m matched-input function
  draws. Their sample mean and (biased) covariance are compared with the
  model's mean and kernel (+ noise on the diagonal) under `distance`.
  """
  noise_variance, = retrieve_params(
      params, ['noise_variance'], warp_func=warp_func)

  def one(key, sub):
    if sub.y.shape[1] == 0 or sub.y.shape[0] != sub.x.shape[0]:
      raise ValueError(
          f'dataset[{key}].x has shape {tuple(sub.x.shape)} '
          f'but dataset[{key}].y has shape {tuple(sub.y.shape)}')
    mu_model = mean_func(params, sub.x, warp_func=warp_func).flatten()
    eye = torch.eye(sub.x.shape[0], dtype=sub.x.dtype, device=sub.x.device)
    cov_model = cov_func(params, sub.x, warp_func=warp_func) + (
        eye * noise_variance)
    return distance(mu0=torch.mean(sub.y, dim=1),
                    cov0=torch.cov(sub.y, correction=0),
                    mu1=mu_model, cov1=cov_model)

  vals = [one(k, s) for k, s in _objective_items(dataset,
                                                 aligned_only=True)]
  if not vals:
    return 0.
  return sum(vals) / len(vals)


multivariate_normal_euc_distance = functools.partial(
    multivariate_normal_divergence,
    distance=divergences.euclidean_multivariate_normal)


def neg_log_marginal_likelihood(mean_func,
                                cov_func,
                                params,
                                dataset,
                                warp_func=None,
                                exclude_aligned=True,
                                return_key2nll=False,
                                use_cholesky=True):
  """Mean negative log marginal likelihood over (non-aligned) sub-datasets.

  use_cholesky=False computes each NLL through a full SVD, for a kernel
  that is PD but whose covariance is numerically low rank.
  config['fused_mll'] = True sends every sub-dataset the fused route
  serves (se_nll_fused_applicable) through kernels K2-K4, differentiably.
  Otherwise config['iterative_mll'] (True, or a dict of
  ops/iterative.mll_iterative's keyword arguments) sends each
  single-output sub-dataset of a kernel in the fused route's table
  through the matrix-free estimate: CG and a stochastic Lanczos logdet,
  O(n) memory, for n beyond the dense routes' reach.
  """
  fused = fused_mll.fused_requested(params)
  it_cfg = params.config.get('iterative_mll') if params.config else None

  def nll_cholesky(vx, vy):
    if fused and fused_mll.se_nll_fused_applicable(cov_func, vx, params,
                                                   y=vy):
      return fused_mll.se_nll_fused(mean_func, params, vx, vy,
                                    warp_func=warp_func, cov_func=cov_func)
    if (it_cfg and vy.shape[-1] == 1 and
        cov_func in fused_mll._fused_kernel_table()):
      kwargs = dict(it_cfg) if isinstance(it_cfg, dict) else {}
      return iterative.mll_iterative(mean_func, params, vx, vy,
                                     warp_func=warp_func, cov_func=cov_func,
                                     **kwargs)
    chol, kinvy, vy = linalg.solve_gp_linear_system(
        mean_func=mean_func, cov_func=cov_func, params=params, x=vx, y=vy,
        warp_func=warp_func)
    return torch.sum(0.5 * torch.matmul(vy.T, kinvy) +
                     torch.sum(torch.log(torch.diagonal(chol))) +
                     0.5 * vx.shape[0] * math.log(2 * math.pi))

  def nll_svd(vx, vy):
    vy, cov = linalg.compute_delta_y_and_cov(
        mean_func=mean_func, cov_func=cov_func, params=params, x=vx, y=vy,
        warp_func=warp_func)
    u, s, vh = torch.linalg.svd(cov)
    if bool(s[-1] <= 0):
      logging.warning('Covariance matrix is low rank. s = %s', s)
    kinv = vh.T @ torch.diag(s**-1) @ u.T
    kinvy = torch.matmul(kinv, vy)
    return 0.5 * torch.sum(
        torch.matmul(vy.T, kinvy) + torch.sum(torch.log(s)) +
        vx.shape[0] * math.log(2 * math.pi))

  nll_one = nll_cholesky if use_cholesky else nll_svd
  key2nll = {k: nll_one(s.x, s.y)
             for k, s in _objective_items(dataset,
                                          exclude_aligned=exclude_aligned)}
  total_nll = (sum(key2nll.values()) / len(key2nll)) if key2nll else 0.
  total_nll = total_nll - _hyperprior_log_prob(params, warp_func)
  if return_key2nll:
    return total_nll, key2nll
  return total_nll


def _hyperprior_log_prob(params, warp_func):
  """Sum of config['priors'] log-densities over the (warped) model."""
  if not params.config or 'priors' not in params.config:
    return 0.
  total = 0.
  priors = params.config['priors']
  for name in params.model:
    if name in priors:
      val, = retrieve_params(params, [name], warp_func)
      total = total + priors[name](val)
  return total


nll = neg_log_marginal_likelihood
kl = multivariate_normal_divergence
ekl = kl
euc = multivariate_normal_euc_distance
regkl = kl
regeuc = euc


def add(*objectives):

  def added_objective(*args, **kwargs):
    return sum([o(*args, **kwargs) for o in objectives])

  return added_objective


def mul(c, o):

  def multiplied_objective(*args, **kwargs):
    return c * o(*args, **kwargs)

  return multiplied_objective


# The trainer routes a tagged objective through the packed path
# (models/packed.py): ('nll', None), ('kl', None) or ('nll_regkl', weight).
neg_log_marginal_likelihood._packed_spec = ('nll', None)
multivariate_normal_divergence._packed_spec = ('kl', None)


def nll_regkl(c):
  f = add(nll, mul(c, regkl))
  f._packed_spec = ('nll_regkl', c)
  return f


nll_regeuc = lambda c: add(nll, mul(c, regeuc))

nll_regkl1 = nll_regkl(1.)
nll_regeuc1 = nll_regeuc(1.)
nll_regkl01 = nll_regkl(.1)
nll_regeuc01 = nll_regeuc(.1)

nll_regkl10 = nll_regkl(10.)
nll_regeuc10 = nll_regeuc(10.)
