"""Training objectives (port of hyperbo_tpu/models/objectives.py), NLL half.

`neg_log_marginal_likelihood` is the mean NLL over the non-aligned
sub-datasets through the Cholesky path, tagged `_packed_spec =
('nll', None)` so that GP.train routes it through the packed trainer
(models/packed.py). With config['fused_mll'] = True each large enough
sub-dataset of a served kernel goes through the fused route
(ops/fused_mll: kernels K2-K4). The EKL/EUC divergences, the objective
combinators and config['iterative_mll'] wait (ROADMAP Queue A).
"""

from __future__ import annotations

import math

import torch

from hyperbo_tpu_torch.core.warp import retrieve_params
from hyperbo_tpu_torch.ops import fused_mll
from hyperbo_tpu_torch.ops import linalg


def _objective_items(dataset, exclude_aligned=False):
  """Non-empty sub-datasets an objective runs over, in dataset order."""
  for key, sub in dataset.items():
    if exclude_aligned and sub.aligned is not None:
      continue
    if sub.x.shape[0] == 0:
      continue
    yield key, sub


def neg_log_marginal_likelihood(mean_func,
                                cov_func,
                                params,
                                dataset,
                                warp_func=None,
                                exclude_aligned=True,
                                return_key2nll=False,
                                use_cholesky=True):
  """Mean negative log marginal likelihood over (non-aligned) sub-datasets.

  Only the Cholesky evaluation is ported; use_cholesky=False (the SVD
  path) and the opt-in iterative route raise. config['fused_mll'] = True
  sends every sub-dataset the fused route serves (se_nll_fused_applicable)
  through kernels K2-K4, differentiably.
  """
  if not use_cholesky:
    raise NotImplementedError('the SVD evaluation of the NLL is not '
                              'ported yet: see ROADMAP Queue A')
  if params.config and params.config.get('iterative_mll'):
    raise NotImplementedError("config['iterative_mll'] is not ported yet: "
                              'see ROADMAP Queue A')
  fused = fused_mll.fused_requested(params)

  def nll_one(vx, vy):
    if fused and fused_mll.se_nll_fused_applicable(cov_func, vx, params,
                                                   y=vy):
      return fused_mll.se_nll_fused(mean_func, params, vx, vy,
                                    warp_func=warp_func, cov_func=cov_func)
    chol, kinvy, vy = linalg.solve_gp_linear_system(
        mean_func=mean_func, cov_func=cov_func, params=params, x=vx, y=vy,
        warp_func=warp_func)
    return torch.sum(0.5 * torch.matmul(vy.T, kinvy) +
                     torch.sum(torch.log(torch.diagonal(chol))) +
                     0.5 * vx.shape[0] * math.log(2 * math.pi))

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

# The trainer routes a tagged objective through the packed path
# (models/packed.py); ('nll', None) is the only tag ported so far.
neg_log_marginal_likelihood._packed_spec = ('nll', None)
