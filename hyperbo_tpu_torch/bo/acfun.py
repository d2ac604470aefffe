"""Acquisition functions for Bayesian optimization (port of
hyperbo_tpu/bo/acfun.py): EI, PI and UCB with their callbacks, random
search and Thompson sampling. Under an HGP the closed-form acquisitions
average over the posterior samples (HGP.predict_stacked), and Thompson
sampling draws a sample, then the function from its posterior.

Random search and Thompson sampling consume `model.rng` (a torch.Generator
on the model's device) through `_uniform`, `_normal` and `_randint`, the
one place each draw is made, so that a test can substitute the JAX
package's draws.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Union

import torch

from hyperbo_tpu_torch.models import gp

partial = functools.partial

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _norm_pdf(x):
  return torch.exp(-0.5 * x * x) * _INV_SQRT_2PI


def _uniform(generator: torch.Generator, shape) -> torch.Tensor:
  return torch.rand(shape, generator=generator, device=generator.device)


def _normal(generator: torch.Generator, shape) -> torch.Tensor:
  return torch.randn(shape, generator=generator, device=generator.device)


def _randint(generator: torch.Generator, n: int) -> torch.Tensor:
  """0-d int64 uniform on [0, n)."""
  return torch.randint(n, (), generator=generator, device=generator.device)


def random_search(model, x_queries, **unused_kwargs):
  """Uniform random scores (n' x 1, the random-search baseline), drawn from
  model.rng."""
  assert model.rng is not None, 'Random search requires random key.'
  return _uniform(model.rng, (x_queries.shape[0], 1)).to(model.device)


def thompson_sampling(*, model, sub_dataset_key, x_queries,
                      **unused_kwargs):
  """Thompson-sampling scores: ONE posterior draw of the latent f at each
  query (no observation noise, no unbiased rescale), drawn from model.rng;
  their argmax is the Thompson choice. The draw is per candidate
  (diagonal covariance), as bo/ondevice's 'ts'. Under an HGP, one
  posterior sample is drawn uniformly first, and f from its posterior."""
  assert model.rng is not None, 'Thompson sampling requires random key.'
  if isinstance(model, gp.HGP):
    mu_s, var_s = model.predict_stacked(
        x_queries, sub_dataset_key=sub_dataset_key, with_noise=False)
    # predict_stacked applies the N/(N-1) unbiased rescale; it is taken
    # back out to draw the latent function (as ondevice._ts_index).
    n_unaligned = len(
        [k for k, v in model.dataset.items() if v.aligned is None])
    scale = (n_unaligned / (n_unaligned - 1.)
             if n_unaligned > 1 else 1.0)
    s = _randint(model.rng, mu_s.shape[0]).to(mu_s.device).reshape(1)
    mu = mu_s.index_select(0, s)[0]
    var_f = torch.clamp(var_s.index_select(0, s)[0] / scale, min=1e-12)
    draw = _normal(model.rng, tuple(mu.shape)).to(mu.device)
    return mu + torch.sqrt(var_f) * draw
  mu, var_f = model.predict(
      x_queries, sub_dataset_key=sub_dataset_key, full_cov=False,
      with_noise=False, unbiased=False)
  draw = _normal(model.rng, tuple(mu.shape)).to(mu.device)
  return mu + torch.sqrt(torch.clamp(var_f, min=1e-12)) * draw


def expected_improvement_sub(mu, std, target):
  """Closed-form EI: (phi(g) - g * (1 - Phi(g))) * std, g = (t - mu)/std."""
  gamma = (target - mu) / std
  return (_norm_pdf(gamma) - gamma * (1 - torch.special.ndtr(gamma))) * std


def probability_of_improvement_sub(mu, std, target):
  """PI expressed as the negative z-score of the target (rank-equivalent)."""
  gamma = (target - mu) / std
  return -gamma


def ucb_sub(mu, std, beta=3.):
  """Upper confidence bound mu + beta * std."""
  return mu + beta * std


def sample_mean(values: torch.Tensor) -> torch.Tensor:
  """Mean over the leading (sample) axis as v_0 + sum_s (v_s - v_0) / S,
  the sum taken one sample after another. Every step is elementwise, so
  equal values give equal means at every candidate (an argmax over
  candidates tied in each sample stays tied, which a reduction's
  position-dependent order does not keep), and S equal samples give the
  value itself, as one sample would."""
  first = values[0]
  total = torch.zeros_like(first)
  for s in range(1, values.shape[0]):
    total = total + (values[s] - first)
  return first + total / values.shape[0]


def acfun_wrapper(
    acfun_sub: Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor],
    acfun_callback_default: Callable[..., Any],
):
  """Build an acquisition function from a sub-function + parameter callback.

  The returned function scores x_queries (n' x d) against the posterior of
  model at sub_dataset_key, returning n' x 1 values. An HGP averages the
  acquisition over its posterior samples.
  """

  def acquisition_function(*,
                           model: gp.GP,
                           sub_dataset_key: Union[int, str],
                           x_queries: torch.Tensor,
                           acfun_callback: Callable[
                               ..., Any] = acfun_callback_default):
    if isinstance(model, gp.HGP):
      mu_s, var_s = model.predict_stacked(
          x_queries, sub_dataset_key=sub_dataset_key, with_noise=True)
      acfun_param = acfun_callback(model, sub_dataset_key)
      return sample_mean(acfun_sub(mu_s, torch.sqrt(var_s), acfun_param))
    mu, var = model.predict(
        x_queries, sub_dataset_key=sub_dataset_key,
        full_cov=False, with_noise=True)
    acfun_param = acfun_callback(model, sub_dataset_key)
    return acfun_sub(mu, torch.sqrt(var), acfun_param)

  return acquisition_function


def ei_callback_default(model, key, **unused_kwargs):
  """EI target: best observed y (0 with no observations)."""
  if key not in model.dataset or model.dataset[key].y.shape[0] == 0:
    return 0.0
  return torch.max(model.dataset[key].y)


def pi_callback_default(model, key, zeta=0.1, use_std=False, **unused_kwargs):
  """PI target: best observed y + zeta (optionally + zeta * std(y))."""
  if key not in model.dataset or model.dataset[key].y.shape[0] == 0:
    return 0.0
  y = model.dataset[key].y
  if use_std:
    # jnp.std is the population standard deviation.
    return torch.max(y) + zeta * torch.std(y, correction=0)
  return torch.max(y) + zeta


expected_improvement = acfun_wrapper(
    acfun_sub=expected_improvement_sub,
    acfun_callback_default=ei_callback_default)
ei = expected_improvement

probability_of_improvement = acfun_wrapper(
    acfun_sub=probability_of_improvement_sub,
    acfun_callback_default=pi_callback_default)
pi = probability_of_improvement
pi2 = acfun_wrapper(
    acfun_sub=probability_of_improvement_sub,
    acfun_callback_default=partial(pi_callback_default, use_std=True))
pi3 = acfun_wrapper(
    acfun_sub=probability_of_improvement_sub,
    acfun_callback_default=partial(pi_callback_default, zeta=0.05))

# UCB variants; default coefficient 3.
ucb4 = acfun_wrapper(acfun_sub=ucb_sub, acfun_callback_default=lambda a, b: 4.)
ucb3 = acfun_wrapper(acfun_sub=ucb_sub, acfun_callback_default=lambda a, b: 3.)
ucb2 = acfun_wrapper(acfun_sub=ucb_sub, acfun_callback_default=lambda a, b: 2.)
ucb = ucb3

rand = random_search
ts = thompson_sampling
