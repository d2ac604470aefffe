"""Log-prob priors for GP hyperparameters (port of
hyperbo_tpu/models/priors.py).

The log densities are written out (Normal, LogNormal, TruncatedNormal), as
in the JAX package, with the same parameters; the normal CDF is
torch.special.ndtr.
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def _normal_log_prob(x, loc, scale):
  x = torch.as_tensor(x)
  z = (x - loc) / scale
  return -0.5 * z * z - math.log(scale) - 0.5 * _LOG_2PI


def _lognormal_log_prob(x, loc, scale):
  logx = torch.log(torch.as_tensor(x))
  return _normal_log_prob(logx, loc, scale) - logx


def _truncated_normal_log_prob(x, loc, scale, low, high):
  x = torch.as_tensor(x)
  z = _normal_log_prob(x, loc, scale)
  mass = (torch.special.ndtr(torch.tensor((high - loc) / scale)) -
          torch.special.ndtr(torch.tensor((low - loc) / scale)))
  inside = (x >= low) & (x <= high)
  return torch.where(inside, z - torch.log(mass).to(z.device),
                     torch.full_like(z, -math.inf))


def _square_plus(x):
  return (x + torch.sqrt(x**2 + 4)) / 2


def kumar_prior(params):
  """TruncatedNormal(0, 1, [-2, 2]) prior on log(squareplus(a/b))."""
  prior_ll = lambda x: _truncated_normal_log_prob(
      torch.log(_square_plus(torch.as_tensor(x))), 0., 1., -2., 2.)
  return sum(torch.sum(prior_ll(v)) for v in params.values())


noise_prior = lambda x: torch.sum(_normal_log_prob(x, 0., 0.1))
lognormal_prior = lambda x: torch.sum(_lognormal_log_prob(x, 0., 1.))
constant_prior = lambda x: torch.sum(_normal_log_prob(x, 0., 1.))
horseshoe_prior = lambda x, tau: torch.log(torch.log(1. + 3. * (tau / x)**2))

DEFAULT_PRIORS = {
    'noise_variance': noise_prior,
    'signal_variance': lognormal_prior,
    'constant': constant_prior,
}
