"""Input samplers for the continuous-oracle BO loop (port of
hyperbo_tpu/bo/input_samplers.py).

A sampler maps (generator, input_dim) to a (num_samples, input_dim) pool of
candidate inputs in [0, 1]^d, on the generator's device. The registry
INPUT_SAMPLERS names one for each data loader, as in the JAX package: a
uniform cube and a stratified (latin-hypercube) pool.

Every draw goes through `_draw_uniform` and `_draw_permutation`, the one
place each is made, so that a test can substitute the JAX package's draws.
"""

from __future__ import annotations

import torch


def _draw_uniform(generator: torch.Generator, shape) -> torch.Tensor:
  """Uniforms on [0, 1) of `shape`, on the generator's device."""
  return torch.rand(shape, generator=generator, device=generator.device)


def _draw_permutation(generator: torch.Generator, n: int) -> torch.Tensor:
  """A uniform permutation of range(n), on the generator's device."""
  return torch.randperm(n, generator=generator, device=generator.device)


def uniform_sampler(num_samples: int = 1000):
  """Uniform sampler over [0, 1]^d: (generator, input_dim) -> (n, d)."""

  def sample(generator, input_dim):
    return _draw_uniform(generator, (num_samples, input_dim))

  sample.__name__ = f'uniform_{num_samples}'
  return sample


def stratified_sampler(num_samples: int = 1000):
  """Stratified (jittered-grid) sampler over [0, 1]^d.

  Each of the n samples is jittered within its own 1/n slab per dimension,
  with the slab order permuted independently per dimension (a latin
  hypercube): lower discrepancy than iid uniforms for seeding the
  acquisition's argmax. The uniforms are drawn first, then one
  permutation a dimension.
  """

  def sample(generator, input_dim):
    u = _draw_uniform(generator, (num_samples, input_dim))
    perms = torch.stack([_draw_permutation(generator, num_samples)
                         for _ in range(input_dim)], dim=1)
    return (perms.to(u.device, u.dtype) + u) / num_samples

  sample.__name__ = f'stratified_{num_samples}'
  return sample


# data_loader_name -> sampler.
INPUT_SAMPLERS = {
    'pd1': uniform_sampler(1000),
    'random': uniform_sampler(1000),
    'uniform': uniform_sampler(1000),
    'stratified': stratified_sampler(1000),
}
