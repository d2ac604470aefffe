"""Multivariate-normal divergences (port of
hyperbo_tpu/models/divergences.py).

The partial KL, the full KL with SVD-square-root whitening of a possibly
rank-deficient sample covariance, and the weighted Euclidean distance of
two MVNs. Factorizations go through ops/chol.cholesky (and so take its
opt-in routes). `sub_sample_dataset_iterator` draws the host-loop
trainer's batches; its row order is drawn by `draw_permutation`, which a
test can replace by the JAX stream's.
"""

from __future__ import annotations

from typing import Optional

import torch

from hyperbo_tpu_torch.core import defs
from hyperbo_tpu_torch.ops import linalg

SubDataset = defs.SubDataset


def draw_permutation(generator: Optional[torch.Generator], n: int,
                     device) -> torch.Tensor:
  """A uniform random permutation of range(n), int64 on `device` (drawn
  on the generator's device)."""
  gen_device = generator.device if generator is not None else device
  return torch.randperm(n, generator=generator,
                        device=gen_device).to(device)


def sub_sample_dataset_iterator(generator: Optional[torch.Generator],
                                dataset, batch_size: int):
  """Yields datasets whose sub-datasets have at most batch_size rows.

  A sub-dataset of batch_size rows or more takes the first batch_size
  rows of a fresh permutation (one draw a sub-dataset a batch, in dataset
  order); a smaller one is kept whole. A string `aligned` tag is replaced
  by the sub-dataset's enumeration index, as in the JAX package.
  """
  while True:
    sub_sampled = {}
    for i, (sub_key, sub) in enumerate(dataset.items()):
      if sub.x.shape[0] >= batch_size:
        indices = draw_permutation(generator, sub.x.shape[0],
                                   sub.x.device)[:batch_size]
        new_sub = SubDataset(x=sub.x[indices, :], y=sub.y[indices, :],
                             aligned=sub.aligned)
      else:
        new_sub = sub
      if isinstance(new_sub.aligned, str):
        new_sub = SubDataset(x=new_sub.x, y=new_sub.y, aligned=i)
      sub_sampled[sub_key] = new_sub
    yield sub_sampled


def partial_kl_mvn(mu0, cov0, mu1, cov1):
  """KL(N0 || N1) terms that depend on mu1 / cov1 only:
  tr(cov1^{-1} cov0) + (mu1 - mu0)^T cov1^{-1} (mu1 - mu0) + log det cov1.
  """
  mu_diff = mu1 - mu0
  chol1, cov1invmudiff = linalg.solve_linear_system(cov1, mu_diff)
  kinv_cov0 = linalg.inverse_spdmatrix_vector_product(
      cov1, cov0, cached_cholesky=chol1)
  trcov1invcov0 = torch.trace(kinv_cov0)
  mahalanobis = torch.dot(mu_diff, cov1invmudiff)
  logdetcov1 = torch.sum(2 * torch.log(torch.diagonal(chol1)))
  return trcov1invcov0 + mahalanobis + logdetcov1


def kl_multivariate_normal(mu0, cov0, mu1, cov1, weight=1.0, eps=0.0,
                           partial=True):
  """KL divergence between two MVNs.

  partial=True drops the terms constant in (mu1, cov1). partial=False
  whitens by the SVD square root of cov0 (rank-deficient sample
  covariances included) and returns the full KL restricted to the support
  of cov0.
  """
  if not cov0.shape:
    cov0 = cov0[None, None]
  if not cov1.shape:
    cov1 = cov1[None, None]
  if eps > 0.:
    cov0 = cov0 + torch.eye(cov0.shape[0], dtype=cov0.dtype,
                            device=cov0.device) * eps
    cov1 = cov1 + torch.eye(cov1.shape[0], dtype=cov1.dtype,
                            device=cov1.device) * eps
  if partial:
    return weight * partial_kl_mvn(mu0, cov0, mu1, cov1)

  chol0 = linalg.svd_matrix_sqrt(cov0)
  # jnp.linalg.pinv's default cutoff, 10 max(m, n) eps.
  rtol = 10. * max(chol0.shape) * torch.finfo(chol0.dtype).eps
  chol0inv = torch.linalg.pinv(chol0, rtol=rtol)
  mu1 = torch.matmul(chol0inv, mu1 - mu0)
  cov1 = chol0inv @ cov1 @ chol0inv.T
  mu0 = torch.zeros_like(mu1)
  cov0 = torch.eye(cov1.shape[0], dtype=cov1.dtype, device=cov1.device)
  ekl = 0.5 * (partial_kl_mvn(mu0, cov0, mu1, cov1) - chol0.shape[1])
  return weight * ekl


def euclidean_multivariate_normal(mu0, cov0, mu1, cov1, mean_weight=1.,
                                  cov_weight=1., **unused_kwargs):
  """Weighted Euclidean distance between two MVNs (means and
  covariances)."""
  mean_diff = linalg.safe_l2norm(mu0 - mu1)
  cov_diff = linalg.safe_l2norm((cov0 - cov1).flatten())
  return mean_weight * mean_diff + cov_weight * cov_diff
