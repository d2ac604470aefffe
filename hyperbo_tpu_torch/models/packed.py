"""Packed (padded + masked) multi-task GP objectives, NLL half (port of
hyperbo_tpu/models/packed.py).

Sub-datasets are packed into dense (T, n_max, ...) buffers with row masks,
and the per-task NLL runs on all tasks at once: one batched Gram and one
batched factorization. Padded rows of K are replaced by identity rows and
padded entries of y by 0, so the padding adds nothing to the log-det or
the quadratic term, and the n/2 log(2 pi) term uses the true count.

With config['fused_mll'] = True and a served kernel at n_max >= 512, each
task goes through the fused large-n route instead (ops/fused_mll, kernels
K2-K4), one task after another.

The aligned/EKL half (pack_aligned_dataset, the KL variants,
subsample_aligned_packed) and the window sampler wait (ROADMAP Queue A).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from hyperbo_tpu_torch.core import defs
from hyperbo_tpu_torch.core.warp import retrieve_params
from hyperbo_tpu_torch.ops import batch_chol
from hyperbo_tpu_torch.ops import chol as chol_ops
from hyperbo_tpu_torch.ops import fused_mll

SubDataset = defs.SubDataset

_LOG_2PI = math.log(2 * math.pi)


class PackedDataset(NamedTuple):
  """Dense multi-task batch: T tasks padded to n_max points each."""
  x: torch.Tensor      # (T, n_max, d)
  y: torch.Tensor      # (T, n_max, 1)
  mask: torch.Tensor   # (T, n_max) bool: valid rows
  count: torch.Tensor  # (T,) int32: valid rows per task
  task_mask: torch.Tensor  # (T,) bool: valid tasks


def _round_up(x: int, m: int) -> int:
  return ((x + m - 1) // m) * m


def pack_dataset(dataset: Dict[Union[int, str], SubDataset],
                 pad_to_multiple: int = 8,
                 num_tasks_multiple: int = 1,
                 dtype=torch.float32,
                 device: Union[str, torch.device] = 'cpu'
                 ) -> Tuple[PackedDataset, List[Any]]:
  """Pack the non-aligned, single-output sub-datasets into dense buffers.

  Returns (packed, keys): the buffers on `device` and the sub-dataset keys
  in task order.
  """
  keys = [k for k, s in dataset.items()
          if s.aligned is None and s.x.shape[0] > 0 and s.y.shape[1] == 1]
  if not keys:
    raise ValueError('No non-aligned sub-datasets with scalar outputs '
                     'to pack.')
  subs = [dataset[k] for k in keys]
  d = subs[0].x.shape[1]
  n_max = _round_up(max(s.x.shape[0] for s in subs), pad_to_multiple)
  t_real = len(subs)
  t_total = _round_up(t_real, num_tasks_multiple)

  x = torch.zeros((t_total, n_max, d), dtype=dtype, device=device)
  y = torch.zeros((t_total, n_max, 1), dtype=dtype, device=device)
  mask = torch.zeros((t_total, n_max), dtype=torch.bool, device=device)
  count = torch.zeros((t_total,), dtype=torch.int32, device=device)
  for i, s in enumerate(subs):
    n = s.x.shape[0]
    x[i, :n] = torch.as_tensor(s.x, dtype=dtype, device=device)
    y[i, :n] = torch.as_tensor(s.y, dtype=dtype, device=device)
    mask[i, :n] = True
    count[i] = n
  task_mask = torch.arange(t_total, device=device) < t_real
  return PackedDataset(x=x, y=y, mask=mask, count=count,
                       task_mask=task_mask), keys


def _masked_system(mean_func, cov_func, params, x, y, mask,
                   warp_func=None, eps: float = 1e-6):
  """(K_masked, delta) of padded tasks: x (..., n_max, d), mask (..., n_max).

  Padded rows of K are identity rows (diag exactly 1, so zero log-det
  contribution) and padded entries of delta are 0.
  """
  noise_variance, = retrieve_params(params, ['noise_variance'],
                                    warp_func=warp_func)
  mu = mean_func(params, x, warp_func=warp_func)
  delta = (y - mu) * mask[..., None]
  kmat = cov_func(params, x, warp_func=warp_func)
  pair_mask = mask[..., :, None] & mask[..., None, :]
  eye = torch.eye(x.shape[-2], dtype=kmat.dtype, device=kmat.device)
  diag_fill = torch.where(mask, noise_variance + eps, 1.0)
  kmat = torch.where(pair_mask, kmat, 0.0) + eye * diag_fill[..., None]
  return kmat, delta


def nll_one_task(mean_func, cov_func, params, x, y, mask, count,
                 warp_func=None, eps: float = 1e-6) -> torch.Tensor:
  """Masked NLL of padded tasks through the dense factorization; equals
  the reference per-task NLL. Takes leading batch dimensions."""
  kmat, delta = _masked_system(mean_func, cov_func, params, x, y, mask,
                               warp_func=warp_func, eps=eps)
  chol = chol_ops.cholesky(kmat)
  kinvy = chol_ops.cho_solve(chol, delta)
  quad = 0.5 * torch.sum(delta * kinvy, dim=(-2, -1))
  # Padded diagonal entries are exactly 1, so their log is 0.
  logdet_half = torch.sum(
      torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
  return quad + logdet_half + 0.5 * count * _LOG_2PI


def _nll_packed_fused(mean_func, cov_func, params, packed, warp_func, eps):
  """Per-task NLL through the fused route, one task after another (the JAX
  package's lax.map). Padded rows leave each task exactly
  (se_nll_fused_masked); gradients flow through the fused core's
  backward."""
  lengthscale, signal_variance, noise_variance = retrieve_params(
      params, ['lengthscale', 'signal_variance', 'noise_variance'],
      warp_func=warp_func)
  kfam = fused_mll.kernel_family(cov_func)
  sv = torch.squeeze(torch.as_tensor(signal_variance))
  da = torch.squeeze(torch.as_tensor(noise_variance)) + eps
  out = []
  for x, y, mask, count in zip(packed.x, packed.y, packed.mask,
                               packed.count):
    mu = mean_func(params, x, warp_func=warp_func)
    delta = (y - torch.atleast_2d(mu)) * mask[:, None]
    emb = fused_mll._se_embed(params, x, cov_func, warp_func)
    out.append(fused_mll.se_nll_fused_masked(emb / lengthscale, delta, sv,
                                             da, count, kfam=kfam))
  return torch.stack(out)


def _batched_chol_route(params, packed) -> bool:
  """Whether the batched small-n kernel (K1) evaluates the packed NLL.

  config['batched_chol']: None/'auto'/True engage it for n_max <= 128;
  False keeps the dense factorization. The JAX package also leaves out
  n_max <= 32, but only because its Mosaic kernel pads every matrix to a
  fixed 128 x 128 sweep; the Hopper kernel takes n at run time, so small
  widths cost no padding here. The device picks the implementation
  (ops/batch_chol.batched_linv_t), so the JAX package's 'xla',
  'interpret', 'tasks3d' and 'grid2d' have no meaning here and raise.
  """
  flag = (params.config or {}).get('batched_chol', 'auto')
  if flag is False:
    return False
  if flag not in (None, 'auto', True):
    raise ValueError(f"config['batched_chol'] = {flag!r}: the port takes "
                     "None, 'auto', True or False.")
  return packed.x.shape[1] <= batch_chol.MAX_N


def _nll_packed_batched(mean_func, cov_func, params, packed, warp_func,
                        eps):
  """Per-task NLL through the batched kernel."""
  kb, delta = _masked_system(mean_func, cov_func, params, packed.x,
                             packed.y, packed.mask, warp_func=warp_func,
                             eps=eps)
  quad, ld = batch_chol.nll_terms_batched(kb.contiguous(), delta)
  return 0.5 * quad + ld + 0.5 * packed.count * _LOG_2PI


def per_task_nll_packed(mean_func,
                        cov_func,
                        params,
                        packed: PackedDataset,
                        warp_func=None,
                        eps: float = 1e-6) -> torch.Tensor:
  """(T,) per-task NLLs of a packed batch (route-selected, unmasked): the
  fused large-n route when configured and applicable, the batched small-n
  kernel (K1) in its regime, else the dense factorization."""
  if (fused_mll.fused_requested(params) and
      fused_mll.se_nll_fused_applicable(cov_func, packed.x[0], params)):
    return _nll_packed_fused(mean_func, cov_func, params, packed,
                             warp_func, eps)
  if _batched_chol_route(params, packed):
    return _nll_packed_batched(mean_func, cov_func, params, packed,
                               warp_func, eps)
  return nll_one_task(mean_func, cov_func, params, packed.x, packed.y,
                      packed.mask, packed.count, warp_func, eps)


def prior_nll_terms(params, warp_func=None):
  """Negated hyperprior log-probs added to the packed NLL (0 without
  config['priors'])."""
  total = 0.0
  if params.config and 'priors' in params.config:
    for k in params.model:
      if k in params.config['priors']:
        val, = retrieve_params(params, [k], warp_func)
        total = total - params.config['priors'][k](val)
  return total


def neg_log_marginal_likelihood_packed(mean_func,
                                       cov_func,
                                       params,
                                       packed: PackedDataset,
                                       warp_func=None,
                                       eps: float = 1e-6) -> torch.Tensor:
  """Mean NLL over the packed tasks (+ hyperprior terms)."""
  per_task = per_task_nll_packed(mean_func, cov_func, params, packed,
                                 warp_func=warp_func, eps=eps)
  per_task = torch.where(packed.task_mask, per_task, 0.0)
  num = torch.clamp(packed.task_mask.sum(), min=1)
  return per_task.sum() / num + prior_nll_terms(params, warp_func)


def subsample_packed(generator: Optional[torch.Generator],
                     packed: PackedDataset,
                     batch_size: int) -> PackedDataset:
  """Per-task uniform random subsample to at most batch_size rows.

  Tasks larger than batch_size get a fresh uniform subset of their valid
  rows on each call (top-k over uniform scores, then a row gather);
  smaller tasks keep all rows, padded rows keep their mask. The scores are
  drawn on the generator's device.
  """
  t, n_max, _ = packed.x.shape
  if batch_size >= n_max:
    return packed
  device = packed.x.device
  scores = torch.rand(
      (t, n_max), generator=generator,
      device=generator.device if generator is not None else device)
  scores = torch.where(packed.mask, scores.to(device), float('-inf'))
  sel = torch.topk(scores, batch_size, dim=1).indices       # (T, B)
  return take_rows(packed, sel)


def take_rows(packed: PackedDataset, sel: torch.Tensor) -> PackedDataset:
  """The batch of rows `sel` (T, B) of each task, valid rows first.

  `sel` lists each task's chosen valid rows before any padded ones, as
  subsample_packed's top-k order does; the new mask marks the first
  min(count, B) rows valid.
  """
  batch_size = sel.shape[1]
  d = packed.x.shape[-1]
  x = torch.gather(packed.x, 1, sel[..., None].expand(-1, -1, d))
  y = torch.gather(packed.y, 1, sel[..., None])
  count = torch.clamp(packed.count, max=batch_size)
  mask = (torch.arange(batch_size, device=sel.device)[None, :]
          < count[:, None])
  return PackedDataset(x=x, y=y, mask=mask, count=count,
                       task_mask=packed.task_mask)
