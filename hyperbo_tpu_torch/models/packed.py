"""Packed (padded + masked) multi-task GP objectives (port of
hyperbo_tpu/models/packed.py).

Sub-datasets are packed into dense (T, n_max, ...) buffers with row masks,
and the per-task NLL runs on all tasks at once: one batched Gram and one
batched factorization. Padded rows of K are replaced by identity rows and
padded entries of y by 0, so the padding adds nothing to the log-det or
the quadratic term, and the n/2 log(2 pi) term uses the true count.

With config['fused_mll'] = True and a served kernel at n_max >= 512, each
task goes through the fused large-n route instead (ops/fused_mll, kernels
K2-K4), one task after another.

The aligned half packs the aligned sub-datasets (n matched inputs, m
function draws each) into (T, n_max, m_max) buffers and evaluates the
partial or full (SVD-whitened) KL of every task at once; its
factorizations go through ops/chol.cholesky and take its opt-in routes
(kernels K6 and K7).

Each random sampler is a draw on a torch.Generator and a deterministic
part that takes what was drawn: subsample_packed draws scores and
take_rows gathers; prepermute_packed draws each task's row order
(draw_permutation) and permute_rows applies it; subsample_packed_window
draws each task's window offset (draw_window_offsets) and take_window
slices. Tests substitute the draws with the JAX package's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from hyperbo_tpu_torch.core import convert
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
                 device: Union[str, torch.device] = 'cuda'
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
  return dense_nll(kmat, delta, count)


def dense_nll(kmat, delta, count) -> torch.Tensor:
  """NLL of masked systems (..., n, n), (..., n, 1) through the dense
  factorization (ops/chol.cholesky and its routes)."""
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


# The Gram matrices of one batched evaluation are built this many bytes at
# a time at most: larger stacks of models go in consecutive chunks.
_BATCH_GRAM_BYTES = 1 << 30


def batched_masked_system(mean_func, cov_func, config, stacked_model, x, y,
                          mask, warp_func=None, eps: float = 1e-6):
  """_masked_system of every model of a stack (leaves with a leading axis
  B): (B, ..., n, n) and (B, ..., n, 1). The padded tasks are the same
  for every model (x (T, n, d)) or each model's own (x (B, T, n, d), y
  and mask with the same leading axis)."""
  def one(model, x, y, mask):
    return _masked_system(mean_func, cov_func,
                          defs.GPParams(model=model, config=config), x, y,
                          mask, warp_func=warp_func, eps=eps)

  per_model = 0 if x.ndim == 4 else None
  return torch.func.vmap(one, in_dims=(0, per_model, per_model, per_model))(
      stacked_model, x, y, mask)


def batched_prior_nll_terms(config, stacked_model, warp_func=None):
  """prior_nll_terms of every model of a stack: (B,), or 0.0 without
  config['priors']."""
  if not config or 'priors' not in config:
    return 0.0
  return torch.func.vmap(lambda m: torch.as_tensor(prior_nll_terms(
      defs.GPParams(model=m, config=config), warp_func)))(stacked_model)


def neg_log_marginal_likelihood_packed_batched(
    mean_func, cov_func, config, stacked_model, packed: PackedDataset,
    warp_func=None, eps: float = 1e-6) -> torch.Tensor:
  """neg_log_marginal_likelihood_packed of every model of a stack (leaves
  with a leading axis B): (B,).

  `packed` holds the tasks every model is evaluated on, or each model's
  own batch of them (x, y, mask and count with a leading axis B, as
  subsample_packed_stacked draws for multi-start Adam; task_mask shared).
  The B x T systems are built at once and, in K1's regime, factored by
  ONE launch of the batched kernel on (B T, n, n) (stacks whose Gram
  matrices exceed _BATCH_GRAM_BYTES go in chunks, one launch a chunk).
  Each model's value equals the unbatched function's. The fused large-n
  route has no batched form: there each model goes through it in turn.
  """
  shim = defs.GPParams(model={}, config=config)
  b = convert.stack_size(stacked_model)
  per_model = packed.x.ndim == 4

  def data_at(r):
    if not per_model:
      return packed
    return packed._replace(x=packed.x[r], y=packed.y[r],
                           mask=packed.mask[r], count=packed.count[r])

  x_one = packed.x[0, 0] if per_model else packed.x[0]
  if (fused_mll.fused_requested(shim) and
      fused_mll.se_nll_fused_applicable(cov_func, x_one, shim)):
    return torch.stack([neg_log_marginal_likelihood_packed(
        mean_func, cov_func,
        defs.GPParams(model=convert.model_at(stacked_model, r),
                      config=config),
        data_at(r), warp_func, eps) for r in range(b)])
  t, n = packed.x.shape[-3], packed.x.shape[-2]
  use_k1 = _batched_chol_route(shim, data_at(0))
  step = max(1, _BATCH_GRAM_BYTES // max(1, 4 * t * n * n))
  per_task = []
  for start in range(0, b, step):
    part = convert.model_at(stacked_model, slice(start, start + step))
    data = data_at(slice(start, start + step))
    kb, delta = batched_masked_system(
        mean_func, cov_func, config, part, data.x, data.y, data.mask,
        warp_func=warp_func, eps=eps)
    rows = kb.shape[0]
    if use_k1:
      quad, ld = batch_chol.nll_terms_batched(
          kb.reshape(rows * t, n, n).contiguous(),
          delta.reshape(rows * t, n, 1))
      per_task.append(0.5 * quad.reshape(rows, t) + ld.reshape(rows, t) +
                      0.5 * data.count * _LOG_2PI)
    else:
      per_task.append(dense_nll(kb, delta, data.count))
  per_task = torch.where(packed.task_mask, torch.cat(per_task), 0.0)
  num = torch.clamp(packed.task_mask.sum(), min=1)
  return (per_task.sum(dim=-1) / num +
          batched_prior_nll_terms(config, stacked_model, warp_func))


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


def draw_restart_subsets(generator: Optional[torch.Generator],
                         packed: PackedDataset, batch_size: int,
                         num: int) -> torch.Tensor:
  """(num, T, batch_size) int64: for each of `num` restarts, each task's
  uniform subset of its valid rows (top-k of uniform scores, valid rows
  first), drawn on the generator's device."""
  t, n_max, _ = packed.x.shape
  device = packed.x.device
  scores = torch.rand((num, t, n_max), generator=generator,
                      device=_draw_device(generator, device)).to(device)
  scores = torch.where(packed.mask, scores, float('-inf'))
  return torch.topk(scores, batch_size, dim=-1).indices


def take_rows_stacked(packed: PackedDataset,
                      sel: torch.Tensor) -> PackedDataset:
  """take_rows of each restart's rows sel (R, T, B): x, y, mask and count
  with a leading axis R; task_mask shared."""
  r, t, batch_size = sel.shape
  tasks = torch.arange(t, device=sel.device)[:, None]
  count = torch.clamp(packed.count, max=batch_size).expand(r, t)
  mask = (torch.arange(batch_size, device=sel.device) < count[..., None])
  return PackedDataset(x=packed.x[tasks, sel], y=packed.y[tasks, sel],
                       mask=mask, count=count, task_mask=packed.task_mask)


def subsample_packed_stacked(generator: Optional[torch.Generator],
                             packed: PackedDataset, batch_size: int,
                             num: int) -> PackedDataset:
  """subsample_packed for each of `num` restarts, each with its own draw
  (draw_restart_subsets): a stacked batch (take_rows_stacked), or the
  packed set itself, shared, when batch_size >= n_max."""
  if batch_size >= packed.x.shape[1]:
    return packed
  return take_rows_stacked(
      packed, draw_restart_subsets(generator, packed, batch_size, num))


def _draw_device(generator: Optional[torch.Generator], device):
  return generator.device if generator is not None else device


def draw_permutation(generator: Optional[torch.Generator],
                     packed: PackedDataset) -> torch.Tensor:
  """(T, n_max) int64 row order of each task: its valid rows in a uniform
  random order, then its padded rows. Drawn on the generator's device."""
  t, n_max, _ = packed.x.shape
  device = packed.x.device
  scores = torch.rand((t, n_max), generator=generator,
                      device=_draw_device(generator, device)).to(device)
  scores = torch.where(packed.mask, scores, float('inf'))
  return torch.argsort(scores, dim=1)


def permute_rows(packed: PackedDataset, order: torch.Tensor
                 ) -> PackedDataset:
  """Rows of each task in the given (T, n_max) order; the masks and counts
  stay (the order puts the valid rows first)."""
  d = packed.x.shape[-1]
  x = torch.gather(packed.x, 1, order[..., None].expand(-1, -1, d))
  y = torch.gather(packed.y, 1, order[..., None])
  return packed._replace(x=x, y=y)


def prepermute_packed(generator: Optional[torch.Generator],
                      packed: PackedDataset) -> PackedDataset:
  """One-time random shuffle of each task's valid rows (pads stay last),
  for subsample_packed_window: per-step batches by sliding a window over
  the shuffled rows (epoch-style SGD batches) instead of a fresh uniform
  subset a step (config['fast_subsample'] picks this scheme)."""
  return permute_rows(packed, draw_permutation(generator, packed))


def draw_window_offsets(generator: Optional[torch.Generator],
                        packed: PackedDataset,
                        batch_size: int) -> torch.Tensor:
  """(T,) int64 window start of each task, uniform on
  [0, max(count - batch_size + 1, 1)): 0 for a task smaller than the
  batch. Drawn on the generator's device; nothing is read back."""
  device = packed.x.device
  u = torch.rand((packed.x.shape[0],), generator=generator,
                 device=_draw_device(generator, device)).to(device)
  hi = torch.clamp(packed.count.to(torch.int64) - batch_size + 1, min=1)
  return torch.minimum((u * hi).to(torch.int64), hi - 1)


def take_window(packed: PackedDataset, offsets: torch.Tensor,
                batch_size: int) -> PackedDataset:
  """Rows offsets[t] .. offsets[t] + batch_size - 1 of each task; the
  first min(count, batch_size) rows of the batch are valid."""
  rows = offsets[:, None] + torch.arange(batch_size, device=offsets.device)
  return take_rows(packed, rows)


def subsample_packed_window(generator: Optional[torch.Generator],
                            packed: PackedDataset,
                            batch_size: int) -> PackedDataset:
  """Per-step batch: a random contiguous window of each task's pre-permuted
  rows (prepermute_packed). A task smaller than the batch takes offset 0
  and the row mask of its count; batch_size >= n_max returns the packed
  set unchanged."""
  if batch_size >= packed.x.shape[1]:
    return packed
  return take_window(packed,
                     draw_window_offsets(generator, packed, batch_size),
                     batch_size)


class PackedAlignedDataset(NamedTuple):
  """Dense aligned-task batch: T tasks, n_max matched inputs, m_max
  function draws per task."""
  x: torch.Tensor        # (T, n_max, d)
  y: torch.Tensor        # (T, n_max, m_max)
  n_mask: torch.Tensor   # (T, n_max) valid rows
  m_mask: torch.Tensor   # (T, m_max) valid function draws
  count_n: torch.Tensor  # (T,)
  count_m: torch.Tensor  # (T,)
  task_mask: torch.Tensor  # (T,)


def pack_aligned_dataset(dataset: Dict[Union[int, str], SubDataset],
                         pad_to_multiple: int = 8,
                         num_tasks_multiple: int = 1,
                         dtype=torch.float32,
                         device: Union[str, torch.device] = 'cuda'
                         ) -> Tuple[PackedAlignedDataset, List[Any]]:
  """Pack the aligned sub-datasets (n x m matched evaluations) on
  `device`."""
  keys = [k for k, s in dataset.items()
          if s.aligned is not None and s.x.shape[0] > 0]
  if not keys:
    raise ValueError('No aligned sub-datasets to pack.')
  subs = [dataset[k] for k in keys]
  d = subs[0].x.shape[1]
  n_max = _round_up(max(s.x.shape[0] for s in subs), pad_to_multiple)
  m_max = _round_up(max(s.y.shape[1] for s in subs), pad_to_multiple)
  t_total = _round_up(len(subs), num_tasks_multiple)

  opts = dict(dtype=dtype, device=device)
  x = torch.zeros((t_total, n_max, d), **opts)
  y = torch.zeros((t_total, n_max, m_max), **opts)
  n_mask = torch.zeros((t_total, n_max), dtype=torch.bool, device=device)
  m_mask = torch.zeros((t_total, m_max), dtype=torch.bool, device=device)
  count_n = torch.zeros((t_total,), dtype=torch.int32, device=device)
  count_m = torch.zeros((t_total,), dtype=torch.int32, device=device)
  for i, s in enumerate(subs):
    n, m = s.y.shape
    x[i, :n] = torch.as_tensor(s.x, **opts)
    y[i, :n, :m] = torch.as_tensor(s.y, **opts)
    n_mask[i, :n] = True
    m_mask[i, :m] = True
    count_n[i] = n
    count_m[i] = m
  task_mask = torch.arange(t_total, device=device) < len(subs)
  return PackedAlignedDataset(x, y, n_mask, m_mask, count_n, count_m,
                              task_mask), keys


def _aligned_task_stats(mean_func, cov_func, params, packed, warp_func,
                        eps):
  """Masked sample and model MVN statistics of every task, shared by the
  KL variants: (mu_data, cov_data, mu_model, kmat).

  cov_data is the biased sample covariance over the valid draws (+ eps on
  the valid diagonal) and kmat the model covariance + (noise + eps) ridge;
  padded rows and columns of both are zero (the KL variants fill what they
  need).
  """
  noise_variance, = retrieve_params(params, ['noise_variance'],
                                    warp_func=warp_func)
  x, y, n_mask, m_mask = packed.x, packed.y, packed.n_mask, packed.m_mask
  m = torch.clamp(packed.count_m, min=1).to(y.dtype)[:, None]
  mu_data = torch.sum(y * m_mask[:, None, :], dim=-1) / m       # (T, n)
  centered = (y - mu_data[..., None]) * m_mask[:, None, :]
  cov_data = centered @ centered.transpose(-1, -2) / m[..., None]
  pair = n_mask[:, :, None] & n_mask[:, None, :]
  mu_data = torch.where(n_mask, mu_data, 0.0)
  eye = torch.eye(x.shape[1], dtype=cov_data.dtype, device=x.device)
  cov_data = torch.where(pair, cov_data, 0.0) + eye * torch.where(
      n_mask, eps, 0.0)[:, None, :]

  mu_model = mean_func(params, x, warp_func=warp_func)[..., 0]
  mu_model = torch.where(n_mask, mu_model, 0.0)
  kmat = cov_func(params, x, warp_func=warp_func)
  kmat = torch.where(pair, kmat, 0.0) + eye * torch.where(
      n_mask, noise_variance + eps, 0.0)[:, None, :]
  return mu_data, cov_data, mu_model, kmat


def _full_kl_tasks(mean_func, cov_func, params, packed, warp_func, eps):
  """(T,) masked FULL KL (divergences.kl_multivariate_normal(partial=False))
  with static shapes.

  Singular directions beyond the numerical rank of the sample covariance
  (and the padded dimensions, whose singular values are exactly 0) are
  zeroed in the whitener and identity-filled in the whitened model
  covariance, so each null dimension adds 1 to the trace, 0 to the log-det
  and 0 to the Mahalanobis term; subtracting the full padded size n_max
  then gives the reference value
    0.5 (tr_s + mahal + logdet_s - rank)
      = 0.5 (tr_full + mahal + logdet_full - n_max).
  """
  mu_data, cov_data, mu_model, kmat = _aligned_task_stats(
      mean_func, cov_func, params, packed, warp_func, eps)
  n_max = packed.x.shape[1]
  u, s, _ = torch.linalg.svd(cov_data)
  # The reference rank tolerance (ops/linalg.svd_matrix_sqrt) with the
  # true row count, not the padded one.
  tol = (s.max(dim=-1).values * torch.finfo(s.dtype).eps / 2. *
         torch.sqrt(2. * packed.count_n.to(s.dtype) + 1.))
  support = s > tol[:, None]
  s_safe = torch.where(support, s, 1.0)
  # Whitener W = pinv(U sqrt(S)) = diag(support / sqrt(s)) U^T.
  w = (support / torch.sqrt(s_safe))[..., None] * u.transpose(-1, -2)
  mu1 = (w @ (mu_model - mu_data)[..., None])[..., 0]
  cov1 = w @ kmat @ w.transpose(-1, -2)
  eye = torch.eye(n_max, dtype=cov1.dtype, device=cov1.device)
  cov1 = cov1 + eye * (1.0 - support.to(cov1.dtype))[:, None, :]

  chol = chol_ops.cholesky(cov1)
  kinv_mu = chol_ops.cho_solve(chol, mu1)
  vinv = chol_ops.solve_triangular(chol, eye.expand_as(chol), lower=True)
  tr_full = torch.sum(vinv * vinv, dim=(-2, -1))  # tr cov1^{-1}
  mahal = torch.sum(mu1 * kinv_mu, dim=-1)
  return 0.5 * (tr_full + mahal + chol_ops.logdet_from_chol(chol) - n_max)


def _partial_kl_tasks(mean_func, cov_func, params, packed, warp_func, eps):
  """(T,) masked partial KL: tr(K^-1 C) + (mu_K - mu_C)^T K^-1 (mu_K - mu_C)
  + logdet K, with C, mu_C the sample covariance and mean over the m
  matched draws and K the model covariance with the noise (+ eps) ridge.
  Padded rows of K are identity rows (no contribution)."""
  mu_data, cov_data, mu_model, kmat = _aligned_task_stats(
      mean_func, cov_func, params, packed, warp_func, eps)
  eye = torch.eye(packed.x.shape[1], dtype=kmat.dtype, device=kmat.device)
  kmat = kmat + eye * torch.where(packed.n_mask, 0.0, 1.0)[:, None, :]
  chol = chol_ops.cholesky(kmat)
  mu_diff = mu_model - mu_data
  kinv_mudiff = chol_ops.cho_solve(chol, mu_diff)
  kinv_cov = chol_ops.cho_solve(chol, cov_data)
  tr = torch.diagonal(kinv_cov, dim1=-2, dim2=-1).sum(dim=-1)
  mahalanobis = torch.sum(mu_diff * kinv_mudiff, dim=-1)
  return tr + mahalanobis + chol_ops.logdet_from_chol(chol)


def per_task_divergence_packed(
    mean_func, cov_func, params, packed: PackedAlignedDataset,
    warp_func=None, partial: bool = True,
    eps: float = 0.0) -> torch.Tensor:
  """(T,) per-task EKL values of a packed aligned batch (unmasked)."""
  kl_fn = _partial_kl_tasks if partial else _full_kl_tasks
  return kl_fn(mean_func, cov_func, params, packed, warp_func, eps)


def multivariate_normal_divergence_packed(
    mean_func, cov_func, params, packed: PackedAlignedDataset,
    warp_func=None, partial: bool = True,
    eps: float = 0.0) -> torch.Tensor:
  """Mean EKL over the packed aligned tasks.

  partial=True matches objectives.multivariate_normal_divergence with the
  default partial KL; partial=False is the full SVD-whitened KL. `eps` is
  the diagonal ridge the host path adds to both covariances (GP.stats uses
  1e-6).
  """
  per_task = per_task_divergence_packed(
      mean_func, cov_func, params, packed, warp_func=warp_func,
      partial=partial, eps=eps)
  per_task = torch.where(packed.task_mask, per_task, 0.0)
  num = torch.clamp(packed.task_mask.sum(), min=1)
  return per_task.sum() / num


def subsample_aligned_packed(generator: Optional[torch.Generator],
                             packed: PackedAlignedDataset,
                             batch_size: int) -> PackedAlignedDataset:
  """Per-task uniform random subsample of the matched inputs to at most
  batch_size rows; every task keeps all its m draws (only the n axis is
  subsampled, as the reference iterator does for aligned sub-datasets).
  Top-k over uniform scores drawn on the generator's device, then a row
  gather, as subsample_packed."""
  t, n_max, _ = packed.x.shape
  if batch_size >= n_max:
    return packed
  device = packed.x.device
  scores = torch.rand(
      (t, n_max), generator=generator,
      device=generator.device if generator is not None else device)
  scores = torch.where(packed.n_mask, scores.to(device), float('-inf'))
  sel = torch.topk(scores, batch_size, dim=1).indices
  return take_aligned_rows(packed, sel)


def take_aligned_rows(packed: PackedAlignedDataset,
                      sel: torch.Tensor) -> PackedAlignedDataset:
  """The batch of matched-input rows `sel` (T, B) of each task, valid rows
  first (as take_rows)."""
  batch_size = sel.shape[1]
  d, m = packed.x.shape[-1], packed.y.shape[-1]
  x = torch.gather(packed.x, 1, sel[..., None].expand(-1, -1, d))
  y = torch.gather(packed.y, 1, sel[..., None].expand(-1, -1, m))
  count_n = torch.clamp(packed.count_n, max=batch_size)
  n_mask = (torch.arange(batch_size, device=sel.device)[None, :]
            < count_n[:, None])
  return packed._replace(x=x, y=y, n_mask=n_mask, count_n=count_n)
