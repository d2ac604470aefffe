"""Slice sampling over GP hyperparameters, the HGP posterior sampler (port
of hyperbo_tpu/train/slice_sampler.py).

The log posterior is the negated training objective (the NLL with the
hyperprior log-probs subtracted when config['priors'] is set), over the
model's unconstrained parameters raveled into one float32 vector
(`ravel_model`, in the key order of jax.flatten_util.ravel_pytree, so the
two packages' vectors line up). Each sweep updates every coordinate once,
in a fresh random order, by Neal's (2003) univariate slice sampling:
stepping out from a bracket of `width`, then shrinkage. `burnin` sweeps
are discarded and 2 * nsamples kept, the HGP contract.

Two samplers, as in the JAX package:

  * `slice_sample`, the host loop: one log-prob evaluation at a time, read
    back as a Python float; it takes a callback a sweep.
  * `slice_sample_ondevice`: `num_chains` chains (chain c > 0 jittered by
    `init_jitter`) split the 2 * nsamples budget, and every log-prob
    evaluation is one batched call over the chains, given as a
    `batched_objective_fn` of a stacked model (its leaves with a leading
    axis). Stepping out evaluates every edge either side could reach
    (max_steps_out of each) in one call and takes each side's first edge
    under the slice, which is the decision of the JAX package's loop with
    no serial depth. Shrinkage runs its trips in chunks of SHRINK_CHUNK
    with a per-chain done mask and reads back one flag a chunk; trips
    after a chain accepted leave it unchanged and trip t takes the t-th
    uniform, so the result does not depend on the chunk size. Non-finite
    proposals are rejected; a coordinate whose shrinkage runs out stays.

`run_chains` is the device sampler's sweep loop, which the on-device HGP
BO runner (bo/ondevice.py) also advances its chains with.

Every random draw goes through its own small function (`_draw_order`,
`_draw_level`, `_draw_offset`, `_draw_shrink`, `_draw_jitter`) on a
torch.Generator, so that a test can put the JAX key schedule's draws in
their place.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Any, Callable, Dict, List, Optional

import torch

from hyperbo_tpu_torch.core import convert

# Shrinkage trips between two reads of the chains' done flag: most
# coordinates accept within a few trips, and a read costs a wait for the
# device.
SHRINK_CHUNK = 4


def _leaves(tree, prefix=()):
  """(path, leaf) pairs of a nested dict in sorted-key order, the order of
  jax.tree_util.tree_flatten for dicts."""
  if isinstance(tree, dict):
    for key in sorted(tree):
      yield from _leaves(tree[key], prefix + (key,))
  else:
    yield prefix, tree


def ravel_model(model: Dict[str, Any], device=None):
  """(flat, unravel): the model's leaves as one float32 vector, in
  jax.flatten_util.ravel_pytree's order, and its inverse.

  unravel takes leading batch dimensions: a (..., p) array gives a dict
  whose leaves have those leading dimensions.
  """
  paths, shapes, parts = [], [], []
  for path, leaf in _leaves(model):
    leaf = torch.as_tensor(leaf, dtype=torch.float32, device=device)
    paths.append(path)
    shapes.append(tuple(leaf.shape))
    parts.append(leaf.reshape(-1))
  flat = (torch.cat(parts) if parts
          else torch.zeros((0,), dtype=torch.float32, device=device))
  sizes = [p.numel() for p in parts]

  def unravel(vec: torch.Tensor) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    lead = tuple(vec.shape[:-1])
    offset = 0
    for path, shape, size in zip(paths, shapes, sizes):
      node = out
      for key in path[:-1]:
        node = node.setdefault(key, {})
      node[path[-1]] = vec[..., offset:offset + size].reshape(lead + shape)
      offset += size
    return out

  return flat, unravel


def _draw_device(generator: Optional[torch.Generator], device):
  return generator.device if generator is not None else device


def _draw_order(generator, chains: int, dim: int, device) -> torch.Tensor:
  """(chains, dim) int64: each chain's coordinate order for one sweep, a
  uniform random permutation."""
  scores = torch.rand((chains, dim), generator=generator,
                      device=_draw_device(generator, device))
  return torch.argsort(scores, dim=1).to(device)


def _draw_level(generator, chains: int, device) -> torch.Tensor:
  """(chains,) log u, u uniform on [0, 1): the slice level below the
  current log prob."""
  u = torch.rand((chains,), generator=generator,
                 device=_draw_device(generator, device))
  return torch.log(u).to(device)


def _draw_offset(generator, chains: int, device) -> torch.Tensor:
  """(chains,) uniform on [0, 1): where the current point sits in the
  initial bracket."""
  return torch.rand((chains,), generator=generator,
                    device=_draw_device(generator, device)).to(device)


def _draw_shrink(generator, chains: int, trips: int, device) -> torch.Tensor:
  """(chains, trips) uniforms on [0, 1): trip t's proposal in the bracket."""
  return torch.rand((chains, trips), generator=generator,
                    device=_draw_device(generator, device)).to(device)


def _draw_jitter(generator, chains: int, dim: int, device) -> torch.Tensor:
  """(chains, dim) standard normals: the chains' start perturbations."""
  return torch.randn((chains, dim), generator=generator,
                     device=_draw_device(generator, device)).to(device)


def _check_stepout():
  """The fused stepping out is the only one ported."""
  mode = os.environ.get('HYPERBO_SLICE_STEPOUT', 'fused')
  if mode != 'fused':
    raise NotImplementedError(
        f'HYPERBO_SLICE_STEPOUT={mode!r}: the port steps out both sides at '
        "once ('fused'); the serial loops were a TPU A/B probe: see "
        'ROADMAP Queue C')


def _count(stats, key):
  if stats is not None:
    stats[key] = stats.get(key, 0) + 1


def _set_coord(xs: torch.Tensor, i: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
  """Copies of the rows of xs (..., C, p) with coordinate i[c] of chain c
  set to values (..., C)."""
  idx = i.reshape((1,) * (xs.ndim - 2) + (-1, 1)).expand(
      xs.shape[:-1] + (1,))
  return xs.scatter(-1, idx, values[..., None])


def _coord_update(log_prob, xs, i, ll, log_u, u, shrink_u, width: float,
                  max_steps_out: int, stats=None):
  """One slice-sampling update of coordinate i[c] of every chain c.

  xs (C, p), i (C,) int64, ll (C,) the chains' log probs; log_u, u (C,)
  and shrink_u (C, max_shrink) the draws. Returns (xs, ll).
  """
  chains = xs.shape[0]
  x0i = xs.gather(1, i[:, None])[:, 0]
  log_y = ll + log_u
  left0 = x0i - u * width
  right0 = left0 + width

  # Stepping out: edge k of a side is its initial edge moved k widths out,
  # accumulated in float32 as the JAX loop does. All 2 * max_steps_out
  # edges a side could test are evaluated in one call; each side stops at
  # its first edge whose log prob is not above the level (NaN stops too).
  lefts, rights = [left0], [right0]
  for _ in range(max_steps_out):
    lefts.append(lefts[-1] - width)
    rights.append(rights[-1] + width)
  edges = torch.stack([torch.stack(lefts, dim=1), torch.stack(rights, dim=1)],
                      dim=1)                         # (C, 2, M + 1)
  if max_steps_out > 0:
    probe = edges[..., :max_steps_out].permute(2, 1, 0)   # (M, 2, C)
    cand = _set_coord(xs.expand((max_steps_out, 2) + xs.shape), i, probe)
    lp = log_prob(cand.reshape(-1, xs.shape[1]))
    _count(stats, 'evaluations')
    above = (lp.reshape(max_steps_out, 2, chains).permute(2, 1, 0)
             > log_y[:, None, None])
    out = torch.cumprod(above.to(torch.int64), dim=2).sum(dim=2)
  else:
    out = torch.zeros((chains, 2), dtype=torch.int64, device=xs.device)
  ends = edges.gather(2, out[..., None])[..., 0]
  left, right = ends[:, 0], ends[:, 1]

  # Shrinkage, trip by trip with a per-chain done mask; one flag read a
  # chunk of trips.
  xi, lli = x0i, ll
  done = torch.zeros((chains,), dtype=torch.bool, device=xs.device)
  max_shrink = shrink_u.shape[1]
  trip = 0
  while trip < max_shrink:
    for _ in range(min(SHRINK_CHUNK, max_shrink - trip)):
      x1 = left + shrink_u[:, trip] * (right - left)
      ll_new = log_prob(_set_coord(xs, i, x1))
      _count(stats, 'evaluations')
      live = ~done
      accept = live & torch.isfinite(ll_new) & (ll_new > log_y)
      xi = torch.where(accept, x1, xi)
      lli = torch.where(accept, ll_new, lli)
      reject = live & ~accept
      below = x1 < x0i
      left = torch.where(reject & below, x1, left)
      right = torch.where(reject & ~below, x1, right)
      done = done | accept
      trip += 1
    _count(stats, 'readbacks')
    if bool(done.all()):
      break
  return _set_coord(xs, i, xi), lli


def run_chains(log_prob: Callable[[torch.Tensor], torch.Tensor],
               xs: torch.Tensor,
               ll: torch.Tensor,
               generator: Optional[torch.Generator],
               sweeps: int,
               width: float = 1.0,
               max_steps_out: int = 10,
               max_shrink: int = 100,
               keep_from: Optional[int] = None,
               stats: Optional[Dict[str, int]] = None):
  """`sweeps` sweeps of the C chains xs (C, p) with log probs ll (C,).

  log_prob maps (B, p) points to (B,) log probs in one call. Each sweep
  draws every chain's coordinate order, then per coordinate the level, the
  offset and max_shrink shrinkage uniforms (in that order, as the JAX key
  schedule splits them). Returns (xs, ll, kept): kept stacks the chains
  after each sweep from `keep_from` on, (sweeps - keep_from, C, p), or is
  None. `stats` counts the batched evaluations and the flags read back.
  """
  _check_stepout()
  chains, dim = xs.shape
  device = xs.device
  kept = []
  for sweep in range(sweeps):
    order = _draw_order(generator, chains, dim, device)
    for p in range(dim):
      log_u = _draw_level(generator, chains, device)
      u = _draw_offset(generator, chains, device)
      shrink_u = _draw_shrink(generator, chains, max_shrink, device)
      xs, ll = _coord_update(log_prob, xs, order[:, p], ll, log_u, u,
                             shrink_u, width, max_steps_out, stats)
    if keep_from is not None and sweep >= keep_from:
      kept.append(xs)
  return xs, ll, (torch.stack(kept) if kept else None)


def _slice_sample_coord(log_prob, x, i: int, ll: float, log_u: float,
                        u: float, shrink_u, width: float = 1.0,
                        max_steps_out: int = 10):
  """One univariate slice-sampling update of coordinate i on the host:
  every log prob read back as a Python float, the bracket in float64 and
  the point in float32, as the JAX host loop keeps them."""
  log_y = ll + log_u
  x0 = float(x[i])
  left = x0 - u * width
  right = left + width

  def at(v):
    out = x.clone()
    out[i] = v
    return out

  j = 0
  while j < max_steps_out and float(log_prob(at(left))) > log_y:
    left -= width
    j += 1
  j = 0
  while j < max_steps_out and float(log_prob(at(right))) > log_y:
    right += width
    j += 1

  for r in shrink_u:
    x1 = left + r * (right - left)
    cand = at(x1)
    ll_new = float(log_prob(cand))
    if math.isfinite(ll_new) and ll_new > log_y:
      return cand, ll_new
    if x1 < x0:
      left = x1
    else:
      right = x1
  logging.warning('Slice sampler shrinkage exhausted at coord %d.', i)
  return x, ll


@torch.no_grad()
def slice_sample(objective_fn: Callable[[Dict[str, Any]], torch.Tensor],
                 model_params: Dict[str, Any],
                 generator: Optional[torch.Generator],
                 burnin: int,
                 nsamples: int,
                 width: float = 1.0,
                 callback: Optional[Callable[..., Any]] = None,
                 logging_interval: int = 10,
                 max_steps_out: int = 10,
                 max_shrink: int = 100) -> List[Dict[str, Any]]:
  """Posterior samples of the model parameters by the host loop.

  Args:
    objective_fn: model_params -> scalar objective (NLL incl. priors);
      -objective_fn is the unnormalized log posterior.
    model_params: starting parameters (unconstrained space).
    generator: draws the orders and uniforms (on its device).
    burnin: discarded leading sweeps.
    nsamples: 2 * nsamples samples are returned.
    width: initial slice width.
    callback: optional (step, model_params, loss) hook, once a sweep.
    logging_interval: log every this many sweeps.
    max_steps_out / max_shrink: the stepping-out bound per side and the
      shrinkage bound (the JAX host loop's 10 and 100).

  Returns:
    List of 2 * nsamples sampled model parameter dicts.
  """
  x, unravel = ravel_model(model_params)

  def log_prob(v):
    return -objective_fn(unravel(v))

  ll = float(log_prob(x))
  if not math.isfinite(ll):
    raise ValueError(f'Slice sampler started at non-finite log prob {ll}.')
  dim = x.shape[0]
  keep = []
  total = burnin + 2 * nsamples
  for it in range(total):
    order = _draw_order(generator, 1, dim, x.device)[0].tolist()
    for i in order:
      log_u = float(_draw_level(generator, 1, x.device)[0])
      u = float(_draw_offset(generator, 1, x.device)[0])
      shrink_u = _draw_shrink(generator, 1, max_shrink, x.device)[0].tolist()
      x, ll = _slice_sample_coord(log_prob, x, int(i), ll, log_u, u,
                                  shrink_u, width, max_steps_out)
    if it % logging_interval == 0:
      logging.info('slice_sample iter %d/%d log_prob=%f', it, total, ll)
    if callback is not None:
      callback(step=it, model_params=unravel(x), loss=-ll)
    if it >= burnin:
      keep.append(unravel(x))
  return keep


def _rowwise(objective_fn):
  """A batched objective from a per-model one: one call a row."""
  def batched(stacked):
    return torch.stack([
        torch.as_tensor(objective_fn(convert.model_at(stacked, r)),
                        dtype=torch.float32)
        for r in range(convert.stack_size(stacked))])
  return batched


@torch.no_grad()
def slice_sample_ondevice(
    objective_fn: Callable[[Dict[str, Any]], torch.Tensor],
    model_params: Dict[str, Any],
    generator: Optional[torch.Generator],
    burnin: int,
    nsamples: int,
    width: float = 1.0,
    max_steps_out: int = 10,
    max_shrink: int = 100,
    num_chains: int = 1,
    init_jitter: float = 0.0,
    batched_objective_fn: Optional[Callable[[Dict[str, Any]],
                                            torch.Tensor]] = None,
    stats: Optional[Dict[str, int]] = None) -> List[Dict[str, Any]]:
  """The device sampler: num_chains chains, every log-prob evaluation one
  batched call over them (and over the stepping-out edges).

  Semantics match `slice_sample` (Neal-2003 stepping out and shrinkage,
  coordinate-wise in a fresh random order a sweep); the 2 * nsamples
  samples are split evenly across the chains, each burning in on its own
  (chain c > 0 starts from the given params plus N(0, init_jitter^2)
  noise), and returned interleaved across chains, so that a prefix stays
  chain-balanced.

  Args:
    objective_fn: model_params -> scalar objective; -objective_fn is the
      unnormalized log posterior.
    model_params: starting parameters (unconstrained space).
    generator: draws the jitter, orders and uniforms (on its device).
    burnin: discarded leading sweeps (per chain).
    nsamples: 2 * nsamples samples are returned.
    width: initial slice width.
    max_steps_out: stepping-out bound per side (host parity: 10).
    max_shrink: shrinkage bound (host parity: 100).
    num_chains: parallel chains; must divide 2 * nsamples.
    init_jitter: stddev of the per-chain start perturbation.
    batched_objective_fn: stacked model (leaves with a leading axis B) ->
      (B,) objectives in one call; by default objective_fn a row.
    stats: counts of batched evaluations and flags read back, if given.

  Returns:
    List of 2 * nsamples sampled model parameter dicts.
  """
  x0, unravel = ravel_model(model_params)
  batched = batched_objective_fn or _rowwise(objective_fn)

  def log_prob(v):
    return -batched(unravel(v))

  ll0 = float(log_prob(x0[None])[0])
  if not math.isfinite(ll0):
    raise ValueError(f'Slice sampler started at non-finite log prob {ll0}.')
  want = 2 * nsamples
  if num_chains < 1 or want % num_chains:
    raise ValueError(
        f'num_chains={num_chains} must divide 2*nsamples={want}.')
  per_chain = want // num_chains
  dim = x0.shape[0]
  noise = _draw_jitter(generator, num_chains, dim, x0.device)
  scale = torch.where(torch.arange(num_chains, device=x0.device) > 0,
                      init_jitter, 0.0)
  xs = x0 + scale[:, None] * noise
  ll = log_prob(xs)
  _count(stats, 'evaluations')
  xs, ll, kept = run_chains(log_prob, xs, ll, generator, burnin + per_chain,
                            width=width, max_steps_out=max_steps_out,
                            max_shrink=max_shrink, keep_from=burnin,
                            stats=stats)
  logging.info('slice_sample_ondevice: %d chains x %d kept, final '
               'log_prob per chain = %s', num_chains, per_chain,
               ll.tolist())
  flat = kept.reshape(want, dim)
  return [unravel(row) for row in flat]
