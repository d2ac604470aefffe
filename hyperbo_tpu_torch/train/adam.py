"""Adam training loops for GP objectives (port of
hyperbo_tpu/train/adam.py: the host loop `fit_adam`, `_guarded_update`,
`fit_adam_scan`, `make_fit_adam_scan`, the packed runners
`fit_adam_packed` and `make_fit_adam_packed` with their window sampler,
and the multi-start `fit_adam_packed_multistart`).

The JAX package runs the whole training as one compiled `lax.scan`; here
it is a Python loop over steps of fixed shape, with the NaN-freeze kept on
the device (no host sync inside the loop). `fit_adam` is the JAX
package's host loop: it reads each step's loss back, raises on NaN at
step 0 and stops at the first non-finite loss.

The update is written out by hand to match `optax.adam` (b1 0.9,
b2 0.999, eps 1e-8 added outside the square root, eps_root 0, bias
correction by the step count):

    m <- b1 m + (1 - b1) g,   v <- b2 v + (1 - b2) g^2,
    p <- p + (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) * (-lr),

in optax's order of operations and with its float32 bias corrections.

torch.optim.Adam computes the same rule, but the NaN-freeze must discard
a step's moments and parameters together, which is simpler on state
this module owns. The step count needs no freezing: once frozen, every
later update is discarded, so t is the step index + 1 whenever a step
is kept. `adam_update` is the bare rule, which the on-device BO loop's
retraining (bo/ondevice.py) runs without the freeze, as the JAX package
runs plain optax.adam there. The optimizer state a run returns
(config['return_state']) and resumes from (config['opt_state']) is
optax's ScaleByAdamState as a dict: {'count': steps taken, 'mu': first
moments, 'nu': second moments}, the moments in the model's layout.

Multi-start Adam trains R restarts of the packed NLL as one stack: every
leaf carries a leading restart axis, each restart draws its own batch,
and each step builds the R x T systems at once and factors them in ONE
launch of kernel K1 (models/packed.neg_log_marginal_likelihood_packed_
batched), with a NaN-freeze per restart.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import logging

import numpy as np
import torch

B1 = 0.9
B2 = 0.999
EPS = 1e-8


def _flatten(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
  if isinstance(tree, dict):
    out = []
    for k in tree:
      out.extend(_flatten(tree[k], prefix + (k,)))
    return out
  return [(prefix, tree)]


def _unflatten(paths, leaves) -> Dict[str, Any]:
  tree: Dict[str, Any] = {}
  for path, leaf in zip(paths, leaves):
    node = tree
    for k in path[:-1]:
      node = node.setdefault(k, {})
    node[path[-1]] = leaf
  return tree


def _leaf_at(tree, path):
  for k in path:
    tree = tree[k]
  return tree


class AdamState:
  """Parameters, moments and NaN-freeze latch of one training run, or of
  a stack of runs (`batch_shape` (R,): every leaf has a leading restart
  axis and each restart has its own latch).

  `opt_state` (optax's state as a dict, see `opt_state()`) resumes the
  moments and the step count of an earlier run."""

  def __init__(self, model: Dict[str, Any],
               opt_state: Optional[Dict[str, Any]] = None,
               batch_shape: Tuple[int, ...] = ()):
    flat = _flatten(model)
    self.paths = [p for p, _ in flat]
    self.params = [leaf.detach().clone() for _, leaf in flat]
    if opt_state is None:
      self.m = [torch.zeros_like(p) for p in self.params]
      self.v = [torch.zeros_like(p) for p in self.params]
      self.step = 0
    else:
      # The moments may come back from a checkpoint as numpy arrays.
      self.m, self.v = [
          [torch.as_tensor(_leaf_at(opt_state[key], path), dtype=p.dtype,
                           device=p.device).clone()
           for path, p in zip(self.paths, self.params)]
          for key in ('mu', 'nu')]
      self.step = int(opt_state['count'])
    device = self.params[0].device if self.params else 'cpu'
    self.frozen = torch.zeros(batch_shape, dtype=torch.bool, device=device)

  def model(self) -> Dict[str, Any]:
    return _unflatten(self.paths, self.params)

  def opt_state(self) -> Dict[str, Any]:
    """optax's ScaleByAdamState of this run: count, mu and nu."""
    return {'count': self.step, 'mu': _unflatten(self.paths, self.m),
            'nu': _unflatten(self.paths, self.v)}


def value_and_grads(loss_fn, state: AdamState, batch):
  """(loss, gradients) of loss_fn at the state's parameters; a leaf the
  loss does not reach gets a zero gradient. A stack's loss has one entry
  a restart, and each restart's leaves get the gradient of its own."""
  params = [p.detach().requires_grad_(True) for p in state.params]
  with torch.enable_grad():
    loss = loss_fn(_unflatten(state.paths, params), batch)
    grads = torch.autograd.grad(loss if loss.ndim == 0 else loss.sum(),
                                params, allow_unused=True)
  grads = [torch.zeros_like(p) if g is None else g
           for p, g in zip(params, grads)]
  return loss.detach(), grads


@torch.no_grad()
def adam_update(lr: float, state: AdamState, grads) -> List[Tuple[
    torch.Tensor, torch.Tensor, torch.Tensor]]:
  """optax.adam's update of every leaf at step state.step + 1: a list of
  (parameter, m, v) candidates. The caller commits them (and the step)."""
  t = state.step + 1
  # Bias corrections rounded to float32 as optax computes them.
  bc1 = float(np.float32(1) - np.float32(B1)**t)
  bc2 = float(np.float32(1) - np.float32(B2)**t)
  out = []
  for p, m, v, g in zip(state.params, state.m, state.v, grads):
    m = B1 * m + (1 - B1) * g
    v = B2 * v + (1 - B2) * g * g
    out.append((p + (m / bc1) / (torch.sqrt(v / bc2) + EPS) * (-lr), m, v))
  return out


def _guarded_update(lr: float, loss_fn, state: AdamState, batch):
  """One Adam update with the on-device NaN-freeze.

  A non-finite loss keeps the previous parameters and moments and latches
  `state.frozen`, so all remaining steps are no-ops. Returns the loss.
  """
  loss, grads = value_and_grads(loss_fn, state, batch)
  new = adam_update(lr, state, grads)
  state.step += 1
  with torch.no_grad():
    finite = torch.isfinite(loss)
    ok = finite & ~state.frozen
    for i, (p, m, v) in enumerate(new):
      keep = ok.reshape(ok.shape + (1,) * (p.ndim - ok.ndim))
      state.params[i] = torch.where(keep, p, state.params[i])
      state.m[i] = torch.where(keep, m, state.m[i])
      state.v[i] = torch.where(keep, v, state.v[i])
    state.frozen = state.frozen | ~finite
  return loss


def fit_adam(loss_fn: Callable[[Dict[str, Any], Any], torch.Tensor],
             model_params: Dict[str, Any],
             dataset_iter,
             learning_rate: float,
             max_training_step: int,
             callback: Optional[Callable[..., Any]] = None):
  """Host-loop Adam with the JAX package's NaN rules.

  Each step takes the next batch of `dataset_iter` (the host subsampler,
  models/divergences.sub_sample_dataset_iterator) and reads its loss back:
  a NaN at step 0 raises ValueError, the first non-finite loss ends the
  loop and keeps the last parameters whose loss was finite.
  `callback(step, model_params, loss)` fires after each kept step.

  Returns (model_params, final_loss): the last finite parameters and the
  loss re-evaluated at them on the final batch (after an instability
  stop, the non-finite loss that stopped the loop).
  """
  state = AdamState(model_params)
  kept = model_params
  batch = None
  loss = torch.tensor(float('nan'))
  unstable = False
  for i in range(max_training_step):
    batch = next(dataset_iter)
    loss, grads = value_and_grads(loss_fn, state, batch)
    loss_val = float(loss)
    if np.isnan(loss_val) and i == 0:
      raise ValueError(
          f'Encountered NaN in loss function. current_loss = {loss_val}.')
    if not np.isfinite(loss_val):
      logging.info('adam stopped at step %d due to instability.', i)
      unstable = True
      break
    kept = state.model()
    new = adam_update(learning_rate, state, grads)
    state.params = [p for p, _, _ in new]
    state.m = [m for _, m, _ in new]
    state.v = [v for _, _, v in new]
    state.step += 1
    if callback:
      callback(i, kept, loss)
  if batch is not None and not unstable:
    current = state.model()
    with torch.no_grad():
      final_loss = loss_fn(current, batch)
    if np.isfinite(float(final_loss)):
      kept = current
    return kept, final_loss
  return kept, loss


def fit_adam_scan(loss_fn: Callable[[Dict[str, Any], Any], torch.Tensor],
                  model_params: Dict[str, Any],
                  data: Any,
                  subsample_fn: Optional[Callable[..., Any]],
                  config: Dict[str, Any],
                  generator: Optional[torch.Generator] = None,
                  callback: Optional[Callable[..., Any]] = None):
  """Adam over config['max_training_step'] fixed-shape steps.

  `subsample_fn(generator, data)` draws each step's batch (None = full
  batch). With `callback` set, `callback(step, model_params, loss)` fires
  after every config['checkpoint_every'] steps (default 100) and after the
  last step, with that step's loss, as between the JAX package's chunks;
  it changes nothing in the iterates, so a run with checkpoints equals one
  without.

  Returns (model_params, losses): trained parameters and the (steps,)
  loss trace; with config['return_state'], (model_params, losses,
  opt_state) (see AdamState.opt_state), from which config['opt_state']
  resumes a later run.
  """
  steps = int(config['max_training_step'])
  lr = float(config['learning_rate'])
  every = int(config.get('checkpoint_every', 0) or 0) or 100
  state = AdamState(model_params, config.get('opt_state'))
  losses: List[torch.Tensor] = []
  for step in range(1, steps + 1):
    batch = subsample_fn(generator, data) if subsample_fn else data
    losses.append(_guarded_update(lr, loss_fn, state, batch))
    if callback is not None and (step % every == 0 or step == steps):
      callback(step, state.model(), losses[-1])
  if config.get('return_state'):
    return state.model(), torch.stack(losses), state.opt_state()
  return state.model(), torch.stack(losses)


def make_fit_adam_scan(loss_fn: Callable[[Dict[str, Any], Any],
                                         torch.Tensor],
                       subsample_fn: Optional[Callable[..., Any]],
                       config: Dict[str, Any]):
  """Reusable runner `run(model_params, data, generator=None) ->
  (model_params, losses)`: `fit_adam_scan` without callbacks. (The JAX
  package caches one compiled program per shape here; an eager runner has
  nothing to cache, and the factory keeps the JAX API's call shape.)"""

  def run(model, data, generator=None):
    return fit_adam_scan(loss_fn, model, data, subsample_fn, config,
                         generator)

  return run


def _packed_loss(mean_func, cov_func, config, warp_func):
  """The packed multi-task NLL with `config`, as (model, batch) -> loss."""
  from hyperbo_tpu_torch.core import defs
  from hyperbo_tpu_torch.models import packed as packed_lib

  def loss_fn(model, batch):
    shim = defs.GPParams(model=model, config=config)
    return packed_lib.neg_log_marginal_likelihood_packed(
        mean_func, cov_func, shim, batch, warp_func=warp_func)

  return loss_fn


def _packed_on_device(packed, device):
  """The packed set on its tensors' device; fields that are not tensors
  (numpy arrays) go to `device`, resolved as models/gp does: CUDA raises
  without a card."""
  if torch.is_tensor(packed.x):
    return packed
  from hyperbo_tpu_torch.models import gp
  device = gp.resolve_device(device)
  return type(packed)(*[torch.as_tensor(np.asarray(f), device=device)
                        for f in packed])


def _fit_packed(loss_fn, model_params, packed, config, generator,
                batch_size: int, window: bool):
  """fit_adam_scan over the packed set on its device: with `window`, the
  rows shuffled once and a window of them a step; else a uniform subset a
  step. The generator (default: one on the packed set's device, seeded 0,
  as the JAX package's PRNGKey(0)) draws the shuffle, then each batch."""
  from hyperbo_tpu_torch.core import convert
  from hyperbo_tpu_torch.models import packed as packed_lib

  device = packed.x.device
  if generator is None:
    generator = torch.Generator(device=device).manual_seed(0)
  if window:
    packed = packed_lib.prepermute_packed(generator, packed)

    def subsample(gen, data):
      return packed_lib.subsample_packed_window(gen, data, batch_size)
  else:
    def subsample(gen, data):
      return packed_lib.subsample_packed(gen, data, batch_size)
  return fit_adam_scan(loss_fn, convert.model_to(model_params, device),
                       packed, subsample, config, generator)


def fit_adam_packed(mean_func,
                    cov_func,
                    model_params: Dict[str, Any],
                    packed,
                    config: Dict[str, Any],
                    warp_func=None,
                    generator: Optional[torch.Generator] = None,
                    loss_fn: Optional[Callable] = None,
                    in_shardings=None,
                    device: Union[str, torch.device] = 'cuda'):
  """Adam over the packed multi-task NLL, on the packed set's device (or
  on `device`, the CUDA card unless the caller asks for the CPU, when its
  fields are numpy arrays).

  config needs learning_rate and max_training_step; batch_size defaults
  to the packed width. With config['fast_subsample'] and every task able
  to fill a batch (the one read of the device before the loop, as in the
  JAX package), the rows are shuffled once and each step takes a window
  of them (models/packed.subsample_packed_window); otherwise each step
  draws a uniform subset (subsample_packed). `loss_fn(model, batch)`
  overrides the packed NLL.

  Returns (model_params, losses), as fit_adam_scan.
  """
  if in_shardings is not None:
    from hyperbo_tpu_torch.models import gp
    raise gp._not_ported('fit_adam_packed(in_shardings=...) (the mesh '
                         'routes)')
  packed = _packed_on_device(packed, device)
  batch_size = int(config.get('batch_size', packed.x.shape[1]))
  if loss_fn is None:
    loss_fn = _packed_loss(mean_func, cov_func, config, warp_func)
  big = torch.iinfo(torch.int32).max
  window = bool(config.get('fast_subsample', False)) and int(torch.min(
      torch.where(packed.task_mask, packed.count, big))) >= batch_size
  return _fit_packed(loss_fn, model_params, packed, config, generator,
                     batch_size, window)


def make_fit_adam_packed(mean_func,
                         cov_func,
                         config: Dict[str, Any],
                         warp_func=None,
                         loss_fn: Optional[Callable] = None,
                         device: Union[str, torch.device] = 'cuda'):
  """Reusable packed-Adam runner `run(model_params, packed, generator=None)
  -> (model_params, losses)` with fit_adam_packed's semantics, on the
  packed set's device (or `device` for numpy fields), except that
  config['fast_subsample'] is honored as given: the window sampler takes a
  task smaller than the batch at offset 0 with a row mask, so no read of
  the device decides the scheme, and nothing is read back between the
  first step and the last.

  The JAX package compiles this runner once for all same-shaped calls; an
  eager runner has nothing to compile, and the factory keeps the JAX API's
  call shape. (Capturing the step as a CUDA graph is ROADMAP's lead.)
  """
  batch_size_cfg = config.get('batch_size')
  window = bool(config.get('fast_subsample', False))
  if loss_fn is None:
    loss_fn = _packed_loss(mean_func, cov_func, config, warp_func)

  def run(model, packed, generator=None):
    packed = _packed_on_device(packed, device)
    batch_size = int(batch_size_cfg or packed.x.shape[1])
    return _fit_packed(loss_fn, model, packed, config, generator,
                       batch_size, window)

  return run


def draw_restart_perturbation(generator: Optional[torch.Generator],
                              model: Dict[str, Any],
                              num_restarts: int) -> Dict[str, Any]:
  """Standard normal noise of shape (num_restarts,) + leaf shape for
  every leaf of the model, drawn on the generator's device in the
  model's leaf order."""
  def draw(leaf):
    device = leaf.device
    gen_device = generator.device if generator is not None else device
    return torch.randn((num_restarts,) + tuple(leaf.shape),
                       generator=generator, device=gen_device).to(device)

  return _unflatten(*zip(*[(path, draw(leaf))
                           for path, leaf in _flatten(model)]))


def fit_adam_packed_multistart(mean_func,
                               cov_func,
                               model_params: Dict[str, Any],
                               packed,
                               config: Dict[str, Any],
                               warp_func=None,
                               generator: Optional[torch.Generator] = None,
                               num_restarts: int = 4,
                               perturb_scale: float = 1.0,
                               loss_fn: Optional[Callable] = None,
                               callback: Optional[Callable[..., Any]] = None,
                               device: Union[str, torch.device] = 'cuda'):
  """Multi-start Adam: R restarts of the packed NLL trained as one stack.

  Restart 0 keeps the given parameters; restarts 1 to R-1 add
  perturb_scale times standard normal noise to every (unconstrained) leaf
  (draw_restart_perturbation). Each step, every restart draws its own
  batch of every task (models/packed.subsample_packed_stacked), the R x T
  systems are built at once and, at n <= 128, factored by ONE launch of
  kernel K1; each restart has its own NaN-freeze. Nothing is read back
  inside a chunk. `loss_fn(model, batch)` overrides the packed NLL and is
  then evaluated restart by restart.

  The restart with the best final objective wins, evaluated on the full
  packed set (non-finite finals never win). With `callback` set (or
  config['checkpoint_every'] > 0), `callback(step, best_model, best_loss)`
  fires after every config['checkpoint_every'] steps (default 100, as the
  JAX package's chunks) with the running best, and after the last step.

  Returns (best_model, best_loss, finals): finals is the (R,) full-set
  objective of every restart.
  """
  from hyperbo_tpu_torch.core import convert
  from hyperbo_tpu_torch.models import packed as packed_lib

  packed = _packed_on_device(packed, device)
  dev = packed.x.device
  if generator is None:
    generator = torch.Generator(device=dev).manual_seed(0)
  lr = float(config['learning_rate'])
  steps = int(config['max_training_step'])
  batch_size = int(config.get('batch_size', packed.x.shape[1]))

  if loss_fn is None:
    def stacked_loss(models, batch):
      return packed_lib.neg_log_marginal_likelihood_packed_batched(
          mean_func, cov_func, config, models, batch, warp_func=warp_func)
  else:
    def stacked_loss(models, batch):
      def at(r):
        if batch.x.ndim == 3:
          return batch
        return batch._replace(x=batch.x[r], y=batch.y[r],
                              mask=batch.mask[r], count=batch.count[r])
      return torch.stack([loss_fn(convert.model_at(models, r), at(r))
                          for r in range(num_restarts)])

  model = convert.model_to(model_params, dev)
  noise = draw_restart_perturbation(generator, model, num_restarts)
  paths, leaves = [], []
  for path, leaf in _flatten(model):
    eps = perturb_scale * _leaf_at(noise, path)
    # Restart 0 keeps the given init (a concatenation: setting the entry
    # in place would wait for the device).
    eps = torch.cat([torch.zeros_like(eps[:1]), eps[1:]])
    paths.append(path)
    leaves.append(leaf[None] + eps)
  state = AdamState(_unflatten(paths, leaves),
                    batch_shape=(num_restarts,))

  @torch.no_grad()
  def eval_best(models):
    finals = stacked_loss(models, packed)
    finals = torch.where(torch.isfinite(finals), finals, float('inf'))
    # The winner is taken by index_select: no read of the device.
    best = torch.argmin(finals)
    return (convert.model_at(models, best),
            finals.index_select(0, best.reshape(1))[0], finals)

  every = int(config.get('checkpoint_every', 0) or 0) or 100
  for step in range(1, steps + 1):
    batch = packed_lib.subsample_packed_stacked(generator, packed,
                                                batch_size, num_restarts)
    _guarded_update(lr, stacked_loss, state, batch)
    if callback is not None and step % every == 0 and step < steps:
      best_model, best_loss, _ = eval_best(state.model())
      callback(step, best_model, best_loss)
  best_model, best_loss, finals = eval_best(state.model())
  if callback is not None:
    callback(steps, best_model, best_loss)
  return best_model, best_loss, finals
