"""The packed Adam runners of the PyTorch port (train/adam.fit_adam_packed
and make_fit_adam_packed) and their window sampler
(models/packed.prepermute_packed, subsample_packed_window) against the
JAX package on the CPU, on the same numpy inputs.

Randomness is injected: the port's draws (each task's row order, each
step's window offsets or subsample rows) are replaced by the JAX stream's
own, computed here from the keys the JAX code splits, never seeded alike.

Tolerances: the sampled batches equal (rows are copied); loss traces
within rtol 1e-4 and trained leaves within atol 1e-4, the bounds of
tests/test_torch_slice.py (float32 on both sides, summed in different
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.core import defs as jdefs
from hyperbo_tpu.core.warp import DEFAULT_WARP_FUNC as JWARP
from hyperbo_tpu.models import kernel as jkernel
from hyperbo_tpu.models import mean as jmean
from hyperbo_tpu.models import packed as jpacked
from hyperbo_tpu.train import adam as jadam
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC as TWARP
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.models import packed as tpacked
from hyperbo_tpu_torch.train import adam as tadam
from torch_threads import one_torch_thread  # noqa: F401

D, BATCH, STEPS = 3, 8, 6


def _data(sizes, seed=0):
  rng = np.random.default_rng(seed)
  data = {}
  for i, n in enumerate(sizes):
    x = rng.uniform(size=(n, D)).astype(np.float32)
    y = (np.sin(3 * x @ rng.normal(size=(D, 1))) +
         0.1 * rng.normal(size=(n, 1))).astype(np.float32)
    data[f't{i}'] = (x, y)
  return data


def _packs(sizes):
  """(JAX pack, port pack on the CPU) of the same tasks."""
  data = _data(sizes)
  jpack, _ = jpacked.pack_dataset(
      {k: jdefs.SubDataset(*v) for k, v in data.items()})
  tpack, _ = tpacked.pack_dataset(
      {k: tdefs.SubDataset(*v) for k, v in data.items()}, device='cpu')
  return jpack, tpack


WINDOW_TASKS, RUNNER_TASKS, FALLBACK_TASKS = (13, 5, 16), (13, 16, 11), (
    13, 6, 16)
CONFIG = {'learning_rate': 0.05, 'max_training_step': STEPS,
          'batch_size': BATCH, 'fast_subsample': True}


def _model():
  rng = np.random.default_rng(1)
  return {'constant': np.float32(0.1),
          'lengthscale': np.full((D,), 0.3, np.float32),
          'signal_variance': np.float32(0.2),
          'noise_variance': np.float32(-3.0),
          'linear_mean': {
              'kernel': 0.3 * rng.normal(size=(D, 1)).astype(np.float32),
              'bias': np.zeros((1,), np.float32)}}


def _jax_order(key, mask):
  """prepermute_packed's row order of each task (its draw, then argsort)."""
  keys = jax.random.split(key, mask.shape[0])
  scores = jax.vmap(lambda k, m: jnp.where(
      m, jax.random.uniform(k, (m.shape[0],)), jnp.inf))(keys, mask)
  return jnp.argsort(scores, axis=1)


def _jax_offsets(key, count):
  """subsample_packed_window's offset of each task."""
  keys = jax.random.split(key, count.shape[0])
  hi = jnp.maximum(count - BATCH + 1, 1)
  return jax.vmap(lambda k, h: jax.random.randint(k, (), 0, h))(keys, hi)


def _jax_subset(key, mask):
  """subsample_packed's rows of each task (top-k of its scores)."""
  keys = jax.random.split(key, mask.shape[0])
  scores = jax.vmap(lambda k, m: jnp.where(
      m, jax.random.uniform(k, (m.shape[0],)), -jnp.inf))(keys, mask)
  return jax.lax.top_k(scores, BATCH)[1]


def _t(a):
  return torch.from_numpy(np.asarray(a)).to(torch.int64)


def _assert_batch_equal(tbatch, jbatch):
  for name in ('x', 'y', 'mask', 'count', 'task_mask'):
    np.testing.assert_array_equal(getattr(tbatch, name).numpy(),
                                  np.asarray(getattr(jbatch, name)),
                                  err_msg=name)


def _assert_close_leaves(tmodel, jmodel):
  """Trained leaves within atol 1e-4, leaf by leaf."""
  got = convert.model_to_numpy(tmodel)
  for path, want in jax.tree_util.tree_leaves_with_path(jmodel):
    leaf = got
    for p in path:
      leaf = leaf[p.key]
    np.testing.assert_allclose(leaf, np.asarray(want), atol=1e-4,
                               err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope='module')
def jax_ref():
  """Every JAX result this file compares with, as numpy, from ONE jitted
  program: the shuffle and window of WINDOW_TASKS with their draws; the
  compile-once runner on RUNNER_TASKS with the order and the offsets of
  each step it draws; the subsets that fit_adam_packed's steps draw on
  FALLBACK_TASKS. (fit_adam_packed itself reads the device before its
  loop, so it runs outside.)"""
  def everything():
    out = {}
    jpack, _ = _packs(WINDOW_TASKS)
    pkey, wkey = jax.random.split(jax.random.PRNGKey(2))
    out['order'] = _jax_order(pkey, jpack.mask)
    out['perm'] = jpacked.prepermute_packed(pkey, jpack)
    out['offsets'] = _jax_offsets(wkey, jpack.count)
    out['window'] = jpacked.subsample_packed_window(wkey, out['perm'],
                                                    BATCH)
    jpack, _ = _packs(RUNNER_TASKS)
    key = jax.random.PRNGKey(4)
    out['run'] = jadam.make_fit_adam_packed(
        jmean.linear, jkernel.squared_exponential, CONFIG,
        warp_func=JWARP)(jax.tree.map(jnp.asarray, _model()), jpack, key)
    rest, pkey = jax.random.split(key)
    out['run_order'] = _jax_order(pkey, jpack.mask)
    out['run_offsets'] = jax.vmap(_jax_offsets, in_axes=(0, None))(
        jax.random.split(rest, STEPS), jpack.count)
    jpack, _ = _packs(FALLBACK_TASKS)
    # fit_adam_scan threads the key: k, sk = split(k) a step.
    key, subsets = jax.random.PRNGKey(5), []
    for _ in range(STEPS):
      key, sk = jax.random.split(key)
      subsets.append(_jax_subset(sk, jpack.mask))
    out['subsets'] = jnp.stack(subsets)
    return out

  return jax.tree.map(np.asarray, jax.jit(everything)())


def test_prepermute_and_window_match_jax(jax_ref, monkeypatch):
  """With the JAX stream's order and offsets injected, the shuffled rows
  and the windows equal the JAX package's, a task of 5 rows (smaller than
  the batch: offset 0 and a row mask) included; a batch as wide as the
  packed set returns it unchanged."""
  _, tpack = _packs(WINDOW_TASKS)
  monkeypatch.setattr(tpacked, 'draw_permutation',
                      lambda g, p: _t(jax_ref['order']))
  tperm = tpacked.prepermute_packed(None, tpack)
  _assert_batch_equal(tperm, jax_ref['perm'])
  assert int(jax_ref['offsets'][1]) == 0
  monkeypatch.setattr(tpacked, 'draw_window_offsets',
                      lambda g, p, b: _t(jax_ref['offsets']))
  _assert_batch_equal(tpacked.subsample_packed_window(None, tperm, BATCH),
                      jax_ref['window'])
  assert tpacked.subsample_packed_window(None, tperm, 16) is tperm
  monkeypatch.undo()

  # The port's own draws: a permutation of each task's valid rows, pads
  # last, and offsets that keep every window inside its task.
  gen = torch.Generator().manual_seed(0)
  for _ in range(20):
    order = tpacked.draw_permutation(gen, tpack)
    for t, n in enumerate(tpack.count.tolist()):
      assert sorted(order[t, :n].tolist()) == list(range(n))
    offsets = tpacked.draw_window_offsets(gen, tpack, BATCH)
    assert offsets.tolist()[1] == 0
    assert (offsets + BATCH <= torch.clamp(tpack.count, min=BATCH)).all()


def test_make_fit_adam_packed_matches_jax(jax_ref, monkeypatch):
  """The compile-once runner with fast_subsample: one split for the
  shuffle, one draw a step, as the JAX runner keys them."""
  _, tpack = _packs(RUNNER_TASKS)
  offsets = iter(jax_ref['run_offsets'])
  monkeypatch.setattr(tpacked, 'draw_permutation',
                      lambda g, p: _t(jax_ref['run_order']))
  monkeypatch.setattr(tpacked, 'draw_window_offsets',
                      lambda g, p, b: _t(next(offsets)))
  run = tadam.make_fit_adam_packed(tmean.linear, tkernel.squared_exponential,
                                   CONFIG, warp_func=TWARP)
  tmodel, tlosses = run(convert.model_from_jax(_model()), tpack)
  jmodel, jlosses = jax_ref['run']
  np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=1e-4)
  assert tlosses[-1] < tlosses[0]
  _assert_close_leaves(tmodel, jmodel)


def test_fit_adam_packed_falls_back_to_subsample_packed(jax_ref,
                                                        monkeypatch):
  """With a task smaller than the batch, fit_adam_packed keeps the uniform
  subsample though fast_subsample is set (the JAX gate), and matches the
  JAX package on its per-step subsets; in_shardings raises."""
  jpack, tpack = _packs(FALLBACK_TASKS)
  jmodel, jlosses = jadam.fit_adam_packed(
      jmean.linear, jkernel.squared_exponential,
      jax.tree.map(jnp.asarray, _model()), jpack, CONFIG, warp_func=JWARP,
      key=jax.random.PRNGKey(5))
  subsets = iter(jax_ref['subsets'])
  monkeypatch.setattr(tpacked, 'subsample_packed',
                      lambda g, p, b: tpacked.take_rows(p, _t(next(subsets))))

  def no_window(*args):
    raise AssertionError('the window sampler must not run')

  monkeypatch.setattr(tpacked, 'prepermute_packed', no_window)
  monkeypatch.setattr(tpacked, 'subsample_packed_window', no_window)
  tmodel, tlosses = tadam.fit_adam_packed(
      tmean.linear, tkernel.squared_exponential,
      convert.model_from_jax(_model()), tpack, CONFIG, warp_func=TWARP)
  np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                             rtol=1e-4)
  _assert_close_leaves(tmodel, jmodel)
  with pytest.raises(NotImplementedError, match='ROADMAP'):
    tadam.fit_adam_packed(tmean.linear, tkernel.squared_exponential,
                          convert.model_from_jax(_model()), tpack, CONFIG,
                          warp_func=TWARP, in_shardings=object())
