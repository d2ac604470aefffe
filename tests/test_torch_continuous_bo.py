"""The continuous-oracle BO of the PyTorch port (bo/bayesopt.bayesopt with
its L-BFGS-B refinement, bo/input_samplers, bo/const, the on-device
continuous runner of bo/ondevice) and the two model-level helpers
(ops/gram.sqdist_direct, models/mean.mean_vector) against the JAX package
on the CPU, on the same numpy inputs.

Randomness is injected: the port's pools and picks ('rand', 'ts') are
replaced by the JAX stream's own draws, never seeded alike. The JAX
results come from one module fixture.

Tolerances (float32 on both sides): sqdist_direct and mean_vector within
rtol 1e-6; the samplers' pools equal (the same uniforms and permutations,
one float32 operation each); an L-BFGS-B refinement and a 2-iteration EI
run from the same starts within atol 1e-4 in x (scipy drives both in
float64 from float32 values and gradients that differ in their last bits)
and their acquisition values within rtol 1e-4; the on-device runner's
selections bitwise with no refinement, within atol 1e-4 after 15 steps of
projected gradient ascent, and bitwise for 'rand' and 'ts'; the oracle's
values at equal points within rtol 1e-6 (its float32 sum, in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.bo import acfun as jacfun
from hyperbo_tpu.bo import bayesopt as jbo
from hyperbo_tpu.bo import input_samplers as jsamplers
from hyperbo_tpu.bo import ondevice as jon
from hyperbo_tpu.core import defs as jdefs
from hyperbo_tpu.core.warp import DEFAULT_WARP_FUNC as JWARP
from hyperbo_tpu.models import gp as jgp
from hyperbo_tpu.models import kernel as jkernel
from hyperbo_tpu.models import mean as jmean
from hyperbo_tpu.ops import gram as jgram
from hyperbo_tpu_torch.bo import acfun as tacfun
from hyperbo_tpu_torch.bo import bayesopt as tbo
from hyperbo_tpu_torch.bo import const as tconst
from hyperbo_tpu_torch.bo import input_samplers as tsamplers
from hyperbo_tpu_torch.bo import ondevice as ton
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC as TWARP
from hyperbo_tpu_torch.models import gp as tgp
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.ops import gram as tgram
from torch_threads import one_torch_thread  # noqa: F401

D, POOL, ITERS, BO_ITERS, SAMPLES = 2, 48, 5, 2, 24
MODEL = {'constant': np.float32(0.1),
         'lengthscale': np.array([-0.7, -0.4], np.float32),
         'signal_variance': np.float32(0.3),
         'noise_variance': np.float32(-3.0)}
# The on-device loop's model (tests/test_bayesopt.py's continuous case).
LOOP_MODEL = {'constant': np.float32(0.),
              'lengthscale': np.array([.3, .3], np.float32),
              'signal_variance': np.float32(1.0),
              'noise_variance': np.float32(1e-4)}


def _init_obs():
  x = np.array([[0.9, 0.9], [0.1, 0.8], [0.6, 0.2]], np.float32)
  return x, -np.sum((x - 0.35) ** 2, axis=1, keepdims=True)


def _joracle(x):
  return -jnp.sum((x - 0.35) ** 2, axis=-1, keepdims=True)


def _toracle(x):
  return -torch.sum((x - 0.35) ** 2, dim=-1, keepdim=True)


def _jscalar_mean(params, x, warp_func=None):
  del warp_func
  return jnp.atleast_1d(jnp.sum(jnp.sin(3 * x)) * params.model['constant'])


def _tscalar_mean(params, x, warp_func=None):
  del warp_func
  return torch.atleast_1d(torch.sum(torch.sin(3 * x)) *
                          params.model['constant'])


def _jmodel():
  x, y = _init_obs()
  return jgp.GP({'test': jdefs.SubDataset(jnp.asarray(x), jnp.asarray(y))},
                jmean.constant, jkernel.squared_exponential,
                jdefs.GPParams(model=jax.tree.map(jnp.asarray, MODEL),
                               config={}), JWARP)


def _tmodel():
  x, y = _init_obs()
  return tgp.GP({'test': (x, y)}, tmean.constant,
                tkernel.squared_exponential,
                tdefs.GPParams(model=convert.model_from_jax(MODEL),
                               config={}), TWARP, device='cpu')


def _jax_loop(refine_steps, acquisition, key):
  x0, y0 = _init_obs()
  return jon.continuous_bayesopt_ondevice(
      jmean.zero, jkernel.squared_exponential,
      jax.tree.map(jnp.asarray, LOOP_MODEL), {}, None, _joracle,
      input_dim=D, iters=ITERS, acquisition=acquisition, pool_size=POOL,
      refine_steps=refine_steps, init_obs=(jnp.asarray(x0), jnp.asarray(y0)),
      key=key)


def _jax_loop_draws(key):
  """The JAX continuous runner's draws, iteration by iteration: its pool,
  the 'rand' index and the 'ts' normals of each split(key, ITERS) key."""
  keys = jax.random.split(key, ITERS)
  return {
      'pool': jax.vmap(lambda k: jax.random.uniform(k, (POOL, D)))(keys),
      'index': jax.vmap(lambda k: jax.random.randint(
          jax.random.fold_in(k, 1), (), 0, POOL))(keys),
      'normal': jax.vmap(lambda k: jax.random.normal(
          jax.random.fold_in(k, 2), (POOL, 1)))(keys)}


def _jax_host():
  """The JAX host loop: BO_ITERS EI iterations whose pools are recorded
  (its first point is the L-BFGS-B refinement of the first pool's
  argmax)."""
  pools = []

  def sampler(key, input_dim):
    p = jax.random.uniform(key, (SAMPLES, input_dim))
    pools.append(np.asarray(p))
    return p

  obs = jbo.bayesopt(jax.random.PRNGKey(22), _jmodel(), 'test', _joracle,
                     jacfun.expected_improvement, BO_ITERS, sampler)
  return {'bo_pools': np.stack(pools), 'bo_x': np.asarray(obs.x),
          'bo_y': np.asarray(obs.y)}


@pytest.fixture(scope='module')
def jax_ref():
  """Every JAX result this file compares with, as numpy: the host loop,
  and the rest from one jitted program."""
  rng = np.random.default_rng(0)
  a = rng.normal(size=(7, 3)).astype(np.float32)
  b = rng.normal(size=(5, 3)).astype(np.float32)

  def everything():
    out = {'sqdist': jgram.sqdist_direct(a),
           'sqdist2': jgram.sqdist_direct(a, b),
           'mean_vector': jmean.mean_vector(_jscalar_mean)(
               jdefs.GPParams(model={'constant': jnp.float32(0.7)}), a)}
    key = jax.random.PRNGKey(5)
    out['uniform'] = jsamplers.uniform_sampler(30)(key, 3)
    out['stratified'] = jsamplers.stratified_sampler(30)(key, 3)
    keys = jax.random.split(key, 4)
    out['stratified_draws'] = (
        jax.random.uniform(keys[0], (30, 3)),
        [jax.random.permutation(k, 30) for k in keys[1:]])
    loop_key = jax.random.PRNGKey(3)
    for steps in (0, 15):
      out['loop_%d' % steps] = _jax_loop(steps, 'ei', loop_key)
    # 'rand' and 'ts' take no refinement: 0 steps compiles less.
    for acq in ('rand', 'ts'):
      out['loop_' + acq] = _jax_loop(0, acq, loop_key)
    out['loop_draws'] = _jax_loop_draws(loop_key)
    return out

  out = jax.tree.map(np.asarray, jax.jit(everything)())
  out['inputs'] = (a, b)
  out.update(_jax_host())
  return out


def _replay(values):
  it = iter(values)
  return lambda *args, **kwargs: torch.from_numpy(np.array(next(it)))


def test_sqdist_direct_and_mean_vector_match_jax(jax_ref):
  a, b = map(torch.from_numpy, jax_ref['inputs'])
  np.testing.assert_allclose(tgram.sqdist_direct(a).numpy(),
                             jax_ref['sqdist'], rtol=1e-6)
  np.testing.assert_allclose(tgram.sqdist_direct(a, b).numpy(),
                             jax_ref['sqdist2'], rtol=1e-6)
  # Batched leading dimensions, as the port's other distance functions.
  assert tgram.sqdist_direct(torch.stack([a, a])).shape == (2, 7, 7)
  vec = tmean.mean_vector(_tscalar_mean)
  got = vec(tdefs.GPParams(model={'constant': torch.tensor(0.7)}), a)
  assert got.shape == (7, 1)
  np.testing.assert_allclose(got.numpy(), jax_ref['mean_vector'], rtol=1e-6)
  assert vec.__name__ == '_tscalar_mean'


def test_input_samplers_give_jax_pools_from_its_draws(jax_ref, monkeypatch):
  """Both samplers on the JAX stream's draws; the registries' keys."""
  monkeypatch.setattr(tsamplers, '_draw_uniform',
                      _replay([jax_ref['uniform']]))
  got = tsamplers.uniform_sampler(30)(torch.Generator(), 3)
  np.testing.assert_array_equal(got.numpy(), jax_ref['uniform'])
  u, perms = jax_ref['stratified_draws']
  monkeypatch.setattr(tsamplers, '_draw_uniform', _replay([u]))
  monkeypatch.setattr(tsamplers, '_draw_permutation', _replay(perms))
  got = tsamplers.stratified_sampler(30)(torch.Generator(), 3)
  np.testing.assert_allclose(got.numpy(), jax_ref['stratified'], rtol=1e-6)
  monkeypatch.undo()
  # Undisturbed: a stratified pool has one sample in each 1/n slab of
  # every dimension, on the generator's device.
  pool = tsamplers.stratified_sampler(30)(torch.Generator().manual_seed(1),
                                          3)
  assert pool.device.type == 'cpu' and pool.shape == (30, 3)
  for j in range(3):
    assert sorted((pool[:, j] * 30).floor().long().tolist()) == list(
        range(30))
  assert set(tsamplers.INPUT_SAMPLERS) == set(jsamplers.INPUT_SAMPLERS)
  assert tconst.INPUT_SAMPLERS is tsamplers.INPUT_SAMPLERS
  from hyperbo_tpu.bo import const as jconst
  for name in ('MEAN', 'KERNEL', 'ACFUN', 'ACFUN_SUB'):
    assert set(getattr(tconst, name)) == set(getattr(jconst, name)), name
    for k, f in getattr(tconst, name).items():
      assert f.__module__.startswith('hyperbo_tpu_torch'), (name, k)
  for name in ('EPS', 'CONTEXTUAL_METHODS', 'HBO_METHODS',
               'OFFLINE_METHODS', 'ONLINE_METHODS', 'USE_HGP', 'ST_METHODS'):
    assert getattr(tconst, name) == getattr(jconst, name), name
  assert not hasattr(tconst, 'HYPERBO_DATASETS')


def test_lbfgsb_refine_matches_jax(jax_ref):
  """From the first pool's EI argmax on the same GP, the refined point is
  the JAX loop's first (its refinement of the same start) and reaches its
  EI; the refinement never leaves the box [0, 1]^d."""
  model = _tmodel()
  ei = tacfun.expected_improvement
  pool = torch.tensor(jax_ref['bo_pools'][0])
  with torch.no_grad():
    x_init = pool[ei(model=model, sub_dataset_key='test',
                     x_queries=pool).argmax()]
  neg_ac = lambda x: -ei(model=model, sub_dataset_key='test',
                         x_queries=x[None, :]).flatten()[0]
  got = tbo._lbfgsb_refine(neg_ac, x_init, D)
  want = torch.tensor(jax_ref['bo_x'][3])
  assert got.dtype == torch.float32 and got.shape == (D,)
  np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
  with torch.no_grad():
    np.testing.assert_allclose(-float(neg_ac(got)), -float(neg_ac(want)),
                               rtol=1e-4)
    assert -float(neg_ac(got)) >= -float(neg_ac(x_init))
  assert bool(((got >= 0) & (got <= 1)).all())


def test_bayesopt_matches_jax_and_ts_stays_in_its_pools(jax_ref):
  """BO_ITERS EI iterations on the JAX pools give the JAX observations;
  Thompson sampling proposes only members of its pools."""
  pools = iter(jax_ref['bo_pools'])
  sampler = lambda gen, d: torch.from_numpy(next(pools))
  obs = tbo.bayesopt(torch.Generator().manual_seed(0), _tmodel(), 'test',
                     _toracle, tacfun.expected_improvement, BO_ITERS,
                     sampler)
  np.testing.assert_allclose(obs.x.numpy(), jax_ref['bo_x'], atol=1e-4)
  np.testing.assert_allclose(obs.y.numpy(), jax_ref['bo_y'], atol=1e-4)

  drawn = []

  def recording(gen, d):
    drawn.append(tsamplers.uniform_sampler(SAMPLES)(gen, d))
    return drawn[-1]

  model = _tmodel()
  model.rng = torch.Generator().manual_seed(31)
  obs = tbo.bayesopt(torch.Generator().manual_seed(32), model, 'test',
                     lambda x: torch.sin(5 * x[:, :1]),
                     tacfun.thompson_sampling, 2, recording)
  assert len(drawn) == 2
  for x_new, pool in zip(obs.x[3:], drawn):
    assert bool((pool == x_new).all(dim=1).any())
  with pytest.raises(ValueError, match='generator'):
    tbo.bayesopt(None, _tmodel(), 'test', _toracle, tacfun.ucb, 1, sampler)


def test_run_bayesopt_oracle_branch(monkeypatch):
  """run_bayesopt with a callable: init_model trains, then the registry's
  sampler feeds bayesopt (best_query None); an unknown loader raises
  NotImplementedError, as in the JAX package (here before training);
  with_task_context appends the one-hot task columns."""
  x, y = _init_obs()
  calls = []
  real = tbo.bayesopt
  monkeypatch.setattr(tbo, 'bayesopt', lambda **kw: calls.append(
      kw['input_sampler'].__name__) or real(**kw))
  params = tdefs.GPParams(model=convert.model_from_jax(MODEL), config={
      'method': 'adam', 'learning_rate': 1e-2, 'max_training_step': 3,
      'batch_size': 8, 'objective': 'nll'})
  (xo, yo), best, _ = tbo.run_bayesopt(
      {'train': (x, y)}, 'test', _toracle, tmean.constant,
      tkernel.squared_exponential, params, tacfun.ucb, 2,
      warp_func=TWARP, init_random_key=torch.Generator().manual_seed(0),
      init_model=True, data_loader_name='stratified', device='cpu')
  assert calls == ['stratified_1000'] and best is None
  assert xo.shape == (2, D) and yo.shape == (2, 1)
  assert bool(((xo >= 0) & (xo <= 1)).all())
  np.testing.assert_allclose(yo.numpy(), _toracle(xo).numpy(), rtol=1e-6)
  with pytest.raises(NotImplementedError, match='nope'):
    tbo.run_bayesopt({'train': (x, y)}, 'test', _toracle, tmean.constant,
                     tkernel.squared_exponential, params, tacfun.ucb, 1,
                     data_loader_name='nope', device='cpu')
  ctx = tbo.with_task_context(torch.from_numpy(x), 1, 3)
  np.testing.assert_array_equal(
      ctx.numpy(), jbo.with_task_context(x, task_id=1, num_tasks=3))


def test_continuous_runner_matches_jax(jax_ref, monkeypatch):
  """The on-device continuous loop on the JAX pools: with no refinement
  the same selections bitwise, with 15 steps the same points within
  1e-4; 'rand' and 'ts' on the JAX draws bitwise; two calls on equal
  generators equal; and the best observation beats the initial ones."""
  draws = jax_ref['loop_draws']
  x0, y0 = _init_obs()

  def port(steps, acq='ei', generator=None):
    return ton.continuous_bayesopt_ondevice(
        tmean.zero, tkernel.squared_exponential,
        convert.model_from_jax(LOOP_MODEL), {}, None, _toracle, D, ITERS,
        acquisition=acq, pool_size=POOL, refine_steps=steps,
        init_obs=(x0, y0), generator=generator, device='cpu')

  for key, steps, acq in ((0, 0, 'ei'), (15, 15, 'ei'), ('rand', 15, 'rand'),
                          ('ts', 15, 'ts')):
    monkeypatch.setattr(ton, '_draw_uniform', _replay(draws['pool']))
    monkeypatch.setattr(ton, '_draw_index', _replay(draws['index']))
    monkeypatch.setattr(ton, '_draw_normal', _replay(draws['normal']))
    xo, yo = port(steps, acq)
    jx, jy = jax_ref['loop_%s' % key]
    assert xo.shape == (3 + ITERS, D) and yo.shape == (3 + ITERS, 1)
    if steps == 15 and acq == 'ei':
      np.testing.assert_allclose(xo.numpy(), jx, atol=1e-4)
      assert not np.array_equal(xo.numpy(), jax_ref['loop_0'][0])
    else:
      np.testing.assert_array_equal(xo.numpy(), jx, err_msg=str(key))
      np.testing.assert_allclose(yo.numpy(), jy, rtol=1e-6,
                                 err_msg=str(key))
      pools = draws['pool']
      assert all((pool == x).all(axis=1).any()
                 for pool, x in zip(pools, xo.numpy()[3:]))
  monkeypatch.undo()
  a = port(15, generator=torch.Generator().manual_seed(4))
  b = port(15, generator=torch.Generator().manual_seed(4))
  assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
  assert float(a[1][3:].max()) > float(y0.max())
  assert bool(((a[0] >= 0) & (a[0] <= 1)).all())
