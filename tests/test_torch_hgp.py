"""The slice sampler and the HGP of the PyTorch port (train/slice_sampler,
models/gp.HGP, the HGP branches of bo/acfun, bo/bayesopt and bo/ondevice)
against the JAX package on the CPU, on the same numpy inputs.

Randomness is injected: the port's draws (the sweep's coordinate order,
the slice level, the bracket offset, the shrinkage uniforms, the chains'
start jitter, the HGP's sample index and normal draws) are replaced by the
draws of the JAX key schedule, replayed with jax.random, never seeded
alike. The JAX results that trace are computed in one jitted module
fixture and shared as numpy; the JAX samplers run eagerly there (they
read the device inside).

Tolerances (float32 on both sides): kept samples within atol 1e-4 (the
port evaluates the packed NLL, the JAX sampler the dict NLL; no decision
of the sampler parts at these inputs); the chain-batched corpus NLL
bitwise the per-chain one; posteriors and acquisitions within rtol 1e-4
(atol 1e-6), stats within rtol 1e-4; selections equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.bo import acfun as jacfun
from hyperbo_tpu.bo import ondevice as jon
from hyperbo_tpu.core import defs as jdefs
from hyperbo_tpu.core.warp import DEFAULT_WARP_FUNC as JWARP
from hyperbo_tpu.models import gp as jgp
from hyperbo_tpu.models import kernel as jkernel
from hyperbo_tpu.models import mean as jmean
from hyperbo_tpu.models import objectives as jobj
from hyperbo_tpu.models import packed as jpacked
from hyperbo_tpu.models import priors as jpriors
from hyperbo_tpu.train import slice_sampler as jslice
from hyperbo_tpu_torch.bo import acfun as tacfun
from hyperbo_tpu_torch.bo import bayesopt as tbayesopt
from hyperbo_tpu_torch.bo import ondevice as ton
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC as TWARP
from hyperbo_tpu_torch.models import gp as tgp
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.models import packed as tpacked
from hyperbo_tpu_torch.models import priors as tpriors
from hyperbo_tpu_torch.train import slice_sampler as tslice
from torch_threads import one_torch_thread  # noqa: F401

D, TASKS, POINTS, CANDIDATES, ITERS = 2, 3, 8, 24, 5
MAX_SHRINK = 100
MODEL = {'constant': np.float32(0.1),
         'lengthscale': np.array([-0.5, 0.3], np.float32),
         'signal_variance': np.float32(0.2),
         'noise_variance': np.float32(-3.0)}
DIM = 5  # constant, lengthscale (2), noise_variance, signal_variance
# The device sampler: 2 chains, 1 burn-in sweep, 2 samples each.
CHAINS, BURNIN, NSAMPLES, JITTER = 2, 1, 2, 0.1
# The re-sampling runner: 2 chains, a sweep before each of 3 iterations.
RS_SAMPLES, RS_ITERS = 2, 3


def _data(seed=0):
  """TASKS training tasks of y = sin(3 x @ w), the candidates of a test
  task and 3 initial observations of it, float32 in [0, 1)^D."""
  rng = np.random.default_rng(seed)
  f = lambda x, w: np.sin(3 * x @ w).astype(np.float32)
  tasks = {}
  for i in range(TASKS):
    x = rng.uniform(size=(POINTS, D)).astype(np.float32)
    tasks[f't{i}'] = (x, f(x, rng.normal(size=(D, 1))))
  w = rng.normal(size=(D, 1))
  cx = rng.uniform(size=(CANDIDATES, D)).astype(np.float32)
  x0 = rng.uniform(size=(3, D)).astype(np.float32)
  return tasks, (cx, f(cx, w)), (x0, f(x0, w))


def _samples():
  """Three posterior samples around MODEL (numpy dicts)."""
  rng = np.random.default_rng(3)
  return [{k: (v + 0.2 * rng.normal(size=np.shape(v))).astype(np.float32)
           for k, v in MODEL.items()} for _ in range(3)]


def _chain_draws(key, sweeps):
  """The draws of one chain of the JAX samplers (_run_chain/_coord_update,
  and slice_sample/_slice_sample_coord, which split alike): per sweep the
  coordinate order, per coordinate log u, the offset u and the shrinkage
  uniforms."""
  def sweep(key, _):
    key, perm_key = jax.random.split(key)
    order = jax.random.permutation(perm_key, DIM)

    def coord(k, _):
      k, ck = jax.random.split(k)
      k1, k2, k3, _ = jax.random.split(ck, 4)

      def trip(kk, _):
        kk, kd = jax.random.split(kk)
        return kk, jax.random.uniform(kd)

      _, shrink = jax.lax.scan(trip, k3, None, length=MAX_SHRINK)
      return k, (jnp.log(jax.random.uniform(k1)), jax.random.uniform(k2),
                 shrink)

    key, (level, offset, shrink) = jax.lax.scan(coord, key, None,
                                                length=DIM)
    return key, (order, level, offset, shrink)

  return jax.lax.scan(sweep, key, None, length=sweeps)[1]


def _chains_draws(keys, sweeps):
  """_chain_draws of each key, chains on the leading axis."""
  return jax.vmap(lambda k: _chain_draws(k, sweeps))(keys)


def _inject(monkeypatch, events, jitter=None):
  """Substitute the port's slice-sampler draws with the JAX chains' draws.

  `events` lists the sampler runs in order, each (order, level, offset,
  shrink) with chains on the leading axis and sweeps next, as
  _chains_draws returns them; the port draws them call by call."""
  calls = {'order': [], 'level': [], 'offset': [], 'shrink': []}
  for order, level, offset, shrink in events:
    for s in range(order.shape[1]):
      calls['order'].append(order[:, s])
      for p in range(DIM):
        calls['level'].append(level[:, s, p])
        calls['offset'].append(offset[:, s, p])
        calls['shrink'].append(shrink[:, s, p])
  queues = {k: iter(v) for k, v in calls.items()}

  def take(kind, dtype=np.float32):
    return lambda *args: torch.from_numpy(
        np.array(next(queues[kind]), dtype))

  monkeypatch.setattr(tslice, '_draw_order', take('order', np.int64))
  monkeypatch.setattr(tslice, '_draw_level', take('level'))
  monkeypatch.setattr(tslice, '_draw_offset', take('offset'))
  monkeypatch.setattr(tslice, '_draw_shrink', take('shrink'))
  if jitter is not None:
    monkeypatch.setattr(tslice, '_draw_jitter',
                        lambda *args: torch.from_numpy(np.array(jitter)))
  return queues


def _jax_dataset():
  tasks, _, _ = _data()
  return {k: jdefs.SubDataset(*map(jnp.asarray, v)) for k, v in tasks.items()}


def _jax_loss(config):
  """The JAX package's slice-sampling objective (gp.py:325-331)."""
  dataset = _jax_dataset()

  def loss(model):
    return jobj.neg_log_marginal_likelihood(
        mean_func=jmean.constant, cov_func=jkernel.squared_exponential,
        params=jdefs.GPParams(model=model, config=config), dataset=dataset,
        warp_func=JWARP)

  return loss


def _jax_model(model=MODEL):
  return jax.tree.map(jnp.asarray, model)


def _jax_hgp(with_test):
  """A JAX HGP on the training tasks (and the test task's 3 observations)
  with _samples()."""
  tasks, _, init = _data()
  data = dict(_jax_dataset())
  if with_test:
    data['test'] = jdefs.SubDataset(*map(jnp.asarray, init))
  model = jgp.HGP(data, jmean.constant, jkernel.squared_exponential,
                  jdefs.GPParams(model=_jax_model(),
                                 samples=[_jax_model(s) for s in _samples()]),
                  JWARP)
  return model


def _port_hgp(with_test):
  tasks, _, init = _data()
  data = dict(tasks, test=init) if with_test else dict(tasks)
  return tgp.HGP(data, tmean.constant, tkernel.squared_exponential,
                 tdefs.GPParams(model=convert.model_from_jax(MODEL),
                                samples=[convert.model_from_jax(s)
                                         for s in _samples()]),
                 TWARP, device='cpu')


def _resample_kwargs(jax_side):
  """The re-sampling runners' corpus and options."""
  tasks, _, _ = _data()
  defs_, packed, priors = ((jdefs, jpacked, jpriors) if jax_side else
                           (tdefs, tpacked, tpriors))
  opts = {} if jax_side else {'device': 'cpu'}
  return dict(
      num_samples=RS_SAMPLES, num_train_tasks=TASKS, resample_every=1,
      sweeps=1, init_jitter=JITTER,
      pretrain_packed=packed.pack_dataset(
          {k: defs_.SubDataset(*v) for k, v in tasks.items()}, **opts)[0],
      config={'priors': priors.DEFAULT_PRIORS})


def _run_side(jax_side, fn_name, model, acquisition, **kwargs):
  _, cands, init = _data()
  mod, mean, kernel, warp = ((jon, jmean, jkernel, JWARP) if jax_side else
                             (ton, tmean, tkernel, TWARP))
  config = kwargs.pop('config', {})
  if jax_side:
    cands, init = tuple(map(jnp.asarray, cands)), tuple(map(jnp.asarray,
                                                            init))
    extra = {'key': kwargs.pop('key', jax.random.PRNGKey(5))}
  else:
    extra = {'device': 'cpu'}
  return getattr(mod, fn_name)(
      mean.constant, kernel.squared_exponential, model, config, warp,
      (jdefs if jax_side else tdefs).SubDataset(*cands), ITERS if
      fn_name.endswith('hgp') else RS_ITERS, acquisition=acquisition,
      init_obs=init, **kwargs, **extra)


@pytest.fixture(scope='module')
def jax_ref():
  """Every JAX result this file compares with, as numpy: the samplers
  (eager), and from ONE jitted program the HGP's stats, predictions and
  predict_stacked, the runners, the draws and the acquisitions."""
  config = {'priors': jpriors.DEFAULT_PRIORS}
  out = {}
  key = jax.random.PRNGKey(11)
  out['sampler', 'ondevice'] = jslice.slice_sample_ondevice(
      _jax_loss(config), _jax_model(), key, burnin=BURNIN,
      nsamples=NSAMPLES, num_chains=CHAINS, init_jitter=JITTER)
  out['sampler', 'host'] = jslice.slice_sample(
      _jax_loss(config), _jax_model(), key, burnin=BURNIN,
      nsamples=NSAMPLES)
  _, cands, init = _data()
  qx = jnp.asarray(cands[0])

  def everything():
    res = {}
    stats = _jax_hgp(True).stats(verbose=False)
    res['stats'] = jnp.stack(stats[:4])
    res['key2nll'] = dict(stats[4])
    res['predict'] = _jax_hgp(True).predict(qx, 'test', full_cov=False)
    ckeys = jax.random.split(key, CHAINS + 1)
    res['draws', 'ondevice'] = _chains_draws(ckeys[1:], BURNIN + NSAMPLES)
    res['draws', 'jitter'] = jax.vmap(
        lambda k: jax.random.normal(k, (DIM,)))(
            jax.random.split(ckeys[0], CHAINS))
    res['draws', 'host'] = _chains_draws(key[None], BURNIN + 2 * NSAMPLES)
    for with_test in (False, True):
      res['stacked', with_test] = _jax_hgp(with_test).predict_stacked(
          qx, 'test', with_noise=True)
    model = _jax_hgp(True)
    model.rng = jax.random.PRNGKey(7)
    res['ei'] = jacfun.ei(model=model, sub_dataset_key='test', x_queries=qx)
    res['ts'] = jacfun.ts(model=model, sub_dataset_key='test', x_queries=qx)
    _, sub = jax.random.split(jax.random.PRNGKey(7))
    s_key, d_key = jax.random.split(sub)
    res['draws', 'ts_host'] = (jax.random.randint(s_key, (), 0, 3),
                               jax.random.normal(d_key, (CANDIDATES, 1)))

    samples = [_jax_model(s) for s in _samples()]
    for acq in ('ei', 'ucb', 'ts'):
      res['hgp', acq] = _run_side(True, 'simulated_bayesopt_ondevice_hgp',
                                  samples, acq, num_train_tasks=TASKS)
    ks = jax.random.split(jax.random.PRNGKey(5), ITERS)
    sd = jax.vmap(jax.random.split)(ks)
    res['draws', 'hgp_ts'] = (
        jax.vmap(lambda k: jax.random.randint(k, (), 0, 3))(sd[:, 0]),
        jax.vmap(lambda k: jax.random.normal(k, (CANDIDATES, 1)))(sd[:, 1]))
    x, y, _ = res['hgp', 'ei']
    stacked = jax.tree.map(lambda *ls: jnp.stack(ls), *samples)
    res['hgp_posterior'] = jgp._stacked_predict_fn(
        jmean.constant, jkernel.squared_exponential,
        jgp._hashable_warp(JWARP), True, True, {})(
            stacked, x, y, qx, jnp.float32(ton._unbiased_scale(TASKS)))

    res['resample'] = _run_side(
        True, 'simulated_bayesopt_ondevice_hgp_resample', _jax_model(),
        'ei', **_resample_kwargs(True))
    ik, rk = jax.random.split(jax.random.PRNGKey(5))
    res['draws', 'rs_jitter'] = jax.vmap(
        lambda k: jax.random.normal(k, (DIM,)))(
            jax.random.split(ik, RS_SAMPLES))
    rks = jax.vmap(lambda k: jax.random.split(k)[0])(
        jax.random.split(rk, RS_ITERS))
    res['draws', 'resample'] = [
        _chains_draws(jax.random.split(rks[i], RS_SAMPLES), 1)
        for i in range(RS_ITERS)]
    keys.extend(res)
    return [res[k] for k in keys]

  keys = []
  out.update(zip(keys, jax.jit(everything)()))
  return {k: jax.tree.map(np.asarray, v) for k, v in out.items()}


def _assert_samples(got, want, atol=1e-4):
  assert len(got) == len(want)
  for g, w in zip(got, want):
    g = convert.model_to_numpy(g)
    for k in w:
      np.testing.assert_allclose(g[k], w[k], atol=atol, err_msg=k)


def test_samplers_match_jax(jax_ref, monkeypatch):
  """GP.train(method='slice_sample') on the device sampler (2 chains, the
  packed NLL batched over chains and edges) and on the host sampler, each
  on the JAX key schedule's draws, keep the JAX samplers' samples; the
  serial stepping-out probe raises."""
  tasks, _, _ = _data()
  models = {}
  for sampler in ('ondevice', 'host'):
    if sampler == 'ondevice':
      _inject(monkeypatch, [jax_ref['draws', 'ondevice']],
              jitter=jax_ref['draws', 'jitter'])
    else:
      _inject(monkeypatch, [jax_ref['draws', 'host']])
    config = {'method': 'slice_sample', 'burnin': BURNIN,
              'nsamples': NSAMPLES, 'num_chains': CHAINS,
              'chain_init_jitter': JITTER, 'slice_sampler': sampler,
              'max_training_step': 0, 'objective': 'nll',
              'priors': tpriors.DEFAULT_PRIORS}
    model = tgp.HGP(tasks, tmean.constant, tkernel.squared_exponential,
                    tdefs.GPParams(model=convert.model_from_jax(MODEL),
                                   config=config), TWARP, device='cpu')
    model.initialize_params(torch.Generator().manual_seed(0))
    models[sampler] = model
    params = model.train()
    want = jax_ref['sampler', sampler]
    _assert_samples(params.samples, want)
    assert len(params.samples) == 2 * NSAMPLES
    _assert_samples([params.model], want[-1:])
    moved = np.abs(convert.model_to_numpy(params.samples[-1])['lengthscale']
                   - MODEL['lengthscale'])
    assert moved.max() > 1e-3
  monkeypatch.setenv('HYPERBO_SLICE_STEPOUT', 'serial')
  with pytest.raises(NotImplementedError, match='ROADMAP'):
    models['ondevice'].train()


def test_chain_batched_corpus_nll_is_bitwise_per_chain():
  """The corpus log prob of 4 models in one batched call (K1's route on
  the packed corpus, one batched Cholesky on the test task) equals the
  same call on each model alone, bitwise in float32, and _corpus_loss of
  each within 1 ulp-scale rounding (its test task is a matrix product where
  the batch's is a batched one); the batched packed NLL equals the
  unbatched one bitwise, with and without priors."""
  tasks, _, init = _data()
  pp = tpacked.pack_dataset({k: tdefs.SubDataset(*v)
                             for k, v in tasks.items()}, device='cpu')[0]
  rows = torch.from_numpy(np.stack([
      tslice.ravel_model(s)[0].numpy() for s in _samples()] +
      [tslice.ravel_model(MODEL)[0].numpy()]))
  _, unravel = tslice.ravel_model(MODEL)
  x_buf, y_buf = torch.zeros((6, D)), torch.zeros((6, 1))
  x_buf[:3], y_buf[:3] = torch.from_numpy(init[0]), torch.from_numpy(init[1])
  args = (tmean.constant, tkernel.squared_exponential)
  for config in ({}, {'priors': tpriors.DEFAULT_PRIORS}):
    for count in (0, 3):
      got = ton._corpus_loss_batched(*args, config, TWARP, 6, unravel(rows),
                                     x_buf, y_buf, count, pretrain_packed=pp)
      one = torch.cat([ton._corpus_loss_batched(
          *args, config, TWARP, 6, unravel(rows[r:r + 1]), x_buf, y_buf,
          count, pretrain_packed=pp) for r in range(len(rows))])
      assert torch.equal(got, one), (config, count, got - one)
      want = torch.stack([ton._corpus_loss(
          *args, config, TWARP, 6, unravel(r), x_buf, y_buf, count,
          pretrain_packed=pp) for r in rows])
      np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    got = tpacked.neg_log_marginal_likelihood_packed_batched(
        *args, config, unravel(rows), pp, warp_func=TWARP)
    want = torch.stack([tpacked.neg_log_marginal_likelihood_packed(
        *args, tdefs.GPParams(model=unravel(r), config=config), pp,
        warp_func=TWARP) for r in rows])
    assert torch.equal(got, want)
  assert got.shape == (4,) and torch.isfinite(got).all()


def test_hgp_predict_and_stats_match_jax(jax_ref):
  """HGP.predict_stacked (with and without observations), HGP.predict
  (one pair a sample) and HGP.stats (the mean over samples) against the
  JAX HGP."""
  _, cands, _ = _data()
  for with_test in (False, True):
    mu, var = _port_hgp(with_test).predict_stacked(cands[0], 'test')
    want_mu, want_var = jax_ref['stacked', with_test]
    assert mu.shape == (3, CANDIDATES, 1)
    np.testing.assert_allclose(mu.numpy(), want_mu, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), want_var, rtol=1e-4, atol=1e-6)
  model = _port_hgp(True)
  pairs = model.predict(cands[0], 'test', full_cov=False)
  assert len(pairs) == 3
  for (mu, var), (want_mu, want_var) in zip(pairs, jax_ref['predict']):
    np.testing.assert_allclose(mu.numpy(), want_mu, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), want_var, rtol=1e-4, atol=1e-6)
  stats = _port_hgp(True).stats(verbose=False)
  np.testing.assert_allclose(stats[:4], jax_ref['stats'], rtol=1e-4,
                             atol=1e-6)
  assert sorted(stats[4]) == sorted(jax_ref['key2nll'])
  for k, want in jax_ref['key2nll'].items():
    np.testing.assert_allclose(stats[4][k], want, rtol=1e-4)


def test_hgp_acquisitions_match_jax(jax_ref, monkeypatch):
  """EI averaged over the samples, and HGP Thompson sampling on the JAX
  draws (the sample index, then the normals)."""
  _, cands, _ = _data()
  model = _port_hgp(True)
  model.rng = torch.Generator().manual_seed(0)
  got = tacfun.ei(model=model, sub_dataset_key='test', x_queries=cands[0])
  np.testing.assert_allclose(got.numpy(), jax_ref['ei'], rtol=1e-4,
                             atol=1e-6)
  s, normal = jax_ref['draws', 'ts_host']
  monkeypatch.setattr(tacfun, '_randint',
                      lambda g, n: torch.tensor(int(s)))
  monkeypatch.setattr(tacfun, '_normal',
                      lambda g, shape: torch.from_numpy(normal.copy()))
  got = tacfun.ts(model=model, sub_dataset_key='test', x_queries=cands[0])
  np.testing.assert_allclose(got.numpy(), jax_ref['ts'], rtol=1e-4,
                             atol=1e-6)


def test_fixed_sample_runner_matches_jax(jax_ref, monkeypatch):
  """simulated_bayesopt_ondevice_hgp for 'ei', 'ucb' and 'ts' (on the JAX
  draws): the JAX runner's selections; the S posteriors from the final W
  buffers within rtol 1e-4 of the JAX HGP's predict_stacked; the
  dispatcher sends an HGP to this runner."""
  _, cands, init = _data()
  samples = [convert.model_from_jax(s) for s in _samples()]
  for acq in ('ei', 'ucb', 'ts'):
    if acq == 'ts':
      idx, normal = jax_ref['draws', 'hgp_ts']
      idx_q, nrm_q = iter(idx), iter(normal)
      monkeypatch.setattr(ton, '_draw_index',
                          lambda g, n, d: torch.tensor(int(next(idx_q))))
      monkeypatch.setattr(ton, '_draw_normal',
                          lambda g, shape, d: torch.from_numpy(
                              np.array(next(nrm_q))))
    jx, jy, jidx = jax_ref['hgp', acq]
    tx, ty, tidx = _run_side(False, 'simulated_bayesopt_ondevice_hgp',
                             samples, acq, num_train_tasks=TASKS)
    np.testing.assert_array_equal(tidx.numpy(), jidx, err_msg=acq)
    np.testing.assert_allclose(tx.numpy(), jx, atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), jy, atol=1e-6)
  monkeypatch.undo()

  run = ton.make_bo_hgp_runner(tmean.constant, tkernel.squared_exponential,
                               {}, TWARP, 'ei', ITERS, 3, 3 + ITERS, 3,
                               TASKS)
  qx = torch.from_numpy(cands[0])
  stacked = convert.stack_models(samples)
  x_buf, y_buf, _, facs = run(stacked, torch.from_numpy(init[0]),
                              torch.from_numpy(init[1]), qx,
                              torch.from_numpy(cands[1]),
                              torch.Generator(), return_factor=True)
  scale = ton._unbiased_scale(TASKS)
  mu, var = torch.func.vmap(lambda m, f: ton._masked_posterior(
      tmean.constant, tkernel.squared_exponential,
      tdefs.GPParams(model=m), TWARP,
      ton._noise(tdefs.GPParams(model=m), TWARP), scale, x_buf, y_buf, f,
      3 + ITERS, qx))(stacked, facs)
  want_mu, want_var = jax_ref['hgp_posterior']
  np.testing.assert_allclose(mu.numpy(), want_mu, rtol=1e-4, atol=1e-6)
  np.testing.assert_allclose(var.numpy(), want_var, rtol=1e-4, atol=1e-6)

  # The dispatcher: the port's HGP on the test task's 3 observations picks
  # as the runner does (the JAX dispatcher sends it to the same runner).
  (dx, _), _, _ = ton.run_bayesopt_ondevice(_port_hgp(True), 'test',
                                            tdefs.SubDataset(*cands), ITERS)
  np.testing.assert_allclose(dx.numpy(), jax_ref['hgp', 'ei'][0], atol=1e-6)
  with pytest.raises(ValueError, match='q-batch'):
    ton.run_bayesopt_ondevice(_port_hgp(True), 'test',
                              tdefs.SubDataset(*cands), ITERS, q=2)


def test_resample_runner_matches_jax(jax_ref, monkeypatch):
  """simulated_bayesopt_ondevice_hgp_resample, 2 chains jittered from
  MODEL, a sweep on the corpus posterior (3 tasks, the test task, priors)
  before each of 3 iterations, on the JAX draws: its selections and final
  samples; sweeps = 0 with no jitter is the plain runner bitwise; the
  dispatcher sends an HGP with config['retrain'] > 0 here."""
  jx, _, jidx, jsamples = jax_ref['resample']
  _inject(monkeypatch, jax_ref['draws', 'resample'],
          jitter=jax_ref['draws', 'rs_jitter'])
  stats = {}
  tx, _, tidx, tsamples = _run_side(
      False, 'simulated_bayesopt_ondevice_hgp_resample',
      convert.model_from_jax(MODEL), 'ei', stats=stats,
      **_resample_kwargs(False))
  np.testing.assert_array_equal(tidx.numpy(), jidx)
  np.testing.assert_allclose(tx.numpy(), jx, atol=1e-6)
  _assert_samples(tsamples, jsamples)
  # Each re-sampling evaluates once at the start, then per coordinate once
  # for the stepping out and once a shrinkage trip, a flag read a chunk.
  assert stats['evaluations'] >= RS_ITERS * (1 + 2 * DIM)
  assert stats['readbacks'] >= RS_ITERS * DIM
  monkeypatch.undo()

  plain = ton.simulated_bayesopt_ondevice(
      tmean.constant, tkernel.squared_exponential,
      convert.model_from_jax(MODEL), {}, TWARP, tdefs.SubDataset(*_data()[1]),
      RS_ITERS, num_train_tasks=TASKS, init_obs=_data()[2], device='cpu')
  fixed = _run_side(False, 'simulated_bayesopt_ondevice_hgp_resample',
                    convert.model_from_jax(MODEL), 'ei',
                    **dict(_resample_kwargs(False), sweeps=0,
                           init_jitter=0.0))
  for a, b in zip(plain, fixed):
    assert torch.equal(a, b)

  calls = {'jax': [], 'port': []}

  def recorder(side):
    def fn(*args, **kwargs):
      calls[side].append((
          kwargs['sweeps'], kwargs['resample_every'], kwargs['iters'],
          kwargs['num_train_tasks'], len(kwargs['init_samples']),
          np.asarray(kwargs['init_obs'][0]).tolist(),
          tuple(kwargs['pretrain_packed'].x.shape)))
      x = np.zeros((1, D), np.float32)
      return x, x[:, :1], None, kwargs['init_samples']
    return fn

  monkeypatch.setattr(ton, 'simulated_bayesopt_ondevice_hgp_resample',
                      recorder('port'))
  monkeypatch.setattr(jon, 'simulated_bayesopt_ondevice_hgp_resample',
                      recorder('jax'))
  for side, model, defs_ in (('port', _port_hgp(True), tdefs),
                             ('jax', _jax_hgp(True), jdefs)):
    model.params.config['retrain'] = 2
    mod = ton if side == 'port' else jon
    mod.run_bayesopt_ondevice(model, 'test',
                              defs_.SubDataset(*_data()[1]), ITERS,
                              retrain_every=3)
  assert calls['port'] == calls['jax']
  assert calls['port'][0][:5] == (2, 3, ITERS, TASKS, 3)


def test_train_and_hyperbo_ss_end_to_end(monkeypatch):
  """GP.train(method='slice_sample') with a callback (the host sampler)
  and run_bayesopt(method='hyperbo_ss', init_model=True) on the device
  sampler run and give 2 * nsamples samples; an HGP's BO loop appends
  candidates through the averaged acquisition."""
  tasks, cands, _ = _data()
  seen = []
  model = tgp.GP(tasks, tmean.constant, tkernel.squared_exponential,
                 tdefs.GPParams(model=convert.model_from_jax(MODEL),
                                config={'method': 'slice_sample',
                                        'burnin': 1, 'nsamples': 1,
                                        'max_training_step': 0,
                                        'objective': 'nll'}),
                 TWARP, device='cpu')
  model.initialize_params(torch.Generator().manual_seed(0))
  params = model.train(callback=lambda step, model_params, loss:
                       seen.append(float(loss)))
  assert len(params.samples) == 2 and len(seen) == 3
  assert np.isfinite(seen).all()

  monkeypatch.setattr(tbayesopt, '_HGP_SAMPLING_CONFIG', dict(
      tbayesopt._HGP_SAMPLING_CONFIG, burnin=1, nsamples=2))
  (xo, yo), best, params = tbayesopt.run_bayesopt(
      tasks, 'test', tdefs.SubDataset(*cands), tmean.constant,
      tkernel.squared_exponential,
      tdefs.GPParams(model=convert.model_from_jax(MODEL),
                     config={'max_training_step': 0, 'retrain': 0}),
      tacfun.ei, 4, warp_func=TWARP,
      init_random_key=torch.Generator().manual_seed(0),
      method='hyperbo_ss', init_model=True, device='cpu')
  assert len(params.samples) == 4
  assert params.config['method'] == 'slice_sample'
  assert 'priors' in params.config
  assert xo.shape == (4, D) and torch.isfinite(yo).all()
  assert all(bool((torch.from_numpy(cands[0]) == r).all(dim=1).any())
             for r in xo)
  assert float(best[1][0]) == float(cands[1].max())
