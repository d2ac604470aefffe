"""The on-device BO loops of the PyTorch port (bo/ondevice.py) and the
algebra they carry (ops/chol appends, ops/linalg.tri_inv_blocked) against
the JAX package on the CPU, on the same numpy inputs.

The JAX runners are compiled once in this file's module fixtures, which
share numpy results. Randomness is injected: the port's draws ('rand',
'ts', the host random_search and thompson_sampling) are replaced by the
JAX stream's own draws, never seeded alike.

Tolerances (float32 on both sides): the appends and the inverse within
rtol 1e-5 (atol 1e-6 for entries near zero); the selections equal and the
observations within atol 1e-6 (they are candidates, copied); the masked
posterior within rtol 1e-4 of GP.predict (two float32 evaluation orders
of a 12-point posterior); the retrained leaves within atol 1e-4, as
tests/test_torch_slice.py bounds trained leaves.
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
from hyperbo_tpu.models import packed as jpacked
from hyperbo_tpu.models import priors as jpriors
from hyperbo_tpu.ops import chol as jchol
from hyperbo_tpu.ops import linalg as jlinalg
from hyperbo_tpu_torch.bo import acfun as tacfun
from hyperbo_tpu_torch.bo import ondevice as ton
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC as TWARP
from hyperbo_tpu_torch.models import gp as tgp
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.models import packed as tpacked
from hyperbo_tpu_torch.models import priors as tpriors
from hyperbo_tpu_torch.ops import chol as tchol
from hyperbo_tpu_torch.ops import linalg as tlinalg
from torch_threads import one_torch_thread  # noqa: F401

D, CANDIDATES, ITERS, TRAIN_TASKS = 2, 48, 8, 3
GREEDY = ('ei', 'pi', 'pi2', 'pi3', 'ucb', 'ucb2', 'ucb4')
MODEL = {'constant': np.float32(0.1),
         'lengthscale': np.array([-1.2, -0.9], np.float32),
         'signal_variance': np.float32(0.2),
         'noise_variance': np.float32(-4.0)}


def _data(seed=0):
  """Candidates of y = sin(3 x @ w) and 3 initial observations near three
  of them, in [0, 1)^D, float32."""
  rng = np.random.default_rng(seed)
  w = rng.normal(size=(D, 1))
  cx = rng.uniform(size=(CANDIDATES, D))
  x0 = rng.uniform(size=(3, D))
  f = lambda x: np.sin(3 * x @ w).astype(np.float32)
  return (cx.astype(np.float32), f(cx)), (x0.astype(np.float32), f(x0))


def _corpus(seed=1, sizes=(11, 16, 9)):
  """Training tasks of the retrain corpus and one aligned sub-dataset of
  12 shared inputs x 3 draws."""
  rng = np.random.default_rng(seed)
  tasks = {}
  for i, n in enumerate(sizes):
    x = rng.uniform(size=(n, D)).astype(np.float32)
    tasks[f't{i}'] = (x, np.sin(3 * x @ rng.normal(size=(D, 1))).astype(
        np.float32))
  ax = rng.uniform(size=(12, D)).astype(np.float32)
  ay = np.sin(3 * ax @ rng.normal(size=(D, 3))).astype(np.float32)
  return tasks, (ax, ay)


def _jax_run(kind, acquisition, init_obs=None, key=None, **kwargs):
  """One call of a JAX entry point (traced inside _jax_results' jit)."""
  cands, _ = _data()
  fn = {'plain': jon.simulated_bayesopt_ondevice,
        'qbatch': jon.simulated_bayesopt_ondevice_qbatch,
        'retrain': jon.simulated_bayesopt_ondevice_retrain}[kind]
  return fn(jmean.constant, jkernel.squared_exponential,
            jax.tree.map(jnp.asarray, MODEL), kwargs.pop('config', {}),
            JWARP, jdefs.SubDataset(*map(jnp.asarray, cands)), ITERS,
            acquisition=acquisition, num_train_tasks=TRAIN_TASKS,
            init_obs=None if init_obs is None else tuple(
                map(jnp.asarray, init_obs)),
            key=key if key is not None else jax.random.PRNGKey(3), **kwargs)


def _port_run(kind, acquisition, init_obs=None, **kwargs):
  cands, _ = _data()
  fn = {'plain': ton.simulated_bayesopt_ondevice,
        'qbatch': ton.simulated_bayesopt_ondevice_qbatch,
        'retrain': ton.simulated_bayesopt_ondevice_retrain}[kind]
  return fn(tmean.constant, tkernel.squared_exponential,
            convert.model_from_jax(MODEL), kwargs.pop('config', {}), TWARP,
            tdefs.SubDataset(*cands), ITERS, acquisition=acquisition,
            num_train_tasks=TRAIN_TASKS, init_obs=init_obs, device='cpu',
            **kwargs)


def _stream(monkeypatch, index_draws=(), normal_draws=()):
  """Substitute the port's draws with the given JAX draws, in order."""
  idx, nrm = iter(index_draws), iter(normal_draws)
  monkeypatch.setattr(ton, '_draw_index',
                      lambda g, n, device: torch.tensor(int(next(idx))))
  monkeypatch.setattr(ton, '_draw_normal',
                      lambda g, shape, device: torch.from_numpy(
                          np.array(next(nrm), np.float32)))


def _jax_draws(key, iters, q, kind):
  """The JAX runners' draws, pick by pick: each of split(key, iters), or
  fold_in(k, j) of each for q > 1, drawn as 'rand' (randint) or 'ts'
  (normal) draws it."""
  keys = jax.random.split(key, iters)
  if q > 1:
    keys = jax.vmap(lambda k: jax.vmap(
        lambda j: jax.random.fold_in(k, j))(jnp.arange(q)))(keys)
    keys = keys.reshape((iters * q,) + keys.shape[2:])
  if kind == 'rand':
    return jax.vmap(lambda k: jax.random.randint(k, (), 0, CANDIDATES))(keys)
  return jax.vmap(lambda k: jax.random.normal(k, (CANDIDATES, 1)))(keys)


def _jax_host_scores(name):
  """The JAX host acquisition `name` on a GP of the initial observations,
  model.rng = PRNGKey(7)."""
  cands, init = _data()
  model = jgp.GP({'test': jdefs.SubDataset(*map(jnp.asarray, init))},
                 jmean.constant, jkernel.squared_exponential,
                 jdefs.GPParams(model=jax.tree.map(jnp.asarray, MODEL)),
                 JWARP)
  model.rng = jax.random.PRNGKey(7)
  return getattr(jacfun, name)(model=model, sub_dataset_key='test',
                               x_queries=jnp.asarray(cands[0]))


APPEND_ROWS, APPENDS = 16, 11


def _append_inputs():
  """An SPD 16 x 16 K, the factor of its leading 9 x 9 block, and a
  40 x 40 lower factor (float32)."""
  rng = np.random.default_rng(5)
  a = rng.normal(size=(APPEND_ROWS, APPEND_ROWS))
  k = (a @ a.T / APPEND_ROWS + np.eye(APPEND_ROWS)).astype(np.float32)
  a = rng.normal(size=(40, 40))
  return (k, np.linalg.cholesky(k[:9, :9]).astype(np.float32),
          np.linalg.cholesky(a @ a.T / 40 + np.eye(40)).astype(np.float32))


def _jax_appends():
  """The JAX appends on _append_inputs: chol_append of the 9 x 9 factor,
  APPENDS rank-1 appends of W and of L into identity buffers, and
  tri_inv_blocked at block 8."""
  k, l, l40 = map(jnp.asarray, _append_inputs())
  w = lbuf = jnp.eye(APPEND_ROWS)
  for i in range(APPENDS):
    w = jchol.winv_append_padded(w, jnp.array(i), k[:, i], k[i, i])
    lbuf = jchol.chol_append_padded(lbuf, jnp.array(i), k[:, i], k[i, i])
  return {('append', 'chol'): jchol.chol_append(l, k[:9, 9], k[9, 9]),
          ('append', 'winv'): w, ('append', 'chol_padded'): lbuf,
          ('append', 'tri_inv'): jlinalg.tri_inv_blocked(l40, 8)}


def _retrain_kwargs(ekl, jax_side):
  """The retrain runners' corpus and options: without, then with an
  aligned EKL term (weight 0.5) and the default priors."""
  tasks, (ax, ay) = _corpus()
  defs_, packed, priors = ((jdefs, jpacked, jpriors) if jax_side else
                           (tdefs, tpacked, tpriors))
  opts = {} if jax_side else {'device': 'cpu'}
  kwargs = dict(retrain_every=2, retrain_steps=3, learning_rate=0.05,
                pretrain_packed=packed.pack_dataset(
                    {k: defs_.SubDataset(*v) for k, v in tasks.items()},
                    **opts)[0])
  if ekl:
    kwargs.update(aligned_packed=packed.pack_aligned_dataset(
        {'a': defs_.SubDataset(ax, ay, 'aligned')}, **opts)[0],
                  ekl_weight=0.5, config={'priors': priors.DEFAULT_PRIORS})
  return kwargs


@pytest.fixture(scope='module')
def jax_ref():
  """Every JAX result this file compares with, as numpy, from ONE jitted
  program (the runners, the draws and the host acquisitions compiled
  together once): the plain runner for every greedy acquisition with and
  without init_obs and for 'rand' and 'ts'; q = 2 for 'ei' and 'ts'; the
  retrain runner without and with EKL; the draws; the host scores; the
  appends and the inverse."""
  _, init = _data()

  def everything():
    out = {}
    for acq in GREEDY:
      for with_init in (False, True):
        out['plain', acq, with_init] = _jax_run(
            'plain', acq, init if with_init else None)
    for acq in ('rand', 'ts'):
      out['plain', acq, True] = _jax_run('plain', acq, init)
    out['qbatch', 'ei'] = _jax_run('qbatch', 'ei', init, q=2)
    out['qbatch', 'ts'] = _jax_run('qbatch', 'ts', init, q=2,
                                   key=jax.random.PRNGKey(4))
    for ekl in (False, True):
      out['retrain', ekl] = _jax_run('retrain', 'ei', init,
                                     **_retrain_kwargs(ekl, True))
    out['draws', 'rand'] = _jax_draws(jax.random.PRNGKey(3), ITERS, 1,
                                      'rand')
    out['draws', 'ts'] = _jax_draws(jax.random.PRNGKey(3), ITERS, 1, 'ts')
    out['draws', 'ts2'] = _jax_draws(jax.random.PRNGKey(4), ITERS, 2, 'ts')
    _, sub = jax.random.split(jax.random.PRNGKey(7))
    out['draws', 'random_search'] = jax.random.uniform(sub, (CANDIDATES, 1))
    out['draws', 'thompson_sampling'] = jax.random.normal(sub,
                                                          (CANDIDATES, 1))
    for name in ('random_search', 'thompson_sampling'):
      out['host', name] = _jax_host_scores(name)
    out.update(_jax_appends())
    return out

  return jax.tree.map(np.asarray, jax.jit(everything)())


def test_appends_and_inverse_match_jax(jax_ref, monkeypatch):
  k, l, l40 = _append_inputs()
  got = tchol.chol_append(torch.from_numpy(l), torch.from_numpy(k[:9, 9]),
                          torch.tensor(k[9, 9])).numpy()
  np.testing.assert_allclose(got, jax_ref['append', 'chol'], rtol=1e-5,
                             atol=1e-6)

  # Eleven appends into 16-row buffers; a count given as a 0-d tensor
  # (no host read) appends as the Python int does.
  w, lbuf = torch.eye(APPEND_ROWS), torch.eye(APPEND_ROWS)
  for i in range(APPENDS):
    kv, kap = torch.from_numpy(k[:, i]), torch.tensor(k[i, i])
    count = torch.tensor(i) if i % 2 else i
    w = tchol.winv_append_padded(w, count, kv, kap)
    lbuf = tchol.chol_append_padded(lbuf, count, kv, kap)
  np.testing.assert_allclose(w.numpy(), jax_ref['append', 'winv'],
                             rtol=1e-5, atol=1e-6)
  np.testing.assert_allclose(lbuf.numpy(), jax_ref['append', 'chol_padded'],
                             rtol=1e-5, atol=1e-6)
  np.testing.assert_allclose((w.double() @ lbuf.double()).numpy(),
                             np.eye(APPEND_ROWS), atol=1e-5)

  # tri_inv_blocked above its block (two levels of the recursion).
  got = tlinalg.tri_inv_blocked(torch.from_numpy(l40), block=8).numpy()
  np.testing.assert_allclose(got, jax_ref['append', 'tri_inv'], rtol=1e-5,
                             atol=1e-6)
  monkeypatch.setenv('HYPERBO_TRIINV_DOUBLING', '1')
  with pytest.raises(NotImplementedError, match='ROADMAP'):
    tlinalg.tri_inv_blocked(torch.from_numpy(l40), block=8)


def test_plain_runner_matches_jax(jax_ref):
  """Seven closed-form acquisitions, with and without init_obs: the same
  selections and observations as the JAX runner."""
  _, init = _data()
  picks = set()
  for acq in GREEDY:
    for with_init in (False, True):
      jx, jy, jidx = jax_ref['plain', acq, with_init]
      tx, ty, tidx = _port_run('plain', acq, init if with_init else None)
      np.testing.assert_array_equal(tidx.numpy(), jidx, err_msg=acq)
      np.testing.assert_allclose(tx.numpy(), jx, atol=1e-6)
      np.testing.assert_allclose(ty.numpy(), jy, atol=1e-6)
      picks.add(tuple(jidx))
  assert len(picks) > 4


def test_rand_and_ts_match_jax_with_injected_draws(jax_ref, monkeypatch):
  """The plain runner's 'rand' and 'ts' on the JAX stream's draws, and the
  host random_search and thompson_sampling on them."""
  cands, init = _data()
  _stream(monkeypatch, index_draws=jax_ref['draws', 'rand'])
  _, _, tidx = _port_run('plain', 'rand', init)
  np.testing.assert_array_equal(tidx.numpy(), jax_ref['plain', 'rand',
                                                      True][2])
  _stream(monkeypatch, normal_draws=jax_ref['draws', 'ts'])
  tx, _, tidx = _port_run('plain', 'ts', init)
  jx, _, jidx = jax_ref['plain', 'ts', True]
  np.testing.assert_array_equal(tidx.numpy(), jidx)
  np.testing.assert_allclose(tx.numpy(), jx, atol=1e-6)

  # Host acquisitions: the scores of one draw from model.rng.
  tmodel = tgp.GP({'test': init}, tmean.constant,
                  tkernel.squared_exponential,
                  tdefs.GPParams(model=convert.model_from_jax(MODEL)), TWARP,
                  device='cpu')
  tmodel.rng = torch.Generator().manual_seed(0)
  for name, draw in (('random_search', '_uniform'),
                     ('thompson_sampling', '_normal')):
    monkeypatch.setattr(tacfun, draw,
                        lambda g, shape, d=jax_ref['draws', name]:
                        torch.from_numpy(d))
    got = getattr(tacfun, name)(model=tmodel, sub_dataset_key='test',
                                x_queries=cands[0])
    np.testing.assert_allclose(got.numpy(), jax_ref['host', name],
                               rtol=1e-5, atol=1e-6)
  assert tacfun.rand is tacfun.random_search
  assert tacfun.ts is tacfun.thompson_sampling


def test_masked_posterior_matches_gp_predict():
  """_masked_posterior from a 16-row W buffer holding 12 observations
  (_masked_refactor) against GP.predict with with_noise and unbiased on
  and off; appending the rest row by row gives the same W."""
  cands, _ = _data()
  tasks, _ = _corpus()
  obs = tasks['t1']
  x = torch.from_numpy(obs[0][:12])
  data = dict(tasks, test=(obs[0][:12], obs[1][:12]))
  model = tgp.GP(data, tmean.constant, tkernel.squared_exponential,
                 tdefs.GPParams(model=convert.model_from_jax(MODEL)), TWARP,
                 device='cpu')
  shim = tdefs.GPParams(model=model.params.model)
  x_buf = torch.zeros((16, D))
  y_buf = torch.zeros((16, 1))
  x_buf[:12], y_buf[:12] = x, torch.from_numpy(obs[1][:12])
  w = ton._masked_refactor(tmean.constant, tkernel.squared_exponential, {},
                           TWARP, model.params.model, x_buf, 12)
  nv = ton._noise(shim, TWARP)
  qx = torch.from_numpy(cands[0])
  for with_noise in (False, True):
    for unbiased in (False, True):
      mu, var = model.predict(qx, 'test', with_noise=with_noise,
                              unbiased=unbiased)
      got_mu, got_var = ton._masked_posterior(
          tmean.constant, tkernel.squared_exponential, shim, TWARP,
          nv if with_noise else 0.0,
          ton._unbiased_scale(len(tasks)) if unbiased else 1.0,
          x_buf, y_buf, w, 12, qx)
      np.testing.assert_allclose(got_mu.numpy(), mu.numpy(), rtol=1e-4,
                                 atol=1e-6)
      np.testing.assert_allclose(got_var.numpy(), var.numpy(), rtol=1e-4)
  grown = torch.eye(16)
  for i in range(12):
    grown = ton._append_factor(tkernel.squared_exponential, shim, TWARP, nv,
                               1e-6, x_buf, grown, i, x_buf[i:i + 1])
  np.testing.assert_allclose(grown.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


def test_qbatch_matches_jax_and_q1_is_plain(jax_ref, monkeypatch):
  """q = 2 against the JAX runner ('ei', and 'ts' on the JAX stream's
  fold_in draws); q = 1 equals the plain runner bitwise, draws included."""
  _, init = _data()
  jx, jy, jidx = jax_ref['qbatch', 'ei']
  tx, ty, tidx = _port_run('qbatch', 'ei', init, q=2)
  np.testing.assert_array_equal(tidx.numpy(), jidx)
  np.testing.assert_allclose(tx.numpy(), jx, atol=1e-6)
  np.testing.assert_allclose(ty.numpy(), jy, atol=1e-6)
  assert tidx.shape == (ITERS, 2) and tx.shape == (3 + 2 * ITERS, D)
  _stream(monkeypatch, normal_draws=jax_ref['draws', 'ts2'])
  _, _, tidx = _port_run('qbatch', 'ts', init, q=2)
  np.testing.assert_array_equal(tidx.numpy(), jax_ref['qbatch', 'ts'][2])

  monkeypatch.undo()
  for acq in ('ei', 'ts', 'rand'):
    outs = []
    for kind in ('plain', 'qbatch'):
      kwargs = {'q': 1} if kind == 'qbatch' else {}
      outs.append(_port_run(kind, acq, init,
                            generator=torch.Generator().manual_seed(9),
                            **kwargs))
    (px, py, pidx), (qx, qy, qidx) = outs
    assert torch.equal(px, qx) and torch.equal(py, qy), acq
    assert torch.equal(pidx, qidx[:, 0]), acq


def test_retrain_runner_matches_jax(jax_ref):
  """3 Adam steps every 2 iterations on a 3-task corpus and the test task:
  without, then with an aligned EKL term (weight 0.5) and the default
  priors. The same selections and final leaves as the JAX runner;
  retrain_steps = 0 equals the plain runner."""
  _, init = _data()
  for ekl in (False, True):
    jx, _, jidx, jmodel = jax_ref['retrain', ekl]
    tx, _, tidx, tmodel = _port_run('retrain', 'ei', init,
                                    **_retrain_kwargs(ekl, False))
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_allclose(tx.numpy(), jx, atol=1e-6)
    trained = convert.model_to_numpy(tmodel)
    assert not np.allclose(trained['lengthscale'], MODEL['lengthscale'])
    for key, want in jmodel.items():
      np.testing.assert_allclose(trained[key], want, atol=1e-4, err_msg=key)

  px, py, pidx = _port_run('plain', 'ei', init)
  rx, ry, ridx, _ = _port_run('retrain', 'ei', init,
                              **dict(_retrain_kwargs(True, False),
                                     retrain_steps=0))
  assert torch.equal(px, rx) and torch.equal(py, ry)
  assert torch.equal(pidx, ridx)


def test_dispatcher_matches_jax_and_refuses(monkeypatch):
  """run_bayesopt_ondevice sends a GP where the JAX package sends it, with
  the same iteration count, train-task count, initial observations and
  retrain corpus; the plain branch returns the runner's observations. An
  HGP of one sample (its point estimate) picks as the plain runner, and
  with q = 2 raises ValueError as the JAX package does; mesh= and
  HYPERBO_BO_SOLVER=chol raise."""
  cands, init = _data()
  tasks, _ = _corpus()
  calls = {'jax': [], 'port': []}

  def recorder(side, kind):
    def fn(*args, **kwargs):
      pp = kwargs.get('pretrain_packed')
      calls[side].append((
          kind, kwargs['iters'], kwargs['num_train_tasks'],
          np.asarray(kwargs['init_obs'][0]).tolist(), kwargs.get('q'),
          kwargs.get('retrain_steps'), kwargs.get('retrain_every'),
          None if pp is None else tuple(pp.x.shape)))
      x = np.zeros((1, D), np.float32)
      return (x, x[:, :1], None) + (
          (args[2],) if kind == 'retrain' else ())
    return fn

  for side, mod in (('jax', jon), ('port', ton)):
    for kind in ('', '_qbatch', '_retrain'):
      monkeypatch.setattr(mod, 'simulated_bayesopt_ondevice' + kind,
                          recorder(side, kind.strip('_') or 'plain'))
  for retrain, q in ((0, 1), (0, 2), (2, 1)):
    config = {'retrain': retrain}
    jm = jgp.GP(dict({k: jdefs.SubDataset(*v) for k, v in tasks.items()},
                     test=jdefs.SubDataset(*init)), jmean.constant,
                jkernel.squared_exponential,
                jdefs.GPParams(model=jax.tree.map(jnp.asarray, MODEL),
                               config=dict(config)), JWARP)
    tm = tgp.GP(dict(tasks, test=init), tmean.constant,
                tkernel.squared_exponential,
                tdefs.GPParams(model=convert.model_from_jax(MODEL),
                               config=dict(config)), TWARP, device='cpu')
    jon.run_bayesopt_ondevice(jm, 'test', jdefs.SubDataset(*cands), 4,
                              q=q, retrain_every=3)
    ton.run_bayesopt_ondevice(tm, 'test', tdefs.SubDataset(*cands), 4, q=q,
                              retrain_every=3)
  assert calls['port'] == calls['jax'] and len(calls['port']) == 3
  monkeypatch.undo()

  tm = tgp.GP(dict(tasks, test=init), tmean.constant,
              tkernel.squared_exponential,
              tdefs.GPParams(model=convert.model_from_jax(MODEL)), TWARP,
              device='cpu')
  (xo, yo), best, _ = ton.run_bayesopt_ondevice(
      tm, 'test', tdefs.SubDataset(*cands), ITERS)
  want = _port_run('plain', 'ei', init)
  assert torch.equal(xo, want[0]) and torch.equal(yo, want[1])
  assert float(best[1][0]) == float(cands[1].max())

  with pytest.raises(NotImplementedError, match='ROADMAP'):
    ton.run_bayesopt_ondevice(tm, 'test', tdefs.SubDataset(*cands), 2,
                              mesh=object())
  hgp = tgp.HGP(dict(tasks, test=init), tmean.constant,
                tkernel.squared_exponential,
                tdefs.GPParams(model=convert.model_from_jax(MODEL)), TWARP,
                device='cpu')
  (xo, yo), _, _ = ton.run_bayesopt_ondevice(
      hgp, 'test', tdefs.SubDataset(*cands), ITERS)
  assert torch.equal(xo, want[0]) and torch.equal(yo, want[1])
  with pytest.raises(ValueError, match='q-batch'):
    ton.run_bayesopt_ondevice(hgp, 'test', tdefs.SubDataset(*cands), 2,
                              q=2)
  monkeypatch.setenv('HYPERBO_BO_SOLVER', 'chol')
  with pytest.raises(NotImplementedError, match='ROADMAP'):
    ton.run_bayesopt_ondevice(tm, 'test', tdefs.SubDataset(*cands), 2)
