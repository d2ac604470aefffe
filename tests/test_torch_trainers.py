"""The PyTorch port's other trainers against the JAX package on the CPU,
on the same numpy inputs: L-BFGS and BFGS (train/optimizers), the
host-loop Adam (train/adam.fit_adam with
models/divergences.sub_sample_dataset_iterator) and multi-start Adam
(train/adam.fit_adam_packed_multistart), each also through GP.train.

Randomness is injected: the port's draws (the host loop's permutations,
the restarts' perturbation and batches) are replaced by the JAX stream's
own, computed here from the keys the JAX code splits.

Tolerances: loss traces and final objectives within rtol 1e-4 (float32
on both sides, summed in different orders); trained leaves within atol
1e-4 + rtol 1e-4. The quasi-Newton line searches branch on float comparisons; at
these inputs no L-BFGS or BFGS decision parts between the two packages
(the callbacks' counts and the kept pairs agree, and the leaves after 8
iterations lie within 3e-5 of the JAX package's; 3 more from the
returned state, along the NLL's flat direction in the signal variance,
take them to 1.9e-4 apart, held at atol 5e-4). Routes through GP.train
equal the direct call bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.core import defs as jdefs
from hyperbo_tpu.core.warp import DEFAULT_WARP_FUNC as JWARP
from hyperbo_tpu.models import gp as jgp
from hyperbo_tpu.models import kernel as jkernel
from hyperbo_tpu.models import mean as jmean
from hyperbo_tpu.models import objectives as jobj
from hyperbo_tpu.models import packed as jpacked
from hyperbo_tpu.train import optimizers as jopt
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC as TWARP
from hyperbo_tpu_torch.models import divergences as tdiv
from hyperbo_tpu_torch.models import gp as tgp
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.models import objectives as tobj
from hyperbo_tpu_torch.models import packed as tpacked
from hyperbo_tpu_torch.train import adam as tadam
from hyperbo_tpu_torch.train import optimizers as topt
from torch_threads import one_torch_thread  # noqa: F401

D = 2
SIZES = (20, 28, 24)
QN_STEPS = 8
ADAM_STEPS, BATCH = 6, 16
RESTARTS = 3


def _data(aligned=False):
  rng = np.random.default_rng(0)
  data = {}
  for i, n in enumerate(SIZES):
    x = rng.uniform(size=(n, D)).astype(np.float32)
    y = (np.sin(3 * x @ rng.normal(size=(D, 1))) +
         0.1 * rng.normal(size=(n, 1))).astype(np.float32)
    data[f't{i}'] = (x, y)
  if aligned:
    x = rng.uniform(size=(18, D)).astype(np.float32)
    y = (np.sin(3 * x @ rng.normal(size=(D, 5))) +
         0.1 * rng.normal(size=(18, 5))).astype(np.float32)
    data['al'] = (x, y, 'al')
  return data


def _model():
  return {'constant': np.float32(0.1),
          'lengthscale': np.full((D,), 0.3, np.float32),
          'signal_variance': np.float32(0.2),
          'noise_variance': np.float32(-3.0)}


def _jdata(data):
  return {k: jdefs.SubDataset(*[jnp.asarray(a) for a in v[:2]], *v[2:])
          for k, v in data.items()}


def _tdata(data):
  return {k: tdefs.SubDataset(*[torch.from_numpy(a) for a in v[:2]],
                              *v[2:]) for k, v in data.items()}


def _jnll(data):
  jd = _jdata(data)
  return lambda m: jobj.neg_log_marginal_likelihood(
      jmean.constant, jkernel.squared_exponential,
      jdefs.GPParams(model=m, config={}), jd, warp_func=JWARP)


def _tnll(data):
  td = _tdata(data)
  return lambda m: tobj.neg_log_marginal_likelihood(
      tmean.constant, tkernel.squared_exponential,
      tdefs.GPParams(model=m, config={}), td, warp_func=TWARP)


def _assert_leaves(tmodel, jmodel, atol):
  got = convert.model_to_numpy(tmodel)
  for path, want in jax.tree_util.tree_leaves_with_path(jmodel):
    leaf = got
    for p in path:
      leaf = leaf[p.key]
    np.testing.assert_allclose(leaf, np.asarray(want), rtol=1e-4,
                               atol=atol,
                               err_msg=jax.tree_util.keystr(path))


def _jmodel():
  return jax.tree.map(jnp.asarray, _model())


def _gp(config, data, generator_seed=0):
  g = tgp.GP(_tdata(data), tmean.constant, tkernel.squared_exponential,
             tdefs.GPParams(model=convert.model_from_jax(_model()),
                            config=dict(config)), TWARP, device='cpu')
  g.initialize_params(torch.Generator().manual_seed(generator_seed))
  return g


def test_lbfgs_matches_jax(tmp_path):
  """L-BFGS on the per-task NLL: the callback's losses, the final value
  and model, and a run resumed from the returned state; GP.train(method=
  'lbfgs') equals the direct call and saves its checkpoint."""
  data = _data()
  jl, tl = [], []
  jval, jparams, jstate = jopt.lbfgs(
      _jnll(data), _jmodel(), steps=QN_STEPS,
      callback=lambda step, model_params, loss: jl.append(float(loss)))
  tval, tparams, tstate = topt.lbfgs(
      _tnll(data), convert.model_from_jax(_model()), steps=QN_STEPS,
      callback=lambda step, model_params, loss: tl.append(float(loss)))
  assert len(tl) == len(jl) and len(tstate[0]) == len(jstate[0])
  np.testing.assert_allclose(tl, jl, rtol=1e-4)
  np.testing.assert_allclose(float(tval), float(jval), rtol=1e-4)
  _assert_leaves(tparams, jparams, 1e-4)
  for s, js in zip(tstate[0], jstate[0]):
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-4)

  jval2, jparams2, _ = jopt.lbfgs(_jnll(data), jparams, steps=3,
                                  state=jstate)
  tval2, tparams2, _ = topt.lbfgs(_tnll(data), tparams, steps=3,
                                  state=tstate)
  np.testing.assert_allclose(float(tval2), float(jval2), rtol=1e-4)
  _assert_leaves(tparams2, jparams2, 5e-4)

  # batch_size above every task: the one subsample draws nothing.
  g = _gp({'method': 'lbfgs', 'max_training_step': QN_STEPS,
           'batch_size': 100, 'objective': 'nll'}, data)
  path = str(tmp_path / 'lbfgs.pkl')
  g.train(get_params_path=lambda x=0: path)
  for k, v in tparams.items():
    assert torch.equal(g.params.model[k], v), k
  from hyperbo_tpu_torch.core import params_io
  loaded, (step, loss) = params_io.load_params(path, include_state=True,
                                               device='cpu')
  assert step == QN_STEPS and float(loss) == float(tval)


def test_bfgs_matches_jax():
  """BFGS (this package's, with jax.scipy's algorithm) against the JAX
  package's bfgs, which runs jax.scipy.optimize.minimize; GP.train(method=
  'bfgs') equals the direct call."""
  data = _data()
  jparams, jval = jax.jit(lambda m: jopt.bfgs(_jnll(data), m, 1e-6,
                                              QN_STEPS))(_jmodel())
  tparams, tval = topt.bfgs(_tnll(data), convert.model_from_jax(_model()),
                            1e-6, QN_STEPS)
  np.testing.assert_allclose(float(tval), float(jval), rtol=1e-4)
  _assert_leaves(tparams, jparams, 1e-4)
  assert float(tval) < float(_tnll(data)(convert.model_from_jax(_model())))

  g = _gp({'method': 'bfgs', 'max_training_step': QN_STEPS,
           'batch_size': 100, 'objective': 'nll', 'tol': 1e-6}, data)
  g.train()
  for k, v in tparams.items():
    assert torch.equal(g.params.model[k], v), k


def test_quasi_newton_contracts_match_jax():
  """tests/test_optimizers.py's contracts on the port (a non-descent
  direction returns the start; the max-steps fallback pairs the value
  with the alpha it was evaluated at; no curvature-violating pair in the
  warm-start state; a quadratic minimized), and the tree helpers against
  the JAX package's."""
  def vg(fn):
    def call(p):
      leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
      with torch.enable_grad():
        val = fn(leaves)
        grads = torch.autograd.grad(val, list(leaves.values()))
      return val.detach(), dict(zip(leaves, grads))
    return call

  sq = lambda p: torch.sum(p['x']**2)
  params = {'x': torch.tensor([1.0, -2.0])}
  val, grads = vg(sq)(params)
  new_val, alpha = topt.backtracking_linesearch(vg(sq), val, params, grads,
                                                grads, alpha=1.0)
  assert alpha == 0. and float(new_val) == float(val)

  params = {'x': torch.tensor([-1.0])}
  val, grads = vg(sq)(params)
  descent = {'x': -grads['x']}
  got = topt.backtracking_linesearch(vg(sq), val, params, grads, descent,
                                     alpha=1e-3, c2=1.0 - 1e-12,
                                     max_steps=4)
  jgot = jopt.backtracking_linesearch(
      jax.value_and_grad(lambda p: jnp.sum(p['x']**2)), jnp.float32(1.0),
      {'x': jnp.array([-1.0])}, {'x': jnp.array([-2.0])},
      {'x': jnp.array([2.0])}, alpha=1e-3, c2=1.0 - 1e-12, max_steps=4)
  assert got[1] == jgot[1]
  np.testing.assert_allclose(float(got[0]), float(jgot[0]), rtol=1e-6)
  np.testing.assert_allclose(float(got[0]),
                             float(sq({'x': params['x'] + got[1] *
                                       descent['x']})), rtol=1e-6)

  def fvg(v):
    v = v.detach().requires_grad_(True)
    with torch.enable_grad():
      f = torch.sum(v**2)
      g, = torch.autograd.grad(f, v)
    return f.detach(), g
  x = torch.tensor([-1.0])
  f0, g = fvg(x)
  f_new, g_new, alpha = topt._line_search(fvg, f0, x, g, -g, 1e-3,
                                          c2=1.0 - 1e-12, max_steps=4)
  np.testing.assert_allclose(float(f_new), float(torch.sum((x - alpha * g)
                                                           ** 2)), rtol=1e-6)
  np.testing.assert_allclose(g_new.numpy(), (2 * (x - alpha * g)).numpy(),
                             rtol=1e-6)

  _, out, state = topt.lbfgs(lambda p: -torch.sum(p['x']**2),
                             {'x': torch.tensor([1.0])}, steps=5)
  if state is not None:
    for s, y in zip(state[0], state[1]):
      assert float(torch.dot(y, s)) >= 1e-6
    _, out2, _ = topt.lbfgs(lambda p: -torch.sum(p['x']**2), out, steps=2,
                            state=state)
    assert torch.isfinite(out2['x']).all()
  target = torch.tensor([1.5, -0.5, 2.0])
  _, out, state = topt.lbfgs(lambda p: torch.sum((p['x'] - target)**2),
                             {'x': torch.zeros(3)}, steps=50)
  np.testing.assert_allclose(out['x'].numpy(), target.numpy(), atol=1e-3)

  rng = np.random.default_rng(3)
  hist = [{'a': rng.normal(size=(2,)).astype(np.float32),
           'b': rng.normal(size=()).astype(np.float32)} for _ in range(4)]
  s_hist, y_hist = hist[:2], [
      {k: v + 0.5 * hist[2 + i][k] for k, v in h.items()}
      for i, h in enumerate(hist[:2])]
  g = {'a': np.array([0.3, -0.7], np.float32), 'b': np.float32(1.1)}
  want = jopt.lbfgs_descent_dir_nocedal(
      jax.tree.map(jnp.asarray, g), [jax.tree.map(jnp.asarray, s)
                                     for s in s_hist],
      [jax.tree.map(jnp.asarray, y) for y in y_hist])
  got = topt.lbfgs_descent_dir_nocedal(
      convert.model_from_jax(g), [convert.model_from_jax(s) for s in s_hist],
      [convert.model_from_jax(y) for y in y_hist])
  for k in g:
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               rtol=1e-5, err_msg=k)


def _jax_permutations(key, data, steps):
  """sub_sample_dataset_iterator's permutations, in draw order: one split
  of the iterator's key per sub-dataset of BATCH rows or more a batch."""
  perms = []
  for _ in range(steps):
    for x, *_ in data.values():
      if x.shape[0] >= BATCH:
        key, sub = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sub, x.shape[0])))
  return perms


def test_host_loop_adam_matches_jax(monkeypatch):
  """GP.train() with nll_regeuc(1.) (no packed spec: the host loop) on
  three tasks and an aligned sub-dataset: the loss trace within rtol
  1e-4 and the trained leaves within atol 1e-4 of the JAX package's, the
  JAX iterator's permutations injected; pack_tasks False and multi-output
  NLL data route to the host loop in both packages; NaN at step 0
  raises."""
  data = _data(aligned=True)
  config = {'method': 'adam', 'learning_rate': 0.05,
            'max_training_step': ADAM_STEPS, 'batch_size': BATCH,
            'objective': 'nll_regeuc1'}
  # The objective passed resolved: initialize_params has nothing else to
  # do for this model (its eager dataset log costs seconds here).
  jm = jgp.GP(_jdata(data), jmean.constant, jkernel.squared_exponential,
              jdefs.GPParams(model=_jmodel(), config=dict(
                  config, objective=jobj.nll_regeuc1)), JWARP)
  jl = []
  jm.train(jax.random.PRNGKey(1), callback=lambda i, m, l: jl.append(
      float(l)))
  # GP.train and infer_parameters each split the key once.
  key = jax.random.split(jax.random.split(jax.random.PRNGKey(1))[1])[1]
  perms = iter(_jax_permutations(key, data, ADAM_STEPS))
  monkeypatch.setattr(tdiv, 'draw_permutation',
                      lambda g, n, device: torch.tensor(next(perms)))
  tm = _gp(config, data)
  tl, tsteps = [], []
  tm.train(callback=lambda i, m, l: (tl.append(float(l)), tsteps.append(i)))
  assert tsteps == list(range(ADAM_STEPS))
  np.testing.assert_allclose(tl, jl, rtol=1e-4)
  _assert_leaves(tm.params.model, jm.params.model, 1e-4)
  assert next(perms, None) is None  # the final loss reuses the last batch

  for cfg, dataset in (
      (dict(config, objective='nll', pack_tasks=False), data),
      (dict(config, objective='nll'),
       {'m': (data['t0'][0], np.tile(data['t0'][1], (1, 2)))})):
    assert tgp._build_packed_training(
        tobj.nll, _tdata(dataset), cfg, tmean.constant,
        tkernel.squared_exponential, TWARP, 'cpu') is None
    assert jgp._build_packed_training(
        jobj.nll, _jdata(dataset), cfg, jmean.constant,
        jkernel.squared_exponential, JWARP) is None

  with pytest.raises(ValueError, match='NaN'):
    tadam.fit_adam(lambda m, b: m['c'] * float('nan'),
                   {'c': torch.tensor(1.0)}, iter(lambda: None, 0), 0.1, 3)


def _jax_restart_draws(key, jpack, model):
  """fit_adam_packed_multistart's draws: each leaf's perturbation noise
  (leaves in jax.tree order, one key each) and each restart's subset of
  every task at every step (a key a restart, split once a step)."""
  key, pkey = jax.random.split(key)
  leaves, treedef = jax.tree.flatten(model)
  pkeys = jax.random.split(pkey, len(leaves))
  noise = jax.tree.unflatten(treedef, [
      jax.random.normal(k, (RESTARTS,) + jnp.shape(l))
      for l, k in zip(leaves, pkeys)])
  t, n_max = jpack.mask.shape
  subsets = []
  for k in jax.random.split(key, RESTARTS):
    rows = []
    for _ in range(ADAM_STEPS):
      k, sk = jax.random.split(k)
      scores = jax.vmap(lambda kk, m: jnp.where(
          m, jax.random.uniform(kk, (n_max,)), -jnp.inf))(
              jax.random.split(sk, t), jpack.mask)
      rows.append(jax.lax.top_k(scores, BATCH)[1])
    subsets.append(jnp.stack(rows))
  return noise, np.asarray(jnp.stack(subsets, axis=1))


def test_multistart_matches_jax(monkeypatch):
  """GP.train() with num_restarts = 3 on the plain NLL (multi-start
  Adam): the running best at each checkpoint and the final best loss
  within rtol 1e-4 of the JAX package's, the trained model within atol
  1e-4, with the JAX stream's perturbation and per-restart batches
  injected; the batched evaluation of the R restarts' own batches equals
  R single evaluations bitwise."""
  data = _data()
  config = {'method': 'adam', 'learning_rate': 0.05,
            'max_training_step': ADAM_STEPS, 'batch_size': BATCH,
            'objective': 'nll', 'num_restarts': RESTARTS,
            'checkpoint_every': 3, 'restart_perturb_scale': 0.5}
  jm = jgp.GP(_jdata(data), jmean.constant, jkernel.squared_exponential,
              jdefs.GPParams(model=_jmodel(), config=dict(
                  config, objective=jobj.nll)), JWARP)
  jcalls = []
  jm.train(jax.random.PRNGKey(1), callback=lambda s, m, l: jcalls.append(
      (s, float(l))))
  jpack, _ = jpacked.pack_dataset(_jdata(data))
  key = jax.random.split(jax.random.split(jax.random.PRNGKey(1))[1])[1]
  noise, subsets = _jax_restart_draws(key, jpack, _jmodel())
  steps = iter(subsets)
  monkeypatch.setattr(tadam, 'draw_restart_perturbation',
                      lambda g, m, r: convert.model_from_jax(noise))
  monkeypatch.setattr(tpacked, 'draw_restart_subsets',
                      lambda g, p, b, r: torch.from_numpy(next(steps)).long())
  tm = _gp(config, data)
  tcalls = []
  tm.train(callback=lambda s, m, l: tcalls.append((s, float(l))))
  assert [s for s, _ in tcalls] == [s for s, _ in jcalls] == [3, ADAM_STEPS]
  np.testing.assert_allclose([l for _, l in tcalls], [l for _, l in jcalls],
                             rtol=1e-4)
  _assert_leaves(tm.params.model, jm.params.model, 1e-4)

  # One batched evaluation of every restart on its own batch equals each
  # restart alone, bitwise (the CPU's plain K1).
  tpack, _ = tpacked.pack_dataset(_tdata(data), device='cpu')
  rng = np.random.default_rng(5)
  stacked = convert.stack_models([
      {k: v + 0.1 * rng.normal(size=np.shape(v)).astype(np.float32)
       for k, v in _model().items()} for _ in range(RESTARTS)])
  batch = tpacked.take_rows_stacked(tpack, torch.from_numpy(subsets[0]))
  got = tpacked.neg_log_marginal_likelihood_packed_batched(
      tmean.constant, tkernel.squared_exponential, {}, stacked, batch,
      warp_func=TWARP)
  for r in range(RESTARTS):
    one = tpacked.neg_log_marginal_likelihood_packed(
        tmean.constant, tkernel.squared_exponential,
        tdefs.GPParams(model=convert.model_at(stacked, r), config={}),
        tpacked.take_rows(tpack, torch.from_numpy(subsets[0][r])),
        warp_func=TWARP)
    assert torch.equal(got[r], one), r
