"""The PyTorch port's checkpoints (core/params_io and GP.train's
get_params_path) and Kumaraswamy-warped kernels against the JAX package on
the CPU, on the same numpy inputs.

Tolerances: a checkpoint read by the other package gives GP.stats()
within rtol 1e-5 of the same package's stats of the model it was written
from (the leaves round-trip exactly); the two packages' stats of one
model within rtol 1e-4 (tests/test_torch_ekl.py's bound). The Kumar Grams
within rtol 1e-5 (atol 1e-6); the packed NLL's value within rtol 1e-5 and
its gradient within rtol 1e-4 (atol 1e-5); the fused route over the Kumar
embedding against the JAX package's dense route in value rtol 1e-4 and
gradient max rel 5e-3 per leaf, kumar_params included (bench.py's
parity bounds). Chunked and resumed runs equal one run bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.core import defs as jdefs
from hyperbo_tpu.core import params_io as jio
from hyperbo_tpu.core.warp import DEFAULT_WARP_FUNC as JWARP
from hyperbo_tpu.experiments import configs as jconfigs
from hyperbo_tpu.models import basis as jbasis
from hyperbo_tpu.models import gp as jgp
from hyperbo_tpu.models import kernel as jkernel
from hyperbo_tpu.models import mean as jmean
from hyperbo_tpu.models import objectives as jobj
from hyperbo_tpu.models import packed as jpacked
from hyperbo_tpu.ops import pallas_mll as jpallas_mll
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core import params_io as tio
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC as TWARP
from hyperbo_tpu_torch.models import basis as tbasis
from hyperbo_tpu_torch.models import gp as tgp
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.models import objectives as tobj
from hyperbo_tpu_torch.models import packed as tpacked
from hyperbo_tpu_torch.ops import fused_mll as tfused
from hyperbo_tpu_torch.train import adam as tadam
from torch_threads import one_torch_thread  # noqa: F401

D = 3
SIZES = (20, 30, 24)
KUMAR = ('squared_exponential', 'matern32', 'matern52', 'dot_product')


def _data(sizes=SIZES, seed=0):
  rng = np.random.default_rng(seed)
  data = {}
  for i, n in enumerate(sizes):
    x = rng.uniform(size=(n, D)).astype(np.float32)
    y = (np.sin(3 * x @ rng.normal(size=(D, 1))) +
         0.1 * rng.normal(size=(n, 1))).astype(np.float32)
    data[f't{i}'] = (x, y)
  return data


def _model():
  return {'constant': np.float32(0.1),
          'lengthscale': np.array([0.4, 0.6, 0.5], np.float32),
          'signal_variance': np.float32(0.2),
          'noise_variance': np.float32(-3.0),
          'dot_prod_sigma': np.float32(0.5),
          'dot_prod_bias': np.float32(0.3),
          'kumar_params': {'a': np.array([0.3, -0.5, 0.1], np.float32),
                           'b': np.array([-0.2, 0.4, 0.0], np.float32)}}


def _jdata(data):
  return {k: jdefs.SubDataset(jnp.asarray(x), jnp.asarray(y))
          for k, (x, y) in data.items()}


def _tdata(data):
  return {k: tdefs.SubDataset(torch.from_numpy(x), torch.from_numpy(y))
          for k, (x, y) in data.items()}


def _jgp(data, config, cov='squared_exponential_kumar'):
  return jgp.GP(_jdata(data), jmean.constant, getattr(jkernel, cov),
                jdefs.GPParams(model=jax.tree.map(jnp.asarray, _model()),
                               config=dict(config)), JWARP)


def _tgp(data, config, cov='squared_exponential_kumar', model=None):
  return tgp.GP(_tdata(data), tmean.constant, getattr(tkernel, cov),
                tdefs.GPParams(model=model or convert.model_from_jax(
                    _model()), config=dict(config)), TWARP, device='cpu')


def _gram_inputs():
  rng = np.random.default_rng(1)
  return (rng.uniform(size=(9, D)).astype(np.float32),
          rng.uniform(size=(5, D)).astype(np.float32))


GRAM_CASES = ((0,), (0, 1), (0, 'diag'))
PACKED_KERNELS = ('squared_exponential_kumar', 'matern52_kumar')
FUSED_KERNELS = ('squared_exponential_kumar', 'matern32_kumar')


def _jscalar(params, a, b, warp_func=None):
  ls = params.model['lengthscale'][0]
  return jnp.exp(-jnp.sum(jnp.abs(a - b)) / ls) + jnp.dot(a, b)


def _gram_call(kern, params, xs, case, warp_func):
  """kern on the inputs `case` names (x1, x1 and x2, or x1's diagonal)."""
  args = [xs[i] for i in case if i != 'diag']
  return kern(params, *args, warp_func=warp_func, diag='diag' in case)


@pytest.fixture(scope='module')
def jax_ref():
  """(the JAX program, its results at _model()): ONE jitted function of
  the model computing every JAX value this file compares with: the Kumar
  Grams and the lifted scalar kernel, the packed NLL's and the dense NLL's
  values and gradients (the latter on the fused tasks), and GP.stats()'s
  NLL on _data(). The checkpoint test calls it again on a loaded model."""
  xs = [jnp.asarray(x) for x in _gram_inputs()]
  jpack, _ = jpacked.pack_dataset(_jdata(_data()))
  big = _jdata(_data(sizes=(512, 520), seed=2))
  jm = _jgp(_data(), {'objective': 'nll', 'method': 'adam'})
  jcov = jkernel.covariance_matrix(_jscalar)

  def everything(model):
    out = {}
    jp = jdefs.GPParams(model=model)
    for name in KUMAR:
      for case in GRAM_CASES:
        out[f'gram {name} {case}'] = _gram_call(
            getattr(jkernel, name + '_kumar'), jp, xs, case, JWARP)
    for case in GRAM_CASES:
      out[f'cov {case}'] = _gram_call(jcov, jp, xs, case, JWARP)
    for name in PACKED_KERNELS:
      out[f'packed {name}'] = jax.value_and_grad(
          lambda m, name=name: jpacked.neg_log_marginal_likelihood_packed(
              jmean.constant, getattr(jkernel, name),
              jdefs.GPParams(model=m, config={'batched_chol': 'xla'}),
              jpack, warp_func=JWARP))(model)
    for name in FUSED_KERNELS:
      out[f'dense {name}'] = jax.value_and_grad(
          lambda m, name=name: jobj.neg_log_marginal_likelihood(
              jmean.constant, getattr(jkernel, name),
              jdefs.GPParams(model=m, config={}), big,
              warp_func=JWARP))(model)
    jm.params.model = model
    out['stats'] = jm.stats(verbose=False)[0]
    return out

  program = jax.jit(everything)
  return program, jax.tree.map(np.asarray, program(
      jax.tree.map(jnp.asarray, _model())))


def _assert_bitwise(got, want):
  """Two port models equal leaf for leaf, bitwise."""
  assert jax.tree.structure(got) == jax.tree.structure(want)
  for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
    assert torch.equal(a, b)


def test_checkpoints_load_across_packages(tmp_path, jax_ref):
  """A JAX-written pickle loads in the port and a port-written one in the
  JAX package's load_params; either way GP.stats() of the loaded model
  equals the writer's within rtol 1e-5, kumar_params carried leaf for
  leaf."""
  data = _data()
  config = {'objective': 'nll', 'method': 'adam'}
  jm = _jgp(data, config)
  jpath = str(tmp_path / 'jax' / 'ckpt.pkl')
  jio.save_params(jpath, jm.params, state=(7, jnp.float32(1.5)))
  loaded, (step, loss) = tio.load_params(jpath, include_state=True,
                                         device='cpu')
  assert step == 7 and float(loss) == 1.5
  assert loaded.config['objective'] == 'nll'
  assert sorted(loaded.model['kumar_params']) == ['a', 'b']
  for path, want in jax.tree_util.tree_leaves_with_path(jm.params.model):
    leaf = loaded.model
    for p in path:
      leaf = leaf[p.key]
    assert torch.is_tensor(leaf) and leaf.dtype == torch.float32
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))

  program, ref = jax_ref
  want_j = float(ref['stats'])
  tm = _tgp(data, config)
  want_t = float(tm.stats(verbose=False)[0])
  got_t = float(_tgp(data, config, model=loaded.model).stats(
      verbose=False)[0])
  np.testing.assert_allclose(got_t, want_t, rtol=1e-5)
  np.testing.assert_allclose(want_t, want_j, rtol=1e-4)

  tm.initialize_params(torch.Generator().manual_seed(0))
  tpath = str(tmp_path / 'port' / 'ckpt.pkl')
  tio.save_params(tpath, tm.params, state=(3, torch.tensor(2.5)))
  jloaded, (step, loss) = jio.load_params(tpath, include_state=True)
  assert step == 3 and float(loss) == 2.5
  assert isinstance(jloaded.model['kumar_params']['a'], np.ndarray)
  got_j = float(program(jax.tree.map(jnp.asarray, jloaded.model))['stats'])
  np.testing.assert_allclose(got_j, want_j, rtol=1e-5)
  assert isinstance(jloaded.config['objective'], str)


def test_filename_encoding_and_io_helpers_match_jax(tmp_path):
  """encode_model_filename gives the JAX package's paths for a pd1 and an
  hpob config (an ml_collections ConfigDict, read by attribute and `in`);
  to_list_or_float and register_filesystem behave as there; the Orbax
  pair raises naming ROADMAP."""
  pd1 = jconfigs.get_config('pd1')
  pd1.model_dir = str(tmp_path)
  pd1.test_dataset_index = 'wl'
  pd1.num_irrelevant = '3'
  hpob = jconfigs.get_config('hpob')
  hpob.model_dir = str(tmp_path)
  hpob.search_space_index = '5971'
  hpob.init_params.config['mlp_features'] = (4, 4)
  hpob.use_surrogate_train = True
  hpob.wild_card_train = True
  hpob.normalize_y = True
  stbo = jconfigs.get_config('pd1')
  stbo.model_dir = str(tmp_path)
  stbo.method = 'stbo'
  for config in (pd1, hpob, stbo):
    want, got = (io.encode_model_filename(config) for io in (jio, tio))
    for args in ((), (12,), ('x',)):
      assert got(*args) == want(*args)
    assert got(model_key_only=True) == want(model_key_only=True)
  assert 'wl-0-linear_mlp' in tio.encode_model_filename(pd1)()
  random = jconfigs.get_config('random')
  with pytest.raises(NotImplementedError, match='random'):
    tio.encode_model_filename(random)

  for x in (np.float32(1.5), np.arange(3), 'a', torch.arange(2.)):
    assert tio.to_list_or_float(x) == jio.to_list_or_float(
        x.numpy() if torch.is_tensor(x) else x)
  opened = []

  def opener(path, mode):
    opened.append((path, mode))
    return open(path[len('mem:'):], mode)

  tio.register_filesystem('mem:', opener)
  try:
    path = str(tmp_path / 'fs.pkl')
    tio.save_params('mem:' + path, {'model': {'c': np.float32(1.)}})
    assert opened == [('mem:' + path, 'wb')]
    assert os.path.exists(path)
  finally:
    tio._FILESYSTEMS.pop('mem:')
  for fn in (tio.save_params_orbax, tio.load_params_orbax):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
      fn(str(tmp_path), tdefs.GPParams())


def test_checkpoint_steps_chunks_and_resume(tmp_path):
  """GP.train with checkpoint_every 7 over 20 steps fires the hook at the
  JAX package's chunk ends, [7, 14, 20] (tests/test_train_checkpoint.py),
  with the loss of each, and saves (step, loss); the checkpointed run
  equals one run without chunks, and 10 steps, then 10 resumed from the
  returned optimizer state, equal 20 steps, bitwise."""
  data = _data()
  config = {'method': 'adam', 'learning_rate': 1e-2, 'max_training_step': 20,
            'batch_size': 100, 'objective': 'nll', 'checkpoint_every': 7}
  cov = 'squared_exponential'
  path = str(tmp_path / 'run' / 'ckpt.pkl')
  tm = _tgp(data, config, cov)
  tm.initialize_params(torch.Generator().manual_seed(0))
  tcalls = []
  tm.train(get_params_path=lambda x=0: path,
           callback=lambda s, m, l: tcalls.append((s, float(l))))
  assert [s for s, _ in tcalls] == [7, 14, 20]
  saved, (step, loss) = tio.load_params(path, include_state=True,
                                        device='cpu')
  assert step == 20 and float(loss) == tcalls[-1][1]
  trace = []
  each = _tgp(data, dict(config, checkpoint_every=1), cov)
  each.initialize_params(torch.Generator().manual_seed(0))
  each.train(callback=lambda s, m, l: trace.append(float(l)))
  assert [l for _, l in tcalls] == [trace[6], trace[13], trace[19]]
  _assert_bitwise(saved.model, tm.params.model)

  one = _tgp(data, dict(config, checkpoint_every=0), cov)
  one.initialize_params(torch.Generator().manual_seed(0))
  one.train()
  _assert_bitwise(one.params.model, tm.params.model)

  half = _tgp(data, dict(config, max_training_step=10, return_state=True),
              cov)
  half.initialize_params(torch.Generator().manual_seed(0))
  half.train()
  state = half.params.config['opt_state']
  assert state['count'] == 10
  half.params.config['return_state'] = False
  half.train()
  _assert_bitwise(half.params.model, tm.params.model)

  packed, _ = tpacked.pack_dataset(_tdata(data), device='cpu')
  loss_fn = tadam._packed_loss(tmean.constant, tkernel.squared_exponential,
                               config, TWARP)
  model0 = convert.model_from_jax(_model())
  m10, l10, st = tadam.fit_adam_scan(
      loss_fn, model0, packed, None,
      dict(config, max_training_step=10, return_state=True))
  m20, l20 = tadam.fit_adam_scan(loss_fn, m10, packed, None,
                                 dict(config, max_training_step=10,
                                      opt_state=st))
  full_model, full = tadam.fit_adam_scan(loss_fn, model0, packed, None,
                                         config)
  assert torch.equal(torch.cat([l10, l20]), full)
  _assert_bitwise(m20, full_model)


def test_kumar_kernels_match_jax(jax_ref):
  """The four *_kumar Grams (square, cross and diagonal) against the JAX
  package's at rtol 1e-5; kumar_params through core/convert; the warp's
  init; covariance_matrix lifting a user's scalar kernel."""
  _, ref = jax_ref
  xs = [torch.from_numpy(x) for x in _gram_inputs()]
  tp = tdefs.GPParams(model=convert.model_from_jax(_model()))
  for name in KUMAR:
    tk = getattr(tkernel, name + '_kumar')
    assert tk.__name__ == getattr(jkernel, name + '_kumar').__name__
    for case in GRAM_CASES:
      np.testing.assert_allclose(_gram_call(tk, tp, xs, case,
                                            TWARP).numpy(),
                                 ref[f'gram {name} {case}'], rtol=1e-5,
                                 atol=1e-6, err_msg=f'{name} {case}')
  warped = tbasis.kumar_warp_apply(tp.model['kumar_params'], xs[0])
  assert ((warped >= 0) & (warped <= 1)).all()
  # core/convert carries kumar_params leaf for leaf, both ways.
  back = convert.model_to_numpy(tp.model)
  assert jax.tree.structure(back) == jax.tree.structure(_model())
  for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_model())):
    np.testing.assert_array_equal(a, b)

  jinit = jdefs.GPParams(model={})
  jbasis.init_kumar_warp_with_shape(jax.random.PRNGKey(0), jinit, (5, D))
  tinit = tdefs.GPParams(model={})
  tbasis.init_kumar_warp_with_shape(None, tinit, (5, D))
  for k in ('a', 'b'):
    np.testing.assert_array_equal(tinit.model['kumar_params'][k].numpy(),
                                  np.asarray(jinit.model['kumar_params'][k]))

  def tscalar(params, a, b, warp_func=None):
    ls = params.model['lengthscale'][0]
    return torch.exp(-torch.sum(torch.abs(a - b)) / ls) + torch.dot(a, b)

  tcov = tkernel.covariance_matrix(tscalar)
  assert tcov.__name__ == 'tscalar'
  for case in GRAM_CASES:
    got = _gram_call(tcov, tp, xs, case, TWARP).numpy()
    assert got.shape == ref[f'cov {case}'].shape
    np.testing.assert_allclose(got, ref[f'cov {case}'], rtol=1e-5,
                               err_msg=str(case))


def _leaf_rel(got, want):
  """Max relative error of a gradient leaf, over the leaf's largest."""
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _torch_value_and_grad(fn, model):
  """fn's value and gradient at the model, the leaves in jax.tree order."""
  leaves = convert.model_from_jax(model)
  flat = jax.tree.leaves(leaves)
  for v in flat:
    v.requires_grad_(True)
  val = fn(leaves)
  grads = torch.autograd.grad(val, flat, allow_unused=True)
  return val.detach(), [np.zeros(v.shape, np.float32) if g is None
                        else g.numpy() for v, g in zip(flat, grads)]


def test_kumar_packed_nll_matches_jax(jax_ref):
  """The packed NLL (K1's route, its plain version on the CPU) with the
  SE-Kumar and Matern-5/2-Kumar kernels: value within rtol 1e-5 and
  gradient, kumar_params included, within rtol 1e-4 of the JAX
  package's."""
  _, ref = jax_ref
  tpack, _ = tpacked.pack_dataset(_tdata(_data()), device='cpu')
  for name in PACKED_KERNELS:
    want, wgrad = ref[f'packed {name}']
    got, grads = _torch_value_and_grad(
        lambda m, name=name: tpacked.neg_log_marginal_likelihood_packed(
            tmean.constant, getattr(tkernel, name),
            tdefs.GPParams(model=m, config={}), tpack, warp_func=TWARP),
        _model())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(wgrad)):
      np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)


def test_kumar_fused_route_matches_jax(jax_ref):
  """config['fused_mll'] over SE- and Matern-3/2-Kumar kernels on tasks of
  512 rows and 520 rows (the masked route): the port's fused route (the
  plain versions of K2-K4 on the CPU, the Kumar warp outside the autograd
  Function) against the JAX package's dense route, value rtol 1e-4 and
  gradient max rel 5e-3 per leaf, kumar_params included. The route serves
  a Kumar kernel only with kumar_params in the model, in both packages."""
  _, ref = jax_ref
  data = _data(sizes=(512, 520), seed=2)
  td = _tdata(data)
  for name in FUSED_KERNELS:
    want, wgrad = ref[f'dense {name}']
    calls = []
    real = tfused.fused_nll_core

    def counted(*args, **kwargs):
      calls.append(args[0].shape[0])
      return real(*args, **kwargs)

    tfused.fused_nll_core = counted
    try:
      got, grads = _torch_value_and_grad(
          lambda m, name=name: tobj.neg_log_marginal_likelihood(
              tmean.constant, getattr(tkernel, name),
              tdefs.GPParams(model=m, config={'fused_mll': True}), td,
              warp_func=TWARP), _model())
    finally:
      tfused.fused_nll_core = real
    assert calls == [512, 576], calls
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    for g, w in zip(grads, jax.tree.leaves(wgrad)):
      assert _leaf_rel(g, w) <= 5e-3, (name, _leaf_rel(g, w))

  x = td['t0'].x
  bare = tdefs.GPParams(model={'lengthscale': torch.ones(D)}, config={})
  kp = tdefs.GPParams(model=convert.model_from_jax(_model()), config={})
  jbare = jdefs.GPParams(model={'lengthscale': jnp.ones(D)}, config={})
  for cov in ('squared_exponential_kumar', 'matern52_kumar'):
    assert not tfused.se_nll_fused_applicable(getattr(tkernel, cov), x, bare)
    assert tfused.se_nll_fused_applicable(getattr(tkernel, cov), x, kp)
    assert not jpallas_mll.se_nll_fused_applicable(
        getattr(jkernel, cov), jnp.asarray(data['t0'][0]), jbare)
  assert not tfused.se_nll_fused_applicable(tkernel.dot_product_kumar, x, kp)


def test_sample_from_gp_factors():
  """sample_from_gp with 'cholesky', 'eigh' and 'svd': with the standard
  normal draws injected as the identity, the samples minus the mean are
  the factor F, and F F^T is the noisy covariance (rtol 1e-4); another
  method raises ValueError, as in the JAX package."""
  rng = np.random.default_rng(3)
  x = torch.from_numpy(rng.uniform(size=(12, D)).astype(np.float32))
  params = tdefs.GPParams(model=convert.model_from_jax(_model()))
  cov = tkernel.squared_exponential_kumar(params, x, warp_func=TWARP)
  cov = cov + torch.eye(12) * (TWARP['noise_variance'](
      params.model['noise_variance']) + 1e-6)
  mean = tmean.constant(params, x, warp_func=TWARP)
  real = tgp._draw_normal
  tgp._draw_normal = lambda g, shape, device: torch.eye(*shape)
  try:
    for method in ('cholesky', 'eigh', 'svd'):
      f = tgp.sample_from_gp(None, tmean.constant,
                             tkernel.squared_exponential_kumar, params, x,
                             warp_func=TWARP, num_samples=12,
                             method=method) - mean.reshape(-1, 1)
      np.testing.assert_allclose((f @ f.T).numpy(), cov.numpy(), rtol=1e-4,
                                 atol=1e-6, err_msg=method)
  finally:
    tgp._draw_normal = real
  draws = tgp.sample_from_gp(torch.Generator().manual_seed(0), tmean.constant,
                             tkernel.squared_exponential_kumar, params, x,
                             warp_func=TWARP, num_samples=3, method='svd')
  assert draws.shape == (12, 3) and torch.isfinite(draws).all()
  with pytest.raises(ValueError):
    tgp.sample_from_gp(None, tmean.constant, tkernel.squared_exponential,
                       params, x, warp_func=TWARP, method='qr')
  with pytest.raises(ValueError):  # raised while tracing
    jax.jit(lambda: jgp.sample_from_gp(
        jax.random.PRNGKey(0), jmean.constant, jkernel.squared_exponential,
        jdefs.GPParams(model=jax.tree.map(jnp.asarray, _model())),
        jnp.asarray(x.numpy()), warp_func=JWARP, method='qr'))()
