"""Model functions of the PyTorch port against the JAX package, on the same
numpy inputs: warps, distances, kernels, means, parameter conversion, the
packed multi-task NLL and its gradient, and the port's import and device
contracts.

Tolerances (float32 throughout): elementwise maps within rtol 1e-6;
distances, kernels and means within rtol 1e-5 / atol 1e-6, since the
matmuls sum in another order than XLA's; the packed NLL within rtol 1e-5
and its gradient within atol 1e-4 / rtol 1e-4, the bounds the JAX
package's own packed-route parity test (tests/test_batch_chol.py) uses.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.core import defs as jdefs
from hyperbo_tpu.core import warp as jwarp
from hyperbo_tpu.models import basis as jbasis
from hyperbo_tpu.models import kernel as jkernel
from hyperbo_tpu.models import mean as jmean
from hyperbo_tpu.models import packed as jpacked
from hyperbo_tpu.ops import gram as jgram
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core import warp as twarp
from hyperbo_tpu_torch.models import basis as tbasis
from hyperbo_tpu_torch.models import gp as tgp
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.models import packed as tpacked
from hyperbo_tpu_torch.ops import gram as tgram
from torch_threads import one_torch_thread  # noqa: F401

D, FEATURES = 3, (5, 4)


def _t(a):
  return torch.from_numpy(np.asarray(a, np.float32))


def _model(seed=0):
  """JAX-layout model with an MLP and a linear mean, made with numpy."""
  rng = np.random.default_rng(seed)
  widths = (D,) + FEATURES
  mlp = {f'Dense_{i}': {
      'kernel': rng.normal(size=(widths[i], widths[i + 1])).astype(
          np.float32) / np.sqrt(widths[i]),
      'bias': 0.1 * rng.normal(size=(widths[i + 1],)).astype(np.float32)}
         for i in range(len(FEATURES))}
  return {
      'constant': np.float32(0.3),
      'lengthscale': rng.uniform(-0.5, 0.5, size=(FEATURES[-1],)).astype(
          np.float32),
      'signal_variance': np.float32(0.2),
      'noise_variance': np.float32(-3.0),
      'dot_prod_sigma': np.float32(0.5),
      'dot_prod_bias': np.float32(0.1),
      'mlp_params': mlp,
      'linear_mean': {
          'kernel': rng.normal(size=(FEATURES[-1], 1)).astype(np.float32),
          'bias': np.array([0.2], np.float32)},
  }


def _params(model, raw_lengthscale_dim=None):
  """(JAX GPParams, port GPParams) over the same leaves."""
  model = dict(model)
  if raw_lengthscale_dim is not None:
    model['lengthscale'] = model['lengthscale'][:raw_lengthscale_dim]
  config = {'mlp_features': FEATURES}
  jp = jdefs.GPParams(model=jax.tree.map(jnp.asarray, model), config=config)
  tp = tdefs.GPParams(model=convert.model_from_jax(model),
                      config=dict(config))
  return jp, tp


def test_warps_match_jax():
  x = np.array([-30., -3., -0.5, 0., 0.7, 5., 19., 21., 40.], np.float32)
  for jf, tf in ((jwarp.softplus_warp, twarp.softplus_warp),
                 (jwarp.squareplus_warp, twarp.squareplus_warp),
                 (jwarp.DEFAULT_SOFTPLUS, twarp.DEFAULT_SOFTPLUS)):
    np.testing.assert_allclose(tf(_t(x)).numpy(), np.asarray(jf(x)),
                               rtol=1e-6)
  assert set(twarp.DEFAULT_WARP_FUNC) == set(jwarp.DEFAULT_WARP_FUNC)


def test_sqdist_matches_jax():
  rng = np.random.default_rng(1)
  x1 = rng.normal(size=(17, D)).astype(np.float32) + 3.0
  x2 = rng.normal(size=(9, D)).astype(np.float32)
  want_11, want_12 = jax.jit(lambda a, b: (jgram.sqdist(a),
                                           jgram.sqdist(a, b)))(x1, x2)
  got = tgram.sqdist(_t(x1))
  np.testing.assert_allclose(got.numpy(), np.asarray(want_11),
                             rtol=1e-5, atol=1e-5)
  assert (torch.diagonal(got) == 0).all()
  np.testing.assert_allclose(tgram.sqdist(_t(x1), _t(x2)).numpy(),
                             np.asarray(want_12), rtol=1e-5, atol=1e-5)
  # Leading batch dimensions: one call per task gives the same.
  batch = np.stack([x1, x1[::-1] * 0.5])
  np.testing.assert_allclose(
      tgram.sqdist(_t(batch))[1].numpy(),
      tgram.sqdist(_t(batch[1])).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('name', ['squared_exponential', 'matern32',
                                  'matern52', 'dot_product'])
@pytest.mark.parametrize('mlp', [False, True])
def test_kernels_match_jax(name, mlp):
  rng = np.random.default_rng(2)
  x1 = rng.uniform(size=(11, D)).astype(np.float32)
  x2 = rng.uniform(size=(6, D)).astype(np.float32)
  x1[3] = x1[4]   # a coincident pair: the safe-r floor path
  jp, tp = _params(_model(), None if mlp else D)
  suffix = '_mlp' if mlp else ''
  jk = getattr(jkernel, name + suffix)
  tk = getattr(tkernel, name + suffix)
  warp = jwarp.DEFAULT_WARP_FUNC
  cases = (((x1,), {}), ((x1, x2), {}), ((x1,), {'diag': True}))
  # The three JAX calls in one jitted program.
  wants = jax.jit(lambda: [jk(jp, *map(jnp.asarray, args), warp_func=warp,
                              **kwargs) for args, kwargs in cases])()
  for (args, kwargs), want in zip(cases, wants):
    want = np.asarray(want)
    got = tk(tp, *map(_t, args), warp_func=twarp.DEFAULT_WARP_FUNC,
             **kwargs).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('name', ['zero', 'constant', 'linear', 'linear_mlp'])
def test_means_match_jax(name):
  x = np.random.default_rng(3).uniform(size=(8, D)).astype(np.float32)
  model = _model()
  if name == 'linear':
    model['linear_mean'] = {'kernel': model['linear_mean']['kernel'][:D],
                            'bias': model['linear_mean']['bias']}
  jp, tp = _params(model)
  want = np.asarray(jax.jit(lambda v: getattr(jmean, name)(jp, v))(x))
  got = getattr(tmean, name)(tp, _t(x)).numpy()
  assert got.shape == want.shape == (8, 1)
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_model_conversion_round_trip():
  model = _model()
  back = convert.model_to_numpy(convert.model_from_jax(model))
  flat_a, tree_a = jax.tree.flatten(model)
  flat_b, tree_b = jax.tree.flatten(back)
  assert tree_a == tree_b
  for a, b in zip(flat_a, flat_b):
    np.testing.assert_array_equal(np.asarray(a, np.float32), b)
  # The MLP layout is Flax's: a JAX-initialized MLP applies identically.
  x = np.random.default_rng(4).uniform(size=(5, D)).astype(np.float32)

  def init_and_apply(key, v):
    params = jdefs.GPParams(config={'mlp_features': FEATURES})
    jbasis.init_mlp_with_shape(key, params, (0, D))
    mlp = params.model['mlp_params']
    return mlp, jbasis.MLP(FEATURES).apply({'params': mlp}, v)

  mlp, want = jax.jit(init_and_apply)(jax.random.PRNGKey(0), x)
  got = tbasis.mlp_apply(convert.model_from_jax(mlp), _t(x))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-6)


def test_dense_init_has_flax_distribution():
  """lecun_normal: truncated at 2 std, variance exactly 1 / fan_in."""
  w = tbasis.dense_init(torch.Generator().manual_seed(0), 400, 300)
  k = w['kernel']
  assert k.shape == (400, 300) and (w['bias'] == 0).all()
  assert abs(float(k.std()) * np.sqrt(400) - 1.0) < 0.02
  assert float(k.abs().max()) <= 2.0 / np.sqrt(400) / 0.87962566 + 1e-6


def _ragged_pack(seed=4, tasks=3, n=40, d=2):
  rng = np.random.default_rng(seed)
  data = {}
  for i in range(tasks):
    x = rng.uniform(size=(n - 3 * i, d)).astype(np.float32)
    y = (np.sin(x.sum(-1, keepdims=True)) +
         0.1 * rng.normal(size=(n - 3 * i, 1))).astype(np.float32)
    data[i] = (x, y)
  jpack, _ = jpacked.pack_dataset(
      {k: jdefs.SubDataset(*v) for k, v in data.items()}, pad_to_multiple=8)
  tpack, _ = tpacked.pack_dataset(
      {k: tdefs.SubDataset(_t(v[0]), _t(v[1])) for k, v in data.items()},
      pad_to_multiple=8, device='cpu')
  model = {'constant': np.float32(0.2),
           'lengthscale': np.zeros(d, np.float32),
           'signal_variance': np.float32(0.1),
           'noise_variance': np.float32(-3.0)}
  return jpack, tpack, model


@pytest.mark.parametrize('batched', [True, False])
def test_packed_nll_and_grad_match_jax(batched):
  jpack, tpack, model = _ragged_pack()
  assert tpack.x.shape == jpack.x.shape == (3, 40, 2)

  def jnll(model):
    shim = jdefs.GPParams(model=model, config={
        'batched_chol': 'xla' if batched else False})
    return jpacked.neg_log_marginal_likelihood_packed(
        jmean.constant, jkernel.squared_exponential, shim, jpack,
        warp_func=jwarp.DEFAULT_WARP_FUNC)

  v_j, g_j = jax.jit(jax.value_and_grad(jnll))(
      jax.tree.map(jnp.asarray, model))
  tmodel = {k: v.requires_grad_(True)
            for k, v in convert.model_from_jax(model).items()}
  shim = tdefs.GPParams(model=tmodel, config={'batched_chol': batched})
  assert tpacked._batched_chol_route(shim, tpack) is batched
  v_t = tpacked.neg_log_marginal_likelihood_packed(
      tmean.constant, tkernel.squared_exponential, shim, tpack,
      warp_func=twarp.DEFAULT_WARP_FUNC)
  g_t = torch.autograd.grad(v_t, list(tmodel.values()))
  np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=1e-5)
  for key, g in zip(tmodel, g_t):
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j[key]), atol=1e-4,
                               rtol=1e-4)


def test_subsample_packed_draws_valid_rows():
  _, tpack, _ = _ragged_pack(tasks=3, n=40)
  gen = torch.Generator().manual_seed(0)
  batch = tpacked.subsample_packed(gen, tpack, 16)
  assert batch.x.shape == (3, 16, 2) and batch.y.shape == (3, 16, 1)
  assert (batch.count == 16).all() and batch.mask.all()
  for t in range(3):
    rows = tpack.x[t, :int(tpack.count[t])]
    for row in batch.x[t]:
      assert (rows == row).all(dim=1).any()
    assert torch.unique(batch.x[t], dim=0).shape[0] == 16
  # A width at or above n_max passes the pack through.
  assert tpacked.subsample_packed(gen, tpack, 40) is tpack
  # Unknown route flags raise instead of silently choosing a path.
  with pytest.raises(ValueError):
    tpacked._batched_chol_route(
        tdefs.GPParams(config={'batched_chol': 'xla'}), tpack)


def test_cuda_device_without_cuda_raises(monkeypatch):
  """The entry points run on the card unless the caller asks for the CPU:
  without CUDA, the default device and an explicit 'cuda' both raise."""
  from hyperbo_tpu_torch.bo import acfun as tacfun
  from hyperbo_tpu_torch.bo import bayesopt as tbo
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  x = np.zeros((4, 2), np.float32)
  data = {0: (x, x[:, :1])}
  for kwargs in ({}, {'device': 'cuda'}):
    with pytest.raises(RuntimeError, match='CUDA is not available'):
      tgp.GP(data, tmean.zero, tkernel.squared_exponential,
             tdefs.GPParams(), **kwargs)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
      tbo.run_bayesopt(data, 'test', tdefs.SubDataset(x, x[:, :1]),
                       tmean.zero, tkernel.squared_exponential,
                       tdefs.GPParams(), tacfun.ei, 1, **kwargs)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
      tgp.infer_parameters(
          tmean.zero, tkernel.squared_exponential,
          tdefs.GPParams(config={'method': 'adam', 'max_training_step': 1}),
          {0: tdefs.SubDataset(torch.zeros(4, 2), torch.zeros(4, 1))},
          **kwargs)
    # The array entry points: candidates or packed fields given as numpy.
    from hyperbo_tpu_torch.bo import ondevice
    from hyperbo_tpu_torch.train import adam
    for fn in (ondevice.simulated_bayesopt_ondevice,
               ondevice.simulated_bayesopt_ondevice_qbatch,
               ondevice.simulated_bayesopt_ondevice_retrain):
      with pytest.raises(RuntimeError, match='CUDA is not available'):
        fn(tmean.zero, tkernel.squared_exponential, {}, {}, None,
           tdefs.SubDataset(x, x[:, :1]), 1, **kwargs)
    packed = tpacked.PackedDataset(
        x[None], x[None, :, :1], np.ones((1, 4), bool),
        np.array([4], np.int32), np.ones((1,), bool))
    with pytest.raises(RuntimeError, match='CUDA is not available'):
      adam.make_fit_adam_packed(
          tmean.zero, tkernel.squared_exponential,
          {'learning_rate': 0.1, 'max_training_step': 1}, **kwargs)(
              {}, packed)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
      adam.fit_adam_packed(
          tmean.zero, tkernel.squared_exponential, {}, packed,
          {'learning_rate': 0.1, 'max_training_step': 1}, **kwargs)


PORT_MODULES = [
    'core.defs', 'core.warp', 'core.convert', 'ops.gram', 'ops.chol',
    'ops.chol_hbm', 'ops.chol_panel', 'ops.linalg', 'ops.batch_chol',
    'ops._build', 'models.basis', 'models.kernel', 'models.mean',
    'models.packed', 'models.objectives', 'models.priors',
    'models.divergences', 'models.gp', 'train.adam', 'bo.acfun',
    'bo.bayesopt', 'bo.const', 'bo.ondevice', 'core.params_io',
    'train.optimizers', 'train.slice_sampler', 'bo.input_samplers',
    'ops.iterative']


def test_port_imports_without_jax():
  code = ('import sys\n'
          'for name in ("jax", "flax", "optax", "ml_collections", "orbax",\n'
          '             "hyperbo_tpu"):\n'
          '  sys.modules[name] = None\n'
          'import importlib\n'
          f'for m in {PORT_MODULES!r}:\n'
          '  importlib.import_module("hyperbo_tpu_torch." + m)\n'
          'import torch\n'
          'assert not torch.backends.cuda.matmul.allow_tf32\n'
          'assert not torch.backends.cudnn.allow_tf32\n'
          'print("ok")\n')
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                        text=True, timeout=120, cwd=repo)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip() == 'ok'


def test_adam_matches_optax_and_freezes_on_nan():
  """The hand-written update equals optax.adam step for step; a non-finite
  loss keeps the last finite parameters for every remaining step."""
  import optax
  from hyperbo_tpu_torch.train import adam as tadam

  target = np.array([1.0, -2.0, 0.5], np.float32)
  w0 = np.array([0.3, 0.1, -0.4], np.float32)
  opt = optax.adam(0.1)
  w, state = jnp.asarray(w0), opt.init(jnp.asarray(w0))
  jtrace = []
  for _ in range(5):
    g = jax.grad(lambda w: jnp.sum((w - target) ** 4))(w)
    upd, state = opt.update(g, state)
    w = optax.apply_updates(w, upd)
    jtrace.append(np.asarray(w))

  def loss_fn(model, step):
    loss = torch.sum((model['w'] - _t(target)) ** 4)
    return loss * (float('nan') if step['nan_from'] <= step['i'] else 1.0)

  for nan_from in (100, 3):
    state = tadam.AdamState({'w': _t(w0)})
    for i in range(5):
      tadam._guarded_update(0.1, loss_fn, state,
                            {'i': i, 'nan_from': nan_from})
      kept = min(i, nan_from - 1)
      np.testing.assert_allclose(state.params[0].numpy(), jtrace[kept],
                                 rtol=1e-6, atol=1e-7)
    assert bool(state.frozen) == (nan_from < 5)


def test_nll_objective_matches_jax():
  """The per-sub-dataset Cholesky NLL (the objective GP.train routes)."""
  from hyperbo_tpu.models import objectives as jobj
  from hyperbo_tpu_torch.models import objectives as tobj

  model = {'constant': np.float32(0.2), 'lengthscale': np.zeros(2, np.float32),
           'signal_variance': np.float32(0.1),
           'noise_variance': np.float32(-3.0)}
  rng = np.random.default_rng(5)
  data = {}
  for i in range(3):
    x = rng.uniform(size=(20 + 5 * i, 2)).astype(np.float32)
    data[i] = (x, np.cos(x.sum(-1, keepdims=True)).astype(np.float32))
  jp = jdefs.GPParams(model=jax.tree.map(jnp.asarray, model), config={})
  tp = tdefs.GPParams(model=convert.model_from_jax(model), config={})
  want, want_k = jax.jit(lambda: jobj.neg_log_marginal_likelihood(
      jmean.constant, jkernel.matern52, jp,
      {k: jdefs.SubDataset(*v) for k, v in data.items()},
      warp_func=jwarp.DEFAULT_WARP_FUNC, return_key2nll=True))()
  got, got_k = tobj.neg_log_marginal_likelihood(
      tmean.constant, tkernel.matern52, tp,
      {k: tdefs.SubDataset(_t(v[0]), _t(v[1])) for k, v in data.items()},
      warp_func=twarp.DEFAULT_WARP_FUNC, return_key2nll=True)
  np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
  for k in want_k:
    np.testing.assert_allclose(float(got_k[k]), float(want_k[k]), rtol=1e-5)
  assert tobj.nll._packed_spec == jobj.nll._packed_spec == ('nll', None)


@pytest.mark.parametrize('name', ['expected_improvement_sub',
                                  'probability_of_improvement_sub',
                                  'ucb_sub'])
def test_acquisition_functions_match_jax(name):
  from hyperbo_tpu.bo import acfun as jacfun
  from hyperbo_tpu_torch.bo import acfun as tacfun

  rng = np.random.default_rng(6)
  mu = rng.normal(size=(50, 1)).astype(np.float32)
  std = rng.uniform(0.05, 2.0, size=(50, 1)).astype(np.float32)
  param = 3.0 if name == 'ucb_sub' else 0.7
  want = np.asarray(jax.jit(lambda m, s: getattr(jacfun, name)(
      m, s, param))(mu, std))
  got = getattr(tacfun, name)(_t(mu), _t(std), param).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sample_from_gp_has_the_gp_covariance():
  x = np.random.default_rng(7).uniform(size=(4, 2)).astype(np.float32)
  model = convert.model_from_jax({
      'constant': np.float32(1.5), 'lengthscale': np.zeros(2, np.float32),
      'signal_variance': np.float32(0.0), 'noise_variance': np.float32(-3.)})
  params = tdefs.GPParams(model=model)
  draws = tgp.sample_from_gp(
      torch.Generator().manual_seed(0), tmean.constant,
      tkernel.squared_exponential, params, _t(x),
      warp_func=twarp.DEFAULT_WARP_FUNC, num_samples=20000)
  assert draws.shape == (4, 20000)
  cov = tkernel.squared_exponential(params, _t(x),
                                    warp_func=twarp.DEFAULT_WARP_FUNC)
  cov = cov + torch.eye(4) * (twarp.DEFAULT_SOFTPLUS(model['noise_variance'])
                              + 1e-6)
  # 20000 draws: the sample moments are within ~3 standard errors.
  np.testing.assert_allclose(draws.mean(dim=1).numpy(), 1.5, atol=0.04)
  np.testing.assert_allclose(torch.cov(draws).numpy(), cov.numpy(),
                             atol=0.04)
