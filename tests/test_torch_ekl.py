"""The EKL half of the PyTorch port against the JAX package on the same
numpy inputs: the linear-algebra helpers and priors, the MVN divergences,
the EKL/EUC/SVD-NLL objectives and their combinators (value and gradient),
the packed aligned EKL (partial and full), GP.stats() and nll_regkl
training through the packed trainer.

Tolerances (float32 in both packages, sums in different orders): values of
the helpers, priors and the partial KL within rtol 1e-4 and gradients
within rtol 1e-3 / atol 1e-4 (the bound tests/test_linalg.py and
tests/test_mean_divergences.py set against the reference's own
evaluation); the full KL with the eps = 1e-6 ridge within 3e-3, and 5e-4
without it, as tests/test_packed_fullkl.py states for two evaluation orders
(whitening by 1/sqrt(eps) amplifies float32 rounding); loss traces within
rtol 1e-4 and trained leaves within atol 1e-4, as tests/test_torch_slice.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.core import defs as jdefs
from hyperbo_tpu.core.warp import DEFAULT_WARP_FUNC as JWARP
from hyperbo_tpu.models import divergences as jdiv
from hyperbo_tpu.models import gp as jgp
from hyperbo_tpu.models import kernel as jkernel
from hyperbo_tpu.models import mean as jmean
from hyperbo_tpu.models import objectives as jobj
from hyperbo_tpu.models import packed as jpacked
from hyperbo_tpu.models import priors as jpriors
from hyperbo_tpu.ops import linalg as jlinalg
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC as TWARP
from hyperbo_tpu_torch.models import divergences as tdiv
from hyperbo_tpu_torch.models import gp as tgp
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.models import objectives as tobj
from hyperbo_tpu_torch.models import packed as tpacked
from hyperbo_tpu_torch.models import priors as tpriors
from hyperbo_tpu_torch.ops import linalg as tlinalg
from hyperbo_tpu_torch.train import adam as tadam
from torch_threads import one_torch_thread  # noqa: F401

D = 2


def _t(a):
  return torch.tensor(np.asarray(a), dtype=torch.float32)


def _rand_mvn(seed, n, rank=None):
  rng = np.random.default_rng(seed)
  u = rng.normal(size=(n, rank or n))
  return (rng.normal(size=(n,)).astype(np.float32),
          (u @ u.T).astype(np.float32))


def _model():
  return {'constant': np.float32(0.8),
          'lengthscale': np.array([0.1, -0.2], np.float32),
          'signal_variance': np.float32(0.3),
          'noise_variance': np.float32(-3.)}


def _dataset(seed=0, aligned=((9, 4), (6, 3), (12, 5)), plain=(7, 11)):
  """Aligned tasks of unequal (n, m), so rank(sample cov) = m - 1 < n and
  the pack pads both axes, drawn from a GP; plus non-aligned tasks."""
  rng = np.random.default_rng(seed)
  data = {}
  for t, (n, m) in enumerate(aligned):
    x = rng.uniform(size=(n, D))
    k = np.exp(-0.5 * ((x[:, None] - x[None]) ** 2).sum(-1) / 0.16)
    chol = np.linalg.cholesky(k + 0.01 * np.eye(n))
    y = 1.0 + chol @ rng.normal(size=(n, m))
    data[f'a{t}'] = (x.astype(np.float32), y.astype(np.float32), t)
  for t, n in enumerate(plain):
    x = rng.uniform(size=(n, D))
    y = np.sin(3 * x.sum(-1, keepdims=True)) + 0.1 * rng.normal(size=(n, 1))
    data[f'p{t}'] = (x.astype(np.float32), y.astype(np.float32), None)
  return data


def _jdata(data):
  return {k: jdefs.SubDataset(jnp.asarray(x), jnp.asarray(y), a)
          for k, (x, y, a) in data.items()}


def _tdata(data):
  return {k: tdefs.SubDataset(_t(x), _t(y), a)
          for k, (x, y, a) in data.items()}


def _torch_value_and_grad(fn, model):
  leaves = {k: _t(v).requires_grad_(True) for k, v in model.items()}
  val = fn(leaves)
  grads = torch.autograd.grad(val, list(leaves.values()))
  return float(val.detach()), {k: g.numpy() for k, g in zip(leaves, grads)}


def _assert_value_and_grad(got, want, rtol=1e-4, grtol=1e-3, gatol=1e-4):
  np.testing.assert_allclose(got[0], want[0], rtol=rtol)
  for k in want[1]:
    np.testing.assert_allclose(got[1][k], want[1][k], rtol=grtol,
                               atol=gatol, err_msg=k)


def _linalg_inputs():
  _, spd = _rand_mvn(0, 6)
  spd = spd / 6 + 2 * np.eye(6, dtype=np.float32)
  rng = np.random.default_rng(1)
  return spd, [rng.normal(size=(6,)).astype(np.float32),
               rng.normal(size=(6, 3)).astype(np.float32)]


def _divergence_inputs():
  mu0, cov0 = _rand_mvn(3, 8)
  cov0 = cov0 + np.eye(8, dtype=np.float32)
  mu1, cov1 = _rand_mvn(4, 8)
  cov1 = cov1 / 8 + 2 * np.eye(8, dtype=np.float32)
  _, cov0_low = _rand_mvn(5, 8, rank=4)
  return mu0, cov0, mu1, cov1, cov0_low


PRIOR_VALUES = np.array([0.05, 0.7, 1.9], np.float32)
KUMAR_PRIOR = {'a': np.array([0.3, -1.0], np.float32),
               'b': np.array([2.5], np.float32)}
PACKED_EKL_CASES = ((True, 0.0), (True, 1e-6), (False, 0.0), (False, 1e-6))


def _objective_pairs():
  return (
      (jobj.kl, tobj.kl),
      (jobj.euc, tobj.euc),
      (functools.partial(jobj.nll, use_cholesky=False),
       functools.partial(tobj.nll, use_cholesky=False)),
      (jobj.nll_regkl(0.5), tobj.nll_regkl(0.5)),
      (jobj.nll_regeuc(2.), tobj.nll_regeuc(2.)))


def _value_and_grad_np(vg):
  val, grads = vg
  return float(val), {k: np.asarray(g) for k, g in grads.items()}


@pytest.fixture(scope='module')
def jax_ref():
  """Every JAX value of this file that traces, as numpy, from ONE jitted
  program: the linear-algebra helpers and priors, the partial KL and the
  Euclidean distance, every objective's value and gradient, the packed
  EKL variants and GP.stats(). The full KL of a sample covariance and the
  SVD square root without jit_safe take shapes from a rank and stay
  eager in their tests."""
  spd, rhss = _linalg_inputs()
  mu0, cov0, mu1, cov1, _ = _divergence_inputs()
  cov_low = _rand_mvn(2, 8, rank=3)[1]
  objective_data = _jdata(_dataset(1))
  jpack, _ = jpacked.pack_aligned_dataset(_jdata(_dataset(2, plain=())))
  stats_model = jgp.GP(
      _jdata(_dataset(3)), jmean.constant, jkernel.squared_exponential,
      jdefs.GPParams(model=jax.tree.map(jnp.asarray, _model()),
                     config={'objective': 'nll'}), JWARP)
  model = jax.tree.map(jnp.asarray, _model())

  def everything():
    out = {}
    for i, rhs in enumerate(rhss):
      out[f'inverse {i}'] = jax.value_and_grad(
          lambda m, v: jnp.sum(jlinalg.inverse_spdmatrix_vector_product(
              m, v) ** 2), argnums=(0, 1))(jnp.asarray(spd),
                                           jnp.asarray(rhs))
    out['svd sqrt'] = jlinalg.svd_matrix_sqrt(jnp.asarray(cov_low),
                                              jit_safe=True)
    for name in ('noise_variance', 'signal_variance', 'constant'):
      out[f'prior {name}'] = jpriors.DEFAULT_PRIORS[name](
          jnp.asarray(PRIOR_VALUES))
    out['kumar prior'] = jpriors.kumar_prior(
        jax.tree.map(jnp.asarray, KUMAR_PRIOR))
    for name, fn in (('partial', jdiv.partial_kl_mvn),
                     ('euclidean', jdiv.euclidean_multivariate_normal)):
      out[f'divergence {name}'] = jax.value_and_grad(
          lambda m, c, fn=fn: fn(jnp.asarray(mu0), jnp.asarray(cov0), m, c),
          argnums=(0, 1))(jnp.asarray(mu1), jnp.asarray(cov1))
    for i, (jfn, _) in enumerate(_objective_pairs()):
      out[f'objective {i}'] = jax.value_and_grad(
          lambda m, jfn=jfn: jfn(
              jmean.constant, jkernel.squared_exponential,
              jdefs.GPParams(model=m, config={
                  'priors': jpriors.DEFAULT_PRIORS}), objective_data,
              warp_func=JWARP))(model)
    for partial, eps in PACKED_EKL_CASES:
      out[f'packed {partial} {eps}'] = (
          jpacked.multivariate_normal_divergence_packed(
              jmean.constant, jkernel.squared_exponential,
              jdefs.GPParams(model=model), jpack, warp_func=JWARP,
              partial=partial, eps=eps))
    out['packed grad'] = jax.value_and_grad(
        lambda m: jpacked.multivariate_normal_divergence_packed(
            jmean.constant, jkernel.squared_exponential,
            jdefs.GPParams(model=m), jpack, warp_func=JWARP))(model)
    out['stats'] = stats_model.stats(verbose=False)
    return out

  return jax.tree.map(np.asarray, jax.jit(everything)())


def test_linalg_and_priors_match_jax(jax_ref):
  """The custom-VJP inverse product (vector and matrix right-hand sides),
  the SVD square root in both forms, the safe square root's clamped
  gradient, and the priors."""
  spd, rhss = _linalg_inputs()
  for i, rhs in enumerate(rhss):
    want = jax_ref[f'inverse {i}']
    m, v = _t(spd).requires_grad_(True), _t(rhs).requires_grad_(True)
    val = torch.sum(tlinalg.inverse_spdmatrix_vector_product(m, v) ** 2)
    got = torch.autograd.grad(val, (m, v))
    np.testing.assert_allclose(float(val.detach()), float(want[0]),
                               rtol=1e-4)
    for g, w in zip(got, want[1]):
      np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                 atol=1e-4)

  _, cov = _rand_mvn(2, 8, rank=3)
  for jit_safe in (False, True):
    a_t = tlinalg.svd_matrix_sqrt(_t(cov), jit_safe=jit_safe).numpy()
    a_j = (jax_ref['svd sqrt'] if jit_safe else np.asarray(
        jlinalg.svd_matrix_sqrt(jnp.asarray(cov), jit_safe=False)))
    assert a_t.shape == a_j.shape == ((8, 8) if jit_safe else (8, 3))
    np.testing.assert_allclose(a_t @ a_t.T, cov, atol=1e-4)
  x = torch.zeros((), requires_grad=True)
  assert torch.autograd.grad(tlinalg.safe_sqrt(x), x)[0] == 1e6
  x = torch.zeros(3, requires_grad=True)
  assert torch.isfinite(torch.autograd.grad(tlinalg.safe_l2norm(x),
                                            x)[0]).all()
  np.testing.assert_allclose(float(tlinalg.safe_l2norm(_t([3., 4.]))), 5.)

  for name in ('noise_variance', 'signal_variance', 'constant'):
    np.testing.assert_allclose(
        float(tpriors.DEFAULT_PRIORS[name](_t(PRIOR_VALUES))),
        float(jax_ref[f'prior {name}']), rtol=1e-5)
  np.testing.assert_allclose(
      float(tpriors.kumar_prior({k: _t(v) for k, v in KUMAR_PRIOR.items()})),
      float(jax_ref['kumar prior']), rtol=1e-5)
  assert float(tpriors.kumar_prior({'a': _t([9.0])})) == -np.inf


def test_divergences_match_jax(jax_ref):
  """Partial KL, full KL (full-rank and rank-deficient sample covariance,
  with and without eps) and the Euclidean distance: values, and gradients
  with respect to the model's mean and covariance."""
  mu0, cov0, mu1, cov1, cov0_low = _divergence_inputs()
  cases = [(jax_ref['divergence partial'], tdiv.partial_kl_mvn, cov0, {}),
           (jdiv.kl_multivariate_normal, tdiv.kl_multivariate_normal, cov0,
            dict(partial=False)),
           (jdiv.kl_multivariate_normal, tdiv.kl_multivariate_normal,
            cov0_low, dict(partial=False)),
           (jdiv.kl_multivariate_normal, tdiv.kl_multivariate_normal,
            cov0_low, dict(partial=False, eps=1e-3, weight=0.5)),
           (jax_ref['divergence euclidean'],
            tdiv.euclidean_multivariate_normal, cov0, {})]
  for jfn, tfn, c0, kw in cases:
    if callable(jfn):
      # The full KL: its SVD square root's rank sets a shape, so eager.
      want = jax.value_and_grad(
          lambda m, c: jfn(jnp.asarray(mu0), jnp.asarray(c0), m, c, **kw),
          argnums=(0, 1))(jnp.asarray(mu1), jnp.asarray(cov1))
    else:
      want = jfn
    m, c = _t(mu1).requires_grad_(True), _t(cov1).requires_grad_(True)
    val = tfn(_t(mu0), _t(c0), m, c, **kw)
    got = torch.autograd.grad(val, (m, c))
    np.testing.assert_allclose(float(val.detach()), float(want[0]),
                               rtol=1e-4, err_msg=f'{tfn.__name__} {kw}')
    for g, w in zip(got, want[1]):
      np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                 atol=1e-4, err_msg=f'{tfn.__name__} {kw}')
  same = tdiv.kl_multivariate_normal(_t(mu0), _t(cov0), _t(mu0), _t(cov0),
                                     partial=False)
  assert abs(float(same)) < 1e-4


def test_objectives_match_jax(jax_ref):
  """Value and gradient of every objective over a dataset of aligned and
  non-aligned sub-datasets, with the default hyperpriors on."""
  td = _tdata(_dataset(1))
  for i, (jfn, tfn) in enumerate(_objective_pairs()):
    assert (getattr(tfn, '_packed_spec', None) ==
            getattr(jfn, '_packed_spec', None))
    want = _value_and_grad_np(jax_ref[f'objective {i}'])
    got = _torch_value_and_grad(
        lambda m: tfn(tmean.constant, tkernel.squared_exponential,
                      tdefs.GPParams(model=m, config={
                          'priors': tpriors.DEFAULT_PRIORS}), td,
                      warp_func=TWARP), _model())
    _assert_value_and_grad(got, want)


def test_packed_ekl_matches_jax(jax_ref):
  """The packed aligned EKL, partial and full, with and without the eps
  ridge, against the JAX package's packed EKL and the port's own host
  loop; the partial EKL's gradient; injected and drawn subsamples."""
  data = _dataset(2, plain=())
  td = _tdata(data)
  tpack, keys = tpacked.pack_aligned_dataset(td, device='cpu')
  assert keys == list(data) and tpack.y.shape == (3, 16, 8)
  for partial, eps in PACKED_EKL_CASES:
    tol = 3e-3 if eps else 5e-4
    want = float(jax_ref[f'packed {partial} {eps}'])
    params = tdefs.GPParams(model={k: _t(v) for k, v in _model().items()})
    got = float(tpacked.multivariate_normal_divergence_packed(
        tmean.constant, tkernel.squared_exponential, params, tpack,
        warp_func=TWARP, partial=partial, eps=eps))
    host = float(tobj.multivariate_normal_divergence(
        tmean.constant, tkernel.squared_exponential, params, td,
        warp_func=TWARP, distance=functools.partial(
            tdiv.kl_multivariate_normal, eps=eps, partial=partial)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, host, rtol=tol, atol=tol)

  want = _value_and_grad_np(jax_ref['packed grad'])
  got = _torch_value_and_grad(
      lambda m: tpacked.multivariate_normal_divergence_packed(
          tmean.constant, tkernel.squared_exponential,
          tdefs.GPParams(model=m), tpack, warp_func=TWARP), _model())
  _assert_value_and_grad(got, want)

  # Injected rows: each task's chosen valid rows first, then padding.
  sel = torch.tensor([[8, 0, 3, 9], [5, 1, 2, 4], [11, 7, 0, 2]])
  sub = tpacked.take_aligned_rows(tpack, sel)
  np.testing.assert_array_equal(
      sub.y.numpy(), np.take_along_axis(tpack.y.numpy(),
                                        sel.numpy()[..., None], axis=1))
  assert sub.count_n.tolist() == [4, 4, 4] and bool(sub.n_mask.all())
  assert torch.equal(sub.m_mask, tpack.m_mask)
  gen = torch.Generator().manual_seed(0)
  drawn = tpacked.subsample_aligned_packed(gen, tpack, 8)
  assert drawn.x.shape == (3, 8, D) and drawn.count_n.tolist() == [8, 6, 8]
  assert (drawn.y[1, 6:] == 0).all()
  assert tpacked.subsample_aligned_packed(gen, tpack, 16) is tpack


def test_gp_stats_matches_jax(jax_ref):
  """GP.stats(): the SVD NLL per task, the full and partial packed EKL
  and the host EUC, against the JAX package's GP.stats()."""
  data = _dataset(3)
  tmodel = tgp.GP(_tdata(data), tmean.constant, tkernel.squared_exponential,
                  tdefs.GPParams(model=convert.model_from_jax(_model()),
                                 config={'objective': 'nll'}), TWARP,
                  device='cpu')
  want = jax_ref['stats']
  got = tmodel.stats(verbose=False)
  np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)
  np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=3e-3,
                             atol=3e-3)
  np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=3e-3,
                             atol=3e-3)
  np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-4)
  assert sorted(got[4]) == sorted(want[4]) == ['p0', 'p1']
  for k in want[4]:
    np.testing.assert_allclose(float(got[4][k]), float(want[4][k]),
                               rtol=1e-4)


def test_nll_regkl_training_matches_jax():
  """GP.train() with nll_regkl(1.) on the packed trainer: the NLL half on
  the non-aligned tasks, the EKL half on the aligned ones. batch_size
  exceeds every task, so no random subsample has to be matched."""
  data = _dataset(4)
  config = {'method': 'adam', 'learning_rate': 1e-2, 'max_training_step': 6,
            'batch_size': 100, 'objective': 'nll_regkl1'}
  jmodel = jgp.GP(_jdata(data), jmean.constant, jkernel.squared_exponential,
                  jdefs.GPParams(model=jax.tree.map(jnp.asarray, _model()),
                                 config=dict(config, batched_chol='xla')),
                  JWARP)
  jmodel.initialize_params(jax.random.PRNGKey(0))
  jmodel.train(jax.random.PRNGKey(1))
  runner = next(iter(jmodel._trainer_cache.values()))
  _, jdata, _, pure_nll = jgp._build_packed_training(
      jmodel.params.config['objective'], jmodel.dataset,
      jmodel.params.config, jmean.constant, jkernel.squared_exponential,
      JWARP)
  assert not pure_nll
  _, jlosses = runner(jax.tree.map(jnp.asarray, _model()), jdata,
                      jax.random.PRNGKey(2))

  tmodel = tgp.GP(_tdata(data), tmean.constant, tkernel.squared_exponential,
                  tdefs.GPParams(model=convert.model_from_jax(_model()),
                                 config=dict(config, checkpoint_every=1)),
                  TWARP, device='cpu')
  tmodel.initialize_params(torch.Generator().manual_seed(0))
  tlosses = []
  tmodel.train(callback=lambda s, m, l: tlosses.append(float(l)))
  np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-4)
  for k, v in jmodel.params.model.items():
    np.testing.assert_allclose(tmodel.params.model[k].numpy(),
                               np.asarray(v), atol=1e-4, err_msg=k)
  # The EKL half alone trains too, and an objective the packed trainer
  # does not serve is left to the host loop, as in the JAX package.
  loss_fn, tdata, subsample_fn, pure_nll = tgp._build_packed_training(
      tobj.kl, tmodel.dataset, dict(config), tmean.constant,
      tkernel.squared_exponential, TWARP, 'cpu')
  assert not pure_nll
  assert tdata[0] is None and tdata[1].x.shape == (3, 16, D)
  _, losses = tadam.fit_adam_scan(loss_fn, convert.model_from_jax(_model()),
                                  tdata, subsample_fn, dict(config))
  assert torch.isfinite(losses).all() and losses[-1] < losses[0]
  assert tgp._build_packed_training(
      tobj.euc, tmodel.dataset, dict(config), tmean.constant,
      tkernel.squared_exponential, TWARP, 'cpu') is None
  assert jgp._build_packed_training(
      jobj.euc, jmodel.dataset, dict(config), jmean.constant,
      jkernel.squared_exponential, JWARP) is None
