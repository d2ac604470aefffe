"""The PyTorch port's main path against the JAX package, at a small size:
multi-task pre-training with GP.train() (Adam on the packed NLL, kernel
K1's route), then simulated BO with EI through GP.predict and the
bucket-padded incremental Cholesky cache.

Both packages start from the same parameters (initialized in JAX,
converted with core/convert.model_from_jax) and the same numpy data.
batch_size exceeds every task's size, so no random subsample has to be
matched. The JAX side routes the packed NLL through its batched Cholesky
reference (config['batched_chol'] = 'xla'), the algorithm K1 computes.

Tolerances: loss traces within rtol 1e-4 and trained leaves within atol
1e-4. Both packages sum in float32 in different orders, and Adam's
m / sqrt(v) can turn that noise on a near-zero gradient into a step of
the learning rate's order; on these inputs the traces agree to 1e-5
relative and the leaves to 1e-5 absolute, so the bounds leave a factor of
ten. BO: the same selected candidates, and posterior mean and variance at
every candidate within rtol 1e-4 with atol 1e-6 for values near zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.bo import acfun as jacfun
from hyperbo_tpu.bo import bayesopt as jbo
from hyperbo_tpu.core import defs as jdefs
from hyperbo_tpu.core.warp import DEFAULT_WARP_FUNC as JWARP
from hyperbo_tpu.models import gp as jgp
from hyperbo_tpu.models import kernel as jkernel
from hyperbo_tpu.models import mean as jmean
from hyperbo_tpu_torch.bo import acfun as tacfun
from hyperbo_tpu_torch.bo import bayesopt as tbo
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC as TWARP
from hyperbo_tpu_torch.models import gp as tgp
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.train import adam as tadam
from torch_threads import one_torch_thread  # noqa: F401

TASKS, DIM, STEPS, BO_ITERS = 4, 2, 10, 5


def _data(seed=0):
  rng = np.random.default_rng(seed)
  data = {}
  for i in range(TASKS):
    n = 40 + 6 * i
    x = rng.uniform(size=(n, DIM)).astype(np.float32)
    w = rng.normal(size=(DIM, 1))
    y = (np.sin(3 * x @ w) + 0.1 * rng.normal(size=(n, 1))).astype(
        np.float32)
    data[f'task{i}'] = (x, y)
  cx = rng.uniform(size=(120, DIM)).astype(np.float32)
  cy = np.sin(3 * cx @ rng.normal(size=(DIM, 1))).astype(np.float32)
  return data, (cx, cy)


def _config():
  return {'method': 'adam', 'learning_rate': 1e-2,
          'max_training_step': STEPS, 'batch_size': 100,
          'objective': 'nll', 'mlp_features': (4, 4)}


def _model0():
  return {'constant': 0., 'lengthscale': 0., 'signal_variance': 0.,
          'noise_variance': -4.}


def _jax_gp(data, model):
  return jgp.GP({k: jdefs.SubDataset(*v) for k, v in data.items()},
                jmean.linear_mlp, jkernel.squared_exponential_mlp,
                jdefs.GPParams(model=model, config=dict(
                    _config(), batched_chol='xla')), JWARP)


def _torch_gp(data, init_np):
  tmodel = tgp.GP(data, tmean.linear_mlp, tkernel.squared_exponential_mlp,
                  tdefs.GPParams(model=convert.model_from_jax(init_np),
                                 config=_config()), TWARP, device='cpu')
  tmodel.initialize_params(torch.Generator().manual_seed(0))
  return tmodel


@pytest.fixture(scope='module')
def initial():
  """The data and the JAX package's initial parameters, as numpy."""
  data, cands = _data()
  jmodel = _jax_gp(data, _model0())
  jmodel.initialize_params(jax.random.PRNGKey(0))
  return data, cands, jax.tree.map(np.asarray, jmodel.params.model)


@pytest.fixture(scope='module')
def trained(initial):
  """Both packages trained from the same initial parameters."""
  data, _, init_np = initial
  jmodel = _jax_gp(data, jax.tree.map(jnp.asarray, init_np))
  jmodel.initialize_params(jax.random.PRNGKey(0))
  jmodel.train(jax.random.PRNGKey(1))
  # The JAX losses: rerun the runner GP.train cached (compiled once).
  runner = next(iter(jmodel._trainer_cache.values()))
  _, jdata, _, _ = jgp._build_packed_training(
      jmodel.params.config['objective'], jmodel.dataset,
      jmodel.params.config, jmean.linear_mlp,
      jkernel.squared_exponential_mlp, JWARP)
  _, jlosses = runner(jax.tree.map(jnp.asarray, init_np), jdata,
                      jax.random.PRNGKey(2))

  tmodel = _torch_gp(data, init_np)
  tmodel.train()
  loss_fn, tdata, subsample_fn, _ = tgp._build_packed_training(
      tmodel.params.config['objective'], tmodel.dataset,
      tmodel.params.config, tmean.linear_mlp,
      tkernel.squared_exponential_mlp, TWARP, 'cpu')
  trerun, tlosses = tadam.make_fit_adam_scan(
      loss_fn, subsample_fn, tmodel.params.config)(
          convert.model_from_jax(init_np), tdata)
  return dict(jmodel=jmodel, tmodel=tmodel, jlosses=np.asarray(jlosses),
              tlosses=tlosses.numpy(), trerun=trerun)


def _leaves(tree):
  return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def test_training_matches_jax(trained):
  jl, tl = trained['jlosses'], trained['tlosses']
  assert jl.shape == tl.shape == (STEPS,)
  assert np.isfinite(tl).all() and tl[-1] < tl[0]
  np.testing.assert_allclose(tl, jl, rtol=1e-4)
  jtrained = trained['jmodel'].params.model
  ttrained = convert.model_to_numpy(trained['tmodel'].params.model)
  assert (jax.tree.structure(jax.tree.map(np.asarray, jtrained)) ==
          jax.tree.structure(ttrained))
  for a, b in zip(_leaves(jtrained), _leaves(ttrained)):
    np.testing.assert_allclose(b, a, atol=1e-4)
  # GP.train() and the bare runner compute the same iterates.
  for a, b in zip(_leaves(convert.model_to_numpy(trained['trerun'])),
                  _leaves(ttrained)):
    np.testing.assert_array_equal(a, b)


def test_bo_matches_jax(initial):
  """EI over the same candidates from the same parameters: the same
  selections and posteriors. (The parameters are the initial ones, so that
  this test needs no training run of its own.)"""
  data, (cx, cy), init_np = initial

  def jax_bo():
    """The JAX host loop and its final posterior, traced as one program."""
    jmodel = _jax_gp(data, jax.tree.map(jnp.asarray, init_np))
    jmodel.initialize_params(jax.random.PRNGKey(0))
    jobs = jbo.simulated_bayesopt(
        jmodel, 'test', jdefs.SubDataset(jnp.asarray(cx), jnp.asarray(cy)),
        jacfun.ei, BO_ITERS, random_key=jax.random.PRNGKey(3))
    return (jobs.x,) + tuple(jmodel.predict(jnp.asarray(cx), 'test'))

  jx, mu_j, var_j = jax.jit(jax_bo)()
  tmodel = _torch_gp(data, init_np)
  tobs = tbo.simulated_bayesopt(tmodel, 'test', tdefs.SubDataset(cx, cy),
                                tacfun.ei, BO_ITERS)

  def picks(x):
    return [int(np.flatnonzero((cx == row).all(axis=1))[0])
            for row in np.asarray(x)]

  assert tobs.x.shape == (BO_ITERS, DIM) and tobs.y.shape == (BO_ITERS, 1)
  assert picks(tobs.x) == picks(jx)
  # Both caches went through the bucket-padded rank-1 appends.
  assert tmodel.params.cache['test'].num_obs == BO_ITERS - 1
  mu_t, var_t = tmodel.predict(cx, 'test')
  assert tmodel.params.cache['test'].num_obs == BO_ITERS
  assert mu_t.shape == var_t.shape == (len(cx), 1)
  np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-4,
                             atol=1e-6)
  np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=1e-4,
                             atol=1e-6)


def test_run_bayesopt_end_to_end():
  """The port's entry point alone: initialize, pre-train with subsampled
  batches, run BO; finite, decreasing loss and well-formed results."""
  data, (cx, cy) = _data(seed=1)
  config = dict(_config(), batch_size=24, checkpoint_every=1)
  losses = []
  (xo, yo), best, params = tbo.run_bayesopt(
      data, 'test', tdefs.SubDataset(cx, cy), tmean.linear_mlp,
      tkernel.squared_exponential_mlp,
      tdefs.GPParams(model=_model0(), config=config), tacfun.ei, 3,
      warp_func=TWARP, init_random_key=torch.Generator().manual_seed(0),
      init_model=True, callback=lambda s, m, l: losses.append(float(l)),
      device='cpu')
  assert len(losses) == STEPS and np.isfinite(losses).all()
  assert losses[-1] < losses[0]
  assert xo.shape == (3, DIM) and yo.shape == (3, 1)
  assert torch.isfinite(xo).all() and torch.isfinite(yo).all()
  np.testing.assert_array_equal(best[1], cy.max(axis=0))
  assert params.model['lengthscale'].shape == (4,)
