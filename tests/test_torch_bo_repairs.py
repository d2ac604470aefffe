"""BO-loop repairs of the PyTorch port against the JAX package on the CPU:
the retrain guard of bo/bayesopt.retrain_model, a retraining BO run's
selections, and the gradient of EI through GP.predict.

Both packages get the same numpy inputs and the same model, carried across
with core/convert. Tolerances: the selections are equal (the candidates'
EI values are far apart at this size); the retrained parameters within
rtol 1e-3 (two float32 Adam steps on either side); the gradient of EI with
respect to a query point within rtol 1e-4, compared in float64 (float32
posteriors of a 9-point GP on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.bo import acfun as jacfun
from hyperbo_tpu.bo import bayesopt as jbo
from hyperbo_tpu.core import defs as jdefs
from hyperbo_tpu.core import warp as jwarp
from hyperbo_tpu.models import gp as jgp
from hyperbo_tpu.models import kernel as jkernel
from hyperbo_tpu.models import mean as jmean
from hyperbo_tpu.models import objectives as jobj
from hyperbo_tpu_torch.bo import acfun as tacfun
from hyperbo_tpu_torch.bo import bayesopt as tbo
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core import warp as twarp
from hyperbo_tpu_torch.models import gp as tgp
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.models import objectives as tobj
from torch_threads import one_torch_thread  # noqa: F401

D = 2
MODEL = {'constant': np.float32(0.1),
         'lengthscale': np.array([-0.7, -0.4], np.float32),
         'signal_variance': np.float32(0.3),
         'noise_variance': np.float32(-3.0)}


def _data(seed=0, n=9, candidates=40):
  """n observations and the candidates of y = sin(3 x @ w), in [0, 1)^D."""
  rng = np.random.default_rng(seed)
  w = rng.normal(size=(D, 1))
  x = rng.uniform(size=(n + candidates, D))
  y = np.sin(3 * x @ w)
  x, y = x.astype(np.float32), y.astype(np.float32)
  return (x[:n], y[:n]), (x[n:], y[n:])


def _models(obs, config):
  """(JAX GP, port GP on the CPU) of one sub-dataset 'test' of obs."""
  x, y = obs
  jmodel = jgp.GP({'test': jdefs.SubDataset(jnp.asarray(x), jnp.asarray(y))},
                  jmean.constant, jkernel.squared_exponential,
                  jdefs.GPParams(model=jax.tree.map(jnp.asarray, MODEL),
                                 config=dict(config)),
                  jwarp.DEFAULT_WARP_FUNC)
  tmodel = tgp.GP({'test': (x, y)}, tmean.constant,
                  tkernel.squared_exponential,
                  tdefs.GPParams(model=convert.model_from_jax(MODEL),
                                 config=dict(config)),
                  twarp.DEFAULT_WARP_FUNC, device='cpu')
  return jmodel, tmodel


@pytest.mark.parametrize('name', ['regkl', 'regeuc'])
def test_retrain_refuses_an_objective_without_nll(name):
  obs, _ = _data()
  jmodel, tmodel = _models(obs, {'retrain': 2})
  jmodel.params.config['objective'] = getattr(jobj, name)
  tmodel.params.config['objective'] = getattr(tobj, name)
  msg = 'Objective must include NLL to retrain.'
  with pytest.raises(ValueError, match=msg):
    jbo.retrain_model(jmodel, 'test')
  with pytest.raises(ValueError, match=msg):
    tbo.retrain_model(tmodel, 'test')


def test_retraining_bo_selects_what_jax_selects():
  """Two BO iterations with retrain = 2 over 40 injected candidates: the
  same selections and retrained parameters, and max_training_step
  restored."""
  obs, cands = _data(seed=1)
  config = {'method': 'adam', 'learning_rate': 0.05, 'max_training_step': 7,
            'batch_size': 100, 'retrain': 2}
  jmodel, tmodel = _models(obs, config)
  jx = jbo.simulated_bayesopt(jmodel, 'test', jdefs.SubDataset(*cands),
                              jacfun.ei, 2).x
  tx = tbo.simulated_bayesopt(tmodel, 'test', tdefs.SubDataset(*cands),
                              tacfun.ei, 2).x
  assert tx.shape == (len(obs[0]) + 2, D)
  np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
  for model in (jmodel, tmodel):
    assert model.params.config['max_training_step'] == 7
  tparams = convert.model_to_numpy(tmodel.params.model)
  assert not np.allclose(tparams['lengthscale'], MODEL['lengthscale'])
  for key, value in jmodel.params.model.items():
    np.testing.assert_allclose(tparams[key], np.asarray(value), rtol=1e-3)


def test_ei_gradient_matches_jax_and_bo_keeps_no_graph():
  obs, cands = _data(seed=2)
  jmodel, tmodel = _models(obs, {})
  # The JAX posterior cache is set up outside the traced functions, as in
  # the JAX package's BO loop before its L-BFGS-B refinement; the query is
  # the candidate of largest EI, where EI has a slope to climb. EI and its
  # gradient then run jitted, reading that cache.
  jmodel.setup_predictor('test')
  evals = jax.jit(lambda: jacfun.ei(model=jmodel, sub_dataset_key='test',
                                    x_queries=jnp.asarray(cands[0])))()
  q = cands[0][int(jnp.argmax(evals))]
  want = jax.jit(jax.grad(lambda v: jacfun.ei(
      model=jmodel, sub_dataset_key='test', x_queries=v[None, :])[0, 0]))(
          jnp.asarray(q))
  tq = torch.tensor(q, requires_grad=True)
  val = tacfun.ei(model=tmodel, sub_dataset_key='test',
                  x_queries=tq[None, :])[0, 0]
  got, = torch.autograd.grad(val, tq)
  assert float(np.abs(want).max()) > 1e-3
  np.testing.assert_allclose(got.double().numpy(),
                             np.asarray(want, np.float64), rtol=1e-4)

  # Parameters that carry requires_grad (as while a caller differentiates
  # through them): a BO iteration's acquisition builds no graph, and a
  # predict outside the loop, which does build one, caches none.
  tmodel.update_model_params(
      {k: v.requires_grad_(True) for k, v in tmodel.params.model.items()})
  graphs = []

  def ei(**kwargs):
    out = tacfun.ei(**kwargs)
    graphs.append(out.requires_grad)
    return out

  tbo.simulated_bayesopt(tmodel, 'test', tdefs.SubDataset(*cands), ei, 1)
  assert graphs == [False]
  mu, _ = tmodel.predict(cands[0][:2], 'test')
  cache = tmodel.params.cache['test']
  assert cache.num_obs == len(obs[0]) + 1
  assert mu.requires_grad
  assert not (cache.chol.requires_grad or cache.kinvy.requires_grad)
