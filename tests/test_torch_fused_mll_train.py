"""The fused route of the PyTorch port in its callers, against the JAX
package on the CPU: GP.train(), the packed route, the dense route that
dot_product keeps, and the 'interpret' flag the port refuses. The helpers
and the tolerances are in test_torch_fused_mll.py.
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
from hyperbo_tpu.train import adam as jadam
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC as TWARP
from hyperbo_tpu_torch.models import gp as tgp
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.models import packed as tpacked
from hyperbo_tpu_torch.ops import fused_mll
from test_torch_fused_mll import (_assert_close_leaves, _inputs,
                                  _jax_value_and_grad, _objective_case,
                                  _torch_value_and_grad)
from torch_threads import one_torch_thread  # noqa: F401


def test_dot_product_stays_on_the_dense_route():
  x, y, model, _ = _objective_case('dot_product')
  model.update(dot_prod_sigma=np.float32(0.8), dot_prod_bias=np.float32(0.1))
  assert not fused_mll.se_nll_fused_applicable(tkernel.dot_product,
                                               torch.from_numpy(x))
  want, _ = _jax_value_and_grad('dot_product', x, y, model, {})
  dense, _ = _torch_value_and_grad('dot_product', x, y, model, {})
  got, _ = _torch_value_and_grad('dot_product', x, y, model,
                                 {'fused_mll': True})
  assert got == dense
  np.testing.assert_allclose(got, want, rtol=1e-4)


def test_packed_route_matches_jax():
  """Two tasks of 600 and 530 rows (n_max = 600, not a multiple of 64)
  through the port's packed fused route, against the JAX package's dense
  NLL of the same two tasks (their mean, as the packed NLL is)."""
  d = 3
  rng = np.random.default_rng(4)
  data = {i: (rng.uniform(size=(n, d)).astype(np.float32),
              rng.normal(size=(n, 1)).astype(np.float32))
          for i, n in enumerate((600, 530))}
  model = {'constant': np.float32(0.3),
           'lengthscale': np.full((d,), 0.4, np.float32),
           'signal_variance': np.float32(0.5),
           'noise_variance': np.float32(-2.0)}
  jdata = {k: jdefs.SubDataset(jnp.asarray(x), jnp.asarray(y))
           for k, (x, y) in data.items()}

  def jloss(m):
    return jobj.neg_log_marginal_likelihood(
        jmean.constant, jkernel.squared_exponential,
        jdefs.GPParams(model=m, config={}), jdata, warp_func=JWARP)

  want, gwant = jax.jit(jax.value_and_grad(jloss))(
      jax.tree.map(jnp.asarray, model))
  tpack, _ = tpacked.pack_dataset(
      {k: tdefs.SubDataset(x, y) for k, (x, y) in data.items()},
      pad_to_multiple=8, device='cpu')
  assert tpack.x.shape[1] == 600
  model_t = {k: v.requires_grad_(True)
             for k, v in convert.model_from_jax(model).items()}
  got = tpacked.neg_log_marginal_likelihood_packed(
      tmean.constant, tkernel.squared_exponential,
      tdefs.GPParams(model=model_t, config={'fused_mll': True}), tpack,
      warp_func=TWARP)
  ggot = dict(zip(model_t, torch.autograd.grad(got, list(model_t.values()))))
  np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
  _assert_close_leaves({k: g.numpy() for k, g in ggot.items()},
                       jax.tree.map(np.asarray, gwant))


def test_train_matches_jax():
  """GP.train() through the fused route: 3 Adam steps on one task of 512
  rows, against the JAX package's packed Adam runner with its interpreted
  kernel: the make_fit_adam_scan runner over _build_packed_training's
  buffers that its GP.train builds and calls on this data, given the
  subkey GP.train splits off. Run once, it gives both the loss trace and
  the trained leaves; GP.train's finite-loss gate passes on this data and
  its runner cache changes no value."""
  steps = 3
  x, y = _inputs(5, 512, 3, scale=1.0)
  y = np.sin(3 * x @ np.array([[1.0], [-2.0], [0.5]], np.float32)) + 0.1 * y
  data = {'t': (x, y.astype(np.float32))}
  config = {'method': 'adam', 'learning_rate': 1e-2,
            'max_training_step': steps, 'batch_size': 512,
            'objective': 'nll'}
  model = {'constant': 0., 'lengthscale': np.full((3,), 0.4, np.float32),
           'signal_variance': 0., 'noise_variance': -2.}
  jconfig = dict(config, fused_mll='interpret')
  jmodel = jgp.GP({k: jdefs.SubDataset(*v) for k, v in data.items()},
                  jmean.constant, jkernel.squared_exponential,
                  jdefs.GPParams(model=jax.tree.map(jnp.asarray, model),
                                 config=jconfig), JWARP)
  jmodel.initialize_params(jax.random.PRNGKey(0))
  init_np = jax.tree.map(np.asarray, jmodel.params.model)
  # The JAX side runs what its GP.train runs on the packed route, once, so
  # the interpreted kernels take the 3 steps once.
  loss_fn, jdata, subsample_fn, _ = jgp._build_packed_training(
      jmodel.params.config['objective'], jmodel.dataset, jmodel.params.config,
      jmean.constant, jkernel.squared_exponential, JWARP)
  jtrained, jlosses = jadam.make_fit_adam_scan(
      loss_fn, subsample_fn, jmodel.params.config)(
          jax.tree.map(jnp.asarray, init_np), jdata,
          jax.random.split(jax.random.PRNGKey(1))[1])

  tmodel = tgp.GP(data, tmean.constant, tkernel.squared_exponential,
                  tdefs.GPParams(model=convert.model_from_jax(init_np),
                                 config=dict(config, fused_mll=True,
                                             checkpoint_every=1)),
                  TWARP, device='cpu')
  tmodel.initialize_params(torch.Generator().manual_seed(0))
  losses = []
  tmodel.train(callback=lambda s, m, l: losses.append(float(l)))
  assert len(losses) == steps and losses[-1] < losses[0]
  np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-4)
  trained = convert.model_to_numpy(tmodel.params.model)
  for key, want in jax.tree.map(np.asarray, jtrained).items():
    np.testing.assert_allclose(trained[key], want, atol=1e-4)


def test_interpret_flag_raises():
  x, y, model, _ = _objective_case('squared_exponential')
  with pytest.raises(ValueError, match='interpret'):
    _torch_value_and_grad('squared_exponential', x, y, model,
                          {'fused_mll': 'interpret'})
  tpack, _ = tpacked.pack_dataset({0: tdefs.SubDataset(x, y)}, device='cpu')
  with pytest.raises(ValueError, match='interpret'):
    tpacked.per_task_nll_packed(
        tmean.constant, tkernel.squared_exponential,
        tdefs.GPParams(model=convert.model_from_jax(model),
                       config={'fused_mll': 'interpret'}), tpack,
        warp_func=TWARP)
