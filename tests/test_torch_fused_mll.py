"""The fused large-n NLL of the PyTorch port (hyperbo_tpu_torch/ops/
fused_mll.py, tri_inv.py and mll_bwd.py: kernels K2, K3 and K4, their
route and their custom backward) against the JAX package on the CPU.

On the CPU every wrapper runs its kernel's plain version; the CUDA kernels
themselves are held against those plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py). The JAX side runs its Pallas
kernels in interpret mode where a test names a kernel, and only for SE:
each interpreted shape costs seconds to trace here. The Matern and SE-MLP
routes are held against the JAX package's dense pipeline, to which the JAX
suite holds its own fused route at the same bounds. The kernel-level tests
are in test_torch_fused_mll_kernels.py, training and the packed route in
test_torch_fused_mll_train.py, the route's applicability in
test_torch_fused_mll_applicable.py; they share this file's helpers. No
file has more than seven tests: `pytest --dist loadfile` hands out the
files with the most tests first, and smaller files start after the suite's
longest file (tests/test_distributed_grad.py, seven tests) instead of
delaying it.

Tolerances: L within atol 5e-4, quad within rtol 1e-3 and logdet within
rtol 1e-4 (tests/test_pallas_chol.py's bounds for the same float32
factorization); T = L^{-1} within 1e-5 of its largest entry (both are
float32 substitutions of a well-conditioned factor); the backward's P and
d_x within 3e-3 of their largest entry plus 1e-5 and its two scalars
within rtol 1e-4. Objective values within rtol 1e-4
(tests/test_objectives.py:313) and gradients within 3e-3 max + 1e-5 per
leaf (tests/test_objectives.py:353). A ragged n is held against the port's
own dense route in float64 rather than the JAX masked route, which misses
its bound on this tree (ROADMAP Queue C). Training: loss traces within
rtol 1e-4 and trained leaves within atol 1e-4, the bounds of
tests/test_torch_slice.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.core import defs as jdefs
from hyperbo_tpu.core.warp import DEFAULT_WARP_FUNC as JWARP
from hyperbo_tpu.models import kernel as jkernel
from hyperbo_tpu.models import mean as jmean
from hyperbo_tpu.models import objectives as jobj
from hyperbo_tpu.ops import pallas_mll
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC as TWARP
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.models import objectives as tobj
from hyperbo_tpu_torch.ops import fused_mll

SV, DA = 1.3, 0.11


def _inputs(seed, n, d, scale=2.0):
  rng = np.random.default_rng(seed)
  x = (rng.uniform(size=(n, d)) * scale).astype(np.float32)
  y = rng.normal(size=(n, 1)).astype(np.float32)
  return x, y


def _factor(x):
  """float32 Cholesky factor of the SE Gram of x (+ DA I), as numpy."""
  chol, _, _ = fused_mll.mll_fused_plain(
      torch.from_numpy(x), torch.zeros(x.shape[0], 1), torch.tensor(SV),
      torch.tensor(DA))
  return chol.numpy()


def _assert_close_leaves(got, want, scale=3e-3, floor=1e-5):
  for key in want:
    a = np.asarray(want[key], np.float64)
    b = np.asarray(got[key], np.float64)
    assert np.max(np.abs(a - b)) <= scale * np.max(np.abs(a)) + floor, (
        f'{key}: {b} vs {a}')


def test_k2_plain_matches_jax_kernel():
  """Against mll_fused_g with the arguments, shapes and dtypes of the JAX
  route's own call (se_nll_fused at n = 512, d = 3), so that
  test_objective_matches_jax reuses this interpreted trace."""
  x, y = _inputs(0, 512, 3)
  l_j, quad_j, ld_j = pallas_mll.mll_fused_g(
      jnp.asarray(x), jnp.asarray(y), jnp.asarray(SV, jnp.float32),
      jnp.asarray(DA, jnp.float32), block=256, half=512, group=2,
      sweep_unroll=2, return_l=True, kfam='se', pivot_mode='octv',
      interpret=True)
  l_t, quad_t, ld_t = fused_mll.mll_fused(
      torch.from_numpy(x), torch.from_numpy(y), torch.tensor(SV),
      torch.tensor(DA))
  np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=5e-4)
  np.testing.assert_allclose(float(quad_t), float(quad_j), rtol=1e-3)
  np.testing.assert_allclose(float(ld_t), float(ld_j), rtol=1e-4)


def _objective_case(cov_name, n=512, d=3, seed=2):
  x, y = _inputs(seed, n, d, scale=1.0)
  model = {'constant': np.float32(0.3),
           'lengthscale': np.full((d,), 0.4, np.float32),
           'signal_variance': np.float32(0.5),
           'noise_variance': np.float32(-2.0)}
  config = {}
  if cov_name.endswith('_mlp'):
    # As tests/test_objectives.py:515 sets it up (features (8, 8), Flax's
    # fan-in scaled weights, zero biases), with the raw lengthscale 0.4 of
    # the other kernels here: at 1.0 the embedded Gram is so smooth that
    # the signal-variance gradient cancels, and both float32 pipelines then
    # err up to 6e-3 against float64.
    rng = np.random.default_rng(seed + 1)
    config['mlp_features'] = (8, 8)
    model['mlp_params'] = {
        f'Dense_{i}': {
            'kernel': (rng.normal(size=(fan_in, 8)) /
                       np.sqrt(fan_in)).astype(np.float32),
            'bias': np.zeros(8, np.float32)}
        for i, fan_in in enumerate((d, 8))}
    model['lengthscale'] = np.full((8,), 0.4, np.float32)
  return x, y, model, config


def _jax_value_and_grad(cov_name, x, y, model, config):
  """Jitted, except around an interpreted kernel, whose trace jit would
  compile once more."""
  cov = getattr(jkernel, cov_name)
  dataset = {'a': jdefs.SubDataset(jnp.asarray(x), jnp.asarray(y))}

  def loss(m):
    return jobj.neg_log_marginal_likelihood(
        jmean.constant, cov, jdefs.GPParams(model=m, config=config),
        dataset, warp_func=JWARP)

  vg = jax.value_and_grad(loss)
  if not config.get('fused_mll'):
    vg = jax.jit(vg)
  val, grad = vg(jax.tree.map(jnp.asarray, model))
  return float(val), jax.tree.map(np.asarray, grad)


def _torch_value_and_grad(cov_name, x, y, model, config,
                          dtype=torch.float32):
  model_t = convert.model_from_jax(model)
  model_t = jax.tree.map(lambda v: v.to(dtype).requires_grad_(True),
                         model_t)
  leaves, treedef = jax.tree.flatten(model_t)
  dataset = {'a': tdefs.SubDataset(torch.from_numpy(x).to(dtype),
                                   torch.from_numpy(y).to(dtype))}
  val = tobj.neg_log_marginal_likelihood(
      tmean.constant, getattr(tkernel, cov_name),
      tdefs.GPParams(model=model_t, config=config), dataset,
      warp_func=TWARP)
  grads = torch.autograd.grad(val, leaves, allow_unused=True)
  return float(val.detach()), jax.tree.unflatten(
      treedef, [np.zeros(v.shape) if g is None else g.double().numpy()
                for v, g in zip(leaves, grads)])


def _flat(tree):
  return {'/'.join(str(k.key) for k in path): leaf for path, leaf in
          jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize('cov_name', ['squared_exponential', 'matern32',
                                      'matern52',
                                      'squared_exponential_mlp'])
def test_objective_matches_jax(cov_name):
  """The fused route (plain versions on the CPU) against JAX: the Pallas
  route in interpret mode for SE, the dense pipeline for the others."""
  x, y, model, config = _objective_case(cov_name)
  jconfig = dict(config)
  if cov_name == 'squared_exponential':
    jconfig['fused_mll'] = 'interpret'
  want, gwant = _jax_value_and_grad(cov_name, x, y, model, jconfig)
  tconfig = dict(config, fused_mll=True)
  assert fused_mll.se_nll_fused_applicable(
      getattr(tkernel, cov_name), torch.from_numpy(x),
      tdefs.GPParams(model=convert.model_from_jax(model), config=tconfig))
  got, ggot = _torch_value_and_grad(cov_name, x, y, model, tconfig)
  np.testing.assert_allclose(got, want, rtol=1e-4)
  _assert_close_leaves(_flat(ggot), _flat(gwant))


@pytest.mark.parametrize('cov_name', ['squared_exponential', 'matern32'])
def test_ragged_n_matches_float64_dense(cov_name):
  """n = 700 pads to 704 through the masked core; held against the port's
  dense route in float64 (value and gradients)."""
  x, y, model, _ = _objective_case(cov_name, n=700, seed=3)
  want, gwant = _torch_value_and_grad(cov_name, x, y, model, {},
                                      dtype=torch.float64)
  got, ggot = _torch_value_and_grad(cov_name, x, y, model,
                                    {'fused_mll': True})
  np.testing.assert_allclose(got, want, rtol=1e-4)
  _assert_close_leaves(_flat(ggot), _flat(gwant))
