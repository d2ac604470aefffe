"""Both packages send the same configurations down the fused route:
se_nll_fused_applicable of the PyTorch port against the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.core import defs as jdefs
from hyperbo_tpu.models import kernel as jkernel
from hyperbo_tpu.ops import pallas_mll
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.ops import fused_mll


@pytest.mark.parametrize('case', ['se', 'se_small', 'matern52_ragged',
                                  'dot_product', 'mlp_missing', 'mlp',
                                  'two_outputs'])
def test_applicability_matches_jax(case):
  """Both packages send the same configurations down the fused route."""
  n = {'se_small': 511, 'matern52_ragged': 700}.get(case, 512)
  x = np.zeros((n, 3), np.float32)
  y = np.zeros((n, 2 if case == 'two_outputs' else 1), np.float32)
  name = {'matern52_ragged': 'matern52', 'dot_product': 'dot_product',
          'mlp_missing': 'squared_exponential_mlp',
          'mlp': 'squared_exponential_mlp'}.get(case, 'squared_exponential')
  model, config = {}, {}
  if case == 'mlp':
    model['mlp_params'] = {'Dense_0': {'kernel': np.zeros((3, 4), np.float32),
                                       'bias': np.zeros(4, np.float32)}}
    config['mlp_features'] = (4,)
  want = pallas_mll.se_nll_fused_applicable(
      getattr(jkernel, name), jnp.asarray(x),
      jdefs.GPParams(model=model, config=config), y=jnp.asarray(y))
  got = fused_mll.se_nll_fused_applicable(
      getattr(tkernel, name), torch.from_numpy(x),
      tdefs.GPParams(model=convert.model_from_jax(model), config=config),
      y=torch.from_numpy(y))
  assert got == want
