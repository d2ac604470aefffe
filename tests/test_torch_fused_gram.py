"""The fused Gram matrix of the PyTorch port (hyperbo_tpu_torch/ops/
fused_gram.py, kernel K5) against the JAX package on the CPU.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel
itself is held against that plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py). Four calls go through the
JAX package's Pallas kernel in interpret mode (seconds each here); the rest
are held against the JAX package's models/kernel.py functions, as
tests/test_pallas_gram.py holds the Pallas kernel, within its atol 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbo_tpu.core import defs as jdefs
from hyperbo_tpu.core.warp import DEFAULT_WARP_FUNC as JWARP
from hyperbo_tpu.models import kernel as jkernel
from hyperbo_tpu.ops import pallas_gram
from hyperbo_tpu_torch.ops import fused_gram

KINDS = {
    'se': jkernel.squared_exponential,
    'matern32': jkernel.matern32,
    'matern52': jkernel.matern52,
}
SV_RAW, NV_RAW = 0.7, -2.0


def _softplus(v):
  return np.log1p(np.exp(v)) + 1e-10


def _params(d):
  """The raw parameters of tests/test_pallas_gram.py, for the JAX kernel
  functions, and their warped values (lengthscale, sv, ridge) as float32."""
  raw_ls = np.linspace(0.4, 0.8, d).astype(np.float32)
  params = jdefs.GPParams(model={'lengthscale': jnp.asarray(raw_ls),
                                 'signal_variance': SV_RAW,
                                 'noise_variance': NV_RAW})
  return params, (_softplus(raw_ls).astype(np.float32),
                  np.float32(_softplus(SV_RAW)),
                  np.float32(_softplus(NV_RAW) + 1e-6))


def _inputs(seed, *shapes):
  rng = np.random.default_rng(seed)
  return [rng.normal(size=s).astype(np.float32) for s in shapes]


def test_matches_pallas_gram():
  """gram_with_ridge, cross_gram and gram (with and without the ridge, on a
  rectangular matrix) against the interpreted Pallas kernel, with d = 40
  spanning more than one 32-wide feature chunk of the Hopper kernel."""
  x, x1, x2, y1 = _inputs(0, (70, 4), (41, 3), (17, 3), (37, 40))
  # gram takes inputs already divided by the lengthscale: at unit scale and
  # d = 40, |x|^2 ~ 40 and the float32 cancellation in |a|^2 + |b|^2 - 2 a.b
  # alone reaches the 2e-5 bound.
  y1 = y1 * np.float32(0.3)
  _, (ls4, sv, ridge) = _params(4)
  _, (ls3, _, _) = _params(3)
  t = torch.from_numpy
  cases = [
      (fused_gram.gram_with_ridge(t(x), t(ls4), sv, ridge, 'se'),
       pallas_gram.gram_with_ridge(x, ls4, sv, ridge, kind='se',
                                   interpret=True, block=32)),
      (fused_gram.cross_gram(t(x1), t(x2), t(ls3), sv, 'matern32'),
       pallas_gram.cross_gram(x1, x2, ls3, sv, kind='matern32',
                              interpret=True, block=32)),
      (fused_gram.gram(t(y1), t(y1[:23]), sv, ridge, 'matern52'),
       pallas_gram.gram(y1, y1[:23], sv, ridge, kind='matern52',
                        block_m=32, block_n=32, interpret=True)),
      (fused_gram.gram(t(x1), t(x2), sv, ridge, 'se', add_ridge=True),
       pallas_gram.gram(x1, x2, sv, ridge, kind='se', add_ridge=True,
                        block_m=32, block_n=32, interpret=True)),
  ]
  for got, want in cases:
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize('kind', list(KINDS))
def test_gram_with_ridge_matches_kernel_lib(kind):
  for n in (32, 70):
    x, = _inputs(n, (n, 4))
    params, (ls, sv, ridge) = _params(4)
    got = fused_gram.gram_with_ridge(torch.from_numpy(x), torch.from_numpy(ls),
                                     sv, ridge, kind)
    want = KINDS[kind](params, jnp.asarray(x), warp_func=JWARP) + (
        ridge * jnp.eye(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_cross_gram_matches_kernel_lib():
  x1, x2 = _inputs(1, (41, 3), (17, 3))
  params, (ls, sv, _) = _params(3)
  for kind, fn in KINDS.items():
    got = fused_gram.cross_gram(torch.from_numpy(x1), torch.from_numpy(x2),
                                torch.from_numpy(ls), sv, kind)
    want = fn(params, jnp.asarray(x1), jnp.asarray(x2), warp_func=JWARP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_psd_and_forward_only():
  """K + ridge I is positive definite; a gradient request raises, as the
  JAX kernel has no VJP."""
  x, = _inputs(3, (60, 5))
  _, (ls, _, _) = _params(5)
  got = fused_gram.gram_with_ridge(torch.from_numpy(x), torch.from_numpy(ls),
                                   1.0, 1e-3, 'se')
  assert np.linalg.eigvalsh(got.double().numpy()).min() > 0
  xg = torch.from_numpy(x).requires_grad_(True)
  out = fused_gram.gram_with_ridge(xg, torch.from_numpy(ls), 1.0, 1e-3, 'se')
  with pytest.raises(NotImplementedError, match='forward-only'):
    torch.autograd.grad(out.sum(), xg)


def test_launch_refuses_cpu_tensors():
  """A CPU tensor never reaches the kernel: launch_gram raises before
  building anything."""
  x1, x2 = (torch.from_numpy(a) for a in _inputs(4, (8, 2), (5, 2)))
  with pytest.raises(ValueError, match='CUDA'):
    fused_gram.launch_gram(x1, x2, 1.0, 0.1)
