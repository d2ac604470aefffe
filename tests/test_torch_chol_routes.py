"""The Cholesky routes of the PyTorch port (hyperbo_tpu_torch/ops/chol.py)
and the plain versions of kernels K6 (ops/chol_hbm.py) and K7
(ops/chol_panel.py) against the JAX package on the CPU, its Pallas kernels
in interpret mode.

Tolerances are the JAX suite's own for these kernels
(tests/test_pallas_chol.py): a factor within atol 2e-5 of the panel
kernel's and 5e-4 at the route level and for the HBM kernel, and a GP NLL
from the routed factor within rel 1e-4. The kernels themselves run only on
the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

from unittest import mock

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import numpy as np
import pytest
import torch

from hyperbo_tpu.ops import chol as jchol
from hyperbo_tpu.ops import pallas_chol
from hyperbo_tpu.ops import pallas_chol_hbm
from hyperbo_tpu_torch.ops import chol as tchol
from hyperbo_tpu_torch.ops import chol_hbm
from hyperbo_tpu_torch.ops import chol_panel
from torch_threads import one_torch_thread  # noqa: F401

SETTERS = ('set_use_hbm_kernel', 'set_use_recursive', 'set_use_pallas_base')


def _spd(seed, n, batch=()):
  a = np.random.default_rng(seed).normal(size=batch + (n, n))
  return (a @ np.swapaxes(a, -1, -2) / n + np.eye(n)).astype(np.float32)


@pytest.fixture
def routes():
  """Switch routes on in both packages; everything off afterwards."""

  def switch(*names):
    for name in names:
      getattr(jchol, name)(True)
      getattr(tchol, name)(True)

  yield switch
  for name in SETTERS:
    getattr(jchol, name)(False)
    getattr(tchol, name)(False)


@pytest.fixture(scope='module')
def hbm_route():
  """A 1024 x 1024 matrix and the JAX package's factor of it through its
  HBM route: the Pallas HBM kernel at its default block and chunk, the
  call ops/chol.cholesky makes with set_use_hbm_kernel on. It runs in
  Pallas's TPU interpret mode, which models the kernel's DMAs and
  semaphores and compiles in about a third of the time of the generic
  interpreter the route picks on the CPU (the two give the same factor to
  float32 rounding). The interpreted trace is this file's costliest step,
  so the two tests that hold the port against that kernel share one."""
  a = _spd(1024, 1024)
  # The route picks that kernel for this matrix (its call recorded, not run).
  calls = []
  jchol.set_use_hbm_kernel(True)
  try:
    with mock.patch.object(pallas_chol_hbm, 'cholesky_hbm',
                           lambda m, **kw: calls.append((m.shape, kw)) or m):
      jchol.cholesky(jnp.asarray(a))
  finally:
    jchol.set_use_hbm_kernel(False)
  assert calls == [((1024, 1024), {'interpret': True})]
  want = np.asarray(jax.jit(lambda m: pallas_chol_hbm.cholesky_hbm(
      m, interpret=pltpu.InterpretParams()))(jnp.asarray(a)))
  return a, want


def _nll(chol, y):
  """GP NLL of y from a factor, in float64."""
  chol = np.asarray(chol, np.float64)
  z = np.linalg.solve(chol, y)
  return (0.5 * float(np.sum(z * z)) + float(np.sum(np.log(np.diag(chol))))
          + 0.5 * len(y) * np.log(2 * np.pi))


def test_k7_plain_matches_jax_panel_kernels():
  """cholesky_panel, cholesky_panel_blocked and cholesky_panel_padded of
  the port (plain version here) against the three Pallas entry points; a
  non-symmetric input is symmetrized first, as the Pallas bodies do."""
  a = _spd(1, 256)
  a[3, 5] += 0.05
  got = chol_panel.cholesky_panel(torch.from_numpy(a)).numpy()
  want = np.asarray(pallas_chol.cholesky_panel(jnp.asarray(a),
                                               interpret=True))
  np.testing.assert_allclose(got, want, atol=2e-5)
  a = _spd(2, 64)
  got = chol_panel.cholesky_panel_blocked(torch.from_numpy(a),
                                          block_width=32).numpy()
  want = np.asarray(pallas_chol.cholesky_panel_blocked(
      jnp.asarray(a), interpret=True, block_width=32))
  np.testing.assert_allclose(got, want, atol=2e-5)
  with pytest.raises(ValueError, match='block_width'):
    chol_panel.cholesky_panel_blocked(torch.from_numpy(a), block_width=48)
  a = _spd(3, 200)
  got = chol_panel.cholesky_panel_padded(torch.from_numpy(a)).numpy()
  want = np.asarray(pallas_chol.cholesky_panel_padded(jnp.asarray(a),
                                                      interpret=True))
  np.testing.assert_allclose(got, want, atol=2e-5)
  # A batch is factored matrix by matrix.
  batch = _spd(4, 37, (3,))
  got = chol_panel.cholesky_panel(torch.from_numpy(batch)).numpy()
  np.testing.assert_allclose(got, np.linalg.cholesky(batch), atol=2e-5)


def test_k6_plain_matches_jax_hbm_kernel(hbm_route):
  """cholesky_hbm (plain version here) against the Pallas HBM kernel at
  n = 1024 at the JAX route's block and chunk (hbm_route: the kernel call
  the route makes, in TPU interpret mode); the layout aliases give the
  same factor and keep the JAX shape checks."""
  a, want = hbm_route
  y = np.random.default_rng(6).normal(size=(1024, 1))
  ta = torch.from_numpy(a)
  got = chol_hbm.cholesky_hbm(ta, block=128, chunk=256).numpy()
  np.testing.assert_allclose(got, want, atol=5e-4)
  assert abs(_nll(got, y) - _nll(want, y)) <= 1e-4 * abs(_nll(want, y))
  for alias, kwargs in (
      (chol_hbm.cholesky_hbm_halves, dict(block=128, chunk=128, half=256)),
      (chol_hbm.cholesky_hbm_wide, dict(block=128, chunk=128, tw=256)),
      (chol_hbm.cholesky_hbm_halfwide,
       dict(block=128, chunk=128, tw=256, half=256))):
    np.testing.assert_array_equal(alias(ta, **kwargs).numpy(), got)
  # Only the lower triangle is read, as LAPACK's potrf reads it.
  upper = a + np.triu(np.full_like(a, 7.0), 1)
  np.testing.assert_array_equal(
      chol_hbm.cholesky_hbm(torch.from_numpy(upper), block=128,
                            chunk=256).numpy(), got)
  for alias, kwargs in ((chol_hbm.cholesky_hbm, dict(block=384)),
                        (chol_hbm.cholesky_hbm_halves, dict(half=384)),
                        (chol_hbm.cholesky_hbm_wide, dict(tw=384)),
                        (chol_hbm.cholesky_hbm, dict(block=32, chunk=96))):
    with pytest.raises(ValueError):
      alias(ta, **kwargs)


@pytest.mark.parametrize('names,n,base_block', [
    (('set_use_hbm_kernel',), 1024, 512),
    (('set_use_recursive', 'set_use_pallas_base'), 1024, 512),
    (('set_use_recursive', 'set_use_pallas_base'), 700, 256),
])
def test_routes_match_jax_routes(request, routes, names, n, base_block):
  """ops/chol.cholesky with the same setters on in both packages: K6 at
  n = 1024 (the JAX side from the hbm_route fixture: the route's own
  kernel call, which the fixture checks the route makes, run in TPU
  interpret mode), and the blocked recursion with K7 base cases (1024 splits into
  two 512 blocks; 700 recurses down to 128-188 blocks)."""
  y = np.random.default_rng(7).normal(size=(n, 1))
  if names == ('set_use_hbm_kernel',):
    a, want = request.getfixturevalue('hbm_route')
    routes(*names)
  else:
    a = _spd(n, n)
    routes(*names)
    want = np.asarray(jax.jit(lambda m: jchol.cholesky(
        m, base_block=base_block))(jnp.asarray(a)))
  got = tchol.cholesky(torch.from_numpy(a), base_block=base_block).numpy()
  np.testing.assert_allclose(got, want, atol=5e-4)
  np.testing.assert_allclose(got, np.linalg.cholesky(a.astype(np.float64)),
                             atol=5e-4)
  assert abs(_nll(got, y) - _nll(want, y)) <= 1e-4 * abs(_nll(want, y))


def test_route_selection_and_gradient(routes, monkeypatch):
  """The JAX precedence (HBM kernel, recursion, base), with the n
  conditions applied to every matrix of a batch. A routed factor is
  forward-only, as in the JAX package; with the routes off the
  factorization stays differentiable."""
  calls = []
  real_hbm, real_panel = chol_hbm.cholesky_hbm, chol_panel.cholesky_panel
  monkeypatch.setattr(chol_hbm, 'cholesky_hbm',
                      lambda a: calls.append(('hbm', a.shape[-1])) or
                      real_hbm(a))
  monkeypatch.setattr(chol_panel, 'cholesky_panel',
                      lambda a: calls.append(('panel', a.shape[-1])) or
                      real_panel(a))
  batch = torch.from_numpy(_spd(8, 1024, (2,)))
  want = np.linalg.cholesky(batch.double().numpy())
  hbm, rec, base = SETTERS
  for names, n, expect in (
      ((), 1024, []),
      ((base,), 1024, []),
      ((base,), 512, [('panel', 512)]),
      ((rec,), 1024, []),
      ((rec, base), 1024, [('panel', 512), ('panel', 512)]),
      ((hbm,), 1024, [('hbm', 1024)]),
      ((hbm, rec, base), 1024, [('hbm', 1024)]),
      ((hbm, rec, base), 960, [('panel', 384), ('panel', 256),
                               ('panel', 320)]),
      ((hbm, base), 512, [('panel', 512)])):
    for name in SETTERS:
      getattr(tchol, name)(False)
    calls.clear()
    routes(*names)
    got = tchol.cholesky(batch[:, :n, :n]).numpy()
    assert calls == expect, (names, n, calls)
    np.testing.assert_allclose(got, want[:, :n, :n], atol=5e-4)
  assert tchol.logdet_from_chol(torch.eye(3) * 2.0).item() == pytest.approx(
      6 * np.log(2.0))

  for name in SETTERS:
    getattr(tchol, name)(False)
  a = torch.from_numpy(_spd(10, 300)).double().requires_grad_(True)
  torch.log(torch.diagonal(tchol.cholesky(a))).sum().backward()
  assert torch.isfinite(a.grad).all()
  routes(base)
  out = torch.log(torch.diagonal(tchol.cholesky(a))).sum()
  with pytest.raises(NotImplementedError, match='forward-only'):
    out.backward()


def test_non_pd_gives_nan_on_every_route(routes):
  """A matrix that is not positive definite comes out NaN (the whole
  matrix, and only that matrix of a batch) on every route; a failure in
  the recursion's trailing block poisons the whole factor too."""
  hbm, rec, base = SETTERS
  for names, n in (((), 600), ((hbm,), 1024), ((rec,), 600),
                   ((rec, base), 600), ((base,), 300)):
    for name in SETTERS:
      getattr(tchol, name)(False)
    routes(*names)
    a = _spd(9, n, (2,))
    a[1, -1, -1] = -5.0
    got = tchol.cholesky(torch.from_numpy(a), base_block=256)
    assert torch.isfinite(got[0]).all(), names
    assert torch.isnan(got[1]).all(), names
