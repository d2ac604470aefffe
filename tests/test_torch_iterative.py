"""The matrix-free NLL of the PyTorch port (ops/iterative) and its
objective route (config['iterative_mll']) against the JAX package on the
CPU, on the same numpy inputs.

The probes are injected: the port's Rademacher draws (`_draw_rademacher`)
are replaced by the JAX package's two draws of the same key (Hutchinson's,
then SLQ's), never seeded alike. The JAX results come from one jitted
module fixture.

Tolerances (float32 on both sides): kernel_matvec within 2e-6 of the
largest entry (one rank-d product and the transform, in another
summation order) and its gradient within 1e-5 of the largest entry (1e-4
for sv's, one sum over every entry of the tiles); the
pivoted Cholesky factor within atol 1e-5; the Woodbury apply and a CG
solve within rtol 1e-4 (float32 CG on a well-conditioned system), with
the same iteration count; the SLQ logdet within rtol 1e-5; the NLL estimate
within rtol 1e-4 of JAX's and each gradient leaf within 1e-3 of that
leaf's largest entry (acceptance bounds of the port); the posterior mean
and variance within rtol 1e-4 (atol 1e-5); the dense fallback within rtol
1e-6.
"""

import math

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
from hyperbo_tpu.ops import iterative as jit_
from hyperbo_tpu_torch.core import convert
from hyperbo_tpu_torch.core import defs as tdefs
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC as TWARP
from hyperbo_tpu_torch.models import gp as tgp
from hyperbo_tpu_torch.models import kernel as tkernel
from hyperbo_tpu_torch.models import mean as tmean
from hyperbo_tpu_torch.models import objectives as tobj
from hyperbo_tpu_torch.ops import iterative as tit
from torch_threads import one_torch_thread  # noqa: F401

D, N, CHUNK, PROBES, STEPS = 3, 300, 128, 8, 20
NTOT = 384  # N padded to a multiple of CHUNK
FAMILIES = ('se', 'matern32', 'matern52')
KERNELS = {'se': 'squared_exponential', 'matern52': 'matern52'}
MODEL = {'constant': np.float32(0.2),
         'lengthscale': np.full(D, 0.4, np.float32),
         'signal_variance': np.float32(0.3),
         'noise_variance': np.float32(0.5)}
PROBE_KEY = 11


def _data(seed=0, n=N):
  rng = np.random.default_rng(seed)
  x = rng.uniform(size=(n, D)).astype(np.float32)
  y = np.sin(3 * x @ rng.normal(size=(D, 1))).astype(np.float32)
  return x, y


def _scaled(seed=1, n=NTOT):
  """Centered length-scaled inputs and right-hand sides for the pieces."""
  rng = np.random.default_rng(seed)
  x = (rng.uniform(size=(n, D)) / 0.4).astype(np.float32)
  return x - x.mean(axis=0), rng.normal(size=(n, 5)).astype(np.float32)


SV, DA, RANK = np.float32(1.2), np.float32(0.13), 16


def _jax_probes(key, n):
  k_slq, k_probe = jax.random.split(key)
  draw = lambda k: jnp.where(jax.random.bernoulli(k, 0.5, (n, PROBES)),
                             1.0, -1.0).astype(jnp.float32)
  return draw(k_probe), draw(k_slq)


def _jax_nll(model, cov, x, y, **kwargs):
  return jit_.mll_iterative(
      jmean.constant, jdefs.GPParams(model=model), x, y, warp_func=JWARP,
      cov_func=cov, row_chunk=CHUNK, num_probes=PROBES, lanczos_steps=STEPS,
      key=jax.random.PRNGKey(PROBE_KEY), precond_rank=RANK, **kwargs)


@pytest.fixture(scope='module')
def jax_ref():
  """Every JAX result this file compares with, as numpy, from one jitted
  program."""
  xs, v = _scaled()
  x, y = _data()
  xq = np.random.default_rng(2).uniform(size=(40, D)).astype(np.float32)

  def everything():
    out = {}
    xsj, vj = jnp.asarray(xs), jnp.asarray(v)
    for kf in FAMILIES:
      out['matvec_' + kf] = jit_.kernel_matvec(xsj, vj, SV, DA, kfam=kf,
                                             row_chunk=CHUNK)
      out['matvec_grad_' + kf] = jax.grad(
          lambda a, s: jnp.sum(jnp.sin(jit_.kernel_matvec(
              a, vj, s, DA, kfam=kf, row_chunk=CHUNK))), argnums=(0, 1))(
                  xsj, jnp.asarray(SV))
    lmat = jit_.partial_pivoted_cholesky(xsj, SV, 'matern52', RANK)
    out['lmat'] = lmat
    pinv = jit_.woodbury_inverse_apply(lmat, DA)
    out['woodbury'] = pinv(vj)
    mv = lambda a: jit_.kernel_matvec(xsj, a, SV, jnp.float32(1.0),
                                      kfam='se', row_chunk=CHUNK)
    out['cg'] = jit_.cg_batched(mv, vj, tol=1e-5, precond=pinv)
    out['cg_plain'] = jit_.cg_batched(mv, vj, tol=1e-5)
    out['slq'] = jit_.slq_logdet(mv, NTOT, jax.random.PRNGKey(1),
                                 num_probes=PROBES, lanczos_steps=STEPS)
    out['slq_probes'] = jnp.where(jax.random.bernoulli(
        jax.random.PRNGKey(1), 0.5, (NTOT, PROBES)), 1.0, -1.0)
    model = jax.tree.map(jnp.asarray, MODEL)
    for kf, name in KERNELS.items():
      cov = getattr(jkernel, name)
      (val, info), grads = jax.value_and_grad(
          lambda m: _jax_nll(m, cov, jnp.asarray(x), jnp.asarray(y),
                             return_info=True), has_aux=True)(model)
      out['nll_' + kf] = (val, info['cg_iters'], grads)
    out['probes'] = _jax_probes(jax.random.PRNGKey(PROBE_KEY), NTOT)
    out['dense'] = jobj.neg_log_marginal_likelihood(
        jmean.constant, jkernel.squared_exponential,
        jdefs.GPParams(model=model),
        {'a': jdefs.SubDataset(jnp.asarray(x), jnp.asarray(y))},
        warp_func=JWARP)
    out['predict'] = jit_.predict_iterative(
        jmean.constant, jdefs.GPParams(model=model), jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(xq), warp_func=JWARP,
        cov_func=jkernel.matern52, row_chunk=CHUNK, query_chunk=16,
        cg_tol=1e-7, precond_rank=RANK)
    out['predict_grad'] = jax.grad(lambda q: jnp.sum(jit_.predict_iterative(
        jmean.constant, jdefs.GPParams(model=model), jnp.asarray(x),
        jnp.asarray(y), q, warp_func=JWARP, cov_func=jkernel.matern52,
        row_chunk=CHUNK, cg_tol=1e-7, precond_rank=RANK,
        compute_var=False)[0]))(jnp.asarray(xq))
    return out

  out = jax.tree.map(np.asarray, jax.jit(everything)())
  out['inputs'] = {'xs': xs, 'v': v, 'x': x, 'y': y, 'xq': xq}
  return out


def _inject(monkeypatch, *draws):
  it = iter(draws)
  monkeypatch.setattr(tit, '_draw_rademacher',
                      lambda g, shape, device: torch.tensor(next(it)))


def _max_rel(a, b):
  return np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(b))


def test_kernel_matvec_matches_jax(jax_ref):
  """All three families, with and without a gradient; the gradient path
  (a checkpointed tile a chunk) gives the same values bitwise, and its
  gradients in x and sv are JAX's."""
  xs, v = (torch.tensor(jax_ref['inputs'][k]) for k in ('xs', 'v'))
  for kf in FAMILIES:
    with torch.no_grad():
      got = tit.kernel_matvec(xs, v, SV, DA, kfam=kf, row_chunk=CHUNK)
    assert _max_rel(got.numpy(), jax_ref['matvec_' + kf]) < 2e-6, kf
    a = xs.clone().requires_grad_(True)
    s = torch.tensor(SV, requires_grad=True)
    live = tit.kernel_matvec(a, v, s, DA, kfam=kf, row_chunk=CHUNK)
    assert torch.equal(live.detach(), got), kf
    ga, gs = torch.autograd.grad(torch.sum(torch.sin(live)), (a, s))
    want_a, want_s = jax_ref['matvec_grad_' + kf]
    assert _max_rel(ga.numpy(), want_a) < 1e-5, kf
    np.testing.assert_allclose(float(gs), float(want_s), rtol=1e-4)
  with pytest.raises(AssertionError):
    tit.kernel_matvec(xs[:300], v[:300], SV, DA, row_chunk=CHUNK)


def test_cg_pivoted_cholesky_and_woodbury_match_jax(jax_ref, monkeypatch):
  """The rank-16 preconditioner, its Woodbury apply, and preconditioned
  and plain CG: JAX's solutions, iteration counts and residuals; the
  device flag read every iteration or every fourth gives the same result
  bitwise."""
  xs, v = (torch.tensor(jax_ref['inputs'][k]) for k in ('xs', 'v'))
  lmat = tit.partial_pivoted_cholesky(xs, SV, 'matern52', RANK)
  np.testing.assert_allclose(lmat.numpy(), jax_ref['lmat'], atol=1e-5)
  pinv = tit.woodbury_inverse_apply(lmat, DA)
  np.testing.assert_allclose(pinv(v).numpy(), jax_ref['woodbury'],
                             rtol=1e-4, atol=1e-5)
  mv = lambda a: tit.kernel_matvec(xs, a, SV, 1.0, row_chunk=CHUNK)
  for key, precond in (('cg', pinv), ('cg_plain', None)):
    jx, jiters, jres = jax_ref[key]
    runs = []
    for every in (1, 4):
      monkeypatch.setattr(tit, 'CG_CHECK_EVERY', every)
      runs.append(tit.cg_batched(mv, v, tol=1e-5, precond=precond))
    (x1, i1, r1), (x4, i4, r4) = runs
    assert torch.equal(x1, x4) and int(i1) == int(i4) and float(r1) == float(
        r4)
    assert i1.dtype == torch.int32 and int(i1) == int(jiters), key
    assert _max_rel(x1.numpy(), jx) < 1e-4, key
    np.testing.assert_allclose(float(r1), float(jres), rtol=0.5)
  # maxiter caps the count, as the JAX loop's condition does.
  _, iters, _ = tit.cg_batched(mv, v, tol=1e-9, maxiter=3)
  assert int(iters) == 3


def test_slq_logdet_matches_jax_with_its_probes(jax_ref, monkeypatch):
  xs = torch.tensor(jax_ref['inputs']['xs'])
  mv = lambda a: tit.kernel_matvec(xs, a, SV, 1.0, row_chunk=CHUNK)
  _inject(monkeypatch, jax_ref['slq_probes'])
  got = tit.slq_logdet(mv, NTOT, torch.Generator(), num_probes=PROBES,
                       lanczos_steps=STEPS)
  np.testing.assert_allclose(float(got), float(jax_ref['slq']), rtol=1e-5)


def test_mll_iterative_matches_jax_with_its_probes(jax_ref, monkeypatch):
  """N = 300 rows padded to 384 (row_chunk 128 does not divide N): the
  value, every gradient leaf and the CG iteration count of return_info,
  for SE and Matern-5/2. Without a key the probes come from a generator
  seeded by the batch: two calls agree, another batch draws others."""
  x, y = (torch.tensor(jax_ref['inputs'][k]) for k in ('x', 'y'))
  for kf, name in KERNELS.items():
    _inject(monkeypatch, *jax_ref['probes'])
    model = convert.model_from_jax(MODEL)
    for leaf in model.values():
      leaf.requires_grad_(True)
    val, info = tit.mll_iterative(
        tmean.constant, tdefs.GPParams(model=model), x, y, warp_func=TWARP,
        cov_func=getattr(tkernel, name), row_chunk=CHUNK,
        num_probes=PROBES, lanczos_steps=STEPS, key=torch.Generator(),
        precond_rank=RANK, return_info=True)
    jval, jiters, jgrads = jax_ref['nll_' + kf]
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-4)
    assert int(info['cg_iters']) == int(jiters), kf
    assert float(info['cg_residual']) < 1e-3
    grads = torch.autograd.grad(val, list(model.values()))
    for (k, want), g in zip(((k, jgrads[k]) for k in model), grads):
      assert _max_rel(g.numpy(), want) < 1e-3, (kf, k)
  monkeypatch.undo()
  kwargs = dict(warp_func=TWARP, cov_func=tkernel.squared_exponential,
                row_chunk=CHUNK, num_probes=PROBES, lanczos_steps=STEPS,
                precond_rank=RANK)
  params = tdefs.GPParams(model=convert.model_from_jax(MODEL))
  a = tit.mll_iterative(tmean.constant, params, x, y, **kwargs)
  b = tit.mll_iterative(tmean.constant, params, x, y, **kwargs)
  c = tit.mll_iterative(tmean.constant, params, x, y + 1e-3, **kwargs)
  assert float(a) == float(b) and math.isfinite(float(c))
  np.testing.assert_allclose(float(a), float(jax_ref['dense']), rtol=0.05)


def test_objective_routes_iterative_mll(jax_ref, monkeypatch):
  """config['iterative_mll'] (True or a kwargs dict) sends the per-task
  NLL through mll_iterative, dot_product falls back to the dense
  pipeline, multi-output data too; GP.train reaches it where the JAX
  package does (the host-loop Adam with pack_tasks False), and the packed
  trainer does not."""
  x, y = (torch.tensor(jax_ref['inputs'][k]) for k in ('x', 'y'))
  dataset = {'a': tdefs.SubDataset(x, y)}
  cfg = {'row_chunk': CHUNK, 'num_probes': PROBES, 'lanczos_steps': STEPS,
         'precond_rank': RANK, 'key': torch.Generator()}
  _inject(monkeypatch, *jax_ref['probes'])
  got = tobj.neg_log_marginal_likelihood(
      tmean.constant, tkernel.squared_exponential,
      tdefs.GPParams(model=convert.model_from_jax(MODEL),
                     config={'iterative_mll': cfg}), dataset,
      warp_func=TWARP)
  np.testing.assert_allclose(float(got), float(jax_ref['nll_' + 'se'][0]),
                             rtol=1e-4)
  monkeypatch.undo()
  calls = []
  real = tit.mll_iterative
  monkeypatch.setattr(tit, 'mll_iterative',
                      lambda *a, **k: calls.append(k) or real(*a, **k))
  model = dict(convert.model_from_jax(MODEL), dot_prod_sigma=torch.tensor(
      0.8), dot_prod_bias=torch.tensor(0.1))
  for flag in (True, cfg):
    dense = tobj.neg_log_marginal_likelihood(
        tmean.constant, tkernel.dot_product, tdefs.GPParams(model=model),
        dataset, warp_func=TWARP)
    routed = tobj.neg_log_marginal_likelihood(
        tmean.constant, tkernel.dot_product,
        tdefs.GPParams(model=model, config={'iterative_mll': flag}),
        dataset, warp_func=TWARP)
    np.testing.assert_allclose(float(routed), float(dense), rtol=1e-6)
  two = {'a': tdefs.SubDataset(x, torch.cat([y, -y], dim=1))}
  tobj.neg_log_marginal_likelihood(
      tmean.constant, tkernel.squared_exponential,
      tdefs.GPParams(model=model, config={'iterative_mll': True}), two,
      warp_func=TWARP)
  assert not calls
  tobj.neg_log_marginal_likelihood(
      tmean.constant, tkernel.squared_exponential,
      tdefs.GPParams(model=model, config={'iterative_mll': True}), dataset,
      warp_func=TWARP)
  assert calls == [{'warp_func': TWARP,
                    'cov_func': tkernel.squared_exponential}]

  # The host loop evaluates once a step and once for its final loss.
  for pack, want in ((False, 4), (True, 0)):
    calls.clear()
    config = {'method': 'adam', 'learning_rate': 0.05,
              'max_training_step': 3, 'batch_size': N,
              'objective': tobj.nll,
              'pack_tasks': pack,
              'iterative_mll': dict(cfg, key=None)}
    losses = []
    gp_model = tgp.GP({'a': (x.numpy(), y.numpy())}, tmean.constant,
                      tkernel.squared_exponential,
                      tdefs.GPParams(model=convert.model_from_jax(MODEL),
                                     config=config), TWARP, device='cpu')
    gp_model.train(torch.Generator().manual_seed(0),
                   callback=lambda s, m, loss: losses.append(float(loss)))
    assert len(calls) == want, pack
    if not pack:
      assert len(losses) == 3 and losses[-1] < losses[0]


def test_predict_iterative_matches_jax(jax_ref):
  """Matern-5/2, 40 queries in chunks of 16: the mean and variance, and
  the mean's gradient in the queries; compute_var=False skips the
  variance."""
  x, y, xq = (torch.tensor(jax_ref['inputs'][k]) for k in ('x', 'y', 'xq'))
  params = tdefs.GPParams(model=convert.model_from_jax(MODEL))
  kwargs = dict(warp_func=TWARP, cov_func=tkernel.matern52, row_chunk=CHUNK,
                cg_tol=1e-7, precond_rank=RANK)
  mu, var, info = tit.predict_iterative(tmean.constant, params, x, y, xq,
                                        query_chunk=16, return_info=True,
                                        **kwargs)
  jmu, jvar = jax_ref['predict']
  assert mu.shape == (40, 1) and var.shape == (40, 1)
  np.testing.assert_allclose(mu.numpy(), jmu, rtol=1e-4, atol=1e-5)
  np.testing.assert_allclose(var.numpy(), jvar, rtol=1e-4, atol=1e-5)
  assert int(info['cg_iters']) > 0
  q = xq.clone().requires_grad_(True)
  mu_only, none = tit.predict_iterative(tmean.constant, params, x, y, q,
                                        compute_var=False, **kwargs)
  assert none is None
  g, = torch.autograd.grad(mu_only.sum(), q)
  np.testing.assert_allclose(g.numpy(), jax_ref['predict_grad'], rtol=1e-4,
                             atol=1e-5)


def test_clamp_row_chunk_under_2gib_tile():
  """The (chunk, n) float32 tile stays under 2^31 bytes, at least 128
  rows: the JAX package's cases."""
  assert tit._clamp_row_chunk(4096, 65536) == 4096
  assert tit._clamp_row_chunk(4096, 131072) == 2048
  assert tit._clamp_row_chunk(4096, 1 << 20) == 256
  assert tit._clamp_row_chunk(1024, 8192) == 1024
  assert tit._clamp_row_chunk(128, 1 << 24) == 128
  for rc, n in ((4096, 65536), (4096, 131072), (4096, 1 << 20), (512, 3000)):
    assert tit._clamp_row_chunk(rc, n) == jit_._clamp_row_chunk(rc, n)
