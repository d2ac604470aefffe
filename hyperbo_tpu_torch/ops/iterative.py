"""Matrix-free GP marginal likelihood for n beyond the O(n^2) wall (port of
hyperbo_tpu/ops/iterative.py).

The direct routes build the n x n Gram matrix: 4 GB at n = 32768, 64 GB at
n = 131072. This module estimates the same NLL with O(n) memory, in the
style of GPyTorch's BBMM:

  * `kernel_matvec`: (K + da I) @ V without K, over row chunks; each
    chunk's (chunk, n) tile is one rank-d product plus the kernel's
    transform, against all columns of V at once, so CG's and SLQ's probes
    share one pass. When a gradient is asked for, each chunk runs under
    torch.utils.checkpoint: its backward builds the tile again, and no
    tile outlives its chunk.
  * `cg_batched`: batched (preconditioned) conjugate gradients, all
    right-hand sides together, stopping at the JAX package's iteration.
  * `slq_logdet`: stochastic Lanczos quadrature with Rademacher probes.
  * `mll_iterative`: 0.5 delta^T K^{-1} delta (CG) + 0.5 logdet (SLQ) +
    the constant, with the surrogate terms that give its gradient.
  * `predict_iterative`: the posterior mean and variance by CG.

Every product is a plain torch.matmul in float32 (the package pins TF32
off); no hand-written kernel runs here, as the JAX package computes these
outside any Pallas kernel.

CG reads the device once every CG_CHECK_EVERY iterations: between reads
it keeps iterating, each update a torch.where no-op once every column
converged, so the iteration count and the solution are the ones of the
JAX package's while_loop. Probes come from a torch.Generator through
`_draw_rademacher`, the one place they are drawn, so that a test can
substitute the JAX package's draws.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.utils import checkpoint

from hyperbo_tpu_torch.core.warp import retrieve_params
from hyperbo_tpu_torch.ops import fused_mll
from hyperbo_tpu_torch.ops.mll_bwd import _km_nm

# CG iterations between two reads of the "every column converged" flag.
CG_CHECK_EVERY = 4
# The probe generator's seed when no key is given: the JAX package's
# PRNGKey(20260817), folded with the bits of the float32 sum of delta.
_PROBE_SEED = 20260817


def _draw_rademacher(generator: torch.Generator, shape,
                     device) -> torch.Tensor:
  """Rademacher (+-1) float32 probes of `shape`."""
  bits = torch.randint(2, shape, generator=generator,
                       device=generator.device)
  return (2.0 * bits - 1.0).to(device=device, dtype=torch.float32)


def _clamp_row_chunk(row_chunk: int, n: int) -> int:
  """Halve row_chunk until the (chunk, n) float32 tile stays under 2^31
  bytes (at least 128 rows). The tile is the largest buffer a chunk
  makes; the clamp bounds the memory of one chunk and keeps every tile's
  byte offsets within int32. Shrinking the chunk only adds chunks."""
  while row_chunk > 128 and row_chunk * n * 4 >= 2**31:
    row_chunk //= 2
  return row_chunk


def _chunk_tile(xb, sb, xs, sqn, sv, kfam: str, row0: int):
  """sv k(|x_i - x_j|^2) for the chunk's rows i against every row j, with
  the chunk's own diagonal zeroed (the caller adds the exact k(0) = sv).

  The self-distance computes as (big - big), whose float32 cancellation
  could put k(0) anywhere in [0, sv] for rows of large norm (the padding
  sentinels), so r2 is pinned to 1 there before the transform and the
  entry zeroed after it: pinned before, the Matern square root's infinite
  slope at 0 never meets the masked entries' zero cotangent.
  """
  r2 = torch.addmm(sb + sqn.T, xb, xs.T, alpha=-2.0)
  rows = xb.shape[0]
  if r2.requires_grad or (torch.is_grad_enabled() and sv.requires_grad):
    diag = (torch.arange(rows, device=xs.device)[:, None] + row0 ==
            torch.arange(xs.shape[0], device=xs.device)[None, :])
    km, _ = _km_nm(torch.clamp(torch.where(diag, 1.0, r2), min=0.0), sv,
                   kfam)
    return torch.where(diag, 0.0, km)
  # No gradient: the same values, written in place.
  r2[:, row0:row0 + rows].diagonal().fill_(1.0)
  km, _ = _km_nm(r2.clamp_(min=0.0), sv, kfam)
  km[:, row0:row0 + rows].diagonal().zero_()
  return km


def _chunk_matvec(xb, sb, xs, sqn, v, sv, kfam: str, row0: int):
  return torch.matmul(_chunk_tile(xb, sb, xs, sqn, sv, kfam, row0), v)


def kernel_matvec(x_scaled: torch.Tensor, v: torch.Tensor, sv, da,
                  kfam: str = 'se', row_chunk: int = 1024) -> torch.Tensor:
  """(K + da I) @ V with K = sv k_fam(|x_i - x_j|^2), O(chunk n) memory.

  x_scaled: (n, d) length-scaled inputs; v: (n, m) right-hand sides. n
  must divide by row_chunk (mll_iterative pads). Differentiable in
  x_scaled, v, sv and da; each chunk's tile is then rebuilt in backward.
  """
  n, _ = x_scaled.shape
  assert n % row_chunk == 0, (n, row_chunk)
  xs = x_scaled.to(torch.float32)
  vv = v.to(torch.float32)
  sv = torch.as_tensor(sv, dtype=torch.float32, device=xs.device)
  da = torch.as_tensor(da, dtype=torch.float32, device=xs.device)
  sqn = torch.sum(xs * xs, dim=1, keepdim=True)
  grad = torch.is_grad_enabled() and any(
      t.requires_grad for t in (xs, vv, sv))
  outs = []
  for row0 in range(0, n, row_chunk):
    args = (xs[row0:row0 + row_chunk], sqn[row0:row0 + row_chunk], xs, sqn,
            vv, sv, kfam, row0)
    outs.append(checkpoint.checkpoint(_chunk_matvec, *args,
                                      use_reentrant=False)
                if grad else _chunk_matvec(*args))
  return torch.cat(outs, dim=0) + (sv + da) * vv


def partial_pivoted_cholesky(x_scaled: torch.Tensor, sv, kfam: str,
                             rank: int) -> torch.Tensor:
  """Rank-k pivoted partial Cholesky L (n, k) of K, matrix-free, O(nk)
  memory: greedy on the largest residual diagonal, one kernel row a step.
  K ~ L L^T; the CG preconditioner of GP systems with a small ridge
  (GPyTorch). The pivot stays a device tensor: nothing is read back."""
  xs = x_scaled.to(torch.float32)
  n = xs.shape[0]
  sv = torch.as_tensor(sv, dtype=torch.float32, device=xs.device)
  sqn = torch.sum(xs * xs, dim=1)
  lmat = xs.new_zeros((n, rank))
  dvec = sv.expand(n).clone()
  for j in range(rank):
    i = torch.argmax(dvec).reshape(1)
    xi = xs.index_select(0, i)                              # (1, d)
    r2 = torch.sum(xi * xi) + sqn - 2.0 * torch.matmul(xs, xi.T)[:, 0]
    km, _ = _km_nm(torch.clamp(r2, min=0.0), sv, kfam)
    # The exact k(0) on the pivot's own entry.
    km = km.index_put((i,), sv.reshape(1))
    li = lmat.index_select(0, i)                            # (1, k)
    col = km - torch.matmul(lmat, li.T)[:, 0]
    col = col / torch.sqrt(torch.clamp(dvec.index_select(0, i), min=1e-12))
    lmat[:, j] = col
    dvec = torch.clamp(dvec - col * col, min=0.0)
  return lmat


def woodbury_inverse_apply(lmat: torch.Tensor, da):
  """v -> (L L^T + da I)^{-1} v by the Woodbury identity: the k x k core
  factored once, each application two (n, k) products."""
  k = lmat.shape[1]
  da = torch.as_tensor(da, dtype=torch.float32, device=lmat.device)
  core = da * torch.eye(k, device=lmat.device) + torch.matmul(lmat.T, lmat)
  chol = torch.linalg.cholesky_ex(core).L

  def apply(v):
    sol = torch.cholesky_solve(torch.matmul(lmat.T, v), chol)
    return (v - torch.matmul(lmat, sol)) / da

  return apply


def cg_batched(matvec: Callable[[torch.Tensor], torch.Tensor],
               b: torch.Tensor, tol: float = 1e-6, maxiter: int = 1000,
               precond: Optional[Callable[[torch.Tensor],
                                          torch.Tensor]] = None):
  """Batched CG: solve A X = B for SPD A, all columns together.

  Returns (X, iterations, max final residual norm), the last two 0-d
  tensors. Iterates while some column's residual norm is above
  tol * |b_col| and fewer than maxiter iterations ran, as the JAX
  package's while_loop. The flag is computed on the device each
  iteration; once it is off the updates are torch.where no-ops, and the
  host reads it once every CG_CHECK_EVERY iterations. With `precond`
  (v -> M^{-1} v for an SPD M ~ A) the CG is preconditioned: the same
  fixed point in fewer iterations when A is ill-conditioned.
  """
  pinv = precond if precond is not None else (lambda v: v)
  bnorm = torch.sqrt(torch.sum(b * b, dim=0, keepdim=True))
  thresh = tol * torch.clamp(bnorm, min=1e-30)

  def running(r, i):
    rn = torch.sqrt(torch.sum(r * r, dim=0, keepdim=True))
    return (i < maxiter) & torch.any(rn > thresh)

  x = torch.zeros_like(b)
  r = b
  p = pinv(b)
  rz = torch.sum(b * p, dim=0, keepdim=True)
  iters = torch.zeros((), dtype=torch.int32, device=b.device)
  go = running(r, iters)
  for step in range(maxiter):
    if step % CG_CHECK_EVERY == 0 and not bool(go):
      break
    ap = matvec(p)
    alpha = rz / torch.clamp(torch.sum(p * ap, dim=0, keepdim=True),
                             min=1e-30)
    x_new = x + alpha * p
    r_new = r - alpha * ap
    z = pinv(r_new)
    rz_new = torch.sum(r_new * z, dim=0, keepdim=True)
    p_new = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
    x = torch.where(go, x_new, x)
    r = torch.where(go, r_new, r)
    p = torch.where(go, p_new, p)
    rz = torch.where(go, rz_new, rz)
    iters = iters + go.to(torch.int32)
    go = running(r, iters)
  return x, iters, torch.max(torch.sqrt(torch.sum(r * r, dim=0)))


def slq_logdet(matvec: Callable[[torch.Tensor], torch.Tensor], n: int,
               generator: torch.Generator, num_probes: int = 16,
               lanczos_steps: int = 32, device=None) -> torch.Tensor:
  """log det A for SPD A by stochastic Lanczos quadrature.

  E_z[z^T log(A) z] = tr log A = logdet A for Rademacher probes z (drawn
  from `generator` onto `device`, the generator's by default); each
  quadratic form comes from k Lanczos steps' tridiagonal
  eigendecomposition (Golub-Welsch), all probes through one matvec a
  step. Each step reorthogonalizes once against the two live vectors.
  """
  if device is None:
    device = generator.device
  z = _draw_rademacher(generator, (n, num_probes), device)
  znorm = torch.sqrt(torch.sum(z * z, dim=0))
  q_prev = torch.zeros_like(z)
  q = z / znorm
  beta_prev = z.new_zeros((num_probes,))
  alphas, betas = [], []
  for _ in range(lanczos_steps):
    w = matvec(q) - beta_prev * q_prev
    alpha = torch.sum(q * w, dim=0)
    w = w - alpha * q
    w = w - torch.sum(w * q, dim=0) * q
    w = w - torch.sum(w * q_prev, dim=0) * q_prev
    beta = torch.sqrt(torch.clamp(torch.sum(w * w, dim=0), min=1e-30))
    q_prev, q, beta_prev = q, w / beta, beta
    alphas.append(alpha)
    betas.append(beta)
  diag = torch.stack(alphas, dim=1)                         # (m, k)
  off = torch.stack(betas, dim=1)[:, :-1]                   # (m, k-1)
  tmat = (torch.diag_embed(diag) + torch.diag_embed(off, offset=1) +
          torch.diag_embed(off, offset=-1))
  evals, evecs = torch.linalg.eigh(tmat)                    # (m, k, k)
  w0 = evecs[:, 0, :] ** 2
  quad = torch.sum(w0 * torch.log(torch.clamp(evals, min=1e-30)), dim=1)
  return torch.mean(quad * znorm ** 2)


def _scaled_inputs(params, x, cov_func, warp_func, lengthscale):
  emb = fused_mll._se_embed(params, x, cov_func, warp_func)
  return (emb / lengthscale).to(torch.float32)


def _sentinels(base, pad: int, spacing: float, d: int):
  """`pad` rows beyond the data, `spacing` apart from it and each other
  in every dimension: every kernel entry they touch off the diagonal is
  k(r2 >= spacing^2) ~ 0 in float32, even for the Matern decay."""
  far = base + spacing * (1.0 + torch.arange(pad, dtype=torch.float32,
                                             device=base.device))
  return far.reshape(-1, 1).expand(pad, d)


def _probe_generator(delta: torch.Tensor) -> torch.Generator:
  """The probes' generator when no key is given, seeded from the bits of
  the float32 sum of delta: a fixed seed would make the estimator's
  error a constant bias over training steps; this one redraws the probes
  whenever the batch changes."""
  bits = torch.sum(delta.detach(), dtype=torch.float32).reshape(1).view(
      torch.int32)
  seed = int(bits.item()) & 0xffffffff
  return torch.Generator(device=delta.device).manual_seed(
      (_PROBE_SEED << 32) | seed)


def mll_iterative(mean_func, params, x, y, warp_func=None, eps: float = 1e-6,
                  cov_func=None, row_chunk: int = 1024,
                  cg_tol: float = 1e-5, cg_maxiter: int = 1000,
                  num_probes: int = 16, lanczos_steps: int = 32,
                  key: Optional[torch.Generator] = None,
                  precond_rank: int = 128,
                  return_info: bool = False):
  """O(n)-memory NLL estimate of one task: CG quad term + SLQ logdet.

  The parameterization of ops/fused_mll.se_nll_fused: warped params, the
  SE and Matern families raw or over the MLP/Kumar embeddings, diagonal
  add = warped noise_variance + eps. An n that row_chunk does not divide
  is padded with sentinel rows (diagonal sv + da, delta 0), whose logdet
  pad log(sv + da) is taken back out analytically.

  Differentiable by the matrix-free construction (GPyTorch/BBMM): CG and
  Lanczos run without gradient, and one differentiable kernel_matvec
  carries the surrogates

    d(delta^T K^{-1} delta) = 2 alpha^T d(delta) - alpha^T dK alpha,
    d(logdet K) = tr(K^{-1} dK) ~ mean_z (K^{-1} z)^T dK z,

  with alpha = K^{-1} delta and the Hutchinson probes z solved in the same
  CG call. The value is delta^T alpha + the SLQ logdet.

  `key` is a torch.Generator for the probes (Hutchinson's first, then
  SLQ's); without one a generator is seeded from the batch (one read of
  the device). precond_rank > 0 preconditions CG with a rank-k pivoted
  Cholesky (Woodbury apply); 0 turns it off. With return_info also
  returns {'cg_iters', 'cg_residual'}: CG at cg_maxiter without reaching
  cg_tol means the quad term and its gradient did not converge.
  """
  lengthscale, signal_variance, noise_variance = retrieve_params(
      params, ['lengthscale', 'signal_variance', 'noise_variance'],
      warp_func=warp_func)
  n = x.shape[0]
  mu = mean_func(params, x, warp_func=warp_func)
  y2 = torch.as_tensor(y, dtype=torch.float32).reshape(n, -1)
  assert y2.shape[1] == 1, ('mll_iterative expects a single task; got y '
                            f'of shape {tuple(y.shape)}')
  delta = (y2 - torch.atleast_2d(mu)).to(torch.float32)
  xs = _scaled_inputs(params, x, cov_func, warp_func, lengthscale)
  # Centered: distances are unchanged, the norms whose difference the
  # product form computes shrink.
  xs = xs - torch.mean(xs, dim=0, keepdim=True).detach()
  kfam = fused_mll.kernel_family(cov_func)
  sv = torch.squeeze(signal_variance)
  da = torch.squeeze(noise_variance) + eps

  row_chunk = _clamp_row_chunk(row_chunk, n)
  pad = (-n) % row_chunk
  if pad:
    far = _sentinels(torch.max(torch.abs(xs)).detach(), pad, 30.0,
                     xs.shape[1])
    xs = torch.cat([xs, far], dim=0)
    delta = torch.cat([delta, delta.new_zeros((pad, delta.shape[1]))])
  ntot = xs.shape[0]
  generator = key if key is not None else _probe_generator(delta)

  xs_sg, sv_sg, da_sg = xs.detach(), sv.detach(), da.detach()

  def mv_sg(v):
    return kernel_matvec(xs_sg, v, sv_sg, da_sg, kfam=kfam,
                         row_chunk=row_chunk)

  z = _draw_rademacher(generator, (ntot, num_probes), xs.device)
  with torch.no_grad():
    precond = None
    if precond_rank > 0:
      precond = woodbury_inverse_apply(
          partial_pivoted_cholesky(xs_sg, sv_sg, kfam, precond_rank), da_sg)
    solves, cg_iters, cg_res = cg_batched(
        mv_sg, torch.cat([delta.detach(), z], dim=1), tol=cg_tol,
        maxiter=cg_maxiter, precond=precond)
  alpha = solves[:, :1]                                     # K^{-1} delta
  w = solves[:, 1:]                                         # K^{-1} z

  # One differentiable kernel application serves both surrogates.
  k_app = kernel_matvec(xs, torch.cat([alpha, z], dim=1), sv, da, kfam=kfam,
                        row_chunk=row_chunk)
  quad = 2.0 * torch.sum(delta * alpha) - torch.sum(alpha * k_app[:, :1])
  with torch.no_grad():
    ld_val = slq_logdet(mv_sg, ntot, generator, num_probes=num_probes,
                        lanczos_steps=lanczos_steps, device=xs.device)
  trace_sur = torch.mean(torch.sum(w * k_app[:, 1:], dim=0))
  ld = ld_val + trace_sur - trace_sur.detach()
  if pad:
    ld = ld - pad * torch.log(sv + da)
  nll = 0.5 * quad + 0.5 * ld + 0.5 * n * math.log(2 * math.pi)
  if return_info:
    return nll, {'cg_iters': cg_iters, 'cg_residual': cg_res}
  return nll


def _cross_kernel(xq: torch.Tensor, xo: torch.Tensor, sv,
                  kfam: str) -> torch.Tensor:
  """K(xq, xo) as one (nq, n) block (callers chunk nq)."""
  sq = torch.sum(xq * xq, dim=1, keepdim=True)
  so = torch.sum(xo * xo, dim=1, keepdim=True)
  r2 = torch.clamp(torch.addmm(sq + so.T, xq, xo.T, alpha=-2.0), min=0.0)
  km, _ = _km_nm(r2, sv, kfam)
  return km


def predict_iterative(mean_func, params, x_obs, y_obs, x_query,
                      warp_func=None, cov_func=None, eps: float = 1e-6,
                      row_chunk: int = 1024, query_chunk: int = 256,
                      cg_tol: float = 1e-5, cg_maxiter: int = 1000,
                      precond_rank: int = 128, compute_var: bool = True,
                      return_info: bool = False):
  """Matrix-free GP posterior for n beyond the O(n^2) memory wall:

    mu  = K_qo (K + da I)^{-1} delta + m(x_q)       one batched CG,
    var = k(0) - diag(K_qo (K + da I)^{-1} K_oq)    one CG a query chunk,

  with mll_iterative's parameterization. The variance is the latent one
  (the caller adds the noise and any task rescale, as GP.predict does).
  mu is differentiable in x_query (alpha is a constant); var is not.
  Observation rows are padded as in mll_iterative, query chunks with
  sentinels 90 apart (an in-distribution padding row would make its CG
  column converge for nothing).

  Returns (mu (nq, 1), var (nq, 1) or None with compute_var=False), and
  with return_info also the mean solve's {'cg_iters', 'cg_residual'}.
  """
  lengthscale, signal_variance, noise_variance = retrieve_params(
      params, ['lengthscale', 'signal_variance', 'noise_variance'],
      warp_func=warp_func)
  n = x_obs.shape[0]
  nq = x_query.shape[0]
  mu_obs = mean_func(params, x_obs, warp_func=warp_func)
  mu_query = mean_func(params, x_query, warp_func=warp_func)
  delta = (torch.as_tensor(y_obs, dtype=torch.float32).reshape(n, -1) -
           torch.atleast_2d(mu_obs)).to(torch.float32)
  assert delta.shape[1] == 1, 'predict_iterative expects a single task'
  xo = _scaled_inputs(params, x_obs, cov_func, warp_func, lengthscale)
  xq = _scaled_inputs(params, x_query, cov_func, warp_func, lengthscale)
  # One shared shift: translation-invariant distances, smaller norms.
  shift = torch.mean(xo, dim=0, keepdim=True).detach()
  xo = xo - shift
  xq = xq - shift
  kfam = fused_mll.kernel_family(cov_func)
  sv = torch.squeeze(signal_variance)
  da = torch.squeeze(noise_variance) + eps

  row_chunk = _clamp_row_chunk(row_chunk, n)
  pad = (-n) % row_chunk

  def base():
    return torch.maximum(torch.max(torch.abs(xo)),
                         torch.max(torch.abs(xq))).detach()

  if pad:
    xo = torch.cat([xo, _sentinels(base(), pad, 30.0, xo.shape[1])], dim=0)
    delta = torch.cat([delta, delta.new_zeros((pad, 1))], dim=0)
  xo_sg, sv_sg, da_sg = xo.detach(), sv.detach(), da.detach()

  def mv(v):
    return kernel_matvec(xo_sg, v, sv_sg, da_sg, kfam=kfam,
                         row_chunk=row_chunk)

  with torch.no_grad():
    precond = None
    if precond_rank > 0:
      precond = woodbury_inverse_apply(
          partial_pivoted_cholesky(xo_sg, sv_sg, kfam, precond_rank), da_sg)
    alpha, cg_iters, cg_res = cg_batched(mv, delta.detach(), tol=cg_tol,
                                         maxiter=cg_maxiter, precond=precond)

  # A single-query call does not pay a (n, 256) variance CG: the chunk is
  # capped at nq rounded up to 8.
  query_chunk = min(query_chunk, max(8, -(-nq // 8) * 8))
  padq = (-nq) % query_chunk
  if padq:
    # Beyond the padded observations too.
    xq = torch.cat([xq, _sentinels(base(), padq, 90.0, xq.shape[1])], dim=0)
  mu_parts, var_parts = [], []
  for q0 in range(0, xq.shape[0], query_chunk):
    kq = _cross_kernel(xq[q0:q0 + query_chunk], xo, sv, kfam)
    mu_parts.append(torch.matmul(kq, alpha))
    if compute_var:
      with torch.no_grad():
        kxq = kq.detach().T
        sol, _, _ = cg_batched(mv, kxq, tol=cg_tol, maxiter=cg_maxiter,
                               precond=precond)
        var_parts.append(torch.clamp(sv_sg - torch.sum(kxq * sol, dim=0),
                                     min=1e-12))
  mu = (torch.cat(mu_parts, dim=0)[:nq] +
        torch.atleast_2d(mu_query).reshape(nq, -1))
  var = (torch.cat(var_parts).reshape(-1, 1)[:nq] if compute_var else None)
  if return_info:
    return mu, var, {'cg_iters': cg_iters, 'cg_residual': cg_res}
  return mu, var
