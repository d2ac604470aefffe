"""Quasi-Newton optimizers for GP hyperparameter fitting (port of
hyperbo_tpu/train/optimizers.py).

`lbfgs` works on one flat float32 vector (the model raveled in
jax.flatten_util order, train/slice_sampler.ravel_model), with the JAX
package's two-loop recursion (`_two_loop`), two-sided backtracking line
search (`_line_search`, Armijo + Wolfe curvature, with the max-steps
fallback that returns the alpha it evaluated at), the curvature-violating
pair kept out of the warm-start state, and its (value, params, state)
contract. `lbfgs_descent_dir_nocedal` and `backtracking_linesearch` are the
same over dict trees.

`bfgs` is this package's own BFGS with the algorithm the JAX package runs
through jax.scipy.optimize.minimize(method='bfgs'): the inverse-Hessian
update (Nocedal and Wright, Algorithm 6.1; the update skipped where
1 / y.s is not finite), the strong-Wolfe line search with its zoom
(Algorithm 3.5 and 3.6: cubic, quadratic or bisection trial steps; at most
`line_search_maxiter` expansions, 30 zoom trips, an interval under 1e-5
fails) and the stop at |g|_inf < gtol. As there, `tol` does not reach the
solver (jax.scipy's minimize does not pass it on): gtol is 1e-5. The
scalar arithmetic of the line search runs in float32 on the host, as the
JAX version's does in its while_loop; each objective evaluation reads its
value, its directional derivative and its gradient's inf-norm back in one
transfer (ROADMAP Queue C).

Objectives are called on dicts of tensors on the device of the initial
parameters, so a fused_mll objective runs kernels K2-K4 (or K8) on the
card.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hyperbo_tpu_torch.train import slice_sampler


def _value_and_grad_flat(fn, unravel):
  """v -> (fn(unravel(v)), its gradient), both detached; a coordinate the
  objective does not reach gets a zero gradient."""

  def vg(v):
    v = v.detach().requires_grad_(True)
    with torch.enable_grad():
      f = fn(unravel(v))
      g, = torch.autograd.grad(f, v, allow_unused=True)
    if g is None:
      g = torch.zeros_like(v)
    return f.detach(), g.detach()

  return vg


def _dot(a, b) -> float:
  return float(torch.dot(a, b))


def _line_search(val_and_grad, f0, x, g, direction, alpha,
                 c1=1e-4, c2=0.9, tau=0.5, max_steps=50):
  """Two-sided backtracking line search (Armijo + Wolfe curvature).

  Expands the step (x2.1) while Armijo holds but curvature fails, shrinks
  (x tau) otherwise. Returns (f_new, g_new, alpha) for the accepted step,
  after max_steps the last finite evaluation with the alpha it was
  evaluated at, or (None, None, 0.) if no finite progress was found.
  """
  gd = _dot(g, direction)
  if gd > 0.:
    logging.info('Not a descent direction (g.d = %f); skipping line search.',
                 gd)
    return None, None, 0.
  t = c1 * gd
  f_new, g_new = None, None
  last_alpha = 0.
  for _ in range(max_steps):
    f_new, g_new = val_and_grad(x + alpha * direction)
    last_alpha = alpha
    f_val = float(f_new)
    if np.isfinite(f_val) and f_val <= float(f0) + alpha * t:
      if _dot(g_new, direction) >= c2 * gd:
        return f_new, g_new, alpha
      alpha *= 2.1
    else:
      alpha *= tau
  if f_new is not None and np.isfinite(float(f_new)):
    return f_new, g_new, last_alpha
  return None, None, 0.


def _two_loop(g, s_list, y_list):
  """Nocedal two-loop recursion for the L-BFGS descent direction."""
  q = -g
  alphas = []
  rhos = [1.0 / _dot(y, s) for s, y in zip(s_list, y_list)]
  for s, y, rho in reversed(list(zip(s_list, y_list, rhos))):
    a = rho * _dot(s, q)
    alphas.append(a)
    q = q - a * y
  alphas.reverse()
  gamma = float(torch.dot(s_list[-1], y_list[-1]) /
                torch.dot(y_list[-1], y_list[-1]))
  r = gamma * q
  for s, y, rho, a in zip(s_list, y_list, rhos, alphas):
    b = rho * _dot(y, r)
    r = r + (a - b) * s
  return r


def lbfgs(fn: Callable[[Dict[str, Any]], torch.Tensor],
          params: Dict[str, Any],
          memory: int = 10,
          ls_steps: int = 50,
          steps: int = 100,
          alpha: float = 1.,
          tol: float = 1e-6,
          ls_tau: float = 0.5,
          callback: Optional[Callable[..., Any]] = None,
          state: Optional[Tuple] = None):
  """Minimize fn over a dict of parameters with L-BFGS.

  Returns (value, params, state): the final objective value, the
  optimized parameters, and the state (s and y histories, last g and x,
  flat) that warm-starts a later call (None when converged at the start).
  """
  x0, unravel = slice_sampler.ravel_model(params, _device_of(params))
  vg = _value_and_grad_flat(fn, unravel)

  if state is None:
    s_hist, y_hist = [], []
    f, g = vg(x0)
    if callback is not None:
      callback(step=0, model_params=unravel(x0), loss=f)
    gnorm = _dot(g, g)
    if gnorm <= tol:
      logging.info('L-BFGS converged at start.')
      return f, unravel(x0), None
    # First step: steepest descent with a |g|-normalized initial step.
    direction = -g
    f_new, g_new, step_size = _line_search(
        vg, f, x0, g, direction, 1.0 / np.sqrt(gnorm),
        tau=ls_tau, max_steps=ls_steps)
    if f_new is None or float(f_new) >= float(f):
      logging.info('L-BFGS: initial line search made no progress.')
      return f, unravel(x0), (s_hist, y_hist, g, x0)
    x_prev, g_prev = x0, g
    x = x0 + step_size * direction
  else:
    s_hist, y_hist, g_prev, x_prev = state
    s_hist, y_hist = list(s_hist), list(y_hist)
    x = x0
    f_new = None

  val = f_new
  for i in range(1, steps + 1):
    f, g = vg(x)
    val = f
    gnorm = _dot(g, g)
    if gnorm <= tol:
      logging.info('L-BFGS converged in %d steps.', i)
      break
    s_new = x - x_prev
    y_new = g - g_prev
    curvature = _dot(y_new, s_new)
    logging.info('L-BFGS step %d val: %f', i, float(f))
    if callback is not None:
      callback(step=i, model_params=unravel(x), loss=f)
    if not np.isfinite(curvature) or curvature < tol:
      # The curvature-violating pair stays out of the warm-start state:
      # its rho = 1 / (y.s) would poison the first resumed direction.
      logging.info('L-BFGS terminating: curvature condition failed.')
      break
    s_hist.append(s_new)
    y_hist.append(y_new)
    if len(s_hist) > memory:
      s_hist = s_hist[-memory:]
      y_hist = y_hist[-memory:]
    x_prev, g_prev = x, g
    direction = _two_loop(g, s_hist, y_hist)
    f_new, g_new, step_size = _line_search(
        vg, f, x, g, direction, alpha, tau=ls_tau, max_steps=ls_steps)
    if f_new is None or float(f_new) >= float(f):
      logging.info('L-BFGS: line search made no progress at step %d.', i)
      break
    x = x + step_size * direction
    val = f_new

  return val, unravel(x), (s_hist, y_hist, g_prev, x_prev)


def _device_of(tree):
  """The device of the first tensor leaf of a dict tree (None if none)."""
  if isinstance(tree, dict):
    for v in tree.values():
      dev = _device_of(v)
      if dev is not None:
        return dev
    return None
  return tree.device if torch.is_tensor(tree) else None


def lbfgs_descent_dir_nocedal(grads, s, y):
  """The two-loop recursion over dict trees (histories s, y of trees)."""
  device = _device_of(grads)
  ravel = slice_sampler.ravel_model
  g_flat, unravel = ravel(grads, device)
  return unravel(_two_loop(g_flat, [ravel(si, device)[0] for si in s],
                           [ravel(yi, device)[0] for yi in y]))


def backtracking_linesearch(val_and_grad_fn, cur_val, params, grads,
                            direction, alpha=1., c1=1e-4, c2=0.9,
                            tau=0.5, max_steps=50, has_aux=False,
                            args=tuple()):
  """Two-sided Armijo + Wolfe backtracking over dict trees.

  `val_and_grad_fn(params, *args)` returns (value, grads) (value a tuple
  whose first entry is the objective with has_aux). Returns (new_val,
  alpha): the accepted value and step, after max_steps the last finite
  value with the alpha it was evaluated at, or (cur_val, 0.) where the
  direction is not a descent direction or no finite progress was found.
  """
  device = _device_of(params)
  g_flat, _ = slice_sampler.ravel_model(grads, device)
  d_flat, _ = slice_sampler.ravel_model(direction, device)
  gd = _dot(g_flat, d_flat)
  if gd > 0.:
    logging.info('Not a descent direction; exiting linesearch.')
    return cur_val, 0.
  t = c1 * gd
  new_val = None
  last_alpha = 0.
  for _ in range(max_steps):
    new_params = _tree_axpy(alpha, direction, params)
    new_val, new_grads = val_and_grad_fn(new_params, *args)
    if has_aux:
      new_val = new_val[0]
    last_alpha = alpha
    f_val = float(new_val)
    if np.isfinite(f_val) and f_val <= float(cur_val) + alpha * t:
      if _dot(slice_sampler.ravel_model(new_grads, device)[0],
              d_flat) >= c2 * gd:
        return new_val, alpha
      alpha *= 2.1
    else:
      alpha *= tau
  if new_val is not None and np.isfinite(float(new_val)):
    return new_val, last_alpha
  return cur_val, 0.


def _tree_axpy(alpha, d, p):
  """p + d * alpha leaf by leaf."""
  if isinstance(p, dict):
    return {k: _tree_axpy(alpha, d[k], p[k]) for k in p}
  return p + d * alpha


# BFGS (jax.scipy.optimize.minimize(method='bfgs')'s algorithm).

_F32 = np.float32


class _Eval(NamedTuple):
  """One objective evaluation on the line x + t p: the value and the
  directional derivative as float32 host scalars, the gradient on the
  device, and its inf-norm."""
  phi: np.float32
  dphi: np.float32
  g: torch.Tensor
  ginf: np.float32


def _evaluator(vg, xk, pk):
  def restricted(t):
    phi, g = vg(xk + torch.tensor(t, dtype=pk.dtype, device=pk.device) * pk)
    phi, dphi, ginf = torch.stack(
        [phi.reshape(()), torch.dot(g, pk),
         torch.linalg.vector_norm(g, ord=float('inf'))]).tolist()
    return _Eval(_F32(phi), _F32(dphi), g, _F32(ginf))

  return restricted


def _cubicmin(a, fa, fpa, b, fb, c, fc):
  C = fpa
  db = b - a
  dc = c - a
  denom = (db * dc)**2 * (db - dc)
  d1 = np.array([[dc**2, -db**2], [-dc**3, db**3]], dtype=_F32)
  d2 = np.array([fb - fa - C * db, fc - fa - C * dc], dtype=_F32)
  A, B = (d1 @ d2) / denom
  radical = B * B - _F32(3.) * A * C
  return a + (-B + np.sqrt(radical)) / (_F32(3.) * A)


def _quadmin(a, fa, fpa, b, fb):
  D = fa
  C = fpa
  db = b - a
  B = (fb - D - C * db) / (db**2)
  return a - C / (_F32(2.) * B)


class _LineSearchResult(NamedTuple):
  failed: bool
  a_k: np.float32
  f_k: np.float32
  g_k: torch.Tensor
  ginf: np.float32
  nfev: int


def _zoom(restricted, wolfe_one, wolfe_two, a_lo, phi_lo, dphi_lo, a_hi,
          phi_hi, dphi_hi, g_0, ginf_0):
  """Algorithm 3.6 as jax.scipy's _zoom runs it: returns (failed, a_star,
  phi_star, dphi_star, g_star, ginf_star, nfev)."""
  a_rec = (a_lo + a_hi) / _F32(2.)
  phi_rec = (phi_lo + phi_hi) / _F32(2.)
  a_star, phi_star, dphi_star, g_star, ginf_star = (
      _F32(1.), phi_lo, dphi_lo, g_0, ginf_0)
  done = failed = False
  j = nfev = 0
  delta1, delta2 = _F32(0.2), _F32(0.1)
  with np.errstate(all='ignore'):
    while not done and not failed:
      dalpha = a_hi - a_lo
      a = min(a_hi, a_lo)
      b = max(a_hi, a_lo)
      cchk = delta1 * dalpha
      qchk = delta2 * dalpha
      # The trip still runs; the interval test ends the loop after it.
      failed = failed or bool(dalpha <= _F32(1e-5))
      a_j_cubic = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec,
                            phi_rec)
      use_cubic = (j > 0) and a_j_cubic > a + cchk and a_j_cubic < b - cchk
      a_j_quad = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
      use_quad = (not use_cubic and a_j_quad > a + qchk and
                  a_j_quad < b - qchk)
      if use_cubic:
        a_j = a_j_cubic
      elif use_quad:
        a_j = a_j_quad
      else:
        a_j = (a_lo + a_hi) / _F32(2.)
      ev = restricted(a_j)
      nfev += 1
      hi_to_j = wolfe_one(a_j, ev.phi) or ev.phi >= phi_lo
      star_to_j = wolfe_two(ev.dphi) and not hi_to_j
      hi_to_lo = (ev.dphi * (a_hi - a_lo) >= 0. and not hi_to_j and
                  not star_to_j)
      lo_to_j = not hi_to_j and not star_to_j
      if hi_to_j:
        a_rec, phi_rec = a_hi, phi_hi
        a_hi, phi_hi, dphi_hi = a_j, ev.phi, ev.dphi
      if star_to_j:
        done = True
        a_star, phi_star, dphi_star, g_star, ginf_star = (
            a_j, ev.phi, ev.dphi, ev.g, ev.ginf)
      if hi_to_lo:
        a_rec, phi_rec = a_hi, phi_hi
        a_hi, phi_hi, dphi_hi = a_lo, phi_lo, dphi_lo
      if lo_to_j and not hi_to_lo:
        a_rec, phi_rec = a_lo, phi_lo
      if lo_to_j:
        a_lo, phi_lo, dphi_lo = a_j, ev.phi, ev.dphi
      j += 1
      failed = failed or j >= 30
  return failed, a_star, phi_star, dphi_star, g_star, ginf_star, nfev


def _strong_wolfe(vg, xk, pk, old_fval, old_old_fval, gfk, ginf_k,
                  c1=1e-4, c2=0.9, maxiter=10) -> _LineSearchResult:
  """jax.scipy's line_search (Algorithm 3.5) from a known value and
  gradient: doubling steps, then a zoom of the bracketing interval."""
  restricted = _evaluator(vg, xk, pk)
  phi_0 = old_fval
  dphi_0 = _F32(_dot(gfk, pk))
  c1, c2 = _F32(c1), _F32(c2)
  with np.errstate(all='ignore'):
    candidate = _F32(1.01 * 2) * (phi_0 - old_old_fval) / dphi_0
  start_value = _F32(1.0) if candidate > 1 else candidate

  def wolfe_one(a_i, phi_i):
    return bool(phi_i > phi_0 + c1 * a_i * dphi_0)

  def wolfe_two(dphi_i):
    return bool(abs(dphi_i) <= -c2 * dphi_0)

  done = failed = False
  i = 1
  nfev = 0
  a_i1, phi_i1, dphi_i1 = _F32(0.), phi_0, dphi_0
  a_star, phi_star, g_star, ginf_star = _F32(0.), phi_0, gfk, ginf_k
  while not done and i <= maxiter and not failed:
    a_i = start_value if i == 1 else a_i1 * _F32(2.)
    ev = restricted(a_i)
    nfev += 1
    star_to_zoom1 = wolfe_one(a_i, ev.phi) or (ev.phi >= phi_i1 and i > 1)
    star_to_i = wolfe_two(ev.dphi) and not star_to_zoom1
    star_to_zoom2 = ev.dphi >= 0. and not star_to_zoom1 and not star_to_i
    if star_to_zoom1:
      z = _zoom(restricted, wolfe_one, wolfe_two, a_i1, phi_i1, dphi_i1,
                a_i, ev.phi, ev.dphi, gfk, ginf_k)
    elif star_to_zoom2:
      z = _zoom(restricted, wolfe_one, wolfe_two, a_i, ev.phi, ev.dphi,
                a_i1, phi_i1, dphi_i1, gfk, ginf_k)
    if star_to_zoom1 or star_to_zoom2:
      done = True
      failed = failed or z[0]
      a_star, phi_star, _, g_star, ginf_star = z[1:6]
      nfev += z[6]
    elif star_to_i:
      done = True
      a_star, phi_star, g_star, ginf_star = a_i, ev.phi, ev.g, ev.ginf
    i += 1
    a_i1, phi_i1, dphi_i1 = a_i, ev.phi, ev.dphi
  # A step under 1e-8 is floored there, as jax.scipy does in float32.
  if abs(a_star) < _F32(1e-8):
    a_star = _F32(np.sign(a_star) * _F32(1e-8))
  return _LineSearchResult(failed or not done, a_star, phi_star, g_star,
                           ginf_star, nfev)


def minimize_bfgs(fun: Callable[[torch.Tensor], torch.Tensor],
                  x0: torch.Tensor,
                  maxiter: Optional[int] = None,
                  gtol: float = 1e-5,
                  line_search_maxiter: int = 10):
  """BFGS on a flat float32 vector (Nocedal and Wright, Algorithm 6.1),
  as jax.scipy's minimize_bfgs. Returns (x, f, g, H, k, converged,
  failed)."""
  if maxiter is None:
    maxiter = x0.numel() * 200
  d = x0.shape[0]
  vg = _value_and_grad_flat(fun, lambda v: v)
  f_k, g_k = vg(x0)
  f0, g_norm, ginf = torch.stack(
      [f_k.reshape(()), torch.linalg.vector_norm(g_k),
       torch.linalg.vector_norm(g_k, ord=float('inf'))]).tolist()
  f_k = _F32(f0)
  converged = bool(_F32(ginf) < _F32(gtol))
  failed = False
  k = 0
  x_k = x0
  eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
  h_k = eye
  old_old_fval = f_k + _F32(g_norm) / _F32(2.)
  while not converged and not failed and k < maxiter:
    p_k = -(h_k @ g_k)
    ls = _strong_wolfe(vg, x_k, p_k, f_k, old_old_fval, g_k,
                       _F32(ginf), maxiter=line_search_maxiter)
    failed = ls.failed
    s_k = torch.tensor(ls.a_k, dtype=x0.dtype, device=x0.device) * p_k
    x_k1 = x_k + s_k
    y_k = ls.g_k - g_k
    rho_k = torch.reciprocal(torch.dot(y_k, s_k))
    w = eye - rho_k * (s_k[:, None] * y_k[None, :])
    h_k1 = w @ h_k @ w.T + rho_k * (s_k[:, None] * s_k[None, :])
    h_k = torch.where(torch.isfinite(rho_k), h_k1, h_k)
    converged = bool(ls.ginf < _F32(gtol))
    ginf = ls.ginf
    k += 1
    old_old_fval = f_k
    x_k, f_k, g_k = x_k1, ls.f_k, ls.g_k
  return x_k, f_k, g_k, h_k, k, converged, failed


def bfgs(fun: Callable[[Dict[str, Any]], torch.Tensor],
         x0: Dict[str, Any],
         tol: float,
         max_training_step: int) -> Tuple[Dict[str, Any], torch.Tensor]:
  """Full BFGS over the raveled parameters; returns (params, value).

  `tol` is taken and, as by jax.scipy.optimize.minimize, not passed to
  the solver, whose stop is |g|_inf < 1e-5 or max_training_step
  iterations.
  """
  del tol
  flat_x0, unravel = slice_sampler.ravel_model(x0, _device_of(x0))
  x, f, _, _, k, converged, failed = minimize_bfgs(
      lambda v: fun(unravel(v)), flat_x0, maxiter=max_training_step)
  logging.info('BFGS results: success=%s value=%s iterations=%d',
               converged and not failed, f, k)
  return unravel(x), torch.tensor(f, device=flat_x0.device)
