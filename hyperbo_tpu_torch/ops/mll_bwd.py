"""Fused NLL backward, kernel K4 (port of hyperbo_tpu/ops/pallas_mll_bwd.py).

From T = L^{-1} (ops/tri_inv) and alpha = K^{-1} delta, the adjoints of the
fused NLL (ops/fused_mll) need

    G = (T^T T - alpha alpha^T) / 2,    W = G o N(r2),
    P = [W x | W 1]  (n, d + 1),   d_sv_raw = sum G o Kf,   d_da = tr G,

with Kf = sv k(r2) and N = -2 sv dk/dr2 per kernel family (`_km_nm`), both
masked by valid_i valid_j for padded rows. The caller forms
d_x = 2 (Wx - (W1) o x) and d_sv = d_sv_raw / sv.

`mll_bwd_fused` dispatches on the tensor's device: a CUDA tensor goes
through the hand-written Hopper kernel (csrc/mll_bwd.cu), which never
writes K^{-1}, G or W to device memory, or raises; a CPU tensor goes
through the plain PyTorch version `mll_bwd_plain`, the dense chain of
hyperbo_tpu/ops/pallas_mll.py:1383-1405 written from T. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from hyperbo_tpu_torch.ops import _build

TILE = 64
KFAM_CODE = {'se': 0, 'matern32': 1, 'matern52': 2}

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)

KERNEL = _build.CudaKernel(
    'mll_bwd.cu', 'hyperbo_mll_bwd',
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5)


def raw_sqdist(x: torch.Tensor) -> torch.Tensor:
  """|x_i|^2 + |x_j|^2 - 2 x_i.x_j floored at 0: the kernels' distance
  form (one product plus the row norms, not centered)."""
  sqn = torch.sum(x * x, dim=1)
  return torch.clamp(sqn[:, None] + sqn[None, :] - 2.0 * (x @ x.T), min=0.0)


def _km_nm(r2, sv, kfam: str):
  """(kmat, neg2kp) = (sv k(r2), -2 sv dk/dr2) per kernel family, with
  the r^2 floor under the Matern square root (the exact coincident-point
  limit of the adjoint is 0, and the floor realizes it without inf * 0)."""
  if kfam == 'se':
    km = sv * torch.exp(-0.5 * r2)
    return km, km
  if kfam == 'matern32':
    r = _SQRT3 * torch.sqrt(torch.clamp(r2, min=1e-36))
    e = torch.exp(-r)
    return sv * (1.0 + r) * e, 3.0 * sv * e
  if kfam == 'matern52':
    r = _SQRT5 * torch.sqrt(torch.clamp(r2, min=1e-36))
    e = torch.exp(-r)
    return (sv * (1.0 + r + (r * r) * (1.0 / 3.0)) * e,
            (5.0 / 3.0) * sv * (1.0 + r) * e)
  raise ValueError(f'unknown fused kernel family: {kfam!r}')


def mll_bwd_plain(t: torch.Tensor, x: torch.Tensor, alpha: torch.Tensor,
                  sv: torch.Tensor, kfam: str = 'se',
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Plain PyTorch (P, d_sv_raw, d_da) (any device, float32 or float64)."""
  kinv = t.T @ t
  gmat = 0.5 * (kinv - alpha @ alpha.T)
  kmat, neg2kp = _km_nm(raw_sqdist(x), sv, kfam)
  if valid is not None:
    pair = valid[:, None] * valid[None, :]
    kmat = kmat * pair
    neg2kp = neg2kp * pair
  w = gmat * neg2kp
  p = torch.cat([w @ x, torch.sum(w, dim=1, keepdim=True)], dim=1)
  return p, torch.sum(gmat * kmat), torch.trace(gmat)


def launch_mll_bwd(t: torch.Tensor, x: torch.Tensor, alpha: torch.Tensor,
                   sv: torch.Tensor, kfam: str = 'se',
                   valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Run the Hopper kernel: t (n, n), x (n, d), alpha (n, 1), sv a
  one-element tensor, valid (n,) 0/1 or None; n a multiple of 64."""
  sv = sv.reshape(1)
  _build.check_cuda_f32('launch_mll_bwd', t=t, x=x, alpha=alpha, sv=sv,
                        valid=valid)
  n, d = x.shape
  if t.shape != (n, n) or alpha.shape != (n, 1) or n % TILE or n == 0:
    raise ValueError(f'launch_mll_bwd takes t (n, n), x (n, d), alpha '
                     f'(n, 1) with n a multiple of {TILE}; got '
                     f'{tuple(t.shape)}, {tuple(x.shape)}, '
                     f'{tuple(alpha.shape)}')
  if valid is not None and valid.shape != (n,):
    raise ValueError(f'valid must be ({n},), got {tuple(valid.shape)}')
  nb = n // TILE
  p_part = torch.empty((nb, nb, TILE, d + 1), dtype=torch.float32,
                       device=t.device)
  s_part = torch.empty((nb * (nb + 1),), dtype=torch.float64,
                       device=t.device)
  p = torch.empty((n, d + 1), dtype=torch.float32, device=t.device)
  out = torch.empty((2,), dtype=torch.float32, device=t.device)
  with torch.cuda.device(t.device):
    stream = torch.cuda.current_stream(t.device).cuda_stream
    KERNEL.launch(t.data_ptr(), x.data_ptr(), alpha.data_ptr(),
                  valid.data_ptr() if valid is not None else None,
                  sv.data_ptr(), n, d, KFAM_CODE[kfam], p_part.data_ptr(),
                  s_part.data_ptr(), p.data_ptr(), out.data_ptr(), stream)
  return p, out[0], out[1]


def mll_bwd_fused(t: torch.Tensor, x: torch.Tensor, alpha: torch.Tensor,
                  sv: torch.Tensor, kfam: str = 'se',
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """(P, d_sv_raw, d_da) of the fused NLL from T = L^{-1}.

  P = [W x | W 1] is (n, d + 1); d_sv_raw = sum G o Kf over the full
  matrix (the caller divides by sv); d_da = tr G.
  """
  if t.device.type == 'cuda':
    return launch_mll_bwd(t, x, alpha, sv, kfam, valid)
  if t.device.type == 'cpu':
    return mll_bwd_plain(t, x, alpha, sv, kfam, valid)
  raise ValueError(f'mll_bwd_fused runs on cpu or cuda, got {t.device}')
