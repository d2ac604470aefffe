"""Joint fused-NLL backward, kernel K8 (port of
hyperbo_tpu/ops/pallas_bwd_joint.py).

From the forward's factor L, one call computes every adjoint of the fused
NLL (ops/fused_mll): T = L^{-1}, u = T delta, alpha = T^T u = K^{-1} delta,
then K4's SYRK consumption P = [W x | W 1], d_sv_raw and d_da (ops/mll_bwd),
and d_x = 2 (P[:, :d] - P[:, d:] o x). It is what ops/tri_inv (K3), alpha
and ops/mll_bwd (K4) compute one after another; the route of ops/fused_mll
takes it under HYPERBO_BWD_JOINT=1, as the JAX package does.

`mll_bwd_joint` dispatches on the tensor's device: a CUDA tensor goes
through the hand-written Hopper kernel (csrc/bwd_joint.cu: one persistent
cooperative launch, whose phases run K3's and K4's bodies from
csrc/bwd_core.cuh) or raises; a CPU tensor goes through the plain PyTorch
version `mll_bwd_joint_plain`, the chain of the three plain versions. There
is no fallback from one to the other, and never from the kernel to K3 + K4.
The Mosaic knobs of the JAX function (tile shapes, panel layouts,
`precise`, MAX_N) have no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from hyperbo_tpu_torch.ops import _build
from hyperbo_tpu_torch.ops import mll_bwd
from hyperbo_tpu_torch.ops import tri_inv as tri_inv_ops

TILE = mll_bwd.TILE
# The JAX kernel reserves lane 127 of its 128-lane feature tiles for delta,
# so its route needs d + 2 <= ULANE; the port's route keeps the condition so
# that both packages send the same configurations through the joint kernel.
ULANE = 127
_SLAB = 32

KERNEL = _build.CudaKernel(
    'bwd_joint.cu', 'hyperbo_mll_bwd_joint',
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 9)


def mll_bwd_joint_plain(l: torch.Tensor, x_scaled: torch.Tensor,
                        delta: torch.Tensor, sv: torch.Tensor,
                        kfam: str = 'se',
                        valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
  """Plain PyTorch (d_x, alpha, d_sv_raw, d_da) (any device, float32 or
  float64)."""
  t = tri_inv_ops.tri_inv_plain(l)
  alpha = tri_inv_ops.alpha_from_inverse(t, delta)
  p, dsv_raw, d_da = mll_bwd.mll_bwd_plain(t, x_scaled, alpha, sv, kfam,
                                           valid)
  d = x_scaled.shape[1]
  return 2.0 * (p[:, :d] - p[:, d:] * x_scaled), alpha, dsv_raw, d_da


def launch_mll_bwd_joint(l: torch.Tensor, x_scaled: torch.Tensor,
                         delta: torch.Tensor, sv: torch.Tensor,
                         kfam: str = 'se',
                         valid: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
  """Run the Hopper kernel: l (n, n), x_scaled (n, d), delta (n, 1), sv a
  one-element tensor, valid (n,) 0/1 or None, all float32 and contiguous on
  one CUDA device; n a multiple of 64."""
  sv = sv.reshape(1)
  _build.check_cuda_f32('launch_mll_bwd_joint', l=l, x_scaled=x_scaled,
                        delta=delta, sv=sv, valid=valid)
  n, d = x_scaled.shape
  if l.shape != (n, n) or delta.shape != (n, 1) or n == 0 or n % TILE:
    raise ValueError(f'launch_mll_bwd_joint takes l (n, n), x_scaled (n, d) '
                     f'and delta (n, 1) with n a multiple of {TILE}; got '
                     f'{tuple(l.shape)}, {tuple(x_scaled.shape)}, '
                     f'{tuple(delta.shape)}')
  if valid is not None and valid.shape != (n,):
    raise ValueError(f'valid must be ({n},), got {tuple(valid.shape)}')
  nb = n // TILE
  dinv = tri_inv_ops.diag_inverses(l).contiguous()
  f32 = dict(dtype=torch.float32, device=l.device)
  t = torch.empty((n, n), **f32)
  u_part = torch.empty((n // _SLAB, n), **f32)
  u = torch.empty((n,), **f32)
  alpha = torch.empty((n, 1), **f32)
  p_part = torch.empty((nb, nb, TILE, d + 1), **f32)
  s_part = torch.empty((nb * (nb + 1),), dtype=torch.float64,
                       device=l.device)
  p = torch.empty((n, d + 1), **f32)
  out = torch.empty((2,), **f32)
  with torch.cuda.device(l.device):
    stream = torch.cuda.current_stream(l.device).cuda_stream
    KERNEL.launch(l.data_ptr(), dinv.data_ptr(), x_scaled.data_ptr(),
                  delta.data_ptr(),
                  valid.data_ptr() if valid is not None else None,
                  sv.data_ptr(), n, d, mll_bwd.KFAM_CODE[kfam], t.data_ptr(),
                  u_part.data_ptr(), u.data_ptr(), alpha.data_ptr(),
                  p_part.data_ptr(), s_part.data_ptr(), p.data_ptr(),
                  out.data_ptr(), stream)
  d_x = 2.0 * (p[:, :d] - p[:, d:] * x_scaled)
  return d_x, alpha, out[0], out[1]


def mll_bwd_joint(l: torch.Tensor, x_scaled: torch.Tensor,
                  delta: torch.Tensor, sv: torch.Tensor, kfam: str = 'se',
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
  """(d_x, alpha, d_sv_raw, d_da) of the fused NLL from its factor L.

  d_x is the (n, d) input adjoint, alpha = K^{-1} delta (n, 1) the delta
  adjoint; the caller divides d_sv_raw by sv. A NaN in L gives NaN outputs.
  """
  if l.device.type == 'cuda':
    return launch_mll_bwd_joint(l, x_scaled, delta, sv, kfam, valid)
  if l.device.type == 'cpu':
    return mll_bwd_joint_plain(l, x_scaled, delta, sv, kfam, valid)
  raise ValueError(f'mll_bwd_joint runs on cpu or cuda, got {l.device}')
