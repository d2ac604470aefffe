"""Batched small-matrix Cholesky inverse-transpose: K -> B = L^{-T}
(port of hyperbo_tpu/ops/pallas_batch_chol.py, kernel K1).

The multi-task NLL at PD1 subsample scale factors a batch of ~100 x 100
kernel matrices per training step. With B = L^{-T} in hand, everything
downstream is a batched matmul, with no triangular solve:

    z         = B^T delta        (forward solve L^{-1} delta)
    quad      = |z|^2
    logdet(L) = -sum log diag B  (diag B = 1 / L_jj)
    K^{-1}    = B B^T            (backward pass)

`batched_linv_t` dispatches on the tensor's device: a CUDA tensor goes
through the hand-written Hopper kernel (csrc/batch_chol.cu) or raises; a
CPU tensor goes through the plain PyTorch version `linv_t_plain`. There is
no fallback from one to the other.

The kernel runs the outer-product sweep on [K; I] blocked by 32-column
panels (a handful of block barriers a task), one block a task, and
symmetrizes K as it loads it. `linv_t_steps` is the float64 mirror of its
schedule and `update_owners` the map of its trailing update to threads,
both for the CPU tests.
"""

from __future__ import annotations

import ctypes

import torch

from hyperbo_tpu_torch.ops import _build

MAX_N = 128
# csrc/batch_chol.cu: a panel's columns, the threads of a task's block, and
# those of its trailing update (the warps that do not share warp 0's
# scheduler, warp % 4 != 0), in the order update_trailing numbers them.
PANEL = 32
THREADS = 512
UPDATE_THREADS = [32 * w + lane for w in range(THREADS // 32) if w % 4
                  for lane in range(32)]

KERNEL = _build.CudaKernel(
    'batch_chol.cu', 'hyperbo_batched_linv_t',
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p])


def linv_t_plain(kb: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch B = L^{-T} (any device, float32 or float64).

  NaN for every batch entry whose factorization failed, like the JAX
  reference path (_linv_t_xla) and the kernel.
  """
  chol, info = torch.linalg.cholesky_ex(kb)
  chol = torch.where((info != 0)[..., None, None],
                     torch.full_like(chol, float('nan')), chol)
  eye = torch.eye(kb.shape[-1], dtype=kb.dtype, device=kb.device)
  linv = torch.linalg.solve_triangular(chol, eye.expand_as(kb), upper=False)
  return linv.transpose(-1, -2)


def panels(n: int):
  """The kernel's panels of an n x n task: (first column, width)."""
  return [(p0, min(PANEL, n - p0)) for p0 in range(0, n, PANEL)]


def update_owners(n: int, p1: int) -> torch.Tensor:
  """The thread of the kernel's trailing update (phase 3) that writes each
  entry of the panel ending at column p1: an (n, n - p1) int64 tensor over
  live rows p1 + i (stacked [K; I] rows) and columns p1 + c. The next
  panel's diagonal tile (i, c < its width) is warp 0's, lane i; the rest
  goes by patches: patch t holds rows rq + nrq a and columns cq + ncq b
  (a, b < 4) and goes to update thread t % len(UPDATE_THREADS), as
  update_trailing takes it. -1 where no thread writes."""
  nc = n - p1
  pw2 = min(PANEL, nc)
  nrq, ncq = -(-n // 4), -(-nc // 4)
  owner = torch.full((n, nc), -1, dtype=torch.int64)
  for i in range(pw2):
    owner[i, :pw2] = i
  for t in range(nrq * ncq):
    rq, cq = divmod(t, ncq)
    for a in range(4):
      for b in range(4):
        i, c = rq + nrq * a, cq + ncq * b
        if i < n and c < nc and not (i < pw2 and c < pw2):
          if owner[i, c] != -1:
            raise AssertionError(f'entry ({i}, {c}) has two owners')
          owner[i, c] = UPDATE_THREADS[t % len(UPDATE_THREADS)]
  return owner


def linv_t_steps(kb: torch.Tensor) -> torch.Tensor:
  """The kernel's schedule in the input's dtype (float64 for the tests):
  B = L^{-T} of 0.5 (K + K^T) for kb (T, n, n), panel by panel as
  csrc/batch_chol.cu runs it. NaN past a non-positive pivot."""
  t, n, _ = kb.shape
  eye = torch.eye(n, dtype=kb.dtype, device=kb.device).expand(t, n, n)
  w = torch.cat([0.5 * (kb + kb.transpose(-1, -2)), eye], dim=1)
  for p0, pw in panels(n):
    p1 = p0 + pw
    # 1. factor the diagonal tile (its lower half): lt[j, c] = L[p0 + c,
    # p0 + j] for c > j, rpv[j] = rsqrt(pivot j).
    d = torch.tril(w[:, p0:p1, p0:p1])
    lt = torch.zeros((t, pw, pw), dtype=kb.dtype, device=kb.device)
    rpv = torch.zeros((t, pw), dtype=kb.dtype, device=kb.device)
    for j in range(pw):
      rpv[:, j] = torch.rsqrt(d[:, j, j])
      col = d[:, :, j] * rpv[:, j, None]
      lt[:, j, j + 1:] = col[:, j + 1:]
      d[:, j + 1:, j + 1:] -= col[:, j + 1:, None] * col[:, None, j + 1:]
    # 2. the live rows p1 .. n + p1 - 1 on the panel's columns.
    x = w[:, p1:n + p1, p0:p1].clone()
    for j in range(pw):
      y = x[:, :, j] * rpv[:, j, None]
      x[:, :, j + 1:] -= y[:, :, None] * lt[:, None, j, j + 1:]
      x[:, :, j] = y
    w[:, p1:n + p1, p0:p1] = x
    # 3. the live rows' columns p1 .. n - 1 minus the panel's product with
    # the rows of L below the tile (stacked rows p1 .. n - 1).
    w[:, p1:n + p1, p1:] -= x @ w[:, p1:n, p0:p1].transpose(-1, -2)
  return w[:, n:]


def launch_linv_t(kb: torch.Tensor) -> torch.Tensor:
  """Run the Hopper kernel on a (T, n, n) CUDA batch; it factors
  0.5 (K + K^T)."""
  t, n, _ = kb.shape
  _build.check_cuda_f32('launch_linv_t', kb=kb)
  if not 1 <= n <= MAX_N:
    raise ValueError(f'launch_linv_t takes 1 <= n <= {MAX_N}, got {n}')
  out = torch.empty_like(kb)
  if t == 0:
    return out
  with torch.cuda.device(kb.device):
    stream = torch.cuda.current_stream(kb.device).cuda_stream
    KERNEL.launch(kb.data_ptr(), out.data_ptr(), t, n, stream)
  return out


def batched_linv_t(kb: torch.Tensor) -> torch.Tensor:
  """B = L^{-T} for a batch of SPD matrices kb: (T, n, n), n <= 128.

  The input is symmetrized as 0.5 (K + K^T), as the JAX wrapper does: by
  the kernel as it loads a CUDA batch, which must be float32 and
  contiguous.
  """
  if kb.ndim != 3 or kb.shape[-1] != kb.shape[-2]:
    raise ValueError(f'batched_linv_t takes (T, n, n), got {tuple(kb.shape)}')
  n = kb.shape[-1]
  if n > MAX_N:
    raise ValueError(f'batched_linv_t takes n <= {MAX_N}, got {n}')
  if kb.device.type == 'cuda':
    return launch_linv_t(kb)
  if kb.device.type == 'cpu':
    return linv_t_plain(0.5 * (kb + kb.transpose(-1, -2)))
  raise ValueError(f'batched_linv_t runs on cpu or cuda, got {kb.device}')


class _NllTermsBatched(torch.autograd.Function):
  """(quad, logdet_half) with the backward of pallas_batch_chol
  (_nll_terms_bwd): batched matmuls against the forward's B."""

  @staticmethod
  def forward(ctx, kb, delta):
    b = batched_linv_t(kb)
    z = torch.matmul(b.transpose(-1, -2), delta)      # L^{-1} delta
    quad = torch.sum(z * z, dim=(-2, -1))
    # diag B = 1/L_jj > 0 for an SPD input; the log of a NaN or
    # non-positive diagonal (non-PD input) propagates.
    ld = -torch.sum(torch.log(torch.diagonal(b, dim1=-2, dim2=-1)), dim=-1)
    ctx.save_for_backward(b, z)
    return quad, ld

  @staticmethod
  def backward(ctx, qbar, lbar):
    b, z = ctx.saved_tensors
    qbar = qbar[:, None, None]
    lbar = lbar[:, None, None]
    alpha = torch.matmul(b, z)                         # K^{-1} delta
    kinv = torch.matmul(b, b.transpose(-1, -2))
    kbar = (0.5 * lbar * kinv
            - qbar * torch.matmul(alpha, alpha.transpose(-1, -2)))
    dbar = 2.0 * qbar * alpha
    return kbar, dbar


def nll_terms_batched(kb: torch.Tensor, delta: torch.Tensor):
  """Per-task (quad, logdet_half) of a batch of GP systems.

  quad_t = delta_t^T K_t^{-1} delta_t,  ld_t = sum_j log L_jj.
  kb: (T, n, n) SPD (masked, diag-filled); delta: (T, n, 1).
  Differentiable w.r.t. kb and delta.
  """
  return _NllTermsBatched.apply(kb, delta)
