"""Cholesky of small SPD matrices (n <= 512), kernel K7 (port of
hyperbo_tpu/ops/pallas_chol.py).

`ops/chol.py` routes its base cases here when `set_use_pallas_base(True)` is
set: directly for n <= 512, and as the base case of the blocked recursion
(`set_use_recursive`). Every matrix is symmetrized as 0.5 (A + A^T) first,
as both Pallas kernels do.

The wrappers dispatch on the tensor's device: a CUDA tensor goes through
the hand-written Hopper kernel (csrc/chol_panel.cu) or raises; a CPU tensor
goes through the plain PyTorch version `cholesky_panel_plain`. There is no
fallback from one to the other. The kernel factors each matrix right-looking
in 64-wide block columns on a thread-block cluster, one block a block
column kept in its shared memory: `cluster_steps` is its schedule and
`cholesky_panel_steps` its float64 mirror, which only the tests run. Its
time is the chain of ceil(n / 64) diagonal factors, panel solves, updates
of the next diagonal block and cluster barriers, far above its bound of
n^3/3 operations and 8 n^2 bytes. The three JAX entry points compute the same
factor and share the one kernel here: the Hopper kernel takes any n <= 512,
so `cholesky_panel_padded` needs no identity padding, and
`cholesky_panel_blocked` keeps only its shape check. Every entry point takes
a batch (..., n, n). The route of ops/chol.py calls `cholesky_panel`.

A matrix that is not positive definite comes out NaN, on both versions (the
TPU kernels clamp the pivot and return finite garbage instead).
"""

from __future__ import annotations

import ctypes

import torch

from hyperbo_tpu_torch.ops import _build
from hyperbo_tpu_torch.ops.chol import plain_cholesky, poison_non_pd

MAX_N = 512
BLOCK = 64  # block column width: one block of the kernel's cluster each
SUB = 16    # sub-panel width of a block's factor of its diagonal block

KERNEL = _build.CudaKernel(
    'chol_panel.cu', 'hyperbo_chol_panel',
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p])


def cholesky_panel_plain(a: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch factor of 0.5 (A + A^T) (any device, float32 or
  float64); NaN where not positive definite."""
  return plain_cholesky(0.5 * (a + a.transpose(-1, -2)))


def cluster_steps(n: int) -> list:
  """The kernel's schedule for one n x n matrix: a list of steps, each the
  parts that the cluster's blocks run before the step's cluster barrier, in
  order. Block j owns block column j (columns 64 j .. 64 j + 63, rows
  64 j .. n - 1). Step 0 is ('factor', 0); step k + 1 holds ('update', j, k)
  for every block j > k (block j subtracts panel k's products), then
  ('factor', k + 1): block k + 1, which updates its diagonal block first,
  factors it while its other rows take the rest of the update, then solves
  its panel."""
  nc = -(-n // BLOCK)
  steps = [[('factor', 0)]]
  for k in range(nc - 1):
    steps.append([('update', j, k) for j in range(k + 1, nc)] +
                 [('factor', k + 1)])
  return steps


def cholesky_panel_steps(a: torch.Tensor) -> torch.Tensor:
  """Plain mirror of the kernel's algorithm (tests run it in float64): the
  factor of 0.5 (A + A^T) by `cluster_steps`, each block column held
  apart as its block holds it; an update subtracts one 64-deep product of
  the panel's rows, a factor is `factor_block_column`. NaN (or inf) where
  not positive definite, as the kernel gives before the wrapper's poison."""
  n = a.shape[-1]
  b = BLOCK
  sym = 0.5 * (a + a.transpose(-1, -2))
  cols = [sym[..., j:, j:j + b].clone() for j in range(0, n, b)]
  for step in cluster_steps(n):
    for part in step:
      if part[0] == 'update':
        _, j, k = part
        p = cols[k][..., (j - k) * b:, :]
        cols[j] -= p @ p[..., :cols[j].shape[-1], :].transpose(-1, -2)
      else:
        factor_block_column(cols[part[1]])
  out = torch.zeros_like(sym)
  for j, col in enumerate(cols):
    out[..., j * b:, j * b:j * b + col.shape[-1]] = torch.tril(col)
  return out


def factor_block_column(col: torch.Tensor) -> torch.Tensor:
  """In place: one block's factor of its block column (rows, w); returns
  1 / sqrt of the pivots (..., w). The w x w diagonal block goes
  right-looking over SUB-wide sub-panels: each diagonal sub-block (a ragged
  one identity-padded) is factored column by column (the pivot p times
  1 / sqrt(p) on the diagonal, the column below scaled by 1 / sqrt(p), then
  each later column c less the column times its entry in row c), the
  diagonal block's rows below it take the same column order against it,
  then their products leave its later columns. The panel's rows (below the
  diagonal block) are then solved against all of L11 (`solve_rows`)."""
  w = col.shape[-1]
  s = SUB
  rdiag = []
  for s0 in range(0, w, s):
    sw = min(s, w - s0)
    d = torch.eye(s, dtype=col.dtype, device=col.device).expand(
        col.shape[:-2] + (s, s)).clone()
    d[..., :sw, :sw] = col[..., s0:s0 + sw, s0:s0 + sw]
    for j in range(s):
      p = d[..., j, j].clone()
      rp = torch.rsqrt(p)
      rdiag.append(rp)
      d[..., j + 1:, j] *= rp[..., None]
      d[..., j, j] = p * rp
      d[..., j + 1:, j + 1:] -= (d[..., j + 1:, j:j + 1] *
                                 d[..., None, j + 1:, j])
    col[..., s0:s0 + sw, s0:s0 + sw] = d[..., :sw, :sw]
    x = col[..., s0 + s:w, s0:s0 + s]
    if not x.shape[-2]:
      continue
    for j in range(s):
      x[..., j] *= rdiag[s0 + j][..., None]
      x[..., j + 1:] -= x[..., j:j + 1] * d[..., None, j + 1:, j]
    col[..., s0 + s:w, s0 + s:w] -= x @ x.transpose(-1, -2)
  rdiag = torch.stack(rdiag, -1)
  solve_rows(col[..., w:, :], col[..., :w, :], rdiag)
  return rdiag


def solve_rows(x: torch.Tensor, l11: torch.Tensor, rdiag: torch.Tensor):
  """In place: x <- x L11^-T in one column sweep, as a thread solves its
  row (scale column j by 1 / sqrt(p_j), then take x_j L11[c][j] from every
  later column c); rdiag (..., w) holds 1 / sqrt of L11's pivots."""
  for j in range(l11.shape[-1] if x.shape[-2] else 0):
    x[..., j] *= rdiag[..., j, None]
    x[..., j + 1:] -= x[..., j:j + 1] * l11[..., None, j + 1:, j]


def launch_chol_panel(a: torch.Tensor) -> torch.Tensor:
  """Run the Hopper kernel on a contiguous float32 CUDA batch (..., n, n),
  n <= 512: one launch of ceil(n / 64) blocks a matrix."""
  _build.check_cuda_f32('launch_chol_panel', a=a)
  n = a.shape[-1]
  if a.ndim < 2 or a.shape[-2] != n or not 1 <= n <= MAX_N:
    raise ValueError(f'launch_chol_panel takes (..., n, n) with 1 <= n <= '
                     f'{MAX_N}, got {tuple(a.shape)}')
  out = torch.empty_like(a)
  batch = a.numel() // (n * n)
  if batch == 0:
    return out
  with torch.cuda.device(a.device):
    stream = torch.cuda.current_stream(a.device).cuda_stream
    KERNEL.launch(a.data_ptr(), out.data_ptr(), n, batch, stream)
  return poison_non_pd(out)


def cholesky_panel(a: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky factor of SPD matrices (..., n, n), n <= 512."""
  if a.shape[-1] > MAX_N:
    raise ValueError(f'cholesky_panel takes n <= {MAX_N}, got '
                     f'{a.shape[-1]}')
  if a.device.type == 'cuda':
    return launch_chol_panel(a)
  if a.device.type == 'cpu':
    return cholesky_panel_plain(a)
  raise ValueError(f'cholesky_panel runs on cpu or cuda, got {a.device}')


def cholesky_panel_blocked(a: torch.Tensor,
                           block_width: int = 128) -> torch.Tensor:
  """`cholesky_panel` with the JAX kernel's shape check: the TPU's
  left-looking sweep covers only whole panels of `block_width` columns."""
  n = a.shape[-1]
  if n % block_width:
    raise ValueError(
        f'cholesky_panel_blocked needs n % block_width == 0, got n={n}, '
        f'block_width={block_width}; use cholesky_panel_padded or '
        'cholesky_panel.')
  return cholesky_panel(a)


def cholesky_panel_padded(a: torch.Tensor) -> torch.Tensor:
  """`cholesky_panel` of any n <= 512. The TPU kernel padded n up to a
  multiple of 128 (`pad_to`) with an identity block; the factor of that
  padded matrix restricted to [:n, :n] is the factor of `a`, which the
  Hopper kernel computes directly."""
  return cholesky_panel(a)
