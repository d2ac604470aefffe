"""The schedule of kernel K7 (hyperbo_tpu_torch/csrc/chol_panel.cu), settled
on the CPU: `cluster_steps`, the blocks' parts step by step, and
`cholesky_panel_steps`, its float64 mirror of the kernel's diagonal factors,
panel solves and trailing updates, held to torch.linalg.cholesky.

Imports no JAX: the mirror's oracle is float64 LAPACK. Tolerance: 1e-12 of
the factor's largest entry (float64 sums in another order).
"""

import numpy as np
import pytest
import torch

from hyperbo_tpu_torch.ops import chol_panel
from torch_threads import one_torch_thread  # noqa: F401


def _spd(seed, t, n):
  a = np.random.default_rng(seed).normal(size=(t, n, n))
  return torch.from_numpy(a @ np.swapaxes(a, -1, -2) / n + 2.0 * np.eye(n))


def _assert_matches_cholesky(a):
  got = chol_panel.cholesky_panel_steps(a)
  want = torch.linalg.cholesky(0.5 * (a + a.transpose(-1, -2)))
  assert got.dtype == torch.float64
  assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
  err = float((got - want).abs().max() / want.abs().max())
  assert err <= 1e-12, err


@pytest.mark.parametrize('sizes', [(1, 37), (64, 65), (128, 300), (511, 512)])
def test_mirror_matches_cholesky(sizes):
  """One block (n <= 64), a ragged second block (65), whole and ragged
  block columns, and the full cluster of eight (511 ragged, 512)."""
  for n in sizes:
    a = _spd(n, 1, n)
    a[0] += 0.01 * torch.triu(a[0], 1)  # the mirror symmetrizes first
    _assert_matches_cholesky(a)


def test_mirror_matches_cholesky_on_a_batch():
  """The packed training shape (23, 100, 100): two block columns a matrix,
  the second ragged."""
  _assert_matches_cholesky(_spd(23, 23, 100))


def test_mirror_gives_nan_for_the_non_pd_matrix_only():
  """A negative pivot in the last block column of the middle matrix: its
  factor is not finite and, after the wrapper's poison, all NaN; the
  others are untouched."""
  a = _spd(5, 3, 300)
  a[1, -1, -1] = -5.0
  got = chol_panel.cholesky_panel_steps(a)
  assert not torch.isfinite(got[1]).all()
  poisoned = chol_panel.poison_non_pd(got)
  assert torch.isnan(poisoned[1]).all()
  want = torch.linalg.cholesky(a[[0, 2]])
  np.testing.assert_allclose(poisoned[[0, 2]].numpy(), want.numpy(),
                             atol=1e-12)


def test_cluster_steps_cover_every_block_column():
  """For every n <= 512: ceil(n / 64) steps (one cluster barrier each);
  block column j takes the updates of panels 0 .. j - 1 once each, in
  order, and is factored in step j right after the last of them."""
  for n in range(1, chol_panel.MAX_N + 1):
    nc = -(-n // chol_panel.BLOCK)
    steps = chol_panel.cluster_steps(n)
    assert len(steps) == nc
    for s, step in enumerate(steps):
      assert step[-1] == ('factor', s)
      assert all(part[0] == 'update' and part[2] == s - 1
                 for part in step[:-1])
    for j in range(nc):
      parts = [p for step in steps for p in step if p[1] == j]
      assert parts == [('update', j, k) for k in range(j)] + [('factor', j)]
