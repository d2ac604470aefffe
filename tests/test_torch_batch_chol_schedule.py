"""The schedule of kernel K1 (hyperbo_tpu_torch/csrc/batch_chol.cu) on the
CPU, through its float64 mirror ops/batch_chol.py linv_t_steps and the map
of its trailing update to threads, update_owners. No JAX; the kernel
itself is held against its plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).

Tolerance: the mirror within 1e-10 of torch.linalg.cholesky and
solve_triangular in float64 (the same factorization in another order of
operations; the inputs' condition numbers are below 10).
"""

import numpy as np
import torch

from hyperbo_tpu_torch.ops import batch_chol
from torch_threads import one_torch_thread  # noqa: F401

SIZES = (1, 31, 32, 33, 64, 65, 100, 127, 128)


def _spd_batch(seed, t, n):
  a = np.random.default_rng(seed).normal(size=(t, n, n))
  return torch.from_numpy(a @ np.swapaxes(a, -1, -2) / n + 2.0 * np.eye(n))


def _reference(kb):
  """L^{-T} of kb by torch.linalg.cholesky and solve_triangular."""
  chol = torch.linalg.cholesky(kb)
  eye = torch.eye(kb.shape[-1], dtype=kb.dtype).expand_as(kb)
  return torch.linalg.solve_triangular(chol, eye, upper=False).transpose(-1,
                                                                         -2)


def test_mirror_matches_cholesky_and_solve():
  """One panel and a partial one (31, 32, 33), two and a ragged third (64,
  65), the PD1 batch's 100 and the largest n the kernel takes."""
  for n in SIZES:
    kb = _spd_batch(n, 2, n)
    got = batch_chol.linv_t_steps(kb)
    np.testing.assert_allclose(got.numpy(), _reference(kb).numpy(),
                               atol=1e-10, err_msg=f'n = {n}')


def test_mirror_symmetrizes_the_input():
  """The kernel factors 0.5 (K + K^T) of what it is given."""
  kb = _spd_batch(3, 2, 65)
  skew = kb + 0.01 * torch.triu(torch.ones_like(kb), diagonal=1)
  np.testing.assert_allclose(batch_chol.linv_t_steps(skew).numpy(),
                             _reference(0.5 * (skew + skew.mT)).numpy(),
                             atol=1e-10)


def test_mirror_gives_nan_for_the_non_pd_task_only():
  kb = _spd_batch(4, 3, 100)
  kb[1] -= 10.0 * torch.eye(100, dtype=kb.dtype)
  b = batch_chol.linv_t_steps(kb)
  finite = torch.isfinite(b).flatten(1).all(dim=1).tolist()
  assert finite == [True, False, True]
  assert torch.isnan(b[1]).any()


def test_panels_cover_the_columns_with_a_handful_of_barriers():
  """Panels partition the columns, all but the last 32 wide; a task takes
  2 barriers to load, 1 after the first panel's factor and 2 a panel (its
  solve; its update with the next panel's factor), the last panel 1: 10
  at n = 100, against 2 n in the unblocked sweep."""
  for n in SIZES:
    panels = batch_chol.panels(n)
    cols = [c for p0, pw in panels for c in range(p0, p0 + pw)]
    assert cols == list(range(n))
    assert all(pw == batch_chol.PANEL for _, pw in panels[:-1])
    assert 1 <= panels[-1][1] <= batch_chol.PANEL
  barriers = 2 + 1 + 2 * len(batch_chol.panels(100)) - 1
  assert barriers == 10 < 2 * 100


def test_trailing_update_writes_each_entry_once():
  """Every entry of every panel's trailing update (live rows p1 .. n+p1-1,
  columns p1 .. n-1) has exactly one thread: the next panel's diagonal
  tile warp 0's, a row a lane, the rest by patches to the warps that do
  not share warp 0's scheduler (warp % 4 != 0)."""
  for n in SIZES:
    for p0, pw in batch_chol.panels(n):
      p1 = p0 + pw
      if p1 == n:
        continue
      owner = batch_chol.update_owners(n, p1)
      pw2 = min(batch_chol.PANEL, n - p1)
      assert owner.shape == (n, n - p1)
      assert (owner >= 0).all() and (owner < batch_chol.THREADS).all()
      tile = torch.zeros_like(owner, dtype=torch.bool)
      tile[:pw2, :pw2] = True
      assert (owner[tile] < batch_chol.PANEL).all()
      assert (owner[~tile] // 32 % 4 != 0).all()
