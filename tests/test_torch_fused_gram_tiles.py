"""The store plan of kernel K5 (hyperbo_tpu_torch/ops/fused_gram.py
gram_store_plan, the mirror of csrc/gram.cu's lane-to-column map) on the
CPU: every entry of an (n1, n2) output is stored exactly once, 16-byte
stores only where every row starts 16-byte aligned, and the scalars reach
the kernel by value. No JAX; the kernel itself is held against its plain
version on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from hyperbo_tpu_torch.ops import fused_gram
from torch_threads import one_torch_thread  # noqa: F401


def _coverage(n1, n2, aligned):
  r, c, w = fused_gram.gram_store_plan(n1, n2, aligned)
  hits = np.zeros((n1, n2), dtype=np.int64)
  for q in range(4):
    lane = w > q
    np.add.at(hits, (r[lane], c[lane] + q), 1)
  return hits, r, c, w


@pytest.mark.parametrize('n1,n2', [(70, 70), (41, 17), (1000, 333),
                                   (130, 256), (257, 1028)])
def test_store_plan_covers_every_entry_once(n1, n2):
  hits, r, c, w = _coverage(n1, n2, aligned=True)
  assert (hits == 1).all()
  assert (r < n1).all() and (c + w <= n2).all()
  if n2 % 4 == 0:
    # One float4 a lane and row: 16-byte aligned starts, whole 512-byte
    # row segments a warp where the tile is full.
    assert (w == 4).all()
    assert ((r * n2 + c) * 4 % 16 == 0).all()
    assert len(r) == n1 * n2 // 4
  else:
    assert (w == 1).all()
    assert len(r) == n1 * n2


def test_unaligned_output_takes_the_4_byte_path():
  hits, _, _, w = _coverage(130, 256, aligned=False)
  assert (hits == 1).all() and (w == 1).all()


def test_scalars_reach_the_kernel_by_value():
  """Numbers and CPU tensors go by value (no copy to the card); a CUDA
  tensor would go by pointer."""
  # pylint: disable-next=protected-access
  arg = fused_gram._scalar_arg
  assert arg(0.9, 'sv') == (None, pytest.approx(0.9))
  assert arg(np.float32(0.05), 'ridge') == (None, pytest.approx(0.05))
  assert arg(torch.tensor([1.5]), 'sv') == (None, 1.5)
