"""One torch thread for the port's CPU tests.

The port's CPU tests run many small products. One thread each is fastest,
and it keeps the test workers (several processes, each with its own
thread pool) from oversubscribing the cores. A test file takes it with

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)
