"""The autouse fixture that runs a port test file's CPU work on one torch
thread. Beside the suite's other xdist workers, torch's intra-op thread
pool contends for the cores and a file of many small CPU applies and
solves takes many times longer; the JAX reference keeps its own threads.

A test file takes it with one import, and it is then autouse there:
``from torch_pin import one_torch_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
