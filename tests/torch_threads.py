"""A fixture for the port's tests that run many small torch ops.

Under several pytest workers at once, torch's default intra-op pool (one
thread a core in every worker) oversubscribes the machine, and a test of
many small ops runs two orders of magnitude slower than alone. A test
module that imports ``one_torch_thread`` runs its tests with one torch
thread and gives the worker its thread count back after them.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
