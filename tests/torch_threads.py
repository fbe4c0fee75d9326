"""One torch intra-op thread for the port's CPU tests.

The suite runs several pytest workers on one machine, and each torch
process starts an intra-op thread pool as wide as the machine.  With the
workers oversubscribing the cores, the pool's many small parallel regions
ran an order of magnitude slower than one thread does.  A test module
imports ``one_torch_thread`` (an autouse fixture) to run with one thread.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the importing module with one intra-op thread, then restore."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
