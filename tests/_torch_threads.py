"""One intra-op thread for PyTorch in the port's CPU tests.

The tier-1 run puts six pytest-xdist workers on the machine's cores, and
PyTorch takes one intra-op thread per core in each.  Every
``tests/test_torch_*.py`` file that runs on the CPU imports this module, so
each worker's PyTorch keeps to one thread and the workers do not contend with
each other (JAX's own threads are left as they are).

A thread count changes the order of PyTorch's CPU sums.  A test whose bar was
set on PyTorch's own thread count takes the ``default_threads`` fixture, which
gives it back that count for its run."""

import pytest
import torch

DEFAULT = torch.get_num_threads()
torch.set_num_threads(1)


@pytest.fixture
def default_threads():
    torch.set_num_threads(DEFAULT)
    try:
        yield DEFAULT
    finally:
        torch.set_num_threads(1)
