"""One intra-op thread for PyTorch in the port's CPU tests.

The tier-1 run puts six pytest-xdist workers on the machine's cores, and
PyTorch takes one intra-op thread per core in each.  Every
``tests/test_torch_*.py`` file that runs on the CPU imports this module, so
each worker's PyTorch keeps to one thread and the workers do not contend with
each other (JAX's own threads are left as they are).

A thread count changes the order of PyTorch's CPU sums.  A test whose bar was
set on more than one thread takes the ``default_threads`` fixture, which
gives it ``BAR_THREADS`` for its run: ``test_torch_dcpt.py``'s three-step
bar holds at 2, 4 and 8 threads (an 8-core machine's own count), and
not at 1 (14 of 8192 elements of ``decoder0.0.conv1.weight`` over it, where
AdamW's step carries float noise in a gradient near zero); 2 threads leave
the other workers their cores."""

import pytest
import torch

DEFAULT = torch.get_num_threads()
BAR_THREADS = 2
torch.set_num_threads(1)


@pytest.fixture
def default_threads():
    torch.set_num_threads(BAR_THREADS)
    try:
        yield BAR_THREADS
    finally:
        torch.set_num_threads(1)
