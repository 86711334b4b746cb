"""Fixtures shared by the port's CPU test modules (``test_torch_*.py``)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's plain versions while a module's
    tests run: the suite runs several test processes at once, and torch's
    OpenMP pool in each of them spins on the shared cores (three processes
    over the HT, XS, CLI and Jacobian files took about ten times the CPU time
    and 2.5-3.5 times the wall time with the default pool as with one
    thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
