"""One torch intra-op thread for the port's CPU tests.

The suite runs in parallel workers (pytest-xdist), each of which would
otherwise start one torch thread per core for every operator on small
tensors, so the workers oversubscribe the cores: beside seven busy
processes, tests/test_torch_slo.py took 99 s with torch's default
threads and 42 s with one. A port test module arms the fixture by
importing it:

    from _torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
