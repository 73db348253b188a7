"""One PyTorch intra-op thread for the port's CPU tests.

The port's plain versions run at test widths (a few hundred), where one
intra-op thread computes as fast as several.  The Tier-1 command runs the
tests in several processes at once; each process's default pool (one
thread per core) then spins against the others', and a trace that takes
one second alone took minutes.  A test module imports the fixture to use it::

    from _torch_threads import one_intra_op_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
