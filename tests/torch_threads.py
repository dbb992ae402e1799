"""One intra-op thread for a test module of the port.

The test suite runs in six pytest-xdist workers on the host's cores. A
torch process uses every core for its intra-op pool by default, so six
workers training small models at once keep several times more OpenMP
threads than cores busy, and each of the thousands of small operations a
step waits for its whole pool to be scheduled: a test that takes seconds
alone took minutes beside the others. A module that imports
:func:`one_intra_op_thread` runs its tests, and the module fixtures they
use, with one intra-op thread, and so do the processes it starts without
setting their own count (``OMP_NUM_THREADS``; the CLI's ranks and the
search's workers set theirs). Both are put back after the module, so
every other module keeps the default. Every test of such a module
computes with the same thread count whichever worker runs it and
whatever ran before, as it did with the default.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    saved = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(n)
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved
