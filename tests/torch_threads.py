"""One intra-op thread for the port's CPU tests.

The suite runs in several pytest-xdist workers at once, each of which would
otherwise give torch a pool of one thread per core: the pools then
oversubscribe the cores many times over and the tests spend their time
switching threads.  Every ``tests/test_torch_*.py`` imports
:func:`one_torch_thread`, so that its tests run torch on one thread (as the
spawned gloo ranks already do, ``spawn(..., threads=1)``); the previous
count is restored after the module.  Numbers may differ from a threaded run
in the last bits only (another summation order), which every comparison's
tolerance holds; comparisons bit for bit are between runs of one module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
