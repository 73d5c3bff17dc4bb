"""A module-scoped fixture that runs torch on one thread.

The tier-1 command runs the tests in several worker processes, and each
worker's torch sizes its intra-op thread pool to every core of the host.
A port test made of many small torch operations then waits, at every
operation, for threads that the other workers keep busy: one such file
took 527 s of test time under six workers and 2 s on one thread.  A test
module opts in with ``from torch_threads import one_torch_thread`` (the
fixture is autouse, so importing it is enough); the thread count is
restored after the module.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
