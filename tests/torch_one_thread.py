"""The port's CPU tests run on one torch intra-op thread: an autouse
fixture a test file imports to apply it to its tests.

The driver of the test suite runs six test processes on the cores of
one machine. A per-process pool of intra-op threads then slows the
thousands of tiny ops these tests run many times over (the pools spin
against each other), and the suite's wall time with it; one thread each
leaves the values the tests check as they are (the tolerances cover a
reduction's order, and every bit-for-bit comparison runs both sides on
the same thread count)."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
