"""A fixture for the port's test modules that train small models: one
intra-op thread for the module's tests, the previous count after them.

The suite runs its files in several worker processes at once, and each
PyTorch process would otherwise start a thread per core for every op of
these tiny models, more threads than the machine has cores, which slows
every worker down (PyTorch's threads wait for each other at every op).
Values do not depend on the thread count at these sizes' reductions
beyond what the tests' tolerances state; bit-equality tests compare runs
made under the same count."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
