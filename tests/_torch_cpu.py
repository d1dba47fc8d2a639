"""What the port's CPU parity tests (``tests/test_torch_*.py``) share: each
imports :func:`one_torch_thread`, which then applies to it.

The tests run tiny shapes, where PyTorch's intra-op threads gain nothing,
and the suite runs in several worker processes at once: each worker's
default of one thread a core oversubscribed the cores several times over,
which made the port's files take 3.6 times as long (1036 s against 284 s
for ``tests/test_torch_*.py`` on six workers of an eight-core host).
The fixture runs a module with one intra-op thread and puts the setting
back after it. No input, tolerance or assertion depends on it.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
