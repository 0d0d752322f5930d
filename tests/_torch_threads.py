"""The port's test files' share of the cores, as one fixture.

Each ``tests/test_torch_*.py`` that runs torch on the CPU imports it:

    from _torch_threads import _worker_threads  # noqa: E402,F401

pytest registers a fixture it finds in a test module's namespace, so the
import alone makes it the file's own.
"""
import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _worker_threads():
    """This file's torch ops on its worker's share of the cores: under
    pytest-xdist several files run at once, and processes of a thread a
    core each would spin against each other."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(n)
