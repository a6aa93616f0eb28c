"""An autouse fixture for the port's heaviest CPU test modules: while the
module runs under pytest-xdist, torch's intra-op threads are capped at the
machine's cores over the worker count (at least one), and restored after.

Each worker otherwise starts as many threads as the machine has cores, and
the workers' threads contend: a 3.8 s fixture of
tests/test_torch_audio_query.py took 47 s on 8 cores beside five busy
processes with torch's 8 threads, and 12 s with 1 or 2. Without xdist the
count stays torch's own.

    from torch_threads import torch_threads_per_worker  # noqa: F401
"""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
