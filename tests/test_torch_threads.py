"""The port's test modules share the CPU's cores among the test workers.

torch's CPU kernels run an intra-op thread pool as wide as the machine.
Under pytest-xdist every worker starts one, so N workers run N times as
many threads as there are cores, and the port's tests slow down many
times over beside each other (a tracker test of
tests/test_torch_sharding.py: 5 s alone, 199 s beside three other
workers).  ``share_cores``, an autouse fixture that every port test
module imports, gives each worker its share of the cores while the
module runs and restores the pool after it.  A run without workers
keeps the whole machine.
"""

import os

import pytest
import torch


def worker_threads(cores=None, workers=None):
    """Threads for one worker: the cores this process may use, shared
    among the run's xdist workers (PYTEST_XDIST_WORKER_COUNT), at least
    one."""
    if cores is None:
        cores = len(os.sched_getaffinity(0))
    if workers is None:
        workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cores // max(1, workers))


@pytest.fixture(scope="module", autouse=True)
def share_cores():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, worker_threads()))
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("cores,workers,want", [
    (8, 1, 8), (8, 4, 2), (8, 6, 1), (4, 6, 1), (96, 6, 16), (8, 0, 8)])
def test_worker_threads(cores, workers, want):
    assert worker_threads(cores, workers) == want


def test_module_runs_with_its_share(monkeypatch):
    """Inside a module the pool is no wider than the worker's share."""
    assert torch.get_num_threads() <= worker_threads()
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "3")
    assert worker_threads(cores=9) == 3
