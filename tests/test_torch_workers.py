"""The port's CPU tests share the machine's cores among pytest-xdist's
workers.

PyTorch starts as many intra-op threads as the process may use cores, in
every worker, and its OpenMP threads spin while they wait: six workers of
eight threads each on eight cores run the port's tests several times
slower than one thread each. `share_cores()` gives each worker's PyTorch
its share of the cores (at least one); outside xdist, or with one worker,
it leaves the thread count as it is. Every other tests/test_torch_*.py
module calls it on import, and xdist's workers import every module they
collect, so the share holds for every test a worker runs.
"""

import os

import torch


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        return os.cpu_count() or 1


def share_cores() -> int:
    """Set PyTorch's intra-op threads to the cores over xdist's worker count
    (PYTEST_XDIST_WORKER_COUNT), at least 1; returns the thread count."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, _cores() // workers))
    return torch.get_num_threads()


def test_share_cores_divides_the_cores_among_workers(monkeypatch):
    before = torch.get_num_threads()
    try:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "3")
        assert share_cores() == max(1, _cores() // 3)
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(4 * _cores()))
        assert share_cores() == 1
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT")
        torch.set_num_threads(2)
        assert share_cores() == 2  # outside xdist: left as it is
    finally:
        torch.set_num_threads(before)
