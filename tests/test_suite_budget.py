"""Suite-wide checks of how the tests themselves run."""

import os

import torch


def test_each_process_keeps_to_its_share_of_the_cores(pytestconfig):
    """The root ``conftest.py`` gives each test process one CPU-thread
    budget; under ``pytest -n N`` the N workers' pools together fit the
    cores, unless the operator chose the count."""
    budget = os.environ.get("OMP_NUM_THREADS")
    assert budget is not None, "OMP_NUM_THREADS is not set"
    n = int(budget)
    assert torch.get_num_threads() == n
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is not None and not pytestconfig.thread_budget_from_operator:
        assert n == 1 or n * int(workers) <= len(os.sched_getaffinity(0)), (n, workers)
