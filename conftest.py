"""One CPU-thread budget for each process that runs tests.

Each process gets its share of this machine's cores, so that ``pytest -n N``
does not run N intra-op pools of every core each.  A serial run keeps every
core; ``OMP_NUM_THREADS`` set by the operator wins, and the subprocesses that
tests start inherit whichever value holds.
"""

import os


def pytest_configure(config):
    # xdist's controller runs no test, and the workers it starts inherit its
    # environment: a budget set there would bind them all.
    if not hasattr(config, "workerinput") and config.getoption("dist", "no") != "no":
        return
    config.thread_budget_from_operator = "OMP_NUM_THREADS" in os.environ
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    os.environ.setdefault("OMP_NUM_THREADS", str(max(1, len(os.sched_getaffinity(0)) // workers)))
    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
