"""Share the machine's cores among pytest-xdist's workers.

Imported by the port's test files. Under xdist (``-n N``) each worker is
its own process, and PyTorch's CPU kernels would each start a thread per
core: N workers then run N times as many threads as there are cores, and
OpenMP's spinning threads make every torch-heavy test several times slower.
Each worker keeps ``cores // N`` threads (at least 1). In one process
(no xdist) nothing changes.
"""

import os

import torch


def share_cores() -> int:
    """Set this worker's torch threads to its share of the cores; returns
    the thread count in force."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // workers))
    return torch.get_num_threads()


share_cores()
