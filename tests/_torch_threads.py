"""Torch's CPU threads for the port's tests when pytest-xdist runs them in
several worker processes.

Each worker's PyTorch would otherwise start one intra-op thread per core,
so that N workers run N times as many busy threads as the machine has
cores, and every torch operation waits on threads that share a core with
another worker's. Imported by the port's test modules; in a worker it gives
each worker its share of the cores (at least one thread), and in a run of
one process it changes nothing.
"""
import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _workers > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))
