"""Settings every test process shares, under ``tests/`` and ``graphbench/``
alike: one torch thread a process.

The suite runs in several worker processes at once, and the port's CPU
tests are eager small-tensor ops. At torch's default of one intra-op
thread a core in every worker, the workers' threads outnumber the cores
and spin against each other, which costs far more than the threads gain.
``OMP_NUM_THREADS`` is set before torch is imported, and in the
environment, so that the processes a test starts (examples, launchers)
inherit it; a value the caller set is kept. XLA's own CPU pool, which the
JAX package's tests use, is left as it is.
"""
import os

os.environ.setdefault("OMP_NUM_THREADS", "1")


def pytest_configure(config):
    try:
        import torch
    except ImportError:
        return
    torch.set_num_threads(1)
