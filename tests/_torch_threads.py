"""One torch CPU thread in each of the port's test processes.

Every `tests/test_torch_*.py` imports this module right after torch. The
suite runs under pytest-xdist, several workers at once on one machine,
and torch starts one intra-op thread per core in each of them, so the
workers' threads outnumber the cores several times over and the longest
files take several times as long as they do alone. One thread a process
gives each worker a core. `subprocess_env` hands the same count to the
processes the port's tests start (launchers, examples, the reference's
side) through OMP_NUM_THREADS, which torch reads when it starts; the
port's spawned gloo ranks pin themselves (`core.dist_gas`). The card's
tests (`test_torch_cuda.py`) run alone in one process and keep torch's
default."""
import os

import torch

THREADS = 1
torch.set_num_threads(THREADS)


def subprocess_env(**extra: str) -> dict:
    """os.environ with OMP_NUM_THREADS set to THREADS, and `extra`."""
    return dict(os.environ, OMP_NUM_THREADS=str(THREADS), **extra)
