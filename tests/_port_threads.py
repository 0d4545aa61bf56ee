"""The port's test files run on their worker's share of the cores.

Every `test_torch_*.py` file imports `compute_share`, an autouse fixture of
module scope: for that file's tests, torch, OpenBLAS and the OpenMP/MKL/
OpenBLAS variables that its subprocesses inherit get cpu_count // W
threads under xdist's `-n W` (one with six workers on eight cores), and
all the cores outside xdist. The JAX reference's files keep their own
settings.

Why: with a full pool in every worker the cores are oversubscribed many
times over and small ops crawl. test_torch_serve.py::test_serve_oneshot_arith
took 916 s under six workers against 12 s alone, and more than 688 s
against 13.8 s alone on one thread.
"""

import os

import pytest
import torch
from threadpoolctl import threadpool_limits

THREADS = max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


@pytest.fixture(scope="module", autouse=True)
def compute_share():
    """THREADS compute threads for the importing file's tests, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    with pytest.MonkeyPatch.context() as mp, threadpool_limits(THREADS):
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
            if var not in os.environ:
                mp.setenv(var, str(THREADS))
        yield
    torch.set_num_threads(old)
