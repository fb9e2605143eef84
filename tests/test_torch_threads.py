"""Cap torch's intra-op threads in every pytest-xdist worker.

Each worker collects every test module, so this module's import sets the
cap in every worker before any test runs: the machine's cores shared out
among the workers (``PYTEST_XDIST_WORKER_COUNT``; all of them in a
serial run).  Without it each of six workers starts torch's default of
one thread a core, and eight cores run 48 threads that thrash one
another."""
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
CAP = max(1, (os.cpu_count() or 1) // WORKERS)
torch.set_num_threads(CAP)


def test_intra_op_threads_are_capped():
    assert torch.get_num_threads() == CAP
    assert CAP * WORKERS <= max(os.cpu_count() or 1, WORKERS)
