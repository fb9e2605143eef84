"""Shared test fixtures/utilities.

NOTE: XLA_FLAGS device-count forcing is deliberately NOT set here — smoke
tests and benches must see the 1 real CPU device. Distributed tests spawn
subprocesses with their own XLA_FLAGS.
"""
import numpy as np
import pytest

from repro.core.formats import CSR, csr_from_coo, csr_from_dense


def random_csr(rng, m, n, density, dtype=np.float32, sorted_rows=True) -> CSR:
    a = (rng.random((m, n)) < density).astype(dtype)
    a *= rng.uniform(0.5, 1.5, size=(m, n)).astype(dtype)
    return csr_from_dense(a)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA (skips without one)")
