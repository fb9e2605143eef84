"""Carrying reference objects into the port (repro_torch.convert): each
conversion keeps every field, and rebuilding the reference object from the
port's arrays gives back the original exactly."""
import dataclasses

import numpy as np

from repro.core import formats as rf
from repro.core.planner import Plan as RefPlan
from repro.core.planner import PlanStats as RefPlanStats
from repro.core.planner import plan as ref_plan
from repro_torch.convert import (bcsr_from_reference, csr_from_reference,
                                 padded_from_reference, plan_from_reference)
from repro_torch.core.formats import to_numpy
from repro_torch.core.planner import Plan, PlanStats
import jax.numpy as jnp


def sample_csr():
    rng = np.random.default_rng(0)
    a = ((rng.random((13, 17)) < 0.3)
         * rng.uniform(0.5, 1.5, (13, 17))).astype(np.float32)
    a[4] = 0.0
    return rf.csr_from_dense(a)


def test_csr_round_trip():
    ref = sample_csr()
    got = csr_from_reference(ref)
    back = rf.CSR(got.indptr, got.indices, got.data, got.shape)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(back, f), getattr(ref, f))
        assert getattr(back, f).dtype == getattr(ref, f).dtype
    assert back.shape == ref.shape


def test_padded_round_trip():
    ref = rf.padded_from_csr(sample_csr(), 4)
    got = padded_from_reference(ref, device="cpu")
    back = rf.PaddedCSR(jnp.asarray(to_numpy(got.cols)),
                        jnp.asarray(to_numpy(got.vals)),
                        jnp.asarray(to_numpy(got.lens)), got.shape)
    for f in ("cols", "vals", "lens"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(ref, f)))
        assert np.asarray(getattr(back, f)).dtype == \
            np.asarray(getattr(ref, f)).dtype
    assert back.shape == ref.shape and got.width == ref.width


def test_bcsr_round_trip():
    ref = rf.bcsr_from_csr(sample_csr(), 4)
    got = bcsr_from_reference(ref, device="cpu")
    back = rf.BCSR(got.indptr, got.indices, jnp.asarray(to_numpy(got.blocks)),
                   got.shape, got.block_size)
    np.testing.assert_array_equal(back.indptr, ref.indptr)
    np.testing.assert_array_equal(back.indices, ref.indices)
    np.testing.assert_array_equal(np.asarray(back.blocks),
                                  np.asarray(ref.blocks))
    assert back.shape == ref.shape and back.block_size == ref.block_size
    np.testing.assert_array_equal(got.to_dense(), ref.to_dense())


def test_plan_round_trip():
    A = rf.erdos_renyi(64, 4.0, seed=1)
    M = rf.er_mask(64, 8.0, seed=2)
    ref = ref_plan(A, A, M, use_cache=False)
    got = plan_from_reference(ref)
    assert isinstance(got, Plan) and isinstance(got.stats, PlanStats)
    back = RefPlan(**{**dataclasses.asdict(got),
                      "stats": RefPlanStats(
                          **dataclasses.asdict(got.stats))})
    assert back == ref
    stats = plan_from_reference(ref.stats)
    assert isinstance(stats, PlanStats)
    assert dataclasses.asdict(stats) == dataclasses.asdict(ref.stats)
