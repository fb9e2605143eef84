"""Port parity for the slice as a whole: ``masked_spgemm(algorithm="auto")``
through the planner and both routes, and triangle counting.

The auto call must elect what the reference elects and return equal
vals/present/mask_cols: array_equal on small-integer data; on float data
the elected kernel's own tolerance (exact for msa/hash/mca, 1e-5 for
heap/inner, 1e-4 for the tile route).  Every problem keeps m below
``TRIAL_MIN_ROWS`` so no measured trial makes an election timing-dependent.
"""
import numpy as np
import pytest

from repro.core import formats as rf
from repro.core.masked_spgemm import dense_oracle as ref_dense_oracle
from repro.core.masked_spgemm import masked_spgemm as ref_masked_spgemm
from repro.core.planner import plan as ref_plan
from repro.graphs.triangle_counting import triangle_count as ref_tc
from repro.graphs.triangle_counting import tc_flops as ref_tc_flops
from repro_torch.convert import csr_from_reference, plan_from_reference
from repro_torch.core import masked_spgemm as port_masked_spgemm
from repro_torch.core.masked_spgemm import dense_oracle
from repro_torch.core.planner import plan as port_plan
from repro_torch.core.semiring import REGISTRY as SR
from repro.core.semiring import REGISTRY as REF_SR
from repro_torch.graphs import tc_flops, triangle_count

TOL = {"heap": 1e-5, "heapdot": 1e-5, "inner": 1e-5, "tile": 1e-4}


def port(*xs):
    return [csr_from_reference(x) for x in xs]


def ints_like(x, seed):
    """Same structure, small integer values."""
    rng = np.random.default_rng(seed)
    return type(x)(x.indptr, x.indices,
                   rng.integers(1, 5, x.nnz).astype(np.float32), x.shape)


def er_case(n, d_a, d_m, seed, ints):
    A = rf.erdos_renyi(n, d_a, seed=seed)
    B = rf.erdos_renyi(n, d_a, seed=seed + 1)
    M = rf.er_mask(n, d_m, seed=seed + 2)
    if ints:
        A, B = ints_like(A, seed), ints_like(B, seed + 1)
    return A, B, M


def block_case(n, bs, seed, ints=True):
    a = rf.block_sparse(n, bs, 0.4, 0.9, seed=seed)
    b = rf.block_sparse(n, bs, 0.4, 0.9, seed=seed + 1)
    if not ints:
        rng = np.random.default_rng(seed)
        a = a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
    m = rf.block_sparse(n, bs, 0.6, 1.0, seed=seed + 2, mask=True)
    return tuple(rf.csr_from_dense(x) for x in (a, b, m))


CASES = {
    "er_sparse_mask": lambda ints: er_case(120, 4.0, 2.0, 1, ints),
    "er_dense_mask": lambda ints: er_case(120, 2.0, 60.0, 2, ints),
    "er_mid": lambda ints: er_case(200, 6.0, 12.0, 3, ints),
    "block_tile": lambda ints: block_case(128, 8, 4, ints),
}


def check_result(got, want, algorithm, ints):
    np.testing.assert_array_equal(got.present.numpy(),
                                  np.asarray(want.present))
    np.testing.assert_array_equal(got.mask_cols.numpy(),
                                  np.asarray(want.mask_cols))
    tol = 0.0 if ints else TOL.get(algorithm, 0.0)
    if tol:
        np.testing.assert_allclose(got.vals.numpy(), np.asarray(want.vals),
                                   rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(got.vals.numpy(),
                                      np.asarray(want.vals))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ints", [True, False])
def test_auto_matches_reference(case, ints):
    A, B, M = CASES[case](ints)
    want_plan = ref_plan(A, B, M)
    got_plan = port_plan(*port(A, B, M), device="cpu")
    assert got_plan.algorithm == want_plan.algorithm
    if case == "block_tile":
        assert got_plan.algorithm == "tile"
    else:
        assert got_plan.algorithm != "tile"
    want = ref_masked_spgemm(A, B, M)
    got = port_masked_spgemm(*port(A, B, M), device="cpu")
    check_result(got, want, got_plan.algorithm, ints)
    np.testing.assert_allclose(got.to_dense().numpy(),
                               np.asarray(want.to_dense()), rtol=1e-4,
                               atol=1e-4)
    gc, wc = got.to_csr(), want.to_csr()
    np.testing.assert_array_equal(gc.indptr, wc.indptr)
    np.testing.assert_array_equal(gc.indices, wc.indices)
    np.testing.assert_allclose(gc.data, wc.data, rtol=1e-4, atol=1e-4)
    assert int(got.nnz) == int(want.nnz)


@pytest.mark.parametrize("bs", [8, 16])
def test_tile_route_matches_row_route_and_oracle(bs):
    """The tile route equals every row kernel bitwise on integer data and
    the dense oracle, explicitly stored zeros included."""
    A, B, M = block_case(64, bs, 7)
    A.data[::7] = 0.0                    # stored zeros stay structural
    At, Bt, Mt = port(A, B, M)
    tile = port_masked_spgemm(At, Bt, Mt, algorithm="tile", tile_block=bs,
                              device="cpu")
    want = ref_masked_spgemm(A, B, M, algorithm="tile", tile_block=bs)
    check_result(tile, want, "tile", ints=True)
    for alg in ("mca", "inner"):
        row = port_masked_spgemm(At, Bt, Mt, algorithm=alg, device="cpu")
        np.testing.assert_array_equal(tile.vals.numpy(), row.vals.numpy())
        np.testing.assert_array_equal(tile.present.numpy(),
                                      row.present.numpy())
    vals, present = dense_oracle(At.to_dense(), Bt.to_dense(), Mt.to_dense(),
                                 device="cpu")
    np.testing.assert_array_equal(tile.to_dense().numpy(),
                                  vals.numpy() * present.numpy())


def test_tile_route_truncated_mask_width():
    """A mask width below the true row width drops the extra slots, as
    the reference's scatter drops them."""
    A, B, M = block_case(64, 8, 9)
    want = ref_masked_spgemm(A, B, M, algorithm="tile", tile_block=8,
                             widths=(1, 1, 5))
    got = port_masked_spgemm(*port(A, B, M), algorithm="tile", tile_block=8,
                             widths=(1, 1, 5), device="cpu")
    check_result(got, want, "tile", ints=True)


def test_tile_route_empty_mask():
    A, B, _ = block_case(32, 8, 10)
    M = rf.csr_from_dense(np.zeros((32, 32), np.float32))
    want = ref_masked_spgemm(A, B, M, algorithm="tile", tile_block=8)
    got = port_masked_spgemm(*port(A, B, M), algorithm="tile", tile_block=8,
                             device="cpu")
    check_result(got, want, "tile", ints=True)


def test_reference_plan_drives_the_port():
    A, B, M = CASES["block_tile"](True)
    p = plan_from_reference(ref_plan(A, B, M))
    got = port_masked_spgemm(*port(A, B, M), plan=p, device="cpu")
    check_result(got, ref_masked_spgemm(A, B, M), "tile", ints=True)


@pytest.mark.parametrize("sr", ["plus_times", "or_and", "min_plus"])
def test_auto_complement_matches_reference(sr):
    A, B, M = er_case(60, 3.0, 8.0, 12, ints=True)
    want = ref_masked_spgemm(A, B, M, complement=True, semiring=REF_SR[sr])
    got = port_masked_spgemm(*port(A, B, M), complement=True,
                             semiring=SR[sr], device="cpu")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("sr", ["plus_times", "min_plus", "plus_first"])
def test_dense_oracle_matches_reference(sr):
    rng = np.random.default_rng(13)
    a = ((rng.random((9, 7)) < 0.4) * rng.integers(1, 5, (9, 7))).astype(
        np.float32)
    b = ((rng.random((7, 11)) < 0.4) * rng.integers(1, 5, (7, 11))).astype(
        np.float32)
    m = (rng.random((9, 11)) < 0.5).astype(np.float32)
    for comp in (False, True):
        got = dense_oracle(a, b, m, semiring=SR[sr], complement=comp,
                           device="cpu")
        want = ref_dense_oracle(a, b, m, semiring=REF_SR[sr],
                                complement=comp)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("scale", [8, 9, 10])
def test_triangle_count_matches_reference(scale):
    g = rf.rmat(scale, 8, seed=scale)
    got, _ = triangle_count(csr_from_reference(g), device="cpu")
    want, _ = ref_tc(g)
    assert got == want
    assert tc_flops(csr_from_reference(g)) == ref_tc_flops(g)


def test_default_device_needs_cuda():
    """Without a card, a call that names no device raises through torch
    instead of carrying on on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    A, B, M = CASES["er_mid"](True)
    with pytest.raises((RuntimeError, AssertionError)):
        port_masked_spgemm(*port(A, B, M))
    with pytest.raises((RuntimeError, AssertionError)):
        port_masked_spgemm(*port(*CASES["block_tile"](True)))
