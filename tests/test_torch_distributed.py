"""Port parity for the distributed routes: ``repro_torch.core.distributed``
(the port's one-process ``Mesh``, row-parallel, the dense ring and the
sparse BCSR ring), the K-slab schedules, the BCSR panel helpers,
``planner.plan_distributed`` / ``explain(DistPlan)``, ``QueryEngine``'s
``mesh=`` and the ``dist`` probes, against the reference's
``repro.core.distributed`` and ``tests/dist_sparse_check.py`` /
``tests/dist_check.py``.

Tolerances: ``array_equal`` on small-integer data, where every summation
order is exact in f32 (the reference's own checks are bitwise there):
ring and row against the port's single-device ``masked_spgemm``, against
``dense_oracle`` and against the reference's distributed routes (at p = 1
in this process, at p = 4 in a child with 4 forced host devices); the
dense ring within 2e-6 normwise of a masked ``torch.matmul``; planner
costs to rtol 1e-12.  Meshes are ``make_mesh(p, device="cpu")``: every
shard on the CPU, where the block product runs its plain version.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

from repro import obs as ref_obs
from repro.core import distributed as rd
from repro.core import formats as rf
from repro.core import planner as rp
from repro.kernels.masked_matmul import ops as rops
from repro.serving import QueryEngine as RefQueryEngine
from repro.tuning import profile as rprofile
from repro_torch import caches, obs, tuning
from repro_torch.core import distributed as td
from repro_torch.core import formats as F
from repro_torch.core import planner
from repro_torch.core.distributed import (Mesh, distributed_masked_spgemm,
                                          make_mesh, pad_rows_to,
                                          ring_masked_matmul,
                                          ring_sparse_masked_spgemm,
                                          row_parallel_masked_spgemm)
from repro_torch.core.formats import CSR, csr_from_dense
from repro_torch.core.masked_spgemm import dense_oracle, masked_spgemm
from repro_torch.core.semiring import MIN_PLUS
from repro_torch.kernels.masked_matmul import ops
from repro_torch.serving import QueryEngine, VirtualClock
from repro_torch.serving.batcher import mesh_key
from repro_torch.tuning import probes
from repro_torch.tuning import profile as tprofile

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
MESH_SIZES = (1, 2, 4, 8)


def int_sparse(rng, m, n, density):
    return ((rng.random((m, n)) < density)
            * rng.integers(1, 5, (m, n))).astype(np.float32)


def ref(x: CSR) -> rf.CSR:
    return rf.CSR(x.indptr, x.indices, x.data, x.shape)


def ref_mesh(p: int = 1) -> RefMesh:
    return RefMesh(np.array(jax.devices()[:p]), ("data",))


def arr(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_result(got, want):
    np.testing.assert_array_equal(arr(got.vals), arr(want.vals))
    np.testing.assert_array_equal(arr(got.present), arr(want.present))
    np.testing.assert_array_equal(arr(got.mask_cols), arr(want.mask_cols))
    assert tuple(got.shape) == tuple(want.shape)


def check_bitwise(out, A, B, M):
    """``out`` equals the port's single-device row kernel and the dense
    oracle, bit for bit (tests/dist_sparse_check.py's check)."""
    Ac, Bc, Mc = csr_from_dense(A), csr_from_dense(B), csr_from_dense(M)
    want = masked_spgemm(Ac, Bc, Mc, algorithm="msa", device=CPU)
    np.testing.assert_array_equal(arr(out.to_dense()), arr(want.to_dense()))
    np.testing.assert_array_equal(arr(out.present), arr(want.present))
    np.testing.assert_array_equal(arr(out.mask_cols), arr(want.mask_cols))
    vals, present = dense_oracle(A, B, M, device=CPU)
    np.testing.assert_array_equal(
        arr(out.to_dense()), np.where(arr(present), arr(vals), 0))


@pytest.fixture(autouse=True)
def _fresh_caches():
    caches.clear_all()
    yield
    caches.clear_all()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_reads_like_a_jax_mesh():
    mesh = make_mesh(4, device=CPU)
    assert mesh.shape == {"data": 4} and int(mesh.shape["data"]) == 4
    assert [str(d) for d in np.ravel(mesh.devices)] == ["cpu"] * 4
    named = Mesh([CPU, torch.device("cpu")], ("model",))
    assert named.axis_names == ("model",) and named.shape == {"model": 2}
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(ValueError):
        Mesh([CPU] * 4, ("data", "model"))
    with pytest.raises(ValueError):
        make_mesh(0, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2)


def test_mesh_key_distinguishes_axis_and_size():
    k2 = mesh_key(make_mesh(2, device=CPU), "data")
    assert k2 == mesh_key(make_mesh(2, device=CPU), "data")
    assert k2 != mesh_key(make_mesh(4, device=CPU), "data")
    assert k2 != mesh_key(make_mesh(2, device=CPU, axis="model"), "model")
    assert mesh_key(None, "data") is None


# ---------------------------------------------------------------------------
# panels and schedules against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,m,n,bs,nparts", [
    (0, 40, 40, 8, 1), (1, 37, 21, 4, 2), (2, 9, 40, 8, 4), (3, 33, 5, 4, 4),
    (4, 1, 1, 8, 2), (5, 64, 16, 8, 8)])
def test_bcsr_panel_split_concat_roundtrip(seed, m, n, bs, nparts):
    rng = np.random.default_rng(seed)
    a = ((rng.random((m, n)) < 0.3)
         * rng.uniform(0.5, 1.5, (m, n))).astype(np.float32)
    b = F.bcsr_from_csr(csr_from_dense(a), bs, device=CPU)
    padded = F.bcsr_pad_block_rows(b, -(-b.block_rows // nparts) * nparts)
    panels = F.bcsr_row_panels(padded, nparts)
    assert len(panels) == nparts
    assert sum(p.nnzb for p in panels) == b.nnzb
    for p in panels:                       # views of the parent's blocks
        assert (p.blocks.untyped_storage().data_ptr()
                == padded.blocks.untyped_storage().data_ptr())
    back = F.bcsr_concat_row_panels(panels)
    np.testing.assert_array_equal(back.indptr, padded.indptr)
    np.testing.assert_array_equal(back.indices, padded.indices)
    np.testing.assert_array_equal(arr(back.blocks), arr(padded.blocks))
    np.testing.assert_array_equal(back.to_dense()[:m, :n], a)
    want = rf.bcsr_row_panels(rf.bcsr_pad_block_rows(
        rf.bcsr_from_csr(ref(csr_from_dense(a)), bs),
        padded.block_rows), nparts)
    for got_p, want_p in zip(panels, want):
        np.testing.assert_array_equal(got_p.indptr, want_p.indptr)
        np.testing.assert_array_equal(got_p.indices, want_p.indices)
        np.testing.assert_array_equal(arr(got_p.blocks),
                                      np.asarray(want_p.blocks))


def test_bcsr_pad_block_rows_is_structural_noop():
    rng = np.random.default_rng(3)
    a = ((rng.random((20, 20)) < 0.3) * 1.0).astype(np.float32)
    b = F.bcsr_from_csr(csr_from_dense(a), 8, device=CPU)
    padded = F.bcsr_pad_block_rows(b, b.block_rows + 3)
    assert padded.block_rows == b.block_rows + 3 and padded.nnzb == b.nnzb
    np.testing.assert_array_equal(padded.to_dense()[:20, :20], a)
    with pytest.raises(ValueError):
        F.bcsr_pad_block_rows(b, b.block_rows - 1)
    with pytest.raises(ValueError):
        F.bcsr_row_panels(b, 2)            # 3 block rows
    structure = F.BCSR(b.indptr, b.indices, None, b.shape, 8)
    assert all(p.blocks is None
               for p in F.bcsr_row_panels(F.bcsr_pad_block_rows(
                   structure, 4), 2))


def _ring_problems():
    """(name, A, B, M) dense problems of tests/dist_sparse_check.py's
    matrix: empty rows and mask columns, non-divisible shapes, K-slabs
    left empty on an 8-stage ring, an empty B, an empty mask panel."""
    rng = np.random.default_rng(0)
    out = []
    for m, k, n in ((64, 64, 64), (50, 33, 70), (8, 80, 24)):
        A = int_sparse(rng, m, k, 0.2)
        A[m // 2, :] = 0.0
        B = int_sparse(rng, k, n, 0.2)
        M = (rng.random((m, n)) < 0.4).astype(np.float32)
        M[:, n // 2] = 0.0
        out.append((f"{m}x{k}x{n}", A, B, M))
    A = int_sparse(rng, 40, 24, 0.3)
    M = (rng.random((40, 40)) < 0.5).astype(np.float32)
    out.append(("empty_slabs", A, int_sparse(rng, 24, 40, 0.3), M))
    out.append(("empty_B", A, np.zeros((24, 40), np.float32), M))
    Mp = M.copy()
    Mp[8:40] = 0.0                         # only the first panels hold M
    out.append(("empty_mask_panels", A, int_sparse(rng, 24, 40, 0.3), Mp))
    return out


RING_PROBLEMS = _ring_problems()


def _struct(x, bs: int):
    """Structure-only BCSR of a host CSR in each package."""
    got = F.bcsr_from_csr(x, bs, device=CPU)
    got = F.BCSR(got.indptr, got.indices, None, got.shape, bs)
    want = rf.bcsr_from_csr(ref(x), bs)
    return got, want


@pytest.mark.parametrize("p", MESH_SIZES)
@pytest.mark.parametrize("prob", RING_PROBLEMS, ids=lambda t: t[0])
def test_ring_schedules_equal_reference(prob, p):
    _, A, B, M = prob
    bs = 8
    Ac, Bc, Mc = csr_from_dense(A), csr_from_dense(B), csr_from_dense(M)
    st = td._ring_prep(Ac, Bc, Mc, bs, make_mesh(p, device=CPU).devices,
                       None)
    want = rd._ring_prep(ref(Ac), ref(Bc), ref(Mc), bs, p, None)
    assert len(st.shards) == p
    assert (st.wa, st.wb) == (want["a_scatter"][-1], want["b_scatter"][-1])
    assert st.wm_blocks == want["wm_blocks"]
    assert st.rows_loc == want["rows_loc"]
    assert st.pm == want["pm"]
    np.testing.assert_array_equal(arr(st.mask_cols),
                                  np.asarray(want["mask_cols"]))
    # the reference pads each panel's extraction entries to one length;
    # a shard keeps its panel's real entries, in CSR order, as flat
    # offsets into its output blocks and its (rows_loc, pm) result rows
    ex_count = (want["ex_rowl"] < want["rows_loc"]).sum(axis=1)
    for d, sh in enumerate(st.shards):
        np.testing.assert_array_equal(arr(sh.sched), want["sched"][d])
        for side, w in (("a", st.wa), ("b", st.wb)):
            pan, loc, r, c, _ = want[f"{side}_scatter"]
            lo, hi = np.searchsorted(pan, [d, d + 1])
            assert getattr(sh, f"{side}_rows") == (lo, hi)
            np.testing.assert_array_equal(
                arr(getattr(sh, f"{side}_flat")),
                ((loc * bs + r) * bs + c)[lo:hi])
            assert getattr(sh, f"{side}_flat").dtype == torch.int32
        np.testing.assert_array_equal(arr(sh.a_pat.float()),
                                      want["a_pat"][d])
        np.testing.assert_array_equal(arr(sh.b_pat.float()),
                                      want["b_pat"][d])
        e = ex_count[d]
        np.testing.assert_array_equal(
            arr(sh.ex_src), ((want["ex_loc"][d, :e] * bs
                              + want["ex_roff"][d, :e]) * bs
                             + want["ex_coff"][d, :e]))
        np.testing.assert_array_equal(
            arr(sh.ex_dst), want["ex_rowl"][d, :e] * st.pm
            + want["ex_slot"][d, :e])
        for key in ("ex_loc", "ex_roff", "ex_coff", "ex_slot", "ex_rowl"):
            assert (want[key][d, e:] == (
                want["rows_loc"] if key == "ex_rowl" else 0)).all()
    # the slab schedules one by one, on the reference's own panels
    a_s, a_r = _struct(Ac, bs)
    b_s, b_r = _struct(Bc, bs)
    m_s, m_r = _struct(Mc, bs)
    rows = -(-a_s.block_rows // p) * p
    kb = -(-b_s.block_rows // p) * p
    A_p = F.bcsr_row_panels(F.bcsr_pad_block_rows(a_s, rows), p)
    M_p = F.bcsr_row_panels(F.bcsr_pad_block_rows(m_s, rows), p)
    B_p = F.bcsr_row_panels(F.bcsr_pad_block_rows(b_s, kb), p)
    rA = rf.bcsr_row_panels(rf.bcsr_pad_block_rows(a_r, rows), p)
    rM = rf.bcsr_row_panels(rf.bcsr_pad_block_rows(m_r, rows), p)
    rB = rf.bcsr_row_panels(rf.bcsr_pad_block_rows(b_r, kb), p)
    for d in range(p):
        for src in range(p):
            g = ops.build_spgemm_schedule_slab(A_p[d], B_p[src], M_p[d],
                                               src * (kb // p))
            w = rops.build_spgemm_schedule_slab(rA[d], rB[src], rM[d],
                                                src * (kb // p))
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y)
    out_pad = max(pm.nnzb for pm in M_p) + 3   # out_pad > every panel
    np.testing.assert_array_equal(
        ops.build_ring_schedules(A_p, B_p, M_p, out_pad=out_pad),
        rops.build_ring_schedules(rA, rB, rM, out_pad=out_pad))


# ---------------------------------------------------------------------------
# the routes on CPU meshes: bitwise the single-device call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", MESH_SIZES)
@pytest.mark.parametrize("prob", RING_PROBLEMS, ids=lambda t: t[0])
def test_ring_bitwise_single_device_and_oracle(prob, p):
    _, A, B, M = prob
    Ac, Bc, Mc = csr_from_dense(A), csr_from_dense(B), csr_from_dense(M)
    out = ring_sparse_masked_spgemm(Ac, Bc, Mc, make_mesh(p, device=CPU),
                                    block_size=8)
    check_bitwise(out, A, B, M)
    tile = masked_spgemm(Ac, Bc, Mc, algorithm="tile", tile_block=8,
                         device=CPU)
    assert_same_result(out, tile)


@pytest.mark.parametrize("p", MESH_SIZES)
@pytest.mark.parametrize("algorithm", ["row", "ring", "auto"])
def test_entry_point_routes_bitwise(algorithm, p):
    rng = np.random.default_rng(7)
    m, k, n = 100, 60, 88                  # m not a multiple of p * bs
    A = int_sparse(rng, m, k, 0.15)
    B = int_sparse(rng, k, n, 0.15)
    M = (rng.random((m, n)) < 0.4).astype(np.float32)
    Ac, Bc, Mc = csr_from_dense(A), csr_from_dense(B), csr_from_dense(M)
    out = distributed_masked_spgemm(Ac, Bc, Mc, make_mesh(p, device=CPU),
                                    algorithm=algorithm)
    check_bitwise(out, A, B, M)


@pytest.mark.parametrize("p", (2, 8))
@pytest.mark.parametrize("row_algorithm", ["msa", "hash", "mca", "heap",
                                           "heapdot", "inner"])
def test_row_route_every_row_kernel_bitwise(row_algorithm, p):
    rng = np.random.default_rng(8)
    A = int_sparse(rng, 50, 30, 0.2)
    B = int_sparse(rng, 30, 44, 0.2)
    M = (rng.random((50, 44)) < 0.3).astype(np.float32)
    out = distributed_masked_spgemm(
        csr_from_dense(A), csr_from_dense(B), csr_from_dense(M),
        make_mesh(p, device=CPU), algorithm="row",
        row_algorithm=row_algorithm)
    check_bitwise(out, A, B, M)


def test_ring_empty_mask_and_default_block():
    rng = np.random.default_rng(1)
    A = csr_from_dense(int_sparse(rng, 32, 32, 0.3))
    Z = csr_from_dense(np.zeros((32, 32), np.float32))
    mesh = make_mesh(8, device=CPU)
    out = ring_sparse_masked_spgemm(A, A, Z, mesh, block_size=8)
    assert int(out.nnz) == 0 and out.vals.shape == (32, 1)
    assert td.ring_prep_cache_info()["size"] == 0     # no prep, no work
    M = csr_from_dense((rng.random((32, 32)) < 0.5).astype(np.float32))
    got = ring_sparse_masked_spgemm(A, A, M, mesh)     # block 32
    want = masked_spgemm(A, A, M, algorithm="msa", device=CPU)
    assert_same_result(got, want)


def test_ring_never_densifies():
    rng = np.random.default_rng(2)
    A, B = int_sparse(rng, 48, 48, 0.25), int_sparse(rng, 48, 48, 0.25)
    M = (rng.random((48, 48)) < 0.5).astype(np.float32)
    Ac, Bc, Mc = csr_from_dense(A), csr_from_dense(B), csr_from_dense(M)

    def boom(self):
        raise AssertionError("to_dense() on the sparse ring path")

    saved = [(cls, cls.to_dense) for cls in (CSR, F.BCSR, F.PaddedCSR)]
    try:
        for cls, _ in saved:
            cls.to_dense = boom
        out = ring_sparse_masked_spgemm(Ac, Bc, Mc,
                                        make_mesh(4, device=CPU),
                                        block_size=8)
    finally:
        for cls, fn in saved:
            cls.to_dense = fn
    assert int(out.nnz) > 0
    check_bitwise(out, A, B, M)


def test_ring_launches_p_squared_fused_replays_and_counts_link_bytes(
        monkeypatch):
    from repro_torch.kernels.masked_matmul import kernel
    calls, sent = [], []
    real = kernel.block_spgemm_with_structure_kernel
    rotate = td._rotate

    def counted(*args):
        calls.append(args[-1])
        return real(*args)

    def counted_rotate(held, devices):
        sent.append(sum(x.nbytes for x in held))
        return rotate(held, devices)

    monkeypatch.setattr(kernel, "block_spgemm_with_structure_kernel",
                        counted)
    monkeypatch.setattr(td, "_rotate", counted_rotate)
    rng = np.random.default_rng(4)
    A = csr_from_dense(int_sparse(rng, 64, 64, 0.2))
    M = csr_from_dense((rng.random((64, 64)) < 0.4).astype(np.float32))
    for p in (2, 4):
        calls.clear()
        sent.clear()
        ring_sparse_masked_spgemm(A, A, M, make_mesh(p, device=CPU),
                                  block_size=8)
        st = td._ring_state(A, A, M, 8, make_mesh(p, device=CPU), "data",
                            None)
        assert len(calls) == p * p
        assert set(calls) == {st.wm_blocks}
        slab = st.wb * 8 * 8 * (4 + 2)     # f32 values + bf16 pattern
        # p - 1 rotations, each of one values and one pattern slab a shard
        assert len(sent) == 2 * (p - 1)
        assert sum(sent) == st.link_bytes() == p * (p - 1) * slab


def test_ring_prep_cache_is_bounded_by_device_bytes():
    rng = np.random.default_rng(9)
    M = csr_from_dense((rng.random((64, 64)) < 0.4).astype(np.float32))
    As = [csr_from_dense(int_sparse(rng, 64, 64, 0.2)) for _ in range(3)]
    mesh = make_mesh(2, device=CPU)
    td.clear_ring_prep_cache()
    ring_sparse_masked_spgemm(As[0], As[0], M, mesh, block_size=8)
    one = td.ring_prep_cache_info()["bytes"]
    st = td._ring_state(As[0], As[0], M, 8, mesh, "data", None)
    assert one == st.nbytes() > 0
    saved = td._ring_prep_cache._max_bytes
    try:
        td._ring_prep_cache._max_bytes = int(one * 2.5)
        for a in As[1:]:
            ring_sparse_masked_spgemm(a, a, M, mesh, block_size=8)
        info = td.ring_prep_cache_info()
        assert info["size"] == 2 and info["bytes"] <= info["max_bytes"]
        # the least recently used structure went first
        misses = info["misses"]
        ring_sparse_masked_spgemm(As[0], As[0], M, mesh, block_size=8)
        assert td.ring_prep_cache_info()["misses"] == misses + 1
        # an entry larger than the bound alone is still kept
        td._ring_prep_cache._max_bytes = 1
        ring_sparse_masked_spgemm(As[1], As[1], M, mesh, block_size=8)
        assert td.ring_prep_cache_info()["size"] == 1
    finally:
        td._ring_prep_cache._max_bytes = saved
        td.clear_ring_prep_cache()


def test_ring_prep_is_cached_by_structure_and_mesh():
    rng = np.random.default_rng(5)
    A = csr_from_dense(int_sparse(rng, 64, 64, 0.2))
    M = csr_from_dense((rng.random((64, 64)) < 0.4).astype(np.float32))
    A2 = CSR(A.indptr, A.indices, A.data * 2, A.shape)   # same structure
    mesh = make_mesh(2, device=CPU)
    ring_sparse_masked_spgemm(A, A, M, mesh, block_size=8)
    ring_sparse_masked_spgemm(A2, A, M, mesh, block_size=8)
    info = td.ring_prep_cache_info()
    assert (info["misses"], info["hits"], info["size"]) == (1, 1, 1)
    ring_sparse_masked_spgemm(A, A, M, make_mesh(4, device=CPU),
                              block_size=8)
    assert td.ring_prep_cache_info()["size"] == 2
    assert "ring-prep" in caches.cache_info()
    td.clear_ring_prep_cache()
    assert td.ring_prep_cache_info()["size"] == 0


def test_wm_narrower_than_mask_rows_drops_entries_as_the_reference():
    rng = np.random.default_rng(6)
    A = csr_from_dense(int_sparse(rng, 32, 32, 0.3))
    M = csr_from_dense((rng.random((32, 32)) < 0.5).astype(np.float32))
    got = ring_sparse_masked_spgemm(A, A, M, make_mesh(2, device=CPU),
                                    block_size=8, wm=5)
    want = rd.ring_sparse_masked_spgemm(ref(A), ref(A), ref(M), ref_mesh(1),
                                        block_size=8, wm=5)
    # the reference's mesh has one device: its p = 1 shard extracts the
    # same mask-aligned slots the port's two shards do
    assert_same_result(got, want)


def test_unsupported_products_raise_or_go_to_the_row_route():
    rng = np.random.default_rng(9)
    A = int_sparse(rng, 40, 24, 0.3)
    B = int_sparse(rng, 24, 40, 0.3)
    M = (rng.random((40, 40)) < 0.5).astype(np.float32)
    Ac, Bc, Mc = csr_from_dense(A), csr_from_dense(B), csr_from_dense(M)
    mesh = make_mesh(4, device=CPU)
    with pytest.raises(NotImplementedError, match="plus_times"):
        distributed_masked_spgemm(Ac, Bc, Mc, mesh, algorithm="ring",
                                  semiring=MIN_PLUS)
    with pytest.raises(NotImplementedError, match="complemented"):
        distributed_masked_spgemm(Ac, Bc, Mc, mesh, complement=True)
    with pytest.raises(NotImplementedError, match="host CSR"):
        distributed_masked_spgemm(F.padded_from_csr(Ac, device=CPU), Bc,
                                  Mc, mesh)
    with pytest.raises(ValueError, match="unknown"):
        distributed_masked_spgemm(Ac, Bc, Mc, mesh, algorithm="tile")
    dplan = planner.plan_distributed(Ac, Bc, Mc, 4, semiring=MIN_PLUS)
    assert dplan.route == "row" and dplan.tile_block == 0
    with obs.tracing() as tr:
        out = distributed_masked_spgemm(Ac, Bc, Mc, mesh, algorithm="auto",
                                        semiring=MIN_PLUS)
    assert [r["attrs"].get("route") for r in tr.sink.spans()
            if r["name"] == "spgemm.dist"] == ["row"]
    want = masked_spgemm(Ac, Bc, Mc, algorithm="msa", semiring=MIN_PLUS,
                         device=CPU)
    np.testing.assert_array_equal(arr(out.to_dense()), arr(want.to_dense()))


def test_row_parallel_pads_and_splits_rows():
    rng = np.random.default_rng(10)
    m, k, n = 30, 20, 25
    A = ((rng.random((m, k)) < 0.2) * rng.uniform(0.5, 1.5, (m, k))
         ).astype(np.float32)
    B = ((rng.random((k, n)) < 0.2) * rng.uniform(0.5, 1.5, (k, n))
         ).astype(np.float32)
    M = (rng.random((m, n)) < 0.3).astype(np.float32)
    Ap, Bp, Mp = (F.padded_from_csr(csr_from_dense(x), device=CPU)
                  for x in (A, B, M))
    Ap4, Mp4 = pad_rows_to(4, Ap, Mp)
    assert Ap4.shape == (32, k) and Mp4.shape == (32, n)
    assert int(Mp4.lens[m:].abs().sum()) == 0
    assert bool((Mp4.cols[m:] == n).all())
    assert pad_rows_to(2, Ap)[0] is Ap                   # already even
    with pytest.raises(ValueError, match="pad_rows_to"):
        row_parallel_masked_spgemm(Ap, Bp, Mp, make_mesh(4, device=CPU))
    vals, present = row_parallel_masked_spgemm(Ap4, Bp, Mp4,
                                               make_mesh(4, device=CPU))
    want = masked_spgemm(csr_from_dense(A), csr_from_dense(B),
                         csr_from_dense(M), algorithm="msa", device=CPU)
    np.testing.assert_array_equal(arr(vals[:m]), arr(want.vals))
    np.testing.assert_array_equal(arr(present[:m]), arr(want.present))
    # complemented masks: the row route's dense outputs, sharded by rows
    cv, cp = row_parallel_masked_spgemm(Ap4, Bp, Mp4,
                                        make_mesh(4, device=CPU),
                                        complement=True)
    wv, wp = masked_spgemm(csr_from_dense(A), csr_from_dense(B),
                           csr_from_dense(M), algorithm="msa",
                           complement=True, device=CPU)
    np.testing.assert_array_equal(arr(cv[:m]), arr(wv))
    np.testing.assert_array_equal(arr(cp[:m]), arr(wp))


@pytest.mark.parametrize("p", (1, 2, 4))
def test_dense_ring_matches_masked_matmul_and_skips_panels(p):
    rng = np.random.default_rng(0)
    m, k, n = 32, 64, 40
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    mask = torch.from_numpy((rng.random((m, n)) < 0.5).astype(np.float32))
    mesh = make_mesh(p, device=CPU)
    for mk, block in ((mask, 128), (mask.clone(), 8)):
        if block == 8:       # 5 column panels; panels 1 and 3 masked out
            mk[:, 8:16] = 0.0
            mk[:, 24:32] = 0.0
        got = ring_masked_matmul(a, b, mk, mesh, block=block)
        want = torch.where(mk != 0, a.double() @ b.double(), 0.0)
        err = float((got.double() - want).norm() / want.norm())
        assert err <= 2e-6, err
        f32 = torch.where(mk != 0, a @ b, 0.0)
        assert float((got - f32).norm() / f32.norm()) <= 2e-6
        if block == 8:
            assert float(got[:, 8:16].abs().sum()) == 0.0
            assert float(got[:, 24:32].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="split evenly"):
        ring_masked_matmul(a[:30], b, mask[:30], make_mesh(4, device=CPU))
    with pytest.raises(ValueError, match="precision"):
        ring_masked_matmul(a, b, mask, mesh, precision="tf32")


def test_dense_ring_bf16_inputs_accumulate_in_f32():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((32, 24)).astype(np.float32))
    mask = torch.ones(16, 24)
    got = ring_masked_matmul(a.bfloat16(), b.bfloat16(), mask,
                             make_mesh(2, device=CPU), block=8)
    assert got.dtype == torch.bfloat16
    want = a.bfloat16().double() @ b.bfloat16().double()
    # the f32 accumulation, rounded once to bf16 (8 mantissa bits)
    assert float((got.double() - want).norm() / want.norm()) <= 2.0 ** -8


# ---------------------------------------------------------------------------
# against the reference's own distributed routes
# ---------------------------------------------------------------------------


def _ref_problem(seed: int):
    rng = np.random.default_rng(seed)
    A = int_sparse(rng, 72, 56, 0.2)
    B = int_sparse(rng, 56, 64, 0.2)
    M = (rng.random((72, 64)) < 0.4).astype(np.float32)
    return A, B, M


@pytest.mark.parametrize("algorithm", ["row", "ring", "auto"])
def test_p1_equals_reference_in_process(algorithm):
    A, B, M = (csr_from_dense(x) for x in _ref_problem(11))
    got = distributed_masked_spgemm(A, B, M, make_mesh(1, device=CPU),
                                    algorithm=algorithm)
    want = rd.distributed_masked_spgemm(ref(A), ref(B), ref(M), ref_mesh(1),
                                        algorithm=algorithm)
    assert_same_result(got, want)
    if algorithm == "ring":
        got = ring_sparse_masked_spgemm(A, B, M, make_mesh(1, device=CPU),
                                        block_size=8)
        want = rd.ring_sparse_masked_spgemm(ref(A), ref(B), ref(M),
                                            ref_mesh(1), block_size=8)
        assert_same_result(got, want)


REF_CHILD = r"""
import sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core.distributed import distributed_masked_spgemm
from repro.core.formats import CSR
assert jax.device_count() == 4, jax.devices()
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
z = np.load(sys.argv[1])
ops = [CSR(z[k + "_indptr"], z[k + "_indices"], z[k + "_data"],
           tuple(z[k + "_shape"])) for k in "ABM"]
out = {}
for alg in ("ring", "row"):
    r = distributed_masked_spgemm(*ops, mesh, algorithm=alg, block_size=8)
    out[alg + "_vals"] = np.asarray(r.vals)
    out[alg + "_present"] = np.asarray(r.present)
    out[alg + "_cols"] = np.asarray(r.mask_cols)
np.savez(sys.argv[2], **out)
print("REF_OK")
"""


def test_p4_equals_reference_with_four_host_devices(tmp_path):
    A, B, M = (csr_from_dense(x) for x in _ref_problem(12))
    inp, outp = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, **{f"{k}_{f}": getattr(x, f)
                     for k, x in zip("ABM", (A, B, M))
                     for f in ("indptr", "indices", "data", "shape")})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", REF_CHILD, str(inp),
                           str(outp)], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0 and "REF_OK" in proc.stdout, \
        proc.stdout + proc.stderr
    want = np.load(outp)
    mesh = make_mesh(4, device=CPU)
    for alg in ("ring", "row"):
        got = distributed_masked_spgemm(A, B, M, mesh, algorithm=alg,
                                        block_size=8)
        np.testing.assert_array_equal(arr(got.vals), want[alg + "_vals"])
        np.testing.assert_array_equal(arr(got.present),
                                      want[alg + "_present"])
        np.testing.assert_array_equal(arr(got.mask_cols),
                                      want[alg + "_cols"])


# ---------------------------------------------------------------------------
# the distributed planner
# ---------------------------------------------------------------------------


def _planner_operands():
    out = [(F.erdos_renyi(96, 4, seed=1), F.erdos_renyi(96, 4, seed=2),
            F.er_mask(96, 8, seed=3))]
    for n, bs, td_, mo in ((128, 8, 0.4, 0.6), (256, 32, 0.3, 0.5),
                           (64, 8, 0.05, 0.2)):
        out.append(tuple(csr_from_dense(x) for x in (
            F.block_sparse(n, bs, td_, 0.9, seed=1),
            F.block_sparse(n, bs, td_, 0.9, seed=2),
            F.block_sparse(n, bs, mo, 1.0, seed=3, mask=True))))
    return out


PLANNER_OPERANDS = _planner_operands()


def _builtin(snapshot):
    return dataclasses.replace(
        snapshot(name="builtin", backend={"platform": "test",
                                          "device_kind": "test",
                                          "device_count": 1}),
        version="builtin")


BUILTIN = _builtin(tprofile.snapshot)
REF_BUILTIN = _builtin(rprofile.snapshot)


def _warped():
    """Row constants x100 / x0.01 in alternation, replication x1000 and
    ring bytes x0.001: the ranking and the route election move."""
    p = BUILTIN
    cc = {alg: {k: v * (100.0 if i % 2 else 0.01) for k, v in tbl.items()}
          for i, (alg, tbl) in enumerate(sorted(p.cost_constants.items()))}
    dc = dict(p.dist_cost, per_bcast_elem=p.dist_cost["per_bcast_elem"] * 1e3,
              per_ring_byte=p.dist_cost["per_ring_byte"] * 1e-3)
    return dataclasses.replace(p, name="dist-warped", cost_constants=cc,
                               dist_cost=dc, version="dist-warped")


@pytest.fixture
def builtin_tables():
    def restore():
        tuning.activate(BUILTIN)
        planner.clear_plan_cache()
        rprofile.activate(REF_BUILTIN)
        rp.clear_plan_cache()
    restore()
    try:
        yield
    finally:
        restore()


@pytest.mark.parametrize("warp", [False, True], ids=["builtin", "warped"])
@pytest.mark.parametrize("p", MESH_SIZES)
def test_decide_distributed_equals_reference(p, warp, builtin_tables):
    if warp:
        prof = _warped()
        tuning.activate(prof)
        rprofile.activate(rprofile.CalibrationProfile.from_json(
            prof.to_json()))
    assert planner.cost_model_token() == rp.cost_model_token()
    for A, B, M in PLANNER_OPERANDS:
        s = planner.collect_stats(A, B, M)
        rs = rp.collect_stats(ref(A), ref(B), ref(M))
        assert dataclasses.asdict(s) == dataclasses.asdict(rs)
        got, want = planner.decide_distributed(s, p), \
            rp.decide_distributed(rs, p)
        assert (got.route, got.p, got.tile_block, got.row_algorithm) == (
            want.route, want.p, want.tile_block, want.row_algorithm)
        assert [c[0] for c in got.costs] == [c[0] for c in want.costs]
        np.testing.assert_allclose([c[1] for c in got.costs],
                                   [c[1] for c in want.costs], rtol=1e-12)
        assert planner.distributed_costs(s, p) == got.costs
        for bs in planner.ring_block_candidates(s.m, s.k, s.n):
            np.testing.assert_allclose(planner.ring_cost(s, p, bs),
                                       rp.ring_cost(rs, p, bs), rtol=1e-12)


def test_plan_distributed_caches_under_the_cost_model_token(builtin_tables):
    A, B, M = PLANNER_OPERANDS[1]
    first = planner.plan_distributed(A, B, M, 4)
    assert planner.plan_distributed(A, B, M, 4) is first
    assert planner.plan_distributed(A, B, M, 2) is not first
    assert planner.plan_distributed(A, B, M, 4, use_cache=False) == first
    token = planner.cost_model_token()
    tuning.activate(_warped())
    assert planner.cost_model_token() != token
    warped = planner.plan_distributed(A, B, M, 4)
    assert warped is not first and warped.costs != first.costs
    assert planner.plan_distributed(A, B, M, 4) is warped


@pytest.mark.parametrize("case", range(len(PLANNER_OPERANDS)))
def test_explain_dist_plan_equals_reference(case, builtin_tables):
    A, B, M = PLANNER_OPERANDS[case]
    got = planner.plan_distributed(A, B, M, 2)
    want = rp.plan_distributed(ref(A), ref(B), ref(M), 2)
    info = planner.explain(got)
    assert info == rp.explain(want)
    assert info["route"] == info["elected"] == got.route
    assert info["p"] == 2 and set(info["costs_ms"]) >= {"row", "ring"}
    assert info["elected_cost_ms"] == min(info["costs_ms"].values())
    assert "ring" in info["features"]
    json.dumps(info)
    assert planner.feature_regime(got) == rp.feature_regime(want)
    assert planner.explain_cached(got) is planner.explain_cached(got)


# ---------------------------------------------------------------------------
# serving: QueryEngine(mesh=)
# ---------------------------------------------------------------------------


def _serve_problem():
    rng = np.random.default_rng(20)
    A = csr_from_dense(int_sparse(rng, 64, 48, 0.2))
    B = csr_from_dense(int_sparse(rng, 48, 56, 0.2))
    M = csr_from_dense((rng.random((64, 56)) < 0.4).astype(np.float32))
    return A, B, M


def _revalue(x: CSR, seed: int) -> CSR:
    rng = np.random.default_rng(seed)
    return CSR(x.indptr, x.indices,
               rng.integers(1, 5, x.nnz).astype(np.float32), x.shape)


def _drain_virtual(eng, tickets, timeout=60.0):
    end = time.monotonic() + timeout
    while not all(t.done() for t in tickets):
        assert time.monotonic() < end, "virtual drain timed out"
        d = eng.next_flush_deadline()
        if d is not None:
            eng.clock.advance_to(max(d + 1e-9, eng.clock.now()))
        time.sleep(0.002)


@pytest.mark.parametrize("algorithm", [None, "ring", "row"])
@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_engine_serves_mesh_requests_bitwise_one_shot(async_mode,
                                                      algorithm):
    A, B, M = _serve_problem()
    mesh = make_mesh(2, device=CPU)
    stream = [_revalue(A, s) for s in range(4)]
    kw = dict(async_mode=True, max_wait_ms=10.0, clock=VirtualClock()) \
        if async_mode else {}
    with QueryEngine(device=CPU, cache_results=False, **kw) as eng:
        misses = planner.plan_cache_info()["misses"]
        tickets = [eng.submit(a, B, M, mesh=mesh, algorithm=algorithm)
                   for a in stream]
        if async_mode:
            _drain_virtual(eng, tickets)
        else:
            eng.flush()
        results = [t.result(timeout=30.0) for t in tickets]
        log = eng.metrics.bucket_log()
    # one dist plan for the bucket (auto), and one ring prep
    assert planner.plan_cache_info()["misses"] - misses == (
        1 if algorithm is None else 0)
    assert [b["route"] for b in log] == ["distributed"]
    assert log[0]["size"] == 4
    elected = planner.plan_distributed(A, B, M, 2).route
    assert log[0]["algorithm"] == (algorithm or elected)
    if (algorithm or elected) == "ring":
        info = td.ring_prep_cache_info()
        assert (info["misses"], info["hits"]) == (1, 3)
    for a, got in zip(stream, results):
        want = distributed_masked_spgemm(a, B, M, mesh,
                                         algorithm=algorithm or "auto")
        assert_same_result(got, want)


def test_engine_result_cache_keys_the_mesh():
    A, B, M = _serve_problem()
    with QueryEngine(device=CPU) as eng:
        t1 = eng.submit(A, B, M, mesh=make_mesh(2, device=CPU))
        t2 = eng.submit(A, B, M, mesh=make_mesh(4, device=CPU))
        t3 = eng.submit(A, B, M)
        eng.flush()
        t4 = eng.submit(A, B, M, mesh=make_mesh(2, device=CPU))
        assert t4.done()                         # a cache hit
        routes = [b["route"] for b in eng.metrics.bucket_log()]
    assert routes.count("distributed") == 2 and len(routes) == 3
    for t in (t1, t2, t3, t4):
        assert_same_result(t.result(), t3.result())


def test_engine_mesh_spans_equal_reference_at_p1():
    A, B, M = _serve_problem()
    stream = [(_revalue(A, s), {}) for s in range(3)] + [
        (A, {"algorithm": "ring"}), (A, {"algorithm": "row"})]
    planner.clear_plan_cache()
    rp.clear_plan_cache()
    from repro import caches as ref_caches
    ref_caches.clear_all()

    def run(module, engine, mesh, conv, **kw):
        with module.tracing() as tr:
            with engine(max_batch=8, **kw) as eng:
                ts = [eng.submit(conv(a), conv(B), conv(M), mesh=mesh, **o)
                      for a, o in stream]
                eng.flush()
                eng.serve([(conv(stream[0][0]), conv(B), conv(M))])
            res = [t.result() for t in ts]
        module.disable()
        return tr.sink.spans(), res

    got, got_res = run(obs, QueryEngine, make_mesh(1, device=CPU),
                       lambda x: x, device=CPU)
    want, want_res = run(ref_obs, RefQueryEngine, ref_mesh(1), ref)

    def shape(recs):
        return [(r["name"], r["span"], r.get("parent"), r["trace"])
                for r in recs]

    assert shape(got) == shape(want)
    assert [r["attrs"] for r in got if r["name"] == "spgemm.dist"] == \
        [r["attrs"] for r in want if r["name"] == "spgemm.dist"]
    assert {r["attrs"]["route"] for r in got
            if r["name"] == "spgemm.dist"} == {"row", "ring"}
    for g, w in zip(got_res, want_res):
        assert_same_result(g, w)


# ---------------------------------------------------------------------------
# the dist probes and `repro_torch.tune --only dist`
# ---------------------------------------------------------------------------


def test_probe_dist_points_equal_reference_stats(builtin_tables):
    ms = probes.probe_dist(smoke=True, device=CPU, log=lambda *_: None)
    spec = probes._dist_spec(True)
    points = {pt: (A, B, M) for pt, A, B, M in probes.dist_points(
        spec["n"], spec["densities_b"])}
    assert len(ms) == 2 * len(points) * len(spec["mesh_sizes"])
    assert {m.target for m in ms} == {"ring", "row"}
    for m in ms:
        name, p = m.point.rsplit("_p", 1)
        A, B, M = (rf.csr_from_dense(np.asarray(x)) for x in points[name])
        rs = rp.collect_stats(A, B, M)
        feats = dict(m.features)
        assert feats.pop("p") == float(p)
        dplan = rp.decide_distributed(rs, int(p))
        assert feats.pop("bs") == float(dplan.tile_block or 32)
        assert feats.pop("row_algorithm") == dplan.row_algorithm
        assert feats == {k: (float(v) if not isinstance(v, (str, bool))
                             else v)
                         for k, v in dataclasses.asdict(rs).items()}
        assert m.seconds > 0
    assert probes.dist_calls(smoke=True) == (
        (len(spec["densities_b"]) + 1) * (probes.WARMUP + spec["iters"])
        * sum(p * p for p in spec["mesh_sizes"]))


def test_tune_only_dist_runs_on_the_cpu_with_jax_blocked(tmp_path):
    out = tmp_path / "dist.json"
    code = ("import sys; sys.modules['jax'] = None; "
            "from repro_torch.tuning.cli import main; "
            f"sys.exit(main(['--only', 'dist', '--smoke', '--device', "
            f"'cpu', '--out', {str(out)!r}]))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "probing families: dist" in proc.stdout
    p = tuning.CalibrationProfile.load(str(out))
    assert set(p.residuals) == {"dist"}
    assert np.isfinite(p.residuals["dist"])
    assert p.cost_constants == BUILTIN.cost_constants
    assert all(v >= 0 for v in p.dist_cost.values())
