"""Port parity for incremental serving: ``CSRDelta`` / ``apply_csr_delta``
/ ``incremental_signature`` / ``bcsr_apply_delta``, ``planner.revalidate``,
burst lane patching and lineage, scoped result-cache invalidation,
``Batcher.rekey`` and ``QueryEngine.submit_delta``, against the reference
package on the same seeded inputs; one test for each of the reference's
``tests/test_incremental.py``, the rotating-sink ones included.

Tolerances: exact everywhere on the host (CSR arrays, signatures, lane
tables, bitmaps, counters); results bitwise against the reference engine
and the port's own cold recompute on the row routes; on the tile route
(the interleaving's block-sparse bucket, float data) bitwise against the
port's own one-shot call and within the block product's reference
tolerance, 1e-4, of the reference engine.  The reference's hypothesis
property test has a steady counterpart here: eight fixed draws (its two
known falsifying draws among them), each run twice through the port.
"""
import gc
import os
import weakref

import numpy as np
import pytest
import torch

from repro import caches as ref_caches
from repro.core import formats as rf
from repro.core import planner as rp
from repro.core.semiring import PLUS_TIMES as REF_PLUS_TIMES
from repro.serving import QueryEngine as RefQueryEngine
from repro.serving import ResultCache as RefResultCache
from repro.serving import VirtualClock as RefVirtualClock
from repro.serving import burst as ref_burst
from repro.serving import row_bitmap as ref_row_bitmap
from repro.serving.batcher import Batcher as RefBatcher
from repro.serving.batcher import Request as RefRequest
from repro_torch import caches
from repro_torch.convert import delta_from_reference, plan_from_reference
from repro_torch.core import formats as F
from repro_torch.core.formats import (CSR, CSRDelta, apply_csr_delta,
                                      bcsr_apply_delta, bcsr_from_csr,
                                      incremental_signature)
from repro_torch.core.masked_spgemm import masked_spgemm
from repro_torch.core.planner import (clear_plan_cache, cost_model_token,
                                      plan, revalidate)
from repro_torch.core.semiring import PLUS_TIMES
from repro_torch.serving import (QueryEngine, ResultCache, VirtualClock,
                                 burst, result_key, row_bitmap)
from repro_torch.serving.batcher import Batcher, Request

from test_torch_serving import POOL, arr, assert_same_result, revalue

CPU = "cpu"


@pytest.fixture(autouse=True)
def _cold_caches():
    """Every test starts with both packages' plan caches, burst programs,
    patches and lineage empty, so their memo hits cannot differ."""
    caches.clear_all()
    ref_caches.clear_all()
    clear_plan_cache()
    rp.clear_plan_cache()
    yield


def ref(x: CSR) -> rf.CSR:
    return rf.CSR(x.indptr, x.indices, x.data, x.shape)


def ref_delta(d: CSRDelta) -> rf.CSRDelta:
    return rf.CSRDelta(d.rows, d.cols, d.vals, d.delete)


def same_csr(got: CSR, want) -> None:
    for a, b in ((got.indptr, want.indptr), (got.indices, want.indices),
                 (got.data, want.data)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tuple(got.shape) == tuple(want.shape)


def dense(x: CSR) -> np.ndarray:
    out = np.zeros(x.shape, dtype=x.data.dtype)
    for i in range(x.shape[0]):
        s, e = x.indptr[i], x.indptr[i + 1]
        out[i, x.indices[s:e]] = x.data[s:e]
    return out


def random_delta(rng, x: CSR, k: int = 6) -> CSRDelta:
    """The reference test's mixed batch: upserts to fresh and existing
    coordinates plus deletes (some of missing entries: no-ops)."""
    m, n = x.shape
    rows = rng.integers(0, m, k).astype(np.int64)
    cols = rng.integers(0, n, k).astype(np.int64)
    vals = rng.uniform(0.5, 1.5, k).astype(x.data.dtype)
    delete = rng.random(k) < 0.3
    return CSRDelta(rows, cols, vals, delete)


def values_delta(rng, x: CSR, k: int = 4) -> CSRDelta:
    """Upserts confined to EXISTING coordinates: structure survives."""
    if x.nnz == 0:
        return CSRDelta.upserts(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                np.zeros(0, x.data.dtype))
    pos = rng.integers(0, x.nnz, min(k, x.nnz))
    er = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr))
    return CSRDelta.upserts(er[pos], x.indices[pos],
                            rng.uniform(0.5, 1.5, len(pos)).astype(
                                x.data.dtype))


def burst_triple(n=128, seed=0):
    """Sparse A/B + wide mask: an msa/hash/mca election, so the engine
    serves it on the burst route."""
    return (F.erdos_renyi(n, 2, seed=100 + seed),
            F.erdos_renyi(n, 2, seed=200 + seed),
            F.er_mask(n, max(8, n // 8), seed=300 + seed))


def engine(**kw):
    return QueryEngine(device=CPU, **kw)


def same_plan(p, rplan) -> None:
    q = plan_from_reference(rplan)
    assert (p.algorithm, p.widths, p.tile_eligible, p.tile_block) == \
        (q.algorithm, q.widths, q.tile_eligible, q.tile_block)
    assert p.stats == q.stats


# ---------------------------------------------------------------------------
# formats: CSRDelta application + incremental signature
# ---------------------------------------------------------------------------


def test_apply_csr_delta_matches_dense_oracle():
    x = F.erdos_renyi(40, 3, seed=1)
    rd = rf.CSRDelta(
        np.array([2, 2, 7, 7, 39, 2]),
        np.array([5, 6, 0, 0, 39, 5]),
        np.array([1.5, 2.5, 3.5, 4.5, 5.5, 9.0], dtype=x.data.dtype),
        np.array([False, False, False, True, False, False]))
    d = delta_from_reference(rd)
    res = apply_csr_delta(x, d)
    want = dense(x)
    want[2, 5] = 9.0          # second upsert to (2,5) wins (applied in order)
    want[2, 6] = 2.5
    want[7, 0] = 0.0          # upsert then delete -> absent
    want[39, 39] = 5.5
    assert 0 not in res.csr.row(7)[0]
    np.testing.assert_array_equal(dense(res.csr), want)
    assert list(res.changed_rows) == [2, 7, 39]
    assert not res.values_only
    assert res.signature == incremental_signature(res.csr)
    np.testing.assert_array_equal(res.csr.row(5)[0], x.row(5)[0])
    r = rf.apply_csr_delta(ref(x), rd)
    same_csr(res.csr, r.csr)
    assert res.signature == r.signature
    np.testing.assert_array_equal(res.changed_rows, r.changed_rows)


@pytest.mark.parametrize("sorted_rows", [True, False])
def test_incremental_signature_chain_matches_recompute(sorted_rows):
    """A chain of deltas gives the reference's CSR arrays and signature
    integers at every step, on row-sorted operands (the splice) and on
    rows out of column order (the re-sort).  A row's hash reads its
    columns in stored order, so only on sorted rows does the chain equal
    a recompute (in both packages)."""
    rng = np.random.default_rng(7)
    x = F.erdos_renyi(48, 3, seed=2)
    if not sorted_rows:
        perm = np.concatenate([np.arange(s, e)[::-1] for s, e in
                               zip(x.indptr[:-1], x.indptr[1:])])
        x = CSR(x.indptr, x.indices[perm], x.data[perm], x.shape)
    rx = ref(x)
    sig = incremental_signature(x)
    rsig = rf.incremental_signature(rx)
    assert sig == rsig
    for step in range(5):
        d = random_delta(rng, x)
        res = apply_csr_delta(x, d, old_signature=sig)
        rres = rf.apply_csr_delta(rx, ref_delta(d), old_signature=rsig)
        if sorted_rows:
            assert res.signature == incremental_signature(res.csr), step
        assert res.signature == rres.signature, step
        assert res.values_only == rres.values_only
        same_csr(res.csr, rres.csr)
        x, sig = res.csr, res.signature
        rx, rsig = rres.csr, rres.signature
    if sorted_rows:
        y = CSR(x.indptr, x.indices, x.data * 2.0, x.shape)
        assert incremental_signature(y) == sig


def test_values_only_delta_detected():
    rng = np.random.default_rng(3)
    x = F.erdos_renyi(32, 3, seed=3)
    d = values_delta(rng, x)
    res = apply_csr_delta(x, d)
    assert res.values_only
    assert res.signature == incremental_signature(x)
    same_csr(res.csr, rf.apply_csr_delta(ref(x), ref_delta(d)).csr)
    col = next(c for c in range(32) if c not in set(x.row(0)[0].tolist()))
    res2 = apply_csr_delta(x, CSRDelta.upserts([0], [col], [1.0]))
    assert not res2.values_only


def test_apply_csr_delta_validates():
    x = F.erdos_renyi(16, 2, seed=4)
    with pytest.raises(ValueError):
        apply_csr_delta(x, CSRDelta.upserts([16], [0], [1.0]))
    with pytest.raises(ValueError):
        apply_csr_delta(x, CSRDelta.upserts([0], [0], [1.0]),
                        old_signature=("icsr", (8, 8), 0, 0))
    with pytest.raises(ValueError):
        CSRDelta(np.zeros(2), np.zeros(1), np.zeros(2), np.zeros(2, bool))


@pytest.mark.parametrize("structure_only", [False, True])
def test_bcsr_apply_delta_matches_rebuild(structure_only):
    """The result equals the reference's ``bcsr_apply_delta`` (which
    rebuilds only the affected block rows) and a rebuild, array for
    array (exact)."""
    rng = np.random.default_rng(5)
    x = F.csr_from_dense(F.block_sparse(48, 8, 0.5, 0.6, seed=6))
    b0 = bcsr_from_csr(x, 8, device=CPU)
    if structure_only:
        b0 = F.BCSR(b0.indptr, b0.indices, None, b0.shape, 8)
    d = random_delta(rng, x, k=8)
    res = apply_csr_delta(x, d)
    got = bcsr_apply_delta(b0, res.csr, res.changed_rows)
    want = rf.bcsr_from_csr(ref(res.csr), 8)
    r = rf.bcsr_apply_delta(rf.bcsr_from_csr(ref(x), 8), ref(res.csr),
                            res.changed_rows)
    for w in (want, r):
        np.testing.assert_array_equal(got.indptr, np.asarray(w.indptr))
        np.testing.assert_array_equal(got.indices, np.asarray(w.indices))
        if structure_only:
            assert got.blocks is None
        else:
            np.testing.assert_array_equal(got.blocks.numpy(),
                                          np.asarray(w.blocks))
    assert bcsr_apply_delta(b0, res.csr, np.zeros(0, np.int64)) is b0


# ---------------------------------------------------------------------------
# planner: revalidate
# ---------------------------------------------------------------------------


def test_revalidate_survives_row_local_delta_and_stamps_cache():
    rng = np.random.default_rng(8)
    A, B, M = burst_triple(seed=1)
    p0 = plan(A, B, M, device=CPU)
    d = random_delta(rng, M, k=4)
    M1 = apply_csr_delta(M, d).csr
    p1, survived = revalidate(p0, A, B, M1, device=CPU)
    assert survived
    assert p1.algorithm == p0.algorithm
    assert plan(A, B, M1, device=CPU) is p1
    rp0 = rp.plan(ref(A), ref(B), ref(M))
    rp1, rsurvived = rp.revalidate(rp0, ref(A), ref(B), ref(M1))
    assert rsurvived
    same_plan(p1, rp1)


def test_revalidate_goes_cold_past_hysteresis():
    rng = np.random.default_rng(9)
    A, B, M = burst_triple(seed=2)
    p0 = plan(A, B, M, device=CPU)
    rows = rng.integers(0, M.shape[0], 3000).astype(np.int64)
    cols = rng.integers(0, M.shape[1], 3000).astype(np.int64)
    big = CSRDelta.upserts(rows, cols, np.ones(3000, dtype=M.data.dtype))
    M1 = apply_csr_delta(M, big).csr
    p1, survived = revalidate(p0, A, B, M1, device=CPU)
    assert not survived
    assert p1.algorithm == plan(A, B, M1, device=CPU).algorithm
    rp1, rsurvived = rp.revalidate(rp.plan(ref(A), ref(B), ref(M)),
                                   ref(A), ref(B), ref(M1))
    assert not rsurvived
    same_plan(p1, rp1)


def test_revalidate_rejects_mismatched_operands():
    A, B, M = burst_triple(seed=3)
    p0 = plan(A, B, M, device=CPU)
    A2, B2, M2 = POOL[0]
    p1, survived = revalidate(p0, A2, B2, M2, device=CPU)
    assert not survived
    rp1, rsurvived = rp.revalidate(rp.plan(ref(A), ref(B), ref(M)),
                                   ref(A2), ref(B2), ref(M2))
    assert not rsurvived
    same_plan(p1, rp1)


# ---------------------------------------------------------------------------
# burst: lane patching + lineage
# ---------------------------------------------------------------------------


def tables(prog):
    """The port program's lane tables as host arrays (a cold program's
    ``BG`` is one until its first patch)."""
    return (prog._IA.numpy(), prog._BV.numpy(), np.asarray(prog._BG),
            prog.present.numpy(), prog.mask_cols.numpy())


def ref_tables(prog):
    return (prog._IA, prog._BV, prog._BG, prog._present_host,
            prog._mask_cols_host)


def assert_same_tables(got, *wants):
    for want in wants:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("which", ["M", "A"])
def test_patched_program_bitwise_equals_cold_rebuild(which):
    A, B, M = burst_triple(seed=4)
    p0 = plan(A, B, M, device=CPU)
    wm = p0.widths[2]
    parent = burst.get_program(A, B, M, PLUS_TIMES, wm=wm, device=CPU)
    assert parent is not None
    d = CSRDelta.upserts(np.array([3, 3, 9]), np.array([1, 2, 3]),
                         np.ones(3, dtype=np.float32))
    A1, M1 = ((A, apply_csr_delta(M, d).csr) if which == "M"
              else (apply_csr_delta(A, d).csr, M))
    before = tables(parent)
    got = parent.patched(A1, B, M1, np.array([3, 9], np.int64))
    assert got is not None
    prog, lanes = got
    assert lanes > 0
    cold = burst.BurstProgram(A1, B, M1, PLUS_TIMES, wm, device=CPU)
    rparent = ref_burst.get_program(ref(A), ref(B), ref(M), REF_PLUS_TIMES,
                                    wm=wm)
    rprog, rlanes = rparent.patched(ref(A1), ref(B), ref(M1),
                                    np.array([3, 9], np.int64))
    assert lanes == rlanes
    assert prog.n_products == cold.n_products == rprog.n_products
    assert_same_tables(tables(prog), tables(cold), ref_tables(rprog))
    assert_same_tables(tables(parent), before)     # the parent is untouched
    assert_same_result(prog.run([A1])[0], cold.run([A1])[0])
    # the first patch uploads the parent's BG once (a cold program keeps
    # it on the host); a patch past that uploads only the changed columns
    # (and A's position map)
    whole = sum(t.nbytes for t in (cold._IA, cold._BV, cold._BG))
    assert cold.patch_bytes is None
    assert cold.device_bytes() == sum(t.nbytes for t in (
        cold._IA, cold._BV, cold.present, cold.mask_cols))
    assert isinstance(cold._BG, np.ndarray)
    assert isinstance(parent._BG, torch.Tensor)
    bg = parent._BG.nbytes
    assert bg < prog.patch_bytes < bg + whole / 4
    again, _ = parent.patched(A1, B, M1, np.array([3, 9], np.int64))
    assert 0 < again.patch_bytes == prog.patch_bytes - bg
    assert_same_tables(tables(again), tables(cold))


def test_patch_regathers_b_values_only_delta():
    rng = np.random.default_rng(11)
    A, B, M = burst_triple(seed=5)
    p0 = plan(A, B, M, device=CPU)
    parent = burst.get_program(A, B, M, PLUS_TIMES, wm=p0.widths[2],
                               device=CPU)
    d = values_delta(rng, B)
    B1 = apply_csr_delta(B, d).csr
    prog, _ = parent.patched(A, B1, M, np.zeros(0, np.int64))
    cold = burst.BurstProgram(A, B1, M, PLUS_TIMES, p0.widths[2], device=CPU)
    rparent = ref_burst.get_program(ref(A), ref(B), ref(M), REF_PLUS_TIMES,
                                    wm=p0.widths[2])
    rprog, _ = rparent.patched(ref(A), ref(B1), ref(M), np.zeros(0, np.int64))
    assert_same_tables(tables(prog), tables(cold), ref_tables(rprog))
    assert prog.mask_cols is parent.mask_cols       # mask layout shared
    assert_same_result(prog.run([A])[0], cold.run([A])[0])


def test_patch_refuses_b_structural_delta():
    A, B, M = burst_triple(seed=6)
    p0 = plan(A, B, M, device=CPU)
    parent = burst.get_program(A, B, M, PLUS_TIMES, wm=p0.widths[2],
                               device=CPU)
    B1 = apply_csr_delta(B, CSRDelta.upserts([0], [5], [1.0])).csr
    assert parent.patched(A, B1, M, np.array([0], np.int64)) is None
    rparent = ref_burst.get_program(ref(A), ref(B), ref(M), REF_PLUS_TIMES,
                                    wm=p0.widths[2])
    assert rparent.patched(ref(A), ref(B1), ref(M),
                           np.array([0], np.int64)) is None


def test_lineage_rederives_evicted_patch():
    A, B, M = burst_triple(seed=7)
    p0 = plan(A, B, M, device=CPU)
    wm = p0.widths[2]
    parent = burst.get_program(A, B, M, PLUS_TIMES, wm=wm, device=CPU)
    dm = CSRDelta.upserts(np.array([2]), np.array([4]),
                          np.ones(1, dtype=M.data.dtype))
    M1 = apply_csr_delta(M, dm).csr
    changed = np.array([2], np.int64)
    prog, lanes = burst.patch_program(parent, A, B, M1, PLUS_TIMES, wm,
                                      changed, device=CPU)
    assert prog is not None and lanes > 0
    again, zero = burst.patch_program(parent, A, B, M1, PLUS_TIMES, wm,
                                      changed, device=CPU)
    assert again is prog and zero == 0             # memo hit
    burst.record_lineage(A, B, M1, PLUS_TIMES, wm, parent, changed,
                         device=CPU)
    burst._patches.clear()
    assert burst.peek_program(A, B, M1, PLUS_TIMES, wm, device=CPU) is None
    again = burst.get_program(A, B, M1, PLUS_TIMES, wm=wm, device=CPU)
    assert again is not None and again is not prog
    assert_same_tables(tables(again), tables(prog))
    assert burst.peek_program(A, B, M1, PLUS_TIMES, wm, device=CPU) is again


# ---------------------------------------------------------------------------
# cache: row bitmaps + scoped invalidation
# ---------------------------------------------------------------------------


def test_row_bitmap_coarse_coverage():
    assert row_bitmap([], 64) == 0
    assert row_bitmap([0], 64) == 1
    assert row_bitmap([63], 64) == 1 << 63
    assert row_bitmap(range(128), 128) == (1 << 64) - 1
    assert row_bitmap(range(0, 64), 128) & row_bitmap(range(64, 128), 128) == 0
    rng = np.random.default_rng(0)
    for n in (1, 7, 64, 100, 4096):
        rows = rng.integers(0, n, 5)
        assert row_bitmap(rows, n) == ref_row_bitmap(rows, n)


def _scoped_run(cache_cls, name):
    rc = cache_cls(capacity=16, name=name)
    try:
        rc.put("k1", "v1", tags=[("sigA", row_bitmap([0, 1], 64))])
        rc.put("k2", "v2", tags=[("sigA", row_bitmap([40, 41], 64))])
        rc.put("k3", "v3", tags=[("sigB", row_bitmap([0], 64))])
        out = [rc.invalidate("sigA", row_bitmap([1], 64)),
               rc.get("k1"), rc.get("k2"), rc.get("k3"),
               rc.invalidate("sigA"), rc.get("k2"), rc.get("k3"),
               rc.invalidate("missing")]
    finally:
        rc.unregister()
    return out


def test_result_cache_scoped_invalidation():
    got = _scoped_run(ResultCache, "test-torch-inc-scoped")
    assert got == [1, None, "v2", "v3", 1, None, "v3", 0]
    assert got == _scoped_run(RefResultCache, "test-torch-inc-scoped-ref")


def test_result_cache_tag_index_prunes_dead_entries():
    rc = ResultCache(capacity=2, name="test-torch-inc-prune")
    try:
        for i in range(32):
            rc.put(("k", i), i, tags=[(("sig", i), 1)])
        assert sum(len(ix) for ix in rc._tags.values()) <= 4 * rc.capacity
    finally:
        rc.unregister()


def test_invalidated_entry_releases_its_tensors():
    """The cache holds the only reference to an evicted result's tensors:
    once invalidated (and the caller drops it) they are freed, and the
    cache's device bytes drop by the result's own tensor."""
    A, B, M = burst_triple(seed=13)
    with engine() as eng:
        res = eng.submit(A, B, M).result()
        held = eng.results.device_bytes()
        assert held == sum(t.untyped_storage().nbytes()
                           for t in (res.vals, res.present, res.mask_cols))
        vals = weakref.ref(res.vals)
        del res
        gc.collect()
        assert vals() is not None                  # cached
        d = CSRDelta.upserts(np.array([int(np.nonzero(np.diff(
            M.indptr))[0][0])]), np.array([0]), np.ones(1, np.float32))
        out = eng.submit_delta(A, B, M, delta_a=d)
        assert out.entries_evicted == 1
        assert eng.results.device_bytes() == 0
        gc.collect()
        assert vals() is None


# ---------------------------------------------------------------------------
# batcher: rekey
# ---------------------------------------------------------------------------


def _rekey_run(batcher_cls, request_cls):
    def req(key, payload):
        return request_cls(A=payload, B=None, M=None, semiring=None,
                           complement=False, algorithm=None, mesh=None,
                           axis="data", ticket=None, post=None,
                           cache_key=("ck",), submitted_at=0.0, key=key)

    b = batcher_cls(max_batch=8)
    b.add(req(("old",), 1))
    b.add(req(("old",), 2))
    b.add(req(("other",), 3))

    def rw(r):
        r.cache_key = None

    moved = [b.rekey(("old",), ("new",), rw), b.rekey(("old",), ("new",)),
             b.rekey(("x",), ("x",))]
    buckets = {bk[0].key: [(r.A, r.cache_key) for r in bk]
               for bk in b.pop_all()}
    return moved, buckets, b.pending


def test_batcher_rekey_moves_and_rewrites():
    got = _rekey_run(Batcher, Request)
    assert got == ([2, 0, 0], {("new",): [(1, None), (2, None)],
                               ("other",): [(3, ("ck",))]}, 0)
    assert got == _rekey_run(RefBatcher, RefRequest)


# ---------------------------------------------------------------------------
# engine: submit_delta
# ---------------------------------------------------------------------------


DELTA_KEYS = ("delta_applied", "plans_revalidated", "lanes_patched",
              "rows_invalidated")


def same_outcome(out, rout) -> None:
    """A port DeltaOutcome equal to the reference's, field for field."""
    for name in ("A", "B", "M"):
        same_csr(getattr(out, name), getattr(rout, name))
    same_plan(out.plan, rout.plan)
    for f in ("plan_survived", "lanes_patched", "rows_invalidated",
              "entries_evicted", "rekeyed", "signatures"):
        assert getattr(out, f) == getattr(rout, f), f
    np.testing.assert_array_equal(out.changed_rows, rout.changed_rows)


def test_submit_delta_patches_burst_program_and_counts():
    A, B, M = burst_triple(seed=8)
    dm = CSRDelta.upserts(np.array([3, 3, 7]), np.array([1, 2, 3]),
                          np.ones(3, dtype=M.data.dtype))
    outs = []
    for eng_cls, conv, kw in ((QueryEngine, lambda x: x, {"device": CPU}),
                              (RefQueryEngine, ref, {})):
        with eng_cls(async_mode=False, **kw) as eng:
            eng.submit(conv(A), conv(B), conv(M)).result()
            assert eng.metrics.bucket_log()[-1]["route"] == "burst"
            d = dm if conv is not ref else ref_delta(dm)
            out = eng.submit_delta(conv(A), conv(B), conv(M), delta_m=d)
            got = eng.submit(out.A, out.B, out.M).result()
            assert eng.metrics.bucket_log()[-1]["route"] == "burst"
            snap = eng.metrics.snapshot()
        outs.append((out, got, {k: snap[k] for k in DELTA_KEYS}))
    (out, got, snap), (rout, rgot, rsnap) = outs
    assert out.plan_survived and out.lanes_patched > 0
    assert list(out.changed_rows) == [3, 7]
    assert snap == rsnap == {"delta_applied": 1, "plans_revalidated": 1,
                             "lanes_patched": out.lanes_patched,
                             "rows_invalidated": 2}
    same_outcome(out, rout)
    assert_same_result(got, rgot)
    caches.clear_all()
    clear_plan_cache()
    assert_same_result(got, masked_spgemm(out.A, out.B, out.M, device=CPU))


def test_submit_delta_requires_a_delta_and_host_csr():
    A, B, M = POOL[0]
    with engine() as eng:
        with pytest.raises(ValueError):
            eng.submit_delta(A, B, M)
        with pytest.raises(TypeError):
            eng.submit_delta(object(), B, M,
                             delta_m=CSRDelta.upserts([0], [0], [1.0]))
        assert eng.metrics.snapshot()["delta_applied"] == 0


def test_delta_flush_scoped_to_structure_fingerprint():
    """A delta to one structure must not drop cached results of OTHER
    structures sharing the engine."""
    A1, B1, M1 = burst_triple(seed=9)
    A2, B2, M2 = POOL[0]
    db = CSRDelta.upserts(np.array([5]), np.array([6]),
                          np.ones(1, dtype=B1.data.dtype))
    outs = []
    for eng_cls, conv, kw in ((QueryEngine, lambda x: x, {"device": CPU}),
                              (RefQueryEngine, ref, {})):
        with eng_cls(async_mode=False, **kw) as eng:
            t1 = eng.submit(conv(A1), conv(B1), conv(M1))
            t2 = eng.submit(conv(A2), conv(B2), conv(M2))
            eng.flush()
            t1.result(), t2.result()
            assert len(eng.results) == 2
            d = db if conv is not ref else ref_delta(db)
            out = eng.submit_delta(conv(A1), conv(B1), conv(M1), delta_b=d)
            hits0 = eng.metrics.snapshot()["result_cache_hits"]
            eng.submit(conv(A2), conv(B2), conv(M2))
            outs.append((out, eng.metrics.snapshot()["result_cache_hits"]
                         - hits0))
    (out, hits), (rout, rhits) = outs
    assert out.entries_evicted == 1 and hits == rhits == 1
    same_outcome(out, rout)
    # the engine files results under ``result_key``'s key
    with engine(async_mode=False) as eng:
        eng.submit(A2, B2, M2).result()
        key = result_key(A2, B2, M2, semiring_name="plus_times",
                         complement=False, algorithm=None, device=CPU,
                         cost_token=cost_model_token())
        assert eng.results.get(key) is not None


def test_delta_invalidation_row_scoped():
    """An A delta confined to rows the mask never covers leaves the entry
    cached; a covered-row delta evicts it."""
    A, B, _ = burst_triple(seed=10)
    m = A.shape[0]
    md = np.zeros((m, m), dtype=np.float32)
    md[: m // 2] = (np.random.default_rng(0).random((m // 2, m))
                    < 0.1).astype(np.float32)
    M = F.csr_from_dense(md)                 # rows >= m//2 mask-empty
    da = CSRDelta.upserts(np.array([m - 1]), np.array([0]),
                          np.ones(1, dtype=A.data.dtype))
    da2 = CSRDelta.upserts(np.array([0]), np.array([1]),
                           np.ones(1, dtype=A.data.dtype))
    outs = []
    for eng_cls, conv, kw in ((QueryEngine, lambda x: x, {"device": CPU}),
                              (RefQueryEngine, ref, {})):
        dconv = (lambda d: d) if conv is not ref else ref_delta
        with eng_cls(async_mode=False, **kw) as eng:
            eng.submit(conv(A), conv(B), conv(M)).result()
            out = eng.submit_delta(conv(A), conv(B), conv(M),
                                   delta_a=dconv(da))
            eng.submit(out.A, conv(B), conv(M)).result()
            out2 = eng.submit_delta(out.A, conv(B), conv(M),
                                    delta_a=dconv(da2))
        outs.append((out, out2))
    (out, out2), (rout, rout2) = outs
    assert out.entries_evicted == 0 and out2.entries_evicted == 1
    same_outcome(out, rout)
    same_outcome(out2, rout2)


def test_rebase_queued_requests_onto_post_delta_bucket():
    A, B, M = burst_triple(seed=11)
    col = next(c for c in range(M.shape[1])
               if c not in set(M.row(4)[0].tolist()))
    dm = CSRDelta.upserts(np.array([4]), np.array([col]),
                          np.ones(1, dtype=M.data.dtype))
    with engine(async_mode=False, max_batch=32) as eng:
        tickets = [eng.submit(revalue(A, s), B, M) for s in range(3)]
        assert eng._batcher.pending == 3
        out = eng.submit_delta(A, B, M, delta_m=dm, rebase_queued=True)
        assert out.rekeyed == 3
        tickets.append(eng.submit(revalue(A, 99), out.B, out.M))
        eng.flush()
        assert eng.metrics.bucket_log()[-1]["size"] == 4
        results = [t.result() for t in tickets]
    with RefQueryEngine(async_mode=False, max_batch=32) as reng:
        rtickets = [reng.submit(ref(revalue(A, s)), ref(B), ref(M))
                    for s in range(3)]
        rout = reng.submit_delta(ref(A), ref(B), ref(M),
                                 delta_m=ref_delta(dm), rebase_queued=True)
        rtickets.append(reng.submit(ref(revalue(A, 99)), rout.B, rout.M))
        reng.flush()
        rresults = [t.result() for t in rtickets]
    same_outcome(out, rout)
    caches.clear_all()
    clear_plan_cache()
    for s, got, rgot in zip([0, 1, 2, 99], results, rresults):
        assert_same_result(got, rgot)
        want = masked_spgemm(revalue(A, s), out.B, out.M, device=CPU)
        assert_same_result(got, want)


def test_submit_delta_chain_signature_memo():
    """Chained deltas reuse the memoized incremental signature and stay
    bitwise correct."""
    rng = np.random.default_rng(12)
    A, B, M = burst_triple(seed=12)
    with engine(async_mode=False) as eng:
        eng.submit(A, B, M).result()
        for step in range(3):
            dm = random_delta(rng, M, k=3)
            before = incremental_signature(M)
            out = eng.submit_delta(A, B, M, delta_m=dm)
            r = rf.apply_csr_delta(ref(M), ref_delta(dm),
                                   old_signature=before)
            M = out.M
            assert out.signatures["M"] == incremental_signature(M)
            assert out.signatures["M"] == r.signature
        got = eng.submit(A, B, M).result()
    caches.clear_all()
    clear_plan_cache()
    assert_same_result(got, masked_spgemm(A, B, M, device=CPU))


# ---------------------------------------------------------------------------
# the reference's property test, as eight fixed draws
# ---------------------------------------------------------------------------


#: (seed, async_mode, n_steps): the reference property's two known
#: falsifying draws first, then six more fixed draws
DRAWS = [(155728, False, 7), (910245, False, 11), (0, False, 4),
         (3, True, 6), (7, True, 12), (42, False, 9), (2024, True, 8),
         (31337, True, 10)]


def _drain(eng, tickets):
    while not all(t.done() for t in tickets):
        d = eng.next_flush_deadline()
        if d is None:
            break
        eng.clock.advance_to(max(d + 1e-9, eng.clock.now()))
        eng.quiesce()


def interleave(seed, async_mode, n_steps, reference):
    """The reference property's interleaving of deltas, plain and
    complemented queries and a tile-elected bucket, through one engine
    (the reference's with ``reference=True``).  Returns
    ``[(result, A, B, M, complement, tile)]`` with the port operands each
    query was issued with."""
    rng = np.random.default_rng(seed)
    A, B, M = POOL[int(rng.integers(3))]
    A = revalue(A, int(rng.integers(1 << 20)))
    conv = ref if reference else (lambda x: x)
    dconv = ref_delta if reference else (lambda d: d)
    kw = dict(async_mode=async_mode, max_batch=4)
    if async_mode:
        kw["clock"] = RefVirtualClock() if reference else VirtualClock()
    if not reference:
        kw["device"] = CPU
    checks = []
    with (RefQueryEngine if reference else QueryEngine)(**kw) as eng:
        for step in range(n_steps):
            action = int(rng.integers(4))
            if action == 0:
                which = int(rng.integers(3))
                target = (A, B, M)[which]
                d = (values_delta(rng, target) if rng.random() < 0.3
                     else random_delta(rng, target, k=4))
                out = eng.submit_delta(
                    conv(A), conv(B), conv(M),
                    delta_a=dconv(d) if which == 0 else None,
                    delta_b=dconv(d) if which == 1 else None,
                    delta_m=dconv(d) if which == 2 else None)
                A, B, M = (CSR(x.indptr, x.indices, x.data, x.shape)
                           for x in (out.A, out.B, out.M))
            elif action in (1, 2):
                comp = action == 2
                t = eng.submit(conv(A), conv(B), conv(M), complement=comp)
                checks.append((t, A, B, M, comp, False))
            else:
                At, Bt, Mt = POOL[3]
                Aq = revalue(At, 500 + step)
                checks.append((eng.submit(conv(Aq), conv(Bt), conv(Mt)),
                               Aq, Bt, Mt, False, True))
            if async_mode:
                # the worker consumes every due bucket before the next
                # action: bucket composition never depends on its timing
                eng.quiesce()
        if async_mode:
            _drain(eng, [c[0] for c in checks])
        else:
            eng.flush()
        return [(c[0].result(timeout=60),) + c[1:] for c in checks]


def at_mask(res, complement, shape):
    """A result as a dense (m, n) value matrix and its present pattern:
    mask-aligned results scattered through their mask columns, so results
    of different pad widths compare by the entries they hold."""
    if complement:
        return arr(res[0]), arr(res[1])
    m, n = shape
    vals, pres, cols = arr(res.vals), arr(res.present), arr(res.mask_cols)
    out = np.zeros((m, n + 1), vals.dtype)
    hit = np.zeros((m, n + 1), bool)
    rows = np.repeat(np.arange(m), cols.shape[1]).reshape(cols.shape)
    out[rows[pres], cols[pres]] = vals[pres]
    hit[rows[pres], cols[pres]] = True
    return out[:, :n], hit[:, :n]


def width(res, complement):
    return None if complement else tuple(res.vals.shape)


@pytest.mark.parametrize("seed, async_mode, n_steps", DRAWS)
def test_delta_query_interleaving_bitwise_equals_cold(seed, async_mode,
                                                      n_steps):
    first = interleave(seed, async_mode, n_steps, reference=False)
    second = interleave(seed, async_mode, n_steps, reference=False)
    want_ref = interleave(seed, async_mode, n_steps, reference=True)
    assert len(first) == len(second) == len(want_ref)
    for (got, *_, comp, tile), (again, *_), (rgot, *_) in zip(
            first, second, want_ref):
        assert width(got, comp) == width(again, comp) == width(rgot, comp)
        assert_same_result(got, again, complement=comp)  # runs agree
        if tile:
            np.testing.assert_allclose(arr(got.vals), np.asarray(rgot.vals),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(arr(got.present),
                                          np.asarray(rgot.present))
        else:
            assert_same_result(got, rgot, complement=comp)
    caches.clear_all()
    clear_plan_cache()
    for got, Aq, Bq, Mq, comp, _ in first:
        want = masked_spgemm(Aq, Bq, Mq, complement=comp, device=CPU)
        for g, w in zip(at_mask(got, comp, Mq.shape),
                        at_mask(want, comp, Mq.shape)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed, n_steps", [(155728, 7), (910245, 11)])
def test_post_delta_result_pads_wider_as_in_reference(seed, n_steps):
    """The reference engine's known divergence, kept by the port: after a
    delta, a pre-delta and a post-delta bucket of one shape flush together
    and merge, so a result comes back padded one column wider than a cold
    recompute (extra columns hold 0, False and the sentinel n).  Pinned in
    both packages; neither is "fixed"."""
    got = interleave(seed, False, n_steps, reference=False)
    want_ref = interleave(seed, False, n_steps, reference=True)
    caches.clear_all()
    clear_plan_cache()
    wider = []
    for (res, Aq, Bq, Mq, comp, _), (rres, *_) in zip(got, want_ref):
        if comp:
            continue
        cold = masked_spgemm(Aq, Bq, Mq, device=CPU)
        w, wc = res.vals.shape[1], cold.vals.shape[1]
        assert np.asarray(rres.vals).shape[1] == w
        if w > wc:
            n = Mq.shape[1]
            assert not arr(res.present)[:, wc:].any()
            assert (arr(res.vals)[:, wc:] == 0).all()
            assert (arr(res.mask_cols)[:, wc:] == n).all()
            wider.append(w - wc)
    assert wider and set(wider) == {1}


# ---------------------------------------------------------------------------
# trace: rotating sink round-trips
# ---------------------------------------------------------------------------


def _synth(**kw):
    from repro_torch.serving.trace import synthesize_trace
    return synthesize_trace(n=48, queries=24, n_structs=2,
                            block_struct=False, **kw)


def test_rotating_sink_segments_standalone_and_round_trip(tmp_path):
    from repro.serving.trace import Trace as RefTrace
    from repro.serving.trace import load_rotated as ref_load_rotated
    from repro_torch.serving.trace import (RotatingTraceSink, Trace,
                                           load_rotated)
    tr = _synth()
    path = os.path.join(str(tmp_path), "cap.jsonl")
    with RotatingTraceSink(path, max_bytes=4096, rotate=8,
                           name="cap") as sink:
        for ev in tr.events:
            sink.write(ev)
    segs = sink.segments()
    assert len(segs) > 1
    total = 0
    for p in segs:
        seg = Trace.load(p)
        assert all(ev["op"] == "submit" for ev in seg.events)
        assert RefTrace.load(p).events == seg.events   # reference reads it
        total += seg.n_requests
    assert total == 24
    merged = load_rotated(path)
    assert merged.events == tr.events
    assert ref_load_rotated(path).events == tr.events
    assert merged.materialized(check=True)


def test_rotating_sink_drops_oldest_past_rotate(tmp_path):
    from repro_torch.serving.trace import RotatingTraceSink
    tr = _synth()
    path = os.path.join(str(tmp_path), "cap.jsonl")
    with RotatingTraceSink(path, max_bytes=4096, rotate=1) as sink:
        for ev in tr.events:
            sink.write(ev)
    assert len(sink.segments()) <= 2


def test_rotating_sink_sampling_deterministic(tmp_path):
    from repro.serving.trace import RotatingTraceSink as RefSink
    from repro_torch.serving.trace import RotatingTraceSink
    tr = _synth()
    kept = []
    for run, cls in enumerate((RotatingTraceSink, RotatingTraceSink,
                               RefSink)):
        path = os.path.join(str(tmp_path), f"s{run}.jsonl")
        with cls(path, sample_rate=0.5, seed=7) as sink:
            kept.append([sink.write(ev) for ev in tr.events])
        assert sink.written + sink.sampled_out == 24
    assert kept[0] == kept[1] == kept[2]
    assert 0 < sum(kept[0]) < 24


def test_recorder_streams_to_sink(tmp_path):
    from repro_torch.serving.trace import (RotatingTraceSink, Trace,
                                           TraceRecorder)
    A, B, M = POOL[0]
    path = os.path.join(str(tmp_path), "live.jsonl")
    sink = RotatingTraceSink(path, name="live")
    rec = TraceRecorder(name="live", sink=sink, keep_events=False)
    with engine(recorder=rec) as eng:
        for s in range(3):
            eng.submit(revalue(A, s), B, M)
        eng.flush()
    sink.close()
    assert rec.events == []
    got = Trace.load(path)
    assert got.n_requests == 3
    assert got.materialized(check=True)


def test_rotating_sink_validates_knobs(tmp_path):
    from repro_torch.serving.trace import RotatingTraceSink
    path = os.path.join(str(tmp_path), "x.jsonl")
    for kw in ({"max_bytes": 0}, {"rotate": 0}, {"sample_rate": 1.5}):
        with pytest.raises(ValueError):
            RotatingTraceSink(path, **kw)
