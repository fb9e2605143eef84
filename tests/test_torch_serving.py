"""Port parity for the serving path: ``QueryEngine`` (burst, batched, tile
and single routes), the burst programs, the batcher, the result cache,
``masked_spgemm_batched`` and ``plan_batch``, against the reference
package on the same seeded inputs, plus the engine's own contracts as the
reference's ``tests/test_serving.py`` states them.

Tolerances: ``array_equal`` for the batched driver, the burst route and
the row routes against the reference, in the mask case and under
complement, on small-integer data (where heap's and inner's other
summation orders are exact too); bitwise the port's own one-shot call for
every served request (the core serving contract); the reference's 1e-4
for tile buckets on float data.  Every problem keeps m below
``TRIAL_MIN_ROWS`` where an election must not depend on timing, and the
async tests run on a ``VirtualClock``.  No hypothesis draws: every stream
comes from a fixed seed.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import formats as rf
from repro.core.masked_spgemm import \
    masked_spgemm_batched as ref_masked_spgemm_batched
from repro.core.planner import plan_batch as ref_plan_batch
from repro.core.semiring import REGISTRY as REF_SR
from repro.serving import QueryEngine as RefQueryEngine
from repro.serving.burst import get_program as ref_get_program
from repro_torch import caches, obs
from repro_torch.convert import plan_from_reference
from repro_torch.core import formats as F
from repro_torch.core.formats import CSR
from repro_torch.core.masked_spgemm import (masked_spgemm,
                                            masked_spgemm_batched)
from repro_torch.core.planner import clear_plan_cache, plan, plan_batch
from repro_torch.core.semiring import MIN_PLUS, PLUS_TIMES
from repro_torch.core.semiring import REGISTRY as SR
from repro_torch.serving import (Batcher, QueryEngine, ResultCache,
                                 VirtualClock, content_fingerprint,
                                 get_program)
from repro_torch.serving.batcher import Request

CPU = "cpu"


def revalue(x: CSR, seed: int, ints: bool = False) -> CSR:
    rng = np.random.default_rng(seed)
    data = (rng.integers(1, 5, x.nnz) if ints
            else rng.uniform(0.5, 1.5, x.nnz)).astype(np.float32)
    return CSR(x.indptr, x.indices, data, x.shape)


def ref(x: CSR) -> rf.CSR:
    return rf.CSR(x.indptr, x.indices, x.data, x.shape)


def structure_pool():
    """The reference test's pool: ER row-kernel regimes + a block-dense
    triple the tile route wins."""
    pool = []
    for s in range(3):
        pool.append((F.erdos_renyi(48, 3 + s, seed=40 + s),
                     F.erdos_renyi(48, 3, seed=50 + s),
                     F.er_mask(48, 5, seed=60 + s)))
    blocky = (F.csr_from_dense(F.block_sparse(48, 8, 0.5, 0.6, seed=70)),
              F.csr_from_dense(F.block_sparse(48, 8, 0.5, 0.6, seed=71)),
              F.csr_from_dense(F.block_sparse(48, 8, 0.6, 0.5, seed=72,
                                              mask=True)))
    pool.append(blocky)
    return pool


POOL = structure_pool()


def engine(**kw):
    return QueryEngine(device=CPU, **kw)


def one_shot(A, B, M, **kw):
    return masked_spgemm(A, B, M, device=CPU, **kw)


def drain_virtual(eng, tickets, timeout=60.0):
    """Advance the engine's virtual clock past each flush deadline until
    every ticket resolves."""
    end = time.monotonic() + timeout
    while not all(t.done() for t in tickets):
        assert time.monotonic() < end, "virtual drain timed out"
        d = eng.next_flush_deadline()
        if d is not None:
            eng.clock.advance_to(max(d + 1e-9, eng.clock.now()))
        time.sleep(0.002)


def arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_result(got, want, complement=False):
    if complement:
        np.testing.assert_array_equal(arr(got[0]), arr(want[0]))
        np.testing.assert_array_equal(arr(got[1]), arr(want[1]))
        return
    np.testing.assert_array_equal(arr(got.vals), arr(want.vals))
    np.testing.assert_array_equal(arr(got.present), arr(want.present))
    np.testing.assert_array_equal(arr(got.mask_cols), arr(want.mask_cols))


def stream(seed, ints=False):
    """A seeded mixed stream over POOL: plain, complemented, forced-tile
    and tile-elected queries."""
    rng = np.random.default_rng(seed)
    out = []
    for q in range(int(rng.integers(3, 15))):
        A, B, M = POOL[int(rng.integers(len(POOL)))]
        kind = int(rng.integers(4))
        complement = kind == 1
        algorithm = "tile" if kind == 2 else None
        if algorithm == "tile" or kind == 3:
            A, B, M = POOL[3]
            complement = False
        out.append((revalue(A, 1000 + q, ints), B, M, complement, algorithm))
    return out, int(rng.integers(1, 10)), bool(rng.integers(2))


# ---------------------------------------------------------------------------
# any batching == sequential one-shot, bitwise; and == the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_any_batching_bitwise_equals_one_shot(seed):
    queries, max_batch, merge = stream(seed)
    with engine(max_batch=max_batch, merge_same_shape=merge,
                cache_results=False) as eng:
        tickets = [eng.submit(A, B, M, complement=c, algorithm=alg)
                   for A, B, M, c, alg in queries]
        eng.flush()
        for (A, B, M, c, alg), t in zip(queries, tickets):
            want = one_shot(A, B, M, complement=c, algorithm=alg or "auto")
            assert_same_result(t.result(), want, complement=c)


@pytest.mark.parametrize("seed", [0, 3])
def test_engine_stream_matches_reference_engine(seed):
    """The same stream through both engines, on small-integer data: every
    ticket array_equal, and the same bucket schedule."""
    queries, max_batch, merge = stream(seed, ints=True)
    kw = dict(max_batch=max_batch, merge_same_shape=merge,
              cache_results=False)
    with engine(**kw) as eng, RefQueryEngine(**kw) as ref_eng:
        got = [eng.submit(A, B, M, complement=c, algorithm=alg)
               for A, B, M, c, alg in queries]
        want = [ref_eng.submit(ref(A), ref(B), ref(M), complement=c,
                               algorithm=alg)
                for A, B, M, c, alg in queries]
        eng.flush()
        ref_eng.flush()
        for (_, _, _, c, _), g, w in zip(queries, got, want):
            assert_same_result(g.result(), w.result(), complement=c)
        assert (eng.metrics.bucket_schedule()
                == ref_eng.metrics.bucket_schedule())
        assert (eng.metrics.deterministic_snapshot()
                == ref_eng.metrics.deterministic_snapshot())


def test_tile_elected_plan_served_bitwise():
    A, B, M = POOL[3]
    assert plan(A, B, M, device=CPU).algorithm == "tile"
    with engine(cache_results=False) as eng:
        tickets = [eng.submit(revalue(A, s), B, M) for s in range(3)]
        eng.flush()
        for s, t in zip(range(3), tickets):
            assert_same_result(t.result(), one_shot(revalue(A, s), B, M))
        assert eng.metrics.bucket_log()[-1]["route"] == "tile"
    assert_same_result(one_shot(A, B, M),
                       one_shot(A, B, M, algorithm="tile"))


def test_tile_bucket_matches_reference_within_its_tolerance():
    A, B, M = POOL[3]
    As = [revalue(A, s) for s in range(3)]
    with engine(cache_results=False) as eng:
        got = eng.serve([(a, B, M) for a in As])
    with RefQueryEngine(cache_results=False) as ref_eng:
        want = ref_eng.serve([(ref(a), ref(B), ref(M)) for a in As])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(arr(g.present), arr(w.present))
        np.testing.assert_array_equal(arr(g.mask_cols), arr(w.mask_cols))
        np.testing.assert_allclose(arr(g.vals), arr(w.vals), rtol=1e-4,
                                   atol=1e-4)


def test_cache_hit_replay_is_bitwise_identical():
    A, B, M = POOL[0]
    queries = [(revalue(A, s % 3), B, M) for s in range(9)]
    with engine(max_batch=4) as eng:
        first = [eng.submit(*q) for q in queries]
        eng.flush()
        first = [t.result() for t in first]
        hits0 = eng.metrics.snapshot()["result_cache_hits"]
        second = [eng.submit(*q) for q in queries]
        assert all(t.done() for t in second)   # served from cache, no flush
        second = [t.result() for t in second]
        hits1 = eng.metrics.snapshot()["result_cache_hits"]
    assert hits1 - hits0 == len(queries)
    for f, s in zip(first, second):
        assert s is f or np.array_equal(arr(s.vals), arr(f.vals))
        assert_same_result(s, f)
    for q, s in zip(queries, second):
        assert_same_result(s, one_shot(*q))


def test_semiring_and_forced_algorithm_streams():
    A, B, M = POOL[1]
    with engine(cache_results=False) as eng:
        t1 = eng.submit(A, B, M, semiring=MIN_PLUS, algorithm="msa")
        t2 = eng.submit(A, B, M, semiring=PLUS_TIMES, algorithm="heap")
        eng.flush()
        assert_same_result(t1.result(), one_shot(
            A, B, M, semiring=MIN_PLUS, algorithm="msa"))
        assert_same_result(t2.result(), one_shot(
            A, B, M, semiring=PLUS_TIMES, algorithm="heap"))


def test_triangle_composite_matches_direct():
    from repro.graphs import triangle_count as ref_triangle_count
    from repro_torch.graphs import triangle_count
    g = F.erdos_renyi(128, 8, seed=9)
    want, _ = triangle_count(g, device=CPU)
    with engine() as eng:
        t = eng.submit_triangle(g)
        eng.flush()
        assert t.result() == want
    assert want == ref_triangle_count(ref(g))[0]


def test_bc_serving_client_matches_direct():
    from repro_torch.graphs.betweenness import betweenness_centrality
    g = F.erdos_renyi(72, 4, seed=11)
    want, _, calls_direct = betweenness_centrality(
        g, sources=range(12), source_chunks=3, device=CPU)
    with engine(max_batch=16) as eng:
        got, _, calls_served = betweenness_centrality(
            g, sources=range(12), source_chunks=3, engine=eng)
        snap = eng.metrics.snapshot()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert calls_served == calls_direct
    assert snap["batched_requests"] > 0


# ---------------------------------------------------------------------------
# batching/flush policies, async mode, backpressure
# ---------------------------------------------------------------------------


def test_forced_algorithm_chunks_fuse_into_one_program():
    from repro_torch.graphs.betweenness import betweenness_centrality
    g = F.erdos_renyi(64, 4, seed=13)
    want, _, calls = betweenness_centrality(g, sources=range(9),
                                            algorithm="msa",
                                            source_chunks=3, device=CPU)
    with engine(max_batch=16) as eng:
        got, _, calls2 = betweenness_centrality(g, sources=range(9),
                                                algorithm="msa",
                                                source_chunks=3,
                                                engine=eng)
        snap = eng.metrics.snapshot()
    np.testing.assert_array_equal(got, want)
    assert calls2 == calls
    assert snap["mean_batch"] > 1        # chunks fused, not one-by-one


def test_full_bucket_flushes_immediately():
    A, B, M = POOL[0]
    with engine(max_batch=3, cache_results=False) as eng:
        ts = [eng.submit(revalue(A, s), B, M) for s in range(3)]
        assert all(t.done() for t in ts)   # hit max_batch -> executed
        assert eng.metrics.snapshot()["buckets_executed"] == 1


def test_sync_result_triggers_flush():
    A, B, M = POOL[0]
    with engine(cache_results=False) as eng:
        t = eng.submit(A, B, M)
        assert not t.done()
        assert_same_result(t.result(), one_shot(A, B, M))


def test_async_max_wait_flushes_partial_bucket():
    A, B, M = POOL[0]
    with engine(async_mode=True, max_wait_ms=10.0, clock=VirtualClock(),
                cache_results=False) as eng:
        t = eng.submit(A, B, M)
        assert not t.done()         # partial bucket, virtual time frozen
        drain_virtual(eng, [t])
        assert_same_result(t.result(timeout=30.0), one_shot(A, B, M))


def test_backpressure_bounded_queue():
    A, B, M = POOL[0]
    with engine(max_batch=2, queue_cap=2, cache_results=False) as eng:
        ts = [eng.submit(revalue(A, s), B, M) for s in range(7)]
        eng.flush()
        for s, t in zip(range(7), ts):
            assert_same_result(t.result(), one_shot(revalue(A, s), B, M))
    with engine(async_mode=True, max_batch=2, queue_cap=2, max_wait_ms=1.0,
                clock=VirtualClock(), cache_results=False) as eng:
        ts = [eng.submit(revalue(A, s), B, M) for s in range(7)]
        drain_virtual(eng, ts)
        for s, t in zip(range(7), ts):
            assert_same_result(t.result(timeout=30.0),
                               one_shot(revalue(A, s), B, M))


def test_error_propagates_to_ticket():
    A, B, M = POOL[0]
    with engine(cache_results=False) as eng:
        t = eng.submit(A, B, M, complement=True, algorithm="mca")
        eng.flush()
        with pytest.raises(NotImplementedError):
            t.result()
        assert eng.metrics.snapshot()["failed"] == 1


def test_raising_post_fails_only_its_ticket():
    A, B, M = POOL[0]
    with engine(cache_results=False) as eng:
        boom = eng.submit(A, B, M, post=lambda res: 1 / 0)
        ok = eng.submit(revalue(A, 5), B, M)
        eng.flush()
        with pytest.raises(ZeroDivisionError):
            boom.result()
        assert_same_result(ok.result(), one_shot(revalue(A, 5), B, M))
    with engine(async_mode=True, max_batch=8, max_wait_ms=1.0,
                clock=VirtualClock(), cache_results=False) as eng:
        boom = eng.submit(A, B, M, post=lambda res: 1 / 0)
        drain_virtual(eng, [boom])
        with pytest.raises(ZeroDivisionError):
            boom.result(timeout=30.0)
        ok = eng.submit(revalue(A, 6), B, M)
        drain_virtual(eng, [ok])
        assert_same_result(ok.result(timeout=30.0),
                           one_shot(revalue(A, 6), B, M))


def test_batched_tile_plan_rejects_unsupported_semiring():
    A, B, M = POOL[3]
    p = plan(A, B, M, device=CPU)
    if p.algorithm != "tile":
        p = dataclasses.replace(p, algorithm="tile",
                                tile_block=p.tile_block or 8)
    with pytest.raises(NotImplementedError):
        masked_spgemm_batched([A], B, [M], semiring=MIN_PLUS, plan=p,
                              device=CPU)


def test_forced_tile_complement_raises_like_one_shot():
    A, B, M = POOL[3]
    with pytest.raises(NotImplementedError):
        one_shot(A, B, M, algorithm="tile", complement=True)
    with engine(cache_results=False) as eng:
        t = eng.submit(A, B, M, complement=True, algorithm="tile")
        eng.flush()
        with pytest.raises(NotImplementedError):
            t.result()


def test_engine_rejects_invalid_knobs():
    with pytest.raises(ValueError, match="max_batch"):
        engine(max_batch=0)
    with pytest.raises(ValueError, match="max_batch"):
        engine(max_batch=-3)
    with pytest.raises(ValueError, match="max_wait_ms"):
        engine(max_wait_ms=-0.5)
    with pytest.raises(ValueError, match="pad_factor"):
        engine(pad_factor=0.99)
    with pytest.raises(ValueError, match="queue_cap"):
        engine(max_batch=8, queue_cap=4)
    for eng in (engine(max_batch=1, queue_cap=1), engine(max_wait_ms=0.0),
                engine(pad_factor=1.0)):
        eng.close()


def test_unported_features_raise_not_implemented():
    """Every serving feature is ported: ``mesh=`` serves distributed
    requests (``tests/test_torch_distributed.py``), and a recording engine
    refuses them as the reference's does (trace schema v1 is single
    process) before anything is queued.  The health layer is ported too:
    ``monitor=``, ``expose_port=`` and ``health()`` do not raise."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.serving import TraceError, TraceRecorder
    A, B, M = POOL[0]
    rec = TraceRecorder()
    with engine(recorder=rec, expose_port=0,
                monitor=obs.HealthMonitor()) as eng:
        with pytest.raises(TraceError, match="mesh"):
            eng.submit(A, B, M, mesh=make_mesh(2, device=CPU))
        assert eng.health().status == "ok"
        assert eng.obs_server is not None
        # counted before the recorder refuses it, as in the reference
        assert eng.metrics.snapshot()["submitted"] == 1
        assert eng.metrics.snapshot()["completed"] == 0
    assert rec.events == [] and eng.obs_server is None


def test_engine_defaults_to_cuda():
    eng = QueryEngine()
    try:
        assert eng.device.type == "cuda"
    finally:
        eng.close()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    A, B, M = POOL[0]
    with QueryEngine() as eng:
        t = eng.submit(A, B, M)
        eng.flush()
        with pytest.raises((RuntimeError, AssertionError)):
            t.result()


def test_engine_close_unregisters_owned_result_cache():
    eng1 = engine()
    eng2 = engine()
    names = set(caches.cache_info())
    assert eng1.results.name != eng2.results.name
    assert {eng1.results.name, eng2.results.name} <= names
    eng1.close()
    eng2.close()
    left = set(caches.cache_info())
    assert eng1.results.name not in left
    assert eng2.results.name not in left


def test_merged_same_shape_buckets_match_one_shot_dense():
    _, B, _ = POOL[0]
    A1, _, M1 = POOL[0]
    A2 = F.erdos_renyi(48, 5, seed=81)
    M2 = F.er_mask(48, 9, seed=82)
    with engine(max_batch=16, merge_same_shape=True, use_burst=False,
                cache_results=False) as eng:
        t1 = eng.submit(A1, B, M1)
        t2 = eng.submit(A2, B, M2)
        eng.flush()
        merged = eng.metrics.snapshot()["merged_groups"]
        for t, (A, M) in zip((t1, t2), ((A1, M1), (A2, M2))):
            got = t.result()
            want = one_shot(A, B, M)
            if merged and got.vals.shape != want.vals.shape:
                np.testing.assert_array_equal(got.to_dense().numpy(),
                                              want.to_dense().numpy())
            else:
                assert_same_result(got, want)


# ---------------------------------------------------------------------------
# burst programs
# ---------------------------------------------------------------------------


def test_burst_program_bitwise_vs_scatter_kernels_and_reference():
    A, B, M = POOL[1]
    p = plan(A, B, M, device=CPU)
    prog = get_program(A, B, M, PLUS_TIMES, wm=p.widths[2], device=CPU)
    assert prog is not None
    ref_prog = ref_get_program(ref(A), ref(B), ref(M), REF_SR["plus_times"],
                               wm=p.widths[2])
    assert prog.max_chain == ref_prog.max_chain
    assert prog.n_products == ref_prog.n_products
    As = [revalue(A, s) for s in range(4)]
    got = prog.run(As)
    want = ref_prog.run([ref(a) for a in As])
    for a, g, w in zip(As, got, want):
        assert_same_result(g, w)
        for alg in ("msa", "hash", "mca"):
            assert_same_result(g, one_shot(a, B, M, algorithm=alg))


@pytest.mark.parametrize("sr", ["min_plus", "or_and"])
def test_burst_program_other_semirings_match_reference(sr):
    A, B, M = POOL[2]
    wm = plan(A, B, M, device=CPU).widths[2]
    prog = get_program(A, B, M, SR[sr], wm=wm, device=CPU)
    ref_prog = ref_get_program(ref(A), ref(B), ref(M), REF_SR[sr], wm=wm)
    As = [revalue(A, s, ints=True) for s in range(3)]
    for g, w, a in zip(prog.run(As), ref_prog.run([ref(a) for a in As]),
                       As):
        assert_same_result(g, w)
        assert_same_result(g, one_shot(a, B, M, semiring=SR[sr],
                                       algorithm="msa"))


def test_burst_route_serves_the_bucket():
    A, B, M = POOL[1]
    with engine(cache_results=False) as eng:
        ts = [eng.submit(revalue(A, s), B, M) for s in range(5)]
        eng.flush()
        assert eng.metrics.bucket_log()[-1]["route"] == "burst"
        for s, t in enumerate(ts):
            assert_same_result(t.result(), one_shot(revalue(A, s), B, M))


def test_burst_program_over_cap_falls_back(monkeypatch):
    from repro_torch.serving import burst
    A, B, M = POOL[0]
    caches.clear_all()
    monkeypatch.setattr(burst, "MAX_TOTAL_PRODUCTS", 0)
    wm = plan(A, B, M, device=CPU).widths[2]
    assert get_program(A, B, M, PLUS_TIMES, wm=wm, device=CPU) is None
    with engine(cache_results=False, max_batch=2) as eng:
        ts = [eng.submit(revalue(A, s), B, M) for s in range(2)]
        route = eng.metrics.bucket_log()[-1]["route"]
    caches.clear_all()
    assert route in ("batched", "single")
    for s, t in enumerate(ts):
        assert_same_result(t.result(), one_shot(revalue(A, s), B, M))


# ---------------------------------------------------------------------------
# the batched driver and plan_batch
# ---------------------------------------------------------------------------


BATCH_ALGOS = ["auto", "msa", "hash", "mca", "heap", "heapdot", "inner"]


@pytest.mark.parametrize("algorithm", BATCH_ALGOS)
def test_batched_driver_matches_reference(algorithm):
    """Different A and M structures per element, shared B, integer data:
    array_equal to the reference's vmapped driver and to the port's own
    one-shot call at the batch widths."""
    B = revalue(F.erdos_renyi(40, 3, seed=91), 2, ints=True)
    As = [revalue(F.erdos_renyi(40, 2 + i, seed=92 + i), i, ints=True)
          for i in range(3)]
    Ms = [F.er_mask(40, 4 + 2 * i, seed=95 + i) for i in range(3)]
    got = masked_spgemm_batched(As, B, Ms, algorithm=algorithm, device=CPU)
    want = ref_masked_spgemm_batched([ref(a) for a in As], ref(B),
                                     [ref(m) for m in Ms],
                                     algorithm=algorithm)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_same_result(g, w)
    if algorithm != "auto":
        wa = max(int(np.diff(a.indptr).max()) for a in As)
        wm = max(int(np.diff(m.indptr).max()) for m in Ms)
        for a, m, g in zip(As, Ms, got):
            assert_same_result(g, one_shot(a, B, m, algorithm=algorithm,
                                           widths=(wa, None, wm)))


@pytest.mark.parametrize("algorithm", ["auto", "msa", "heap"])
def test_batched_driver_complement_matches_reference(algorithm):
    B = revalue(F.erdos_renyi(36, 3, seed=81), 3, ints=True)
    As = [revalue(F.erdos_renyi(36, 2, seed=82 + i), i, ints=True)
          for i in range(4)]
    Ms = [F.er_mask(36, 6, seed=86 + i) for i in range(4)]
    vals, present = masked_spgemm_batched(As, B, Ms, algorithm=algorithm,
                                          complement=True, device=CPU)
    wv, wp = ref_masked_spgemm_batched([ref(a) for a in As], ref(B),
                                       [ref(m) for m in Ms],
                                       algorithm=algorithm, complement=True)
    assert vals.shape == (4, 36, 36)
    np.testing.assert_array_equal(present.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))


def test_batched_driver_equals_one_shot_on_float_data():
    """One structure, float values: every element bitwise the one-shot
    call under the same plan (the engine's batched route)."""
    A, B, M = POOL[2]
    p = plan(A, B, M, device=CPU)
    As = [revalue(A, s) for s in range(4)]
    for algorithm in ("msa", "hash", "mca", "heap", "inner"):
        pa = dataclasses.replace(p, algorithm=algorithm,
                                 widths=(p.stats.wa, p.stats.wbt
                                         if algorithm == "inner"
                                         else p.stats.wb, p.stats.pm))
        got = masked_spgemm_batched(As, B, [M] * 4, plan=pa, device=CPU)
        for a, g in zip(As, got):
            assert_same_result(g, one_shot(a, B, M, plan=pa))


def test_batched_driver_stacks_padded_operands():
    A, B, M = POOL[0]
    wa = int(np.diff(A.indptr).max())
    wm = int(np.diff(M.indptr).max())
    As = [F.padded_from_csr(revalue(A, s), wa, device=CPU) for s in range(2)]
    Ms = [F.padded_from_csr(M, wm, device=CPU)] * 2
    got = masked_spgemm_batched(As, B, Ms, algorithm="msa", device=CPU)
    for s, g in enumerate(got):
        assert_same_result(g, one_shot(revalue(A, s), B, M, algorithm="msa"))
    with pytest.raises(ValueError, match="width"):
        masked_spgemm_batched(
            [As[0], F.padded_from_csr(A, wa + 1, device=CPU)], B, Ms,
            algorithm="msa", device=CPU)


def test_batched_driver_serves_tile_plan():
    A, B, M = POOL[3]
    As = [A, revalue(A, 1)]
    p = plan_batch(As, B, [M, M], allow_tile=True)
    if p.algorithm != "tile":
        p = dataclasses.replace(p, algorithm="tile",
                                tile_block=p.tile_block or 8)
    outs = masked_spgemm_batched(As, B, [M, M], plan=p, device=CPU)
    for a, o in zip(As, outs):
        assert_same_result(o, one_shot(a, B, M, plan=p))


@pytest.mark.parametrize("allow_tile", [False, True])
def test_plan_batch_matches_reference(allow_tile):
    for A, B, M in POOL:
        As = [A, revalue(A, 1)]
        Ms = [M, M]
        got = plan_batch(As, B, Ms, allow_tile=allow_tile)
        want = plan_from_reference(ref_plan_batch(
            [ref(a) for a in As], ref(B), [ref(m) for m in Ms],
            allow_tile=allow_tile))
        assert got == want
    with pytest.raises(ValueError):
        plan_batch([], POOL[0][1], [])


def test_batched_driver_rejects_ragged_batches():
    A, B, M = POOL[0]
    with pytest.raises(ValueError):
        masked_spgemm_batched([A, A], B, [M], device=CPU)
    with pytest.raises(ValueError):
        masked_spgemm_batched([], B, [], device=CPU)


# ---------------------------------------------------------------------------
# batcher, result cache, bounded caches
# ---------------------------------------------------------------------------


def test_batcher_buckets_by_structure_and_b_content():
    A, B, M = POOL[0]
    b = Batcher(max_batch=8)

    def req(a, bb, mm):
        return Request(A=a, B=bb, M=mm, semiring=PLUS_TIMES,
                       complement=False, algorithm=None, mesh=None,
                       axis="data", ticket=None, post=None, cache_key=None,
                       submitted_at=0.0)

    assert b.add(req(revalue(A, 1), B, M)) is None
    assert b.add(req(revalue(A, 2), B, M)) is None       # same bucket
    assert b.add(req(revalue(A, 3), revalue(B, 9), M)) is None  # new B
    buckets = b.pop_all()
    assert sorted(len(x) for x in buckets) == [1, 2]
    assert b.pending == 0


def test_batcher_aging_and_deadlines():
    A, B, M = POOL[0]
    b = Batcher(max_batch=8)
    for t, s in ((0.0, 1), (0.5, 2)):
        b.add(Request(A=revalue(A, s), B=B, M=M if s == 1 else POOL[1][2],
                      semiring=PLUS_TIMES, complement=False, algorithm=None,
                      mesh=None, axis="data", ticket=None, post=None,
                      cache_key=None, submitted_at=t))
    assert b.next_deadline() == 0.0
    assert b.has_aged(1.0, now=1.0) and not b.has_aged(1.0, now=0.9)
    assert [len(x) for x in b.pop_aged(1.0, now=1.2)] == [1]
    assert b.next_deadline() == 0.5 and b.pending == 1


def test_long_mixed_stream_keeps_every_cache_bounded():
    clear_plan_cache()
    caches.set_capacity("planner-plans", 16)
    try:
        with engine(result_cache=ResultCache(capacity=8, name="serve-test"),
                    max_batch=4) as eng:
            for q in range(60):
                A = F.erdos_renyi(32, 3, seed=5000 + q)
                B = F.erdos_renyi(32, 3, seed=6000 + q)
                M = F.er_mask(32, 4, seed=7000 + q)
                eng.submit(A, B, M)
                if q % 7 == 0:
                    eng.flush()
            eng.flush()
            info = caches.cache_info()
            assert len(eng.results) <= 8
        assert info["planner-plans"]["size"] <= 16
        for name, row in info.items():
            if "capacity" in row and row["capacity"] >= 0:
                assert row["size"] <= row["capacity"], (name, row)
    finally:
        caches.set_capacity("planner-plans", 128)
        caches.unregister("serve-test")
        clear_plan_cache()


def test_caches_registry_clear_all_and_introspection():
    A, B, M = POOL[1]
    with engine(cache_results=False) as eng:
        eng.serve([(revalue(A, s), B, M) for s in range(2)])
    info = caches.cache_info()
    for expected in ("planner-plans", "planner-explain",
                     "serve-burst-programs"):
        assert expected in info
    assert info["serve-burst-programs"]["size"] >= 1
    caches.clear_all()
    assert all(row["size"] == 0 for row in caches.cache_info().values())


def test_result_cache_capacity_env_var(monkeypatch):
    monkeypatch.setenv("REPRO_RESULT_CACHE_CAP", "3")
    A, B, M = POOL[0]
    with engine(max_batch=1) as eng:
        assert caches.cache_info()[eng.results.name]["capacity"] == 3
        for q in range(6):
            eng.submit(revalue(A, 100 + q), B, M).result()
        info = caches.cache_info()[eng.results.name]
        assert len(eng.results) <= 3
        assert info["misses"] >= 6
        hits_before = info["hits"]
        t = eng.submit(revalue(A, 105), B, M)
        assert t.done()
        assert (caches.cache_info()[eng.results.name]["hits"]
                == hits_before + 1)
        caches.set_capacity(eng.results.name, 1)
        assert len(eng.results) <= 1


def test_result_cache_distinguishes_values_not_just_structure():
    A, B, M = POOL[0]
    A2 = revalue(A, 99)
    assert content_fingerprint(A) != content_fingerprint(A2)
    assert content_fingerprint(A) == content_fingerprint(
        CSR(A.indptr, A.indices, A.data.copy(), A.shape))


def test_complement_results_are_not_cached():
    A, B, M = POOL[0]
    with engine() as eng:
        eng.serve([(A, B, M, {"complement": True})] * 2)
        assert eng.metrics.snapshot()["result_cache_hits"] == 0
        assert len(eng.results) == 0


def test_concurrent_submitters_async():
    A, B, M = POOL[0]
    results = {}

    def client(cid):
        t = eng.submit(revalue(A, cid), B, M)
        results[cid] = t.result(timeout=60.0)

    with engine(async_mode=True, max_batch=4, max_wait_ms=2.0,
                clock=VirtualClock(), cache_results=False) as eng:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        end = time.monotonic() + 60.0
        while any(th.is_alive() for th in threads):
            assert time.monotonic() < end, "clients timed out"
            d = eng.next_flush_deadline()
            if d is not None:
                eng.clock.advance_to(max(d + 1e-9, eng.clock.now()))
            time.sleep(0.002)
        for th in threads:
            th.join(timeout=60.0)
            assert not th.is_alive()
    assert sorted(results) == list(range(8))
    for cid, got in results.items():
        assert_same_result(got, one_shot(revalue(A, cid), B, M))


def test_sync_flush_due_and_quiesce_follow_the_virtual_clock():
    A, B, M = POOL[0]
    clock = VirtualClock()
    with engine(max_wait_ms=5.0, clock=clock, cache_results=False) as eng:
        t = eng.submit(A, B, M)
        assert eng.flush_due() == 0 and not t.done()
        assert eng.next_flush_deadline() == pytest.approx(5e-3)
        clock.advance(6e-3)
        eng.quiesce()
        assert t.done() and eng.next_flush_deadline() is None
