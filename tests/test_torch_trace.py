"""Port parity for trace capture and replay (``serving/trace.py``), against
the reference's ``repro.serving.trace`` and its ``tests/test_trace_replay.py``
(one test for each, apart from the knob autotuner's and the tuning
profile's, which belong to ``tuning/``, and the benchmark registry's).

The contracts: one JSONL schema in both packages (each reads the other's
files, fingerprints agree), and a replay is deterministic: two replays of
one trace, sync or async, give one digest, schedule and set of counters,
the reference's schedule and deterministic counters, and results bitwise
equal to the port's one-shot calls.  Against the reference's replay the
results are compared bitwise on the row routes and within the block
product's reference tolerance, 1e-4, on the tile route.  No hypothesis
draws: the reference's property test runs here as fixed draws.
"""
import json
import os

import numpy as np
import pytest

from repro.serving import trace as rtrace
from repro_torch.core.distributed import make_mesh
from repro_torch.core.formats import erdos_renyi, er_mask
from repro_torch.core.masked_spgemm import masked_spgemm
from repro_torch.serving import (QueryEngine, Trace, TraceError,
                                 TraceRecorder, VirtualClock, replay_trace,
                                 synthesize_trace)
from repro_torch.serving.trace import (GOLDEN_TRACE_NAME, RotatingTraceSink,
                                       _result_crc, fingerprint_digest,
                                       golden_trace_path, load_rotated,
                                       materialize, spec_er, spec_er_mask,
                                       spec_inline)

CPU = "cpu"


def tiny_trace(seed=0, queries=10, **kw):
    return synthesize_trace(name=f"tiny-{seed}", n=48, n_structs=2,
                            queries=queries, mean_gap_ms=0.3, seed=seed,
                            **kw)


def replay(trace, **kw):
    return replay_trace(trace, device=CPU, **kw)


# ---------------------------------------------------------------------------
# schema / validation negative paths
# ---------------------------------------------------------------------------


def test_trace_rejects_wrong_schema_version():
    text = tiny_trace().dumps()
    assert text == rtrace.synthesize_trace(
        name="tiny-0", n=48, n_structs=2, queries=10, mean_gap_ms=0.3,
        seed=0).dumps()                       # one schema, one generator
    lines = text.splitlines()
    header = json.loads(lines[0])
    header["schema"] = 99
    with pytest.raises(TraceError, match="schema"):
        Trace.loads("\n".join([json.dumps(header)] + lines[1:]))


def test_trace_rejects_wrong_kind_and_garbage():
    lines = tiny_trace().dumps().splitlines()
    header = json.loads(lines[0])
    header["kind"] = "some-other-artifact"
    with pytest.raises(TraceError, match="kind"):
        Trace.loads("\n".join([json.dumps(header)] + lines[1:]))
    with pytest.raises(TraceError):
        Trace.loads("not json at all\n")
    with pytest.raises(TraceError):
        Trace.loads("")


def test_trace_rejects_truncated_capture():
    lines = tiny_trace(queries=6).dumps().splitlines()
    with pytest.raises(TraceError, match="requests"):
        Trace.loads("\n".join(lines[:-2]) + "\n")


def test_trace_rejects_decreasing_arrivals_and_bad_semiring():
    tr = tiny_trace(queries=4)
    tr.events[2]["t"] = tr.events[1]["t"] - 0.5
    with pytest.raises(TraceError, match="non-decreasing"):
        tr.validate()
    tr2 = tiny_trace(queries=4)
    tr2.events[0]["semiring"] = "no_such_semiring"
    with pytest.raises(TraceError, match="semiring"):
        tr2.validate()


def test_materialize_rejects_fingerprint_drift():
    tr = tiny_trace(queries=4)
    tr.events[1]["fp"]["A"] = (tr.events[1]["fp"]["A"] + 1) & 0xFFFFFFFF
    with pytest.raises(TraceError, match="fingerprint"):
        tr.materialized()
    assert len(tr.materialized(check=False)) == 4


def test_inline_spec_roundtrips_byte_exact():
    A = erdos_renyi(32, 3, seed=5)
    spec = spec_inline(A)
    back = materialize(spec)
    assert fingerprint_digest(back) == fingerprint_digest(A)
    for got in (back, rtrace.materialize(spec)):  # the reference reads it
        np.testing.assert_array_equal(got.data, A.data)
        np.testing.assert_array_equal(got.indices, A.indices)
        np.testing.assert_array_equal(got.indptr, A.indptr)
    assert fingerprint_digest(A) == rtrace.fingerprint_digest(
        rtrace.materialize(spec))


# ---------------------------------------------------------------------------
# capture: recorder hooked into QueryEngine.submit
# ---------------------------------------------------------------------------


def test_recorder_captures_submit_stream_and_replays():
    rec = TraceRecorder(name="unit-capture")
    A = rec.register_operand(erdos_renyi(48, 3, seed=1),
                             spec_er(48, 3, seed=1))
    B = rec.register_operand(erdos_renyi(48, 3, seed=2),
                             spec_er(48, 3, seed=2))
    M = rec.register_operand(er_mask(48, 5, seed=3),
                             spec_er_mask(48, 5, seed=3))
    inline_a = erdos_renyi(48, 4, seed=9)
    with QueryEngine(clock=VirtualClock(), recorder=rec,
                     cache_results=False, device=CPU) as eng:
        eng.submit(A, B, M)
        eng.clock.advance(0.004)
        eng.submit(inline_a, B, M, complement=True)
        eng.flush()
    tr = rec.trace()
    assert tr.n_requests == 2
    assert tr.events[0]["A"]["kind"] == "er"
    assert tr.events[1]["A"]["kind"] == "inline"
    assert tr.events[1]["complement"] is True
    assert tr.events[0]["t"] == 0.0
    assert tr.events[1]["t"] == pytest.approx(0.004)
    rep = replay(Trace.loads(tr.dumps()))
    assert rep.n_requests == 2 and rep.counters["failed"] == 0
    # the reference loads and validates the port's capture
    assert rtrace.Trace.loads(tr.dumps()).materialized(check=True)


def test_recorder_rejects_mesh_requests():
    rec = TraceRecorder()
    A, B, M = (erdos_renyi(32, 3, seed=1), erdos_renyi(32, 3, seed=2),
               er_mask(32, 4, seed=3))
    with pytest.raises(TraceError, match="mesh"):
        rec.on_submit(A, B, M, t=0.0, mesh=object())
    with QueryEngine(recorder=rec, cache_results=False, device=CPU) as eng:
        with pytest.raises(TraceError, match="mesh"):
            eng.submit(A, B, M, mesh=make_mesh(1, device=CPU))
    assert rec.events == []


# ---------------------------------------------------------------------------
# any recorded trace replays deterministically (fixed draws)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed, queries, max_batch, max_wait_ms", [
    (0, 4, 2, 0.0), (11, 8, 4, 0.5), (123, 12, 8, 2.0), (999, 6, 3, 0.5)])
def test_any_trace_replays_deterministically(seed, queries, max_batch,
                                             max_wait_ms):
    trace = Trace.loads(tiny_trace(seed=seed, queries=queries).dumps())
    knobs = dict(max_batch=max_batch, max_wait_ms=max_wait_ms)
    sync1 = replay(trace, knobs=knobs)
    sync2 = replay(trace, knobs=knobs)
    asy = replay(trace, knobs=knobs, async_mode=True)
    assert sync1.digest == sync2.digest == asy.digest
    assert sync1.schedule == sync2.schedule == asy.schedule
    assert sync1.counters == sync2.counters == asy.counters
    assert sync1.result_crcs == sync2.result_crcs == asy.result_crcs
    assert sync1.counters["submitted"] == queries
    assert (sync1.counters["completed"]
            + sync1.counters["failed"]) == queries
    want = rtrace.replay_trace(rtrace.Trace.loads(trace.dumps()),
                               knobs=knobs)
    assert sync1.schedule == want.schedule
    assert sync1.counters == want.counters


def test_replay_results_byte_equal_one_shot_oracle():
    trace = tiny_trace(seed=11, queries=8)
    rep = replay(trace, knobs=dict(max_batch=4))
    want = [_result_crc(masked_spgemm(A, B, M, semiring=kw["semiring"],
                                      complement=kw["complement"],
                                      algorithm=kw.get("algorithm")
                                      or "auto", device=CPU))
            for (_t, A, B, M, kw) in trace.materialized()]
    assert rep.result_crcs == want


def _arr(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def test_golden_trace_is_committed_and_replays_bitwise():
    """The committed golden trace replays twice to one digest, with the
    reference replay's schedule and deterministic counters (48 submitted,
    22 buckets, 7 result-cache hits, as ``results/bench/replay_grid.json``
    records); every result is bitwise the reference's on the row routes
    and within 1e-4 on the tile route (the block-dense structure)."""
    path = golden_trace_path()
    assert os.path.basename(path) == GOLDEN_TRACE_NAME
    assert os.path.exists(path), "golden trace must be committed"
    trace = Trace.load(path)
    assert trace.n_requests >= 32
    r1 = replay(trace, keep_results=True)
    r2 = replay(trace)
    assert r1.digest == r2.digest
    assert r1.result_crcs == r2.result_crcs
    assert r1.counters["result_cache_hits"] > 0
    grid = json.load(open(os.path.join(os.path.dirname(path), os.pardir,
                                       "bench", "replay_grid.json")))
    for k in ("submitted", "buckets_executed", "result_cache_hits"):
        assert r1.counters[k] == grid["counters"][k]
    want = rtrace.replay_trace(rtrace.Trace.load(path), keep_results=True)
    assert r1.schedule == want.schedule
    assert r1.counters == want.counters
    for ev, got, rgot in zip(trace.events, r1.results, want.results):
        tile = ev["A"].get("base", ev["A"])["kind"] == "block"
        for g, w in ((got.vals, rgot.vals), (got.present, rgot.present),
                     (got.mask_cols, rgot.mask_cols)):
            if tile and g is got.vals:
                np.testing.assert_allclose(_arr(g), _arr(w), rtol=1e-4,
                                           atol=1e-4)
            else:
                np.testing.assert_array_equal(_arr(g), _arr(w))


# ---------------------------------------------------------------------------
# rotating sink: segment boundaries + seeded sampling
# ---------------------------------------------------------------------------


def _line_len(event):
    return len(json.dumps(event, sort_keys=True)) + 1


def test_rotating_sink_rotation_boundaries(tmp_path):
    tr = tiny_trace(queries=12)
    cap = max(_line_len(ev) for ev in tr.events) * 3 + 120
    path = str(tmp_path / "rot.jsonl")
    with RotatingTraceSink(path, max_bytes=cap, rotate=8,
                           name="rot-test") as sink:
        for ev in tr.events:
            assert sink.write(ev)
    segs = sink.segments()
    assert len(segs) >= 3
    for p in segs:
        n_events = sum(1 for _ in open(p)) - 1
        assert os.path.getsize(p) <= cap or n_events == 1
        seg = Trace.load(p)
        assert seg.name == "rot-test" and seg.n_requests == n_events >= 1
    loaded = load_rotated(path, rotate=8)
    assert [ev["t"] for ev in loaded.events] == [ev["t"] for ev in tr.events]
    assert [ev["fp"] for ev in loaded.events] == [ev["fp"]
                                                  for ev in tr.events]
    assert sink.written == 12 and sink.sampled_out == 0
    # the reference's sink writes the same segments, byte for byte
    rpath = str(tmp_path / "ref.jsonl")
    with rtrace.RotatingTraceSink(rpath, max_bytes=cap, rotate=8,
                                  name="rot-test") as rsink:
        for ev in tr.events:
            rsink.write(ev)
    assert [open(p).read() for p in segs] == \
        [open(p).read() for p in rsink.segments()]


def test_rotating_sink_drops_oldest_beyond_rotate(tmp_path):
    tr = tiny_trace(seed=3, queries=12)
    cap = max(_line_len(ev) for ev in tr.events) * 2 + 120
    path = str(tmp_path / "rot.jsonl")
    with RotatingTraceSink(path, max_bytes=cap, rotate=2) as sink:
        for ev in tr.events:
            sink.write(ev)
    assert len(sink.segments()) == 3
    kept = [ev["t"] for ev in load_rotated(path, rotate=2).events]
    assert 0 < len(kept) < 12
    assert kept == [ev["t"] for ev in tr.events][-len(kept):]
    assert sink.written == 12


def test_rotating_sink_oversized_event_still_writes(tmp_path):
    tr = tiny_trace(queries=2)
    path = str(tmp_path / "big.jsonl")
    with RotatingTraceSink(path, max_bytes=1, rotate=2) as sink:
        assert sink.write(tr.events[0])
    assert sink.written == 1
    assert Trace.load(path).n_requests == 1


def test_sampled_capture_deterministic_under_keep_events_false(tmp_path):
    A = erdos_renyi(32, 3, seed=1)
    B = erdos_renyi(32, 3, seed=2)
    M = er_mask(32, 4, seed=3)

    def capture(fname, seed):
        sink = RotatingTraceSink(str(tmp_path / fname), max_bytes=1 << 20,
                                 rotate=2, sample_rate=0.5, seed=seed)
        rec = TraceRecorder(name="sampled", sink=sink, keep_events=False)
        rec.register_operand(A, spec_er(32, 3, seed=1))
        rec.register_operand(B, spec_er(32, 3, seed=2))
        rec.register_operand(M, spec_er_mask(32, 4, seed=3))
        for q in range(40):
            rec.on_submit(A, B, M, t=q * 1e-3)
        sink.close()
        assert rec.events == []
        assert sink.written + sink.sampled_out == 40
        assert 0 < sink.written < 40
        return sink

    s1 = capture("a.jsonl", seed=7)
    s2 = capture("b.jsonl", seed=7)
    assert s1.written == s2.written
    assert (open(tmp_path / "a.jsonl").read()
            == open(tmp_path / "b.jsonl").read())
    t1 = [ev["t"] for ev in Trace.load(str(tmp_path / "a.jsonl")).events]
    s3 = capture("c.jsonl", seed=8)
    t3 = [ev["t"] for ev in Trace.load(str(tmp_path / "c.jsonl")).events]
    assert (s3.written, t3) != (s1.written, t1)
