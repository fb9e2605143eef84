"""Port parity for the span layer: ``repro_torch.obs`` spans and sinks,
``planner.explain`` / ``explain_cached`` / ``feature_regime``, the spans
of the serving path, the Chrome-trace and residual exports, the
Prometheus exposition and the ``/metrics`` / ``/health`` endpoint,
against the reference's ``repro.obs`` and ``tests/test_obs.py``.

The contracts: span sites cost one branch when tracing is off and never
feed scheduling (a traced engine gives the same
``deterministic_snapshot()``); span and trace ids are deterministic
counters, nesting links parents; ``explain`` equals the reference's record
for the same plan; one request stream gives the same span names, ids,
parents and traces, in the same order, through both engines.
"""
import json

import numpy as np
import pytest

from repro import obs as ref_obs
from repro.core import planner as rp
from repro.serving import QueryEngine as RefQueryEngine
from repro_torch import obs
from repro_torch.convert import plan_from_reference
from repro_torch.core import planner as tp
from repro_torch.core.formats import CSR, erdos_renyi, er_mask
from repro_torch.core.formats import block_sparse, csr_from_dense
from repro_torch.obs.sinks import InMemorySink, JsonlSpanSink, load_spans
from repro_torch.obs.spans import _NULL_SPAN
from repro_torch.serving import QueryEngine
from repro_torch.serving.metrics import ServeMetrics

CPU = "cpu"


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends untraced (the process default)."""
    obs.disable()
    ref_obs.disable()
    yield
    obs.disable()
    ref_obs.disable()


def _operands(n=64, seed=0):
    return (erdos_renyi(n, 3, seed=seed), erdos_renyi(n, 3, seed=seed + 1),
            er_mask(n, 6, seed=seed + 2))


def _revalue(x, seed: int):
    """Same structure, fresh values, in ``x``'s own CSR type."""
    rng = np.random.default_rng(seed)
    return type(x)(x.indptr, x.indices,
                   rng.uniform(0.5, 1.5, x.nnz).astype(np.float32), x.shape)


def ref(x: CSR):
    from repro.core.formats import CSR as RefCSR
    return RefCSR(x.indptr, x.indices, x.data, x.shape)


# ---------------------------------------------------------------------------
# spans: disabled cost, nesting, determinism
# ---------------------------------------------------------------------------


def test_disabled_sites_are_null_and_shared():
    assert not obs.enabled()
    s = obs.span("anything", attr=1)
    assert s is _NULL_SPAN and s is obs.span("other")
    with s as inner:
        inner.set(whatever=2)           # all no-ops
    assert obs.event("x") is None
    assert obs.counter("serve.queue_depth", 9) is None
    assert obs.new_trace() is None
    assert obs.current_spans() == []


def test_span_nesting_links_parents_and_traces():
    with obs.tracing() as tr:
        tid = obs.new_trace()
        with obs.span("outer", trace=tid) as outer:
            with obs.span("inner") as inner:
                obs.event("leaf", dur_s=0.5)
    recs = {r["name"]: r for r in tr.sink.spans()}
    assert [r["name"] for r in tr.sink.spans()] == ["leaf", "inner",
                                                    "outer"]
    assert recs["outer"]["parent"] is None
    assert recs["inner"]["parent"] == outer.span_id
    assert recs["leaf"]["parent"] == inner.span_id
    assert {recs[k]["trace"] for k in recs} == {tid}
    assert recs["leaf"]["dur"] == 0.5
    assert obs.current_spans() == []


def test_span_ids_are_deterministic_counters():
    def capture():
        with obs.tracing() as tr:
            t1, t2 = obs.new_trace(), obs.new_trace()
            with obs.span("a", trace=t1):
                pass
            with obs.span("b", trace=t2):
                obs.counter("c", 2)
        return [(r["span"], r["trace"]) for r in tr.sink.spans()]

    assert capture() == capture() == [(1, 1), (3, 2), (2, 2)]


def test_span_records_error_and_attrs():
    with obs.tracing() as tr:
        with pytest.raises(RuntimeError):
            with obs.span("boom", stage="setup") as sp:
                sp.set(progress=3)
                raise RuntimeError("x")
    (rec,) = tr.sink.spans()
    assert rec["error"] == "RuntimeError"
    assert rec["attrs"] == {"stage": "setup", "progress": 3}
    assert rec["dur"] >= 0.0


def test_tracing_scope_restores_previous_tracer():
    t_outer = obs.configure()
    with obs.tracing() as t_inner:
        assert obs.get_tracer() is t_inner is not t_outer
    assert obs.get_tracer() is t_outer
    assert obs.disable() is t_outer
    assert not obs.enabled()


def test_counter_records_carry_the_value():
    with obs.tracing() as tr:
        obs.counter("serve.queue_depth", 3)
        with obs.span("serve.exec"):
            obs.counter("serve.inflight", 2.5)
    recs = tr.sink.spans()
    assert [r["name"] for r in recs] == ["serve.queue_depth",
                                         "serve.inflight", "serve.exec"]
    assert recs[0]["counter"] == 3.0 and "dur" not in recs[0]
    assert recs[1]["counter"] == 2.5


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------


def test_inmemory_sink_is_a_bounded_ring():
    sink = InMemorySink(capacity=3)
    with obs.tracing(sink):
        for i in range(5):
            obs.event(f"e{i}")
    assert len(sink) == 3 and sink.emitted == 5
    assert [r["name"] for r in sink.spans()] == ["e2", "e3", "e4"]
    sink.clear()
    assert len(sink) == 0 and sink.emitted == 5


def test_jsonl_sink_roundtrips_and_rotates(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    with JsonlSpanSink(path, max_bytes=512, rotate=16) as sink:
        with obs.tracing(sink):
            for i in range(24):
                obs.event("serve.exec", dur_s=i * 1e-3, idx=i)
    assert sink.written == 24
    assert len(sink.segments()) >= 2                # rotation happened
    head = json.loads(open(path).readline())
    assert head["kind"] == "repro-span-trace"
    recs = load_spans(path, rotate=16)
    assert len(recs) == 24                          # headers not counted
    assert [r["attrs"]["idx"] for r in recs] == list(range(24))


def test_jsonl_sink_files_match_reference(tmp_path):
    """Same records, same rotation: the segment files hold the reference
    sink's headers and the reference's loader reads the port's capture."""
    def capture(module, sink_cls, name):
        path = str(tmp_path / name)
        with sink_cls(path, max_bytes=400, rotate=8) as sink:
            with module.tracing(sink):
                for i in range(12):
                    module.event("e", idx=i)
        return path, sink

    p, sink = capture(obs, JsonlSpanSink, "port.jsonl")
    q, ref_sink = capture(ref_obs, ref_obs.JsonlSpanSink, "ref.jsonl")
    assert len(sink.segments()) == len(ref_sink.segments()) >= 2
    for a, b in zip(sink.segments(), ref_sink.segments()):
        assert open(a).readline() == open(b).readline()
    strip = [{k: r[k] for k in ("name", "span", "attrs")}
             for r in ref_obs.load_spans(p)]
    assert strip == [{k: r[k] for k in ("name", "span", "attrs")}
                     for r in ref_obs.load_spans(q)]


def test_jsonl_sink_seeded_sampling_matches_reference(tmp_path):
    def run(module, sink_cls, fname, seed):
        s = sink_cls(str(tmp_path / fname), sample_rate=0.5, seed=seed)
        with module.tracing(s):
            for i in range(40):
                module.event("e", idx=i)
        s.close()
        return [r["attrs"]["idx"] for r in load_spans(str(tmp_path / fname))]

    a = run(obs, JsonlSpanSink, "a.jsonl", seed=5)
    assert a == run(obs, JsonlSpanSink, "b.jsonl", seed=5)
    assert 0 < len(a) < 40
    assert run(obs, JsonlSpanSink, "c.jsonl", seed=6) != a
    assert a == run(ref_obs, ref_obs.JsonlSpanSink, "r.jsonl", seed=5)


def test_jsonl_sink_rejects_bad_knobs(tmp_path):
    for kw in ({"max_bytes": 0}, {"rotate": 0}, {"sample_rate": 1.5}):
        with pytest.raises(ValueError):
            JsonlSpanSink(str(tmp_path / "x.jsonl"), **kw)


# ---------------------------------------------------------------------------
# planner.explain, explain_cached, feature_regime
# ---------------------------------------------------------------------------


def _blocky():
    return tuple(csr_from_dense(x) for x in (
        block_sparse(128, 8, 0.4, 0.9, seed=1),
        block_sparse(128, 8, 0.4, 0.9, seed=2),
        block_sparse(128, 8, 0.6, 1.0, seed=3, mask=True)))


@pytest.mark.parametrize("case", ["row", "tile", "complement"])
def test_explain_matches_reference(case):
    A, B, M = _operands() if case != "tile" else _blocky()
    comp = case == "complement"
    want_plan = rp.plan(ref(A), ref(B), ref(M), complement=comp)
    got_plan = tp.plan(A, B, M, complement=comp, device=CPU)
    assert got_plan == plan_from_reference(want_plan)
    info = tp.explain(got_plan)
    assert info == rp.explain(want_plan)
    assert info["elected"] == info["algorithm"] == got_plan.algorithm
    assert info["elected"] in info["costs_ms"]
    assert info["elected_cost_ms"] == min(info["costs_ms"].values())
    for algo, feats in info["features"].items():
        assert algo in info["costs_ms"]
        assert all(np.isfinite(v) for v in feats.values())
    if case == "tile":
        assert got_plan.algorithm == "tile" and "tile" in info["features"]
    json.dumps(info)                                # span-attachable
    assert tp.feature_regime(got_plan) == rp.feature_regime(want_plan)


def test_explain_cached_is_memoized_by_plan_identity():
    A, B, M = _operands(seed=3)
    p = tp.plan(A, B, M, device=CPU)
    assert tp.explain_cached(p) is tp.explain_cached(p)
    assert tp.explain_cached(p) == tp.explain(p)


def test_plan_build_span_carries_explain():
    tp.clear_plan_cache()
    A, B, M = _operands(seed=11)
    with obs.tracing() as tr:
        p = tp.plan(A, B, M, device=CPU)
        tp.plan(A, B, M, device=CPU)            # cache hit: no second span
    builds = [r for r in tr.sink.spans() if r["name"] == "plan.build"]
    assert len(builds) == 1
    ex = builds[0]["attrs"]["explain"]
    assert ex["elected"] == p.algorithm
    assert builds[0]["attrs"]["algorithm"] == p.algorithm


def test_spgemm_spans_nest_as_in_reference():
    """One-shot calls on both routes emit the reference's spans."""
    A, B, M = _operands(seed=13)
    bA, bB, bM = _blocky()

    def names(module, call):
        with module.tracing() as tr:
            call()
        return [(r["name"], r["span"], r["parent"])
                for r in tr.sink.spans()]

    from repro.core.masked_spgemm import masked_spgemm as ref_spgemm
    from repro_torch.core.masked_spgemm import masked_spgemm
    for args, kw in (((A, B, M), {"algorithm": "msa"}),
                     ((bA, bB, bM), {"algorithm": "tile", "tile_block": 8})):
        got = names(obs, lambda: masked_spgemm(*args, device=CPU, **kw))
        want = names(ref_obs, lambda: ref_spgemm(*map(ref, args), **kw))
        assert got == want and got


# ---------------------------------------------------------------------------
# the serving path's spans
# ---------------------------------------------------------------------------


def test_request_lifecycle_spans_cover_the_pipeline():
    tp.clear_plan_cache()
    A, B, M = _operands(seed=21)
    stream = [(_revalue(A, s), B, M) for s in range(4)]
    with obs.tracing() as tr:
        with QueryEngine(cache_results=True, device=CPU) as engine:
            engine.serve(stream)
            engine.serve([stream[0]])               # exact repeat -> hit
    names = {r["name"] for r in tr.sink.spans()}
    assert {"serve.submit", "serve.queue_wait", "serve.plan",
            "serve.exec", "serve.result_cache_put", "serve.cache_hit",
            "serve.queue_depth", "serve.inflight", "plan.build"} <= names
    submits = [r for r in tr.sink.spans() if r["name"] == "serve.submit"]
    assert len(submits) == 5
    tids = [r["trace"] for r in submits]
    assert len(set(tids)) == 5 and None not in tids
    execs = [r for r in tr.sink.spans() if r["name"] == "serve.exec"]
    assert execs and set(execs[0]["attrs"]["traces"]) <= set(tids)
    assert execs[0]["attrs"]["regime"] is not None


def _lifecycle(module, engine_cls, ops, delta_cls, **kw):
    """Spans of one request stream: a burst bucket, a tile bucket, a
    complemented single request, a forced-algorithm pair, a failing
    request and a cache-hit replay, then an edge delta to the burst
    structure's mask (revalidation, lane patch, scoped invalidation) and a
    query on the post-delta operands."""
    A, B, M, bA, bB, bM = ops
    col = next(c for c in range(M.shape[1])
               if c not in set(M.indices[M.indptr[3]:M.indptr[4]].tolist()))
    delta = delta_cls.upserts([3], [col], [1.0])
    stream = ([(_revalue(A, s), B, M) for s in range(3)]
              + [(_revalue(bA, s), bB, bM) for s in range(2)]
              + [(A, B, M, {"complement": True}),
                 (A, B, M, {"algorithm": "heap"}),
                 (_revalue(A, 7), B, M, {"algorithm": "heap"}),
                 (A, B, M, {"complement": True, "algorithm": "mca"})])
    with module.tracing() as tr:
        with engine_cls(max_batch=8, **kw) as eng:
            tickets = [eng.submit(*q[:3], **(q[3] if len(q) > 3 else {}))
                       for q in stream]
            eng.flush()
            eng.serve(stream[:2])
            out = eng.submit_delta(A, B, M, delta_m=delta)
            eng.serve([(_revalue(A, 9), out.B, out.M)])
    for t in tickets[:-1]:
        t.result()
    return tr.sink.spans()


def test_stream_spans_equal_reference_names_parents_and_order():
    A, B, M = _operands(seed=31)
    bA, bB, bM = _blocky()
    tp.clear_plan_cache()
    rp.clear_plan_cache()
    from repro import caches as ref_caches
    from repro_torch import caches
    caches.clear_all()
    ref_caches.clear_all()
    from repro.core.formats import CSRDelta as RefCSRDelta
    from repro_torch.core.formats import CSRDelta
    got = _lifecycle(obs, QueryEngine, (A, B, M, bA, bB, bM), CSRDelta,
                     device=CPU)
    want = _lifecycle(ref_obs, RefQueryEngine,
                      tuple(map(ref, (A, B, M, bA, bB, bM))), RefCSRDelta)

    def shape(recs):
        return [(r["name"], r["span"], r.get("parent"), r["trace"])
                for r in recs]

    assert shape(got) == shape(want)
    assert {"delta.apply", "delta.revalidate", "delta.lane_patch",
            "delta.invalidate", "plan.revalidate", "burst.patch",
            "cache.invalidate"} <= {r["name"] for r in got}
    revalidated = [r["attrs"] for r in got if r["name"] == "plan.revalidate"]
    assert revalidated == [r["attrs"] for r in want
                           if r["name"] == "plan.revalidate"]
    routes = [r["attrs"]["route"] for r in got if r["name"] == "serve.exec"]
    assert {"burst", "tile", "single", "batched"} <= set(routes)
    assert [r["attrs"].get("route") for r in want
            if r["name"] == "serve.exec"] == routes


def test_tracing_never_perturbs_deterministic_snapshot():
    A, B, M = _operands(seed=41)
    stream = [(_revalue(A, s), B, M) for s in range(6)]

    def run(traced):
        with QueryEngine(cache_results=False, device=CPU) as engine:
            if traced:
                with obs.tracing():
                    engine.serve(stream)
            else:
                engine.serve(stream)
            return engine.metrics.deterministic_snapshot()

    assert run(traced=False) == run(traced=True)


# ---------------------------------------------------------------------------
# ServeMetrics: hit/miss latency split
# ---------------------------------------------------------------------------


def test_cache_hit_latencies_tracked_separately():
    m = ServeMetrics()
    m.record_bucket(size=3, algorithm="msa", route="batched",
                    queue_wait_s=0.0, plan_s=0.0, exec_s=0.3,
                    latencies_s=(0.10, 0.20, 0.30))
    for s in (0.001, 0.002):
        m.record_cache_hit(latency_s=s)
    snap = m.snapshot()
    assert snap["miss_lat_count"] == 3 and snap["hit_lat_count"] == 2
    assert snap["lat_count"] == 5
    assert snap["lat_p50_s"] < snap["miss_lat_p50_s"]
    assert snap["hit_lat_p99_s"] < snap["miss_lat_p50_s"]
    m.record_cache_hit()
    snap2 = m.snapshot()
    assert snap2["result_cache_hits"] == 3
    assert snap2["hit_lat_count"] == 2
    m.record_submit(4)
    m.record_failure()
    assert m.hit_rate() == 3 / 4
    assert m.error_rate() == 1 / 7
    assert m.bucket_schedule() == [{"size": 3, "algorithm": "msa",
                                    "route": "batched", "merged_from": 1,
                                    "label": None}]


def test_engine_records_hit_latency():
    A, B, M = _operands(seed=51)
    with QueryEngine(device=CPU) as engine:
        engine.serve([(A, B, M)])
        engine.serve([(A, B, M)])
        snap = engine.metrics.snapshot()
    assert snap["result_cache_hits"] == 1
    assert snap["hit_lat_count"] == 1
    assert snap["lat_count"] == snap["miss_lat_count"] + 1


# ---------------------------------------------------------------------------
# export: Chrome trace events and modeled-vs-measured residuals
# ---------------------------------------------------------------------------


def _captured():
    """One capture with slices, nesting, an error, a counter track and
    exec spans with and without a modeled cost."""
    with obs.tracing() as tr:
        with obs.span("serve.exec", algorithm="msa", route="row",
                      modeled_ms=1.0, size=2):
            obs.event("spgemm.row", dur_s=1e-3)
            obs.counter("serve.inflight", 2.5)
        obs.event("serve.exec", dur_s=4e-3, algorithm="tile", route="tile",
                  modeled_ms=2.0, regime="r")
        obs.event("serve.exec", dur_s=1e-3, route="burst")      # no model
        obs.counter("serve.queue_depth", 3)
        with pytest.raises(ValueError):
            with obs.span("boom", obj=object()):
                raise ValueError("x")
    return tr.sink.spans()


def test_chrome_trace_export_equals_reference():
    spans = _captured()
    doc = obs.chrome_trace(spans)
    assert doc == ref_obs.chrome_trace(spans)
    evs = doc["traceEvents"]
    assert {e["ph"] for e in evs} == {"X", "C"}
    by_name = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert by_name["spgemm.row"]["dur"] == pytest.approx(1e3)
    assert by_name["serve.exec"]["cat"] == "serve"
    assert by_name["boom"]["args"]["error"] == "ValueError"
    assert min(e["ts"] for e in evs) == 0.0
    counters = {e["name"]: e for e in evs if e["ph"] == "C"}
    assert counters["serve.queue_depth"]["args"] == {"value": 3.0}
    assert all("dur" not in e for e in counters.values())
    json.dumps(doc)
    assert obs.chrome_trace([]) == {"traceEvents": [],
                                    "displayTimeUnit": "ms"}


def test_save_chrome_trace_writes_loadable_json(tmp_path):
    spans = _captured()
    p = tmp_path / "trace.json"
    obs.save_chrome_trace(str(p), spans)
    assert json.load(open(p)) == json.loads(json.dumps(
        ref_obs.chrome_trace(spans)))


def test_residuals_equal_reference():
    spans = _captured()
    rows = obs.residuals(spans)
    assert rows == ref_obs.residuals(spans)
    assert [r["algorithm"] for r in rows] == ["msa", "tile"]
    assert rows[1]["residual"] == pytest.approx(2.0)
    assert rows[0]["size"] == 2
    summary = obs.export.residual_summary(spans)
    assert summary == ref_obs.export.residual_summary(spans)
    assert set(summary) == {"msa", "tile"}


@pytest.mark.parametrize("records", [
    [], None,
    [{"name": "serve.exec", "dur": 0.01},
     {"name": "serve.queue_wait", "dur": 0.0},
     {"name": "serve.exec", "counter": 1.0}]])
def test_residuals_tolerate_empty_and_planless_captures(records):
    assert obs.residuals(records) == []
    assert obs.export.residual_summary(records) == {}


@pytest.mark.parametrize("rec, residual", [
    ({"name": "serve.exec", "dur": 4e-3,
      "attrs": {"modeled_ms": 2.0, "size": 2, "algorithm": "msa",
                "route": "batched", "regime": "r"}}, 1.0),
    ({"name": "other", "dur": 1.0}, None),
    ({"name": "serve.exec", "counter": 2.0}, None),
    ({"name": "serve.exec", "dur": 1.0, "attrs": {"modeled_ms": "x"}}, None),
    ({"name": "serve.exec", "dur": 1.0, "attrs": {"modeled_ms": 0.0}}, None),
    ({"name": "serve.exec", "dur": 1.0,                # size 0 counts 1
      "attrs": {"modeled_ms": 1.0, "size": 0}}, 1000.0),
    ("not a record", None)])
def test_residual_record_filters_and_normalizes(rec, residual):
    from repro.obs.export import residual_record as ref_residual_record
    from repro_torch.obs.export import residual_record
    r = residual_record(rec)
    assert r == ref_residual_record(rec)
    if residual is None:
        assert r is None
    else:
        assert r["residual"] == pytest.approx(residual)


# ---------------------------------------------------------------------------
# exposition and the HTTP endpoint
# ---------------------------------------------------------------------------


def test_render_parse_roundtrip_with_histograms():
    from repro_torch.obs.exposition import HISTOGRAM_BUCKETS
    with obs.tracing():
        obs.event("serve.exec", dur_s=5e-4)
        obs.event("serve.exec", dur_s=2e-2)
        text = obs.render_prometheus()
    samples = obs.parse_prometheus(text)
    assert samples == ref_obs.parse_prometheus(text)
    name = "repro_span_duration_seconds"
    count = samples[(f"{name}_count", (("phase", "serve.exec"),))]
    total = samples[(f"{name}_sum", (("phase", "serve.exec"),))]
    inf = samples[(f"{name}_bucket",
                   (("le", "+Inf"), ("phase", "serve.exec")))]
    assert count == inf == 2.0
    assert total == pytest.approx(5e-4 + 2e-2)
    counts = [samples[(f"{name}_bucket",
                       (("le", repr(le)), ("phase", "serve.exec")))]
              for le in HISTOGRAM_BUCKETS]
    assert counts == sorted(counts) and counts[-1] == 2.0
    # the port's registry caches appear with labels
    assert samples[("repro_cache_capacity", (("cache", "planner-plans"),))]


def test_render_prometheus_without_a_tracer_skips_histograms():
    text = obs.render_prometheus()
    assert "repro_span_duration_seconds" not in text
    assert "repro_cache_size" in text


@pytest.mark.parametrize("text", [
    "not a sample line at all with {\n",
    "metric{label=unquoted} 1\n",
    "bad-name 1\n",
    "novalue\n"])
def test_parse_prometheus_rejects_malformed(text):
    with pytest.raises(ValueError):
        obs.parse_prometheus(text)
    with pytest.raises(ValueError):
        ref_obs.parse_prometheus(text)


def test_parse_prometheus_nonfinite_values_and_escapes():
    import math
    text = ('b_bucket{le="+Inf"} 7\n'
            'q{quantile="0.99"} NaN\n'
            'lo -Inf\n'
            'hi +Inf\n'
            'm{v="a\\nb\\"c\\\\d"} 1\n'
            'm{v="x,y"} 2\n'
            'm{v="tail\\\\"} 3\n'
            '# a comment\n\n')
    s = obs.parse_prometheus(text)
    assert s[("b_bucket", (("le", "+Inf"),))] == 7.0
    assert math.isnan(s[("q", (("quantile", "0.99"),))])
    assert s[("lo", ())] == float("-inf") and s[("hi", ())] == float("inf")
    assert s[("m", (("v", 'a\nb"c\\d'),))] == 1.0
    assert s[("m", (("v", "x,y"),))] == 2.0
    assert s[("m", (("v", "tail\\"),))] == 3.0
    ref = ref_obs.parse_prometheus(text)
    assert {k: v for k, v in s.items() if k[0] != "q"} == \
        {k: v for k, v in ref.items() if k[0] != "q"}


def test_render_parse_round_trip_is_lossless():
    import math
    from repro.obs.exposition import _Writer as RefWriter
    from repro_torch.obs.exposition import _Writer
    texts = []
    for cls in (_Writer, RefWriter):
        w = cls()
        w.sample("rt_nan", float("nan"))
        w.sample("rt_inf", float("inf"))
        w.sample("rt_bool", True, kind="counter", help_text="a flag")
        w.sample("rt_esc", 1.5, {"path": 'a\\b"c\nd', "tail": "z\\"})
        texts.append(w.render())
    assert texts[0] == texts[1]
    s = obs.parse_prometheus(texts[0])
    assert math.isnan(s[("rt_nan", ())])
    assert s[("rt_inf", ())] == float("inf") and s[("rt_bool", ())] == 1.0
    assert s[("rt_esc", (("path", 'a\\b"c\nd'), ("tail", "z\\")))] == 1.5


def test_counter_records_skipped_by_span_histograms():
    with obs.tracing() as tr:
        obs.counter("serve.queue_depth", 4)
        obs.event("serve.exec", dur_s=0.01)
        text = obs.render_prometheus(tracer=tr)
    samples = obs.parse_prometheus(text)
    assert ("repro_span_duration_seconds_count",
            (("phase", "serve.exec"),)) in samples
    assert not any("queue_depth" in name for name, _ in samples)


def test_http_endpoint_serves_metrics_and_health():
    import urllib.error
    import urllib.request
    A, B, M = _operands()
    with QueryEngine(expose_port=0, device=CPU) as engine:
        engine.serve([(A, B, M)])
        engine.serve([(A, B, M)])                   # result-cache hit
        base = engine.obs_server.url
        assert engine.obs_server.port > 0
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            samples = obs.parse_prometheus(r.read().decode())
        with urllib.request.urlopen(f"{base}/health?verbose=1",
                                    timeout=10) as r:
            assert r.headers["Content-Type"] == "application/json"
            health = json.loads(r.read().decode())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope", timeout=10)
    assert samples[("repro_serve_completed_total", ())] == 2.0
    assert samples[("repro_serve_result_cache_hits_total", ())] == 1.0
    assert samples[("repro_serve_queue_depth", ())] == 0.0
    assert health == {"status": "ok", "reasons": [], "queue_depth": 0,
                      "async_mode": False, "stopped": False,
                      "completed": 2, "failed": 0}


def test_engine_close_shuts_exposition_down():
    import urllib.request
    engine = QueryEngine(expose_port=0, device=CPU)
    url = engine.obs_server.url
    engine.close()
    assert engine.obs_server is None
    with pytest.raises(Exception):
        urllib.request.urlopen(f"{url}/health", timeout=2)


def test_obs_server_standalone_context_manager():
    """``start_server`` on an engine that lacks ``health()`` answers with
    the liveness verdict, and the context manager closes it."""
    import urllib.request
    from repro_torch.obs.serve import ObsServer, start_server

    class Bare:
        metrics = ServeMetrics()
        _stop = False

        def _pending(self):
            return 0

    with start_server(Bare()) as srv:
        assert isinstance(srv, ObsServer)
        with urllib.request.urlopen(f"{srv.url}/health", timeout=10) as r:
            assert json.loads(r.read().decode())["status"] == "ok"
    with pytest.raises(Exception):
        urllib.request.urlopen(f"{srv.url}/health", timeout=2)
