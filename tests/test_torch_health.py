"""Port parity for the health layer: ``repro_torch.obs`` windows, SLOs,
drift, exposition, the HTTP endpoint and the trajectory report, against
the reference's ``repro.obs`` and ``tests/test_health.py``.

The contracts: on one record stream and one virtual clock both packages'
``WindowAggregator``, ``SLOEngine``, ``DriftDetector`` and
``HealthMonitor`` give equal windows, burn rates, statuses, flags,
snapshots and verdicts (pure Python, so ``==``; the one allowed
difference is the tune CLI's module name in ``report().command``); the
exposition renders the reference's lines from the same state; the
golden trace served under a monitor gives the same verdict, serve
counters and drift keys; ``report`` renders the committed grids and the
git-history cases exactly as the reference does.  Then the port's
counterparts of the reference's behaviour tests: ring shards on the
injectable clock, budgets and the both-windows rule, drift flags and
resets, ``health()`` and ``/health`` flipping to 503 under an error
storm, the ``/metrics`` families, ``close()`` stopping the server and a
scrape while an async engine serves.  Engines pass ``device="cpu"``.
"""
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro import obs as ref_obs
from repro.obs import drift as ref_drift
from repro.obs import exposition as ref_exposition
from repro.obs import health as ref_health
from repro.obs import report as ref_report
from repro.obs import slo as ref_slo
from repro.serving.clock import VirtualClock as RefVirtualClock
from repro.serving.trace import replay_trace as ref_replay_trace
from repro.tuning import profile as rprofile
from repro_torch import obs, tuning
from repro_torch.core import planner
from repro_torch.core.formats import (block_sparse, csr_from_dense,
                                      er_mask, erdos_renyi)
from repro_torch.obs import drift, exposition, export, health, slo
from repro_torch.obs import report
from repro_torch.obs.drift import DriftDetector, KernelStats, family_of
from repro_torch.obs.health import (HealthMonitor, HealthVerdict,
                                    WindowAggregator, basic_verdict)
from repro_torch.obs.slo import DEFAULT_SLOS, Objective, SLOEngine
from repro_torch.serving import QueryEngine
from repro_torch.serving.clock import VirtualClock
from repro_torch.serving.trace import (Trace, golden_trace_path,
                                       replay_trace)
from repro_torch.tuning import profile as tprofile

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"

#: the tune CLI each package's drift report names
PORT_TUNE, REF_TUNE = "python -m repro_torch.tune", "python -m repro.tune"
#: the cost-model token of the shipped constants (both packages)
BUILTIN_TOKEN = "builtin-cf91fbf2"


def _builtin(snapshot):
    """The shipped tables as a profile versioned "builtin": activating it
    restores ``cost_model_token()`` exactly."""
    return dataclasses.replace(
        snapshot(name="builtin", backend={"platform": "test"}),
        version="builtin")


#: captured before any test activates a profile
BUILTIN = _builtin(tprofile.snapshot)
REF_BUILTIN = _builtin(rprofile.snapshot)


def _warped(factor):
    """The shipped tables with every row and tile constant x ``factor``."""
    return dataclasses.replace(
        BUILTIN, version="",
        cost_constants={a: {k: v * factor for k, v in t.items()}
                        for a, t in BUILTIN.cost_constants.items()},
        tile_cost={k: v * factor for k, v in BUILTIN.tile_cost.items()})


@pytest.fixture
def builtin_tables():
    """Both packages under the shipped constants, and again after the
    test whatever it activated."""
    def restore():
        tuning.activate(BUILTIN)
        planner.clear_plan_cache()
        rprofile.activate(REF_BUILTIN)

    restore()
    try:
        yield
    finally:
        restore()


@pytest.fixture(autouse=True)
def _tracing_off():
    obs.disable()
    ref_obs.disable()
    yield
    obs.disable()
    ref_obs.disable()


def _operands(n=64, seed=0):
    return (erdos_renyi(n, 3, seed=seed), erdos_renyi(n, 3, seed=seed + 1),
            er_mask(n, 6, seed=seed + 2))


def _exec(dur=0.01, size=1, **attrs):
    return {"name": "serve.exec", "dur": dur,
            "attrs": {"size": size, **attrs}}


def _get(url):
    """``(status, body)`` of a GET, HTTP errors included."""
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# ---------------------------------------------------------------------------
# parity: one record stream through both packages
# ---------------------------------------------------------------------------

ALGOS = ("msa", "hash", "mca", "inner", "tile", "spsumma")
REGIMES = ("r0", "r1", None)
GAUGES = ("serve.queue_depth", "serve.inflight", "serve.cache_hit_rate")
OBJECTIVES = (
    ("lat", "latency_p99", 0.02, 0.1, 2),
    ("err", "error_rate", 0.25, None, 1),
    ("hits", "cache_hit_rate", 0.5, None, 3),
    ("qw", "queue_wait_share", 0.4, None, 1),
)


def _objectives(mod):
    return list(mod.DEFAULT_SLOS) + [
        mod.Objective(name, metric, bound=bound, budget=budget,
                      short_s=5.0, long_s=30.0, min_events=k)
        for name, metric, bound, budget, k in OBJECTIVES]


def _stream(seed, n=400):
    """``(clock step, record)`` pairs: exec spans (some burst, some
    without a modeled cost, buckets of 1-8), errors, queue waits,
    submits, cache hits and counter tracks, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dt = float(rng.choice([0.0, 0.05, 0.4, 2.0, 7.0],
                              p=[0.4, 0.3, 0.2, 0.08, 0.02]))
        kind = int(rng.integers(8))
        if kind <= 2:
            alg = ALGOS[int(rng.integers(len(ALGOS)))]
            attrs = {"size": int(rng.integers(1, 9)), "algorithm": alg,
                     "route": "burst" if rng.random() < 0.15 else "batched",
                     "regime": REGIMES[int(rng.integers(3))],
                     "modeled_ms": (None if rng.random() < 0.1 else
                                    float(rng.uniform(0.1, 5.0)))}
            rec = {"name": "serve.exec",
                   "dur": float(rng.lognormal(-5.0, 1.5)), "attrs": attrs}
        elif kind == 3:
            rec = {"name": "serve.error", "dur": 0.0,
                   "attrs": {"error": "NotImplementedError"}}
        elif kind == 4:
            rec = {"name": "serve.queue_wait",
                   "dur": float(rng.exponential(0.01))}
        elif kind == 5:
            rec = {"name": "serve.submit", "dur": float(rng.exponential(1e-4))}
        elif kind == 6:
            rec = {"name": "serve.cache_hit",
                   "dur": float(rng.exponential(1e-5))}
        else:
            rec = {"name": GAUGES[int(rng.integers(3))],
                   "counter": float(rng.integers(0, 64))}
        out.append((dt, rec))
    return out


def _window_view(w):
    names = list(w.names)
    view = {"names": names,
            "gauges": {g: w.gauge(g) for g in GAUGES}}
    for n in names:
        view[n] = (w.count(n), w.req_count(n), w.dur_sum(n),
                   list(w.samples(n)), w.percentile(n, 0.5),
                   w.percentile(n, 0.99))
    return view


def _monitor_view(mon, engine=None):
    """Everything a monitor reports, as plain data; the port's tune
    command spelled the reference's way."""
    def norm(x):
        return json.loads(json.dumps(x).replace(PORT_TUNE, REF_TUNE))

    det = mon.drift
    return {
        "windows": {s: _window_view(mon.aggregator.window(s))
                    for s in (1, 5, 30, 60, 600)},
        "slo": [st.as_dict() for st in mon.slo_status()],
        "verdict": norm(mon.verdict(engine).as_dict()),
        "flags": [f.as_dict() for f in det.flags()],
        "snapshot": det.snapshot(),
        "report": norm(det.report().as_dict()),
        "token": det.token,
        "stats": {k: (v.count, v.mean, v.variance, v.ewma)
                  for k, v in det.stats().items()},
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windows_slos_and_drift_equal_reference_on_one_stream(seed):
    """The same records on the same virtual timeline: every window
    aggregate, SLO status and burn rate, drift statistic, flag, snapshot,
    report and verdict equal (a token change mid-stream resets both)."""
    token = ["tok-a"]
    monitors = []
    for mod_health, mod_drift, clock_cls, mod_slo in (
            (health, drift, VirtualClock, slo),
            (ref_health, ref_drift, RefVirtualClock, ref_slo)):
        clk = clock_cls()
        det = mod_drift.DriftDetector(band=3.0, min_count=4,
                                      token_fn=lambda: token[0])
        mon = mod_health.HealthMonitor(clock=clk, slos=_objectives(mod_slo),
                                       drift=det, sample_cap=16,
                                       horizon_s=60.0, shards=12)
        monitors.append((clk, mon))
    stream = _stream(seed)
    checkpoints = 0
    for i, (dt, rec) in enumerate(stream):
        if i == len(stream) // 2:
            token[0] = "tok-b"
        for clk, mon in monitors:
            clk.advance(dt)
            mon.emit(rec)
        if i % 40 == 39:
            got, want = (_monitor_view(m) for _, m in monitors)
            assert got == want
            checkpoints += 1
    got, want = (_monitor_view(m) for _, m in monitors)
    assert got == want and checkpoints == 10
    # the stream exercised what it claims to
    assert got["token"] == "tok-b"
    assert got["flags"] and "--only" in got["report"]["command"]
    assert {s["status"] for s in got["slo"]} >= {"ok"}
    (_, port_mon), _ = monitors
    assert PORT_TUNE in port_mon.drift.report().command


def test_drift_command_names_the_ports_tune_cli():
    """The one string that differs from the reference: the retune
    command names ``python -m repro_torch.tune``."""
    for mod in (drift, ref_drift):
        det = mod.DriftDetector(band=2.0, min_count=1, token_fn=lambda: "t")
        det.observe("tile", "r", 1e-4)
        det.observe("msa", "r", 1e-4)
        rep = det.report()
        assert rep.families == ("row", "tile")
        want = PORT_TUNE if mod is drift else REF_TUNE
        assert rep.command == (f"re-run `{want} --only row,tile` (cost "
                               f"table t)")


class _Duck:
    """The engine surface the exposition reads: a metrics snapshot, the
    queue depth, the stop flag and an optional monitor."""

    def __init__(self, snapshot, monitor):
        self.metrics = SimpleNamespace(snapshot=lambda: dict(snapshot))
        self.monitor = monitor
        self._stop = False

    def _pending(self):
        return 3


def _spans(seed=5):
    """Span records of a served stream, counter tracks included."""
    recs = [r for _, r in _stream(seed, n=120)]
    recs.append({"name": "serve.exec", "dur": -1.0})      # clamped to 0
    return recs


@pytest.mark.parametrize("case", ["spans", "engine", "engine+monitor"])
def test_render_prometheus_equals_reference(case):
    """One set of span records (and one engine state): the exposition's
    lines equal the reference's, the process cache registry aside (each
    package registers its own caches)."""
    recs = _spans()
    snap = QueryEngine(device=CPU).metrics.snapshot()
    texts = []
    for mod_obs, mod_expo, mod_health, mod_drift, clock_cls in (
            (obs, exposition, health, drift, VirtualClock),
            (ref_obs, ref_exposition, ref_health, ref_drift,
             RefVirtualClock)):
        sink = mod_obs.InMemorySink(capacity=1024)
        for r in recs:
            sink.emit(r)
        engine = None
        if case != "spans":
            mon = None
            if case == "engine+monitor":
                mon = mod_health.HealthMonitor(
                    clock=clock_cls(), drift=mod_drift.DriftDetector(
                        band=2.0, min_count=2, token_fn=lambda: "t"))
                for r in recs:
                    mon.emit(r)
            engine = _Duck(snap, mon)
        texts.append(mod_expo.render_prometheus(
            engine, tracer=mod_obs.Tracer(sink)))

    def lines(text):
        return [x for x in text.splitlines() if "repro_cache_" not in x]

    got, want = texts
    assert lines(got) == lines(want)
    hist = [x for x in lines(got) if "repro_span_duration_seconds" in x]
    assert len(hist) >= 5 * 14                  # 5 phases, 14 lines each
    assert ("repro_slo_burn_rate" in got) == (case == "engine+monitor")
    assert ("repro_serve_completed_total" in got) == (case != "spans")
    assert exposition.parse_prometheus(got)
    assert exposition.HISTOGRAM_BUCKETS == ref_exposition.HISTOGRAM_BUCKETS


def test_golden_trace_under_a_monitor_equals_reference(builtin_tables):
    """Both engines replay the golden trace with a monitor each: the
    same verdict, ``repro_serve_*_total`` counters, SLO event counts and
    drift keys with their counts.  Durations are timings of two runtimes
    (a cold first tile bucket takes over a second on some CPUs), so the
    verdict is held on what the trace determines: the error-rate
    objective, and a drift band no timing reaches."""
    from repro import caches as ref_caches
    from repro.core import planner as rp
    from repro_torch import caches
    trace = Trace.load(golden_trace_path())
    from repro.serving.trace import Trace as RefTrace
    ref_trace = RefTrace.load(golden_trace_path())
    views = []
    for mod_obs, mod_health, mod_drift, mod_slo, mod_expo, run in (
            (obs, health, drift, slo, exposition,
             lambda k: replay_trace(trace, knobs=k, device=CPU)),
            (ref_obs, ref_health, ref_drift, ref_slo, ref_exposition,
             lambda k: ref_replay_trace(ref_trace, knobs=k))):
        planner.clear_plan_cache()
        rp.clear_plan_cache()
        caches.clear_all()
        ref_caches.clear_all()
        mon = mod_health.HealthMonitor(
            slos=[o for o in mod_slo.DEFAULT_SLOS
                  if o.metric == "error_rate"],
            drift=mod_drift.DriftDetector(band=1e9))
        with mod_obs.tracing(mon):
            rep = run({"monitor": mon})
        text = mod_expo.render_prometheus(_Duck(rep.snapshot, mon),
                                          tracer=None)
        samples = mod_expo.parse_prometheus(text)
        views.append({
            "digest_counters": rep.counters,
            "verdict": mon.verdict().as_dict(),
            "totals": {k: v for k, v in samples.items()
                       if k[0].startswith("repro_serve_")
                       and k[0].endswith("_total")},
            "health": samples[("repro_health_status", ())],
            "slo_events": [st.events_long for st in mon.slo_status()],
            "drift": {k: v["count"]
                      for k, v in mon.drift.snapshot().items()},
            "token": mon.drift.token,
        })
    got, want = views
    assert got == want
    assert got["totals"][("repro_serve_completed_total", ())] > 0
    assert got["drift"] and got["verdict"]["status"] == "ok"


# ---------------------------------------------------------------------------
# parity: the trajectory report
# ---------------------------------------------------------------------------


def _gens(gens):
    return [(g.label, g.payload, g.error, g.readable) for g in gens]


def _report_view(mod, bench, **kw):
    rep = mod.build_report(str(bench), **kw)
    return ({name: _gens(g) for name, g in rep["grids"].items()},
            rep["regressions"], mod.render_console(rep),
            mod.render_console(rep, max_rows=2), mod.render_html(rep))


def test_report_on_committed_grids_equals_reference():
    bench = REPO / "results" / "bench"
    got = _report_view(report, bench)
    assert got == _report_view(ref_report, bench)
    grids, _, console, short, html = got
    assert len(grids) >= 8 and "obs_overhead" in console
    assert "<svg" in html


def _git(args, cwd):
    return subprocess.run(["git", *args], cwd=str(cwd),
                          capture_output=True, text=True)


@pytest.fixture
def grid_repo(tmp_path):
    repo = tmp_path / "repo"
    bench = repo / "results" / "bench"
    bench.mkdir(parents=True)
    assert _git(["init", "-q"], repo).returncode == 0
    _git(["config", "user.email", "t@example.com"], repo)
    _git(["config", "user.name", "t"], repo)

    def commit(payload, msg="gen"):
        text = (payload if isinstance(payload, str)
                else json.dumps(payload))
        (bench / "unit_grid.json").write_text(text)
        _git(["add", "-A"], repo)
        assert _git(["commit", "-qm", msg], repo).returncode == 0

    return repo, bench, commit


@pytest.mark.parametrize("case", ["trend", "regression", "unreadable",
                                  "bad-flag", "dirty", "no-git"])
def test_report_cases_equal_reference(case, grid_repo, tmp_path):
    """The reference's ``grid_repo`` cases through both packages: equal
    generations, regression flags, console and HTML, and ``--check``
    exit codes; then what each case must show."""
    repo, bench, commit = grid_repo
    if case == "trend":
        commit({"perf": {"qps": 100.0}, "_ok": True}, "gen1")
        commit({"perf": {"qps": 150.0}, "_ok": True}, "gen2")
    elif case == "regression":
        commit({"qps": 100.0, "_ok": True}, "good")
        commit({"qps": 90.0, "_ok": False}, "bad")
    elif case == "unreadable":
        commit({"qps": 1.0, "_ok": True}, "good")
        commit("{not json", "broken")
    elif case == "bad-flag":
        commit({"qps": 1.0, "_ok": True}, "good")
        commit({"qps": 1.0, "_ok": "yes"}, "bad-schema")
    elif case == "dirty":
        commit({"qps": 1.0}, "gen1")
        (bench / "unit_grid.json").write_text(json.dumps({"qps": 2.0}))
    else:
        bench = tmp_path / "solo"
        bench.mkdir()
        (bench / "solo_grid.json").write_text(json.dumps({"x": 1.0}))
    got = _report_view(report, bench)
    assert got == _report_view(ref_report, bench)
    rc = report.main(["--dir", str(bench), "--check"])
    assert rc == ref_report.main(["--dir", str(bench), "--check"])
    grids, regressions, console = got[0], got[1], got[2]
    (gens,) = grids.values()
    expect = {
        "trend": (0, [True, True], "no regressions"),
        "regression": (1, [True, True], "_ok regressed True->False"),
        "unreadable": (1, [True, False], "unreadable"),
        "bad-flag": (1, [True, False], "must be a bool"),
        "dirty": (0, [True, True], "no regressions"),
        "no-git": (0, [True], "no regressions"),
    }[case]
    assert rc == expect[0]
    assert [g[3] for g in gens] == expect[1]
    assert expect[2] in console
    if case == "dirty":
        assert gens[-1][0] == "worktree"
    if case == "no-git":
        assert [g[0] for g in gens] == ["worktree"]


def test_report_main_writes_html_like_reference(grid_repo, tmp_path):
    repo, bench, commit = grid_repo
    commit({"perf": {"qps": 100.0}, "_ok": True}, "gen1")
    commit({"perf": {"qps": 150.0}, "_ok": True}, "gen2")
    a, b = tmp_path / "port.html", tmp_path / "ref.html"
    assert report.main(["--dir", str(bench), "--html", str(a)]) == 0
    assert ref_report.main(["--dir", str(bench), "--html", str(b)]) == 0
    assert a.read_text() == b.read_text()
    assert "perf.qps" in a.read_text() and "<svg" in a.read_text()
    # an empty bench dir: nothing to render, a failure only under --check
    empty = tmp_path / "empty"
    empty.mkdir()
    assert report.main(["--dir", str(empty)]) == 0
    assert report.main(["--dir", str(empty), "--check"]) == 1


def test_sparkline_and_formatting_helpers_equal_reference():
    series = ([], [1.0, 1.0], [0.0, 0.5, 1.0], [0.0, float("nan"), 1.0],
              [3.0, 1.0, 2.0, 8.0])
    for xs in series:
        assert report.sparkline(xs) == ref_report.sparkline(xs)
        assert report._delta(xs) == ref_report._delta(xs)
        assert report._svg_spark(xs) == ref_report._svg_spark(xs)
    for v in (0.0, 1e-4, 2.5, 7.0, 123456.0, float("nan"), -3.25):
        assert report._fmt_val(v) == ref_report._fmt_val(v)
    assert report.sparkline([0.0, 0.5, 1.0]) == "▁▄█"
    payload = {"a": {"b": 2}, "_flag": True, "_cache_info": {"x": {"y": 1}},
               "s": "str", "_bad": False, "n": 1}
    assert report.flatten_metrics(payload) == \
        ref_report.flatten_metrics(payload) == {"a.b": 2.0, "n": 1.0}
    assert report.grid_flags(payload) == {"_bad": False, "_flag": True}


# ---------------------------------------------------------------------------
# WindowAggregator: ring shards on the injectable clock
# ---------------------------------------------------------------------------


def test_aggregator_windows_follow_virtual_clock():
    clk = VirtualClock()
    agg = WindowAggregator(clock=clk, horizon_s=60.0, shards=12)
    clk.advance(1.0)
    for _ in range(10):
        agg.emit({"name": "serve.error"})
        agg.emit(_exec())
    assert agg.window(60).count("serve.error") == 10
    assert agg.window(60).req_count("serve.exec") == 10
    assert agg.window(60).dur_sum("serve.exec") == pytest.approx(0.1)
    clk.advance(10.0)
    assert agg.window(5).count("serve.error") == 0
    assert agg.window(60).count("serve.error") == 10
    clk.advance(120.0)
    assert agg.window(60).count("serve.error") == 0


def test_aggregator_ring_reuses_shards_in_place():
    clk = VirtualClock()
    agg = WindowAggregator(clock=clk, horizon_s=12.0, shards=4)
    for _ in range(50):
        agg.emit(_exec())
        clk.advance(3.0)
    assert len(agg._ring) == 4
    assert agg.window(12).count("serve.exec") <= 4


def test_aggregator_bounds_percentile_samples():
    clk = VirtualClock()
    agg = WindowAggregator(clock=clk, horizon_s=60.0, shards=12,
                           sample_cap=4)
    for i in range(10):
        agg.emit(_exec(dur=i * 0.01))
    w = agg.window(60)
    assert w.count("serve.exec") == 10
    assert len(w.samples("serve.exec")) == 4
    assert w.percentile("serve.exec", 0.99) <= 0.03


def test_aggregator_gauges_latest_wins():
    clk = VirtualClock()
    agg = WindowAggregator(clock=clk, horizon_s=60.0, shards=12)
    agg.emit({"name": "serve.queue_depth", "counter": 3.0})
    agg.emit({"name": "serve.queue_depth", "counter": 7.0})
    assert agg.window(60).gauge("serve.queue_depth") == 7.0
    clk.advance(6.0)
    agg.emit({"name": "serve.queue_depth", "counter": 1.0})
    assert agg.window(60).gauge("serve.queue_depth") == 1.0
    assert agg.window(60).gauge("missing") is None


@pytest.mark.parametrize("kw", [{"horizon_s": 0}, {"shards": 1}])
def test_aggregator_validates_construction(kw):
    with pytest.raises(ValueError):
        WindowAggregator(clock=VirtualClock(), **kw)
    with pytest.raises(ValueError):
        ref_health.WindowAggregator(clock=RefVirtualClock(), **kw)


def test_aggregator_defaults_to_the_ports_system_clock():
    from repro_torch.serving.clock import SystemClock
    agg = WindowAggregator()
    assert isinstance(agg.clock, SystemClock)
    agg.emit(_exec())
    assert agg.window(60).count("serve.exec") == 1


# ---------------------------------------------------------------------------
# SLO engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric, bound, budget", [
    ("latency_p99", 0.25, 0.01), ("error_rate", 0.02, 0.02),
    ("cache_hit_rate", 0.9, 0.1), ("queue_wait_share", 0.5, 0.5)])
def test_objective_derives_budgets(metric, bound, budget):
    o = Objective("x", metric, bound=bound)
    assert o.budget == pytest.approx(budget)
    assert o.budget == ref_slo.Objective("x", metric, bound=bound).budget


@pytest.mark.parametrize("make, match", [
    (lambda m: m.Objective("x", "nope", bound=1.0), "unknown SLO metric"),
    (lambda m: m.Objective("x", "error_rate", bound=0.01, budget=2.0),
     "budget"),
    (lambda m: m.Objective("x", "error_rate", bound=0.01, short_s=90,
                           long_s=60), "short_s"),
    (lambda m: m.SLOEngine([m.Objective("a", "error_rate", bound=0.1)] * 2),
     "duplicate")])
def test_objective_and_engine_reject_bad_construction(make, match):
    for mod in (slo, ref_slo):
        with pytest.raises(ValueError, match=match):
            make(mod)


def test_default_slos_equal_reference():
    assert [dataclasses.asdict(o) for o in DEFAULT_SLOS] == \
        [dataclasses.asdict(o) for o in ref_slo.DEFAULT_SLOS]
    assert slo.METRICS == ref_slo.METRICS


def _err_objective(**kw):
    kw.setdefault("min_events", 1)
    return Objective("err", "error_rate", bound=0.25, short_s=5.0,
                     long_s=60.0, **kw)


def test_slo_failing_needs_both_windows_degraded_only_long():
    clk = VirtualClock()
    agg = WindowAggregator(clock=clk, horizon_s=60.0, shards=12)
    eng = SLOEngine([_err_objective()])
    clk.advance(1.0)
    for _ in range(10):
        agg.emit({"name": "serve.error"})
        agg.emit(_exec())
    (st,) = eng.evaluate(agg)
    assert st.status == "failing" and "err" in st.reason
    assert st.burn_long == pytest.approx(2.0)
    clk.advance(10.0)
    (st,) = eng.evaluate(agg)
    assert st.status == "degraded" and st.burn_short == 0.0
    assert st.burn_long == pytest.approx(2.0)
    clk.advance(120.0)
    (st,) = eng.evaluate(agg)
    assert st.status == "ok" and st.reason == ""


def test_slo_idle_and_sparse_windows_stay_ok():
    clk = VirtualClock()
    agg = WindowAggregator(clock=clk, horizon_s=60.0, shards=12)
    eng = SLOEngine(DEFAULT_SLOS)
    assert all(st.status == "ok" for st in eng.evaluate(agg))
    agg.emit({"name": "serve.error"})
    assert all(st.status == "ok" for st in eng.evaluate(agg))


def test_slo_latency_p99_counts_over_bound_samples():
    clk = VirtualClock()
    agg = WindowAggregator(clock=clk, horizon_s=60.0, shards=12)
    eng = SLOEngine([Objective("lat", "latency_p99", bound=0.1, budget=0.1,
                               min_events=1)])
    for _ in range(8):
        agg.emit(_exec(dur=0.01))
    (st,) = eng.evaluate(agg)
    assert st.status == "ok" and st.burn_long == 0.0
    for _ in range(8):
        agg.emit(_exec(dur=0.5))
    (st,) = eng.evaluate(agg)
    assert st.burn_long == pytest.approx(5.0)
    assert st.status == "failing"


def test_slo_queue_wait_share_and_hit_rate():
    clk = VirtualClock()
    agg = WindowAggregator(clock=clk, horizon_s=60.0, shards=12)
    for _ in range(4):
        agg.emit({"name": "serve.queue_wait", "dur": 0.9})
        agg.emit(_exec(dur=0.1))
        agg.emit({"name": "serve.submit", "dur": 0.0})
    qw = Objective("qw", "queue_wait_share", bound=0.4, min_events=1)
    (st,) = SLOEngine([qw]).evaluate(agg)
    assert st.burn_long == pytest.approx(0.9 / 0.4)
    assert st.status == "failing"
    hit = Objective("hits", "cache_hit_rate", bound=0.5, min_events=1)
    (st,) = SLOEngine([hit]).evaluate(agg)
    assert st.burn_long == pytest.approx(2.0)
    assert st.status == "failing"


def test_health_verdict_worst_of_merges_reasons():
    a = HealthVerdict("ok")
    b = HealthVerdict("degraded", ("slow",))
    c = HealthVerdict("failing", ("down", "slow"))
    worst = HealthVerdict.worst(a, b, c)
    assert worst.status == "failing" and not worst.ok
    assert worst.reasons == ("slow", "down")
    assert HealthVerdict.worst().status == "ok"
    assert b.as_dict() == {"status": "degraded", "reasons": ["slow"]}


# ---------------------------------------------------------------------------
# HealthMonitor
# ---------------------------------------------------------------------------


def test_monitor_tees_to_inner_sink_and_exposes_spans():
    clk = VirtualClock()
    inner = obs.InMemorySink(capacity=64)
    mon = HealthMonitor(clock=clk, inner=inner, drift=None)
    with obs.tracing(mon):
        obs.event("serve.exec", dur_s=0.01, size=1)
        obs.counter("serve.queue_depth", 2)
    assert len(mon.spans()) == 2
    assert mon.aggregator.window(60).count("serve.exec") == 1
    assert mon.aggregator.window(60).gauge("serve.queue_depth") == 2.0
    assert HealthMonitor(clock=clk).spans() == []
    assert isinstance(HealthMonitor(clock=clk).drift, DriftDetector)


def test_monitor_verdict_folds_liveness_and_slos():
    clk = VirtualClock()
    mon = HealthMonitor(clock=clk, drift=None, slos=[_err_objective()])
    assert mon.verdict().status == "ok"
    clk.advance(1.0)
    for _ in range(10):
        mon.emit({"name": "serve.error"})
        mon.emit(_exec())
    v = mon.verdict()
    assert v.status == "failing" and any("err" in r for r in v.reasons)
    eng = QueryEngine(device=CPU)
    eng.close()
    v = HealthMonitor(clock=VirtualClock(), drift=None).verdict(engine=eng)
    assert v.status == "failing" and "engine stopped" in v.reasons
    assert basic_verdict(eng).status == "failing"


def test_monitor_drift_degrades_never_fails():
    clk = VirtualClock()
    det = DriftDetector(band=2.0, min_count=2, token_fn=lambda: "t")
    mon = HealthMonitor(clock=clk, drift=det)
    for _ in range(3):
        mon.emit(_exec(dur=1e-4, algorithm="tile", route="tile",
                       regime="r", modeled_ms=100.0))
    v = mon.verdict()
    assert v.status == "degraded"
    assert any("cost-model drift" in r for r in v.reasons)
    assert any(f"{PORT_TUNE} --only tile" in r for r in v.reasons)


def test_engine_health_without_monitor_is_liveness_only():
    with QueryEngine(device=CPU) as eng:
        assert eng.monitor is None and eng.obs_server is None
        assert eng.health().status == "ok"
    assert eng.health().status == "failing"


# ---------------------------------------------------------------------------
# drift detector
# ---------------------------------------------------------------------------


def test_drift_flags_warped_model_quiet_when_calibrated():
    det = DriftDetector(band=4.0, min_count=8, token_fn=lambda: "tok")
    for _ in range(20):
        det.observe("msa", "r1", 1.2)
    assert det.flags() == []
    for _ in range(20):
        det.observe("hash", "r1", 1 / 64)
    (flag,) = det.flags()
    assert flag.algorithm == "hash" and flag.family == "row"
    assert flag.ewma_residual == pytest.approx(1 / 64, rel=0.05)
    assert "modeled >> measured" in flag.reason
    rep = det.report()
    assert rep.families == ("row",)
    assert f"{PORT_TUNE} --only row" in rep.command
    assert rep.token == "tok"
    assert det.snapshot()["row/hash/r1"]["count"] == 20


def test_drift_needs_min_count_before_flagging():
    det = DriftDetector(band=2.0, min_count=8, token_fn=lambda: "t")
    for _ in range(7):
        det.observe("msa", "r", 100.0)
    assert det.flags() == []
    det.observe("msa", "r", 100.0)
    (flag,) = det.flags()
    assert "measured >> modeled" in flag.reason
    assert det.report().command


def test_drift_resets_on_cost_model_token_change():
    tok = ["t1"]
    det = DriftDetector(band=2.0, min_count=4, token_fn=lambda: tok[0])
    for _ in range(10):
        det.observe("msa", "r", 100.0)
    assert det.flags() and det.token == "t1"
    tok[0] = "t2"
    det.observe("msa", "r", 1.0)
    assert det.token == "t2" and det.flags() == []
    assert det.snapshot()["row/msa/r"]["count"] == 1


def test_drift_default_token_follows_the_ports_planner(builtin_tables):
    """The default detector reads ``repro_torch.core.planner``'s token:
    activating a profile changes it and resets the statistics."""
    det = DriftDetector(band=2.0, min_count=1)
    det.observe("msa", "r", 1.0)
    assert det.token == planner.cost_model_token() == BUILTIN_TOKEN
    tuning.activate(_warped(256.0))
    det.observe("msa", "r", 1.0)
    assert det.token == planner.cost_model_token() != BUILTIN_TOKEN
    assert det.snapshot()["row/msa/r"]["count"] == 1


def test_drift_observe_record_normalizes_by_size_skips_burst():
    det = DriftDetector(band=2.0, min_count=1, token_fn=lambda: "t")
    det.observe_record({"name": "serve.exec", "dur": 8e-3,
                        "attrs": {"modeled_ms": 1.0, "size": 8,
                                  "algorithm": "msa", "route": "batched",
                                  "regime": "r"}})
    st = det.snapshot()["row/msa/r"]
    assert st["count"] == 1
    assert st["ewma_residual"] == pytest.approx(1.0)
    det.observe_record({"name": "serve.exec", "dur": 1.0,
                        "attrs": {"modeled_ms": 1.0, "size": 1,
                                  "algorithm": "msa", "route": "burst",
                                  "regime": "r"}})
    assert det.snapshot()["row/msa/r"]["count"] == 1
    det.observe_record({"name": "serve.submit"})
    det.observe_record({"name": "serve.exec", "counter": 1.0})
    assert det.ingest(None) == 0
    assert det.ingest([_exec()]) == 0
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        det.observe("msa", "r", bad)
    assert det.snapshot()["row/msa/r"]["count"] == 1


def test_drift_welford_matches_batch_statistics():
    vals = [0.5, 1.0, 2.0, 4.0, 8.0]
    st, ref_st = KernelStats(), ref_drift.KernelStats()
    for v in vals:
        st.update(math.log(v))
        ref_st.update(math.log(v))
    mean = sum(math.log(v) for v in vals) / len(vals)
    var = (sum((math.log(v) - mean) ** 2 for v in vals) / (len(vals) - 1))
    assert st.mean == pytest.approx(mean)
    assert st.variance == pytest.approx(var)
    assert st.mean_residual == pytest.approx(math.exp(mean))
    assert (st.mean, st.variance, st.ewma) == \
        (ref_st.mean, ref_st.variance, ref_st.ewma)


@pytest.mark.parametrize("algorithm, family", [
    ("msa", "row"), ("hash", "row"), ("heapdot", "row"), ("inner", "row"),
    ("tile", "tile"), ("block", "tile"), ("spsumma", "dist"),
    ("distributed", "dist"), (None, "row"), ("unknown", "row")])
def test_family_mapping_covers_kernels(algorithm, family):
    assert family_of(algorithm) == family == ref_drift.family_of(algorithm)


def test_drift_rejects_a_band_of_one():
    with pytest.raises(ValueError):
        DriftDetector(band=1.0)


def test_engine_drift_residuals_equal_export_and_flag_when_warped(
        builtin_tables):
    """A monitored CPU engine (one query a bucket, no burst, no result
    cache) on row and tile structures: the detector's per-key statistics
    equal those rebuilt from the captured spans by ``export.residuals``;
    tile queries count under family ``tile``; under every constant x256
    both families flag and the report names the port's tune CLI."""
    row = _operands(n=96, seed=3)
    tile = tuple(csr_from_dense(x) for x in (
        block_sparse(128, 8, 0.4, 0.9, seed=1),
        block_sparse(128, 8, 0.4, 0.9, seed=2),
        block_sparse(128, 8, 0.6, 1.0, seed=3, mask=True)))

    def rebuilt(spans):
        stats = {}
        for r in export.residuals(spans):
            if r["route"] == "burst":
                continue
            key = (family_of(r["algorithm"]), str(r["algorithm"]),
                   str(r["regime"] or "-"))
            stats.setdefault(key, KernelStats()).update(
                math.log(r["residual"]))
        return {k: (v.count, v.mean, v.ewma) for k, v in stats.items()}

    det = DriftDetector(band=8.0, min_count=4)
    for warp in (1.0, 1e6):
        tuning.activate(_warped(warp))
        inner = obs.InMemorySink(capacity=4096)
        mon = HealthMonitor(drift=det, inner=inner)
        with QueryEngine(max_batch=1, use_burst=False, cache_results=False,
                         monitor=mon, device=CPU) as eng:
            with obs.tracing(mon):
                for q in range(6):
                    eng.serve([row, tile])
        got = {k: (v.count, v.mean, v.ewma) for k, v in det.stats().items()}
        assert got == rebuilt(inner.spans())
        assert {k[0] for k in got} == {"row", "tile"}
        assert all(c == 6 for c, _, _ in got.values())      # reset by token
    warped = det.report()
    assert warped.families == ("row", "tile")
    assert all("modeled >> measured" in f.reason for f in warped.flags)
    assert f"{PORT_TUNE} --only row,tile" in warped.command


# ---------------------------------------------------------------------------
# engine + HTTP: verdicts on the wire
# ---------------------------------------------------------------------------


def test_induced_pressure_flips_health_to_503_with_reasons():
    A, B, M = _operands(seed=61)
    mon = HealthMonitor(drift=None)
    with QueryEngine(monitor=mon, expose_port=0, device=CPU) as eng:
        base = eng.obs_server.url
        with obs.tracing(mon):
            eng.serve([(A, B, M)] * 4)
            code, body = _get(f"{base}/health")
            healthy = json.loads(body)
            assert code == 200 and healthy["status"] == "ok"
            assert healthy["reasons"] == [] and healthy["stopped"] is False
            bad = [eng.submit(A, B, M, algorithm="hash", complement=True)
                   for _ in range(16)]
            eng.flush()
            for t in bad:
                with pytest.raises(NotImplementedError):
                    t.result()
            assert eng.health().status == "failing"
            code, body = _get(f"{base}/health")
            assert code == 503
            payload = json.loads(body)
            assert payload["status"] == "failing"
            assert any("serve-errors" in r for r in payload["reasons"])
            assert payload["failed"] == 16 and payload["queue_depth"] == 0
            samples = obs.parse_prometheus(_get(f"{base}/metrics")[1])
    assert samples[("repro_health_status", ())] == 2.0
    for window in ("short", "long"):
        assert samples[("repro_slo_burn_rate", (("slo", "serve-errors"),
                                                ("window", window)))] > 2.0
    assert samples[("repro_slo_healthy", (("slo", "serve-errors"),))] == 0.0
    assert samples[("repro_serve_failed_total", ())] == 16.0


def test_metrics_exposition_gains_slo_and_drift_families():
    A, B, M = _operands(seed=71)
    mon = HealthMonitor()
    mon.drift._token_fn = lambda: "tok"
    for _ in range(10):
        mon.drift.observe("msa", "r1", 1 / 64)
    with QueryEngine(monitor=mon, expose_port=0, device=CPU) as eng:
        with obs.tracing(mon):
            eng.serve([(A, B, M)] * 2)
        code, text = _get(f"{eng.obs_server.url}/metrics")
    assert code == 200
    samples = obs.parse_prometheus(text)
    assert samples[("repro_slo_burn_rate",
                    (("slo", "serve-errors"), ("window", "long")))] == 0.0
    assert samples[("repro_slo_healthy",
                    (("slo", "serve-latency-p99"),))] == 1.0
    assert samples[("repro_health_status", ())] == 1.0       # drift degrades
    labels = (("algorithm", "msa"), ("family", "row"), ("regime", "r1"))
    assert samples[("repro_drift_observations", labels)] == 10.0
    assert samples[("repro_drift_flagged", labels)] == 1.0
    assert samples[("repro_drift_flagged_families", ())] == 1.0
    assert samples[("repro_drift_ewma_residual", labels)] == \
        pytest.approx(1 / 64, rel=0.05)


def test_render_prometheus_without_monitor_has_no_slo_families():
    with QueryEngine(device=CPU) as eng:
        text = obs.render_prometheus(eng)
    assert "repro_slo_" not in text and "repro_drift_" not in text
    assert "repro_health_status" not in text
    assert ("repro_serve_queue_depth", ()) in obs.parse_prometheus(text)


def test_engine_close_shuts_the_server_first():
    eng = QueryEngine(expose_port=0, monitor=HealthMonitor(), device=CPU)
    url = eng.obs_server.url
    assert _get(f"{url}/health")[0] == 200
    assert _get(f"{url}/nope")[0] == 404
    eng.close()
    assert eng.obs_server is None and eng.health().status == "failing"
    with pytest.raises(Exception):
        urllib.request.urlopen(f"{url}/health", timeout=2)


def test_metrics_scrape_while_async_engine_serves():
    """The HTTP threads render /metrics and /health while the async
    worker serves: every scrape parses and answers 200, and the counters
    a scrape reads never run backwards."""
    structs = [_operands(n=96, seed=s) for s in (0, 3)]
    rng = np.random.default_rng(0)
    stream = [structs[int(rng.integers(2))] for _ in range(48)]
    mon = HealthMonitor(inner=obs.InMemorySink(capacity=8192))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    seen, errors = [], []
    try:
        with QueryEngine(async_mode=True, max_batch=4, max_wait_ms=1.0,
                         cache_results=False, monitor=mon, expose_port=0,
                         device=CPU) as eng:
            base = eng.obs_server.url
            with obs.tracing(mon):
                done = threading.Event()

                def submit():
                    try:
                        tickets = [eng.submit(*q) for q in stream]
                        for t in tickets:
                            t.result(timeout=60)
                    except Exception as e:     # reported below
                        errors.append(e)
                    finally:
                        done.set()

                th = threading.Thread(target=submit)
                th.start()
                while not done.is_set() or len(seen) < 4:
                    code, text = _get(f"{base}/metrics")
                    assert code == 200
                    samples = obs.parse_prometheus(text)
                    seen.append(
                        samples[("repro_serve_completed_total", ())])
                    hcode, body = _get(f"{base}/health")
                    assert hcode == 200
                    assert json.loads(body)["async_mode"] is True
                th.join(timeout=60)
                assert not th.is_alive()
                final = obs.parse_prometheus(_get(f"{base}/metrics")[1])
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    assert seen == sorted(seen) and len(seen) >= 4
    assert final[("repro_serve_completed_total", ())] == len(stream)
    assert final[("repro_span_duration_seconds_count",
                  (("phase", "serve.exec"),))] == len(
        [r for r in mon.spans() if r["name"] == "serve.exec"]) > 0


def test_serve_demo_on_the_cpu_answers_and_has_no_cpu_fallback(tmp_path):
    """``python -m repro_torch.obs.serve --device cpu`` serves its demo and
    exposes /health until interrupted; without ``--device`` it asks for
    CUDA and fails where there is none, instead of falling back."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    cmd = [sys.executable, "-m", "repro_torch.obs.serve", "--port", "0",
           "--queries", "4", "--n", "64"]
    proc = subprocess.Popen(cmd + ["--device", "cpu"], cwd=tmp_path,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "metrics at http://" in line, proc.stderr.read()
        url = line.split("metrics at ")[1].split("/metrics")[0]
        code, body = _get(f"{url}/health")
        assert code == 200 and json.loads(body)["completed"] == 4
        assert "repro_span_duration_seconds" in _get(f"{url}/metrics")[1]
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0
    import torch
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0 and "metrics at" not in out.stdout
