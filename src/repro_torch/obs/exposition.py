"""Prometheus text exposition for the serving stack.

``render_prometheus`` flattens these sources into the text format every
Prometheus-compatible scraper ingests (version 0.0.4):

* ``ServeMetrics.snapshot()`` — counters and latency percentiles as
  ``repro_serve_*`` gauges/counters;
* ``repro_torch.caches.cache_info()`` — the process cache registry as
  ``repro_cache_*{cache="..."}`` families;
* the active tracer's in-memory span ring — per-phase duration
  histograms (``repro_span_duration_seconds{phase="serve.exec"}``) with
  cumulative buckets, ``_sum`` and ``_count`` (counter-track records
  are skipped: they have no duration);
* the engine's :class:`repro_torch.obs.health.HealthMonitor`, when attached —
  ``repro_slo_*`` burn-rate gauges per objective and window,
  ``repro_drift_*`` residual gauges per (family, kernel, regime), and
  the scalar ``repro_health_status`` (0=ok 1=degraded 2=failing).

The family names and histogram buckets are the reference package's, so
one scraper reads both.  Every source is host state (counters, floats,
span records): rendering from the HTTP thread never touches a device
tensor while the serving worker launches kernels.

``parse_prometheus`` is the matching reader the tests and
``chip_smoke.py`` use to assert the exposition round-trips.  The round
trip is lossless, including non-finite values (``+Inf`` buckets, NaN
quantiles from empty reservoirs) and escaped label values.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

__all__ = ["parse_prometheus", "render_prometheus", "HISTOGRAM_BUCKETS"]

#: cumulative upper bounds (seconds) for span-duration histograms —
#: microseconds through ~16s, the serving stack's realistic span range
HISTOGRAM_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 4e-3, 1.6e-2, 6.4e-2,
                     0.25, 1.0, 4.0, 16.0)


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isnan(f):
        return "NaN"                  # Prometheus spelling, not repr's "nan"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _unescape(v: str) -> str:
    """Inverse of :func:`_escape` (``\\\\``, ``\\"``, ``\\n``); unknown
    escapes pass through verbatim, matching Prometheus readers."""
    out: List[str] = []
    i = 0
    while i < len(v):
        ch = v[i]
        if ch == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ('"', "\\"):
                out.append(nxt)
                i += 2
                continue
        out.append(ch)
        i += 1
    return "".join(out)


class _Writer:
    def __init__(self):
        self.lines: List[str] = []
        self._typed = set()

    def sample(self, name: str, value, labels: Optional[Dict] = None,
               *, kind: str = "gauge", help_text: str = "") -> None:
        if name not in self._typed:
            self._typed.add(name)
            if help_text:
                self.lines.append(f"# HELP {name} {help_text}")
            self.lines.append(f"# TYPE {name} {kind}")
        lab = ""
        if labels:
            inner = ",".join(f'{k}="{_escape(v)}"'
                             for k, v in sorted(labels.items()))
            lab = "{" + inner + "}"
        self.lines.append(f"{name}{lab} {_fmt(value)}")

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


def _serve_section(w: _Writer, engine) -> None:
    snap = engine.metrics.snapshot()
    counters = {"submitted", "completed", "failed", "result_cache_hits",
                "buckets_executed", "batched_requests", "merged_groups",
                "delta_applied", "plans_revalidated", "lanes_patched",
                "rows_invalidated"}
    for key, val in snap.items():
        if not isinstance(val, (int, float)):
            continue
        if key in counters:
            w.sample(f"repro_serve_{key}_total", val, kind="counter",
                     help_text=f"ServeMetrics.{key}")
        else:
            w.sample(f"repro_serve_{key}", val,
                     help_text=f"ServeMetrics snapshot {key}")
    w.sample("repro_serve_queue_depth", engine._pending(),
             help_text="Requests admitted but not yet served")


def _cache_section(w: _Writer) -> None:
    from repro_torch import caches
    for name, info in sorted(caches.cache_info().items()):
        labels = {"cache": name}
        w.sample("repro_cache_size", info.get("size", 0), labels,
                 help_text="Entries currently held")
        w.sample("repro_cache_capacity", info.get("capacity", 0), labels,
                 help_text="Configured LRU capacity")
        w.sample("repro_cache_hits_total", info.get("hits", 0), labels,
                 kind="counter", help_text="Registry cache hits")
        w.sample("repro_cache_misses_total", info.get("misses", 0), labels,
                 kind="counter", help_text="Registry cache misses")


def _span_section(w: _Writer, tracer) -> None:
    spans_fn = getattr(tracer.sink, "spans", None)
    if not callable(spans_fn):
        return
    per_phase: Dict[str, List[float]] = {}
    for rec in spans_fn():
        if "counter" in rec:       # counter tracks have no duration
            continue
        per_phase.setdefault(rec.get("name", "?"), []).append(
            max(rec.get("dur", 0.0), 0.0))
    name = "repro_span_duration_seconds"
    for phase, durs in sorted(per_phase.items()):
        for le in HISTOGRAM_BUCKETS:
            count = sum(1 for d in durs if d <= le)
            w.sample(f"{name}_bucket", count,
                     {"phase": phase, "le": repr(le)}, kind="histogram",
                     help_text="Span durations by phase (ring window)")
        w.sample(f"{name}_bucket", len(durs),
                 {"phase": phase, "le": "+Inf"}, kind="histogram")
        w.sample(f"{name}_sum", sum(durs), {"phase": phase},
                 kind="histogram")
        w.sample(f"{name}_count", len(durs), {"phase": phase},
                 kind="histogram")


_STATUS_CODE = {"ok": 0.0, "degraded": 1.0, "failing": 2.0}


def _slo_section(w: _Writer, engine) -> None:
    mon = getattr(engine, "monitor", None)
    if mon is None:
        return
    for st in mon.slo_status():
        labels = {"slo": st.objective.name}
        w.sample("repro_slo_burn_rate", st.burn_short,
                 {**labels, "window": "short"},
                 help_text="Error-budget burn rate per objective/window")
        w.sample("repro_slo_burn_rate", st.burn_long,
                 {**labels, "window": "long"})
        w.sample("repro_slo_events", st.events_long, labels,
                 help_text="Relevant events in the long window")
        w.sample("repro_slo_healthy", st.status == "ok", labels,
                 help_text="1 while the objective is within budget")
    verdict = mon.verdict(engine)
    w.sample("repro_health_status", _STATUS_CODE[verdict.status],
             help_text="HealthVerdict: 0=ok 1=degraded 2=failing")


def _drift_section(w: _Writer, engine) -> None:
    mon = getattr(engine, "monitor", None)
    if mon is None or mon.drift is None:
        return
    flagged = {(f.family, f.algorithm, f.regime)
               for f in mon.drift.flags()}
    for st in mon.drift.snapshot().values():
        labels = {"family": st["family"], "algorithm": st["algorithm"],
                  "regime": st["regime"]}
        w.sample("repro_drift_ewma_residual", st["ewma_residual"], labels,
                 help_text="Recent-weighted measured/modeled cost ratio "
                           "(1.0 = calibrated)")
        w.sample("repro_drift_mean_residual", st["mean_residual"], labels,
                 help_text="Geometric-mean measured/modeled cost ratio")
        w.sample("repro_drift_observations", st["count"], labels,
                 help_text="Residuals folded for this kernel/regime")
        key = (st["family"], st["algorithm"], st["regime"])
        w.sample("repro_drift_flagged", key in flagged, labels,
                 help_text="1 when this kernel/regime is outside the "
                           "drift band")
    rep = mon.drift.report()
    w.sample("repro_drift_flagged_families", len(rep.families),
             help_text="Probe families needing a repro.tune re-run")


def render_prometheus(engine=None, tracer=None) -> str:
    """Render the full exposition.  ``engine=None`` skips the serve
    section; ``tracer=None`` uses the globally-configured tracer (and
    skips span histograms when tracing is off)."""
    from . import spans as _spans
    w = _Writer()
    if engine is not None:
        _serve_section(w, engine)
    _cache_section(w)
    if tracer is None:
        tracer = _spans.get_tracer()
    if tracer is not None:
        _span_section(w, tracer)
    if engine is not None:
        _slo_section(w, engine)
        _drift_section(w, engine)
    return w.render()


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple], float]:
    """Strict-enough parser for the exposition this module renders:
    maps ``(metric_name, sorted_label_items)`` to the sample value.
    Raises ``ValueError`` on a malformed sample line."""
    out: Dict[Tuple[str, Tuple], float] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        if not head:
            raise ValueError(f"malformed sample line: {raw!r}")
        labels: Tuple = ()
        name = head
        if head.endswith("}"):
            name, _, rest = head.partition("{")
            body = rest[:-1]
            items = []
            for pair in _split_labels(body):
                k, _, v = pair.partition("=")
                if len(v) < 2 or not (v.startswith('"')
                                      and v.endswith('"')):
                    raise ValueError(f"malformed label in: {raw!r}")
                items.append((k, _unescape(v[1:-1])))
            labels = tuple(sorted(items))
        if not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"malformed metric name in: {raw!r}")
        out[(name, labels)] = float(value)
    return out


def _split_labels(body: str) -> List[str]:
    """Split ``k="v",k2="v2"`` on commas outside quotes.

    Tracks escape state explicitly: a ``prev != "\\\\"`` heuristic
    mis-handles values *ending* in a backslash (rendered ``\\\\`` —
    the second backslash is escaped, so the closing quote that follows
    must still close the string)."""
    parts: List[str] = []
    cur: List[str] = []
    in_q = esc = False
    for ch in body:
        if in_q:
            cur.append(ch)
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_q = False
            continue
        if ch == ",":
            parts.append("".join(cur))
            cur = []
            continue
        if ch == '"':
            in_q = True
        cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts
