"""Trace exports: Chrome trace-event / Perfetto JSON and residuals.

``chrome_trace`` turns captured span records into the Trace Event
Format both ``chrome://tracing`` and https://ui.perfetto.dev open
directly: complete ("ph": "X") events with microsecond timestamps
normalized to the earliest span, one row per emitting thread.

Counter records (from :func:`repro_torch.obs.counter`) render as counter
("ph": "C") events, which Perfetto draws as value tracks — queue
depth, in-flight requests and cache hit-rate alongside the slices.

``residuals`` closes the paper's modeled-vs-measured loop: exec spans
carry the planner's modeled cost (``modeled_ms`` from
``planner.explain``), so a capture yields per-algorithm residual
factors that ``repro_torch.tune`` can fold into the next calibration.  Both
``residuals`` and ``residual_summary`` accept empty, ``None`` or
plan-span-free captures and return empty results — the online drift
detector feeds them sparse windows.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

__all__ = ["chrome_trace", "residual_record", "residual_summary",
           "residuals", "save_chrome_trace"]


def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return repr(v)


def chrome_trace(spans: List[Dict]) -> Dict:
    """Render span records as a Chrome trace-event JSON object."""
    spans = spans or []
    if spans:
        t_base = min(s.get("t0", 0.0) for s in spans)
    else:
        t_base = 0.0
    events = []
    for s in spans:
        if "counter" in s:                 # counter track, not a slice
            events.append({
                "name": s.get("name", "?"),
                "cat": str(s.get("name", "?")).split(".", 1)[0],
                "ph": "C",
                "ts": (s.get("t0", 0.0) - t_base) * 1e6,
                "pid": 1,
                "tid": s.get("tid", 0),
                "args": {"value": float(s["counter"])},
            })
            continue
        args = dict(s.get("attrs") or {})
        if s.get("trace") is not None:
            args["trace_id"] = s["trace"]
        if s.get("parent") is not None:
            args["parent_span"] = s["parent"]
        if s.get("error"):
            args["error"] = s["error"]
        events.append({
            "name": s.get("name", "?"),
            "cat": str(s.get("name", "?")).split(".", 1)[0],
            "ph": "X",
            "ts": (s.get("t0", 0.0) - t_base) * 1e6,
            "dur": max(s.get("dur", 0.0), 0.0) * 1e6,
            "pid": 1,
            "tid": s.get("tid", 0),
            "args": _json_safe(args),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def save_chrome_trace(path, spans: List[Dict]) -> Dict:
    """Write a Perfetto-openable trace JSON; returns the object."""
    obj = chrome_trace(spans)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)
    return obj


def residual_record(rec: Dict, *,
                    span_name: str = "serve.exec") -> Optional[Dict]:
    """One span record -> residual dict, or ``None``.

    Returns ``{"algorithm", "route", "regime", "size", "modeled_ms",
    "measured_ms", "residual"}`` for an exec span carrying a usable
    modeled cost; ``None`` for anything else (wrong name, counter
    record, missing/zero/non-numeric ``modeled_ms``).  ``residual =
    measured / (modeled * size)``: bucketed exec spans measure the
    whole bucket while ``modeled_ms`` prices one query, so the modeled
    side scales by the bucket ``size`` (absent -> 1).
    """
    if not isinstance(rec, dict) or rec.get("name") != span_name:
        return None
    if "counter" in rec:
        return None
    attrs = rec.get("attrs") or {}
    try:
        modeled = float(attrs.get("modeled_ms") or 0.0)
        measured = float(rec.get("dur") or 0.0) * 1e3
        size = float(attrs.get("size") or 1.0)
    except (TypeError, ValueError):
        return None
    if modeled <= 0.0 or size <= 0.0:
        return None
    return {
        "algorithm": attrs.get("algorithm"),
        "route": attrs.get("route"),
        "regime": attrs.get("regime"),
        "size": int(size),
        "modeled_ms": modeled,
        "measured_ms": measured,
        "residual": measured / (modeled * size),
    }


def residuals(spans: Optional[List[Dict]],
              *, span_name: str = "serve.exec") -> List[Dict]:
    """Modeled-vs-measured cost residuals from exec spans.

    Returns one record per exec span that carried a modeled cost (see
    :func:`residual_record`); ``residual = 1.0`` means perfectly
    calibrated.  Feed the aggregate back to ``repro_torch.tune`` as a
    correction factor.  Empty / ``None`` / plan-span-free input yields
    ``[]``.
    """
    out = []
    for s in spans or ():
        r = residual_record(s, span_name=span_name)
        if r is not None:
            out.append(r)
    return out


def residual_summary(spans: Optional[List[Dict]]) -> Dict[str, Dict]:
    """Per-algorithm residual aggregate: count / mean residual.
    Empty or plan-span-free input yields ``{}`` rather than raising."""
    per: Dict[Optional[str], List[float]] = {}
    for r in residuals(spans):
        per.setdefault(r["algorithm"], []).append(r["residual"])
    return {
        str(alg): {"count": len(v), "mean_residual": sum(v) / len(v)}
        for alg, v in per.items()
    }
