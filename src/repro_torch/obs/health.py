"""Streaming health aggregation over the span stream.

:class:`WindowAggregator` is a pluggable span **sink** (the same
``emit(record)`` protocol as :class:`repro_torch.obs.sinks.InMemorySink`):
point a tracer at it — or tee through :class:`HealthMonitor` — and it
folds every span into bounded sliding windows in O(1) memory.

The memory bound comes from **ring-buffered window shards**: the
horizon (default 60 s) is cut into ``shards`` equal slices of
``shard_s`` seconds each; a record landing at time ``t`` goes into ring
slot ``int(t / shard_s) % shards``, and a slot whose stored epoch is
stale is reset in place before reuse.  Nothing is ever scanned or
evicted — expiry is a single epoch comparison on write and on read.
Per-shard state is a handful of dicts keyed by span name plus
**bounded** duration-sample lists (``sample_cap`` per shard) for
percentile estimation, so total memory is
``O(shards * names * sample_cap)`` regardless of traffic.

Time comes from the **injectable clock** (the same
:class:`repro_torch.serving.clock.SystemClock` /
:class:`~repro_torch.serving.clock.VirtualClock` split the engine uses):
records are bucketed by ``clock.now()`` at emit time, so tests drive
window expiry deterministically by advancing a virtual clock — no
sleeps, no wall-clock reads.

:class:`HealthMonitor` bundles an aggregator with an
:class:`repro_torch.obs.slo.SLOEngine` and a
:class:`repro_torch.obs.drift.DriftDetector` and renders
:class:`HealthVerdict` — the ``ok | degraded | failing`` triple (plus
concrete reasons) that ``/health`` serves (503 on ``failing``).

Everything here is host Python over host floats: the HTTP thread reads
verdicts while the serving worker launches kernels, and neither touches
a device tensor or calls into ``torch.cuda``.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from . import drift as drift_mod
from . import slo as slo_mod

__all__ = ["HealthMonitor", "HealthVerdict", "WindowAggregator",
           "WindowStats", "basic_verdict"]

#: span names whose durations are sampled for percentile estimation
DEFAULT_SAMPLE_NAMES = ("serve.exec", "serve.queue_wait")

_STATUS_RANK = {"ok": 0, "degraded": 1, "failing": 2}


@dataclasses.dataclass(frozen=True)
class HealthVerdict:
    """``ok | degraded | failing`` plus the reasons that earned it."""

    status: str
    reasons: Tuple[str, ...] = ()

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def as_dict(self) -> Dict:
        return {"status": self.status, "reasons": list(self.reasons)}

    @staticmethod
    def worst(*verdicts: "HealthVerdict") -> "HealthVerdict":
        """Combine verdicts: worst status wins, reasons concatenate —
        how a fabric aggregates per-worker verdicts into one."""
        status = max((v.status for v in verdicts),
                     key=lambda s: _STATUS_RANK[s], default="ok")
        reasons: List[str] = []
        for v in verdicts:
            reasons.extend(r for r in v.reasons if r not in reasons)
        return HealthVerdict(status, tuple(reasons))


class _Shard:
    """One ring slot: aggregates for one ``shard_s``-second slice."""

    __slots__ = ("epoch", "counts", "req_counts", "dur_sums", "samples",
                 "gauges")

    def __init__(self):
        self.epoch = -1
        self.reset(-1)

    def reset(self, epoch: int) -> None:
        self.epoch = epoch
        self.counts: Dict[str, int] = {}
        self.req_counts: Dict[str, int] = {}
        self.dur_sums: Dict[str, float] = {}
        self.samples: Dict[str, List[float]] = {}
        self.gauges: Dict[str, float] = {}


class WindowStats:
    """Read-only aggregate over the shards inside one trailing window."""

    def __init__(self, seconds: float, shards: Sequence[_Shard]):
        self.seconds = seconds
        self._counts: Dict[str, int] = {}
        self._req_counts: Dict[str, int] = {}
        self._dur_sums: Dict[str, float] = {}
        self._samples: Dict[str, List[float]] = {}
        self._gauges: Dict[str, float] = {}
        # oldest -> newest so newest shard wins the gauge value
        for sh in shards:
            for k, v in sh.counts.items():
                self._counts[k] = self._counts.get(k, 0) + v
            for k, v in sh.req_counts.items():
                self._req_counts[k] = self._req_counts.get(k, 0) + v
            for k, v in sh.dur_sums.items():
                self._dur_sums[k] = self._dur_sums.get(k, 0.0) + v
            for k, v in sh.samples.items():
                self._samples.setdefault(k, []).extend(v)
            self._gauges.update(sh.gauges)

    def count(self, name: str) -> int:
        """Number of records named ``name`` in the window."""
        return self._counts.get(name, 0)

    def req_count(self, name: str) -> int:
        """Size-weighted count: a ``serve.exec`` span covering a bucket
        of 8 requests contributes 8 (its ``size`` attr), so rates stay
        per-request under batching."""
        return self._req_counts.get(name, 0)

    def dur_sum(self, name: str) -> float:
        """Total seconds spent inside spans named ``name``."""
        return self._dur_sums.get(name, 0.0)

    def samples(self, name: str) -> List[float]:
        """Bounded duration samples for ``name`` (percentile fodder)."""
        return self._samples.get(name, [])

    def gauge(self, name: str) -> Optional[float]:
        """Most recent counter-track value for ``name``, if any."""
        return self._gauges.get(name)

    def percentile(self, name: str, q: float) -> float:
        """Nearest-rank percentile (``q`` in [0, 1]) of ``name``'s
        duration samples; 0.0 with no samples."""
        xs = sorted(self._samples.get(name, ()))
        if not xs:
            return 0.0
        idx = min(len(xs) - 1, max(0, int(q * len(xs))))
        return xs[idx]

    @property
    def names(self) -> List[str]:
        return sorted(self._counts)


class WindowAggregator:
    """Span sink folding the stream into ring-buffered window shards."""

    def __init__(self, *, clock=None, horizon_s: float = 60.0,
                 shards: int = 12, sample_cap: int = 256,
                 sample_names: Sequence[str] = DEFAULT_SAMPLE_NAMES):
        if horizon_s <= 0 or shards < 2:
            raise ValueError("horizon_s must be > 0 and shards >= 2")
        if clock is None:
            # deferred: repro_torch.serving imports repro_torch.obs at import
            from repro_torch.serving.clock import SystemClock
            clock = SystemClock()
        self.clock = clock
        self.horizon_s = float(horizon_s)
        self.shard_s = self.horizon_s / shards
        self.sample_cap = int(sample_cap)
        self.sample_names = frozenset(sample_names)
        self._ring = [_Shard() for _ in range(shards)]
        self._lock = threading.Lock()

    # -- sink protocol ------------------------------------------------------

    def emit(self, rec: Dict) -> None:
        """Fold one span/event/counter record into the current shard."""
        epoch = int(self.clock.now() / self.shard_s)
        name = rec.get("name", "?")
        with self._lock:
            sh = self._ring[epoch % len(self._ring)]
            if sh.epoch != epoch:
                sh.reset(epoch)
            if "counter" in rec:                       # counter track
                sh.gauges[name] = float(rec["counter"])
                return
            sh.counts[name] = sh.counts.get(name, 0) + 1
            attrs = rec.get("attrs") or {}
            size = attrs.get("size")
            if isinstance(size, (int, float)) and size > 0:
                sh.req_counts[name] = sh.req_counts.get(name, 0) + int(size)
            dur = rec.get("dur")
            if isinstance(dur, (int, float)):
                sh.dur_sums[name] = sh.dur_sums.get(name, 0.0) + dur
                if name in self.sample_names:
                    xs = sh.samples.setdefault(name, [])
                    if len(xs) < self.sample_cap:
                        xs.append(dur)

    # -- reads --------------------------------------------------------------

    def window(self, seconds: float) -> WindowStats:
        """Aggregate over the trailing ``seconds`` (clamped to the
        horizon).  Shard granularity means the effective window is
        ``ceil(seconds / shard_s)`` shards including the current
        partial one."""
        seconds = min(float(seconds), self.horizon_s)
        now = self.clock.now()
        cur = int(now / self.shard_s)
        span = min(max(1, math.ceil(seconds / self.shard_s)),
                   len(self._ring))
        lo = cur - span + 1
        with self._lock:
            live = sorted((sh for sh in self._ring
                           if lo <= sh.epoch <= cur),
                          key=lambda sh: sh.epoch)
            return WindowStats(seconds, live)

    def __repr__(self):
        return (f"WindowAggregator(horizon_s={self.horizon_s}, "
                f"shards={len(self._ring)}, shard_s={self.shard_s:.2f})")


def basic_verdict(engine) -> HealthVerdict:
    """Liveness-only verdict for engines without a monitor: a closed
    engine is ``failing``, a live one is ``ok``.  Window-based SLO and
    drift intelligence needs a :class:`HealthMonitor`."""
    if getattr(engine, "_stop", False):
        return HealthVerdict("failing", ("engine stopped",))
    return HealthVerdict("ok")


class HealthMonitor:
    """Aggregator + SLO engine + drift detector behind one sink.

    Use it anywhere a sink goes::

        monitor = HealthMonitor()
        engine = QueryEngine(monitor=monitor, expose_port=0)
        with obs.tracing(monitor):
            ...serve...
        engine.health()          # -> HealthVerdict

    ``inner`` optionally tees every record to a second sink (e.g. an
    :class:`~repro_torch.obs.sinks.InMemorySink` so spans stay exportable);
    ``spans()`` delegates to it, making the monitor a drop-in
    replacement where code expects an in-memory sink.
    """

    def __init__(self, *, slos: Sequence[slo_mod.Objective] = None,
                 clock=None, horizon_s: float = 60.0, shards: int = 12,
                 sample_cap: int = 256,
                 drift: Optional[drift_mod.DriftDetector] = "default",
                 inner=None):
        self.aggregator = WindowAggregator(
            clock=clock, horizon_s=horizon_s, shards=shards,
            sample_cap=sample_cap)
        self.slo = slo_mod.SLOEngine(
            slo_mod.DEFAULT_SLOS if slos is None else slos)
        self.drift: Optional[drift_mod.DriftDetector] = (
            drift_mod.DriftDetector() if drift == "default" else drift)
        self.inner = inner

    # -- sink protocol ------------------------------------------------------

    def emit(self, rec: Dict) -> None:
        self.aggregator.emit(rec)
        if self.drift is not None:
            self.drift.observe_record(rec)
        if self.inner is not None:
            self.inner.emit(rec)

    def spans(self) -> List[Dict]:
        """Records captured by the inner sink ([] without one)."""
        if self.inner is not None and hasattr(self.inner, "spans"):
            return self.inner.spans()
        return []

    # -- verdicts -----------------------------------------------------------

    def slo_status(self) -> List[slo_mod.ObjectiveStatus]:
        return self.slo.evaluate(self.aggregator)

    def verdict(self, engine=None) -> HealthVerdict:
        """Worst-of: engine liveness, every SLO, and cost-model drift
        (drift degrades — a stale model misroutes kernels but still
        serves — it never fails the worker outright)."""
        parts: List[HealthVerdict] = []
        if engine is not None:
            parts.append(basic_verdict(engine))
        for st in self.slo_status():
            if st.status != "ok":
                parts.append(HealthVerdict(st.status, (st.reason,)))
        if self.drift is not None:
            flagged = self.drift.flags()
            if flagged:
                rep = self.drift.report()
                reasons = tuple(f.reason for f in flagged) + (
                    (rep.command,) if rep.command else ())
                parts.append(HealthVerdict("degraded", reasons))
        return HealthVerdict.worst(*parts) if parts else HealthVerdict("ok")
