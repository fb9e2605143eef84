"""Declarative SLOs evaluated as multi-window burn rates.

An :class:`Objective` names a serving quantity (p99 serve latency, error
rate, result-cache hit rate, queue-wait share), a bound on it, and an
error *budget* — the fraction of traffic allowed to violate the bound.
The classic SRE multi-window discipline turns those into verdicts:

* every objective reduces to a **bad-event fraction** over a window
  (requests that failed, exec spans over the latency bound, ...);
* ``burn rate = bad fraction / budget`` — 1.0 means the budget is being
  consumed exactly as fast as it accrues;
* the engine evaluates each objective over a *short* and a *long*
  window (both served by :class:`repro_torch.obs.health.WindowAggregator`'s
  ring shards): ``failing`` requires the burn to exceed
  ``failing_burn`` on BOTH windows (a long-window burn alone is old
  news; a short-window burn alone is a blip), ``degraded`` needs only
  the long window over ``degraded_burn``.

Windows with fewer than ``min_events`` relevant events stay ``ok`` —
an idle engine has consumed no budget, and the drift detector feeds on
sparse windows without tripping anything here.

This module is deliberately standalone: it duck-types the aggregator
(anything with ``window(seconds) -> WindowStats``), so tests can drive
it from synthetic windows without an engine or a tracer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

__all__ = ["DEFAULT_SLOS", "METRICS", "Objective", "ObjectiveStatus",
           "SLOEngine"]

#: objective ``metric`` names understood by :meth:`SLOEngine.evaluate`
METRICS = ("latency_p99", "error_rate", "cache_hit_rate",
           "queue_wait_share")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative SLO.

    ``bound`` is the threshold on the raw metric (seconds for
    ``latency_p99``, a fraction for the rest).  ``budget`` is the
    allowed bad-event fraction; ``None`` derives the conventional
    default per metric: 0.01 for ``latency_p99`` (a p99 bound means 1%
    of requests may exceed it), ``bound`` itself for ``error_rate`` and
    ``queue_wait_share`` (the bound IS the budget for rate-shaped
    metrics), and ``1 - bound`` for ``cache_hit_rate`` (a minimum).
    """

    name: str
    metric: str
    bound: float
    budget: float = None  # type: ignore[assignment]  (resolved below)
    short_s: float = 5.0
    long_s: float = 60.0
    degraded_burn: float = 1.0
    failing_burn: float = 2.0
    min_events: int = 4

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(f"unknown SLO metric {self.metric!r}; "
                             f"known: {', '.join(METRICS)}")
        if self.budget is None:
            object.__setattr__(self, "budget", self._default_budget())
        if not (0.0 < self.budget <= 1.0):
            raise ValueError(f"{self.name}: budget must be in (0, 1], "
                             f"got {self.budget}")
        if self.short_s > self.long_s:
            raise ValueError(f"{self.name}: short_s ({self.short_s}) must "
                             f"not exceed long_s ({self.long_s})")

    def _default_budget(self) -> float:
        if self.metric == "latency_p99":
            return 0.01
        if self.metric == "cache_hit_rate":
            return max(1e-9, 1.0 - self.bound)
        return max(1e-9, self.bound)       # error_rate / queue_wait_share


#: the shipped defaults: permissive bounds that catch real pathology
#: (a failing bucket storm, multi-second p99s, queues dwarfing work)
#: without tripping on machine speed differences.  Hit-rate SLOs are
#: workload-specific, so none ships by default — add your own
#: ``Objective("cache-hits", "cache_hit_rate", bound=0.5)``.
DEFAULT_SLOS: Tuple[Objective, ...] = (
    Objective("serve-latency-p99", "latency_p99", bound=1.0),
    Objective("serve-errors", "error_rate", bound=0.01),
    Objective("queue-wait-share", "queue_wait_share", bound=0.9),
)


@dataclasses.dataclass(frozen=True)
class ObjectiveStatus:
    """One objective's multi-window evaluation."""

    objective: Objective
    burn_short: float
    burn_long: float
    events_long: int
    status: str                 # ok | degraded | failing
    reason: str                 # human-readable, "" while ok

    def as_dict(self) -> Dict:
        o = self.objective
        return {"slo": o.name, "metric": o.metric, "bound": o.bound,
                "budget": o.budget, "burn_short": self.burn_short,
                "burn_long": self.burn_long, "events": self.events_long,
                "status": self.status, "reason": self.reason}


class SLOEngine:
    """Evaluates a set of objectives against a window aggregator."""

    def __init__(self, objectives: Sequence[Objective] = DEFAULT_SLOS):
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.objectives: Tuple[Objective, ...] = tuple(objectives)

    # -- metric extraction --------------------------------------------------

    @staticmethod
    def _bad_fraction(metric: str, bound: float, win) -> Tuple[float, int]:
        """``(bad_event_fraction, n_events)`` for one metric over one
        window.  Zero events yields ``(0.0, 0)`` — no traffic has
        consumed no budget."""
        if metric == "latency_p99":
            samples = win.samples("serve.exec")
            if not samples:
                return 0.0, 0
            over = sum(1 for s in samples if s > bound)
            return over / len(samples), len(samples)
        if metric == "error_rate":
            errors = win.count("serve.error")
            served = win.req_count("serve.exec") + win.count(
                "serve.cache_hit")
            total = errors + served
            return (errors / total if total else 0.0), total
        if metric == "cache_hit_rate":
            submits = win.count("serve.submit")
            hits = win.count("serve.cache_hit")
            return ((1.0 - hits / submits) if submits else 0.0), submits
        if metric == "queue_wait_share":
            wait = win.dur_sum("serve.queue_wait")
            exec_s = win.dur_sum("serve.exec")
            total = wait + exec_s
            return ((wait / total) if total > 0 else 0.0), \
                win.count("serve.exec")
        raise ValueError(f"unknown SLO metric {metric!r}")

    def burn_rate(self, objective: Objective, win) -> Tuple[float, int]:
        """``(burn_rate, n_events)`` of one objective over one window."""
        bad, events = self._bad_fraction(objective.metric, objective.bound,
                                         win)
        return bad / objective.budget, events

    # -- verdicts -----------------------------------------------------------

    def evaluate(self, aggregator) -> List[ObjectiveStatus]:
        """Multi-window evaluation of every objective: ``aggregator``
        is anything with ``window(seconds) -> WindowStats``."""
        out: List[ObjectiveStatus] = []
        for o in self.objectives:
            burn_s, _ = self.burn_rate(o, aggregator.window(o.short_s))
            burn_l, events = self.burn_rate(o, aggregator.window(o.long_s))
            status, reason = "ok", ""
            if events >= o.min_events:
                if burn_l >= o.failing_burn and burn_s >= o.failing_burn:
                    status = "failing"
                    reason = (f"{o.name}: burn {burn_l:.1f}x over "
                              f"{o.long_s:.0f}s AND {burn_s:.1f}x over "
                              f"{o.short_s:.0f}s (budget "
                              f"{o.budget * 100:g}%, {o.metric} bound "
                              f"{o.bound:g})")
                elif burn_l >= o.degraded_burn:
                    status = "degraded"
                    reason = (f"{o.name}: burn {burn_l:.1f}x over "
                              f"{o.long_s:.0f}s (budget "
                              f"{o.budget * 100:g}%, {o.metric} bound "
                              f"{o.bound:g})")
            out.append(ObjectiveStatus(o, burn_s, burn_l, events, status,
                                       reason))
        return out
