"""Structured spans: the tracing core of ``repro_torch.obs``.

One process-global :class:`Tracer` (installed by :func:`configure`,
removed by :func:`disable`) receives every span.  Instrumented call
sites go through the module-level :func:`span` / :func:`event` /
:func:`counter` / :func:`new_trace` helpers, which cost one global read
and one branch when tracing is off.  Spans never feed scheduling or
``ServeMetrics`` counters, so enabling them cannot change
``deterministic_snapshot()``.

Spans measure host wall time (``time.perf_counter``).  A span around
asynchronous CUDA work times its dispatch unless the work inside it
synchronises; the serving engine's ``serve.exec`` ends after
``torch.cuda.synchronize``.  Scheduling quantities (queue wait) are never
measured here: the engine computes them from its injectable clock and
hands them to :func:`event` as ready-made durations.

Span identity is deterministic: trace and span ids come from process
counters, never the wall clock or an RNG, so two traced replays of one
stream produce identically numbered spans.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from contextvars import ContextVar
from typing import Dict, Iterator, List, Optional

__all__ = [
    "Tracer", "configure", "counter", "current_spans", "disable",
    "enabled", "event", "get_tracer", "new_trace", "span", "tracing",
]

#: parent span id of the calling context (thread/task local): nested
#: ``span()`` blocks link into a tree
_parent_var: ContextVar[Optional[int]] = ContextVar("obs_parent",
                                                    default=None)
#: trace id in scope for the calling context (set by request-scoped spans)
_trace_var: ContextVar[Optional[int]] = ContextVar("obs_trace",
                                                   default=None)


class _NullSpan:
    """Reusable no-op span: what every span site receives while tracing
    is disabled.  Stateless, so one shared instance is safe under any
    interleaving."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Span:
    """One live span: context manager measuring its own wall duration.

    ``set(**attrs)`` inside the block attaches attributes that are only
    known mid-flight (elected route, eviction counts).  The record is
    emitted to the tracer's sink on exit.
    """

    __slots__ = ("_tracer", "name", "span_id", "trace", "attrs",
                 "parent", "_t0", "_tok_parent", "_tok_trace")

    def __init__(self, tracer: "Tracer", name: str,
                 trace: Optional[int], attrs: Dict):
        self._tracer = tracer
        self.name = name
        self.span_id = tracer._next_span()
        self.trace = trace
        self.attrs = attrs
        self.parent = None
        self._tok_parent = None
        self._tok_trace = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self.parent = _parent_var.get()
        self._tok_parent = _parent_var.set(self.span_id)
        if self.trace is None:
            self.trace = _trace_var.get()
        else:
            self._tok_trace = _trace_var.set(self.trace)
        self._t0 = time.perf_counter()  # lint: clock-ok(span start stamp)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0  # lint: clock-ok(span duration)
        if self._tok_parent is not None:
            _parent_var.reset(self._tok_parent)
        if self._tok_trace is not None:
            _trace_var.reset(self._tok_trace)
        rec = {"name": self.name, "span": self.span_id,
               "parent": self.parent, "trace": self.trace,
               "t0": self._t0, "dur": dur,
               "tid": threading.get_ident()}
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.attrs:
            rec["attrs"] = self.attrs
        self._tracer._emit(rec)
        return False


class Tracer:
    """Emits span records to one pluggable sink (``emit(dict)``).

    Ids are drawn from process-wide counters (deterministic across
    replays of one stream); emission is serialized by the sink itself.
    """

    def __init__(self, sink):
        self.sink = sink
        self._span_counter = itertools.count(1)
        self._trace_counter = itertools.count(1)

    # itertools.count.__next__ is atomic under the GIL — no lock needed
    def _next_span(self) -> int:
        return next(self._span_counter)

    def new_trace(self) -> int:
        """Fresh per-request trace id (deterministic counter)."""
        return next(self._trace_counter)

    def span(self, name: str, *, trace: Optional[int] = None,
             **attrs) -> Span:
        return Span(self, name, trace, attrs)

    def event(self, name: str, *, dur_s: float = 0.0,
              trace: Optional[int] = None, **attrs) -> None:
        """Emit a complete span whose duration was measured elsewhere
        (the engine's clock-derived queue wait, its plan and exec
        seconds)."""
        t1 = time.perf_counter()  # lint: clock-ok(event emit stamp)
        rec = {"name": name, "span": self._next_span(),
               "parent": _parent_var.get(),
               "trace": trace if trace is not None else _trace_var.get(),
               "t0": t1 - float(dur_s), "dur": float(dur_s),
               "tid": threading.get_ident()}
        if attrs:
            rec["attrs"] = attrs
        self._emit(rec)

    def counter(self, name: str, value: float,
                *, trace: Optional[int] = None) -> None:
        """Emit a counter-track sample (queue depth, in-flight requests,
        cache hit rate): a durationless record whose ``counter`` key
        carries the instantaneous value."""
        rec = {"name": name, "counter": float(value),
               "span": self._next_span(),
               "trace": trace if trace is not None else _trace_var.get(),
               "t0": time.perf_counter(),  # lint: clock-ok(counter stamp)
               "tid": threading.get_ident()}
        self._emit(rec)

    def _emit(self, rec: Dict) -> None:
        self.sink.emit(rec)


#: the process-global tracer; None = tracing disabled (the default).
#: Every instrumented site reads this exactly once per call.
_tracer: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    return _tracer


def enabled() -> bool:
    return _tracer is not None


def configure(sink=None, *, capacity: int = 4096) -> Tracer:
    """Install (and return) the process-global tracer.

    ``sink=None`` builds an in-memory ring of ``capacity`` spans; pass a
    :class:`repro_torch.obs.sinks.JsonlSpanSink` for rotating capture."""
    global _tracer
    if sink is None:
        from .sinks import InMemorySink
        sink = InMemorySink(capacity=capacity)
    _tracer = Tracer(sink)
    return _tracer


def disable() -> Optional[Tracer]:
    """Remove the global tracer; returns the one that was active (its
    sink keeps any captured spans)."""
    global _tracer
    t, _tracer = _tracer, None
    return t


@contextlib.contextmanager
def tracing(sink=None, *, capacity: int = 4096) -> Iterator[Tracer]:
    """Scoped enable: ``with obs.tracing() as tr: ...``; restores the
    previously installed tracer (usually None) on exit."""
    global _tracer
    prev = _tracer
    t = configure(sink, capacity=capacity)
    try:
        yield t
    finally:
        _tracer = prev


def span(name: str, *, trace: Optional[int] = None, **attrs):
    """Module-level span site: one global read + one branch when
    tracing is off (returns the shared no-op span)."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(name, trace=trace, **attrs)


def event(name: str, *, dur_s: float = 0.0, trace: Optional[int] = None,
          **attrs) -> None:
    t = _tracer
    if t is None:
        return
    t.event(name, dur_s=dur_s, trace=trace, **attrs)


def counter(name: str, value: float,
            *, trace: Optional[int] = None) -> None:
    """Module-level counter-track site: one global read + one branch
    when tracing is off."""
    t = _tracer
    if t is None:
        return
    t.counter(name, value, trace=trace)


def new_trace() -> Optional[int]:
    """Per-request trace id, or None while tracing is disabled."""
    t = _tracer
    if t is None:
        return None
    return t.new_trace()


def current_spans() -> List[Dict]:
    """Captured spans of the active tracer's sink, when it keeps any
    (in-memory ring); empty list otherwise."""
    t = _tracer
    if t is None:
        return []
    spans = getattr(t.sink, "spans", None)
    return spans() if callable(spans) else []
