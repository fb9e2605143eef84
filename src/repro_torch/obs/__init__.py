"""repro_torch.obs — structured span tracing for the masked-product stack.

    from repro_torch import obs
    with obs.tracing() as tr:            # in-memory ring; off by default
        engine.serve(queries)
    spans = tr.sink.spans()

Span sites cost one global read + one branch while tracing is off, and
spans never feed scheduling or deterministic counters.
"""
from . import sinks, spans  # noqa: F401
from .sinks import InMemorySink, JsonlSpanSink, load_spans
from .spans import (
    Tracer,
    configure,
    counter,
    current_spans,
    disable,
    enabled,
    event,
    get_tracer,
    new_trace,
    span,
    tracing,
)

__all__ = [
    "InMemorySink", "JsonlSpanSink", "Tracer", "configure", "counter",
    "current_spans", "disable", "enabled", "event", "get_tracer",
    "load_spans", "new_trace", "sinks", "span", "spans", "tracing",
]
