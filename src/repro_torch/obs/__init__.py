"""repro_torch.obs — structured tracing and health exposition for the
masked-product stack.

    from repro_torch import obs
    with obs.tracing() as tr:            # in-memory ring; off by default
        engine.serve(queries)
    spans = tr.sink.spans()
    obs.save_chrome_trace("trace.json", spans)     # Perfetto

Span sites cost one global read + one branch while tracing is off, and
spans never feed scheduling or deterministic counters.

Online health rides the same stream::

    monitor = obs.HealthMonitor()        # aggregator + SLOs + drift
    eng = QueryEngine(monitor=monitor, expose_port=0)   # /metrics, /health
    with obs.tracing(monitor):
        ... serve ...
    eng.health()                         # HealthVerdict{ok|degraded|failing}

while ``python -m repro_torch.obs.report`` renders the cross-commit
trajectory of every committed bench grid.
"""
# NB: .report is deliberately NOT imported here: it is a CLI module
# (``python -m repro_torch.obs.report``) and importing it from the
# package __init__ would trip runpy's double-import warning
from . import drift, export, health, sinks, slo, spans  # noqa: F401
from .drift import DriftDetector
from .exposition import parse_prometheus, render_prometheus
from .export import chrome_trace, residuals, save_chrome_trace
from .health import HealthMonitor, HealthVerdict, WindowAggregator
from .sinks import InMemorySink, JsonlSpanSink, load_spans
from .slo import DEFAULT_SLOS, Objective, SLOEngine
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
    "DEFAULT_SLOS", "DriftDetector", "HealthMonitor", "HealthVerdict",
    "InMemorySink", "JsonlSpanSink", "Objective", "SLOEngine", "Tracer",
    "WindowAggregator", "chrome_trace", "configure", "counter",
    "current_spans", "disable", "drift", "enabled", "event", "export",
    "get_tracer", "health", "load_spans", "new_trace",
    "parse_prometheus", "render_prometheus", "residuals",
    "save_chrome_trace", "sinks", "slo", "span", "spans", "tracing",
]
