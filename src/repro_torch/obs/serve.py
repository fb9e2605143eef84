"""``/metrics`` + ``/health`` over stdlib ``http.server``.

No third-party server dependency: a daemonized ``ThreadingHTTPServer``
bound to loopback by default, serving

* ``GET /metrics`` — the Prometheus text exposition
  (:func:`repro_torch.obs.exposition.render_prometheus`);
* ``GET /health``  — the engine's :class:`repro_torch.obs.health.HealthVerdict`
  as JSON (plus queue depth, quiesce/stop state, async mode); answers
  **503** with machine-readable ``reasons[]`` while the verdict is
  ``failing``, which is what load balancers and the multi-process
  fabric key ejection on.

Start it with ``QueryEngine(expose_port=0)`` (0 = ephemeral port, read
``engine.obs_server.port``), or standalone against a demo engine via
``python -m repro_torch.obs.serve`` (on CUDA; ``--device cpu`` to ask for
the CPU).

The handler threads read host state only (``ServeMetrics.snapshot()``,
the queue depth, the monitor's windows and drift statistics, the cache
registry), so a scrape never synchronises with or touches the device
while the serving worker launches kernels.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["ObsServer", "start_server"]


def _health(engine) -> tuple:
    """``(http_status, payload)``: the engine's HealthVerdict plus the
    liveness fields earlier PRs exposed.  503 while ``failing`` — the
    contract load balancers/fabric schedulers eject workers on."""
    if hasattr(engine, "health"):
        verdict = engine.health()
    else:
        from .health import basic_verdict
        verdict = basic_verdict(engine)
    stopped = bool(getattr(engine, "_stop", False))
    payload = {
        "status": verdict.status,
        "reasons": list(verdict.reasons),
        "queue_depth": int(engine._pending()),
        "async_mode": bool(getattr(engine, "async_mode", False)),
        "stopped": stopped,
    }
    snap = engine.metrics.snapshot()
    payload["completed"] = snap["completed"]
    payload["failed"] = snap["failed"]
    return (503 if verdict.status == "failing" else 200), payload


def _make_handler(engine):
    from .exposition import render_prometheus

    class Handler(BaseHTTPRequestHandler):
        server_version = "repro-obs/1"

        def log_message(self, fmt, *args):
            pass  # exposition must not spam the serving process' stderr

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API name)
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                body = render_prometheus(engine).encode("utf-8")
                self._send(200, body,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/health":
                code, payload = _health(engine)
                body = (json.dumps(payload) + "\n").encode("utf-8")
                self._send(code, body, "application/json")
            else:
                self._send(404, b"not found\n", "text/plain")

    return Handler


class ObsServer:
    """Exposition endpoint bound to one engine; daemon-threaded."""

    def __init__(self, engine, *, port: int = 0, host: str = "127.0.0.1"):
        self.engine = engine
        self._httpd = ThreadingHTTPServer((host, int(port)),
                                          _make_handler(engine))
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"repro-obs-http:{self.port}", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "ObsServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def start_server(engine, *, port: int = 0,
                 host: str = "127.0.0.1") -> ObsServer:
    return ObsServer(engine, port=port, host=host)


def _main(argv=None) -> int:
    """Demo entry: spin up an engine over a synthetic workload, serve a
    few queries with tracing on, and expose /metrics until Ctrl-C."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.serve",
        description="Expose /metrics + /health for a demo QueryEngine.")
    parser.add_argument("--port", type=int, default=9464)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--queries", type=int, default=32,
                        help="synthetic queries to serve before exposing")
    parser.add_argument("--n", type=int, default=128,
                        help="operand dimension for the demo workload")
    parser.add_argument("--device", default="cuda",
                        help="device the demo engine serves on (default "
                             "cuda; pass cpu to ask for the CPU)")
    args = parser.parse_args(argv)

    import numpy as np

    from repro_torch import obs
    from repro_torch.core.formats import er_mask, erdos_renyi
    from repro_torch.serving.engine import QueryEngine

    obs.configure()
    rng = np.random.default_rng(0)
    mats = [erdos_renyi(args.n, 4, seed=s) for s in range(3)]
    B = erdos_renyi(args.n, 4, seed=99)
    M = er_mask(args.n, max(8, args.n // 8), seed=7)
    engine = QueryEngine(expose_port=args.port, device=args.device)
    try:
        tickets = [engine.submit(mats[int(rng.integers(len(mats)))], B, M)
                   for _ in range(args.queries)]
        engine.flush()
        for t in tickets:
            t.result()
        print(f"served {args.queries} queries; "
              f"metrics at {engine.obs_server.url}/metrics "
              f"(Ctrl-C to stop)")
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
    finally:
        engine.close()
        obs.disable()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
