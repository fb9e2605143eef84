"""Deterministic traffic traces: capture a served request stream, replay it
bit-identically.

The engine's throughput knobs are measured against recorded traffic, not
guessed.  This module provides the record half and the replay half:

* :class:`TraceRecorder` — hooked into ``QueryEngine.submit`` (the engine's
  ``recorder=`` parameter): logs each request's operand specs, content
  fingerprints, arrival offset (engine-clock time), and request options to
  a versioned JSONL schema (:data:`SCHEMA_VERSION`), the reference
  package's schema, so traces move between the two packages.
* :func:`replay_trace` — re-runs a trace against a fresh engine on
  ``device`` under a :class:`~repro_torch.serving.clock.VirtualClock`:
  submissions happen at the recorded offsets and the clock is stepped
  through every ``max_wait_ms`` flush deadline, so the bucket sequence is a
  pure function of the trace and the knobs.  Two replays of one trace
  produce identical bucket schedules, identical deterministic counters,
  and byte-exact results, in sync AND async mode (the sync path replays
  the async worker's flush policy via ``QueryEngine.flush_due``).

Operands are stored either as *generator specs* (the seeded synthetic
families of ``repro_torch.core.formats``: tiny traces, exact regeneration)
or *inline* (base64 of the raw CSR arrays: byte-exact for arbitrary live
operands).  Every event also records a content-fingerprint digest per
operand; replay validates regenerated operands against them, so a drifted
generator can never silently replay different traffic.

The committed golden trace lives under ``results/traces/``.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import os
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.formats import (CSR, block_sparse, csr_from_dense,
                                      erdos_renyi, er_mask, to_numpy)
from repro_torch.core.semiring import PLUS_TIMES, REGISTRY

from .cache import content_fingerprint
from .clock import VirtualClock

#: trace schema version — bump on incompatible event/field changes; the
#: loader rejects any other version outright (a misread trace would replay
#: the wrong traffic and invalidate every measurement made against it)
SCHEMA_VERSION = 1
TRACE_KIND = "repro-serve-trace"

#: registry directory for committed traces; override with $REPRO_TRACE_DIR
TRACE_DIR_ENV = "REPRO_TRACE_DIR"
DEFAULT_TRACE_DIR = os.path.join("results", "traces")
GOLDEN_TRACE_NAME = "golden_v1.jsonl"

_DEADLINE_NUDGE = 1e-9   # float-safe step past a flush deadline


class TraceError(ValueError):
    """A trace failed validation, (de)serialization, or replay checks."""


# ---------------------------------------------------------------------------
# Operand specs: how a trace names its matrices
# ---------------------------------------------------------------------------


def spec_er(n: int, avg_degree: float, seed: int) -> Dict:
    return {"kind": "er", "n": int(n), "avg_degree": float(avg_degree),
            "seed": int(seed)}


def spec_er_mask(n: int, d: float, seed: int) -> Dict:
    return {"kind": "er_mask", "n": int(n), "d": float(d), "seed": int(seed)}


def spec_block(n: int, bs: int, tile_density: float, within_density: float,
               seed: int, mask: bool = False) -> Dict:
    return {"kind": "block", "n": int(n), "bs": int(bs),
            "tile_density": float(tile_density),
            "within_density": float(within_density), "seed": int(seed),
            "mask": bool(mask)}


def spec_revalue(base: Dict, seed: int) -> Dict:
    """Same structure as ``base``, fresh uniform[0.5, 1.5) float32 values —
    the 'queries against a shared pattern' workload shape."""
    return {"kind": "revalue", "base": dict(base), "seed": int(seed)}


def _encode_array(a: np.ndarray) -> Dict:
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def _decode_array(enc: Dict) -> np.ndarray:
    raw = base64.b64decode(enc["b64"].encode("ascii"))
    return np.frombuffer(raw, dtype=np.dtype(enc["dtype"])).reshape(
        [int(s) for s in enc["shape"]]).copy()


def spec_inline(x: CSR) -> Dict:
    """Byte-exact embedding of an arbitrary CSR operand (live capture of
    traffic no generator spec describes)."""
    return {"kind": "inline", "shape": list(x.shape),
            "indptr": _encode_array(x.indptr),
            "indices": _encode_array(x.indices),
            "data": _encode_array(x.data)}


def materialize(spec: Dict, _cache: Optional[Dict] = None) -> CSR:
    """Rebuild the operand a spec describes (deterministic: seeded
    generators or exact inline bytes).  ``_cache`` (canonical-spec -> CSR)
    lets a replay share one object per distinct spec, the way live traffic
    shares operand objects."""
    key = None
    if _cache is not None:
        key = json.dumps(spec, sort_keys=True, separators=(",", ":"))
        hit = _cache.get(key)
        if hit is not None:
            return hit
    kind = spec.get("kind")
    if kind == "er":
        out = erdos_renyi(spec["n"], spec["avg_degree"], seed=spec["seed"])
    elif kind == "er_mask":
        out = er_mask(spec["n"], spec["d"], spec["seed"])
    elif kind == "block":
        out = csr_from_dense(block_sparse(
            spec["n"], spec["bs"], spec["tile_density"],
            spec["within_density"], seed=spec["seed"],
            mask=spec.get("mask", False)))
    elif kind == "revalue":
        base = materialize(spec["base"], _cache)
        rng = np.random.default_rng(spec["seed"])
        out = CSR(base.indptr, base.indices,
                  rng.uniform(0.5, 1.5, base.nnz).astype(np.float32),
                  base.shape)
    elif kind == "inline":
        out = CSR(_decode_array(spec["indptr"]),
                  _decode_array(spec["indices"]),
                  _decode_array(spec["data"]),
                  tuple(int(s) for s in spec["shape"]))
    else:
        raise TraceError(f"unknown operand spec kind {kind!r}")
    if _cache is not None:
        _cache[key] = out
    return out


def fingerprint_digest(x: CSR) -> int:
    """One integer summarizing an operand's content fingerprint (structure
    CRC + value CRC); replay compares these against the recorded values."""
    return zlib.crc32(repr(content_fingerprint(x)).encode())


# ---------------------------------------------------------------------------
# Trace container + JSONL (de)serialization
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trace:
    """A recorded request stream: header metadata + submit events ordered
    by arrival offset (seconds from the first submit)."""

    name: str
    events: List[Dict]
    meta: Dict = dataclasses.field(default_factory=dict)

    @property
    def n_requests(self) -> int:
        return len(self.events)

    @property
    def duration_s(self) -> float:
        return float(self.events[-1]["t"]) if self.events else 0.0

    def validate(self) -> "Trace":
        last_t = 0.0
        for i, ev in enumerate(self.events):
            if ev.get("op") != "submit":
                raise TraceError(f"event {i}: unknown op {ev.get('op')!r}")
            t = float(ev.get("t", -1.0))
            if t < last_t - 1e-12:
                raise TraceError(f"event {i}: arrival offsets must be "
                                 f"non-decreasing ({t} after {last_t})")
            last_t = max(last_t, t)
            for op in ("A", "B", "M"):
                if not isinstance(ev.get(op), dict):
                    raise TraceError(f"event {i}: missing operand {op}")
            if ev.get("semiring") not in REGISTRY:
                raise TraceError(f"event {i}: unknown semiring "
                                 f"{ev.get('semiring')!r}")
        return self

    # -- JSONL --------------------------------------------------------------

    def dumps(self) -> str:
        header = {"schema": SCHEMA_VERSION, "kind": TRACE_KIND,
                  "name": self.name, "requests": self.n_requests,
                  "meta": self.meta}
        lines = [json.dumps(header, sort_keys=True)]
        lines += [json.dumps(ev, sort_keys=True) for ev in self.events]
        return "\n".join(lines) + "\n"

    @classmethod
    def loads(cls, text: str) -> "Trace":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise TraceError("empty trace file")
        try:
            header = json.loads(lines[0])
            events = [json.loads(ln) for ln in lines[1:]]
        except json.JSONDecodeError as e:
            raise TraceError(f"not valid JSONL: {e}") from e
        if not isinstance(header, dict) or header.get("kind") != TRACE_KIND:
            raise TraceError(f"not a {TRACE_KIND} file "
                             f"(kind={header.get('kind')!r})")
        schema = header.get("schema")
        if schema != SCHEMA_VERSION:
            raise TraceError(f"unsupported trace schema {schema!r} "
                             f"(this build reads {SCHEMA_VERSION})")
        n = header.get("requests")
        if n is not None and int(n) != len(events):
            raise TraceError(f"header declares {n} requests, file holds "
                             f"{len(events)} (truncated capture?)")
        return cls(name=str(header.get("name", "trace")), events=events,
                   meta=dict(header.get("meta", {}))).validate()

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.dumps())
        return path

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.loads(f.read())

    # -- materialization ----------------------------------------------------

    def materialized(self, check: bool = True
                     ) -> List[Tuple[float, CSR, CSR, CSR, Dict]]:
        """Rebuild every request as ``(t, A, B, M, submit_kwargs)``.

        With ``check`` (default), each regenerated operand's fingerprint
        digest must equal the recorded one — a generator/seed drift fails
        loudly instead of replaying different traffic.
        """
        cache: Dict = {}
        out = []
        for i, ev in enumerate(self.events):
            ops = {name: materialize(ev[name], cache)
                   for name in ("A", "B", "M")}
            if check and "fp" in ev:
                for name, op in ops.items():
                    want = int(ev["fp"][name])
                    got = fingerprint_digest(op)
                    if got != want:
                        raise TraceError(
                            f"event {i}: operand {name} fingerprint "
                            f"{got:#010x} != recorded {want:#010x} "
                            f"(generator drift? corrupted trace?)")
            kwargs = dict(
                semiring=REGISTRY[ev["semiring"]],
                complement=bool(ev.get("complement", False)),
                algorithm=ev.get("algorithm"))
            out.append((float(ev["t"]), ops["A"], ops["B"], ops["M"],
                        kwargs))
        return out


def trace_dir() -> str:
    """Trace registry resolution:
    $REPRO_TRACE_DIR, else ``results/traces`` under the cwd if present,
    else the checkout's committed directory."""
    env = os.environ.get(TRACE_DIR_ENV)
    if env:
        return env
    if os.path.isdir(DEFAULT_TRACE_DIR):
        return DEFAULT_TRACE_DIR
    root = os.path.abspath(__file__)
    for _ in range(4):          # serving -> repro_torch -> src -> repo
        root = os.path.dirname(root)
    return os.path.join(root, "results", "traces")


def golden_trace_path() -> str:
    return os.path.join(trace_dir(), GOLDEN_TRACE_NAME)


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------


class RotatingTraceSink:
    """Streaming JSONL sink for long captures (logrotate discipline).

    Events append to ``path``; when a segment would exceed ``max_bytes``
    the files shift ``path`` → ``path.1`` → ... → ``path.N`` (``N =
    rotate``; the oldest segment falls off) and a fresh segment opens.
    EVERY segment is a standalone loadable trace: it begins with a full
    schema header that simply omits the request count (a stream cannot
    know it; ``Trace.loads`` only cross-checks the count when present).

    ``sample_rate`` keeps that fraction of events, decided by a rng
    seeded with ``seed`` — deterministic per capture, never the wall
    clock, so two captures of one virtual-clock replay sample the SAME
    events.  An event larger than ``max_bytes`` on its own still writes
    (one oversized segment beats silent data loss).
    """

    def __init__(self, path: str, *, max_bytes: int = 1 << 20,
                 rotate: int = 4, sample_rate: float = 1.0, seed: int = 0,
                 name: str = "capture", meta: Optional[Dict] = None,
                 kind: str = TRACE_KIND):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if rotate < 1:
            raise ValueError(f"rotate must be >= 1, got {rotate}")
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], "
                             f"got {sample_rate}")
        self.path = path
        self.max_bytes = int(max_bytes)
        self.rotate = int(rotate)
        self.sample_rate = float(sample_rate)
        self.name = name
        self.meta = dict(meta or {})
        # header kind: request captures keep TRACE_KIND; span captures
        # (``obs.sinks.JsonlSpanSink``) stamp their own so loaders cannot
        # confuse the two families
        self.kind = str(kind)
        self.written = 0        # events persisted (all segments)
        self.sampled_out = 0    # events dropped by the sampler
        self._rng = np.random.default_rng(seed)
        self._f = None
        self._size = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    # -- segment plumbing ---------------------------------------------------

    def _header(self) -> str:
        # NO "requests" field: the segment is still streaming
        return json.dumps({"schema": SCHEMA_VERSION, "kind": self.kind,
                           "name": self.name, "meta": self.meta},
                          sort_keys=True) + "\n"

    def _open(self) -> None:
        self._f = open(self.path, "w")
        head = self._header()
        self._f.write(head)
        self._size = len(head)

    def _shift(self) -> None:
        self._f.close()
        self._f = None
        for i in range(self.rotate, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i}")

    # -- public API -----------------------------------------------------------

    def write(self, event: Dict) -> bool:
        """Persist one submit event; returns False when the sampler
        dropped it."""
        if (self.sample_rate < 1.0
                and float(self._rng.random()) >= self.sample_rate):
            self.sampled_out += 1
            return False
        if self._f is None:
            self._open()
        line = json.dumps(event, sort_keys=True) + "\n"
        if (self._size + len(line) > self.max_bytes
                and self._size > len(self._header())):
            self._shift()
            self._open()
        self._f.write(line)
        self._size += len(line)
        self.written += 1
        return True

    def segments(self) -> List[str]:
        """Existing segment paths, oldest first (``path.N`` ... ``path``)."""
        out = [f"{self.path}.{i}" for i in range(self.rotate, 0, -1)]
        out.append(self.path)
        return [p for p in out if os.path.exists(p)]

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None

    def __enter__(self) -> "RotatingTraceSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_rotated(path: str, rotate: int = 64) -> Trace:
    """Load a rotated capture back as ONE trace: every surviving segment
    (``path.N`` oldest ... ``path`` newest), events concatenated in capture
    order.  Each segment is validated as a standalone trace first, so a
    corrupt rotation fails loudly with the segment named."""
    seg_paths = [f"{path}.{i}" for i in range(rotate, 0, -1)]
    seg_paths.append(path)
    seg_paths = [p for p in seg_paths if os.path.exists(p)]
    if not seg_paths:
        raise TraceError(f"no trace segments at {path!r}")
    segments = []
    for p in seg_paths:
        try:
            segments.append(Trace.load(p))
        except TraceError as e:
            raise TraceError(f"segment {p!r}: {e}") from e
    events = [ev for seg in segments for ev in seg.events]
    return Trace(name=segments[-1].name, events=events,
                 meta=dict(segments[-1].meta)).validate()


class TraceRecorder:
    """Observes every ``QueryEngine.submit`` (engine ``recorder=`` hook).

    Operands registered via :meth:`register_operand` serialize as their
    generator spec (tiny traces); anything else CSR-shaped embeds inline,
    byte-exact.  Arrival offsets are engine-clock seconds from the first
    submit.  ``mesh``-carrying and non-CSR requests are not representable
    in schema v1 and raise — a trace that silently dropped them would
    replay lighter traffic than it recorded.

    ``sink`` (a :class:`RotatingTraceSink`) streams each event to disk as
    it arrives — the long-capture mode, where the in-memory event list
    would grow without bound; pass ``keep_events=False`` alongside it to
    record with O(1) memory.  The sink's ``sample_rate`` applies to the
    sink only; the in-memory list (when kept) holds every event.
    """

    def __init__(self, name: str = "capture", meta: Optional[Dict] = None,
                 *, sink: Optional[RotatingTraceSink] = None,
                 keep_events: bool = True):
        self.name = name
        self.meta = dict(meta or {})
        self.sink = sink
        self.keep_events = keep_events
        self.events: List[Dict] = []
        self._t0: Optional[float] = None
        #: id(obj) -> (spec, obj); the object reference keeps the id valid
        self._specs: Dict[int, Tuple[Dict, object]] = {}

    def register_operand(self, obj: CSR, spec: Dict) -> CSR:
        """Declare that ``obj`` regenerates from ``spec`` (returns ``obj``
        for chaining)."""
        self._specs[id(obj)] = (dict(spec), obj)
        return obj

    def _spec_of(self, x) -> Dict:
        if not isinstance(x, CSR):
            raise TraceError(f"schema v1 records host-CSR operands only, "
                             f"got {type(x).__name__}")
        hit = self._specs.get(id(x))
        return dict(hit[0]) if hit is not None else spec_inline(x)

    def on_submit(self, A, B, M, *, t: float, semiring=PLUS_TIMES,
                  complement: bool = False,
                  algorithm: Optional[str] = None, mesh=None,
                  axis: str = "data") -> None:
        if mesh is not None:
            raise TraceError("mesh-carrying requests are not recordable "
                             "(trace schema v1 is single-process)")
        if self._t0 is None:
            self._t0 = t
        event = {
            "t": float(t - self._t0), "op": "submit",
            "A": self._spec_of(A), "B": self._spec_of(B),
            "M": self._spec_of(M),
            "semiring": semiring.name, "complement": bool(complement),
            "algorithm": algorithm,
            "fp": {"A": fingerprint_digest(A), "B": fingerprint_digest(B),
                   "M": fingerprint_digest(M)},
        }
        if self.keep_events:
            self.events.append(event)
        if self.sink is not None:
            self.sink.write(event)

    def trace(self) -> Trace:
        return Trace(name=self.name, events=list(self.events),
                     meta=dict(self.meta)).validate()


# ---------------------------------------------------------------------------
# Synthetic workloads (the golden trace, CI throwaway traces)
# ---------------------------------------------------------------------------


def synthesize_trace(name: str = "synthetic", *, n: int = 96,
                     n_structs: int = 3, queries: int = 48,
                     mean_gap_ms: float = 0.5, block_struct: bool = True,
                     repeat_fraction: float = 0.2, seed: int = 0) -> Trace:
    """A deterministic mixed-structure request stream, spec-based (no
    inline payloads): ER row-kernel regimes + an optional block-dense
    structure the tile route wins, fresh A values per query, a
    ``repeat_fraction`` of exact repeats (result-cache traffic), and
    seeded exponential inter-arrival gaps.
    """
    rng = np.random.default_rng(seed)
    structs: List[Tuple[Dict, Dict, Dict]] = []
    for s in range(n_structs):
        structs.append((spec_er(n, 2 + 2 * s, seed=100 + s),
                        spec_er(n, 2 + s, seed=200 + s),
                        spec_er_mask(n, max(4, n // 12), seed=300 + s)))
    if block_struct:
        bn = max(32, (n // 2) // 8 * 8)
        structs.append((spec_block(bn, 8, 0.5, 0.6, seed=400),
                        spec_block(bn, 8, 0.5, 0.6, seed=401),
                        spec_block(bn, 8, 0.6, 0.5, seed=402, mask=True)))

    cache: Dict = {}
    events: List[Dict] = []
    t = 0.0
    recent: List[Tuple[Dict, Dict, Dict]] = []
    for q in range(queries):
        if recent and rng.random() < repeat_fraction:
            sa, sb, sm = recent[int(rng.integers(len(recent)))]
        else:
            base_a, sb, sm = structs[int(rng.integers(len(structs)))]
            sa = spec_revalue(base_a, seed=1000 + q)
            recent.append((sa, sb, sm))
            if len(recent) > 8:
                recent.pop(0)
        A, B, M = (materialize(sa, cache), materialize(sb, cache),
                   materialize(sm, cache))
        events.append({
            "t": round(t, 9), "op": "submit", "A": sa, "B": sb, "M": sm,
            "semiring": "plus_times", "complement": False,
            "algorithm": None,
            "fp": {"A": fingerprint_digest(A), "B": fingerprint_digest(B),
                   "M": fingerprint_digest(M)},
        })
        t += float(rng.exponential(mean_gap_ms / 1e3))
    return Trace(name=name, events=events,
                 meta={"generator": "synthesize_trace", "n": n,
                       "n_structs": n_structs, "queries": queries,
                       "mean_gap_ms": mean_gap_ms, "seed": seed,
                       "block_struct": block_struct,
                       "repeat_fraction": repeat_fraction}).validate()


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


def _result_crc(res) -> int:
    """CRC of a served result's bytes (vals/present/mask_cols, or the
    complement's (vals, present) pair), copied to the host first: the
    byte-exactness witness."""
    if isinstance(res, tuple):
        parts = [to_numpy(p) for p in res]
    else:
        parts = [to_numpy(res.vals), to_numpy(res.present),
                 to_numpy(res.mask_cols)]
    crc = 0
    for p in parts:
        p = np.ascontiguousarray(p)
        crc = zlib.crc32(str((p.dtype, p.shape)).encode(), crc)
        crc = zlib.crc32(p.tobytes(), crc)
    return crc


@dataclasses.dataclass
class ReplayReport:
    """One deterministic replay's outcome.

    ``digest`` covers the bucket schedule, the deterministic counters, and
    every served result's bytes — two replays of one trace must produce
    EQUAL digests.  ``wall_s``/``qps``/``lat_*`` are real measurements
    (every route ends in a synchronise on a CUDA device) and are
    deliberately NOT part of the digest.
    """

    trace: str
    mode: str
    n_requests: int
    digest: str
    schedule: List[Dict]
    counters: Dict
    snapshot: Dict
    wall_s: float
    qps: float
    lat_p50_s: float
    lat_p99_s: float
    result_crcs: List[int]
    results: Optional[List] = None


def _advance(clock: VirtualClock, engine, target: float) -> None:
    """Advance virtual time to ``target`` and let the engine act on it."""
    clock.advance_to(max(target, clock.now()))
    engine.quiesce()


def replay_trace(trace: Trace, *, knobs: Optional[Dict] = None,
                 async_mode: bool = False, check: bool = True,
                 keep_results: bool = False,
                 result_timeout_s: float = 120.0,
                 device="cuda") -> ReplayReport:
    """Replay ``trace`` against a fresh engine on ``device`` under a
    virtual clock.

    ``knobs`` are ``QueryEngine`` constructor keywords (``max_batch``,
    ``max_wait_ms``, ``pad_factor``, ``queue_cap``, ...).  The replay
    submits each request at its recorded offset and steps the clock
    through every flush deadline in between, quiescing after each step —
    in async mode the worker thread acts on exactly the same virtual
    schedule the sync path executes inline via ``flush_due``, so the
    bucket sequence is identical across modes and across repeats.
    """
    from .engine import QueryEngine        # local: engine imports .clock

    events = trace.materialized(check=check)
    clock = VirtualClock()
    engine = QueryEngine(async_mode=async_mode, clock=clock, device=device,
                         **dict(knobs or {}))
    tickets = []
    t_real = time.perf_counter()  # lint: clock-ok(replay wall duration)
    try:
        for (t, A, B, M, kwargs) in events:
            # flush every deadline that falls before this arrival
            while True:
                d = engine.next_flush_deadline()
                if d is None or d > t:
                    break
                _advance(clock, engine, d + _DEADLINE_NUDGE)
            clock.advance_to(max(t, clock.now()))
            tickets.append(engine.submit(A, B, M, **kwargs))
            # a submit can fill a bucket (or, at max_wait_ms=0, make one
            # due immediately): drain before the trace proceeds, so bucket
            # composition never depends on worker timing
            engine.quiesce()
        # tail: step through the remaining deadlines
        while True:
            d = engine.next_flush_deadline()
            if d is None:
                break
            _advance(clock, engine, d + _DEADLINE_NUDGE)
        results = [tk.result(timeout=result_timeout_s) for tk in tickets]
        wall_s = time.perf_counter() - t_real  # lint: clock-ok(wall duration)
        snapshot = engine.metrics.snapshot()
        schedule = engine.metrics.bucket_schedule()
        counters = engine.metrics.deterministic_snapshot()
    finally:
        engine.close()

    crcs = [_result_crc(r) for r in results]
    digest_payload = json.dumps(
        {"schedule": schedule, "counters": counters, "results": crcs},
        sort_keys=True, separators=(",", ":"))
    digest = format(zlib.crc32(digest_payload.encode()), "08x")
    return ReplayReport(
        trace=trace.name, mode="async" if async_mode else "sync",
        n_requests=len(events), digest=digest, schedule=schedule,
        counters=counters, snapshot=snapshot, wall_s=wall_s,
        qps=len(events) / max(wall_s, 1e-12),
        lat_p50_s=snapshot["lat_p50_s"], lat_p99_s=snapshot["lat_p99_s"],
        result_crcs=crcs, results=results if keep_results else None)
