"""Masked-SpGEMM query engine: submit/flush serving over the planner.

The paper's lesson is that structure-dependent decisions (accumulator
choice, mask layout) must be amortized; a serving layer amortizes them
across *queries*.  ``QueryEngine`` accepts a stream of masked-SpGEMM
requests, buckets them by structural signature (``batcher``), serves each
bucket through ONE cached plan, consults a bounded content-keyed result
cache first (``cache``), and records per-bucket latency/throughput
counters (``metrics``).  A bucket runs on ``device`` by one of four
routes:

* ``burst`` — a same-structure bucket on an msa/hash/mca plan replays a
  structure-compiled gather program over the whole bucket (``burst``);
* ``batched`` — the batched row driver (``masked_spgemm_batched``): the
  bucket's operands stacked along the rows, one row program;
* ``tile`` — a tile-elected (or tile-forced) bucket runs the tile route
  once per element;
* ``single`` — a one-request bucket goes through ``masked_spgemm``.

A request with ``mesh=`` (a ``core.distributed.Mesh``) is served by the
``distributed`` route instead, on the mesh's devices: the bucket's
requests go through ``distributed_masked_spgemm``, whose dist plan and ring
prep are signature-cached, so the bucket builds them once.

Every route ends in ``torch.cuda.synchronize`` on its CUDA devices, so
``serve.exec`` and the metrics time the device work, not its dispatch.

Modes:

* sync — ``submit()`` queues, ``flush()`` (or ``Ticket.result()``) drains.
* async — a worker thread flushes full buckets immediately and partial
  buckets after ``max_wait_ms``; ``submit()`` returns a future-like
  ``Ticket`` at once.

Backpressure: at most ``queue_cap`` requests may be pending.  The async
engine blocks the submitter until the worker drains; the sync engine
flushes inline.

``submit_delta`` folds edge-delta batches into the served operands
incrementally: plan revalidation, burst lane patching and row-scoped
result-cache invalidation instead of a cold restart.  ``recorder=`` (a
``trace.TraceRecorder``) captures every submit for deterministic replay.

Health: ``monitor=`` (a ``repro_torch.obs.HealthMonitor``) folds the span
stream into SLO burn rates and cost-model drift, and ``health()`` returns
its verdict; ``expose_port=`` serves ``/metrics`` and ``/health`` from a
daemon HTTP thread that reads host state only.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import caches, obs
from repro_torch.core import planner
from repro_torch.core.formats import CSR, CSRDelta, apply_csr_delta, tril
from repro_torch.core.masked_spgemm import (masked_spgemm,
                                            masked_spgemm_batched)
from repro_torch.core.semiring import PLUS_TIMES, Semiring

from . import burst
from .batcher import Batcher, Request, merge_planned, mesh_key
from .cache import (ResultCache, content_fingerprint, row_bitmap,
                    value_fingerprint)
from .clock import SystemClock
from .metrics import ServeMetrics

#: changed-row scratch for the delta path: incremental signatures memoized
#: per structure signature, so a chain of deltas updates each signature in
#: O(changed rows) instead of an O(m) recompute per step;
#: $REPRO_DELTA_SCRATCH_CAP overrides the capacity
_delta_scratch = caches.LRUCache("serve-delta-scratch", 64,
                                 env_var="REPRO_DELTA_SCRATCH_CAP")

#: full row coverage (every ``cache.ROW_BITMAP_BUCKETS`` bucket set): the
#: tag recorded for operands whose deltas cannot be row-scoped (B: one B
#: row feeds every output row)
_FULL_COVERAGE = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DeltaOutcome:
    """What ``QueryEngine.submit_delta`` did, and the operands to query
    with from now on."""

    A: CSR
    B: CSR
    M: CSR
    plan: planner.Plan
    plan_survived: bool          # revalidated in place (no cold re-plan)
    changed_rows: np.ndarray     # output rows the delta can affect
    lanes_patched: int           # burst lane columns re-emitted (0 = none)
    rows_invalidated: int        # affected output rows used to scope eviction
    entries_evicted: int         # result-cache entries actually evicted
    rekeyed: int                 # queued requests remapped onto the bucket
    signatures: Dict[str, tuple]  # per delta'd operand: incremental sig


class Ticket:
    """Future for one submitted request."""

    __slots__ = ("_engine", "_event", "_value", "_error")

    def __init__(self, engine: "QueryEngine"):
        self._engine = engine
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """The served result; blocks until available.

        In sync mode an unserved ticket triggers ``engine.flush()``; in
        async mode the worker's max-wait policy bounds the wait.
        """
        if not self._event.is_set() and not self._engine.async_mode:
            self._engine.flush()
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within timeout")
        if self._error is not None:
            raise self._error
        return self._value

    def _complete(self, value) -> None:
        self._value = value
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()


class QueryEngine:
    """Serving front-end for ``masked_spgemm`` and its graph composites,
    on ``device`` (default ``"cuda"``)."""

    # NOTE: engines register their result cache in ``repro_torch.caches``;
    # use the context manager (or call ``close()``) so a dropped engine
    # does not leave the registry referencing its cached results.
    def __init__(self, *, max_batch: int = 32, max_wait_ms: float = 2.0,
                 queue_cap: int = 1024, async_mode: bool = False,
                 merge_same_shape: bool = True, pad_factor: float = 4.0,
                 result_cache: Optional[ResultCache] = None,
                 cache_results: bool = True, use_burst: bool = True,
                 clock=None, recorder=None,
                 expose_port: Optional[int] = None,
                 monitor=None, device="cuda"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_cap < max_batch:
            raise ValueError(f"queue_cap ({queue_cap}) must be >= "
                             f"max_batch ({max_batch})")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if pad_factor < 1:
            raise ValueError(f"pad_factor must be >= 1, got {pad_factor} "
                             f"(1 disables width merging, it cannot shrink "
                             f"widths)")
        self.device = torch.device(device)
        if (self.device.type == "cuda" and self.device.index is None
                and torch.cuda.is_available()):
            # pinned here, so the async worker runs on the caller's card
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.async_mode = async_mode
        self.max_wait_s = max_wait_ms / 1e3
        self.queue_cap = queue_cap
        self.merge_same_shape = merge_same_shape
        self.pad_factor = pad_factor
        self.cache_results = cache_results
        self.use_burst = use_burst
        #: every time-dependent decision reads this clock; a VirtualClock
        #: here makes the flush schedule a pure function of the submissions
        self.clock = clock if clock is not None else SystemClock()
        #: trace recorder (``serving.trace.TraceRecorder``): observes every
        #: submit; None = no capture
        self.recorder = recorder
        #: health intelligence (``repro_torch.obs.health.HealthMonitor``):
        #: ``health()`` consults it and the exposition renders its
        #: repro_slo_* / repro_drift_* families.  The monitor only SEES
        #: spans while it is (or tees behind) the active tracing sink:
        #: ``with obs.tracing(monitor): ...``
        self.monitor = monitor
        self.metrics = ServeMetrics()
        self._owns_results = result_cache is None
        self.results = (result_cache if result_cache is not None
                        else ResultCache())
        self._batcher = Batcher(max_batch=max_batch)
        self._exec_lock = threading.Lock()
        # RLock: the worker holds _space while draining ready + aged work in
        # one atomic step (quiesce() must never observe the half-taken state)
        self._space = threading.Condition(threading.RLock())
        self.clock.attach(self._space)
        self._busy = False
        #: full buckets awaiting the worker (async mode only): kept out of
        #: the batcher so new same-key requests start a fresh bucket, but
        #: still counted against queue_cap for backpressure
        self._ready: List[List[Request]] = []
        self._ready_count = 0
        self._stop = False
        self._worker: Optional[threading.Thread] = None
        if async_mode:
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="repro-torch-serve-worker",
                                            daemon=True)
            self._worker.start()
        #: /metrics + /health exposition (``repro_torch.obs.serve``); port
        #: 0 binds an ephemeral port: read ``engine.obs_server.port``
        self.obs_server = None
        if expose_port is not None:
            from repro_torch.obs.serve import start_server
            self.obs_server = start_server(self, port=expose_port)

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Shut the exposition down, drain outstanding work, stop the
        worker, and drop the engine's own result cache from the process
        registry."""
        if self.obs_server is not None:
            self.obs_server.close()
            self.obs_server = None
        self.flush()
        # a sync engine has no worker to stop, but a closed engine must
        # still read as stopped (basic_verdict and /health key off it)
        with self._space:
            self._stop = True
            self._space.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
            self._worker = None
        self.clock.detach(self._space)
        if self._owns_results:
            self.results.unregister()

    def __enter__(self) -> "QueryEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def health(self):
        """This engine's :class:`repro_torch.obs.health.HealthVerdict`.

        With a :class:`~repro_torch.obs.health.HealthMonitor` attached the
        verdict folds liveness, every SLO's multi-window burn rate and
        cost-model drift; without one it is liveness only.  ``/health``
        serves exactly this (503 while ``failing``)."""
        from repro_torch.obs.health import basic_verdict
        if self.monitor is not None:
            return self.monitor.verdict(engine=self)
        return basic_verdict(self)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- submission ---------------------------------------------------------

    def submit(self, A, B, M, *, semiring: Semiring = PLUS_TIMES,
               complement: bool = False, algorithm: Optional[str] = None,
               mesh=None, axis: str = "data",
               post: Optional[Callable] = None) -> Ticket:
        """Queue C = M (.) (A B); returns a future-like ``Ticket``.

        ``algorithm=None`` lets the planner decide (bucket-wide); a string
        forces that algorithm (``"tile"``, a row kernel, or, with ``mesh``,
        ``"row"``/``"ring"``).  ``mesh`` (a ``core.distributed.Mesh``)
        serves the request across the mesh's devices along ``axis``.
        ``post`` transforms the raw result before it reaches
        ``Ticket.result()`` (composites use it).
        """
        ticket = Ticket(self)
        self.metrics.record_submit()
        submitted_at = self.clock.now()
        # measurement, not scheduling: hit latency must be real elapsed
        # time even under a frozen virtual clock
        t_sub = time.perf_counter()  # lint: clock-ok(hit latency measurement)
        trace_id = obs.new_trace()   # None while tracing is disabled
        if trace_id is not None:
            obs.event("serve.submit", trace=trace_id,
                      shape=list(M.shape), complement=complement,
                      algorithm=algorithm, mesh=mesh is not None)
        if self.recorder is not None:
            self.recorder.on_submit(A, B, M, t=submitted_at,
                                    semiring=semiring, complement=complement,
                                    algorithm=algorithm, mesh=mesh, axis=axis)
        key = bkey = None
        if (isinstance(A, CSR) and isinstance(B, CSR)
                and isinstance(M, CSR)):
            # one fingerprint pass feeds BOTH keys: the bucket key (A/M by
            # structure, B by content) and the result key (all by content)
            sa = planner.structure_signature(A)
            sm = planner.structure_signature(M)
            cb = content_fingerprint(B)
            mk = mesh_key(mesh, axis)
            bkey = (sa, cb, sm, semiring.name, complement, algorithm, mk)
            if self.cache_results and not complement:
                # only host-CSR, mask-bounded results are cached: device
                # operands hash by id (GC could recycle it) and complement
                # results are dense (m, n) pairs.  A result lives on the
                # engine's device, or on the mesh's first device
                key = ((sa,) + value_fingerprint(A), cb,
                       (sm,) + value_fingerprint(M), semiring.name,
                       complement, algorithm,
                       str(self.device) if mesh is None else mk,
                       planner.cost_model_token())
                hit = self.results.get(key)
                if hit is not None:
                    # lint: clock-ok(hit latency measurement)
                    hit_s = time.perf_counter() - t_sub
                    self.metrics.record_cache_hit(latency_s=hit_s)
                    obs.event("serve.cache_hit", dur_s=hit_s,
                              trace=trace_id)
                    obs.counter("serve.cache_hit_rate",
                                self.metrics.hit_rate())
                    ticket._complete(post(hit) if post is not None else hit)
                    return ticket
        req = Request(A=A, B=B, M=M, semiring=semiring,
                      complement=complement, algorithm=algorithm, mesh=mesh,
                      axis=axis, ticket=ticket, post=post, cache_key=key,
                      key=bkey, submitted_at=submitted_at,
                      trace_id=trace_id)
        self._admit(req)
        if trace_id is not None:
            obs.counter("serve.queue_depth", self._pending())
        return ticket

    def submit_triangle(self, adj: CSR, *, relabel: bool = True,
                        algorithm: Optional[str] = None) -> Ticket:
        """Triangle count of an undirected graph as a served query
        (paper §8.2: #tri = sum(L .* (L @ L))).  ``Ticket.result()`` is the
        integer count, summed in float64 as ``triangle_count`` sums it; the
        underlying product batches/caches like any other request with
        A = B = M = L."""
        from repro_torch.graphs.triangle_counting import degree_relabel
        a = degree_relabel(adj) if relabel else adj
        L = tril(a, strict=True)

        def count(res) -> int:
            return int(round(float(torch.where(res.present, res.vals, 0)
                                   .sum(dtype=torch.float64))))

        return self.submit(L, L, L, algorithm=algorithm, post=count)

    def submit_delta(self, A: CSR, B: CSR, M: CSR, *,
                     delta_a: Optional[CSRDelta] = None,
                     delta_b: Optional[CSRDelta] = None,
                     delta_m: Optional[CSRDelta] = None,
                     semiring: Semiring = PLUS_TIMES,
                     complement: bool = False,
                     algorithm: Optional[str] = None,
                     rebase_queued: bool = False) -> DeltaOutcome:
        """Fold edge-delta batches into served operands without restarting
        the serving state from cold.

        ``A``/``B``/``M`` are the current (pre-delta) operands; each
        ``delta_*`` is a :class:`repro_torch.core.formats.CSRDelta` (or
        None).  The engine:

        * applies the deltas (``apply_csr_delta``), maintaining each
          operand's incremental structure signature in O(changed rows)
          through a memo keyed by structure signature;
        * revalidates the operands' plan (``planner.revalidate``): a
          row-local delta keeps the plan, stamped into the plan cache
          under the post-delta key, so later ``submit`` calls hit;
        * patches the burst program's lane columns instead of rebuilding
          it when the plan survived and a pre-delta program is cached
          (``burst.patch_program``), and records the lineage so an evicted
          patch can be re-derived later;
        * invalidates result-cache entries scoped to the delta'd
          structures AND the affected row coverage: entries of unrelated
          structures sharing this engine stay cached;
        * optionally (``rebase_queued=True``) remaps still-queued requests
          of the pre-delta bucket onto the post-delta bucket, swapping the
          shared B/M references so those queries are answered against the
          post-delta operands (read-your-writes).  Only taken when A's
          structure is unchanged, so per-query A payloads stay valid under
          the new bucket key.  Rebased requests drop their result key (it
          fingerprinted the pre-delta operands).

        Counters land in ``metrics.snapshot()``: ``delta_applied``,
        ``plans_revalidated``, ``lanes_patched``, ``rows_invalidated``.
        Returns a :class:`DeltaOutcome`; query with its ``A``/``B``/``M``
        from now on.
        """
        if not (isinstance(A, CSR) and isinstance(B, CSR)
                and isinstance(M, CSR)):
            raise TypeError("submit_delta requires host-CSR operands")
        if delta_a is None and delta_b is None and delta_m is None:
            raise ValueError("submit_delta needs at least one delta")
        old_ops = {"A": A, "B": B, "M": M}
        deltas = {"A": delta_a, "B": delta_b, "M": delta_m}
        sig_old = {k: planner.structure_signature(v)
                   for k, v in old_ops.items()}
        new_ops = dict(old_ops)
        signatures: Dict[str, tuple] = {}
        changed: Dict[str, np.ndarray] = {}
        values_only = {"A": True, "B": True, "M": True}
        applied = 0
        with obs.span("delta.apply") as sp:
            for name in ("A", "B", "M"):
                d = deltas[name]
                if d is None:
                    changed[name] = np.zeros(0, np.int64)
                    continue
                isig = _delta_scratch.get(
                    ("isig", sig_old[name]))  # lint: plan-key-ok(isig memo)
                res = apply_csr_delta(old_ops[name], d, old_signature=isig)
                new_ops[name] = res.csr
                changed[name] = res.changed_rows
                values_only[name] = res.values_only
                signatures[name] = res.signature
                _delta_scratch.put(
                    ("isig", planner.structure_signature(res.csr)),
                    res.signature)  # lint: plan-key-ok(isig memo)
                applied += 1
            sp.set(applied=applied)
        A1, B1, M1 = new_ops["A"], new_ops["B"], new_ops["M"]
        dev = self.device

        # plan lifecycle: revalidate the pre-delta plan onto the post-delta
        # operands; a surviving plan is stamped under the post-delta cache
        # key inside revalidate(), so the serve path's plan() call hits
        with obs.span("delta.revalidate") as sp:
            old_plan = planner.plan(A, B, M, complement=complement,
                                    semiring=semiring, device=dev)
            new_plan, survived = planner.revalidate(
                old_plan, A1, B1, M1, complement=complement,
                semiring=semiring, device=dev)
            sp.set(survived=survived, algorithm=new_plan.algorithm)

        # burst lifecycle: patch the program's changed lane columns instead
        # of rebuilding it, when the delta is row-local on A/M and B's
        # structure is intact (a values-only B change regathers)
        lanes = 0
        union = np.union1d(changed["A"], changed["M"]).astype(np.int64)
        if (survived and algorithm is None and self.use_burst
                and values_only["B"]
                and burst.burst_eligible(new_plan.algorithm, complement,
                                         A1, B1, M1)):
            with obs.span("delta.lane_patch") as sp:
                parent = burst.peek_program(A, B, M, semiring,
                                            old_plan.widths[2], dev)
                if parent is not None:
                    prog, lanes = burst.patch_program(
                        parent, A1, B1, M1, semiring, new_plan.widths[2],
                        union, dev)
                    if prog is not None:
                        burst.record_lineage(A1, B1, M1, semiring,
                                             new_plan.widths[2], parent,
                                             union, dev)
                sp.set(lanes=int(lanes), had_parent=parent is not None)

        # result-cache lifecycle: evict by (structure, row coverage); a B
        # delta can affect every output row, so it is never row-scoped
        m_rows = A.shape[0]
        evicted = 0
        with obs.span("delta.invalidate") as sp:
            if delta_a is not None:
                evicted += self.results.invalidate(
                    sig_old["A"], row_bitmap(changed["A"], m_rows))
            if delta_m is not None:
                evicted += self.results.invalidate(
                    sig_old["M"], row_bitmap(changed["M"], m_rows))
            if delta_b is not None:
                evicted += self.results.invalidate(sig_old["B"], None)
            sp.set(evicted=int(evicted))
        rows = int(m_rows if delta_b is not None else len(union))
        self.metrics.record_delta(applied=applied,
                                  revalidated=int(survived),
                                  lanes=int(lanes), rows=rows)

        rekeyed = 0
        if rebase_queued and survived and values_only["A"]:
            mk = None
            old_bkey = (sig_old["A"], content_fingerprint(B), sig_old["M"],
                        semiring.name, complement, algorithm, mk)
            new_bkey = (sig_old["A"], content_fingerprint(B1),
                        planner.structure_signature(M1), semiring.name,
                        complement, algorithm, mk)

            def _rebase(r):
                r.B = B1
                r.M = M1
                r.cache_key = None

            rekeyed = self._batcher.rekey(old_bkey, new_bkey, _rebase)

        return DeltaOutcome(
            A=A1, B=B1, M=M1, plan=new_plan, plan_survived=survived,
            changed_rows=union, lanes_patched=int(lanes),
            rows_invalidated=rows, entries_evicted=int(evicted),
            rekeyed=int(rekeyed), signatures=signatures)

    def serve(self, requests: Sequence[tuple]) -> List:
        """Sync convenience: submit ``(A, B, M)`` (or ``(A, B, M, kwargs)``)
        tuples, flush once, return results in order."""
        tickets = []
        for r in requests:
            kwargs = r[3] if len(r) > 3 else {}
            tickets.append(self.submit(r[0], r[1], r[2], **kwargs))
        self.flush()
        return [t.result() for t in tickets]

    def _pending(self) -> int:
        # _space (RLock) also orders _ready_count against the worker's
        # _take_ready decrement
        with self._space:
            return self._batcher.pending + self._ready_count

    def _admit(self, req: Request) -> None:
        """Bounded-queue admission: block (async) or flush inline (sync)
        while the queue is at capacity, then enqueue.  A bucket filled to
        max_batch executes at once in sync mode; in async mode it is
        handed to the worker so submit() stays non-blocking."""
        while True:
            if self._pending() < self.queue_cap:
                break
            if self.async_mode:
                with self._space:
                    if self._pending() >= self.queue_cap and not self._stop:
                        self._space.wait(timeout=0.05)
            else:
                self.flush()
        full = self._batcher.add(req)
        if full is not None:
            if self.async_mode:
                with self._space:
                    self._ready.append(full)
                    self._ready_count += len(full)
                    self._space.notify_all()
            else:
                self._execute_bucket(full)
        elif self.async_mode:
            with self._space:
                self._space.notify_all()

    def _take_ready(self) -> List[List[Request]]:
        with self._space:
            out, self._ready = self._ready, []
            self._ready_count = 0
        return out

    # -- flushing -----------------------------------------------------------

    def flush(self) -> None:
        """Execute every queued bucket (one plan each; mergeable
        same-shape row buckets fuse into wider batches first)."""
        buckets = self._take_ready() + self._batcher.pop_all()
        if not buckets:
            return
        self._execute_many(buckets)
        with self._space:
            self._space.notify_all()

    def flush_due(self) -> int:
        """Execute exactly the work the async worker's policy would execute
        NOW: full buckets plus buckets older than ``max_wait_ms`` at the
        clock's current time.  Returns the number of requests served."""
        work = self._take_ready() + self._batcher.pop_aged(
            self.max_wait_s, now=self.clock.now())
        if not work:
            return 0
        self._execute_many(work)
        with self._space:
            self._space.notify_all()
        return sum(len(b) for b in work)

    def next_flush_deadline(self) -> Optional[float]:
        """Clock time at which the oldest queued bucket becomes due
        (None when nothing is queued)."""
        d = self._batcher.next_deadline()
        return None if d is None else d + self.max_wait_s

    def quiesce(self, timeout: float = 30.0) -> None:
        """Block until no *due* work remains: the ready queue is empty, the
        worker is idle, and no bucket has outlived ``max_wait_ms`` at the
        clock's current time.  Pending-but-not-due buckets stay queued.
        Sync engines serve due work inline."""
        if not self.async_mode:
            self.flush_due()
            return
        # the watchdog deadline is real time by design: it bounds how long
        # we wait for the worker thread, even under a frozen virtual clock
        end = time.perf_counter() + timeout  # lint: clock-ok(watchdog)
        with self._space:
            while (self._ready or self._busy
                   or self._batcher.has_aged(self.max_wait_s,
                                             now=self.clock.now())):
                if time.perf_counter() >= end:  # lint: clock-ok(watchdog)
                    raise TimeoutError(
                        "engine did not quiesce within "
                        f"{timeout}s (worker stuck or stopped?)")
                self._space.wait(timeout=0.05)

    def _worker_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._space:
                if self._stop:
                    return
                deadline = self._batcher.next_deadline()
                # full buckets are ready now; empty queue sleeps until a
                # submit notifies; otherwise wake at the oldest bucket's
                # max-wait deadline
                wait = (None if deadline is None else
                        max(0.0, deadline + self.max_wait_s
                            - self.clock.now()))
                if not self._ready and (wait is None or wait > 0):
                    self.clock.wait_on(self._space, wait)
                if self._stop:
                    return
                # take ready + aged work and mark busy in ONE _space
                # critical section: quiesce() must never see the gap
                work = self._take_ready() + self._batcher.pop_aged(
                    self.max_wait_s, now=self.clock.now())
                if work:
                    self._busy = True
            if work:
                try:
                    self._execute_many(work)
                finally:
                    with self._space:
                        self._busy = False
                        self._space.notify_all()

    # -- execution ----------------------------------------------------------

    def _plan(self, r: Request) -> planner.Plan:
        return planner.plan(r.A, r.B, r.M, complement=r.complement,
                            semiring=r.semiring, device=self.device)

    def _execute_many(self, buckets: List[List[Request]]) -> None:
        if not self.merge_same_shape:
            for bucket in buckets:
                self._execute_bucket(bucket)
            return
        planned, direct, forced_row = [], [], []
        for bucket in buckets:
            r = bucket[0]
            if r.mesh is None and r.algorithm is None:
                t0 = time.perf_counter()  # lint: clock-ok(plan duration)
                try:
                    plan = self._plan(r)
                except Exception as e:
                    self._fail_bucket(bucket, e)
                    continue
                planned.append(  # lint: clock-ok(plan duration)
                    ((bucket, plan), time.perf_counter() - t0))
                if obs.enabled():
                    # explain() rides every plan event so traces carry
                    # modeled costs next to measured exec durations
                    obs.event("serve.plan", dur_s=planned[-1][1],
                              algorithm=plan.algorithm,
                              explain=planner.explain_cached(plan),
                              traces=[q.trace_id for q in bucket])
            elif r.mesh is None and r.algorithm != "tile":
                forced_row.append(bucket)
            else:
                direct.append(bucket)
        for bucket in direct:
            self._execute_bucket(bucket)
        # forced row-kernel buckets sharing B/shape/options fuse without a
        # plan: the batched driver widens pad widths to the batch maxima
        groups: dict = {}
        for bucket in forced_row:
            r = bucket[0]
            b_fp = (r.key[1] if r.key is not None
                    else content_fingerprint(r.B))
            sig = (b_fp, r.A.shape, r.M.shape, r.semiring.name,
                   r.complement, r.algorithm)
            groups.setdefault(sig, []).append(bucket)
        for members in groups.values():
            self._execute_bucket([q for b in members for q in b],
                                 merged_from=len(members))
        merged = merge_planned([g for g, _ in planned],
                               pad_factor=self.pad_factor)
        plan_s = sum(dt for _, dt in planned) / max(1, len(merged))
        for reqs, plan, merged_from in merged:
            self._execute_bucket(reqs, plan=plan, plan_s=plan_s,
                                 merged_from=merged_from)

    def _fail_bucket(self, reqs: List[Request], err: BaseException) -> None:
        self.metrics.record_failure(len(reqs))
        if obs.enabled():
            # one serve.error per request: errors count per request, not
            # per bucket
            for r in reqs:
                obs.event("serve.error", trace=r.trace_id,
                          error=type(err).__name__)
            obs.counter("serve.inflight", 0)
        for r in reqs:
            r.ticket._fail(err)

    def _execute_bucket(self, reqs: List[Request],
                        plan: Optional[planner.Plan] = None,
                        plan_s: float = 0.0, merged_from: int = 1) -> None:
        """Serve one bucket: every request shares structure (or, merged,
        shape + algorithm), so one plan covers all of them."""
        # queue wait is CLOCK time (virtual under a VirtualClock);
        # execution is always a real duration
        t_in = self.clock.now()
        queue_wait = t_in - min(r.submitted_at for r in reqs)
        if obs.enabled():
            obs.counter("serve.inflight", len(reqs))
        t_exec = time.perf_counter()  # lint: clock-ok(exec duration)
        with self._exec_lock:
            try:
                if reqs[0].mesh is not None:
                    results, route, algo = self._run_distributed(reqs)
                else:
                    results, route, algo, plan = self._run_local(
                        reqs, plan, uniform=(merged_from == 1))
            except Exception as e:
                self._fail_bucket(reqs, e)
                return
            # lint: clock-ok(exec duration)
            exec_s = time.perf_counter() - t_exec
        if obs.enabled():
            traces = [r.trace_id for r in reqs]
            obs.event("serve.queue_wait", dur_s=queue_wait, traces=traces)
            modeled = regime = None
            if plan is not None:
                by_name = dict(plan.costs)
                if algo in by_name:
                    modeled = float(by_name[algo])
                regime = planner.feature_regime(plan)
            obs.event("serve.exec", dur_s=exec_s, route=route,
                      algorithm=algo, size=len(reqs),
                      merged_from=merged_from, modeled_ms=modeled,
                      regime=regime, traces=traces)
            obs.counter("serve.inflight", 0)
            obs.counter("serve.cache_hit_rate", self.metrics.hit_rate())
        self.metrics.record_bucket(
            size=len(reqs), algorithm=algo, route=route,
            queue_wait_s=queue_wait, plan_s=plan_s, exec_s=exec_s,
            merged_from=merged_from,
            latencies_s=[(t_in - r.submitted_at) + exec_s for r in reqs])
        # Only uniform buckets' results are cached: width-merged buckets
        # return results padded to the MERGED width, not the shape a fresh
        # one-shot call produces, and a hit must be byte-exact.  The token
        # re-check guards the submit->execute window.
        cacheable = self.cache_results and merged_from == 1
        token = planner.cost_model_token() if cacheable else None
        # scoped-invalidation tags: the entry depends on A and M only where
        # the mask has entries (a delta confined to mask-empty rows cannot
        # change the result), and on EVERY row of B (one B row feeds any
        # output row).  cache_key components [0][0]/[1][0]/[2][0] are the
        # operands' structure signatures, shared across the bucket.
        rep = reqs[0]
        cover = (row_bitmap(np.nonzero(np.diff(rep.M.indptr))[0],
                            rep.M.shape[0])
                 if cacheable and rep.cache_key is not None else 0)
        cache_puts = 0
        for r, res in zip(reqs, results):
            if (cacheable and r.cache_key is not None
                    and r.cache_key[-1] == token):
                self.results.put(r.cache_key, res, tags=(
                    (r.cache_key[0][0], cover),
                    (r.cache_key[1][0], _FULL_COVERAGE),
                    (r.cache_key[2][0], cover)))
                cache_puts += 1
            # a raising post callback must fail ONLY its own ticket
            try:
                value = res if r.post is None else r.post(res)
            except Exception as e:
                self.metrics.record_failure(1)
                obs.event("serve.error", trace=r.trace_id,
                          error=type(e).__name__)
                r.ticket._fail(e)
                continue
            r.ticket._complete(value)
        if cache_puts:
            obs.event("serve.result_cache_put", count=cache_puts)

    def _run_distributed(self, reqs: List[Request]):
        """Mesh-carrying bucket: the distributed plan and the ring's prep
        are signature-cached, so the bucket pays for them once.  Ends in a
        synchronise on each of the mesh's CUDA devices."""
        from repro_torch.core.distributed import distributed_masked_spgemm
        rep = reqs[0]
        algo = rep.algorithm or "auto"
        out = [distributed_masked_spgemm(
            r.A, r.B, r.M, r.mesh, algorithm=algo, axis=r.axis,
            semiring=r.semiring, complement=r.complement) for r in reqs]
        for dev in {str(d): d for d in rep.mesh.devices}.values():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if algo == "auto":
            algo = planner.plan_distributed(
                rep.A, rep.B, rep.M, int(rep.mesh.shape[rep.axis]),
                complement=rep.complement, semiring=rep.semiring).route
        return out, "distributed", algo

    def _run_local(self, reqs: List[Request],
                   plan: Optional[planner.Plan], uniform: bool = True):
        rep = reqs[0]
        forced = rep.algorithm
        dev = self.device
        if plan is None and forced is None:
            plan = self._plan(rep)
        algo = forced if forced is not None else plan.algorithm

        if (uniform and forced is None and self.use_burst
                and burst.burst_eligible(algo, rep.complement, rep.A,
                                         rep.B, rep.M)):
            # same-structure bucket on a sequential-scatter plan: the
            # structure-compiled replay serves the whole bucket at once,
            # bitwise the plan's row kernel (run() synchronises)
            prog = burst.get_program(rep.A, rep.B, rep.M, rep.semiring,
                                     wm=plan.widths[2], device=dev)
            if prog is not None:
                out = prog.run([r.A for r in reqs])
                return out, "burst", algo, plan

        if algo == "tile":
            # tile-elected: the batched driver runs the plan per element.
            # Forced tile (plan None) goes through the one-shot driver,
            # complement passing through so it raises like a direct call
            if plan is not None and not rep.complement:
                out = masked_spgemm_batched(
                    [r.A for r in reqs], rep.B, [r.M for r in reqs],
                    semiring=rep.semiring, plan=plan, device=dev)
            else:
                out = [masked_spgemm(r.A, r.B, r.M, algorithm="tile",
                                     semiring=r.semiring,
                                     complement=r.complement, plan=plan,
                                     device=dev)
                       for r in reqs]
            self._sync()
            return out, "tile", "tile", plan

        if len(reqs) == 1:
            out = [masked_spgemm(rep.A, rep.B, rep.M,
                                 algorithm=forced or "auto",
                                 semiring=rep.semiring,
                                 complement=rep.complement, plan=plan,
                                 device=dev)]
            route = "single"
        else:
            raw = masked_spgemm_batched(
                [r.A for r in reqs], rep.B, [r.M for r in reqs],
                algorithm=forced or "auto", semiring=rep.semiring,
                complement=rep.complement, plan=plan, device=dev)
            if rep.complement:
                vals, present = raw
                out = [(vals[i], present[i]) for i in range(len(reqs))]
            else:
                out = raw
            route = "batched"
        self._sync()
        return out, route, algo, plan

