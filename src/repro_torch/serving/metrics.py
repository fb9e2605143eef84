"""Serving metrics: per-bucket latency/throughput counters.

The engine records one event per submitted request and one per executed
bucket; ``snapshot()`` renders the counters.  Everything is host wall
time, the quantity a serving SLO sees: planner, host prep and device
execution (ended by a synchronise on a CUDA device) included.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Sequence

#: per-bucket records kept for inspection (ring buffer, oldest dropped)
BUCKET_LOG_CAPACITY = 256

#: per-request latency samples kept for percentile reporting (ring buffer)
LATENCY_RESERVOIR_CAPACITY = 65536

#: snapshot() keys that are pure functions of the request stream and the
#: engine's scheduling decisions — no wall-clock durations
DETERMINISTIC_KEYS = ("submitted", "completed", "failed",
                      "result_cache_hits", "buckets_executed",
                      "batched_requests", "mean_batch", "max_batch",
                      "merged_groups")

#: bucket-log keys that are scheduling decisions, not timings
SCHEDULE_KEYS = ("size", "algorithm", "route", "merged_from", "label")


class ServeMetrics:
    """Thread-safe counters for one ``QueryEngine``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.submitted = 0
            self.completed = 0
            self.failed = 0
            self.result_cache_hits = 0
            self.buckets_executed = 0
            self.batched_requests = 0
            self.max_batch_seen = 0
            self.queue_wait_s = 0.0
            self.plan_s = 0.0
            self.exec_s = 0.0
            self.merged_groups = 0
            # delta-path counters, not in DETERMINISTIC_KEYS: deltas arrive
            # outside the request stream, so a replay of a request trace is
            # not held to them
            self.delta_applied = 0
            self.plans_revalidated = 0
            self.lanes_patched = 0
            self.rows_invalidated = 0
            self._bucket_log: deque = deque(maxlen=BUCKET_LOG_CAPACITY)
            self._latencies: deque = deque(maxlen=LATENCY_RESERVOIR_CAPACITY)
            self._hit_latencies: deque = deque(
                maxlen=LATENCY_RESERVOIR_CAPACITY)

    # -- recording ----------------------------------------------------------

    def record_submit(self, n: int = 1) -> None:
        with self._lock:
            self.submitted += n

    def record_cache_hit(self, latency_s: Optional[float] = None) -> None:
        """One result-cache hit.  Hits complete without touching the
        bucket path, so their latencies land in a reservoir of their own;
        ``snapshot()`` reports hit, miss and combined percentiles."""
        with self._lock:
            self.result_cache_hits += 1
            self.completed += 1
            if latency_s is not None:
                self._hit_latencies.append(float(latency_s))

    def record_failure(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    def record_delta(self, *, applied: int = 0, revalidated: int = 0,
                     lanes: int = 0, rows: int = 0) -> None:
        """One ``submit_delta`` outcome: ``applied`` operand deltas folded
        in, ``revalidated`` plans kept without a cold re-plan, ``lanes``
        burst lane columns re-emitted by a patch (instead of a program
        rebuild), ``rows`` result-cache row coverage invalidated."""
        with self._lock:
            self.delta_applied += applied
            self.plans_revalidated += revalidated
            self.lanes_patched += lanes
            self.rows_invalidated += rows

    def record_bucket(self, *, size: int, algorithm: str, route: str,
                      queue_wait_s: float, plan_s: float, exec_s: float,
                      merged_from: int = 1,
                      label: Optional[str] = None,
                      latencies_s: Optional[Sequence[float]] = None) -> None:
        """One executed bucket: ``size`` requests served by one plan.

        ``queue_wait_s`` is the oldest member's submit-to-execute wait;
        ``plan_s`` covers planning + bucket bookkeeping, ``exec_s`` the
        product itself (host prep + device, ended by a synchronise).
        ``latencies_s`` carries each member's submit-to-served latency
        (queue wait + execution) for the percentile reservoir.
        """
        with self._lock:
            if latencies_s is not None:
                self._latencies.extend(float(x) for x in latencies_s)
            self.buckets_executed += 1
            self.batched_requests += size
            self.completed += size
            self.max_batch_seen = max(self.max_batch_seen, size)
            self.queue_wait_s += queue_wait_s
            self.plan_s += plan_s
            self.exec_s += exec_s
            if merged_from > 1:
                self.merged_groups += merged_from - 1
            self._bucket_log.append({
                "size": size, "algorithm": algorithm, "route": route,
                "queue_wait_s": queue_wait_s, "plan_s": plan_s,
                "exec_s": exec_s, "merged_from": merged_from,
                "label": label})

    # -- reading ------------------------------------------------------------

    @staticmethod
    def _percentile(samples: List[float], q: float) -> float:
        """Nearest-rank percentile."""
        if not samples:
            return 0.0
        ordered = sorted(samples)
        idx = min(len(ordered) - 1, max(0, int(round(
            q / 100.0 * (len(ordered) - 1)))))
        return ordered[idx]

    def snapshot(self) -> Dict:
        with self._lock:
            miss = list(self._latencies)
            hit = list(self._hit_latencies)
            lat = miss + hit
            done = self.buckets_executed
            return {
                "lat_count": len(lat),
                "lat_p50_s": self._percentile(lat, 50.0),
                "lat_p99_s": self._percentile(lat, 99.0),
                "miss_lat_count": len(miss),
                "miss_lat_p50_s": self._percentile(miss, 50.0),
                "miss_lat_p99_s": self._percentile(miss, 99.0),
                "hit_lat_count": len(hit),
                "hit_lat_p50_s": self._percentile(hit, 50.0),
                "hit_lat_p99_s": self._percentile(hit, 99.0),
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "result_cache_hits": self.result_cache_hits,
                "buckets_executed": done,
                "batched_requests": self.batched_requests,
                "mean_batch": (self.batched_requests / done) if done else 0.0,
                "max_batch": self.max_batch_seen,
                "merged_groups": self.merged_groups,
                "delta_applied": self.delta_applied,
                "plans_revalidated": self.plans_revalidated,
                "lanes_patched": self.lanes_patched,
                "rows_invalidated": self.rows_invalidated,
                "queue_wait_s": self.queue_wait_s,
                "plan_s": self.plan_s,
                "exec_s": self.exec_s,
                "mean_bucket_exec_s": (self.exec_s / done) if done else 0.0,
            }

    def hit_rate(self) -> float:
        """Lifetime result-cache hit rate over submissions (the value of
        the ``serve.cache_hit_rate`` counter track)."""
        with self._lock:
            if not self.submitted:
                return 0.0
            return self.result_cache_hits / self.submitted

    def error_rate(self) -> float:
        """Lifetime failed fraction of finished requests."""
        with self._lock:
            total = self.completed + self.failed
            return (self.failed / total) if total else 0.0

    def bucket_log(self):
        with self._lock:
            return list(self._bucket_log)

    def deterministic_snapshot(self) -> Dict:
        """The scheduling-only projection of :meth:`snapshot`: counters that
        are pure functions of the request stream + flush decisions, with
        every wall-clock duration dropped."""
        snap = self.snapshot()
        return {k: snap[k] for k in DETERMINISTIC_KEYS}

    def bucket_schedule(self) -> List[Dict]:
        """The bucket log's scheduling-only projection (sizes, algorithms,
        routes, merge arity — no timings), in execution order."""
        with self._lock:
            return [{k: row[k] for k in SCHEDULE_KEYS}
                    for row in self._bucket_log]
