"""Structure-bucketed batching for the serving engine.

Requests are grouped by *bucket key*: the structural signatures of A and M,
the content fingerprint of B (the batched driver shares one B across a
batch, so B must be value-identical, while A/M only need equal structure
for one plan to be exact), the semiring, mask polarity and any forced
algorithm.  Every request in a bucket is served by ONE cached plan and,
for the row kernels, one batched row program.

Two flush policies bound latency: a bucket flushes when it reaches
``max_batch`` requests, and the async engine flushes any bucket whose
oldest member has waited ``max_wait``.

``merge_planned`` is the padding-aware second level: near-same-shape
buckets (same matrix dims, same B, same elected row algorithm) are merged
into one batch with pad widths widened to the group maxima; zero padding
is numerically neutral for the row kernels (length-guarded loops), so the
merged program returns the per-bucket results padded wider.  Buckets whose
widths differ by more than ``pad_factor`` stay separate.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.planner import Plan, structure_signature

from .cache import content_fingerprint


@dataclasses.dataclass
class Request:
    """One masked-SpGEMM query queued in the engine."""

    A: object
    B: object
    M: object
    semiring: object
    complement: bool
    algorithm: Optional[str]          # None = planner's auto
    mesh: Optional[object]            # core.distributed.Mesh => distributed
    axis: str
    ticket: object
    post: Optional[Callable]          # applied to the raw result
    cache_key: Optional[tuple]
    #: engine-clock time at submit, always supplied by the engine (a
    #: wall-clock default would break deterministic virtual-clock runs)
    submitted_at: float
    key: Optional[tuple] = None       # precomputed bucket key (engine)
    #: per-request trace id (None while tracing is disabled), carried so
    #: bucket-level spans can name their member requests
    trace_id: Optional[int] = None


def mesh_key(mesh, axis: str) -> Optional[tuple]:
    """Stable mesh identity: the axis, the axis sizes and the devices
    (never ``id()``, which a recycled address could alias inside a
    persistent cache key)."""
    if mesh is None:
        return None
    import numpy as _np
    return (axis, tuple(mesh.shape.items()),
            tuple(str(d) for d in _np.ravel(mesh.devices)))


def bucket_key(req: Request) -> tuple:
    return (structure_signature(req.A), content_fingerprint(req.B),
            structure_signature(req.M), req.semiring.name, req.complement,
            req.algorithm, mesh_key(req.mesh, req.axis))


class Batcher:
    """Bounded queue of buckets; thread-safe; no execution of its own."""

    def __init__(self, *, max_batch: int = 32):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._buckets: "OrderedDict[tuple, List[Request]]" = OrderedDict()
        self._pending = 0

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending

    def add(self, req: Request) -> Optional[List[Request]]:
        """Queue a request; returns a full bucket when this add filled one
        (the caller executes it), else None."""
        key = req.key if req.key is not None else bucket_key(req)
        with self._lock:
            # bucket keys are transient routing: every bucket drains within
            # one flush; the PLAN is looked up token-keyed at execute time
            # lint: plan-key-ok(transient routing, drains within one flush)
            bucket = self._buckets.setdefault(key, [])
            bucket.append(req)
            self._pending += 1
            if len(bucket) >= self.max_batch:
                del self._buckets[key]
                self._pending -= len(bucket)
                return bucket
        return None

    def rekey(self, old_key: tuple, new_key: tuple,
              rewrite=None) -> int:
        """Remap a still-queued bucket onto a new key (the delta path: a
        delta'd structure whose plan survived revalidation keeps its prior
        bucket, so pre-delta stragglers and post-delta arrivals flush as
        ONE batch).  ``rewrite``, when given, is applied to each moved
        request under the lock; the engine uses it to swap the shared
        operand references (B/M) onto the post-delta objects so a moved
        request really is a member of the new bucket.  The caller owns the
        safety argument: only requests whose payload (per-query A values)
        stays valid under the new key may be moved.  Returns the number of
        requests moved (0 when nothing was queued or the keys are equal).
        """
        if old_key == new_key:
            return 0
        with self._lock:
            bucket = self._buckets.pop(old_key, None)
            if bucket is None:
                return 0
            for r in bucket:
                r.key = new_key
                if rewrite is not None:
                    rewrite(r)
            self._buckets.setdefault(new_key, []).extend(bucket)
            return len(bucket)

    def pop_all(self) -> List[List[Request]]:
        """Drain every bucket, oldest-created first."""
        with self._lock:
            out = list(self._buckets.values())
            self._buckets.clear()
            self._pending = 0
        return out

    def pop_aged(self, max_wait_s: float, now: float) -> List[List[Request]]:
        """Drain buckets whose oldest request has waited >= ``max_wait_s``
        at engine-clock time ``now``."""
        out = []
        with self._lock:
            for key in list(self._buckets):
                bucket = self._buckets[key]
                if now - bucket[0].submitted_at >= max_wait_s:
                    del self._buckets[key]
                    self._pending -= len(bucket)
                    out.append(bucket)
        return out

    def has_aged(self, max_wait_s: float, now: float) -> bool:
        """True when some bucket's oldest request has waited >= ``max_wait_s``
        at engine-clock time ``now`` (what ``pop_aged`` would drain)."""
        with self._lock:
            return any(now - b[0].submitted_at >= max_wait_s
                       for b in self._buckets.values())

    def next_deadline(self) -> Optional[float]:
        """Clock time of the oldest queued request (None if empty)."""
        with self._lock:
            if not self._buckets:
                return None
            return min(b[0].submitted_at for b in self._buckets.values())


# ---------------------------------------------------------------------------
# Padding-aware merging of planned buckets
# ---------------------------------------------------------------------------


def _mergeable(reqs: Sequence[Request], plan: Plan) -> bool:
    r = reqs[0]
    return r.algorithm is None and plan.algorithm != "tile"


def _merge_signature(reqs: Sequence[Request], plan: Plan) -> tuple:
    r = reqs[0]
    # the bucket key's element [1] already holds B's content fingerprint
    b_fp = r.key[1] if r.key is not None else content_fingerprint(r.B)
    return (b_fp, r.A.shape, r.B.shape, r.M.shape,
            r.semiring.name, r.complement, plan.algorithm)


def merge_planned(groups: Sequence[Tuple[List[Request], Plan]],
                  pad_factor: float = 4.0
                  ) -> List[Tuple[List[Request], Plan, int]]:
    """Merge compatible (requests, plan) groups into wider batches.

    Returns ``(requests, plan, merged_from)`` triples; merged groups carry
    a plan whose pad widths are the element-wise maxima, so one row
    program fits every member.  Only auto-planned row-kernel groups merge,
    and only while each width stays within ``pad_factor`` of the group
    minimum.
    """
    out: List[Tuple[List[Request], Plan, int]] = []
    by_sig: "OrderedDict[tuple, List[Tuple[List[Request], Plan]]]" = \
        OrderedDict()
    for reqs, plan in groups:
        if _mergeable(reqs, plan):
            by_sig.setdefault(_merge_signature(reqs, plan), []).append(
                (reqs, plan))
        else:
            out.append((list(reqs), plan, 1))

    for members in by_sig.values():
        members = sorted(members, key=lambda g: g[1].widths)
        pool: List[Tuple[List[Request], Plan]] = []
        for g in members:
            if not pool:
                pool.append(g)
                continue
            lo = [min(p.widths[i] for _, p in pool + [g]) for i in range(3)]
            hi = [max(p.widths[i] for _, p in pool + [g]) for i in range(3)]
            if all(h <= pad_factor * max(1, l) for l, h in zip(lo, hi)):
                pool.append(g)
            else:
                out.append(_fuse(pool))
                pool = [g]
        if pool:
            out.append(_fuse(pool))
    return out


def _fuse(pool: List[Tuple[List[Request], Plan]]
          ) -> Tuple[List[Request], Plan, int]:
    if len(pool) == 1:
        reqs, plan = pool[0]
        return list(reqs), plan, 1
    reqs = [r for g, _ in pool for r in g]
    widths = tuple(max(p.widths[i] for _, p in pool) for i in range(3))
    plan = dataclasses.replace(pool[0][1], widths=widths)
    return reqs, plan, len(pool)
