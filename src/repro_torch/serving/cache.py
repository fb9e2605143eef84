"""Bounded result cache for served masked-SpGEMM queries.

Keys are *content* fingerprints (structure CRC + value-byte CRC per
operand) plus the planner's ``cost_model_token()``: two requests share an
entry iff their operands are byte-identical and the cost model that would
plan them is unchanged, so a hit is bitwise the result a fresh computation
would produce.  This layers over the structure-keyed caches (plan cache,
burst programs): a result-cache miss still reuses all of those.

The cache is a ``repro_torch.caches.LRUCache``: bounded by entry count,
thread-safe, visible to ``repro_torch.caches.cache_info()`` and emptied by
``clear_all()``.  Its entries hold device tensors (a mask-aligned result:
``vals`` (m, pm) f32, ``present`` and ``mask_cols``), so its device memory
is the capacity times the bytes of one result.  An evicted or invalidated
entry drops the cache's reference; its tensors are freed once no caller
holds the result either.

Entries may carry tags (operand structure signatures with a coarse row
coverage) so a delta evicts only the entries it can affect
(``invalidate``).
"""
from __future__ import annotations

import threading
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import caches, obs
from repro_torch.core.formats import CSR, PaddedCSR
from repro_torch.core.planner import structure_signature

#: default result-cache entries; $REPRO_RESULT_CACHE_CAP overrides
DEFAULT_CAPACITY = 256


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def value_fingerprint(x: CSR) -> tuple:
    """Value-only part of the content identity (the structure signature is
    the other part; callers that already hold it avoid re-CRCing the index
    arrays)."""
    return (_crc(x.data), str(x.data.dtype))


def content_fingerprint(x) -> tuple:
    """Content identity of an operand: equal fingerprints => byte-equal
    structure AND values (up to CRC collision).  ``PaddedCSR`` operands live
    on a device; hashing them would force a transfer, so they are
    identified by object id, valid ONLY while the object is referenced
    (the batcher's queued Requests hold one): the engine buckets such
    requests but never result-caches them.
    """
    if isinstance(x, CSR):
        return (structure_signature(x),) + value_fingerprint(x)
    if isinstance(x, PaddedCSR):
        return ("padded-id", id(x))
    raise TypeError(f"unsupported operand type {type(x)!r}")


def result_key(A, B, M, *, semiring_name: str, complement: bool,
               algorithm: Optional[str], device: str,
               cost_token: str) -> Tuple:
    """The engine's result-cache key: every operand by content, the
    request's options, the device the result lives on and the cost-model
    token (the reference keys its mesh where the port keys its device)."""
    return (content_fingerprint(A), content_fingerprint(B),
            content_fingerprint(M), semiring_name, complement, algorithm,
            str(device), cost_token)


#: coarseness of the per-entry row coverage recorded at ``put`` time: rows
#: map onto this many buckets, so ``invalidate(sig, rows_bitmap)`` skips
#: entries whose recorded coverage provably misses every changed row
ROW_BITMAP_BUCKETS = 64


def row_bitmap(rows, nrows: int) -> int:
    """Coarse coverage bitmap of a row set (bit ``r * B // nrows``)."""
    n = max(1, int(nrows))
    bits = np.unique(np.asarray(rows, np.int64) * ROW_BITMAP_BUCKETS // n)
    return sum(1 << int(b) for b in bits)


_instance_count = 0
_instance_lock = threading.Lock()


class ResultCache:
    """LRU of served results, keyed by the engine's content key.

    Values are what the drivers return (``MaskedSpGEMMResult``), never
    written after they are made, so a hit hands back the identical object.
    Each instance registers under a unique name (``serve-results``,
    ``serve-results-2``, ...) so concurrent engines all stay visible to
    ``repro_torch.caches``; ``unregister()`` (called by the owning engine's
    ``close``) drops the registry's reference.
    """

    def __init__(self, capacity: Optional[int] = None,
                 name: Optional[str] = None):
        global _instance_count
        cap = (capacity if capacity is not None else
               caches.env_capacity("REPRO_RESULT_CACHE_CAP",
                                   DEFAULT_CAPACITY))
        if name is None:
            with _instance_lock:
                _instance_count += 1
                name = ("serve-results" if _instance_count == 1
                        else f"serve-results-{_instance_count}")
        self.name = name
        self._lru = caches.LRUCache(name, cap)
        # structure sig -> {entry key: row coverage bitmap}: the scoped-
        # invalidation index (see ``put``/``invalidate``)
        self._tags: dict = {}
        self._tags_lock = threading.Lock()

    def unregister(self) -> None:
        """Drop this cache from the process registry (it keeps working
        locally; the registry just stops referencing it)."""
        caches.unregister(self.name)

    def get(self, key):
        return self._lru.get(key)

    def put(self, key, value, tags=None) -> None:
        """Insert; ``tags`` is an optional sequence of ``(structure_sig,
        row_bitmap)`` pairs naming the operand structures (and the coarse
        row coverage) the entry depends on.  ``invalidate`` walks this tag
        index instead of the whole cache, so a delta to one structure
        never touches entries of unrelated structures sharing the engine.
        """
        self._lru.put(key, value)
        if tags:
            with self._tags_lock:
                for sig, bitmap in tags:
                    self._tags.setdefault(sig, {})[key] = int(bitmap)
                self._maybe_prune_locked()

    def invalidate(self, sig, rows_bitmap: Optional[int] = None) -> int:
        """Evict entries tagged with structure ``sig`` whose recorded row
        coverage overlaps ``rows_bitmap`` (None = every row).  Returns the
        number of live entries evicted.  Entries of other structures, and
        of non-overlapping row ranges, stay cached.
        """
        with self._tags_lock:
            index = self._tags.get(sig)
            if not index:
                return 0
            if rows_bitmap is None:
                hit = list(index)
            else:
                hit = [k for k, b in index.items() if b & rows_bitmap]
            for k in hit:
                index.pop(k, None)
            if not index:
                self._tags.pop(sig, None)
        evicted = 0
        for k in hit:
            if self._lru.pop(k) is not None:
                evicted += 1
        obs.event("cache.invalidate", cache=self.name,
                  tagged=len(hit), evicted=evicted,
                  scoped=rows_bitmap is not None)
        return evicted

    def _maybe_prune_locked(self) -> None:
        """Drop tag-index records whose entries the LRU already evicted
        (called under ``_tags_lock``); keeps the index O(capacity)."""
        total = sum(len(ix) for ix in self._tags.values())
        if total <= 4 * self._lru.capacity:
            return
        for sig in list(self._tags):
            ix = self._tags[sig]
            for k in list(ix):
                if self._lru.peek(k) is None:
                    del ix[k]
            if not ix:
                del self._tags[sig]

    def clear(self) -> None:
        self._lru.clear()
        with self._tags_lock:
            self._tags.clear()

    def __len__(self) -> int:
        return len(self._lru)

    def device_bytes(self) -> int:
        """Bytes of the distinct tensors the cached results hold (a tensor
        shared by several entries, such as a burst program's ``present``,
        counts once)."""
        seen = {}
        for v in self._lru.values():
            parts = v if isinstance(v, tuple) else (
                getattr(v, "vals", None), getattr(v, "present", None),
                getattr(v, "mask_cols", None))
            for t in parts:
                if isinstance(t, torch.Tensor):
                    seen[(t.device, t.untyped_storage().data_ptr())] = \
                        t.untyped_storage().nbytes()
        return sum(seen.values())

    @property
    def capacity(self) -> int:
        return self._lru.capacity

    def info(self) -> dict:
        return self._lru.info()
