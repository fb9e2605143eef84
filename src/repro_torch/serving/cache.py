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
is the capacity times the bytes of one result.
"""
from __future__ import annotations

import threading
import zlib
from typing import Optional

import numpy as np

from repro_torch import caches
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

    def unregister(self) -> None:
        """Drop this cache from the process registry (it keeps working
        locally; the registry just stops referencing it)."""
        caches.unregister(self.name)

    def get(self, key):
        return self._lru.get(key)

    def put(self, key, value) -> None:
        self._lru.put(key, value)

    def clear(self) -> None:
        self._lru.clear()

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def capacity(self) -> int:
        return self._lru.capacity

    def info(self) -> dict:
        return self._lru.info()
