"""Process-wide cache registry: every module-level cache, bounded and
introspectable.

Long-running processes must not grow memory without bound as the
structure stream drifts, so every cache in the package — today the
planner's plan cache, its trial memo and explain memo, the serving
result caches and burst programs — is either an ``LRUCache`` from
this module or registered here with clear/size handles:

    from repro_torch import caches
    caches.cache_info()            # {name: {size, capacity, hits, misses}}
    caches.clear_all()             # one switch empties every cache
    caches.set_capacity("planner-plans", 512)

Capacities are configurable per cache at runtime (``set_capacity``) or at
import via environment variables (each cache names its own, e.g.
``REPRO_PLAN_CACHE_CAP``); shrinking evicts LRU-first immediately.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

_registry_lock = threading.Lock()
_registry: "OrderedDict[str, Dict[str, Callable]]" = OrderedDict()


def register(name: str, *, clear: Callable[[], None],
             size: Callable[[], int],
             capacity: Optional[Callable[[], int]] = None,
             set_capacity: Optional[Callable[[int], None]] = None,
             stats: Optional[Callable[[], Dict[str, int]]] = None) -> None:
    """Register (or replace) a cache's management handles under ``name``."""
    with _registry_lock:
        _registry[name] = dict(clear=clear, size=size, capacity=capacity,
                               set_capacity=set_capacity, stats=stats)


def register_lru(name: str, fn) -> None:
    """Register a ``functools.lru_cache``-wrapped function (fixed capacity)."""
    register(name, clear=fn.cache_clear,
             size=lambda: fn.cache_info().currsize,
             capacity=lambda: fn.cache_info().maxsize,
             stats=lambda: {"hits": fn.cache_info().hits,
                            "misses": fn.cache_info().misses})


def unregister(name: str) -> None:
    """Drop ``name`` from the registry (the cache keeps working; the
    registry stops referencing it)."""
    with _registry_lock:
        _registry.pop(name, None)


def clear_all() -> None:
    """Empty every registered cache.  Everything rebuilds from the
    operands — correctness never depends on a cache.
    """
    with _registry_lock:
        handles = list(_registry.values())
    for h in handles:
        h["clear"]()


def cache_info() -> Dict[str, Dict[str, int]]:
    """Size/capacity/hit-miss snapshot of every registered cache."""
    with _registry_lock:
        handles = list(_registry.items())
    out = {}
    for name, h in handles:
        row = {"size": int(h["size"]())}
        if h["capacity"] is not None:
            cap = h["capacity"]()
            row["capacity"] = -1 if cap is None else int(cap)
        if h["stats"] is not None:
            row.update(h["stats"]())
        out[name] = row
    return out


def set_capacity(name: str, capacity: int) -> None:
    with _registry_lock:
        h = _registry.get(name)
    if h is None:
        raise KeyError(f"no cache registered as {name!r}; "
                       f"known: {sorted(_registry)}")
    if h["set_capacity"] is None:
        raise ValueError(f"cache {name!r} has a fixed capacity")
    h["set_capacity"](int(capacity))


def env_capacity(var: str, default: int) -> int:
    """Capacity from the environment (``var``), falling back to ``default``."""
    raw = os.environ.get(var, "")
    try:
        return int(raw) if raw else default
    except ValueError as e:
        raise ValueError(f"{var} must be an integer, got {raw!r}") from e


class LRUCache:
    """Thread-safe bounded LRU mapping with hit/miss stats.

    Self-registers under ``name`` (env var ``env_var``, when given, sets the
    initial capacity).  The unit of accounting is the entry — callers cache
    similarly-sized objects per cache, so entry count bounds memory.  A
    cache whose entries vary widely in size (device-resident prep, sized
    by the operands) also passes ``nbytes`` (an entry's bytes) and
    ``max_bytes`` (``bytes_env_var`` overrides it): least recently used
    entries go until the total fits, though the newest entry always
    stays.
    """

    def __init__(self, name: str, capacity: int,
                 env_var: Optional[str] = None, *,
                 nbytes: Optional[Callable[[Any], int]] = None,
                 max_bytes: Optional[int] = None,
                 bytes_env_var: Optional[str] = None):
        if env_var is not None:
            capacity = env_capacity(env_var, capacity)
        if capacity < 1:
            raise ValueError(f"{name}: capacity must be >= 1, got {capacity}")
        if (nbytes is None) != (max_bytes is None):
            raise ValueError(f"{name}: nbytes and max_bytes go together")
        if bytes_env_var is not None and max_bytes is not None:
            max_bytes = env_capacity(bytes_env_var, max_bytes)
        self.name = name
        self._capacity = capacity
        self._nbytes = nbytes
        self._max_bytes = max_bytes
        self._sizes: Dict[Any, int] = {}
        self._data: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.RLock()
        self._hits = 0
        self._misses = 0
        register(name, clear=self.clear, size=self.__len__,
                 capacity=lambda: self._capacity,
                 set_capacity=self.set_capacity, stats=self.stats)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    @property
    def capacity(self) -> int:
        return self._capacity

    def set_capacity(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        with self._lock:
            self._capacity = capacity
            self._evict()

    def _bytes(self) -> int:
        return sum(self._sizes.values())

    def _evict(self) -> None:
        """Drop least recently used entries past the entry capacity, then
        past the byte bound (never the newest entry)."""
        while len(self._data) > self._capacity or (
                self._max_bytes is not None and len(self._data) > 1
                and self._bytes() > self._max_bytes):
            key, _ = self._data.popitem(last=False)
            self._sizes.pop(key, None)

    def get(self, key, default=None):
        """Lookup; a hit refreshes recency.  Misses count only here (``peek``
        does not touch stats), so hit-rate reflects real traffic."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self._hits += 1
                return self._data[key]
            self._misses += 1
            return default

    def peek(self, key, default=None):
        with self._lock:
            return self._data.get(key, default)

    def put(self, key, value) -> None:
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            if self._nbytes is not None:
                self._sizes[key] = int(self._nbytes(value))
            self._evict()

    def values(self) -> list:
        """A snapshot of the cached values, least recently used first."""
        with self._lock:
            return list(self._data.values())

    def pop(self, key, default=None):
        """Remove and return one entry (scoped invalidation: evicting a
        stale key must not flush the rest of the cache)."""
        with self._lock:
            self._sizes.pop(key, None)
            return self._data.pop(key, default)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._sizes.clear()
            self._hits = 0
            self._misses = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = {"hits": self._hits, "misses": self._misses}
            if self._max_bytes is not None:
                out.update(bytes=self._bytes(), max_bytes=self._max_bytes)
            return out

    def info(self) -> Dict[str, int]:
        with self._lock:
            return {**self.stats(), "size": len(self._data),
                    "capacity": self._capacity}
