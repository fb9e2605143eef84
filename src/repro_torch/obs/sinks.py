"""Span sinks: where :class:`repro_torch.obs.spans.Tracer` records land.

* :class:`InMemorySink` — a bounded ring for tests and inspection.  O(1)
  emit, oldest spans evicted.
* :class:`JsonlSpanSink` — rotating JSONL capture: size-capped segments
  (``path`` → ``path.1`` → … → ``path.N``), each starting with a header
  line, and seeded ``sample_rate`` shedding.

Both expose ``emit(record)``; the tracer calls nothing else.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["InMemorySink", "JsonlSpanSink", "load_spans"]

#: header ``kind`` of span capture files
SPAN_TRACE_KIND = "repro-span-trace"
#: header schema version of span capture files
SCHEMA_VERSION = 1


class InMemorySink:
    """Bounded in-memory span ring (the test / inspection default)."""

    def __init__(self, capacity: int = 4096):
        self._ring: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self.emitted = 0

    def emit(self, record: Dict) -> None:
        # lock-free on purpose: deque.append is atomic under the GIL and
        # emit is the per-span hot path.  ``emitted`` may undercount under
        # concurrent emits; it is a diagnostic counter only.
        self._ring.append(record)
        self.emitted += 1

    def spans(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class JsonlSpanSink:
    """Rotating JSONL span capture.

    Records append to ``path``; when a segment would exceed ``max_bytes``
    the files shift ``path`` → ``path.1`` → ... → ``path.N`` (``N =
    rotate``; the oldest falls off) and a fresh segment opens with its own
    header.  ``sample_rate`` keeps that fraction of records, decided by a
    generator seeded with ``seed``, never the wall clock, so two captures
    of one stream sample the same records.  A record larger than
    ``max_bytes`` on its own still writes.
    """

    def __init__(self, path, *, max_bytes: int = 1 << 20, rotate: int = 4,
                 sample_rate: float = 1.0, seed: int = 0,
                 name: str = "spans", meta: Optional[Dict] = None):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if rotate < 1:
            raise ValueError(f"rotate must be >= 1, got {rotate}")
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], "
                             f"got {sample_rate}")
        self.path = str(path)
        self.max_bytes = int(max_bytes)
        self.rotate = int(rotate)
        self.sample_rate = float(sample_rate)
        self._header = json.dumps(
            {"schema": SCHEMA_VERSION, "kind": SPAN_TRACE_KIND,
             "name": name, "meta": dict(meta or {})},
            sort_keys=True) + "\n"
        self.written = 0        # records persisted (all segments)
        self.sampled_out = 0    # records dropped by the sampler
        self._rng = np.random.default_rng(seed)
        self._f = None
        self._size = 0
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)

    def _open(self) -> None:
        self._f = open(self.path, "w", encoding="utf-8")
        self._f.write(self._header)
        self._size = len(self._header)

    def _shift(self) -> None:
        self._f.close()
        self._f = None
        for i in range(self.rotate, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i}")

    def emit(self, record: Dict) -> None:
        with self._lock:
            if (self.sample_rate < 1.0
                    and float(self._rng.random()) >= self.sample_rate):
                self.sampled_out += 1
                return
            if self._f is None:
                self._open()
            line = json.dumps(record, sort_keys=True) + "\n"
            if (self._size + len(line) > self.max_bytes
                    and self._size > len(self._header)):
                self._shift()
                self._open()
            self._f.write(line)
            self._size += len(line)
            self.written += 1

    def segments(self) -> List[Path]:
        """Existing segment paths, oldest first (``path.N`` ... ``path``)."""
        out = [f"{self.path}.{i}" for i in range(self.rotate, 0, -1)]
        out.append(self.path)
        return [Path(p) for p in out if os.path.exists(p)]

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "JsonlSpanSink":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def load_spans(path, *, rotate: int = 64) -> List[Dict]:
    """Read every span from a rotated :class:`JsonlSpanSink` capture,
    oldest first, skipping the per-segment header lines."""
    base = Path(path)
    candidates = [base.with_name(f"{base.name}.{i}")
                  for i in range(int(rotate), 0, -1)] + [base]
    out: List[Dict] = []
    for seg in (p for p in candidates if p.exists()):
        with open(seg, "r", encoding="utf-8") as fh:
            for i, line in enumerate(fh):
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if i == 0 and rec.get("kind") == SPAN_TRACE_KIND:
                    continue  # segment header
                out.append(rec)
    return out
