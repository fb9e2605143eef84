"""Span sinks: where :class:`repro_torch.obs.spans.Tracer` records land.

* :class:`InMemorySink` — a bounded ring for tests and inspection.  O(1)
  emit, oldest spans evicted.
* :class:`JsonlSpanSink` — rotating JSONL capture: a thin adapter over
  ``repro_torch.serving.trace.RotatingTraceSink``, inheriting its
  size-capped rotation (``path`` → ``path.1`` → … → ``path.N``, each
  segment starting with a header line) and seeded ``sample_rate``
  shedding.

Both expose ``emit(record)``; the tracer calls nothing else.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["InMemorySink", "JsonlSpanSink", "load_spans"]

#: header ``kind`` distinguishing span capture files from the serving
#: request traces RotatingTraceSink was built for
SPAN_TRACE_KIND = "repro-span-trace"


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

    Delegates the file policy (size-capped segments, rotation, seeded
    sampling) to ``RotatingTraceSink``, so span capture and request capture
    behave identically on disk; only the header ``kind`` differs, so the
    two file families cannot be confused on load.  ``emit`` holds a lock:
    spans arrive from the submitting threads and the async worker alike.
    """

    def __init__(self, path, *, max_bytes: int = 1 << 20, rotate: int = 4,
                 sample_rate: float = 1.0, seed: int = 0,
                 name: str = "spans", meta: Optional[Dict] = None):
        # deferred import: obs stays importable without the serving stack
        from repro_torch.serving.trace import RotatingTraceSink
        self._sink = RotatingTraceSink(
            str(path), max_bytes=max_bytes, rotate=rotate,
            sample_rate=sample_rate, seed=seed, name=name, meta=meta,
            kind=SPAN_TRACE_KIND)
        self.path = self._sink.path
        self._lock = threading.Lock()

    def emit(self, record: Dict) -> None:
        with self._lock:
            self._sink.write(record)

    @property
    def written(self) -> int:
        return self._sink.written

    @property
    def sampled_out(self) -> int:
        return self._sink.sampled_out

    def segments(self) -> List[Path]:
        """Existing segment paths, oldest first (``path.N`` ... ``path``)."""
        return [Path(p) for p in self._sink.segments()]

    def close(self) -> None:
        with self._lock:
            self._sink.close()

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
