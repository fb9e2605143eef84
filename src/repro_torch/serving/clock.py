"""Injectable clocks for the serving engine.

Every time-dependent decision the engine makes — ``Request.submitted_at``,
the ``max_wait_ms`` aging of partial buckets, queue-wait accounting — reads
through a clock object instead of ``time.perf_counter`` directly.  Two
implementations:

* :class:`SystemClock` — wall time (``time.perf_counter``); the default.
* :class:`VirtualClock` — a manually-advanced timeline.  Stepping it
  through each flush deadline (``QueryEngine.next_flush_deadline``) makes
  the engine's bucket/flush decisions depend only on the submissions, so
  the timing-sensitive async tests never sleep on a real ``max_wait_ms``.

A clock can be *attached* to condition variables (the engine attaches its
internal scheduling condition): advancing a :class:`VirtualClock` notifies
them, so an async worker blocked on a virtual deadline wakes exactly when
virtual time reaches it, never on a real timer.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional


class SystemClock:
    """Wall-clock time (``time.perf_counter``)."""

    #: True when ``now()`` only moves via ``advance`` (deterministic schedules)
    virtual = False

    def now(self) -> float:
        return time.perf_counter()

    def wait_on(self, cond: threading.Condition, timeout: Optional[float]
                ) -> None:
        """Block on ``cond`` (held by the caller) until notified or until
        ``timeout`` real seconds pass (None = until notified)."""
        cond.wait(timeout=timeout)

    def attach(self, cond: threading.Condition) -> None:  # pragma: no cover
        pass

    def detach(self, cond: threading.Condition) -> None:  # pragma: no cover
        pass


class VirtualClock:
    """A deterministic timeline: ``now()`` changes only via ``advance``.

    ``advance``/``advance_to`` notify every attached condition, so engine
    workers waiting on virtual deadlines re-evaluate immediately.  Time
    never goes backwards (a regression would silently reorder flush
    decisions, so it raises instead).
    """

    virtual = True

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()
        self._conds: List[threading.Condition] = []

    def now(self) -> float:
        with self._lock:
            return self._now

    # -- timeline -----------------------------------------------------------

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance by negative dt {dt!r}")
        with self._lock:
            target = self._now + float(dt)
        return self.advance_to(target)

    def advance_to(self, t: float) -> float:
        with self._lock:
            if t < self._now - 1e-12:
                raise ValueError(
                    f"virtual time cannot go backwards ({t!r} < {self._now!r})")
            self._now = max(self._now, float(t))
            conds = list(self._conds)
        for cond in conds:
            with cond:
                cond.notify_all()
        return t

    # -- waiter plumbing ----------------------------------------------------

    def attach(self, cond: threading.Condition) -> None:
        with self._lock:
            if cond not in self._conds:
                self._conds.append(cond)

    def detach(self, cond: threading.Condition) -> None:
        with self._lock:
            try:
                self._conds.remove(cond)
            except ValueError:
                pass

    def wait_on(self, cond: threading.Condition, timeout: Optional[float]
                ) -> None:
        """A virtual deadline must not burn real time: block until some
        event (submit, ``advance``, stop) notifies.  The short real timeout
        is only a lost-wakeup safety net, not a schedule."""
        cond.wait(timeout=0.05)
