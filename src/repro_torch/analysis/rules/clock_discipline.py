"""Rule 2 — clock-discipline: serving scheduling reads ``engine.clock``.

Replay determinism rests on one invariant: every *scheduling*
decision in ``repro_torch.serving`` (bucket aging, flush deadlines, submit
timestamps) reads the engine's injectable clock, so a recorded trace
replays to a bit-identical bucket schedule.  One stray wall-clock read
re-introduces timing nondeterminism that only shows up as a divergent
replay digest.

Flags, in any file under a ``serving/`` or ``obs/`` directory except
``clock.py`` (the one module allowed to touch real time).  ``repro_torch.obs``
is covered because its spans measure wall durations INSIDE the request
lifecycle: every ``perf_counter`` read there is a measurement site and
must carry the same ``# lint: clock-ok(reason)`` annotation — and a
``time.sleep`` or scheduling-from-wall-time bug in a span would perturb
exactly the replay determinism this rule protects.

* ``time.time`` / ``time.monotonic`` / ``time.sleep`` — always an error,
  annotations included: scheduling from wall time or real sleeps cannot
  be replayed.  Use ``engine.clock.now()`` / ``clock.wait_on``.
* ``time.perf_counter`` — allowed only at sites annotated
  ``# lint: clock-ok(reason)``: *measuring* a duration (metrics, bench
  wall time) is legitimate; an unannotated read is assumed to be a
  scheduling decision until a human says otherwise.
* ``from time import <any of those>`` — same treatment at the import.
"""
from __future__ import annotations

import ast
from typing import Iterator

from . import Rule, Site

FORBIDDEN = {"time", "monotonic", "sleep"}     # attributes of module time
ANNOTATABLE = {"perf_counter", "perf_counter_ns", "monotonic_ns"}
EXEMPT_BASENAMES = {"clock.py"}


class ClockDisciplineRule(Rule):
    name = "clock-discipline"
    escape = "clock-ok"
    severity = "error"
    description = ("serving + obs code reads the injectable engine clock; "
                   "wall-clock time only in clock.py or at annotated "
                   "measurement sites")

    def applies_to(self, mod) -> bool:
        return ((mod.in_dir("serving") or mod.in_dir("obs"))
                and mod.basename not in EXEMPT_BASENAMES)

    def check(self, mod, table) -> Iterator[Site]:
        time_aliases = {alias for alias, full in mod.imports.items()
                        if full == "time"}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in time_aliases:
                yield from self._site(mod, node, node.attr)
            elif isinstance(node, ast.ImportFrom) and node.module == "time" \
                    and node.level == 0:
                for a in node.names:
                    yield from self._site(mod, node, a.name)
            elif isinstance(node, ast.Name) and node.id in mod.imports and \
                    mod.imports[node.id] in {
                        f"time.{fn}" for fn in FORBIDDEN | ANNOTATABLE}:
                # a from-imported name used bare; the import line itself is
                # also flagged, but a use far from its import deserves its
                # own site (the import may be annotated, the use not)
                yield from self._site(mod, node,
                                      mod.imports[node.id].split(".", 1)[1])

    def _site(self, mod, node, attr: str) -> Iterator[Site]:
        if attr in FORBIDDEN:
            yield self.at(node, (
                f"`time.{attr}` in serving/obs code: scheduling must read the "
                f"injectable engine clock (`clock.now()` / "
                f"`clock.wait_on`) or move into serving/clock.py — replay "
                f"determinism breaks otherwise; no annotation "
                f"exempts this"), escapable=False)
        elif attr in ANNOTATABLE:
            yield self.at(node, (
                f"unannotated `time.{attr}` in serving/obs code: if this is a "
                f"duration measurement (not a scheduling decision), "
                f"annotate `# lint: clock-ok(reason)`; scheduling must use "
                f"the engine clock"))
