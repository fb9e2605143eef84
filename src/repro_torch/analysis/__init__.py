"""``repro_torch.analysis`` — the invariant linter, over the port's tree.

The port's correctness rules were each discovered by a production-style
bug (see the rule docstrings); this package enforces them mechanically so
a regression is a lint failure, not a bitwise-divergent serving stream:

* ``no-densify``       — no dense materialization on core/kernels/serving
  hot paths (the paper's central discipline).
* ``clock-discipline`` — serving scheduling reads ``engine.clock``, never
  wall-clock (replay determinism).
* ``cache-registry``   — every module-level cache registers in
  ``repro_torch.caches`` (the bounded-memory contract).
* ``plan-cache-key``   — structure-keyed cache keys carry
  ``cost_model_token()`` (the stale-plan class).
* ``lock-discipline``  — serving attributes shared between the worker
  thread and the submit/flush path hold a common lock (the plan-race and
  half-taken-work classes).
* ``jit-retrace``      — ``torch.compile`` / ``torch.jit`` boundaries
  neither capture mutable module state nor take per-call container
  literals (the recompile class the serving bucket caches exist to
  prevent).

The linter parses source and never imports it.  Intentional escapes are
in-code annotations, one per rule — e.g. ``# lint: clock-ok(reason)`` —
so every exemption carries its reason at the site.  Run
``python -m repro_torch.lint`` (see that module for the CLI).
"""
from .engine import LintEngine, run_lint
from .findings import Baseline, Finding
from .rules import RULES, rule_names

__all__ = ["LintEngine", "run_lint", "Finding", "Baseline", "RULES",
           "rule_names"]
