"""The six invariant rules, each born from a bug class this repo hit.

A rule declares its ``name`` (CLI ``--only``), its ``escape`` annotation
(``# lint: <escape>(reason)``), and yields ``(lineno, col, end_lineno,
message)`` sites from :meth:`check`; the engine applies escapes and turns
sites into structured findings.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

#: (lineno, col, end_lineno, message[, escapable]) — a 5th element of
#: False marks a violation that NO annotation may suppress
Site = Tuple


class Rule:
    """Base class: subclasses fill in the class attributes and check()."""

    name: str = ""
    escape: str = ""
    severity: str = "error"
    description: str = ""

    def applies_to(self, mod) -> bool:
        return True

    def check(self, mod, table) -> Iterator[Site]:
        raise NotImplementedError

    @staticmethod
    def at(node, message: str, escapable: bool = True) -> Site:
        return (node.lineno, node.col_offset,
                getattr(node, "end_lineno", None) or node.lineno, message,
                escapable)


from .no_densify import NoDensifyRule            # noqa: E402
from .clock_discipline import ClockDisciplineRule  # noqa: E402
from .cache_registry import CacheRegistryRule    # noqa: E402
from .plan_cache_key import PlanCacheKeyRule     # noqa: E402
from .lock_discipline import LockDisciplineRule  # noqa: E402
from .jit_retrace import JitRetraceRule          # noqa: E402

RULES: List[type] = [NoDensifyRule, ClockDisciplineRule, CacheRegistryRule,
                     PlanCacheKeyRule, LockDisciplineRule, JitRetraceRule]


def rule_names() -> List[str]:
    return [r.name for r in RULES]


__all__ = ["Rule", "Site", "RULES", "rule_names"]
