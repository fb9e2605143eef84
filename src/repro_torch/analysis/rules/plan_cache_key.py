"""Rule 4 — plan-cache-key: structure-keyed cache keys carry the token.

The stale-plan bug class: a cache keyed only by operand *structure*
keeps serving entries decided under retired cost-model constants after a
calibration profile activates.  Every cache key derived from planner
structure signatures must therefore incorporate
``planner.cost_model_token()`` — or carry an explicit justification that
the cached value is invariant to the cost model
(``# lint: plan-key-ok(reason)``; the burst gather programs and the
ring's host prep are the canonical structure-pure cases).

Detection (per function, intraprocedural taint):

* *tainted* expressions contain a call to ``structure_signature`` /
  ``content_fingerprint`` / any function the symbol table discovered to
  return structure-derived keys, or reference a local previously assigned
  from one;
* a tainted expression is *token-carrying* when it (or a local folded
  into it) contains a ``cost_model_token()`` call;
* a finding is a cache accessor call — ``X.get(k)`` / ``X.put(k, v)`` /
  ``X.peek(k)`` / ``X.setdefault(k, d)`` on a module-level cache object
  or a ``self.`` attribute, or a ``*cache_get(k)`` / ``*cache_put(k, v)``
  helper — whose key is tainted but not token-carrying.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Set

from . import Rule, Site

ACCESSOR_METHODS = {"get", "put", "peek", "setdefault"}
TOKEN_FUNCS = {"cost_model_token"}


def _contains_call(expr: ast.AST, names: Set[str]) -> bool:
    from ..engine import call_name, last_segment
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            seg = last_segment(call_name(n))
            if seg in names:
                return True
    return False


def _referenced_locals(expr: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(expr)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


class _FunctionScan:
    """Taint pass over one function body (nested defs get their own)."""

    def __init__(self, rule, mod, table, fn):
        self.rule = rule
        self.mod = mod
        self.table = table
        self.fn = fn
        self.tainted: Set[str] = set()
        self.token_ok: Set[str] = set()

    def _expr_taint(self, expr: ast.AST):
        tainted = (_contains_call(expr, self.table.taint_fns)
                   or bool(_referenced_locals(expr) & self.tainted))
        has_token = (_contains_call(expr, TOKEN_FUNCS)
                     or bool(_referenced_locals(expr) & self.token_ok))
        return tainted, has_token

    def _is_cache_receiver(self, recv: ast.AST) -> bool:
        # self.<attr> or a module-level cache object (LRUCache instance /
        # registered dict) — local transient dicts are NOT caches
        if isinstance(recv, ast.Attribute):
            base = recv.value
            return isinstance(base, ast.Name) and base.id == "self"
        if isinstance(recv, ast.Name):
            qual = self.mod.qualify(recv.id)
            return qual in self.table.cache_vars
        return False

    def _shallow_nodes(self):
        """This function's nodes in source order, NOT descending into
        nested defs (each nested function gets its own scan — taint is
        per-scope, and descending twice would double-report)."""
        out = []
        stack = list(ast.iter_child_nodes(self.fn))
        while stack:
            n = stack.pop()
            out.append(n)
            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(ast.iter_child_nodes(n))
        out.sort(key=lambda n: (getattr(n, "lineno", 0),
                                getattr(n, "col_offset", 0)))
        return out

    def run(self) -> Iterator[Site]:
        for node in self._shallow_nodes():
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                tainted, has_token = self._expr_taint(node.value)
                if tainted:
                    self.tainted.add(node.targets[0].id)
                if has_token:
                    self.token_ok.add(node.targets[0].id)
            elif isinstance(node, ast.Call):
                yield from self._check_call(node)

    def _check_call(self, node: ast.Call) -> Iterator[Site]:
        from ..engine import call_name, last_segment
        key_arg: Optional[ast.AST] = None
        func = node.func
        if isinstance(func, ast.Attribute) and \
                func.attr in ACCESSOR_METHODS and node.args:
            if not self._is_cache_receiver(func.value):
                return
            key_arg = node.args[0]
        else:
            seg = last_segment(call_name(node)) or ""
            if (seg.endswith("cache_get") or seg.endswith("cache_put")) \
                    and node.args:
                key_arg = node.args[0]
        if key_arg is None:
            return
        tainted, has_token = self._expr_taint(key_arg)
        if tainted and not has_token:
            yield self.rule.at(node, (
                "cache access keyed by planner structure signatures "
                "without cost_model_token(): after a calibration profile "
                "activates (or an in-place retune), this cache would keep "
                "serving entries decided under the OLD cost model (the "
                "stale-plan class) — add cost_model_token() to the "
                "key, or annotate `# lint: plan-key-ok(reason)` if the "
                "cached value is provably cost-model-invariant"))


class PlanCacheKeyRule(Rule):
    name = "plan-cache-key"
    escape = "plan-key-ok"
    severity = "error"
    description = ("cache keys built from structure signatures must "
                   "include cost_model_token() (stale-plan guard)")

    def applies_to(self, mod) -> bool:
        return "tests" not in mod.parts

    def check(self, mod, table) -> Iterator[Site]:
        funcs: Dict[int, ast.AST] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs[node.lineno] = node
        for fn in funcs.values():
            yield from _FunctionScan(self, mod, table, fn).run()
