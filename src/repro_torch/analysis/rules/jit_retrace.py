"""Rule 6 — jit-retrace: no mutable captures or per-call containers at
compiled boundaries (``torch.compile``, ``torch.jit.script``,
``torch.jit.trace``).

The recompile class the serving bucket caches exist to prevent: a
compiled function is specialised to the Python values it sees.  Two
hazards:

* **mutable module state in the closure** — a compiled function reading a
  module-level dict/list/set either bakes its contents in as constants
  (``torch.jit.trace``, ``torch.jit.script``), so later mutation
  (retuning a table, growing a registry) is silently invisible — the
  stale-constant twin of the stale-plan bug — or guards on them and
  recompiles whenever they change (``torch.compile``).  Pass the data as
  an argument or freeze it after import.
* **container literals at call sites** — calling a compiled function
  with a fresh ``[...]``/``{...}`` literal makes the container's length
  or key set part of what the compiled code is specialised to; every
  distinct length/keyset recompiles.  The serving layer exists to
  amortize compilation across a bucket — per-call containers defeat it.

A bare ``compile(...)`` is Python's builtin: it counts only where the
module's imports make it ``torch.compile``.  Escapes:
``# lint: jit-ok(reason)`` (e.g. a module table that is frozen after
import, or a literal whose shape is provably fixed).
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from . import Rule, Site
from ..engine import call_name

CONTAINER_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                      ast.DictComp, ast.SetComp, ast.GeneratorExp)


def _bound_names(fn) -> Set[str]:
    """Names bound inside the function: params, assignments, imports,
    nested defs, comprehension targets — reads of these are locals, not
    module-state captures."""
    out: Set[str] = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        out.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node is not fn:
                out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out.add((a.asname or a.name).split(".")[0])
    return out


class JitRetraceRule(Rule):
    name = "jit-retrace"
    escape = "jit-ok"
    severity = "warning"
    description = ("torch.compile/torch.jit functions must not capture "
                   "mutable module state; compiled call sites must not "
                   "build container literals per call")

    def applies_to(self, mod) -> bool:
        return "tests" not in mod.parts

    def check(self, mod, table) -> Iterator[Site]:
        mutable_here = {q.rsplit(".", 1)[-1]: q
                        for q in table.mutable_state.get(mod.module, ())}
        # names imported from other scanned modules that are mutable there
        imported_mutable: Set[str] = set()
        for alias, full in mod.imports.items():
            owner, _, leaf = full.rpartition(".")
            if owner and full in table.mutable_state.get(owner, ()):
                imported_mutable.add(alias)

        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and table._jit_decorated(mod, node):
                yield from self._check_closure(mod, node, mutable_here,
                                               imported_mutable)
            elif isinstance(node, ast.Call) and \
                    table.is_jitted_call(mod, node):
                yield from self._check_call_site(node)

    def _check_closure(self, mod, fn, mutable_here, imported_mutable
                       ) -> Iterator[Site]:
        bound = _bound_names(fn)
        seen: Set[str] = set()
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Load)):
                continue
            name = node.id
            if name in bound or name in seen:
                continue
            if name in mutable_here or name in imported_mutable:
                seen.add(name)
                yield self.at(node, (
                    f"compiled closure captures mutable module state "
                    f"`{name}`: torch.jit bakes its contents in as "
                    f"constants (later mutation is silently invisible — "
                    f"the stale-constant class) and torch.compile guards "
                    f"on them and recompiles when they change.  Pass it "
                    f"as an argument or annotate `# lint: jit-ok(reason)` "
                    f"if it is frozen after import"))

    def _check_call_site(self, node: ast.Call) -> Iterator[Site]:
        args = list(node.args) + [kw.value for kw in node.keywords]
        for arg in args:
            if isinstance(arg, ast.Starred):
                arg = arg.value
            if isinstance(arg, CONTAINER_LITERALS):
                fname = call_name(node) or "<compiled>"
                yield self.at(arg, (
                    f"container literal built per call at compiled "
                    f"boundary `{fname}(...)`: each distinct length or "
                    f"key set recompiles — hoist it, convert to a tensor, "
                    f"or annotate `# lint: jit-ok(reason)` if its shape "
                    f"is fixed"))
                break
