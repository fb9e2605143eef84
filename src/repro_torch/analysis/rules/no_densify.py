"""Rule 1 — no-densify: dense materialization is banned on hot paths.

The paper's central discipline, and a hard-won one: the tile and
distributed pipelines must never round-trip through a dense array — a
single ``to_dense()`` on a hot path silently turns the masked product's
O(flops(M)) work into O(m*n) and its memory into a dense allocation.

Flags calls to ``to_dense``/``todense``/``toarray`` in files under
``core/``, ``kernels/``, or ``serving/``.  Allowlisted: ``ref.py``
reference implementations, ``tests``, and sites annotated
``# lint: densify-ok(reason)``.  Defining ``to_dense`` (formats do) is
fine — only *calling* it densifies.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterator

from . import Rule, Site

HOT_DIRS = ("core", "kernels", "serving")
DENSIFY_CALLS = {"to_dense", "todense", "toarray"}
ALLOWED_BASENAMES = {"ref.py"}


class NoDensifyRule(Rule):
    name = "no-densify"
    escape = "densify-ok"
    severity = "error"
    description = ("no to_dense()/todense()/toarray() calls on core/, "
                   "kernels/, or serving/ hot paths")

    def applies_to(self, mod) -> bool:
        if mod.basename in ALLOWED_BASENAMES:
            return False
        if "tests" in Path(mod.relpath).parts:
            return False
        return any(mod.in_dir(d) for d in HOT_DIRS)

    def check(self, mod, table) -> Iterator[Site]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            attr = (func.attr if isinstance(func, ast.Attribute)
                    else func.id if isinstance(func, ast.Name) else None)
            if attr in DENSIFY_CALLS:
                yield self.at(node, (
                    f"dense materialization `{attr}()` on a hot path "
                    f"({'/'.join(p for p in mod.parts[:-1])}); masked "
                    f"products must stay sparse end-to-end — move it to a "
                    f"ref/test path or annotate "
                    f"`# lint: densify-ok(reason)`"))
