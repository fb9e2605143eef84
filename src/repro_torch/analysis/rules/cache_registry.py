"""Rule 3 — cache-registry: every process cache lives in
``repro_torch.caches``.

The bounded-memory contract: a long-running serving process must not
grow memory as the structure stream drifts, so every module-level cache —
``functools.lru_cache`` memos, dict caches, compiled-program tables — is
either a self-registering ``repro_torch.caches.LRUCache`` or registered
with ``caches.register`` / ``caches.register_lru`` so ``cache_info()``
sees it and ``clear_all()`` empties it.

Cross-module check: the registration may live anywhere in the scanned
tree (the symbol table records every identifier referenced inside a
``register*`` call, bare and fully qualified).  A module-level dict
counts as a cache when functions in its module write it by key and
either read it by key or its name says cache/memo/program.  Escapes:
``# lint: cache-ok(reason)`` on the definition.
"""
from __future__ import annotations

from typing import Iterator

from . import Rule, Site

EXEMPT_BASENAMES = {"caches.py"}


class CacheRegistryRule(Rule):
    name = "cache-registry"
    escape = "cache-ok"
    severity = "error"
    description = ("module-level lru_cache/dict caches must be registered "
                   "in repro_torch.caches (register/register_lru) or be "
                   "LRUCache instances")

    def applies_to(self, mod) -> bool:
        return mod.basename not in EXEMPT_BASENAMES and \
            "tests" not in mod.parts

    def check(self, mod, table) -> Iterator[Site]:
        for cd in table.caches.get(mod.module, ()):
            if cd.kind == "lrucache":       # LRUCache self-registers
                continue
            if table.is_registered(cd.module, cd.name):
                continue
            what = ("functools.lru_cache function" if cd.kind == "lru"
                    else "dict cache")
            yield (cd.lineno, cd.col, cd.end_lineno,
                   f"module-level {what} `{cd.name}` is not registered in "
                   f"repro_torch.caches: unbounded/invisible process "
                   f"state — "
                   f"call `caches.register_lru({cd.name!r}-style-name, "
                   f"{cd.name})` (or `caches.register(...)` with "
                   f"clear/size handles), or annotate "
                   f"`# lint: cache-ok(reason)`")
