"""Rule 5 — lock-discipline: a lock-set race detector for serving classes.

Two bug classes motivated this rule:

* the plan-cache race — concurrent misses on one structure ran
  racing measured trials and could elect *different* near-tied kernels,
  mixing plans (and bitwise results) within one stream;
* the half-taken-work window — ``quiesce()`` could observe the gap
  between "bucket popped" and "worker executing" unless pop and
  busy-marking share one critical section.

Analysis, per class in ``serving/`` modules that starts a worker thread
(``threading.Thread(target=self.<m>)``):

1. lock attributes = ``self.X`` assigned ``threading.Lock()`` /
   ``RLock()`` / ``Condition(...)`` in ``__init__``;
2. for every method, every ``self.<attr>`` access is recorded with the
   lexical lock set (``with self.X:`` nesting) at the access, writes
   distinguished (assignments, augmented assignments, subscript stores,
   and mutator method calls like ``.append``/``.update``);
3. the self-call graph propagates held locks: a method called while
   holding L is analyzed as holding L (RLock/Condition reentry is the
   repo's idiom);
4. worker-reachable accesses (closure from the thread targets) are paired
   against submit/flush-path accesses (closure from the public methods);
   a pair touching the same non-lock attribute, at least one side a
   write, with *disjoint* lock sets, is a finding on the unguarded line.

Attributes only ever written in ``__init__`` (pre-thread) are immutable
configuration and exempt.  Escapes: ``# lint: unlocked-ok(reason)`` at
the access.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from . import Rule, Site
from ..engine import call_name, last_segment

LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
MUTATOR_METHODS = {"append", "extend", "insert", "remove", "pop", "clear",
                   "update", "setdefault", "popitem", "add", "discard",
                   "appendleft", "popleft"}
CONTAINER_CTORS = {"list", "dict", "set", "deque", "defaultdict",
                   "OrderedDict", "Counter"}


@dataclasses.dataclass(frozen=True)
class Access:
    attr: str
    write: bool
    locks: FrozenSet[str]
    method: str
    lineno: int
    col: int
    end_lineno: int


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _MethodScan(ast.NodeVisitor):
    """Collect self-attribute accesses + self-calls with lexical locksets."""

    def __init__(self, lock_attrs: Set[str], method: str,
                 container_attrs: Optional[Set[str]] = None):
        self.lock_attrs = lock_attrs
        self.container_attrs = container_attrs or set()
        self.method = method
        self.lockset: Tuple[str, ...] = ()
        self.accesses: List[Access] = []
        #: (callee, lockset-at-callsite)
        self.calls: List[Tuple[str, FrozenSet[str]]] = []

    def _record(self, node, attr: str, write: bool) -> None:
        if attr in self.lock_attrs:
            return
        self.accesses.append(Access(
            attr=attr, write=write, locks=frozenset(self.lockset),
            method=self.method, lineno=node.lineno, col=node.col_offset,
            end_lineno=getattr(node, "end_lineno", None) or node.lineno))

    def visit_With(self, node: ast.With) -> None:
        held = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr in self.lock_attrs:
                held.append(attr)
        for item in node.items:
            self.visit(item.context_expr)
        self.lockset = self.lockset + tuple(held)
        for stmt in node.body:
            self.visit(stmt)
        self.lockset = self.lockset[:len(self.lockset) - len(held)]

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None:
            self._record(node, attr,
                         isinstance(node.ctx, (ast.Store, ast.Del)))
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # self.x[k] = v mutates self.x even though the Attribute ctx is Load
        attr = _self_attr(node.value)
        if attr is not None and isinstance(node.ctx, (ast.Store, ast.Del)):
            self._record(node, attr, True)
            self.visit(node.slice)
            return
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = _self_attr(node.target)
        if attr is not None:
            self._record(node, attr, True)
        elif isinstance(node.target, ast.Subscript):
            inner = _self_attr(node.target.value)
            if inner is not None:
                self._record(node, inner, True)
        self.visit(node.value)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            recv_attr = _self_attr(func.value)
            if recv_attr is not None and func.attr in MUTATOR_METHODS \
                    and recv_attr in self.container_attrs:
                # self.x.append(...) mutates a plain container attribute;
                # method calls on non-container sub-objects (a Batcher, an
                # LRUCache) are NOT writes here — such objects own their
                # internal synchronization
                self._record(func.value, recv_attr, True)
            target = _self_attr(func)
            if target is not None:
                self.calls.append((target, frozenset(self.lockset)))
        self.generic_visit(node)


class _ClassAnalysis:
    def __init__(self, rule, mod, cls: ast.ClassDef):
        self.rule = rule
        self.mod = mod
        self.cls = cls
        self.methods: Dict[str, ast.AST] = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.lock_attrs = self._find_locks()
        self.container_attrs = self._find_container_attrs()
        self.worker_roots = self._find_thread_targets()
        self.scans: Dict[str, _MethodScan] = {}
        for name, fn in self.methods.items():
            scan = _MethodScan(self.lock_attrs, name, self.container_attrs)
            for stmt in fn.body:
                scan.visit(stmt)
            self.scans[name] = scan
        self.init_only = self._init_only_attrs()

    def _find_locks(self) -> Set[str]:
        out: Set[str] = set()
        init = self.methods.get("__init__")
        if init is None:
            return out
        for node in ast.walk(init):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    attr = _self_attr(tgt)
                    if attr is None:
                        continue
                    if isinstance(node.value, ast.Call) and \
                            last_segment(call_name(node.value)) in LOCK_CTORS:
                        out.add(attr)
        return out

    def _find_container_attrs(self) -> Set[str]:
        """Attributes initialized to plain containers in ``__init__`` —
        the ones whose mutator-method calls (.append/.update/...) count
        as writes.  Sub-objects built from other constructors are assumed
        to own their internal synchronization."""
        out: Set[str] = set()
        init = self.methods.get("__init__")
        if init is None:
            return out
        for node in ast.walk(init):
            targets: List[ast.AST] = []
            value: Optional[ast.AST] = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            if value is None:
                continue
            is_container = isinstance(value, (ast.List, ast.Dict, ast.Set,
                                              ast.ListComp, ast.DictComp,
                                              ast.SetComp))
            if isinstance(value, ast.Call) and \
                    last_segment(call_name(value)) in CONTAINER_CTORS:
                is_container = True
            if not is_container:
                continue
            for tgt in targets:
                attr = _self_attr(tgt)
                if attr is not None:
                    out.add(attr)
        return out

    def _find_thread_targets(self) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(self.cls):
            if isinstance(node, ast.Call) and \
                    last_segment(call_name(node)) == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        attr = _self_attr(kw.value)
                        if attr is not None:
                            out.add(attr)
        return out

    def _init_only_attrs(self) -> Set[str]:
        """Attributes written in __init__ and never written elsewhere."""
        written_init: Set[str] = set()
        written_later: Set[str] = set()
        for name, scan in self.scans.items():
            for acc in scan.accesses:
                if acc.write:
                    (written_init if name == "__init__"
                     else written_later).add(acc.attr)
        return written_init - written_later

    def _closure(self, roots: Set[str]) -> List[Access]:
        """Accesses reachable from ``roots`` with propagated held locks.

        Visits each (method, heldset) pair once; held locks at a callsite
        extend the callee's lexical locksets (reentrant-lock idiom).
        """
        out: List[Access] = []
        seen: Set[Tuple[str, FrozenSet[str]]] = set()
        stack: List[Tuple[str, FrozenSet[str]]] = [
            (r, frozenset()) for r in roots if r in self.scans]
        while stack:
            name, held = stack.pop()
            if (name, held) in seen or len(seen) > 512:
                continue
            seen.add((name, held))
            scan = self.scans[name]
            for acc in scan.accesses:
                out.append(dataclasses.replace(
                    acc, locks=acc.locks | held))
            for callee, at_locks in scan.calls:
                if callee in self.scans and callee != "__init__":
                    stack.append((callee, held | at_locks))
        return out

    def findings(self) -> Iterator[Site]:
        if not self.worker_roots or not self.lock_attrs:
            return
        public_roots = {name for name in self.methods
                        if not name.startswith("_")
                        and name not in self.worker_roots}
        worker = self._closure(self.worker_roots)
        submit = self._closure(public_roots)
        reported: Set[Tuple[int, str]] = set()
        for a1 in worker:
            if a1.attr in self.init_only:
                continue
            for a2 in submit:
                if a2.attr != a1.attr or not (a1.write or a2.write):
                    continue
                if a1.locks & a2.locks:
                    continue
                for acc, other in ((a1, a2), (a2, a1)):
                    key = (acc.lineno, acc.attr)
                    if key in reported:
                        continue
                    reported.add(key)
                    held = (", ".join(sorted(acc.locks))
                            or "no lock")
                    other_held = (", ".join(sorted(other.locks))
                                  or "no lock")
                    yield (acc.lineno, acc.col, acc.end_lineno,
                           f"`self.{acc.attr}` {'written' if acc.write else 'read'} "
                           f"in `{acc.method}` holding {held}, but the "
                           f"{'worker' if other is a1 else 'submit/flush'} "
                           f"path accesses it in `{other.method}` holding "
                           f"{other_held} (line {other.lineno}): disjoint "
                           f"lock sets between the worker thread and the "
                           f"submit/flush path — the plan-race / "
                           f"half-taken-work class.  Guard both sides "
                           f"with one Lock/Condition or annotate "
                           f"`# lint: unlocked-ok(reason)`")


class LockDisciplineRule(Rule):
    name = "lock-discipline"
    escape = "unlocked-ok"
    severity = "error"
    description = ("attributes shared between a serving worker thread and "
                   "the submit/flush path must share a lock")

    def applies_to(self, mod) -> bool:
        return mod.in_dir("serving") and "tests" not in mod.parts

    def check(self, mod, table) -> Iterator[Site]:
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                yield from _ClassAnalysis(self, mod, node).findings()
