"""Rule engine: per-file AST walk + a cross-module symbol table.

The engine parses every ``*.py`` under the scan roots (never imports or
executes them), builds a :class:`SymbolTable` over the whole tree so rules
can see imports, ``repro_torch.caches`` registrations, compiled
boundaries (``torch.compile``, ``torch.jit``), and module-level state
across modules, then runs each rule per module.

Intentional escapes are in-code annotations::

    time.perf_counter()   # lint: clock-ok(measurement, not scheduling)

One escape name per rule (``Rule.escape``); the reason inside the parens
is mandatory — an empty reason does not suppress.  An escape suppresses
findings on its own line, on the following statement when it sits alone
on the line above, and anywhere inside a multi-line statement it ends.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding, assign_occurrences

_ESCAPE_RE = re.compile(r"#\s*lint:\s*([A-Za-z0-9_-]+)\s*\(([^)]*)\)")

#: spellings of the cache-registry entry points (``repro_torch.caches``)
REGISTER_FUNCS = {"register", "register_lru"}
REGISTER_MODULES = {"repro_torch.caches", "caches"}
#: spellings of the self-registering cache class
LRUCACHE_NAMES = {"repro_torch.caches.LRUCache", "caches.LRUCache",
                  "LRUCache"}

#: decorators that make a function a process-lifetime memo
LRU_DECORATORS = {"functools.lru_cache", "lru_cache", "functools.cache",
                  "cache"}

#: constructors of mutable module-level containers
MUTABLE_CTORS = {"dict", "list", "set", "OrderedDict", "defaultdict",
                 "deque", "collections.OrderedDict",
                 "collections.defaultdict", "collections.deque"}

#: the compiled-boundary entry points, fully qualified.  A spelling counts
#: when it is one of these as written or once the module's imports qualify
#: it (``from torch import compile`` makes a bare ``compile`` count); a bare
#: ``compile`` with no such import is Python's builtin and never counts
JIT_FUNCS = {"torch.compile", "torch.jit.script", "torch.jit.trace"}

#: functions whose return value keys caches by structure (taint sources
#: for the plan-cache-key rule); the table extends this with discovered
#: key-builder functions
STRUCTURE_TAINT_FUNCS = {"structure_signature", "content_fingerprint",
                         "incremental_signature"}

_CACHE_NAME_RE = re.compile(r"cache|memo|program", re.IGNORECASE)


def call_name(node: ast.AST) -> Optional[str]:
    """Dotted spelling of a call target / decorator / attribute chain
    (``torch.compile``, ``caches.register_lru``); None for anything
    dynamic."""
    if isinstance(node, ast.Call):
        return call_name(node.func)
    if isinstance(node, ast.Attribute):
        base = call_name(node.value)
        return None if base is None else f"{base}.{node.attr}"
    if isinstance(node, ast.Name):
        return node.id
    return None


def last_segment(name: Optional[str]) -> Optional[str]:
    return None if name is None else name.rsplit(".", 1)[-1]


def walk_names(node: ast.AST) -> Set[str]:
    """Every identifier referenced in a subtree (lambda bodies included)."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


@dataclasses.dataclass
class ModuleInfo:
    """One parsed source file plus everything rules need from it."""

    path: Path
    relpath: str                      # posix, relative to the scan root
    module: str                       # dotted name ("serving.engine")
    tree: ast.Module
    lines: List[str]
    escapes: Dict[int, Set[str]]      # line -> escape names with reasons
    imports: Dict[str, str]           # local alias -> fully qualified name

    @property
    def parts(self) -> Tuple[str, ...]:
        return tuple(Path(self.relpath).parts)

    @property
    def basename(self) -> str:
        return Path(self.relpath).name

    def in_dir(self, component: str) -> bool:
        """True when ``component`` is a directory on this file's path."""
        return component in self.parts[:-1]

    def qualify(self, name: str) -> str:
        """Best-effort fully qualified name for a module-scope identifier."""
        if name in self.imports:
            return self.imports[name]
        return f"{self.module}.{name}" if self.module else name

    def qualify_dotted(self, dotted: Optional[str]) -> Optional[str]:
        """Qualify a dotted spelling through this module's imports
        (``planner.cost_model_token`` ->
        ``repro_torch.core.planner.cost_model_token``)."""
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        base = self.imports.get(head)
        if base is None:
            return dotted
        return f"{base}.{rest}" if rest else base

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def escaped(self, escape: str, lineno: int,
                end_lineno: Optional[int] = None) -> bool:
        """Is an escape annotation in force over [lineno, end_lineno]?"""
        lo = max(1, lineno - 1)
        hi = end_lineno if end_lineno is not None else lineno
        return any(escape in self.escapes.get(ln, ())
                   for ln in range(lo, hi + 1))


def _module_name(relpath: str) -> str:
    parts = list(Path(relpath).with_suffix("").parts)
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _parse_escapes(lines: Sequence[str]) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, 1):
        if "#" not in line:
            continue
        names = {m.group(1) for m in _ESCAPE_RE.finditer(line)
                 if m.group(2).strip()}   # empty reason does not suppress
        if names:
            out[i] = names
    return out


def _collect_imports(tree: ast.Module, module: str) -> Dict[str, str]:
    pkg_parts = module.split(".")[:-1] if module else []
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
                if a.asname is None and "." in a.name:
                    # "import a.b.c" binds "a" but rules often compare the
                    # full dotted spelling; keep the bare root mapping
                    out[a.name.split(".")[0]] = a.name.split(".")[0]
                elif a.asname:
                    out[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base_parts = pkg_parts[:len(pkg_parts) - (node.level - 1)] \
                    if node.level > 1 else list(pkg_parts)
                prefix = ".".join(base_parts + ([node.module]
                                                if node.module else []))
            else:
                prefix = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                full = f"{prefix}.{a.name}" if prefix else a.name
                out[a.asname or a.name] = full
    return out


def parse_module(path: Path, root: Path) -> Optional[ModuleInfo]:
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    rel = path.relative_to(root).as_posix()
    module = _module_name(rel)
    lines = source.splitlines()
    return ModuleInfo(path=path, relpath=rel, module=module, tree=tree,
                      lines=lines, escapes=_parse_escapes(lines),
                      imports=_collect_imports(tree, module))


# ---------------------------------------------------------------------------
# cross-module symbol table
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheDef:
    """A module-level cache discovered in one module."""

    module: str
    name: str
    kind: str        # "lru" | "dict" | "lrucache"
    lineno: int
    col: int
    end_lineno: int


class SymbolTable:
    """What every rule may need to see across module boundaries."""

    def __init__(self):
        #: identifiers referenced inside ``caches.register*`` calls,
        #: both bare ("_sched") and qualified ("kernels.flash_mask.ops._sched")
        self.registered: Set[str] = set()
        #: module-level caches, per module name
        self.caches: Dict[str, List[CacheDef]] = {}
        #: compiled functions, decorated or wrapped (bare + qualified
        #: names)
        self.jitted: Set[str] = set()
        #: module-level mutable containers (qualified), per module
        self.mutable_state: Dict[str, Set[str]] = {}
        #: functions returning structure-derived cache keys (bare + qualified)
        self.taint_fns: Set[str] = set(STRUCTURE_TAINT_FUNCS)
        #: module-level LRUCache/registered-dict variables (qualified) —
        #: receivers the plan-cache-key rule treats as caches
        self.cache_vars: Set[str] = set()

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, modules: Sequence[ModuleInfo]) -> "SymbolTable":
        table = cls()
        for mod in modules:
            table._scan_module(mod)
        # one propagation round: functions returning calls to key builders
        # discovered above are key builders too
        for mod in modules:
            table._scan_key_builders(mod)
        return table

    def _is_register_call(self, mod: ModuleInfo, node: ast.Call) -> bool:
        name = call_name(node)
        if name is None or last_segment(name) not in REGISTER_FUNCS:
            return False
        qual = mod.qualify_dotted(name) or name
        return (qual.rsplit(".", 1)[0] in REGISTER_MODULES
                or qual.startswith("repro_torch.caches.")
                or name.split(".")[0] == "caches"
                # "from repro_torch.caches import register"
                or name in REGISTER_FUNCS)

    def _scan_module(self, mod: ModuleInfo) -> None:
        defs: List[CacheDef] = []
        mutable: Set[str] = set()

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and self._is_register_call(mod,
                                                                     node):
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    for name in walk_names(arg):
                        self.registered.add(name)
                        self.registered.add(mod.qualify(name))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self._jit_decorated(mod, node):
                    self.jitted.add(node.name)
                    self.jitted.add(mod.qualify(node.name))

        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self._lru_decorated(mod, node):
                    defs.append(CacheDef(mod.module, node.name, "lru",
                                         node.lineno, node.col_offset,
                                         node.lineno))
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                kind = self._container_kind(mod, node.value)
                if kind == "lrucache":
                    defs.append(CacheDef(mod.module, name, "lrucache",
                                         node.lineno, node.col_offset,
                                         node.end_lineno or node.lineno))
                    self.cache_vars.add(mod.qualify(name))
                elif kind == "mutable":
                    mutable.add(mod.qualify(name))
                    if self._dict_used_as_cache(mod, name):
                        defs.append(CacheDef(mod.module, name, "dict",
                                             node.lineno, node.col_offset,
                                             node.end_lineno or node.lineno))
                        self.cache_vars.add(mod.qualify(name))
                # "x = torch.compile(f)" wraps f: treat both names as
                # compiled
                if isinstance(node.value, ast.Call) and \
                        self._is_jit_name(mod, call_name(node.value)):
                    self.jitted.add(name)
                    self.jitted.add(mod.qualify(name))
                    for inner in node.value.args[:1]:
                        if isinstance(inner, ast.Name):
                            self.jitted.add(inner.id)
                            self.jitted.add(mod.qualify(inner.id))
        self.caches[mod.module] = defs
        self.mutable_state[mod.module] = mutable

    def _scan_key_builders(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for ret in ast.walk(node):
                if isinstance(ret, ast.Return) and ret.value is not None \
                        and self._expr_structure_tainted(ret.value):
                    self.taint_fns.add(node.name)
                    self.taint_fns.add(mod.qualify(node.name))
                    break

    def _expr_structure_tainted(self, expr: ast.AST) -> bool:
        for n in ast.walk(expr):
            if isinstance(n, ast.Call):
                seg = last_segment(call_name(n))
                if seg in self.taint_fns:
                    return True
        return False

    # -- classification helpers --------------------------------------------

    def _lru_decorated(self, mod: ModuleInfo, node) -> bool:
        for dec in node.decorator_list:
            name = call_name(dec)
            if name is None:
                continue
            if name in LRU_DECORATORS:
                return True
            qual = mod.qualify_dotted(name) or name
            if qual in {"functools.lru_cache", "functools.cache"}:
                return True
        return False

    @staticmethod
    def _is_jit_name(mod: ModuleInfo, name: Optional[str]) -> bool:
        """Is the spelling ``name`` a compiled-boundary entry point?"""
        return name is not None and (
            name in JIT_FUNCS or mod.qualify_dotted(name) in JIT_FUNCS)

    def _jit_decorated(self, mod: ModuleInfo, node) -> bool:
        for dec in node.decorator_list:
            name = call_name(dec)
            if self._is_jit_name(mod, name):
                return True
            # functools.partial(torch.compile, ...) / partial(compile, ...)
            # after "from torch import compile"
            if isinstance(dec, ast.Call) and last_segment(name) == "partial" \
                    and dec.args:
                if self._is_jit_name(mod, call_name(dec.args[0])):
                    return True
        return False

    def _container_kind(self, mod: ModuleInfo, value: ast.AST
                        ) -> Optional[str]:
        if isinstance(value, ast.Call):
            name = call_name(value)
            qual = mod.qualify_dotted(name) if name else None
            if (qual or name) in LRUCACHE_NAMES:
                return "lrucache"
            if name in MUTABLE_CTORS or last_segment(name) in {
                    "OrderedDict", "defaultdict", "deque"}:
                return "mutable"
            return None
        if isinstance(value, (ast.Dict, ast.DictComp, ast.List, ast.ListComp,
                              ast.Set, ast.SetComp)):
            return "mutable"
        return None

    def _dict_used_as_cache(self, mod: ModuleInfo, name: str) -> bool:
        """A module-level dict is a cache when in-module functions write it
        by key AND either read it by key or its name says cache/memo."""
        wrote = read = False
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                continue
            for n in ast.walk(fn):
                if isinstance(n, ast.Subscript) and \
                        isinstance(n.value, ast.Name) and n.value.id == name:
                    if isinstance(n.ctx, ast.Store):
                        wrote = True
                    else:
                        read = True
                elif isinstance(n, ast.Call):
                    cname = call_name(n)
                    if cname is None or "." not in cname:
                        continue
                    base, _, meth = cname.rpartition(".")
                    if base != name:
                        continue
                    if meth in {"setdefault", "update"}:
                        wrote = True
                    elif meth in {"get", "pop"}:
                        read = True
        return wrote and (read or bool(_CACHE_NAME_RE.search(name)))

    # -- queries ------------------------------------------------------------

    def is_registered(self, module: str, name: str) -> bool:
        return f"{module}.{name}" in self.registered or \
            name in self.registered

    def is_jitted_call(self, mod: ModuleInfo, node: ast.Call) -> bool:
        name = call_name(node)
        if name is None:
            return False
        if name in self.jitted or last_segment(name) in self.jitted:
            return True
        qual = mod.qualify_dotted(name)
        return qual in self.jitted


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def discover_files(root: Path) -> List[Path]:
    if root.is_file():
        return [root]
    return sorted(p for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts
                  and not any(part.startswith(".") for part in p.parts))


class LintEngine:
    """Parse a tree once, run the selected rules over every module."""

    def __init__(self, root, rules: Optional[Sequence] = None):
        from .rules import RULES
        self.root = Path(root).resolve()
        self.rules = list(rules) if rules is not None else [r() for r in
                                                            RULES]
        scan_base = self.root if self.root.is_dir() else self.root.parent
        self.modules: List[ModuleInfo] = []
        for path in discover_files(self.root):
            mod = parse_module(path, scan_base)
            if mod is not None:
                self.modules.append(mod)
        self.table = SymbolTable.build(self.modules)

    def run(self, only: Optional[Iterable[str]] = None) -> List[Finding]:
        wanted = set(only) if only else None
        findings: List[Finding] = []
        for rule in self.rules:
            if wanted is not None and rule.name not in wanted:
                continue
            for mod in self.modules:
                if not rule.applies_to(mod):
                    continue
                for site in rule.check(mod, self.table):
                    lineno, col, end_lineno, message = site[:4]
                    # a site may append escapable=False: some violations
                    # (e.g. time.sleep in serving) accept no annotation
                    escapable = site[4] if len(site) > 4 else True
                    if escapable and rule.escape and \
                            mod.escaped(rule.escape, lineno, end_lineno):
                        continue
                    findings.append(Finding(
                        rule=rule.name, path=mod.relpath, line=lineno,
                        col=col, message=message, severity=rule.severity,
                        line_text=mod.line_text(lineno)))
        return assign_occurrences(findings)


def run_lint(root, only: Optional[Iterable[str]] = None) -> List[Finding]:
    """Convenience one-shot: lint ``root`` with (optionally) a rule subset."""
    return LintEngine(root).run(only=only)
