"""The port's invariant linter (``repro_torch.analysis``, ``python -m
repro_torch.lint``) against the reference's (``repro.analysis``).

* parity: each shared fixture tree under ``tests/lint_fixtures/``, copied
  and rewritten line for line to the port's names, gives exactly the
  reference's findings on the original tree, fingerprints included;
* torch spellings (``tests/lint_fixtures_torch/``): compiled boundaries
  and the port's cache module, pinned by exact ``(path, line)`` pairs;
* the port's own caches: on the real port files, with no import rewrite,
  ``plan-cache-key`` sees the ring-prep and dist-plan caches;
* engine mechanics and the CLI, mirroring ``tests/test_lint.py``;
* self-hosting: the port's tree lints clean with an empty baseline.
Tolerance: exact throughout.
"""
import ast
import functools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import run_lint as ref_run_lint
from repro.analysis.findings import Finding as RefFinding
from repro_torch import caches
from repro_torch.analysis import Baseline, rule_names, run_lint
from repro_torch.analysis.findings import Finding, split_by_baseline

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
PORT = REPO / "src" / "repro_torch"
SHARED = HERE / "lint_fixtures"
TORCH_FIXTURES = HERE / "lint_fixtures_torch"
TREES = ("densify", "clock", "cache_registry", "plan_key", "lock", "jit")
RULES = ("no-densify", "clock-discipline", "cache-registry",
         "plan-cache-key", "lock-discipline", "jit-retrace")


def _sites(findings, rule=None):
    return sorted((f.path, f.line) for f in findings
                  if rule is None or f.rule == rule)


def _rows(findings):
    return sorted((f.rule, f.path, f.line, f.severity) for f in findings)


def _port_spelling(tree, line):
    """One fixture line in the port's names (never adds or drops a line)."""
    line = line.replace("from repro", "from repro_torch")
    if tree == "jit":
        line = line.replace(
            'functools.partial(jax.jit, static_argnames=("n",))',
            "functools.partial(torch.compile, dynamic=False)")
        line = line.replace("jax.jit", "torch.compile")
    return line


def _rewritten(tree, tmp_path):
    dst = tmp_path / tree
    shutil.copytree(SHARED / tree, dst)
    for path in dst.rglob("*.py"):
        lines = path.read_text().splitlines(keepends=True)
        new = [_port_spelling(tree, ln) for ln in lines]
        assert len(new) == len(lines)
        path.write_text("".join(new))
    return dst


# ---------------------------------------------------------------------------
# parity on the shared fixture trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree", TREES)
def test_shared_fixture_parity(tree, tmp_path):
    want = _rows(ref_run_lint(SHARED / tree))
    got = _rows(run_lint(_rewritten(tree, tmp_path)))
    assert want, "every shared tree has firing cases"
    assert got == want


@pytest.mark.parametrize("tree", TREES)
def test_fingerprints_match_reference(tree, tmp_path):
    """Fingerprints are anchored to the offending line's text; the rewrite
    touches import lines only, so every finding's fingerprint is the
    reference's."""
    want = sorted((f.rule, f.path, f.line, f.fingerprint)
                  for f in ref_run_lint(SHARED / tree))
    got = sorted((f.rule, f.path, f.line, f.fingerprint)
                 for f in run_lint(_rewritten(tree, tmp_path)))
    assert got == want


def test_finding_fingerprint_equals_reference():
    fields = dict(rule="plan-cache-key", path="core/planner.py", line=12,
                  col=4, message="m", line_text="hit = _cache.get(key)",
                  occurrence=1)
    port, ref = Finding(**fields), RefFinding(**fields)
    assert port.fingerprint == ref.fingerprint
    assert port.to_dict() == ref.to_dict()
    assert port.render() == ref.render()


# ---------------------------------------------------------------------------
# torch spellings
# ---------------------------------------------------------------------------


def test_torch_compiled_boundaries_fixture():
    findings = run_lint(TORCH_FIXTURES / "jit", only=["jit-retrace"])
    assert _sites(findings, "jit-retrace") == [
        ("models/compiled.py", 11),   # @torch.compile mutable capture
        ("models/compiled.py", 16),   # @torch.jit.script mutable capture
        ("models/compiled.py", 21),   # @partial(torch.compile, ...) capture
        ("models/compiled.py", 42),   # list literal at a partial boundary
        ("models/compiled.py", 44),   # dict literal at a scripted boundary
        ("models/compiled.py", 45),   # list literal at torch.jit.trace's
        ("models/imported.py", 9),    # @compile after from torch import
        ("models/imported.py", 20),   # compile(f) wraps: literal at call
    ]
    # the annotated capture (compiled.py 26) and every line of builtin.py
    # are silent
    assert all(f.severity == "warning" for f in findings)


def test_bare_compile_counts_only_through_torch(tmp_path):
    """builtin.py is silent as Python's builtin; given the import of
    imported.py on its blank line 3, it fires at the same lines."""
    src = (TORCH_FIXTURES / "jit" / "models" / "builtin.py").read_text()
    lines = src.splitlines(keepends=True)
    assert lines[2] == "\n"
    assert run_lint(TORCH_FIXTURES / "jit" / "models" / "builtin.py") == []
    lines[2] = "from torch import compile\n"
    (tmp_path / "builtin.py").write_text("".join(lines))
    assert _sites(run_lint(tmp_path, only=["jit-retrace"])) == [
        ("builtin.py", 9), ("builtin.py", 20)]


def test_port_cache_spellings_fixture():
    findings = run_lint(TORCH_FIXTURES / "caches")
    assert _sites(findings, "plan-cache-key") == [
        ("core/plans.py", 16),    # caches.LRUCache
        ("core/plans.py", 17),    # LRUCache from repro_torch.caches
        ("core/plans.py", 18),    # an alias of repro_torch.caches
    ]
    # _memo registers through the alias; _unregistered does not
    assert _sites(findings, "cache-registry") == [("core/plans.py", 36)]
    assert {f.rule for f in findings} == {"plan-cache-key", "cache-registry"}


def test_reference_linter_misses_port_caches():
    """Why the port needs its own linter: the reference's knows the cache
    module only by its own name."""
    assert ref_run_lint(TORCH_FIXTURES / "caches",
                        only=["plan-cache-key"]) == []
    assert ref_run_lint(TORCH_FIXTURES / "jit", only=["jit-retrace"]) == []


# ---------------------------------------------------------------------------
# the port's own caches, on the real files
# ---------------------------------------------------------------------------

ESCAPE = "# lint: plan-key-ok(structure-pure prep)"
TOKEN_KEY = 'semiring.name, "dist",\n               cost_model_token())'


@pytest.mark.parametrize("variant,fired", [
    ("as_is", []),
    ("no_escape", ["core/distributed.py"] * 2),
    ("no_token", ["core/planner.py"] * 2),
])
def test_port_caches_guarded_on_real_files(variant, fired, tmp_path):
    """The ring-prep cache needs its structure-pure escape and the dist
    plan cache its cost-model token: without either, the port's rule fires
    on exactly those accesses of an unmodified copy of the port."""
    root = tmp_path / "repro_torch"
    shutil.copytree(PORT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    if variant == "no_escape":
        path = root / "core" / "distributed.py"
        text = path.read_text()
        assert text.count(ESCAPE) == 2
        path.write_text(text.replace(ESCAPE, ""))
    elif variant == "no_token":
        path = root / "core" / "planner.py"
        text = path.read_text()
        assert text.count(TOKEN_KEY) == 1
        path.write_text(text.replace(TOKEN_KEY, 'semiring.name, "dist")'))
    findings = run_lint(root, only=["plan-cache-key"])
    assert [f.path for f in findings] == fired


def test_register_lru_joins_the_registry():
    """``register_lru`` exposes a functools.lru_cache function's size,
    capacity and stats, and ``clear_all`` empties it — the same row as the
    reference's ``register_lru`` over the same calls."""
    from repro import caches as ref_caches

    rows = []
    for mod in (caches, ref_caches):
        @functools.lru_cache(maxsize=4)
        def square(x):
            return x * x

        mod.register_lru("lru-under-test", square)
        try:
            for x in (1, 2, 1, 3):
                square(x)
            row = mod.cache_info()["lru-under-test"]
            mod.clear_all()
            rows.append((row, mod.cache_info()["lru-under-test"]))
            assert square.cache_info().currsize == 0
        finally:
            mod.unregister("lru-under-test")
    assert rows[0][0] == {"size": 3, "capacity": 4, "hits": 1, "misses": 3}
    assert rows[0][1]["size"] == 0
    assert rows[0] == rows[1]
    assert "lru-under-test" not in caches.cache_info()


# ---------------------------------------------------------------------------
# engine mechanics and the CLI
# ---------------------------------------------------------------------------


def test_escape_requires_nonempty_reason(tmp_path):
    tree = tmp_path / "core"
    tree.mkdir()
    (tree / "x.py").write_text(
        "def f(a):\n"
        "    return a.to_dense()  # lint: densify-ok()\n")
    findings = run_lint(tmp_path, only=["no-densify"])
    assert _sites(findings, "no-densify") == [("core/x.py", 2)]


def test_baseline_suppresses_then_line_edit_invalidates(tmp_path):
    tree = tmp_path / "core"
    tree.mkdir()
    src = tree / "x.py"
    src.write_text("def f(a):\n    return a.to_dense()\n")
    findings = run_lint(tmp_path, only=["no-densify"])
    assert len(findings) == 1
    baseline = Baseline.from_findings(findings)
    assert [len(s) for s in split_by_baseline(findings, baseline)] == [0, 1]

    # the same line number with other content: the suppression is gone
    src.write_text("def f(a):\n    return a.to_dense().T\n")
    findings = run_lint(tmp_path, only=["no-densify"])
    assert [len(s) for s in split_by_baseline(findings, baseline)] == [1, 0]

    # line drift alone (code inserted above) keeps it
    src.write_text("import os\n\n\ndef f(a):\n    return a.to_dense()\n")
    findings = run_lint(tmp_path, only=["no-densify"])
    assert [len(s) for s in split_by_baseline(findings, baseline)] == [0, 1]


def test_baseline_roundtrip(tmp_path):
    tree = tmp_path / "serving"
    tree.mkdir()
    (tree / "x.py").write_text("import time\ntime.sleep(1)\n")
    findings = run_lint(tmp_path, only=["clock-discipline"])
    assert findings
    path = tmp_path / "baseline.json"
    Baseline.from_findings(findings).save(path)
    loaded = Baseline.load(path)
    assert len(loaded) == len(findings)
    assert all(loaded.suppresses(f) for f in findings)


def test_cli_write_baseline_then_clean(tmp_path, capsys):
    from repro_torch.lint import main
    tree = SHARED / "densify"
    path = tmp_path / "baseline.json"
    assert main([str(tree), "--baseline", "none"]) == 1
    assert main([str(tree), "--baseline", str(path),
                 "--write-baseline"]) == 0
    capsys.readouterr()
    assert main([str(tree), "--baseline", str(path), "--format=json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["counts"] == {"total": 3, "new": 0, "baselined": 3}


def test_cli_rejects_unknown_rule():
    from repro_torch.lint import main
    assert main(["--only", "no-such-rule", str(SHARED / "densify")]) == 2


def _listed(text):
    """(name, severity, escape) of each rule in a ``--list-rules`` text."""
    out = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) >= 4 and parts[2] == "escape:":
            out.append((parts[0], parts[1], " ".join(parts[3:])))
    return out


def test_cli_lists_the_reference_rules(capsys):
    from repro.lint import main as ref_main
    from repro_torch.lint import main
    assert main(["--list-rules"]) == 0
    port = _listed(capsys.readouterr().out)
    assert ref_main(["--list-rules"]) == 0
    ref = _listed(capsys.readouterr().out)
    assert [name for name, _, _ in port] == list(RULES)
    assert port == ref
    assert rule_names() == list(RULES)


def test_default_baseline_is_the_ports_own():
    from repro_torch.lint import default_baseline_path, default_root
    assert default_root() == PORT
    assert default_baseline_path() == REPO / "lint-baseline-torch.json"


# ---------------------------------------------------------------------------
# self-hosting
# ---------------------------------------------------------------------------

BLOCKED_RUN = """
import runpy, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["repro"] = None        # and so does any import of the reference
sys.argv = ["repro_torch.lint"] + sys.argv[1:]
runpy.run_module("repro_torch.lint", run_name="__main__")
"""


def test_self_lint_is_clean_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN], capture_output=True, text=True,
        cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("clean: 0 non-baselined findings (0 total, 0 baselined)"
            in proc.stdout)


def test_self_lint_json_counts_zero():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, "--format=json", "--baseline",
         "none"], capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["counts"] == {"total": 0, "new": 0, "baselined": 0}
    assert report["rules"] == list(RULES)
    assert report["roots"] == [str(PORT)]


def test_port_baseline_is_empty():
    data = json.loads((REPO / "lint-baseline-torch.json").read_text())
    assert data == {"version": 1, "findings": []}


def test_linter_imports_neither_jax_nor_reference():
    files = sorted((PORT / "analysis").rglob("*.py")) + [PORT / "lint.py"]
    assert len(files) == 11
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "repro"), (path, name)
