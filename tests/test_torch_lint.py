"""The port passes the reference's invariant linter (``repro.analysis``)
with no baseline: every clock read in its serving and span code is an
annotated duration measurement, and every structure-keyed cache carries
the cost-model token or says why it need not (the dist-plan cache keys
the token; the ring-prep cache is structure-pure)."""
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import rule_names, run_lint

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


@pytest.mark.parametrize("rule", rule_names())
def test_port_has_no_findings(rule):
    findings = run_lint(PORT, only=[rule])
    assert findings == [], "\n".join(
        f"{f.path}:{f.line}: [{f.rule}] {f.message}" for f in findings)


def test_lint_cli_over_the_port_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "repro.lint", str(PORT), "--baseline",
         "none"], capture_output=True, text=True, cwd=REPO, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 non-baselined finding" in proc.stdout


def _port_core(tmp_path, strip_escape=False, strip_token=False):
    """A copy of the port's distributed module and planner whose caches
    the rule can see: it knows ``repro.caches.LRUCache`` by that name only,
    so the copy imports the caches module from there."""
    core = tmp_path / "core"
    core.mkdir(parents=True)
    dist = (PORT / "core" / "distributed.py").read_text()
    planner = (PORT / "core" / "planner.py").read_text()
    for name, text in (("distributed.py", dist), ("planner.py", planner)):
        assert text.count("from repro_torch import caches, obs") == 1
        text = text.replace("from repro_torch import caches, obs",
                            "from repro import caches, obs")
        if strip_escape:
            text = text.replace("# lint: plan-key-ok(structure-pure prep)",
                                "")
        if strip_token:
            keyed = ('semiring.name, "dist",\n'
                     "               cost_model_token())")
            assert text.count(keyed) == (name == "planner.py")
            text = text.replace(keyed, 'semiring.name, "dist")')
        (core / name).write_text(text)
    return sorted((f.path, f.line) for f in run_lint(
        tmp_path, only=["plan-cache-key"]))


def test_the_new_caches_are_guarded(tmp_path):
    """The ring-prep cache needs its structure-pure escape and the dist
    plan cache its cost-model token: without either the rule fires on
    exactly those accesses."""
    assert _port_core(tmp_path / "as_is") == []
    fired = _port_core(tmp_path / "no_escape", strip_escape=True)
    assert [p for p, _ in fired] == ["core/distributed.py"] * 2
    fired = _port_core(tmp_path / "no_token", strip_token=True)
    assert [p for p, _ in fired] == ["core/planner.py"] * 2
