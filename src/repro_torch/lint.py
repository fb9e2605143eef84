"""``python -m repro_torch.lint`` — run the port's invariant linter
(``repro_torch.analysis``).

Checks the six repo-specific correctness rules (no-densify,
clock-discipline, cache-registry, plan-cache-key, lock-discipline,
jit-retrace — ``--list-rules`` for details) over ``src/repro_torch`` by
default, against the committed baseline at ``lint-baseline-torch.json``
(empty: the port keeps no baselined finding).

    python -m repro_torch.lint                   # text report, exit != 0
                                                 # on any non-baselined
                                                 # finding
    python -m repro_torch.lint --format=json     # machine-readable
    python -m repro_torch.lint --only clock-discipline,lock-discipline
    python -m repro_torch.lint path/to/tree      # lint another tree
    python -m repro_torch.lint --write-baseline  # accept current findings

Intentional escapes live in code, one annotation per rule with a
mandatory reason, e.g. ``# lint: clock-ok(duration measurement)``.  The
port's committed baseline holds no finding at all (policy, enforced by
``tests/test_torch_analysis.py``): a finding is fixed or annotated at
its site.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import Baseline, LintEngine, rule_names
from repro_torch.analysis.findings import split_by_baseline
from repro_torch.analysis.rules import RULES


def default_root() -> Path:
    """The installed ``repro_torch`` package tree (src/repro_torch in a
    checkout)."""
    return Path(__file__).resolve().parent


def default_baseline_path() -> Path:
    """``lint-baseline-torch.json`` at the checkout root (may not exist).
    The reference package's ``lint-baseline.json`` is a different file:
    ``--write-baseline`` must never overwrite it by default."""
    return default_root().parent.parent / "lint-baseline-torch.json"


def _list_rules() -> str:
    rows = []
    for r in RULES:
        escape = f"# lint: {r.escape}(reason)" if r.escape else "-"
        rows.append(f"  {r.name:18s} [{r.severity}] escape: {escape}\n"
                    f"      {r.description}")
    return "rules:\n" + "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Invariant linter: enforce the repo's hard-won "
                    "correctness rules.")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/trees to lint (default: the repro_torch "
                         "package)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="baseline suppression file (default: "
                         "lint-baseline-torch.json at the checkout root, "
                         "when present; 'none' disables)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--only", default=None, metavar="RULE[,RULE]",
                    help="run only these rules")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings to the baseline file "
                         "and exit 0")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0

    only = None
    if args.only:
        only = [s.strip() for s in args.only.split(",") if s.strip()]
        unknown = set(only) - set(rule_names())
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}; "
                  f"valid: {', '.join(rule_names())}", file=sys.stderr)
            return 2

    roots = [Path(p) for p in (args.paths or [default_root()])]
    for root in roots:
        if not root.exists():
            print(f"no such path: {root}", file=sys.stderr)
            return 2

    findings = []
    for root in roots:
        findings.extend(LintEngine(root).run(only=only))

    baseline_path = None
    if args.baseline != "none":
        baseline_path = (Path(args.baseline) if args.baseline
                         else default_baseline_path())

    if args.write_baseline:
        if baseline_path is None:
            print("--write-baseline needs a baseline path", file=sys.stderr)
            return 2
        Baseline.from_findings(findings).save(baseline_path)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    if baseline_path is not None and baseline_path.exists():
        baseline = Baseline.load(baseline_path)
    else:
        baseline = Baseline()
    new, suppressed = split_by_baseline(findings, baseline)

    if args.format == "json":
        print(json.dumps({
            "version": 1,
            "roots": [str(r) for r in roots],
            "rules": only or rule_names(),
            "baseline": str(baseline_path) if baseline_path else None,
            "counts": {"total": len(findings), "new": len(new),
                       "baselined": len(suppressed)},
            "findings": [dict(f.to_dict(), baselined=False) for f in new]
            + [dict(f.to_dict(), baselined=True) for f in suppressed],
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        if suppressed:
            print(f"({len(suppressed)} baselined finding(s) suppressed)")
        if new:
            print(f"\n{len(new)} non-baselined finding(s).")
        else:
            print("clean: 0 non-baselined findings "
                  f"({len(findings)} total, {len(suppressed)} baselined).")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
