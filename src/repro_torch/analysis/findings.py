"""Structured lint findings and the committed-baseline suppression file.

A :class:`Finding` is one rule violation at one site.  Its *fingerprint*
is content-anchored — rule name, root-relative path, the stripped source
line, and a per-(rule, path, line-text) occurrence index — so unrelated
edits that only shift line numbers do not churn the baseline, while
editing the offending line itself invalidates its suppression (the site
must be re-justified or fixed).

The baseline (:class:`Baseline`) is a committed JSON file listing
fingerprints that are *known and accepted* with a reason each.  The CLI
exits non-zero on any finding not in the baseline; ``--write-baseline``
regenerates it.  Policy (enforced by tests, not this module): findings in
``serving/`` and ``core/`` must be fixed or escape-annotated in code,
never baselined.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Iterable, List, Optional

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str               # posix path relative to the scan root
    line: int
    col: int
    message: str
    severity: str = "error"
    line_text: str = ""     # stripped source line (fingerprint anchor)
    occurrence: int = 0     # index among same (rule, path, line_text)

    @property
    def fingerprint(self) -> str:
        payload = "\x1f".join((self.rule, self.path, self.line_text,
                               str(self.occurrence)))
        return hashlib.sha1(payload.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "severity": self.severity,
                "message": self.message, "fingerprint": self.fingerprint}

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.rule}] {self.severity}: {self.message}")


def assign_occurrences(findings: Iterable[Finding]) -> List[Finding]:
    """Number duplicate (rule, path, line_text) findings so each gets a
    distinct fingerprint (two identical offending lines in one file are
    two sites, suppressible independently)."""
    seen: Dict[tuple, int] = {}
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.rule, f.path, f.line_text)
        n = seen.get(key, 0)
        seen[key] = n + 1
        out.append(dataclasses.replace(f, occurrence=n))
    return out


class Baseline:
    """Committed suppression file: fingerprint -> {rule, path, reason}."""

    VERSION = 1

    def __init__(self, entries: Optional[Dict[str, Dict]] = None,
                 path: Optional[str] = None):
        self.entries = dict(entries or {})
        self.path = path

    @classmethod
    def load(cls, path) -> "Baseline":
        with open(path) as f:
            raw = json.load(f)
        if raw.get("version") != cls.VERSION:
            raise ValueError(
                f"baseline {path}: unsupported version {raw.get('version')!r}"
                f" (expected {cls.VERSION})")
        entries = {e["fingerprint"]: e for e in raw.get("findings", [])}
        return cls(entries, path=str(path))

    @classmethod
    def from_findings(cls, findings: Iterable[Finding],
                      reason: str = "baselined pre-existing finding"
                      ) -> "Baseline":
        entries = {
            f.fingerprint: {"fingerprint": f.fingerprint, "rule": f.rule,
                            "path": f.path, "line": f.line,
                            "reason": reason}
            for f in findings}
        return cls(entries)

    def dumps(self) -> str:
        rows = sorted(self.entries.values(),
                      key=lambda e: (e.get("path", ""), e.get("line", 0),
                                     e["fingerprint"]))
        return json.dumps({"version": self.VERSION, "findings": rows},
                          indent=2, sort_keys=False) + "\n"

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    def suppresses(self, finding: Finding) -> bool:
        return finding.fingerprint in self.entries

    def __len__(self) -> int:
        return len(self.entries)


def split_by_baseline(findings: Iterable[Finding], baseline: Baseline
                      ) -> tuple:
    """(new, suppressed) partition of ``findings`` against ``baseline``."""
    new, suppressed = [], []
    for f in findings:
        (suppressed if baseline.suppresses(f) else new).append(f)
    return new, suppressed
