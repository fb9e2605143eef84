"""Cross-commit perf-trajectory report over the committed bench grids.

Every change that touches a benchmark commits its full-tier grid under
``results/bench/*_grid.json``, so the git history of those files IS the
repo's performance trajectory — one **generation** per commit.  This
module loads every grid plus its history (``git log`` + ``git show``)
and renders:

* a console report: per-grid trend tables with unicode sparklines for
  every scalar metric, first->last deltas, and acceptance-flag status;
* a standalone HTML file (``--html out.html``): the same tables with
  inline-SVG sparklines, no external assets;
* machine-readable regression flags: an acceptance flag (the grid's
  ``_``-prefixed booleans, e.g. ``_health_ok``) that was True in the
  previous committed generation and is False now, or a newest
  generation that does not parse as a grid at all.

``python -m repro_torch.obs.report --check`` exits non-zero on any regression
flag or unreadable newest generation (a gate for automated checks).
Shallow clones degrade gracefully: with no visible history each grid
has a single generation and nothing to regress against.
"""
from __future__ import annotations

import argparse
import html as _html
import json
import os
import subprocess
from typing import Dict, List, Optional, Tuple

__all__ = ["Generation", "build_report", "flatten_metrics", "grid_flags",
           "main", "regressions", "render_console", "render_html",
           "sparkline"]

_SPARK = "▁▂▃▄▅▆▇█"


class Generation:
    """One committed (or working-tree) state of a grid file."""

    __slots__ = ("label", "payload", "error")

    def __init__(self, label: str, payload: Optional[Dict],
                 error: str = ""):
        self.label = label
        self.payload = payload
        self.error = error

    @property
    def readable(self) -> bool:
        return isinstance(self.payload, dict)

    def __repr__(self):
        state = "ok" if self.readable else f"error: {self.error}"
        return f"Generation({self.label}, {state})"


def _git(args: List[str], cwd: str) -> Tuple[int, str]:
    try:
        proc = subprocess.run(["git", *args], cwd=cwd,
                              capture_output=True, text=True, timeout=30)
        return proc.returncode, proc.stdout
    except (OSError, subprocess.SubprocessError):
        return 1, ""


def _parse_grid(text: str) -> Tuple[Optional[Dict], str]:
    try:
        payload = json.loads(text)
    except ValueError as e:
        return None, f"invalid JSON: {e}"
    if not isinstance(payload, dict):
        return None, f"grid must be a JSON object, got {type(payload).__name__}"
    for k, v in payload.items():
        if k.startswith("_") and k != "_cache_info" \
                and not isinstance(v, (bool, dict)):
            return None, f"acceptance flag {k} must be a bool, got {v!r}"
    return payload, ""


def generations(path: str, *, limit: int = 12) -> List[Generation]:
    """Oldest-first generations of one grid: committed states from git
    history plus the working tree when it differs from HEAD.  Outside a
    git checkout (or in a shallow clone with no visible history) the
    on-disk file is the only generation."""
    path = os.path.abspath(path)
    cwd = os.path.dirname(path) or "."
    out: List[Generation] = []
    rc, top = _git(["rev-parse", "--show-toplevel"], cwd)
    rel = None
    if rc == 0 and top.strip():
        rel = os.path.relpath(path, top.strip()).replace(os.sep, "/")
        rc, log = _git(["log", "--format=%h", "--follow", "--", rel],
                       top.strip())
        shas = [s for s in log.split() if s] if rc == 0 else []
        for sha in reversed(shas[:limit]):            # oldest first
            rc, blob = _git(["show", f"{sha}:{rel}"], top.strip())
            if rc != 0:
                out.append(Generation(sha, None, "git show failed"))
                continue
            payload, err = _parse_grid(blob)
            out.append(Generation(sha, payload, err))
    try:
        with open(path, encoding="utf-8") as fh:
            disk = fh.read()
    except OSError as e:
        if not out:
            out.append(Generation("worktree", None, str(e)))
        return out
    payload, err = _parse_grid(disk)
    if rel is not None and out:
        rc, head = _git(["show", f"HEAD:{rel}"],
                        os.path.dirname(os.path.abspath(path)))
        if rc == 0 and head == disk:
            return out                 # worktree == HEAD: no extra gen
    out.append(Generation("worktree", payload, err))
    return out


def flatten_metrics(payload: Dict, prefix: str = "") -> Dict[str, float]:
    """Flatten a grid to dotted scalar metrics.  Booleans, strings,
    lists and the ``_cache_info`` block are skipped — flags are handled
    by :func:`grid_flags`, and only scalars can trend."""
    out: Dict[str, float] = {}
    for k, v in sorted(payload.items()):
        if k == "_cache_info":
            continue
        key = f"{prefix}{k}"
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            out[key] = float(v)
        elif isinstance(v, dict):
            out.update(flatten_metrics(v, prefix=f"{key}."))
    return out


def grid_flags(payload: Dict) -> Dict[str, bool]:
    """The grid's top-level ``_``-prefixed acceptance booleans."""
    return {k: v for k, v in sorted(payload.items())
            if k.startswith("_") and isinstance(v, bool)}


def regressions(name: str, gens: List[Generation]) -> List[str]:
    """Machine flags for one grid: newest generation unreadable, or an
    acceptance flag that went True -> False vs the previous readable
    generation."""
    out: List[str] = []
    if not gens:
        return [f"{name}: no generations found"]
    newest = gens[-1]
    if not newest.readable:
        return [f"{name}@{newest.label}: unreadable grid ({newest.error})"]
    prior = [g for g in gens[:-1] if g.readable]
    if not prior:
        return out
    prev = prior[-1]
    prev_flags = grid_flags(prev.payload)
    for flag, val in grid_flags(newest.payload).items():
        if prev_flags.get(flag) is True and val is False:
            out.append(f"{name}: {flag} regressed True->False "
                       f"({prev.label} -> {newest.label})")
    return out


def sparkline(values: List[float]) -> str:
    """Unicode sparkline; constant series renders mid-height."""
    xs = [v for v in values if v == v]          # drop NaN
    if not xs:
        return ""
    lo, hi = min(xs), max(xs)
    if hi <= lo:
        return _SPARK[3] * len(values)
    out = []
    for v in values:
        if v != v:
            out.append(" ")
            continue
        idx = int((v - lo) / (hi - lo) * (len(_SPARK) - 1))
        out.append(_SPARK[idx])
    return "".join(out)


def _trend_rows(gens: List[Generation]) -> List[Tuple[str, List[float]]]:
    """(metric, per-generation series) with NaN filling gaps."""
    readable = [g for g in gens if g.readable]
    keys: List[str] = []
    per_gen = [flatten_metrics(g.payload) for g in readable]
    for m in per_gen:
        for k in m:
            if k not in keys:
                keys.append(k)
    return [(k, [m.get(k, float("nan")) for m in per_gen])
            for k in sorted(keys)]


def _fmt_val(v: float) -> str:
    if v != v:
        return "-"
    if v == 0:
        return "0"
    av = abs(v)
    if av >= 1e5 or av < 1e-3:
        return f"{v:.3g}"
    if float(v).is_integer() and av < 1e5:
        return str(int(v))
    return f"{v:.4g}"


def _delta(series: List[float]) -> str:
    xs = [v for v in series if v == v]
    if len(xs) < 2 or xs[0] == 0:
        return ""
    pct = (xs[-1] / xs[0] - 1.0) * 100.0
    if abs(pct) < 0.05:
        return "="
    return f"{pct:+.1f}%"


def build_report(bench_dir: str, *, limit: int = 12) -> Dict:
    """Load every ``*_grid.json`` under ``bench_dir`` with history.
    Returns ``{"grids": {name: [Generation...]}, "regressions": [...]}``.
    """
    grids: Dict[str, List[Generation]] = {}
    flagged: List[str] = []
    if not os.path.isdir(bench_dir):
        return {"grids": grids,
                "regressions": [f"bench dir not found: {bench_dir}"]}
    for fname in sorted(os.listdir(bench_dir)):
        if not fname.endswith("_grid.json"):
            continue
        name = fname[:-len("_grid.json")]
        gens = generations(os.path.join(bench_dir, fname), limit=limit)
        grids[name] = gens
        flagged.extend(regressions(name, gens))
    return {"grids": grids, "regressions": flagged}


def render_console(report: Dict, *, max_rows: int = 0) -> str:
    """Plain-text trend tables, one per grid."""
    lines: List[str] = []
    for name, gens in report["grids"].items():
        labels = [g.label for g in gens if g.readable]
        lines.append(f"== {name} ({len(labels)} generation"
                     f"{'s' if len(labels) != 1 else ''}: "
                     f"{' -> '.join(labels) or 'none readable'}) ==")
        for g in gens:
            if not g.readable:
                lines.append(f"  !! {g.label}: {g.error}")
        rows = _trend_rows(gens)
        if max_rows and len(rows) > max_rows:
            lines.append(f"  (showing {max_rows}/{len(rows)} metrics)")
            rows = rows[:max_rows]
        if rows:
            width = max(len(k) for k, _ in rows)
            for key, series in rows:
                last = next((v for v in reversed(series) if v == v),
                            float("nan"))
                lines.append(f"  {key:<{width}}  {sparkline(series):<12} "
                             f"{_fmt_val(last):>10}  {_delta(series)}")
        if gens and gens[-1].readable:
            for flag, val in grid_flags(gens[-1].payload).items():
                lines.append(f"  {flag}: {'PASS' if val else 'FAIL'}")
        lines.append("")
    if report["regressions"]:
        lines.append("REGRESSIONS:")
        lines.extend(f"  - {r}" for r in report["regressions"])
    else:
        lines.append("no regressions vs previous committed generations")
    return "\n".join(lines)


def _svg_spark(series: List[float], w: int = 120, h: int = 24) -> str:
    xs = [(i, v) for i, v in enumerate(series) if v == v]
    if len(xs) < 2:
        return f'<svg width="{w}" height="{h}"></svg>'
    lo = min(v for _, v in xs)
    hi = max(v for _, v in xs)
    rng = (hi - lo) or 1.0
    n = max(i for i, _ in xs) or 1
    pts = " ".join(
        f"{i / n * (w - 4) + 2:.1f},"
        f"{h - 3 - (v - lo) / rng * (h - 6):.1f}" for i, v in xs)
    return (f'<svg width="{w}" height="{h}">'
            f'<polyline fill="none" stroke="#2a6" stroke-width="1.5" '
            f'points="{pts}"/></svg>')


def render_html(report: Dict) -> str:
    """Standalone HTML (inline SVG sparklines, no external assets)."""
    parts = ["<!doctype html><meta charset='utf-8'>"
             "<title>repro bench trajectory</title>"
             "<style>body{font:14px monospace;margin:2em}"
             "table{border-collapse:collapse}"
             "td,th{padding:2px 10px;border-bottom:1px solid #ddd;"
             "text-align:left}.fail{color:#c22;font-weight:bold}"
             ".pass{color:#2a6}</style>",
             "<h1>repro bench trajectory</h1>"]
    regs = report["regressions"]
    if regs:
        parts.append("<h2 class=fail>regressions</h2><ul>")
        parts.extend(f"<li class=fail>{_html.escape(r)}</li>" for r in regs)
        parts.append("</ul>")
    else:
        parts.append("<p class=pass>no regressions vs previous committed "
                     "generations</p>")
    for name, gens in report["grids"].items():
        labels = " &rarr; ".join(_html.escape(g.label) for g in gens
                                 if g.readable)
        parts.append(f"<h2>{_html.escape(name)}</h2>"
                     f"<p>generations: {labels or 'none readable'}</p>")
        if gens and gens[-1].readable:
            flags = grid_flags(gens[-1].payload)
            if flags:
                parts.append("<p>" + " ".join(
                    f"<span class={'pass' if v else 'fail'}>"
                    f"{_html.escape(k)}={'PASS' if v else 'FAIL'}</span>"
                    for k, v in flags.items()) + "</p>")
        rows = _trend_rows(gens)
        if rows:
            parts.append("<table><tr><th>metric</th><th>trend</th>"
                         "<th>last</th><th>&Delta;</th></tr>")
            for key, series in rows:
                last = next((v for v in reversed(series) if v == v),
                            float("nan"))
                parts.append(
                    f"<tr><td>{_html.escape(key)}</td>"
                    f"<td>{_svg_spark(series)}</td>"
                    f"<td>{_fmt_val(last)}</td>"
                    f"<td>{_delta(series)}</td></tr>")
            parts.append("</table>")
    return "".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Cross-commit perf trajectory over committed bench "
                    "grids (console + HTML + regression flags).")
    ap.add_argument("--dir", default=os.path.join("results", "bench"),
                    help="bench grid directory (default: results/bench)")
    ap.add_argument("--html", metavar="PATH", default=None,
                    help="also write a standalone HTML report")
    ap.add_argument("--max-generations", type=int, default=12)
    ap.add_argument("--max-rows", type=int, default=0,
                    help="cap metric rows per grid in console output "
                         "(0 = all)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on regression flags or an unreadable "
                         "newest grid (gate mode)")
    args = ap.parse_args(argv)

    report = build_report(args.dir, limit=args.max_generations)
    print(render_console(report, max_rows=args.max_rows))
    if args.html:
        with open(args.html, "w", encoding="utf-8") as fh:
            fh.write(render_html(report))
        print(f"\nhtml report: {args.html}")
    if not report["grids"]:
        print(f"no *_grid.json under {args.dir}")
        return 1 if args.check else 0
    if args.check and report["regressions"]:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
