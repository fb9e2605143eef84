"""Closed-loop serving-knob autotuning over recorded traffic.

``python -m repro_torch.tune`` fits the planner's cost-model *constants*;
this module closes the remaining loop: the ``QueryEngine`` throughput
knobs (``max_batch``, ``max_wait_ms``, ``pad_factor``, ``queue_cap``) are
searched against a deterministically replayed traffic trace
(``repro_torch.serving.trace``, on ``device``) instead of being
hand-picked.  The search is a successive-halving grid: every
config replays the trace (virtual-clock arrivals, real execution), configs
are ranked by replayed throughput with p99 latency as the tie-break, and
survivors re-replay with more timing iterations until one winner remains.

The winner is written next to the calibration profiles under
``results/profiles/`` with the same backend-signature keying
(``serving_<platform>_<device>_<count>.json``, committed reference fallback
``serving_default.json``) and the same ``cost_model_token()`` staleness
guard: a knob profile tuned under one cost model is flagged stale once the
planner's constants change, because the plans — and therefore the optimal
batching — may have changed with them.

CLI::

    python -m repro_torch.autotune               # golden trace, full grid
    python -m repro_torch.autotune --smoke       # CI: small grid, 1 round
    python -m repro_torch.autotune --trace my.jsonl --out knobs.json
    python -m repro_torch.autotune --synthesize t.jsonl --queries 32
    python -m repro_torch.autotune --device cpu  # replay on the host
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import profile as profile_mod

#: serialization schema for serving-knob profiles
SERVING_SCHEMA_VERSION = 1
SERVING_KIND = "repro-serving-knobs"
SERVING_DEFAULT_NAME = "serving_default"

#: the engine's shipped constructor defaults — always evaluated first, so
#: the winner can never be worse than what an untuned engine would use
DEFAULT_KNOBS: Dict = {"max_batch": 32, "max_wait_ms": 2.0,
                       "pad_factor": 4.0, "queue_cap": 1024}


def knob_grid(smoke: bool = False) -> List[Dict]:
    """The search space: engine-knob combinations, defaults first.

    ``queue_cap`` rides along as 8x ``max_batch`` (backpressure headroom
    scales with batch size; an independent axis would mostly produce
    invalid ``queue_cap < max_batch`` points).
    """
    if smoke:
        batches = (8, 64)
        waits = (0.5, 4.0)
        pads = (4.0,)
    else:
        batches = (8, 16, 32, 64, 128)
        waits = (0.25, 1.0, 2.0, 8.0)
        pads = (1.0, 4.0, 8.0)
    grid = [dict(DEFAULT_KNOBS)]
    for mb in batches:
        for wait in waits:
            for pad in pads:
                cfg = {"max_batch": mb, "max_wait_ms": wait,
                       "pad_factor": pad,
                       "queue_cap": max(8 * mb, DEFAULT_KNOBS["queue_cap"])}
                if cfg not in grid:
                    grid.append(cfg)
    return grid


def evaluate_knobs(trace, knobs: Dict, *, iters: int = 1,
                   async_mode: bool = False, device="cuda") -> Dict:
    """Replay ``trace`` under ``knobs`` ``iters`` times on ``device``;
    best-of wall time (every replayed route ends in a synchronise on a
    CUDA device).

    Returns the ranking record: throughput (``qps``), latency percentiles
    (virtual queue wait + real execution per request), and the replay
    digest (determinism witness).
    """
    from repro_torch.serving.trace import replay_trace
    best = None
    for _ in range(max(1, iters)):
        rep = replay_trace(trace, knobs=knobs, async_mode=async_mode,
                           device=device)
        if best is None or rep.wall_s < best.wall_s:
            best = rep
    return {"knobs": dict(knobs), "qps": best.qps, "wall_s": best.wall_s,
            "lat_p50_s": best.lat_p50_s, "lat_p99_s": best.lat_p99_s,
            "digest": best.digest,
            "mean_batch": best.counters["mean_batch"],
            "buckets_executed": best.counters["buckets_executed"]}


def _rank_key(entry: Dict) -> Tuple:
    return (-entry["qps"], entry["lat_p99_s"], entry["lat_p50_s"])


def autotune(trace, *, smoke: bool = False, rounds: int = 2,
             keep_frac: float = 1 / 3, iters0: int = 1,
             async_mode: bool = False, verbose: bool = True,
             device="cuda") -> Dict:
    """Successive-halving knob search against a replayed trace.

    Round r evaluates the surviving configs with ``iters0 + r`` timing
    iterations each and keeps the top ``keep_frac``; the final round's
    best entry is the winner.  The first replay (default knobs) also warms
    the process-wide plan/program caches so every config is measured warm —
    the same steady state a long-running server sees.
    """
    configs = knob_grid(smoke)
    evaluate_knobs(trace, DEFAULT_KNOBS, iters=1, async_mode=async_mode,
                   device=device)

    survivors = [dict(knobs=cfg) for cfg in configs]
    for rnd in range(max(1, rounds)):
        iters = iters0 + rnd
        for entry in survivors:
            entry.update(evaluate_knobs(trace, entry["knobs"], iters=iters,
                                        async_mode=async_mode,
                                        device=device))
        survivors.sort(key=_rank_key)
        if verbose:
            top = survivors[0]
            print(f"[autotune] round {rnd + 1}/{rounds}: "
                  f"{len(survivors)} configs x {iters} iters; best "
                  f"{top['qps']:.1f} q/s p99 {top['lat_p99_s'] * 1e3:.1f}ms "
                  f"{top['knobs']}", flush=True)
        if rnd < rounds - 1:
            keep = max(2, math.ceil(len(survivors) * keep_frac))
            survivors = survivors[:keep]

    winner = survivors[0]
    default_entry = next(
        (e for e in survivors if e["knobs"] == DEFAULT_KNOBS), None)
    if default_entry is None:
        default_entry = evaluate_knobs(trace, DEFAULT_KNOBS,
                                       iters=iters0 + rounds - 1,
                                       async_mode=async_mode,
                                       device=device)
    return {
        "winner": winner,
        "default": default_entry,
        "ranked": survivors,
        "improvement": winner["qps"] / max(default_entry["qps"], 1e-12),
        "trace": {"name": trace.name, "requests": trace.n_requests,
                  "duration_s": trace.duration_s},
        "async_mode": async_mode,
        "device": str(device),
        "rounds": rounds,
        "configs_evaluated": len(configs),
    }


# ---------------------------------------------------------------------------
# Serving-knob profiles: the winner, pinned on disk
# ---------------------------------------------------------------------------


class ServingProfileError(ValueError):
    """A serving-knob profile failed validation or is stale."""


def serving_profile_path(backend: Optional[Dict] = None,
                         directory: Optional[str] = None,
                         device="cuda") -> str:
    backend = backend or profile_mod.backend_signature(device)
    return os.path.join(directory or profile_mod.profile_dir(),
                        "serving_" + profile_mod.profile_key(backend)
                        + ".json")


def save_serving_profile(result: Dict, path: Optional[str] = None,
                         name: Optional[str] = None) -> str:
    """Write an :func:`autotune` result as a pinned knob profile, keyed by
    the device the result was replayed on (with that device's provenance
    under ``meta``: on a CUDA device the card's name and power limit).

    The profile records the planner's ``cost_model_token()`` at tune time:
    knobs were chosen for the bucket/plan behavior that token implies, so
    :func:`load_serving_knobs` treats a token mismatch as staleness — the
    same guard the plan caches use after a recalibration.
    """
    from repro_torch.core.planner import cost_model_token
    device = result.get("device", "cuda")
    backend = profile_mod.backend_signature(device)
    path = path or serving_profile_path(backend)
    payload = {
        "schema": SERVING_SCHEMA_VERSION,
        "kind": SERVING_KIND,
        "name": name or ("serving_" + profile_mod.profile_key(backend)),
        "backend": backend,
        "knobs": result["winner"]["knobs"],
        "score": {k: result["winner"][k]
                  for k in ("qps", "lat_p50_s", "lat_p99_s", "mean_batch")},
        "default_score": {k: result["default"][k]
                          for k in ("qps", "lat_p50_s", "lat_p99_s")},
        "improvement": result["improvement"],
        "trace": result["trace"],
        "async_mode": result["async_mode"],
        "cost_model_token": cost_model_token(),
        "ranked": [{"knobs": e["knobs"], "qps": e["qps"],
                    "lat_p99_s": e["lat_p99_s"]}
                   for e in result["ranked"]],
        "meta": profile_mod.device_meta(device),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_serving_profile(path: Optional[str] = None,
                         directory: Optional[str] = None,
                         device="cuda") -> Dict:
    """Load a serving-knob profile: explicit ``path``, else ``device``'s
    registry entry, else the committed ``serving_default.json``."""
    if path is None:
        directory = directory or profile_mod.profile_dir()
        path = serving_profile_path(directory=directory, device=device)
        if not os.path.exists(path):
            path = os.path.join(directory, SERVING_DEFAULT_NAME + ".json")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no serving-knob profile for this backend under "
                f"{directory!r} and no {SERVING_DEFAULT_NAME}.json fallback "
                f"(run python -m repro_torch.autotune)")
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict) or raw.get("kind") != SERVING_KIND:
        raise ServingProfileError(f"{path}: not a {SERVING_KIND} profile")
    if raw.get("schema") != SERVING_SCHEMA_VERSION:
        raise ServingProfileError(
            f"{path}: unsupported serving-knob schema {raw.get('schema')!r} "
            f"(this build reads {SERVING_SCHEMA_VERSION})")
    missing = [k for k in ("knobs", "backend", "cost_model_token")
               if k not in raw]
    if missing:
        raise ServingProfileError(f"{path}: missing fields {missing}")
    raw["path"] = path
    return raw


def serving_knobs_stale(profile: Dict) -> bool:
    """True when the live cost model differs from the one the knobs were
    tuned under (plans — and optimal batching — may have changed)."""
    from repro_torch.core.planner import cost_model_token
    return profile["cost_model_token"] != cost_model_token()


def load_serving_knobs(path: Optional[str] = None, *,
                       allow_stale: bool = False) -> Dict:
    """The pinned engine knobs, staleness-guarded.

    Raises :class:`ServingProfileError` when the profile was tuned under a
    different ``cost_model_token`` unless ``allow_stale`` — serving with
    knobs tuned for another cost model silently forfeits the tuning.
    """
    profile = load_serving_profile(path)
    if serving_knobs_stale(profile) and not allow_stale:
        from repro_torch.core.planner import cost_model_token
        raise ServingProfileError(
            f"{profile['path']}: knobs tuned under cost model "
            f"{profile['cost_model_token']!r} but the live token is "
            f"{cost_model_token()!r} — retune (python -m repro_torch.autotune) "
            f"or pass allow_stale=True")
    return dict(profile["knobs"])


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _resolve_trace(args) -> "object":
    from repro_torch.serving.trace import (Trace, golden_trace_path,
                                           synthesize_trace)
    if args.synthesize:
        tr = synthesize_trace(
            name=os.path.splitext(os.path.basename(args.synthesize))[0],
            n=args.n, queries=args.queries, seed=args.seed)
        tr.save(args.synthesize)
        print(f"[autotune] synthesized {tr.n_requests}-request trace "
              f"-> {args.synthesize}", flush=True)
        return tr
    if args.trace:
        return Trace.load(args.trace)
    path = golden_trace_path()
    if os.path.exists(path):
        print(f"[autotune] using golden trace {path}", flush=True)
        return Trace.load(path)
    print("[autotune] no golden trace found; synthesizing a throwaway "
          "stream", flush=True)
    return synthesize_trace(name="throwaway", n=args.n,
                            queries=args.queries, seed=args.seed)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.autotune",
        description="search QueryEngine knobs against a replayed traffic "
                    "trace; pin the winner next to the calibration profile")
    ap.add_argument("--trace", default=None,
                    help="trace JSONL to replay (default: the committed "
                         "golden trace)")
    ap.add_argument("--smoke", action="store_true",
                    help="small grid + 1 round (CI)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="halving rounds (default: 1 smoke, 2 full)")
    ap.add_argument("--out", default=None,
                    help="write the knob profile here instead of the "
                         "results/profiles/ registry")
    ap.add_argument("--async-replay", action="store_true",
                    help="replay through the async worker instead of the "
                         "sync flush_due path (same schedule, real threads)")
    ap.add_argument("--synthesize", metavar="PATH", default=None,
                    help="synthesize a throwaway trace, save it at PATH, "
                         "and tune against it")
    ap.add_argument("--export-golden", metavar="PATH", default=None,
                    help="write the canonical golden trace (fixed "
                         "generator parameters) and exit")
    ap.add_argument("--n", type=int, default=96,
                    help="matrix size for synthesized traces")
    ap.add_argument("--queries", type=int, default=48,
                    help="request count for synthesized traces")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device the replays run on and the profile is "
                         "keyed by (default: cuda)")
    args = ap.parse_args(argv)

    if args.export_golden:
        from repro_torch.serving.trace import synthesize_trace
        tr = synthesize_trace(name="golden_v1", n=96, n_structs=3,
                              queries=48, mean_gap_ms=0.5, seed=7)
        path = tr.save(args.export_golden)
        print(f"wrote {path} ({tr.n_requests} requests, "
              f"{tr.duration_s * 1e3:.1f}ms span)")
        return 0

    trace = _resolve_trace(args)
    rounds = args.rounds if args.rounds is not None else (1 if args.smoke
                                                         else 2)
    t0 = time.perf_counter()
    result = autotune(trace, smoke=args.smoke, rounds=rounds,
                      async_mode=args.async_replay, device=args.device)
    took = time.perf_counter() - t0

    win = result["winner"]
    print(f"[autotune] winner after {took:.1f}s: {win['knobs']}")
    print(f"[autotune]   {win['qps']:.1f} q/s (default "
          f"{result['default']['qps']:.1f} q/s, "
          f"{result['improvement']:.2f}x), p50 "
          f"{win['lat_p50_s'] * 1e3:.1f}ms p99 "
          f"{win['lat_p99_s'] * 1e3:.1f}ms, mean batch "
          f"{win['mean_batch']:.1f}")
    name = (os.path.splitext(os.path.basename(args.out))[0]
            if args.out else None)
    path = save_serving_profile(result, path=args.out, name=name)
    print(f"[autotune] wrote {path}")
    print("[autotune] engines pick it up via repro_torch.tuning.autotune."
          "load_serving_knobs() -> QueryEngine(**knobs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
