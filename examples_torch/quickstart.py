"""Quickstart: Masked SpGEMM in five minutes, on the PyTorch/CUDA port.

    PYTHONPATH=src python examples_torch/quickstart.py               # the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

Covers: the adaptive planner (``algorithm="auto"``, the default), the six
fixed algorithms, semirings, complemented masks, the block/tile path,
backend calibration profiles, and triangle counting.  Every call takes the
device it runs on (``--device``, the card by default).
"""
import argparse

import numpy as np
import torch

from repro_torch.core.formats import (bcsr_from_csr, csr_from_dense,
                                      erdos_renyi)
from repro_torch.core.masked_spgemm import masked_spgemm
from repro_torch.core.planner import plan, plan_cache_info
from repro_torch.core.semiring import MIN_PLUS
from repro_torch.graphs import triangle_count
from repro_torch.kernels.masked_matmul.ops import block_spgemm


def main(argv=None) -> dict:
    """Run the example; returns its deterministic results."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu to run on the CPU)")
    nnz = {}

    rng = np.random.default_rng(0)
    m, k, n = 64, 48, 56
    A = ((rng.random((m, k)) < 0.2) * rng.uniform(1, 2, (m, k))
         ).astype(np.float32)
    B = ((rng.random((k, n)) < 0.2) * rng.uniform(1, 2, (k, n))
         ).astype(np.float32)
    M = (rng.random((m, n)) < 0.3).astype(np.float32)

    # --- 0. the default entry point: let the planner pick -----------------
    # ``algorithm="auto"`` inspects cheap structural statistics (densities,
    # padded widths, a sampled symbolic probe) and dispatches to the
    # cheapest kernel per the paper's Sec. 7-8 guidelines.  Plans are
    # cached by structural signature, so repeated shapes skip re-planning.
    out = masked_spgemm(csr_from_dense(A), csr_from_dense(B),
                        csr_from_dense(M), device=device)  # algorithm="auto"
    p = plan(csr_from_dense(A), csr_from_dense(B), csr_from_dense(M),
             device=device)
    nnz["auto"] = int(out.nnz)
    print(f"auto     nnz(C) = {int(out.nnz)}  "
          f"(planner chose {p.algorithm!r}; "
          f"tile_eligible={p.tile_eligible}; cache={plan_cache_info()})")

    # --- 1. C = M .* (A @ B) with every fixed algorithm -------------------
    for algo in ("msa", "hash", "mca", "heap", "heapdot", "inner"):
        out = masked_spgemm(csr_from_dense(A), csr_from_dense(B),
                            csr_from_dense(M), algorithm=algo, device=device)
        nnz[algo] = int(out.nnz)
        print(f"{algo:8s} nnz(C) = {int(out.nnz)}")

    # --- 2. semirings: min-plus shortest-path style product ---------------
    out = masked_spgemm(csr_from_dense(A), csr_from_dense(B),
                        csr_from_dense(M), algorithm="msa",
                        semiring=MIN_PLUS, device=device)
    nnz["min_plus"] = int(out.nnz)
    print("min_plus nnz(C) =", int(out.nnz))

    # --- 3. complemented mask (BC-style traversal) -------------------------
    vals, present = masked_spgemm(csr_from_dense(A), csr_from_dense(B),
                                  csr_from_dense(M), algorithm="msa",
                                  complement=True, device=device)
    nnz["complement"] = int(present.sum())
    print("complement nnz =", int(present.sum()))

    # --- 4. the tile route (BCSR, densify-free) ----------------------------
    # ``algorithm="tile"`` runs the whole product on the block product
    # (a CUDA kernel on the card, its plain PyTorch version on the CPU):
    # CSR operands scatter straight into occupied blocks on the device, the
    # vectorized host schedule is the paper's symbolic phase made free by
    # the mask bound, and the result comes back in the same mask-aligned
    # layout as the row kernels.  With ``algorithm="auto"`` the planner
    # elects this route itself whenever its modeled cost beats every row
    # kernel (dense-block operands).
    out = masked_spgemm(csr_from_dense(A), csr_from_dense(B),
                        csr_from_dense(M), algorithm="tile", tile_block=8,
                        device=device)
    nnz["tile"] = int(out.nnz)
    print("tile     nnz(C) =", int(out.nnz))

    # the lower-level BCSR entry point, for operands already in block form
    Ab = bcsr_from_csr(csr_from_dense(A[:, :48]), 8, device=device)
    Bb = bcsr_from_csr(csr_from_dense(B[:48, :48]), 8, device=device)
    Mb = bcsr_from_csr(
        csr_from_dense((rng.random((64, 48)) < 0.3).astype(np.float32)), 8,
        device=device)
    C = block_spgemm(Ab, Bb, Mb)
    nnz["block_spgemm tiles"] = C.nnzb
    print("block_spgemm tiles =", C.nnzb)

    # --- 5. distributed: the same product across a mesh --------------------
    # ``distributed_masked_spgemm`` is the mesh counterpart of
    # ``masked_spgemm``: ``algorithm="auto"`` weighs replicating B
    # (row-parallel, zero numeric-phase communication) against rotating
    # B's occupied BCSR K-slabs around a ring (sparse ring-SUMMA — no
    # dense (k, n)/(m, n) array anywhere, memory O(nnzb/p) per shard).
    # Runs on any mesh; here the 1-shard degenerate ring.  ``make_mesh(p)``
    # cycles its p shards over the visible cards (on one card every shard
    # shares it); ``make_mesh(p, device="cpu")`` puts them all on the CPU.
    from repro_torch.core import make_mesh
    from repro_torch.core.distributed import distributed_masked_spgemm
    mesh = make_mesh(1, device=device)
    out = distributed_masked_spgemm(csr_from_dense(A), csr_from_dense(B),
                                    csr_from_dense(M), mesh)
    nnz["distributed"] = int(out.nnz)
    print("distributed nnz(C) =", int(out.nnz))
    forced = distributed_masked_spgemm(csr_from_dense(A), csr_from_dense(B),
                                       csr_from_dense(M), mesh,
                                       algorithm="ring", block_size=8)
    nnz["sparse ring"] = int(forced.nnz)
    print("sparse ring nnz(C) =", int(forced.nnz))

    # --- 6. calibrating the planner for YOUR backend ------------------------
    # Every decision above was priced by the builtin cost tables, fit on a
    # CPU.  On other hardware, don't hand-tune them — fit them:
    #
    #   PYTHONPATH=src python -m repro_torch.tune            # full probe grids
    #   PYTHONPATH=src python -m repro_torch.tune --smoke    # a quick fit
    #   PYTHONPATH=src python -m repro_torch.tune --only row,tile,dist
    #
    # That times the row kernels / tile route / distributed routes on small
    # synthetic grids on the device, solves the planner's cost models for
    # their constants (reporting fit residuals), and registers the profile
    # under results/profiles/ keyed by backend signature (an H100 profile
    # is committed there).  Install one with
    # ``repro_torch.tuning.activate(profile)`` in-process, or export
    # ``REPRO_TUNE_PROFILE=/path/to/profile.json`` for whole process trees.
    # Activation can never serve stale decisions: plan caches are keyed by
    # the active profile's version token.
    from repro_torch.tuning import active_version, backend_signature, lookup
    prof, exact = lookup(backend_signature(device))   # default fallback
    print(f"calibration: active={active_version()!r} "
          f"registry={prof.name!r} (exact={exact}, "
          f"version={prof.version})")

    # --- 7. a real application: triangle counting --------------------------
    g = erdos_renyi(512, 8, seed=1)
    tri, secs = triangle_count(g, algorithm="msa", device=device)
    print(f"triangles = {tri} ({secs * 1e3:.0f} ms masked-SpGEMM time)")

    # --- 8. serving a query stream -----------------------------------------
    # ``QueryEngine`` amortizes structure-dependent decisions across
    # queries: requests are bucketed by structural signature, each bucket
    # is served by ONE cached plan + one compiled program, and a bounded
    # content-keyed result cache catches exact repeats.  Same-structure
    # bursts on scatter plans (msa/hash/mca) run the structure-compiled
    # replay, bitwise-identical to one-shot calls: 61-78x one-shot
    # throughput on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
    # (PERF.md).
    from repro_torch.serving import QueryEngine
    from repro_torch.core.formats import CSR
    A_c, B_c, M_c = (csr_from_dense(A), csr_from_dense(B),
                     csr_from_dense(M))

    def fresh_values(x, seed):
        r = np.random.default_rng(seed)
        return CSR(x.indptr, x.indices,
                   r.uniform(1, 2, x.nnz).astype(np.float32), x.shape)

    with QueryEngine(max_batch=32, device=device) as engine:   # sync mode
        tickets = [engine.submit(fresh_values(A_c, s), B_c, M_c)
                   for s in range(8)]             # one bucket, one plan
        tri_ticket = engine.submit_triangle(g)    # composites batch too
        engine.flush()
        nnz["served"] = int(tickets[0].result().nnz)
        print("served nnz(C) =", int(tickets[0].result().nnz),
              "| triangles =", tri_ticket.result())
        replay = engine.submit(fresh_values(A_c, 0), B_c, M_c)
        cache_hit = replay.done()                 # byte-equal operands
        print("result-cache hit:", cache_hit,
              "| stats:", engine.metrics.snapshot()["result_cache_hits"],
              "hits |", engine.results.info())

    # async mode: submit returns future-like tickets immediately; a worker
    # thread flushes full buckets at once and partial buckets after
    # max_wait_ms.  Backpressure: at most queue_cap requests pending.
    with QueryEngine(async_mode=True, max_batch=16,
                     max_wait_ms=2.0, device=device) as engine:
        t = engine.submit(A_c, B_c, M_c)
        nnz["async"] = int(t.result(timeout=30).nnz)
        print("async nnz(C) =", nnz["async"])

    # every cache in the process is bounded and visible:
    from repro_torch import caches
    sizes = {k: v["size"] for k, v in caches.cache_info().items()}
    print("caches:", sizes)                       # caches.clear_all() empties

    # --- 9. record -> replay -> autotune the serving knobs -----------------
    # Capture real traffic with a recorder on the engine, replay it
    # deterministically under a virtual clock (bit-identical bucket
    # schedule + byte-exact results, sync or async), then search the knob
    # grid against the replayed stream and pin the winner:
    #
    #     python -m repro_torch.autotune           # golden trace, full grid
    #     python -m repro_torch.autotune --smoke   # a small search
    #
    from repro_torch.serving import TraceRecorder, Trace, replay_trace
    from repro_torch.serving.trace import spec_inline
    rec = TraceRecorder(name="quickstart")
    with QueryEngine(recorder=rec, cache_results=False,
                     device=device) as engine:
        # register_operand(obj, spec) records a generator spec instead of
        # inlining bytes; unregistered operands embed base64 CSR payloads
        rec.register_operand(A_c, spec_inline(A_c))
        for s in range(4):
            engine.submit(fresh_values(A_c, s), B_c, M_c)
        engine.flush()
    trace = Trace.loads(rec.trace().dumps())      # JSONL round-trip
    r1 = replay_trace(trace, device=device)
    r2 = replay_trace(trace, async_mode=True, device=device)
    print("replay digests (sync == async):", r1.digest, r2.digest,
          "| qps:", round(r1.qps, 1))
    # the autotuner ranks knob configs by replayed throughput/latency and
    # writes results/profiles/serving_<backend>.json with the same
    # cost_model_token staleness guard the plan caches use; serve with:
    #     from repro_torch.tuning.autotune import load_serving_knobs
    #     engine = QueryEngine(**load_serving_knobs())

    # --- 10. the invariant linter: machine-checked correctness rules -------
    #
    # The hard-won rules of the serving stack are enforced statically by
    # `repro_torch.analysis` (AST-based, never imports your code):
    #
    #     PYTHONPATH=src python -m repro_torch.lint                # text report
    #     PYTHONPATH=src python -m repro_torch.lint --format=json  # CI gate
    #     PYTHONPATH=src python -m repro_torch.lint --list-rules
    #     PYTHONPATH=src python -m repro_torch.lint --only lock-discipline
    #
    # Six rules: no-densify (no to_dense on core/kernels/serving hot
    # paths), clock-discipline (serving scheduling reads the injectable
    # clock — replay determinism), cache-registry (every module cache
    # registered in repro_torch.caches — bounded memory), plan-cache-key
    # (structure-derived keys carry cost_model_token() — stale-plan
    # guard), lock-discipline (a lock-set race detector over the serving
    # worker/submit paths), and jit-retrace (no mutable captures or
    # per-call container literals at torch.compile / torch.jit
    # boundaries).
    #
    # Intentional exceptions are in-code annotations with a mandatory
    # reason — one escape name per rule, e.g.:
    #
    #     t0 = time.perf_counter()  # lint: clock-ok(duration measurement)
    #     hit = cache.get(key)      # lint: plan-key-ok(structure-pure)
    #     self._hits += 1           # lint: unlocked-ok(approximate stat)
    #
    # Findings can also be suppressed via the committed
    # lint-baseline-torch.json (fingerprints are anchored to line CONTENT,
    # so editing a baselined line revives the finding) — but policy keeps
    # that baseline empty.
    import os

    import repro_torch.analysis
    from repro_torch.analysis import run_lint
    pkg_root = os.path.dirname(os.path.dirname(repro_torch.analysis.__file__))
    findings = run_lint(pkg_root)
    print("invariant linter findings on src/repro_torch:", len(findings))

    # --- 11. incremental serving: edge deltas without a cold restart -------
    #
    # Production graphs mutate under traffic.  `QueryEngine.submit_delta`
    # folds a batch of edge upserts/deletes into the served operands and
    # keeps every structure-derived artifact warm instead of rebuilding:
    # the operand's incremental signature updates in O(changed rows), the
    # plan REVALIDATES (kept while nnz/width drift stays inside the
    # planner's hysteresis band), the burst program's gather lanes are
    # patched only in the changed rows' slot columns on the device
    # (bitwise-equal to a cold rebuild, by construction), and result-cache
    # entries are dropped only for the delta'd structure x affected row
    # range — entries for other structures, or rows the delta provably
    # cannot reach, stay cached.
    from repro_torch.core.formats import CSRDelta
    with QueryEngine(max_batch=8, device=device) as d_engine:
        A_d, B_d, M_d = A_c, B_c, M_c             # the section-9 operands
        d_engine.submit(A_d, B_d, M_d)
        d_engine.flush()                          # warm plan + program
        delta = CSRDelta.upserts([0, 3], [5, 7], [1.5, 0.25])
        out = d_engine.submit_delta(A_d, B_d, M_d, delta_a=delta)
        A_d = out.A                               # post-delta operand
        snap = d_engine.metrics.snapshot()
    counters = {k: snap[k] for k in ("delta_applied", "plans_revalidated",
                                     "lanes_patched", "rows_invalidated")}
    survived = out.plan_survived
    print("delta:", counters, "| plan survived:", survived)
    # A delta goes COLD (ordinary re-plan/rebuild on next use — still
    # correct, just not incremental) when it leaves the local regime:
    # nnz or row-width drift beyond the hysteresis band, a mask pad-width
    # or lane-count change that needs a different compiled shape, or a
    # structural change to B (its values regather; its pattern is pinned).
    # The payoff: a patched program is ready 19-21 ms after a 1 % delta at
    # n = 8192 on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
    # (PERF.md).
    #
    # For long-running serving, `RotatingTraceSink` streams the capture
    # of section 9 to size-capped JSONL segments (logrotate-style, with
    # an optional seeded sample_rate) — each segment replays standalone:
    #     sink = RotatingTraceSink("trace.jsonl", max_bytes=1 << 20)
    #     rec = TraceRecorder(engine, sink=sink, keep_events=False)

    # --- 12. observability: spans, plan explain, /metrics ------------------
    #
    # `repro_torch.obs` threads structured tracing through the whole
    # request lifecycle (submit -> queue wait -> plan -> host prep ->
    # device exec -> cache put/hit, plus the delta path).  Off by default:
    # every instrumented site costs one global read + one branch until you
    # enable it, and tracing leaves results bitwise-equal and the engine's
    # deterministic_snapshot() EQUAL (spans never feed scheduling).
    from repro_torch import obs
    with obs.tracing() as trc:                     # scoped enable
        with QueryEngine(max_batch=8, device=device) as engine:
            for s in range(4):
                engine.submit(fresh_values(A_c, s), B_c, M_c)
            engine.flush()
    spans = trc.sink.spans()
    span_names = sorted({r["name"] for r in spans})
    print("observed span kinds:", span_names)

    # every `serve.plan` span carries `planner.explain(plan)` — the
    # elected algorithm, the cost-feature vector, and each candidate's
    # modeled cost, so modeled-vs-measured residuals fall out of a trace:
    from repro_torch.core.planner import explain
    info = explain(plan(A_c, B_c, M_c, device=device))
    print("plan explain: elected", info["elected"], "| modeled ms:",
          {k: round(v, 4) for k, v in info["costs_ms"].items()})
    print("exec residuals:", obs.export.residual_summary(spans))

    # export the capture for chrome://tracing / https://ui.perfetto.dev
    # (obs.save_chrome_trace(path, spans) writes the same JSON to disk),
    # or stream spans to rotating JSONL with obs.JsonlSpanSink(path):
    print("perfetto events:", len(obs.chrome_trace(spans)["traceEvents"]))

    # live exposition: any engine serves Prometheus text + health JSON
    # from a daemon thread (also standalone: python -m repro_torch.obs.serve)
    import urllib.request
    with QueryEngine(expose_port=0, device=device) as engine:  # 0 = ephemeral
        engine.serve([(A_c, B_c, M_c)])
        with urllib.request.urlopen(
                engine.obs_server.url + "/metrics", timeout=10) as resp:
            families = obs.parse_prometheus(resp.read().decode())
    print("scraped", len(families), "prometheus samples")

    # --- 13. health intelligence: SLO burn rates + cost-model drift --------
    #
    # `repro_torch.obs.health` turns that span stream into an online
    # verdict.  HealthMonitor is itself a sink: ring-sharded sliding
    # windows (O(1) memory on the injectable clock), declarative SLOs
    # evaluated as SRE-style multi-window burn rates ("failing" needs the
    # error budget burning >= 2x on BOTH the 5s and 60s windows, so a
    # single blip never pages), and a drift detector streaming each exec
    # span's modeled-vs-measured residual per (tune family, algorithm,
    # regime).
    from repro_torch.obs.health import HealthMonitor
    monitor = HealthMonitor()            # DEFAULT_SLOS + drift detector
    with obs.tracing(monitor):
        with QueryEngine(monitor=monitor, device=device) as engine:
            for s in range(4):
                engine.submit(fresh_values(A_c, s), B_c, M_c)
            engine.flush()
            healthy = engine.health().status
            print("healthy verdict:", healthy)

            # induced pressure: hash + complement is NotImplemented, so
            # this storm burns the serve-errors budget on both windows;
            # with expose_port= the /health endpoint now answers 503
            # carrying exactly these reasons
            storm = [engine.submit(A_c, B_c, M_c, algorithm="hash",
                                   complement=True) for _ in range(8)]
            engine.flush()
            for t in storm:
                try:
                    t.result()
                except NotImplementedError:
                    pass
            verdict = engine.health()
    print("under pressure:", verdict.status, "-", verdict.reasons[0])

    # a drift flag names the exact refit (`python -m repro_torch.tune
    # --only <family>`) and resets itself when the cost table is retuned;
    # the cross-commit perf trajectory of a directory of bench grids
    # renders via `python -m repro_torch.obs.report --dir <grids>`
    # (--check gates flag regressions)
    print("drift:",
          monitor.drift.report().command or "cost model calibrated")

    return {"nnz": nnz, "triangles": tri,
            "served_triangles": tri_ticket.result(), "cache_hit": cache_hit,
            "calibration_exact": exact, "digests": [r1.digest, r2.digest],
            "lint_findings": len(findings), "delta": counters,
            "plan_survived": survived, "span_names": span_names,
            "health": [healthy, verdict.status]}


if __name__ == "__main__":
    main()
