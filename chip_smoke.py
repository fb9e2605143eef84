#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root; needs CUDA

Phases, each printing its own lines:

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
   TF32 is switched off for matmuls and cuDNN;
2. build: the CUDA kernels, compiled with ``nvcc`` from the sources in
   ``src/repro_torch/kernels/*/csrc`` into ``build/repro_torch/``, one
   ``nvcc`` per source, all started together; ``ptxas``'s registers and
   spills of every kernel instance, and the registers, shared memory and
   resident CTAs per SM of the tensor-core kernels at the path's shapes
   (every ``block_spgemm`` instance, both flash instances);
3. kernel against plain: the ``block_spgemm`` kernel, values only and
   fused with the structural counts, against its plain PyTorch version at
   block sizes 4, 8, 32, 48 and 128 (every instance), with zero-fill
   entries, an empty B and a worklist padded with all-flags-off entries;
   standard-normal data also within 2e-6 normwise of float64;
4. tile route: ``masked_spgemm(A, B, M)`` (algorithm "auto") on an
   n = 8192 block-sparse problem; the planner must elect the tile route
   at block size 128, the fused kernel must launch exactly once and no
   plain version run, the values must equal the dense product at the mask
   and ``present`` the structural product; the call's peak device memory;
   then timings of the fused and the values-only replay, and the steps of
   the call one by one (uploads, block construction and gather on the
   card; the schedule on the host);
5. row route: triangle counting on R-MAT scale 14 (algorithm "auto"),
   checked against scipy;
6. serving: ``QueryEngine`` on the card.  A tile bucket of four tile-8192
   queries (A's structure with integer values from seeds 0-3, B and M
   shared): planned once, tile at block size 128, the fused kernel
   launched exactly four times and no plain version run, each result bit
   for bit the one-shot call's; the same four again are result-cache hits
   with no launch.  A burst bucket of 64 queries on bench_serve's burst
   structure at n = 8192 (one burst program) and a shuffled async stream
   of 64 queries over its four structures, every ticket bit for bit its
   one-shot call.  ``submit_triangle`` on R-MAT scale 14 against
   ``triangle_count``; ``ktruss`` (k = 5) on scale 12 against scipy's
   k-truss and on scale 10 against the CPU port; ``betweenness_centrality``
   (256 sources in 4 chunks) on scale 12, directly and through an engine,
   within 1e-5 of the CPU port; then k-truss timed at scale 13 and
   betweenness at scale 14.
   Prints bucket and per-query times, ``serve.submit`` (the fingerprints),
   peak memory and the bytes of one cached result;
7. delta: incremental serving on the card.  delta-burst-8192: the burst
   structure, 8 rounds of one upsert delta to A touching 82 rows (1 %)
   then 64 fresh-valued queries, through ``submit_delta`` (plan
   revalidated, lanes patched on the card) and through a recompute stream
   (apply the delta, drop the plan cache and every burst program, patch
   and lineage, re-plan and rebuild); per delta the time until the program
   is ready (median of the rounds, ended by a synchronise), the lanes
   patched, the bytes a patch uploads and the device bytes a patched
   program holds; 8 of each round's 64 results of both streams bit for bit
   their one-shot calls.  delta-tile-8192: tile-8192's operands served as
   the tile bucket serves them, a delta of 64 upserts in 16 rows of A: the
   tile plan survives ``revalidate``, a 4-query bucket on the post-delta
   operands launches the fused kernel 4 times, each result bit for bit its
   one-shot call and exact against the dense product at the mask;
   ``submit_delta``'s time beside a cold plan, the result-cache entries it
   evicted and the cache's device bytes before and after.  replay: the
   golden trace (``results/traces/golden_v1.jsonl``) replayed sync and
   async on the card (equal digests, the committed counters, every result
   bit for bit its one-shot call); serve-mixed-8192 captured by
   ``TraceRecorder`` (generator specs only) and replayed twice to one
   digest, its replay queries/s beside the captured run's;
8. tile SDDMM: the ``masked_matmul`` kernel against its plain version over
   the reference's test sweep, then ``ops.masked_matmul`` once at
   M = N = 8192, K = 256, 128-blocks on the tile-8192 mask (one launch,
   equal to the plain version on integer data), the same call on
   standard-normal data (f32 accuracy: 2e-6 normwise); then timings;
9. flash attention: the ``flash_mask`` kernel against its plain version
   over the reference's test sweep (bf16 also within 2e-3 normwise; every
   case on tensor cores, the f32 ones on the 3xTF32 kernel), the decode
   offset and the GQA op, then one full-width llama3.2-1b layer (B 4,
   32/8 heads, S 2048, D 64, causal, bf16); then timings beside
   ``scaled_dot_product_attention``; the f32 instance at the layer's shape
   against its plain version and float64, and its times at B 1 (the f32
   prefill's shape) and B 4 beside f32 ``scaled_dot_product_attention``;
10. LM serving: llama3.2-1b at full width with ``attn_impl="flash_pallas"``
   and random weights from seed 0: a bf16 prefill of 4 x 2,048 tokens (the
   bf16 flash kernel must launch once per layer, 16 times; logits finite
   and close to the same forward with dense attention), a
   ``torch.profiler`` breakdown of one warm prefill by kernel with the
   device's idle share, an f32 prefill of 2,048 tokens (the f32 tensor-core
   flash kernel must launch once per layer) against dense attention, f32
   prefill against teacher-forced decode (the reference's
   decode-consistency property), and ``generate``;
11. tuning (runs after phase 7, on tile-8192's operands): the committed
   H100 cost profile found in the registry (``tuning.lookup()``, exact)
   and validated; the probes of ``repro_torch.tuning`` on their smoke
   grids on the card (the tile probes launch the fused kernel once per
   call, warm-ups included, and no plain version runs) and ``fit_profile``
   on them (finite residuals); the planner's elections at tile-8192,
   tc-rmat14's triangle product, serve-burst-8192's and serve-mixed-8192's
   structures (small-integer values) under the builtin constants and
   under the H100 profile: each elected route, its model ms under both,
   its measured warm ms (median of 3), and where the two elect different
   routes, their results bit for bit equal; the serving-knob search on
   the golden trace (smoke grid, winner no slower than the default), the
   committed H100 knobs loaded under the H100 profile and stale under the
   builtin constants, which the phase leaves active;
12. health (runs after phase 11, on tile-8192's operands and the
   committed H100 profile): serve-mixed-8192's 64-query stream served by
   one engine 11 times plain-traced (``InMemorySink``) and as often under
   a ``HealthMonitor``, in turns: every ticket bit for bit equal, equal
   span names, equal ``deterministic_snapshot()``, the monitored share of
   the time; a monitored engine with ``expose_port=0``: ``/health`` 200
   after one tile-8192 query (one fused launch, no plain version), 503
   with the serve-errors reason after 16 hash + complement requests,
   ``/metrics`` parsed with ``repro_health_status`` 2; a
   ``DriftDetector(band=8)`` over one-query buckets (no burst, no result
   cache) of 8 tile-8192 queries and 8 on each serve-mixed-8192 structure
   under the builtin constants (row and tile flagged, the
   ``repro_torch.tune --only row,tile`` command), the H100 profile (token
   changed, statistics reset) and that profile x256 (both families
   flagged), each run's statistics equal to ``export.residuals`` on its
   spans and one fused launch per tile query; the residuals of phase 6's
   async serve-mixed-8192 stream; the builtin constants left active;
13. one JSON line with every kernel's numbers, then the result line
   ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero without the result line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import caches, obs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch import tuning  # noqa: E402
from repro_torch.core import accumulators as acc  # noqa: E402
from repro_torch.core import formats as F  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.masked_spgemm import (  # noqa: E402
    gather_mask_aligned, masked_spgemm)
from repro_torch.graphs import betweenness_centrality, ktruss  # noqa: E402
from repro_torch.graphs.triangle_counting import (  # noqa: E402
    degree_relabel, triangle_count)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_mask import kernel as flash  # noqa: E402
from repro_torch.kernels.flash_mask.ops import (  # noqa: E402
    flash_mask_attention)
from repro_torch.kernels.flash_mask.ref import mask_allowed  # noqa: E402
from repro_torch.kernels.masked_matmul import kernel, ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.decode import generate  # noqa: E402
from repro_torch.core.semiring import PLUS_TIMES  # noqa: E402
from repro_torch.serving import QueryEngine, burst  # noqa: E402
from repro_torch.serving import trace as serve_trace  # noqa: E402
from repro_torch.tuning import autotune, fit, probes  # noqa: E402

#: NVIDIA H100 SXM data sheet: f32 on CUDA cores, bf16 and TF32 on tensor
#: cores (dense), HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
#: the least time of an f32-accurate product: three TF32 passes (3xTF32)
PEAK_F32_ACCURATE_FLOPS = PEAK_TF32_FLOPS / 3

#: each kernel's time at the path's shape in PR 12's last run (NVIDIA H100
#: 80GB HBM3, 700.00 W), printed beside this run's
PR12_MS = {"block_spgemm": 3.569, "masked_matmul": 1.057, "flash_mask": 5.268}
#: per replay, the CUDA-core block_spgemm kernel that the tensor-core one
#: replaced (its last run on an NVIDIA H100 80GB HBM3 at 700.00 W); the tile
#: call ran it twice, once for values and once for counts
CUDA_CORE_BLOCK_SPGEMM_MS = 3.564
#: the CUDA-core f32 flash kernel that the 3xTF32 one replaced, at the
#: layer's shape (its last run on the same card model and power limit)
CUDA_CORE_F32_FLASH_MS = {"B1": 1.605, "B4": 4.979}

#: the tile-route workload: A, B, M from ``block_sparse`` at n = 8192
TILE_N = 8192
TILE_BS = 128
#: the row-route workload: triangle counting on R-MAT(scale, edge factor)
RMAT_SCALE = 14
RMAT_EDGE_FACTOR = 16
#: the SDDMM path: dense (N, K) x (K, N) sampled at the tile-8192 mask
SDDMM_K = 256
#: the flash layer and the LM: llama3.2-1b at full width
LM_BATCH = 4
LM_SEQ = 2048
#: the serving path: a tile bucket of tile-8192 queries, a burst bucket
#: and a mixed async stream on bench_serve's structures at n = 8192
SERVE_TILE_QUERIES = 4
SERVE_N = 8192
SERVE_QUERIES = 64
#: the delta phase: 8 rounds of a 1 % upsert delta to A, then a bucket of
#: 64 queries, at n = 8192 (``bench_incremental``'s structure); a delta of
#: 64 upserts in 16 rows of tile-8192's A
DELTA_ROUNDS = 8
DELTA_ROWS = 82
DELTA_QUERIES = 64
DELTA_CHECKED = 8
TILE_DELTA_ROWS = 16
TILE_DELTA_UPSERTS = 64
#: the graph applications: checked on R-MAT scale 12 (and against the CPU
#: port at scale 10), timed at scale 14 (k-truss at 13)
GRAPH_SCALE = 12
GRAPH_CPU_SCALE = 10
GRAPH_TIME_SCALE = 14
#: k-truss is timed one scale lower: at scale 14 it took 104 s of the
#: script, whose whole run must stay within its time limit
KTRUSS_TIME_SCALE = 13
BC_SOURCES = 256
BC_TIME_SOURCES = 512
BC_CHUNKS = 4

#: the card's ``nvidia-smi`` name and power limit, printed beside every
#: serving number (set by ``card()``)
CARD = "not measured"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def reset_counts() -> None:
    """Zero every kernel's launch count (just before a path runs)."""
    kernel.LAUNCHES = 0
    kernel.FUSED_LAUNCHES = 0
    kernel.MASKED_MATMUL_LAUNCHES = 0
    flash.LAUNCHES = 0
    flash.TC_LAUNCHES = 0
    flash.F32_LAUNCHES = 0


def device_ms(fn, dev, reps: int = 5, warm: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after ``warm``
    runs: CUDA events on a GPU, the host clock around a synchronised call
    elsewhere."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev, reps: int = 2) -> float:
    """Median host-clock milliseconds of ``fn()`` ending in a device
    synchronisation (for calls with host work inside)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak_flops: float):
    """(bound ms, what bounds it) from data-sheet peaks."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# Phase 1-2: card and build
# ---------------------------------------------------------------------------


def card() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script "
                           "runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    CARD = smi
    print(smi)
    print(f"card: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}; matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def ptxas_report(log: str):
    """(kernel instance, registers, spill stores, spill loads) of every
    entry function in a ``ptxas -v`` log, names demangled where
    ``c++filt`` is installed."""
    rows, name, spill = [], None, (0, 0)
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            spill = (nums[1], nums[2])
        elif "Used" in ln and "registers" in ln and name:
            regs = int(ln.split("Used")[1].split()[0])
            rows.append((name, regs) + spill)
            name = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(
            ["c++filt"], input="\n".join(r[0] for r in rows),
            capture_output=True, text=True, check=True,
            timeout=60).stdout.splitlines()
        rows = [(n.replace("(anonymous namespace)::", "").split("(")[0]
                 .removeprefix("void "),) + r[1:]
                for n, r in zip(names, rows)]
    return rows


def build(dev) -> None:
    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {len(paths)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in paths.values()))
    for lib, log in _build.PTXAS_LOG.items():
        for name, regs, st, ld in ptxas_report(log):
            print(f"build: ptxas {lib}: {name}: {regs} registers, spill "
                  f"stores {st} B, loads {ld} B")
    # the tensor-core kernels at the path's shapes, as the card runs them
    with torch.cuda.device(dev):
        for bs in BLOCK_SIZES:
            info = _build.kernel_info("block_spgemm", "block_spgemm_info", bs)
            print(f"build: block_spgemm bs {bs} ({block_instance(bs)}): "
                  f"{info['threads']} threads, {info['smem_bytes']} B dynamic "
                  f"shared memory, {info['registers']} registers and "
                  f"{info['local_bytes']} B local memory per thread, "
                  f"{info['ctas_per_sm']} CTAs per SM")
        for what, info in (
                ("flash_mask bf16 128/128, D 64",
                 _build.kernel_info("flash_mask", "flash_mask_tc_info", 128,
                                    128, 64)),
                ("flash_mask f32 (3xTF32) 128/128, D 64",
                 _build.kernel_info("flash_mask", "flash_mask_f32_info", 128,
                                    128, 64)),
                ("masked_matmul f32 128x128",
                 _build.kernel_info("masked_matmul", "masked_matmul_info",
                                    128, 128, 0)),
                ("masked_matmul bf16 128x128",
                 _build.kernel_info("masked_matmul", "masked_matmul_info",
                                    128, 128, 1))):
            print(f"build: {what}: {info['threads']} threads, "
                  f"{info['smem_bytes']} B dynamic shared memory, "
                  f"{info['registers']} registers and {info['local_bytes']} "
                  f"B local memory per thread, {info['ctas_per_sm']} CTAs "
                  f"per SM")


# ---------------------------------------------------------------------------
# Phase 3: kernel against plain
# ---------------------------------------------------------------------------


#: block sizes of phase 3, one or more per instance of the block_spgemm
#: kernel (CTA tiles 16, 32, 64 and 128)
BLOCK_SIZES = (4, 8, 32, 48, 128)


def block_instance(bs: int) -> str:
    """The block_spgemm kernel instance that block size ``bs`` runs."""
    t, wm, wn = next(c for c in ((16, 1, 1), (32, 2, 1), (64, 2, 2),
                                 (128, 2, 4)) if bs <= c[0] or c[0] == 128)
    return f"block_spgemm_tc_kernel<{t}, {wm}, {wn}>"


def block_f64(a_blocks, b_blocks, wl, nnzb_out) -> torch.Tensor:
    """The worklist replay in float64: the exact value to f32 accuracy."""
    rank, pa, pb, flags = (x.long() for x in wl)
    real = ((flags >> 1) & 1).double()
    out = torch.zeros((nnzb_out,) + tuple(a_blocks.shape[1:]),
                      dtype=torch.float64, device=a_blocks.device)
    prods = torch.bmm(a_blocks.double()[pa], b_blocks.double()[pb])
    return out.index_add_(0, rank, prods * real[:, None, None])


def compare(a_blocks, b_blocks, wl, nnzb_out, exact: bool) -> float:
    """Kernel against plain on the same tensors, values only and fused
    with the counts over the operands' 0/1 patterns: returns max |diff|.
    On float data the values are also held to 2e-6 normwise of float64."""
    a_pat, b_pat = ((x != 0).float() for x in (a_blocks, b_blocks))
    got = kernel.block_spgemm_kernel(a_blocks, b_blocks, *wl, nnzb_out)
    vals, counts = kernel.block_spgemm_with_structure_kernel(
        a_blocks, b_blocks, a_pat, b_pat, *wl, nnzb_out)
    want, want_c = kernel.block_spgemm_with_structure_plain(
        a_blocks, b_blocks, a_pat, b_pat, *wl, nnzb_out)
    sync(a_blocks.device)
    check(torch.equal(counts, want_c), "fused counts equal plain exactly")
    check(torch.equal(vals, got), "fused values equal the values-only "
          "kernel's")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if exact:
        check(torch.equal(got, want), "kernel equals plain exactly")
    else:
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
              f"kernel within 1e-4 of plain (max err {err})")
        exact64 = block_f64(a_blocks, b_blocks, wl, nnzb_out)
        rel = float((got.double() - exact64).norm() / exact64.norm())
        check(rel <= 2e-6, f"kernel within 2e-6 normwise of float64 (got "
              f"{rel:.3g})")
    return err


def worklist(schedule, dev, pad: int = 0):
    """Worklist tensors, optionally followed by ``pad`` all-flags-off
    entries at the last rank (the distributed ring's padding)."""
    rank, pa, pb, flags = schedule
    if pad:
        z = np.zeros(pad, np.int32)
        rank = np.concatenate([rank, np.full(pad, rank[-1], np.int32)])
        pa, pb, flags = (np.concatenate([x, z]) for x in (pa, pb, flags))
    return [torch.as_tensor(x, device=dev) for x in (rank, pa, pb, flags)]


def kernel_vs_plain(dev) -> float:
    err = 0.0
    for bs, nb in zip(BLOCK_SIZES, (64, 48, 16, 12, 8)):
        n = bs * nb
        rng = np.random.default_rng(bs)
        for ints in (True, False):
            ops_ = []
            for seed, mask in ((1, False), (2, False), (3, True)):
                x = F.block_sparse(n, bs, 0.35, 0.8, seed=seed + bs,
                                   mask=mask)
                if not ints and not mask:
                    x = x * rng.standard_normal(x.shape).astype(np.float32)
                ops_.append(x)
            a, b, m = ops_
            a[:bs] = 0.0      # an empty block row: zero-fill entries
            A, B, M = (F.bcsr_from_dense(x, bs, device=dev)
                       for x in (a, b, m))
            sched = ops.build_spgemm_schedule(A, B, M)
            check(bool(((sched[3] & 2) == 0).any()), "zero-fill present")
            for pad in (0, 5):
                err = max(err, compare(A.blocks, B.blocks,
                                       worklist(sched, dev, pad), M.nnzb,
                                       exact=ints))
        # an empty B: only zero-fill entries, over one zero block
        Bz = F.bcsr_from_dense(np.zeros((n, n), np.float32), bs, device=dev)
        sched = ops.build_spgemm_schedule(A, Bz, M)
        check(not (sched[3] & 2).any(), "empty B gives zero-fill only")
        zero = torch.zeros((1, bs, bs), device=dev)
        err = max(err, compare(A.blocks, zero, worklist(sched, dev),
                               M.nnzb, exact=True))
        print(f"kernel-vs-plain: bs={bs} ({block_instance(bs)}) n={n} "
              f"W={len(sched[0])}.. ok")
    print(f"kernel-vs-plain: all block sizes agree, values only and fused "
          f"(exact on integers and counts; 1e-4 and 2e-6 normwise from "
          f"float64 otherwise), max abs err {err:.3g}")
    return err


# ---------------------------------------------------------------------------
# Phase 4: main path, tile route
# ---------------------------------------------------------------------------


def tile_problem(n: int, bs: int):
    a = F.block_sparse(n, bs, 0.3, 0.9, seed=1)
    b = F.block_sparse(n, bs, 0.3, 0.9, seed=2)
    m = F.block_sparse(n, bs, 0.6, 1.0, seed=3, mask=True)
    return a, b, m


class count_plain:
    """Within the block, count the calls of the block product's plain
    versions (kernel.py looks them up at call time)."""

    NAMES = ("block_spgemm_plain", "block_spgemm_with_structure_plain")

    def __enter__(self):
        self.calls = 0
        self.saved = {name: getattr(kernel, name) for name in self.NAMES}

        def counted(fn):
            def call(*args, **kw):
                self.calls += 1
                return fn(*args, **kw)
            return call

        for name, fn in self.saved.items():
            setattr(kernel, name, counted(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(kernel, name, fn)


#: the tile call's steps, as ``host_steps`` names them: its prep (uploads,
#: block construction, schedule) and its gather
PREP_STEPS = ("upload A", "upload B", "upload M (structure)",
              "A values and pattern", "B values and pattern", "M rows",
              "M block structure", "build_spgemm_schedule (host)",
              "worklist check and upload")
GATHER_STEPS = ("gather slots", "gather mask_cols",
                "gather values and present")


def host_steps(A, B, M, dev, bs: int):
    """The tile call's steps one by one, each on the host clock ended by a
    synchronise, as ``_masked_spgemm_tile`` and ``_gather`` run them:
    returns (milliseconds by step, the BCSR operands, the patterns, the
    schedule)."""
    ms = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    Ad = timed("upload A", lambda: F._upload(A, dev))
    Bd = timed("upload B", lambda: F._upload(B, dev))
    Md = timed("upload M (structure)", lambda: F._upload(M, dev, data=False))
    Ab, a_pat = timed("A values and pattern",
                      lambda: F._bcsr_with_pattern(Ad, bs))
    Bb, b_pat = timed("B values and pattern",
                      lambda: F._bcsr_with_pattern(Bd, bs))
    del Ad, Bd
    m_rows = timed("M rows", Md.rows)
    Mb, m_pos = timed("M block structure",
                      lambda: F._bcsr_structure(Md, m_rows, bs))
    sched = timed("build_spgemm_schedule (host)",
                  lambda: ops.build_spgemm_schedule(Ab, Bb, Mb))
    wl = timed("worklist check and upload", lambda: ops._worklist(
        Mb, sched, Ab.nnzb, Bb.nnzb, dev))
    cb, sb = timed("fused kernel", lambda: kernel.
                   block_spgemm_with_structure_kernel(
                       Ab.blocks, Bb.blocks, a_pat, b_pat, *wl, Mb.nnzb))
    # _gather, step by step
    m, width = M.shape[0], F._pad_width(M, None)
    dest = timed("gather slots", lambda: F._slots(Md, m_rows, width))
    timed("gather mask_cols", lambda: F._padded(Md, m_rows, width,
                                                with_vals=False, dest=dest))

    def scatter():
        src = (m_pos * bs + m_rows % bs) * bs + Md.indices % bs
        vals = torch.zeros(m * width + 1, dtype=cb.dtype, device=dev)
        present = torch.zeros(m * width + 1, dtype=torch.bool, device=dev)
        vals[dest] = cb.reshape(-1)[src]
        present[dest] = sb.reshape(-1)[src] > 0

    timed("gather values and present", scatter)
    return ms, (Ab, Bb, Mb), (a_pat, b_pat), sched


def tile_route(dev, n: int = TILE_N, bs: int = TILE_BS):
    """Returns the mask's tile coordinates (block rows, block cols), the
    host CSR operands and the kernel's entry of the JSON line."""
    t0 = time.perf_counter()
    a, b, m = tile_problem(n, bs)
    A, B, M = (F.csr_from_dense(x) for x in (a, b, m))
    print(f"tile: problem n={n} nnz A={A.nnz} B={B.nnz} M={M.nnz} built in "
          f"{time.perf_counter() - t0:.1f} s")

    # the main path, once, through the user's entry point
    planner.clear_plan_cache()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    with count_plain() as plain:
        res = masked_spgemm(A, B, M, device=dev)
        sync(dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = kernel.FUSED_LAUNCHES
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    p = planner.plan(A, B, M, device=dev)        # the cached plan
    print(f"tile: plan algorithm={p.algorithm} block={p.tile_block} costs="
          + ", ".join(f"{k}={v:.4g}" for k, v in p.costs[:3]))
    check(p.algorithm == "tile" and p.tile_block == bs,
          f"planner elects tile at block {bs}")
    check(launches == 1 and kernel.LAUNCHES == 0, f"the fused kernel "
          f"launched once and the values-only one never (got {launches}, "
          f"{kernel.LAUNCHES})")
    check(plain.calls == 0, f"no plain version ran (got {plain.calls})")

    # the result against the dense product at the mask (exact: integer
    # data, every partial sum below 2^24)
    Ad = torch.as_tensor(a, device=dev)
    Bd = torch.as_tensor(b, device=dev)
    C = Ad @ Bd
    S = (Ad != 0).float() @ (Bd != 0).float()
    mr = F._expand_rows(M.indptr)
    slots = np.arange(M.nnz) - M.indptr[mr]
    idx = torch.as_tensor(np.stack([mr, M.indices, slots]), device=dev)
    got_v = res.vals[idx[0], idx[2]]
    got_p = res.present[idx[0], idx[2]]
    check(torch.equal(got_p, S[idx[0], idx[1]] > 0), "present equals the "
          "structural product at the mask")
    check(torch.equal(got_v, C[idx[0], idx[1]]), "values equal dense "
          "torch.matmul at the mask")
    check(int(res.present.sum()) == int(got_p.sum()), "no slot beyond a "
          "mask row is present")
    check(bool(torch.isfinite(res.vals).all()), "values are finite")
    print(f"tile: result equals dense matmul at all {M.nnz} mask entries "
          f"and present the structural product ({int(got_p.sum())} "
          f"present); one fused launch, no plain version; first call "
          f"{first_ms:.1f} ms incl. planning; peak memory "
          f"{peak / 2**20:.1f} MiB")
    del S, C, res, got_v, got_p, idx

    # the call's host steps one by one, then the kernels at its shapes
    steps, (Ab, Bb, Mb), (a_pat, b_pat), sched = host_steps(A, B, M, dev, bs)
    print("tile: steps (ms): " + "; ".join(
        f"{k} {v:.2f}" for k, v in steps.items()))
    prep_ms = sum(steps[k] for k in PREP_STEPS)
    upload_ms = sum(steps[k] for k in PREP_STEPS if k.startswith("upload"))
    gather_steps_ms = sum(steps[k] for k in GATHER_STEPS)
    print(f"tile: steps: prep {prep_ms:.1f} ms (uploads {upload_ms:.1f}), "
          f"gather {gather_steps_ms:.1f} ms")
    wl = worklist(sched, dev)
    W = len(sched[0])
    real = int(((sched[3] >> 1) & 1).sum())
    err = compare(Ab.blocks, Bb.blocks, wl, Mb.nnzb, exact=True)

    def run_fused():
        return kernel.block_spgemm_with_structure_kernel(
            Ab.blocks, Bb.blocks, a_pat, b_pat, *wl, Mb.nnzb)

    def run_values():
        return kernel.block_spgemm_kernel(Ab.blocks, Bb.blocks, *wl,
                                          Mb.nnzb)

    def run_plain():
        return kernel.block_spgemm_with_structure_plain(
            Ab.blocks, Bb.blocks, a_pat, b_pat, *wl, Mb.nnzb)

    fused_ms = device_ms(run_fused, dev, reps=7, warm=2)
    values_ms = device_ms(run_values, dev, reps=7, warm=2)
    plain_ms = device_ms(run_plain, dev, reps=3, warm=1)
    Cb, Sb = run_fused()
    gather_ms = host_ms(lambda: gather_mask_aligned(M, Mb, Cb, Sb, n=n), dev)
    e2e_ms = host_ms(lambda: masked_spgemm(A, B, M, device=dev), dev)
    dense_ms = device_ms(lambda: Ad @ Bd, dev, reps=5, warm=2)

    flops = 2.0 * real * bs ** 3
    out_bytes = Mb.nnzb * bs * bs * 4
    in_bytes = Ab.blocks.nbytes + Bb.blocks.nbytes
    idx_bytes = 16 * W + 4 * (Mb.nnzb + 1)
    values_bound, values_by = bound(flops, in_bytes + idx_bytes + out_bytes,
                                    PEAK_F32_ACCURATE_FLOPS)
    # fused: values as three TF32 passes plus counts as one bf16 pass, on
    # the same tensor cores; the bf16 patterns read and counts written too
    t_ops = flops / PEAK_F32_ACCURATE_FLOPS + flops / PEAK_BF16_FLOPS
    fused_bytes = (in_bytes + a_pat.nbytes + b_pat.nbytes + 2 * out_bytes
                   + idx_bytes)
    t_bytes = fused_bytes / PEAK_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"tile: W={W} real={real} nnzb A={Ab.nnzb} B={Bb.nnzb} "
          f"out={Mb.nnzb}; {flops / 1e9:.1f} GFLOP per replay; fused call "
          f"moves {fused_bytes / 1e6:.0f} MB")
    print(f"tile: fused kernel {fused_ms:.3f} ms per tile call (values and "
          f"counts; the CUDA-core kernel it replaced: 2 x "
          f"{CUDA_CORE_BLOCK_SPGEMM_MS:.3f} ms); bound "
          f"{bound_ms:.3f} ms (by {by}: three TF32 passes at "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s plus one bf16 pass at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f}); at {bound_ms / fused_ms:.1%} of "
          f"it; plain {plain_ms:.3f} ms")
    print(f"tile: values-only replay {values_ms:.3f} ms "
          f"({flops / values_ms / 1e9:.1f} TF32-accurate TFLOP/s; the "
          f"CUDA-core kernel: {CUDA_CORE_BLOCK_SPGEMM_MS:.3f} ms); bound "
          f"{values_bound:.3f} ms "
          f"(by {values_by}); at {values_bound / values_ms:.1%} of it; the "
          f"counting CTAs add {fused_ms - values_ms:.3f} ms")
    print(f"tile: gather_mask_aligned {gather_ms:.1f} ms; end to end "
          f"{e2e_ms:.1f} ms per call (first {first_ms:.1f} ms, with "
          f"planning); peak memory of the first call {peak / 2**20:.1f} "
          f"MiB")
    print(f"tile: dense torch.matmul {n}^3 f32 (SpGEMM-then-mask "
          f"baseline, NOT the same function) {dense_ms:.3f} ms")
    mask_tiles = (np.repeat(np.arange(Mb.block_rows), np.diff(Mb.indptr)),
                  Mb.indices)
    del Ab, Bb, Mb, a_pat, b_pat, wl, Cb, Sb, Ad, Bd
    return mask_tiles, (A, B, M), {
        "name": "block_spgemm", "route": "cuda",
        "source": "src/repro_torch/kernels/masked_matmul/csrc/"
                  "block_spgemm.cu",
        "replaces": "src/repro/kernels/masked_matmul/kernel.py:105",
        "launches": launches, "max_abs_err": err, "ms": fused_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
        "library_ms": None,
        "instance": block_instance(bs) + ", fused values and counts",
        "values_ms": values_ms, "values_bound_ms": values_bound,
        "tile_call_ms": e2e_ms, "tile_peak_mib": peak / 2**20,
        "tile_steps_ms": steps,
        "design": "mma.sync tensor cores: values 3xTF32 (hi + lo "
                  "splits, IEEE k-step adds), counts one bf16 pass over "
                  "bf16 patterns, in one grid of both CTA kinds; the "
                  "(pair, k-chunk) stream in a 3-stage cp.async ring of "
                  "32-deep chunks, ldmatrix fragments; 128x128 CTA "
                  "tile, 8 warps of 64x32"}


# ---------------------------------------------------------------------------
# Phase 5: main path, row route
# ---------------------------------------------------------------------------


def row_route(dev, scale: int = RMAT_SCALE,
              edge_factor: int = RMAT_EDGE_FACTOR) -> None:
    import scipy.sparse as sp
    g = F.rmat(scale, edge_factor, seed=scale)
    L = F.tril(degree_relabel(g), strict=True)
    p = planner.plan(L, L, L, device=dev)
    s = p.stats
    print(f"row: rmat scale {scale}: nnz {g.nnz}, L nnz {L.nnz}, widths "
          f"wa={s.wa} wb={s.wb} wbt={s.wbt} pm={s.pm}; plan "
          f"{p.algorithm} costs="
          + ", ".join(f"{k}={v:.4g}" for k, v in p.costs[:3]))
    check(p.algorithm != "tile", "the row route is elected")
    hits = planner.plan_cache_info()["hits"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    count, seconds = triangle_count(g, device=dev)
    check(planner.plan_cache_info()["hits"] == hits + 1,
          "triangle_count ran the planner's pick")
    check(kernel.LAUNCHES == kernel.FUSED_LAUNCHES == 0,
          "the row route launches no block kernel")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    Ls = sp.csr_matrix((L.data.astype(np.float64), L.indices, L.indptr),
                       shape=L.shape)
    want = int(round((Ls @ Ls).multiply(Ls).sum()))
    check(count == want, f"triangle count {count} equals scipy's {want}")
    _, warm_s = triangle_count(g, device=dev)
    print(f"row: {count} triangles (scipy agrees) via {p.algorithm}; "
          f"first {seconds * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} ms "
          f"(masked SpGEMM + reduction, host prep included); peak memory "
          f"{peak / 2**20:.1f} MiB")


# ---------------------------------------------------------------------------
# Phase 6: the query-serving path (QueryEngine) and the graph applications
# ---------------------------------------------------------------------------


def revalue(x, seed: int, ints: bool = False):
    """Same structure as ``x``, fresh values from ``seed``: small integers
    (1-4) or uniform in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    data = (rng.integers(1, 5, x.nnz) if ints
            else rng.uniform(0.5, 1.5, x.nnz)).astype(np.float32)
    return F.CSR(x.indptr, x.indices, data, x.shape)


def same_result(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in (
        (got.vals, want.vals), (got.present, want.present),
        (got.mask_cols, want.mask_cols)))


def result_bytes(res) -> int:
    return sum(t.numel() * t.element_size()
               for t in (res.vals, res.present, res.mask_cols))


def burst_structure(n: int):
    """``benchmarks/bench_serve.py``'s burst structure: sparse inputs and a
    dense mask (the mca regime), fresh A values per query."""
    return (F.erdos_renyi(n, 2, seed=100), F.erdos_renyi(n, 2, seed=200),
            F.er_mask(n, max(8, n // 8), seed=300))


def mixed_structures(n: int):
    """``bench_serve``'s four mixed structures: the burst one and three
    inner-elected ER points."""
    return [burst_structure(n)] + [
        (F.erdos_renyi(n, 2 + 2 * s, seed=100 + s),
         F.erdos_renyi(n, 2 + 2 * s, seed=200 + s),
         F.er_mask(n, 8 * s, seed=300 + s)) for s in range(1, 4)]


def serving_tile_bucket(dev, ops, bs: int = TILE_BS,
                        queries: int = SERVE_TILE_QUERIES) -> dict:
    """A tile bucket: ``queries`` tile-8192 queries (A's structure with
    integer values from seeds 0..queries-1, B and M shared) through one
    engine.  Returns the bucket's numbers."""
    A, B, M = ops
    As = [revalue(A, s, ints=True) for s in range(queries)]
    planner.clear_plan_cache()
    eng = QueryEngine(max_batch=queries, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    misses = planner.plan_cache_info()["misses"]
    reset_counts()
    submit_ms = []
    with count_plain() as plain:
        t_start = time.perf_counter()
        tickets = []
        for a in As:     # the last submit fills the bucket and runs it
            t0 = time.perf_counter()
            tickets.append(eng.submit(a, B, M))
            submit_ms.append((time.perf_counter() - t0) * 1e3)
        got = [t.result() for t in tickets]
        sync(dev)
        bucket_ms = (time.perf_counter() - t_start) * 1e3
    launches = kernel.FUSED_LAUNCHES
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    (row,) = eng.metrics.bucket_log()
    p = planner.plan(A, B, M, device=dev)
    check(planner.plan_cache_info()["misses"] == misses + 1,
          "the bucket planned once")
    check(row["route"] == "tile" and row["size"] == queries
          and p.algorithm == "tile" and p.tile_block == bs,
          f"the bucket elects the tile route at block {bs} (got "
          f"{row['route']}, {p.algorithm}, {p.tile_block})")
    check(launches == queries and kernel.LAUNCHES == 0, f"the fused kernel "
          f"launched once per query ({queries}), got {launches} (values "
          f"only: {kernel.LAUNCHES})")
    check(plain.calls == 0, f"no plain version ran (got {plain.calls})")
    for a, g in zip(As, got):
        check(same_result(g, masked_spgemm(a, B, M, device=dev)),
              "each tile-bucket result equals its one-shot call bit for bit")

    # the same four again: result-cache hits, no launch
    hits = eng.metrics.snapshot()["result_cache_hits"]
    reset_counts()
    t0 = time.perf_counter()
    again = [eng.submit(a, B, M) for a in As]
    replay_ms = (time.perf_counter() - t0) * 1e3
    check(all(t.done() for t in again)
          and eng.metrics.snapshot()["result_cache_hits"] == hits + queries
          and kernel.FUSED_LAUNCHES == 0,
          "the replayed bucket is served from the result cache, no launch")
    check(all(t.result() is g for t, g in zip(again, got)),
          "a hit returns the cached result")
    per_result = result_bytes(got[0])
    eng.close()
    exec_ms = row["exec_s"] * 1e3
    # what each element repeats: B's upload and its value and pattern blocks
    b_ms = host_ms(lambda: F._bcsr_with_pattern(F._upload(B, dev), bs), dev,
                   reps=3)
    print(f"serving [{CARD}]: tile bucket {queries} x tile-{A.shape[0]}: "
          f"{bucket_ms:.1f} ms submit to results ({bucket_ms / queries:.1f} "
          f"ms per query), serve.exec {exec_ms:.1f} ms; serve.submit "
          f"(fingerprints) "
          + ", ".join(f"{x:.1f}" for x in submit_ms[:-1])
          + f" ms (the last submit ran the bucket: {submit_ms[-1]:.1f} ms); "
          f"B's upload and blocks {b_ms:.1f} ms per element (median of "
          f"3), "
          f"{queries * b_ms / exec_ms:.1%} of serve.exec; peak memory "
          f"{peak / 2**20:.1f} MiB; {launches} fused launches, no plain "
          f"version; all bitwise the one-shot call")
    print(f"serving [{CARD}]: tile replay {queries} result-cache hits in "
          f"{replay_ms:.1f} ms, no launch; one cached tile-{A.shape[0]} "
          f"result holds {per_result / 2**20:.1f} MiB on the card (vals, "
          f"present, mask_cols), the default 256 entries "
          f"{256 * per_result / 2**30:.1f} GiB")
    del got, again
    return {"launches": launches, "bucket_ms": bucket_ms,
            "exec_ms": exec_ms, "submit_ms": submit_ms[:-1],
            "replay_ms": replay_ms, "peak_mib": peak / 2**20,
            "result_mib": per_result / 2**20,
            "b_repeat_share": queries * b_ms / exec_ms}


def serving_burst(dev, n: int = SERVE_N, queries: int = SERVE_QUERIES
                  ) -> dict:
    """A burst bucket: ``queries`` fresh-valued queries on bench_serve's
    burst structure, one bucket, one burst program."""
    A0, B0, M0 = burst_structure(n)
    qs = [(revalue(A0, 1000 + q), B0, M0) for q in range(queries)]
    eng = QueryEngine(max_batch=queries, queue_cap=4 * queries,
                      cache_results=False, device=dev)
    programs = len(burst._programs)
    reset_counts()
    t0 = time.perf_counter()
    eng.serve(qs)                 # cold: plan and program build included
    sync(dev)
    cold_ms = (time.perf_counter() - t0) * 1e3
    (row,) = eng.metrics.bucket_log()
    check(row["route"] == "burst" and row["size"] == queries
          and len(burst._programs) == programs + 1,
          f"one burst program serves the bucket (got {row['route']}, "
          f"{len(burst._programs) - programs} programs)")
    check(kernel.LAUNCHES == kernel.FUSED_LAUNCHES == 0,
          "the burst route launches no block kernel")
    t0 = time.perf_counter()
    got = eng.serve(qs)
    sync(dev)
    engine_ms = (time.perf_counter() - t0) * 1e3
    eng.close()
    t0 = time.perf_counter()
    want = [masked_spgemm(*q, device=dev) for q in qs]
    sync(dev)
    seq_ms = (time.perf_counter() - t0) * 1e3
    check(all(same_result(g, w) for g, w in zip(got, want)),
          "every burst result equals its one-shot call bit for bit")
    print(f"serving [{CARD}]: burst bucket {queries} x n={n} (A, B "
          f"erdos_renyi(2), M er_mask({max(8, n // 8)})): engine "
          f"{engine_ms:.1f} ms ({queries / engine_ms * 1e3:.0f} queries/s; "
          f"cold, with plan and program build, {cold_ms:.1f} ms) against a "
          f"warm sequential one-shot loop {seq_ms:.1f} ms "
          f"({queries / seq_ms * 1e3:.0f} queries/s, "
          f"{row['algorithm']}); all bitwise")
    del got, want
    return {"engine_ms": engine_ms, "cold_ms": cold_ms, "seq_ms": seq_ms,
            "queries": queries}


def mixed_stream(n: int, queries: int) -> list:
    """serve-mixed-8192's stream: ``queries`` draws from bench_serve's four
    structures (seed 0), fresh values per query."""
    structs = mixed_structures(n)
    rng = np.random.default_rng(0)
    mix = []
    for q in range(queries):
        A, B, M = structs[int(rng.integers(len(structs)))]
        mix.append((revalue(A, 2000 + q), B, M))
    return mix


def serving_mixed(dev, n: int = SERVE_N, queries: int = SERVE_QUERIES
                  ) -> dict:
    """A mixed stream in async mode: bench_serve's four structures,
    shuffled, fresh values per query, ``max_wait_ms=2``."""
    mix = mixed_stream(n, queries)
    eng = QueryEngine(async_mode=True, max_wait_ms=2.0, max_batch=queries,
                      queue_cap=4 * queries, cache_results=False,
                      device=dev)
    t0 = time.perf_counter()
    tickets = [eng.submit(*q) for q in mix]
    got = [t.result(timeout=600) for t in tickets]
    stream_ms = (time.perf_counter() - t0) * 1e3
    eng.close()
    log = eng.metrics.bucket_log()
    check(sum(row["size"] for row in log) == queries,
          "the async engine served every query")
    check(all(same_result(g, masked_spgemm(*q, device=dev))
              for g, q in zip(got, mix)),
          "every async ticket equals its one-shot call bit for bit")
    buckets = [f"{row['size']} {row['route']}/{row['algorithm']}"
               for row in log]
    print(f"serving [{CARD}]: mixed async stream {queries} queries over "
          f"4 structures in {stream_ms:.1f} ms (first plans "
          f"included); buckets: " + ", ".join(buckets) + "; all bitwise")
    del got
    return {"stream_ms": stream_ms, "buckets": buckets}


def scipy_ktruss(adj, k: int) -> set:
    """The k-truss edge set by scipy: prune edges whose support (common
    neighbours, ``(A @ A) .* A``) is below k - 2 until a fixed point."""
    import scipy.sparse as sp
    a = sp.csr_matrix((np.ones(adj.nnz), adj.indices, adj.indptr),
                      shape=adj.shape)
    while True:
        s = (a @ a).multiply(a).tocsr()
        s.data = (s.data >= k - 2).astype(np.float64)
        s.eliminate_zeros()
        if s.nnz == a.nnz:
            break
        a = s
    rows, cols = a.nonzero()
    return set(zip(rows.tolist(), cols.tolist()))


def edge_set(x) -> set:
    return set(zip(F._expand_rows(x.indptr).tolist(), x.indices.tolist()))


def serving_composites(dev) -> dict:
    """submit_triangle, k-truss and betweenness on the card, checked, then
    k-truss timed at scale 13 and betweenness at scale 14."""
    import scipy.sparse as sp
    g14 = F.rmat(GRAPH_TIME_SCALE, RMAT_EDGE_FACTOR, seed=GRAPH_TIME_SCALE)
    with QueryEngine(device=dev) as eng:
        t0 = time.perf_counter()
        tri = eng.submit_triangle(g14).result()
        tri_ms = (time.perf_counter() - t0) * 1e3
    want, _ = triangle_count(g14, device=dev)
    check(tri == want, f"submit_triangle {tri} equals triangle_count "
          f"{want}")

    g = F.rmat(GRAPH_SCALE, RMAT_EDGE_FACTOR, seed=GRAPH_SCALE)
    truss, _, iters, _ = ktruss(g, 5, device=dev)
    check(edge_set(truss) == scipy_ktruss(g, 5), "ktruss on the card keeps "
          "scipy's 5-truss edge set")
    t = sp.csr_matrix((np.ones(truss.nnz), truss.indices, truss.indptr),
                      shape=truss.shape)
    support = (t @ t).multiply(t).tocsr()
    check(support.nnz == truss.nnz and bool((support.data >= 3).all()),
          "every kept edge has support >= 3")
    small = F.rmat(GRAPH_CPU_SCALE, RMAT_EDGE_FACTOR, seed=GRAPH_CPU_SCALE)
    check(edge_set(ktruss(small, 5, device=dev)[0])
          == edge_set(ktruss(small, 5, device="cpu")[0]),
          f"ktruss at scale {GRAPH_CPU_SCALE} on the card equals the CPU's")

    srcs = range(BC_SOURCES)
    bc, _, calls = betweenness_centrality(g, sources=srcs,
                                          source_chunks=BC_CHUNKS, device=dev)
    t0 = time.perf_counter()
    bc_cpu, _, _ = betweenness_centrality(g, sources=srcs,
                                          source_chunks=BC_CHUNKS,
                                          device="cpu")
    cpu_s = time.perf_counter() - t0
    with QueryEngine(max_batch=2 * BC_CHUNKS, device=dev) as eng:
        bc_eng, _, _ = betweenness_centrality(g, sources=srcs,
                                              source_chunks=BC_CHUNKS,
                                              engine=eng)
    for what, x in (("directly", bc), ("through the engine", bc_eng)):
        err = float(np.abs(x - bc_cpu).max())
        check(np.allclose(x, bc_cpu, rtol=1e-5, atol=1e-5),
              f"betweenness on the card {what} within 1e-5 of the CPU's "
              f"(max err {err:.3g})")
    print(f"serving [{CARD}]: submit_triangle on rmat {GRAPH_TIME_SCALE}: "
          f"{tri} triangles (= triangle_count) in {tri_ms:.1f} ms; ktruss "
          f"rmat {GRAPH_SCALE} k=5: {truss.nnz} of {g.nnz} entries kept in "
          f"{iters} iterations (= scipy; scale {GRAPH_CPU_SCALE} = the CPU "
          f"port); betweenness rmat {GRAPH_SCALE}, {BC_SOURCES} sources in "
          f"{BC_CHUNKS} chunks, {calls} products: direct and engine within "
          f"1e-5 of the CPU port ({cpu_s:.1f} s on the host)")

    sys.stdout.flush()
    g13 = F.rmat(KTRUSS_TIME_SCALE, RMAT_EDGE_FACTOR, seed=KTRUSS_TIME_SCALE)
    t0 = time.perf_counter()
    truss, kt_s, kt_iters, kt_flops = ktruss(g13, 5, device=dev)
    kt_wall = time.perf_counter() - t0
    print(f"serving [{CARD}]: ktruss rmat {KTRUSS_TIME_SCALE} k=5: "
          f"{kt_wall:.2f} s ({kt_s:.2f} s in masked products), {kt_iters} "
          f"iterations, {truss.nnz} of {g13.nnz} entries kept, "
          f"{kt_flops / kt_s / 1e9:.2f} GFLOP/s", flush=True)
    t0 = time.perf_counter()
    _, bc_s, bc_calls = betweenness_centrality(
        g14, sources=range(BC_TIME_SOURCES), source_chunks=BC_CHUNKS,
        device=dev)
    bc_wall = time.perf_counter() - t0
    print(f"serving [{CARD}]: betweenness rmat {GRAPH_TIME_SCALE}, "
          f"{BC_TIME_SOURCES} sources in {BC_CHUNKS} chunks: {bc_wall:.2f} "
          f"s ({bc_s:.2f} s in {bc_calls} masked products, "
          f"{BC_TIME_SOURCES * g14.nnz / bc_s / 1e6:.1f} M TEPS)")
    return {"tri_ms": tri_ms, "ktruss_s": kt_wall, "ktruss_spgemm_s": kt_s,
            "bc_s": bc_wall, "bc_spgemm_s": bc_s}


def serving_path(dev, ops) -> dict:
    """Phase 6: the engine's tile, burst and mixed async buckets, then the
    composites; returns the block_spgemm launches of the tile bucket and
    the phase's numbers."""
    reset_counts()
    tile = serving_tile_bucket(dev, ops)
    del ops
    caches.clear_all()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"tile": tile, "burst": serving_burst(dev),
           "mixed": serving_mixed(dev)}
    caches.clear_all()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["graphs"] = serving_composites(dev)
    return out


# ---------------------------------------------------------------------------
# Phase 7: incremental serving (submit_delta) and trace replay
# ---------------------------------------------------------------------------


def drop_structure_artifacts() -> None:
    """What a delta invalidates where there is no incremental path: every
    structure-keyed artifact (plans, burst programs, patches, lineage)."""
    planner.clear_plan_cache()
    burst._programs.clear()
    burst._patches.clear()
    burst._lineage.clear()


def delta_stream(n: int, rounds: int, k: int):
    """``bench_incremental``'s stream: one upsert batch per round, each
    touching k distinct rows of A."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(rounds):
        rows = rng.choice(n, size=k, replace=False).astype(np.int64)
        cols = rng.integers(n, size=k).astype(np.int64)
        vals = rng.uniform(0.5, 1.5, k).astype(np.float32)
        out.append(F.CSRDelta.upserts(rows, cols, vals))
    return out


def timed_ready(fn, dev):
    """(fn's value, host ms of fn ended by a synchronise)."""
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def delta_burst(dev, n: int = SERVE_N, rounds: int = DELTA_ROUNDS,
                k: int = DELTA_ROWS, queries: int = DELTA_QUERIES) -> dict:
    """delta-burst-8192: the incremental stream against the recompute
    stream on the same deltas, every round's results checked."""
    A0, B, M = burst_structure(n)
    deltas = delta_stream(n, rounds, k)

    def round_queries(a, r):
        return [(revalue(a, 100_000 * r + i), B, M) for i in range(queries)]

    def serve_checked(eng, a, r, stream):
        qs = round_queries(a, r)
        got = eng.serve(qs)
        check(eng.metrics.bucket_log()[-1]["route"] == "burst",
              f"{stream} round {r}: the bucket runs the burst route")
        for i in range(0, queries, queries // DELTA_CHECKED):
            check(same_result(got[i], masked_spgemm(*qs[i], device=dev)),
                  f"{stream} round {r}: result {i} equals its one-shot "
                  f"call bit for bit")

    # incremental: submit_delta keeps the serving state warm
    drop_structure_artifacts()
    eng = QueryEngine(max_batch=queries, queue_cap=4 * queries, device=dev)
    serve_checked(eng, A0, 0, "incremental")
    builds = len(burst._programs)
    root = burst.peek_program(A0, B, M, PLUS_TIMES, planner.plan(
        A0, B, M, device=dev).widths[2], dev)
    root_cold = storage_bytes(program_tensors(root))
    a = A0
    inc_ms, lanes, up_bytes, prog_bytes, evicted = [], [], [], [], []
    for r, d in enumerate(deltas, start=1):
        with obs.tracing() as tr:
            out, ms = timed_ready(
                lambda: eng.submit_delta(a, B, M, delta_a=d), dev)
        steps = delta_steps(tr)
        inc_ms.append(ms)
        check(out.plan_survived and out.lanes_patched > 0,
              f"round {r}: the plan survives and lanes are patched (got "
              f"{out.plan_survived}, {out.lanes_patched})")
        prog = burst.peek_program(out.A, B, M, PLUS_TIMES,
                                  out.plan.widths[2], dev)
        check(prog is not None and prog.patch_bytes is not None,
              f"round {r}: the post-delta program is a patched one")
        parent = burst._lineage.peek(burst._program_key(
            out.A, B, M, PLUS_TIMES, out.plan.widths[2], dev))[0]
        lanes.append(out.lanes_patched)
        up_bytes.append(prog.patch_bytes)
        # what the patch added on the card (a mask layout it shares with
        # its parent is the parent's)
        prog_bytes.append(storage_bytes(program_tensors(prog))
                          - (storage_bytes([prog.mask_cols])
                             if prog.mask_cols is parent.mask_cols else 0))
        evicted.append(out.entries_evicted)
        a = out.A
        serve_checked(eng, a, r, "incremental")
    check(len(burst._programs) == builds, "the incremental stream built no "
          "program cold after its first")
    root_patched = storage_bytes(program_tensors(root))
    del root
    patches = burst._patches.values()
    parents = [v[0] for v in burst._lineage.values()]
    held_bytes = storage_bytes([t for p in patches + parents
                                for t in program_tensors(p)])
    patch_held = storage_bytes([t for p in patches
                                for t in program_tensors(p)])
    snap = eng.metrics.snapshot()
    eng.close()
    last = prog

    # recompute: the same deltas, every structure artifact dropped
    drop_structure_artifacts()
    eng = QueryEngine(max_batch=queries, queue_cap=4 * queries,
                      cache_results=False, device=dev)
    serve_checked(eng, A0, 0, "recompute")
    a = A0
    cold_ms = []
    for r, d in enumerate(deltas, start=1):
        def recompute():
            res = F.apply_csr_delta(a, d)
            drop_structure_artifacts()
            p = planner.plan(res.csr, B, M, device=dev)
            burst.get_program(res.csr, B, M, PLUS_TIMES, p.widths[2],
                              device=dev)
            return res.csr

        a, ms = timed_ready(recompute, dev)
        cold_ms.append(ms)
        serve_checked(eng, a, r, "recompute")
    eng.close()

    inc, cold = statistics.median(inc_ms), statistics.median(cold_ms)
    tables = last._IA.nbytes + last._BV.nbytes + last._BG.nbytes
    print(f"delta [{CARD}]: delta-burst-{n}: {rounds} rounds of a {k}-row "
          f"upsert delta to A ({k / n:.2%} of rows) then {queries} queries; "
          f"time until the program is ready: incremental (submit_delta) "
          f"median {inc:.2f} ms (" + ", ".join(f"{x:.2f}" for x in inc_ms)
          + f"), recompute (apply, re-plan, rebuild) median {cold:.2f} ms ("
          + ", ".join(f"{x:.1f}" for x in cold_ms) + f"): {cold / inc:.1f}x "
          f"(the last delta: {steps}); "
          f"all {2 * rounds * DELTA_CHECKED + 2 * DELTA_CHECKED} checked "
          f"results bitwise their one-shot calls")
    print(f"delta [{CARD}]: per patch {lanes[0]} lane columns "
          f"({last._IA.shape[0]} lanes deep), uploads "
          + ", ".join(f"{b / 2**10:.1f}" for b in up_bytes)
          + f" KiB (the whole IA, BV, BG tables: {tables / 2**20:.1f} MiB; "
          f"the first patch also uploads the cold program's BG, which "
          f"took it from {root_cold / 2**20:.1f} to "
          f"{root_patched / 2**20:.1f} MiB on the card); "
          f"each patched program adds "
          + ", ".join(f"{b / 2**20:.1f}" for b in prog_bytes)
          + f" MiB on the card (its IA, BV, BG and present; the mask "
          f"columns it shares with its parent), "
          f"{last.device_bytes() / 2**20:.1f} MiB referenced in all; "
          f"{len(patches)} patches hold {patch_held / 2**20:.1f} MiB and "
          f"with the {len(parents)} lineage entries' parents "
          f"{held_bytes / 2**20:.1f} MiB; result entries evicted per delta "
          + ", ".join(str(e) for e in evicted)
          + "; counters " + ", ".join(f"{key}={snap[key]}" for key in (
              "delta_applied", "plans_revalidated", "lanes_patched",
              "rows_invalidated")))
    drop_structure_artifacts()
    return {"incremental_ms": inc_ms, "recompute_ms": cold_ms,
            "median_incremental_ms": inc, "median_recompute_ms": cold,
            "speedup": cold / inc, "lanes": lanes, "upload_bytes": up_bytes,
            "program_bytes": prog_bytes, "held_bytes": held_bytes,
            "patch_held_bytes": patch_held, "cold_program_bytes": root_cold,
            "patched_root_bytes": root_patched,
            "evicted": evicted}


def delta_tile(dev, ops, bs: int = TILE_BS,
               queries: int = SERVE_TILE_QUERIES) -> dict:
    """delta-tile-8192: a delta to tile-8192's A under a warm engine; the
    tile plan survives and the post-delta bucket runs the fused kernel."""
    A, B, M = ops
    n = A.shape[0]
    planner.clear_plan_cache()
    eng = QueryEngine(max_batch=queries, device=dev)
    eng.serve([(revalue(A, s, ints=True), B, M) for s in range(queries)])
    check(eng.metrics.bucket_log()[-1]["route"] == "tile",
          "the pre-delta bucket runs the tile route")
    sync(dev)
    before_bytes = eng.results.device_bytes()
    before_entries = len(eng.results)
    rng = np.random.default_rng(17)
    rows = np.repeat(rng.choice(n, TILE_DELTA_ROWS, replace=False),
                     TILE_DELTA_UPSERTS // TILE_DELTA_ROWS)
    d = F.CSRDelta.upserts(rows, rng.integers(0, n, len(rows)),
                           rng.integers(1, 5, len(rows)).astype(np.float32))
    with obs.tracing() as tr:
        out, delta_ms = timed_ready(
            lambda: eng.submit_delta(A, B, M, delta_a=d), dev)
    steps = delta_steps(tr)
    gc_collect(dev)
    after_bytes = eng.results.device_bytes()
    check(out.plan_survived and out.plan.algorithm == "tile"
          and out.plan.tile_block == bs,
          f"revalidate keeps the tile plan (got {out.plan_survived}, "
          f"{out.plan.algorithm}, {out.plan.tile_block})")
    A1 = out.A

    As = [revalue(A1, 10 + s, ints=True) for s in range(queries)]
    reset_counts()
    with count_plain() as plain:
        got = eng.serve([(a, B, M) for a in As])
        sync(dev)
    launches = kernel.FUSED_LAUNCHES
    check(launches == queries and kernel.LAUNCHES == 0,
          f"the post-delta bucket launches the fused kernel {queries} times "
          f"(got {launches}, values only {kernel.LAUNCHES})")
    check(plain.calls == 0, "no plain version ran")
    check(eng.metrics.bucket_log()[-1]["route"] == "tile",
          "the post-delta bucket runs the tile route")
    eng.close()
    mr = F._expand_rows(M.indptr)
    idx = torch.as_tensor(np.stack([mr, M.indices,
                                    np.arange(M.nnz) - M.indptr[mr]]),
                          device=dev)
    Bd = torch.as_tensor(B.to_dense(), device=dev)
    for a, g in zip(As, got):
        check(same_result(g, masked_spgemm(a, B, M, device=dev)),
              "each post-delta result equals its one-shot call bit for bit")
        C = torch.as_tensor(a.to_dense(), device=dev) @ Bd
        check(torch.equal(g.vals[idx[0], idx[2]], C[idx[0], idx[1]]),
              "each post-delta result is exact against the dense product "
              "at the mask")
        del C
    del Bd, got

    # what the surviving plan saved: a plan of the post-delta operands,
    # with the measured trial's winner memoized and with nothing cached
    _, warm_plan_ms = timed_ready(
        lambda: planner.plan(A1, B, M, use_cache=False, device=dev), dev)
    planner.clear_plan_cache()
    p, cold_plan_ms = timed_ready(
        lambda: planner.plan(A1, B, M, device=dev), dev)
    check(p.algorithm == "tile", "the cold plan elects tile too")

    print(f"delta [{CARD}]: delta-tile-{n}: {len(rows)} upserts in "
          f"{TILE_DELTA_ROWS} rows of A; submit_delta {delta_ms:.1f} ms "
          f"(plan survived: tile at {bs}; " + steps + ") against a cold "
          f"plan of the post-delta operands {cold_plan_ms:.1f} ms (trial "
          f"among {list(p.trialed)}; {warm_plan_ms:.1f} ms with the trial's "
          f"winner memoized); it evicted "
          f"{out.entries_evicted} of {before_entries} result-cache entries: "
          f"the cache held {before_bytes / 2**20:.1f} MiB on the card "
          f"before, {after_bytes / 2**20:.1f} MiB after; the post-delta "
          f"bucket of {queries}: {launches} fused launches, each result "
          f"bitwise its one-shot call and exact against the dense product "
          f"at the mask")
    return {"launches": launches, "submit_delta_ms": delta_ms,
            "cold_plan_ms": cold_plan_ms, "warm_plan_ms": warm_plan_ms,
            "evicted": out.entries_evicted,
            "submit_delta_steps": steps,
            "cache_mib_before": before_bytes / 2**20,
            "cache_mib_after": after_bytes / 2**20}


def delta_steps(tr) -> str:
    """``submit_delta``'s four spans, in ms, from a tracer's records."""
    durs = {r["name"]: r["dur"] * 1e3 for r in tr.sink.spans()
            if r["name"].startswith("delta.")}
    return ", ".join(f"{k} {v:.1f} ms" for k, v in durs.items())


def program_tensors(prog) -> list:
    """A burst program's device tensors (a cold program's ``BG`` is on the
    host until its first patch)."""
    return [t for t in (prog._IA, prog._BV, prog._BG, prog.present,
                        prog.mask_cols) if isinstance(t, torch.Tensor)]


def storage_bytes(tensors) -> int:
    """Bytes of the distinct device storages behind ``tensors``."""
    seen = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in tensors}
    return sum(seen.values())


def gc_collect(dev) -> None:
    import gc
    gc.collect()
    sync(dev)


def one_shot(A, B, M, kw, dev):
    return masked_spgemm(A, B, M, semiring=kw["semiring"],
                         complement=kw["complement"],
                         algorithm=kw.get("algorithm") or "auto", device=dev)


def same_any(got, want) -> bool:
    if isinstance(got, tuple):
        return all(torch.equal(g, w) for g, w in zip(got, want))
    return same_result(got, want)


def replay_golden(dev) -> dict:
    """The committed golden trace, sync and async, on the card."""
    path = serve_trace.golden_trace_path()
    trace = serve_trace.Trace.load(path)
    grid = json.loads((Path(path).parent.parent / "bench"
                       / "replay_grid.json").read_text())
    sync_rep = serve_trace.replay_trace(trace, device=dev, keep_results=True)
    async_rep = serve_trace.replay_trace(trace, device=dev, async_mode=True)
    check(sync_rep.digest == async_rep.digest
          and sync_rep.schedule == async_rep.schedule,
          f"golden replay: sync and async digests equal ({sync_rep.digest}, "
          f"{async_rep.digest})")
    for key, want in grid["counters"].items():
        check(sync_rep.counters[key] == want,
              f"golden replay counter {key} = {sync_rep.counters[key]} "
              f"equals the committed {want}")
    for (_t, A, B, M, kw), got in zip(trace.materialized(),
                                      sync_rep.results):
        check(same_any(got, one_shot(A, B, M, kw, dev)),
              "every golden replay result equals its one-shot call bit for "
              "bit")
    c = sync_rep.counters
    print(f"replay [{CARD}]: golden_v1 ({trace.n_requests} requests): sync "
          f"and async digest {sync_rep.digest}; {c['submitted']} submitted, "
          f"{c['buckets_executed']} buckets, {c['result_cache_hits']} "
          f"result-cache hits (= results/bench/replay_grid.json); "
          f"{sync_rep.qps:.0f} / {async_rep.qps:.0f} queries/s (sync / "
          f"async); every result bitwise its one-shot call")
    return {"digest": sync_rep.digest, "qps_sync": sync_rep.qps,
            "qps_async": async_rep.qps}


def replay_capture(dev, n: int = SERVE_N, queries: int = SERVE_QUERIES
                   ) -> dict:
    """serve-mixed-8192 captured by a TraceRecorder (every operand a
    generator spec), then replayed twice."""
    st = serve_trace
    rec = st.TraceRecorder(name=f"serve-mixed-{n}")
    # mixed_structures' generators, as specs
    specs = [(st.spec_er(n, 2, 100), st.spec_er(n, 2, 200),
              st.spec_er_mask(n, max(8, n // 8), 300))] + [
        (st.spec_er(n, 2 + 2 * s, 100 + s), st.spec_er(n, 2 + 2 * s, 200 + s),
         st.spec_er_mask(n, 8 * s, 300 + s)) for s in range(1, 4)]
    structs = mixed_structures(n)
    for (A, B, M), (sa, sb, sm) in zip(structs, specs):
        rec.register_operand(B, sb)
        rec.register_operand(M, sm)
    rng = np.random.default_rng(0)
    mix = []
    for q in range(queries):
        i = int(rng.integers(len(structs)))
        A, B, M = structs[i]
        a = rec.register_operand(revalue(A, 2000 + q),
                                 st.spec_revalue(specs[i][0], 2000 + q))
        mix.append((a, B, M))
    knobs = dict(max_wait_ms=2.0, max_batch=queries, queue_cap=4 * queries,
                 cache_results=False)
    with QueryEngine(async_mode=True, device=dev, **knobs) as eng:
        t0 = time.perf_counter()     # cold: plans and burst programs built
        for t in [eng.submit(*q) for q in mix]:
            t.result(timeout=600)
        cold_s = time.perf_counter() - t0
    eng = QueryEngine(async_mode=True, recorder=rec, device=dev, **knobs)
    t0 = time.perf_counter()
    tickets = [eng.submit(*q) for q in mix]
    for t in tickets:
        t.result(timeout=600)
    captured_s = time.perf_counter() - t0
    eng.close()
    trace = serve_trace.Trace.loads(rec.trace().dumps())
    kinds = {ev[op].get("kind") for ev in trace.events for op in "ABM"}
    check("inline" not in kinds, f"the capture holds generator specs only "
          f"(kinds {sorted(kinds)})")
    r1 = serve_trace.replay_trace(trace, knobs=knobs, device=dev)
    r2 = serve_trace.replay_trace(trace, knobs=knobs, device=dev)
    check(r1.digest == r2.digest and r1.counters["completed"] == queries,
          f"the captured trace replays twice to one digest ({r1.digest}, "
          f"{r2.digest})")
    print(f"replay [{CARD}]: serve-mixed-{n} captured ({queries} queries, "
          f"async, warm, {queries / captured_s:.0f} queries/s as captured; "
          f"the same stream cold {queries / cold_s:.0f}) and "
          f"replayed twice to digest {r1.digest}: {r1.qps:.0f} / "
          f"{r2.qps:.0f} queries/s in {r1.counters['buckets_executed']} "
          f"buckets")
    return {"digest": r1.digest, "captured_qps": queries / captured_s,
            "replay_qps": [r1.qps, r2.qps]}


def delta_path(dev, ops) -> dict:
    """Phase 7: the delta cells and the replays; returns their numbers."""
    out = {"burst": delta_burst(dev)}
    caches.clear_all()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["tile"] = delta_tile(dev, ops)
    caches.clear_all()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["golden"] = replay_golden(dev)
    out["capture"] = replay_capture(dev)
    caches.clear_all()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 11: planner calibration (repro_torch.tuning) on the card
# ---------------------------------------------------------------------------

#: a row route whose padded operands and result would exceed this many
#: bytes is reckoned, not run
ROW_ROUTE_BYTES_LIMIT = 20e9
#: timed runs of each elected route (after one warm-up), median kept
ELECTION_REPS = 3


def builtin_profile(dev):
    """The shipped constants as a profile whose version is the builtin
    token: activating it restores ``cost_model_token()`` exactly."""
    snap = tuning.snapshot(name="builtin",
                           backend=tuning.backend_signature(dev))
    return dataclasses.replace(snap, version=tuning.BUILTIN_VERSION)


def tuning_cells(ops, n: int = SERVE_N, scale: int = RMAT_SCALE) -> dict:
    """The operands the cells' planners elect on, with small-integer values
    so that every route's result is exact: tile-8192's, tc-rmat14's
    triangle product (0/1 data), serve-burst-8192's structure (mixed
    structure 0) and serve-mixed-8192's other three structures."""
    g = F.rmat(scale, RMAT_EDGE_FACTOR, seed=scale)
    L = F.tril(degree_relabel(g), strict=True)
    cells = {"tile-8192": ops, "tc-rmat14": (L, L, L)}
    for s, (A, B, M) in enumerate(mixed_structures(n)):
        name = "serve-burst-8192" if s == 0 else f"serve-mixed-8192 s{s}"
        cells[name] = (revalue(A, 2 * s, ints=True),
                       revalue(B, 2 * s + 1, ints=True), M)
    return cells


def route_of(p) -> tuple:
    return (p.algorithm, p.tile_block if p.algorithm == "tile" else 0)


def route_name(route) -> str:
    return f"tile/{route[1]}" if route[0] == "tile" else route[0]


def model_ms(stats, route) -> float:
    """The live cost model's ms for ``route`` on ``stats``."""
    alg, bs = route
    if alg == "tile":
        return planner.tile_cost(stats, bs)
    return acc.COST_HOOKS[alg](n=stats.n, wa=stats.wa, wb=stats.wb,
                               wbt=stats.wbt, pm=stats.pm) * stats.m / 1024


def row_route_bytes(stats, alg: str) -> float:
    """Bytes of a row route's padded operands and result: A (m x wa) and B
    (k x wb; B^T n x wbt for inner) as f32 values and int32 columns, M's
    int32 columns and the f32 / bool result (m x pm)."""
    rows_b, wb = ((stats.n, stats.wbt) if alg == "inner"
                  else (stats.k, stats.wb))
    return 8.0 * (stats.m * stats.wa + rows_b * wb) + 9.0 * stats.m * stats.pm


def elections(dev, cells: dict, profiles: dict) -> dict:
    """Per cell: the plan under each profile (a cold ``planner.plan``,
    measured trial included), each elected route's model ms under every
    profile and its measured warm ms (median of ``ELECTION_REPS`` host-
    clock runs ended by a synchronise); where the elections differ, the
    routes' results must be equal bit for bit.  Restores nothing: the
    caller activates what it needs next."""
    out = {}
    for name, (A, B, M) in cells.items():
        routes = {}
        for pname, prof in profiles.items():
            tuning.activate(prof)
            planner.clear_plan_cache()
            p = planner.plan(A, B, M, device=dev)
            routes[pname] = route_of(p)
        stats = p.stats
        distinct = list(dict.fromkeys(routes.values()))
        model = {}
        for pname, prof in profiles.items():
            tuning.activate(prof)
            model[pname] = {route_name(r): model_ms(stats, r)
                            for r in distinct}
        measured, results = {}, {}
        for r in distinct:
            if r[0] != "tile" and (
                    row_route_bytes(stats, r[0]) > ROW_ROUTE_BYTES_LIMIT):
                print(f"tuning [{CARD}]: {name}: {route_name(r)} would pad "
                      f"{row_route_bytes(stats, r[0]) / 1e9:.1f} GB (over "
                      f"{ROW_ROUTE_BYTES_LIMIT / 1e9:.0f}): not run; its "
                      f"comparison is skipped")
                measured[route_name(r)] = None
                continue

            def call(r=r):
                res = masked_spgemm(A, B, M, algorithm=r[0],
                                    tile_block=r[1] or None, device=dev)
                sync(dev)
                return res

            res = call()
            times = []
            for _ in range(ELECTION_REPS):
                t0 = time.perf_counter()
                res = call()
                times.append((time.perf_counter() - t0) * 1e3)
            measured[route_name(r)] = statistics.median(times)
            results[r] = res
        got = list(results.values())
        for r, other in zip(list(results)[1:], got[1:]):
            check(torch.equal(got[0].vals, other.vals)
                  and torch.equal(got[0].present, other.present),
                  f"{name}: {route_name(r)} equals "
                  f"{route_name(distinct[0])} bit for bit")
        for pname in profiles:
            r = route_name(routes[pname])
            ms = measured[r]
            print(f"tuning [{CARD}]: {name} under {pname}: elects {r}; "
                  "model " + ", ".join(
                      f"{q} {model[q][r]:.4g}" for q in profiles)
                  + " ms; measured "
                  + (f"{ms:.2f} ms" if ms is not None else "not run"))
        if len(results) > 1:
            print(f"tuning [{CARD}]: {name}: "
                  + " and ".join(route_name(r) for r in results)
                  + " agree bit for bit (values and present)")
        out[name] = {"elected": {q: route_name(r) for q, r in routes.items()},
                     "model_ms": model, "measured_ms": measured}
    return out


def tuning_phase(dev, ops) -> dict:
    """Phase 11: the committed H100 profile from the registry, the probe
    and fit pipeline on the card (smoke grids), the cells' elections
    under the builtin constants and the H100 profile, and the serving
    knobs.  Ends with the builtin constants active again."""
    check(tuning.active_profile() is None, "the phase starts under the "
          "shipped constants (no profile active)")
    builtin = builtin_profile(dev)
    try:
        h100, exact = tuning.lookup()
        check(exact, f"the registry holds a profile for "
              f"{tuning.backend_signature(dev)} (got {h100.name!r})")
        h100.validate()
        print(f"tuning [{CARD}]: registry: {h100.name} version "
              f"{h100.version}, residuals {h100.residuals}, meta "
              f"{json.dumps(h100.meta, sort_keys=True)}")

        reset_counts()
        t0 = time.perf_counter()
        with count_plain() as plain:
            ms = probes.run_probes(("row", "tile"), smoke=True, device=dev,
                                   log=lambda line: None)
        probe_s = time.perf_counter() - t0
        launches = kernel.FUSED_LAUNCHES
        check(launches == probes.tile_calls(smoke=True)
              and kernel.LAUNCHES == 0,
              f"the tile probes launched the fused kernel "
              f"{probes.tile_calls(smoke=True)} times and the values-only "
              f"one never (got {launches}, {kernel.LAUNCHES})")
        check(plain.calls == 0, f"no plain version ran (got {plain.calls})")
        smoke_fit = fit.fit_profile(ms, builtin, families=("row", "tile"),
                                    name="smoke",
                                    backend=tuning.backend_signature(dev))
        check(set(smoke_fit.residuals) == {"row", "tile"}
              and all(math.isfinite(v) for v in smoke_fit.residuals.values()),
              f"the smoke fit validates with finite row and tile residuals "
              f"({smoke_fit.residuals})")
        print(f"tuning [{CARD}]: smoke probes: {len(ms)} measurements in "
              f"{probe_s:.2f} s, {launches} fused launches, no plain "
              f"version; fit residuals {smoke_fit.residuals}, tile cost "
              f"{smoke_fit.tile_cost}")

        cells = tuning_cells(ops)
        elected = elections(dev, cells,
                            {"builtin": builtin, "H100": h100})

        tuning.activate(h100)
        golden = serve_trace.Trace.load(serve_trace.golden_trace_path())
        tuned = autotune.autotune(golden, smoke=True, rounds=1, device=dev,
                                  verbose=False)
        check(tuned["winner"]["qps"] >= tuned["default"]["qps"],
              "the knob search's winner is no slower than the default")
        committed = autotune.load_serving_profile()
        check(Path(committed["path"]).name == "serving_"
              + tuning.profile_key(h100.backend) + ".json",
              f"the registry holds the H100 serving knobs (got "
              f"{committed['path']})")
        knobs = autotune.load_serving_knobs()
        check(knobs == committed["knobs"], "load_serving_knobs() returns "
              "the committed H100 knobs under the H100 profile")
        tuning.activate(builtin)
        try:
            autotune.load_serving_knobs()
            stale = False
        except autotune.ServingProfileError:
            stale = True
        check(stale, "under the builtin constants the H100 knobs are stale")
        print(f"tuning [{CARD}]: knobs: smoke search on the golden trace "
              f"{tuned['winner']['qps']:.0f} queries/s "
              f"{tuned['winner']['knobs']} against the default's "
              f"{tuned['default']['qps']:.0f}; committed H100 knobs "
              f"{knobs} load under the H100 profile and are stale under "
              f"the builtin constants")
    finally:
        tuning.activate(builtin)
        planner.clear_plan_cache()
    return {"launches": launches, "measurements": len(ms),
            "probe_s": probe_s, "residuals": smoke_fit.residuals,
            "elections": elected}


# ---------------------------------------------------------------------------
# Phase 12: health (repro_torch.obs) on the card
# ---------------------------------------------------------------------------

#: timed pairs of serve-mixed-8192's stream, plain-traced against monitored
HEALTH_PAIRS = 11
#: re-emissions of one monitored run's records that time the monitor alone
EMIT_REPS = 51
#: requests of the error storm (the serve-errors objective needs 4)
STORM_REQUESTS = 16
#: queries of each structure per drift run, the detector's band (the
#: reference bench's) and the warp of the third run's constants
DRIFT_QUERIES = 8
DRIFT_BAND = 8.0
DRIFT_WARP = 256.0


def http_get(url: str):
    """``(status, body)`` of a GET on the engine's loopback endpoint."""
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def health_overhead(dev, n: int = SERVE_N, queries: int = SERVE_QUERIES,
                    pairs: int = HEALTH_PAIRS) -> dict:
    """serve-mixed-8192's stream served by one sync engine ``pairs`` times
    under an ``InMemorySink`` and as often under a ``HealthMonitor``
    teeing into one, in turns (which side goes first alternates): results
    bit for bit equal, equal span names, and a plain-traced and a
    monitored engine's ``deterministic_snapshot()`` equal.  Then the
    monitor's own host cost: one monitored run's records emitted again
    into a fresh sink and into a fresh monitor, ``EMIT_REPS`` times each
    (the serve's run-to-run spread is wider than that cost)."""
    stream = mixed_stream(n, queries)
    kw = dict(max_batch=queries, queue_cap=4 * queries, cache_results=False,
              device=dev)

    def serve(eng, sink):
        t0 = time.perf_counter()
        with obs.tracing(sink):
            got = eng.serve(stream)
        sync(dev)
        return got, (time.perf_counter() - t0) * 1e3

    snaps = []
    for make in (lambda: obs.InMemorySink(capacity=1 << 16),
                 lambda: obs.HealthMonitor(
                     inner=obs.InMemorySink(capacity=1 << 16))):
        with QueryEngine(**kw) as fresh:
            serve(fresh, make())
            snaps.append(fresh.metrics.deterministic_snapshot())
    check(snaps[0] == snaps[1], "a monitored engine's deterministic_snapshot"
          "() equals a plain-traced one's")
    eng = QueryEngine(**kw)
    want, _ = serve(eng, obs.InMemorySink(capacity=1 << 16))   # warm
    shares, plain_ms, mon_ms = [], [], []
    for i in range(pairs):
        sink = obs.InMemorySink(capacity=1 << 16)
        mon = obs.HealthMonitor(inner=obs.InMemorySink(capacity=1 << 16))
        if i % 2 == 0:
            got_p, t_p = serve(eng, sink)
            got_m, t_m = serve(eng, mon)
        else:
            got_m, t_m = serve(eng, mon)
            got_p, t_p = serve(eng, sink)
        check(all(same_result(a, w) and same_result(b, w)
                  for a, b, w in zip(got_p, got_m, want)),
              "every ticket bit for bit equal plain-traced and monitored")
        names_p = [r["name"] for r in sink.spans()]
        names_m = [r["name"] for r in mon.spans()]
        check(names_p == names_m and "serve.exec" in names_p,
              "plain-traced and monitored runs emit the same spans")
        check(mon.aggregator.window(60).count("serve.exec")
              == names_m.count("serve.exec"),
              "the monitor's window saw every exec span")
        plain_ms.append(t_p)
        mon_ms.append(t_m)
        shares.append(t_m / t_p - 1.0)
    eng.close()
    q = statistics.quantiles(shares, n=4)
    med = statistics.median(shares)
    records = mon.spans()
    execs = sum(1 for r in records if r["name"] == "serve.exec")

    def emit_ms(make) -> float:
        times = []
        for _ in range(EMIT_REPS):
            target = make()
            t0 = time.perf_counter()
            for r in records:
                target.emit(r)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    sink_ms = emit_ms(lambda: obs.InMemorySink(capacity=1 << 16))
    monitor_ms = emit_ms(lambda: obs.HealthMonitor(
        inner=obs.InMemorySink(capacity=1 << 16)))
    added_ms = monitor_ms - sink_ms
    added_share = added_ms / statistics.median(plain_ms)
    print(f"health [{CARD}]: overhead, serve-mixed-8192 ({queries} queries, "
          f"sync, {pairs} pairs, order alternating): plain-traced "
          f"{statistics.median(plain_ms):.2f} ms, monitored "
          f"{statistics.median(mon_ms):.2f} ms (medians); monitored share "
          f"median {med:+.2%}, quartiles {q[0]:+.2%} / {q[2]:+.2%}, range "
          f"{min(shares):+.2%} .. {max(shares):+.2%}; spans "
          f"{len(names_p)} a run, bitwise and span names equal, "
          f"deterministic_snapshot equal")
    print(f"health [{CARD}]: overhead, the monitor alone: one run's "
          f"{len(records)} records ({execs} exec spans) emitted into a sink "
          f"in {sink_ms * 1e3:.1f} us and into a monitor in "
          f"{monitor_ms * 1e3:.1f} us (medians of {EMIT_REPS}): "
          f"{added_ms * 1e3:.1f} us added a serve, {added_share:.3%} of the "
          f"plain-traced serve")
    return {"pairs": pairs, "share_median": med, "share_q1": q[0],
            "share_q3": q[2], "shares": shares,
            "plain_ms": statistics.median(plain_ms),
            "monitored_ms": statistics.median(mon_ms),
            "records": len(records), "exec_records": execs,
            "emit_sink_ms": sink_ms, "emit_monitor_ms": monitor_ms,
            "monitor_share": added_share}


def health_pressure(dev, ops, n: int = SERVE_N) -> dict:
    """A monitored engine with ``expose_port=0``: ``/health`` 200 "ok"
    after one tile-8192 query (one fused launch, no plain version), 503
    with the serve-errors reason after an error storm of hash +
    complement requests (``NotImplementedError`` in the port), and
    ``/metrics`` parsed with ``repro_health_status`` 2 and both windows'
    burn rates."""
    A, B, M = ops
    sA, sB, sM = mixed_structures(n)[1]
    mon = obs.HealthMonitor()
    eng = QueryEngine(monitor=mon, expose_port=0, device=dev)
    try:
        base = eng.obs_server.url
        with obs.tracing(mon):
            reset_counts()
            with count_plain() as plain:
                eng.serve([(revalue(A, 0, ints=True), B, M)])
            launches = kernel.FUSED_LAUNCHES
            check(launches == 1 and kernel.LAUNCHES == 0 and plain.calls == 0,
                  f"the tile query launched the fused kernel once and no "
                  f"plain version ran (got {launches}, {kernel.LAUNCHES}, "
                  f"{plain.calls})")
            code, body = http_get(f"{base}/health")
            healthy = json.loads(body)
            check(code == 200 and healthy["status"] == "ok"
                  and healthy["completed"] == 1,
                  f"/health answers 200 ok after the tile query (got {code} "
                  f"{body.strip()})")
            t0 = time.perf_counter()
            storm = [eng.submit(sA, sB, sM, algorithm="hash",
                                complement=True)
                     for _ in range(STORM_REQUESTS)]
            eng.flush()
            failures = 0
            for t in storm:
                try:
                    t.result()
                except NotImplementedError:
                    failures += 1
            storm_ms = (time.perf_counter() - t0) * 1e3
            check(failures == STORM_REQUESTS, f"every storm request failed "
                  f"with NotImplementedError ({failures})")
            code, body = http_get(f"{base}/health")
            failing = json.loads(body)
            check(code == 503 and failing["status"] == "failing"
                  and any("serve-errors" in r for r in failing["reasons"]),
                  f"/health answers 503 failing with the serve-errors reason "
                  f"(got {code} {body.strip()})")
            code, text = http_get(f"{base}/metrics")
            samples = obs.parse_prometheus(text)
            burn = {w: samples.get(("repro_slo_burn_rate",
                                    (("slo", "serve-errors"), ("window", w))))
                    for w in ("short", "long")}
            check(code == 200
                  and samples.get(("repro_health_status", ())) == 2.0
                  and all(v is not None and v >= 2.0 for v in burn.values()),
                  f"/metrics parses with repro_health_status 2 and both "
                  f"windows' burn rates (got {code}, "
                  f"{samples.get(('repro_health_status', ()))}, {burn})")
    finally:
        eng.close()
    check(eng.obs_server is None, "close() stopped the server")
    print(f"health [{CARD}]: pressure: /health 200 ok after one tile-8192 "
          f"query (1 fused launch, no plain version), then {failures} "
          f"hash+complement requests failed in {storm_ms:.1f} ms: /health "
          f"503 {failing['reasons']}; /metrics {len(samples)} samples, "
          f"repro_health_status 2, serve-errors burn short "
          f"{burn['short']:.1f} long {burn['long']:.1f}")
    return {"launches": launches, "failures": failures, "burn": burn,
            "metrics_samples": len(samples)}


def rebuilt_stats(spans) -> dict:
    """Per-key (count, mean, ewma) of the log residuals that
    ``export.residuals`` recomputes from captured spans (burst skipped),
    folded as the detector folds them."""
    stats = {}
    for r in obs.residuals(spans):
        if r["route"] == "burst":
            continue
        key = (obs.drift.family_of(r["algorithm"]), str(r["algorithm"]),
               str(r["regime"] or "-"))
        stats.setdefault(key, obs.drift.KernelStats()).update(
            math.log(r["residual"]))
    return {k: (v.count, v.mean, v.ewma) for k, v in stats.items()}


def warped_profile(prof, factor: float):
    """``prof`` with every cost constant times ``factor`` (a new token)."""
    return dataclasses.replace(
        prof, name=f"{prof.name} x{factor:g}", version="",
        cost_constants={a: {k: v * factor for k, v in t.items()}
                        for a, t in prof.cost_constants.items()},
        tile_cost={k: v * factor for k, v in prof.tile_cost.items()},
        dist_cost={k: v * factor for k, v in prof.dist_cost.items()})


def health_drift(dev, ops, n: int = SERVE_N,
                 queries: int = DRIFT_QUERIES) -> dict:
    """One ``DriftDetector(band=8)`` over three runs of an engine with
    ``max_batch=1, use_burst=False, cache_results=False``, each serving
    ``queries`` tile-8192 queries and as many on each serve-mixed-8192
    structure: under the builtin constants (row and tile flagged), the
    committed H100 profile (token changed, statistics reset) and that
    profile warped x256 (both families flagged).  Each run: the
    detector's statistics equal those rebuilt from the spans, one fused
    launch per tile query and no plain version.  Ends under the builtin
    constants."""
    A, B, M = ops
    structs = [(A, B, M)] + mixed_structures(n)
    builtin = builtin_profile(dev)
    h100, exact = tuning.lookup()
    check(exact, "the registry holds the card's profile")
    det = obs.DriftDetector(band=DRIFT_BAND)
    runs = {}
    try:
        for label, prof in (("builtin", builtin), ("H100", h100),
                            (f"H100 x{DRIFT_WARP:g}",
                             warped_profile(h100, DRIFT_WARP))):
            tuning.activate(prof)
            planner.clear_plan_cache()
            before = det.token
            inner = obs.InMemorySink(capacity=1 << 16)
            mon = obs.HealthMonitor(drift=det, inner=inner)
            eng = QueryEngine(max_batch=1, use_burst=False,
                              cache_results=False, monitor=mon, device=dev)
            reset_counts()
            t0 = time.perf_counter()
            with count_plain() as plain, obs.tracing(mon):
                for q in range(queries):
                    for a, b, m in structs:
                        eng.submit(revalue(a, 3000 + q, ints=True), b,
                                   m).result()
            run_s = time.perf_counter() - t0
            eng.close()
            check(kernel.FUSED_LAUNCHES == queries and kernel.LAUNCHES == 0
                  and plain.calls == 0, f"{label}: the tile queries launched "
                  f"the fused kernel once each and no plain version ran (got "
                  f"{kernel.FUSED_LAUNCHES}, {kernel.LAUNCHES}, "
                  f"{plain.calls})")
            check(det.token == planner.cost_model_token()
                  and (label == "builtin" or det.token != before),
                  f"{label}: the detector follows the cost model's token "
                  f"({before} -> {det.token})")
            got = {k: (v.count, v.mean, v.ewma)
                   for k, v in det.stats().items()}
            check(got == rebuilt_stats(inner.spans()),
                  f"{label}: the detector's residuals equal "
                  f"export.residuals on the captured spans")
            check(sum(c for c, _, _ in got.values())
                  == queries * len(structs),
                  f"{label}: the statistics hold this run's "
                  f"{queries * len(structs)} queries only (reset)")
            rep = det.report()
            flagged = {(f.family, f.algorithm, f.regime) for f in rep.flags}
            for key, st in det.snapshot().items():
                mark = (" FLAGGED" if (st["family"], st["algorithm"],
                                       st["regime"]) in flagged else "")
                print(f"health [{CARD}]: drift under {label} ({det.token}): "
                      f"{key}: ewma residual {st['ewma_residual']:.4g}, mean "
                      f"{st['mean_residual']:.4g}, log stddev "
                      f"{st['log_stddev']:.3f}, count {st['count']}{mark}")
            print(f"health [{CARD}]: drift under {label}: "
                  f"{len(rep.flags)} flags, families {list(rep.families)}, "
                  f"{rep.command or 'no command'}; {run_s:.1f} s")
            if label == "builtin":
                check(rep.families == ("row", "tile")
                      and "python -m repro_torch.tune --only row,tile"
                      in rep.command, f"builtin: row and tile flagged with "
                      f"the port's tune command (got {rep.families}, "
                      f"{rep.command!r})")
            elif label != "H100":
                check(rep.families == ("row", "tile")
                      and {k[0] for k in got} == {"row", "tile"},
                      f"{label}: every family served is flagged (got "
                      f"{rep.families})")
            runs[label] = {"token": det.token, "families": rep.families,
                           "flags": len(rep.flags), "stats": det.snapshot(),
                           "launches": kernel.FUSED_LAUNCHES}
    finally:
        tuning.activate(builtin)
        planner.clear_plan_cache()
    check(planner.cost_model_token() == runs["builtin"]["token"],
          "the builtin constants are active again")
    return runs


def health_async_residuals(dev, n: int = SERVE_N,
                           queries: int = SERVE_QUERIES) -> dict:
    """serve-mixed-8192's async stream (as phase 6 serves it) under a
    monitor: the residuals of its exec spans, one line each."""
    stream = mixed_stream(n, queries)
    det = obs.DriftDetector(band=DRIFT_BAND)
    inner = obs.InMemorySink(capacity=1 << 16)
    mon = obs.HealthMonitor(drift=det, inner=inner)
    eng = QueryEngine(async_mode=True, max_wait_ms=2.0, max_batch=queries,
                      queue_cap=4 * queries, cache_results=False,
                      monitor=mon, device=dev)
    with obs.tracing(mon):
        tickets = [eng.submit(*q) for q in stream]
        got = [t.result(timeout=600) for t in tickets]
    eng.close()
    check(len(got) == queries, "the async stream served every query")
    rows = obs.residuals(inner.spans())
    for r in rows:
        print(f"health [{CARD}]: async serve-mixed-8192 under the builtin "
              f"constants: {r['route']}/{r['algorithm']} size {r['size']} "
              f"regime {r['regime']}: measured {r['measured_ms']:.3f} ms, "
              f"modeled {r['modeled_ms']:.4g} ms a query, residual "
              f"{r['residual']:.4g}"
              + (" (burst: not folded)" if r["route"] == "burst" else ""))
    print(f"health [{CARD}]: async serve-mixed-8192: {len(rows)} exec spans "
          f"with a modeled cost, {len(det.flags())} drift flags")
    return {"residuals": [{k: r[k] for k in ("route", "algorithm", "size",
                                             "regime", "residual")}
                          for r in rows]}


def health_phase(dev, ops) -> dict:
    """Phase 12: the monitor's overhead on serve-mixed-8192, the error
    storm behind /health and /metrics, drift under the builtin, H100 and
    warped constants, and an async stream's residuals."""
    out = {"overhead": health_overhead(dev),
           "pressure": health_pressure(dev, ops),
           "drift": health_drift(dev, ops),
           "async": health_async_residuals(dev)}
    out["launches"] = out["pressure"]["launches"] + sum(
        run["launches"] for run in out["drift"].values())
    return out


# ---------------------------------------------------------------------------
# Phase 8: tile SDDMM (masked_matmul)
# ---------------------------------------------------------------------------


def sddmm_f64(a, b, bi, bj, bm: int, bn: int) -> torch.Tensor:
    """The tile SDDMM in float64: the exact value to f32 accuracy."""
    rows = bi.long()[:, None] * bm + torch.arange(bm, device=a.device)
    cols = bj.long()[:, None] * bn + torch.arange(bn, device=a.device)
    return torch.bmm(a.double()[rows], b.double()[:, cols].permute(1, 0, 2))


def sddmm_vs_plain(dev) -> float:
    """The reference's sweep (tests/test_kernels_masked_matmul.py): four
    shapes x blocks 8/16 x f32/bf16, within 1e-5 / 2e-2 of the plain
    version, and f32 also within 1e-5 of float64.  Then the f32 case of
    the GPU tests with K = 384, where the plain version's own IEEE f32
    bmm strays past 1e-5 of float64 at some outputs: the kernel is held
    to 1e-5 of float64 there, and the outputs beyond 1e-5 are counted."""
    err = 0.0
    for M, K, N in ((16, 16, 16), (32, 48, 64), (64, 32, 16),
                    (128, 128, 128)):
        for blk in (8, 16):
            if M % blk or K % blk or N % blk:
                continue
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
                rng = np.random.default_rng(42)
                a = torch.as_tensor(rng.standard_normal((M, K)),
                                    device=dev).to(dtype)
                b = torch.as_tensor(rng.standard_normal((K, N)),
                                    device=dev).to(dtype)
                ok = rng.random((M // blk, N // blk)) < 0.4
                ok.flat[0] = ok.flat[0] or not ok.any()
                bi, bj = (torch.as_tensor(x.astype(np.int32), device=dev)
                          for x in np.nonzero(ok))
                got = kernel.masked_matmul_kernel(a, b, bi, bj, bm=blk,
                                                  bn=blk, bk=blk)
                wants = [kernel.masked_matmul_plain(a, b, bi, bj, bm=blk,
                                                    bn=blk)]
                if dtype == torch.float32:
                    wants.append(sddmm_f64(a, b, bi, bj, blk, blk).float())
                sync(dev)
                for want in wants:
                    e = float((got - want).abs().max())
                    check(torch.allclose(got, want, rtol=tol, atol=tol),
                          f"masked_matmul ({M},{K},{N}) blocks {blk} "
                          f"{dtype} within {tol} (max err {e})")
                    err = max(err, e)

    # tests/test_torch_cuda.py's f32 case at blocks (128, 128, 128)
    rng = np.random.default_rng(256)
    a = torch.as_tensor(rng.standard_normal((512, 384)), dtype=torch.float32,
                        device=dev)
    b = torch.as_tensor(rng.standard_normal((384, 384)), dtype=torch.float32,
                        device=dev)
    ok = rng.random((4, 3)) < 0.5
    ok[0, 0] = True
    bi, bj = (torch.as_tensor(x.astype(np.int32), device=dev)
              for x in np.nonzero(ok))
    got = kernel.masked_matmul_kernel(a, b, bi, bj, bm=128, bn=128, bk=128)
    plain = kernel.masked_matmul_plain(a, b, bi, bj, bm=128, bn=128)
    exact = sddmm_f64(a, b, bi, bj, 128, 128)
    beyond = {name: int((~torch.isclose(x.double(), y.double(), rtol=1e-5,
                                        atol=1e-5)).sum())
              for name, x, y in (("kernel vs plain", got, plain),
                                 ("plain vs float64", plain, exact),
                                 ("kernel vs float64", got, exact))}
    check(beyond["kernel vs float64"] == 0, "f32 SDDMM at K = 384 within "
          "1e-5 of float64")
    print(f"sddmm-vs-plain: reference sweep agrees (1e-5 f32, also against "
          f"float64; 2e-2 bf16), max abs err {err:.3g}; at K = 384 "
          f"({got.numel()} outputs), outputs beyond 1e-5: "
          + ", ".join(f"{k} {v}" for k, v in beyond.items()))
    return err


def sddmm_path(dev, mask_tiles, n: int = TILE_N, bs: int = TILE_BS,
               k: int = SDDMM_K) -> dict:
    rng = np.random.default_rng(5)
    # integer data: every partial sum is exact in f32
    a = torch.as_tensor(rng.integers(-4, 5, (n, k)).astype(np.float32),
                        device=dev)
    b = torch.as_tensor(rng.integers(-4, 5, (k, n)).astype(np.float32),
                        device=dev)
    bi, bj = (torch.as_tensor(x.astype(np.int32), device=dev)
              for x in mask_tiles)
    nnzb = int(bi.shape[0])

    # the path, once, through its entry point
    reset_counts()
    got = ops.masked_matmul(a, b, bi, bj, bm=bs, bn=bs, bk=bs)
    sync(dev)
    launches = kernel.MASKED_MATMUL_LAUNCHES
    check(launches == 1, f"masked_matmul launched once (got {launches})")
    check(kernel.LAUNCHES == kernel.FUSED_LAUNCHES == flash.LAUNCHES == 0,
          "the SDDMM path launches "
          "no other kernel")
    want = kernel.masked_matmul_plain(a, b, bi, bj, bm=bs, bn=bs)
    check(torch.equal(got, want), "masked_matmul equals plain exactly on "
          "integer data")
    check(bool(torch.isfinite(got).all()), "SDDMM values are finite")
    err = float((got - want).abs().max())
    del got, want

    # the same call on standard-normal data, where precision shows: the
    # plain version runs bmm in IEEE f32, 3xTF32 keeps f32 accuracy and
    # one TF32 pass misses 2e-6 by more than 10x (test_torch_tc_numerics).
    # Any
    # f32 summation order errs by up to ~1e-5 of the dot products'
    # absolute scale sum_k |a_ik b_kj|, not of their (possibly tiny)
    # values, so the elementwise 1e-5 is held relative to that scale
    an = torch.as_tensor(rng.standard_normal((n, k)), dtype=torch.float32,
                         device=dev)
    bn_ = torch.as_tensor(rng.standard_normal((k, n)), dtype=torch.float32,
                          device=dev)
    got = ops.masked_matmul(an, bn_, bi, bj, bm=bs, bn=bs, bk=bs)
    want = kernel.masked_matmul_plain(an, bn_, bi, bj, bm=bs, bn=bs)
    diff = (got - want).abs()
    rel = float(diff.norm() / want.norm())
    err = max(err, float(diff.max()))
    diff /= kernel.masked_matmul_plain(an.abs(), bn_.abs(), bi, bj, bm=bs,
                                       bn=bs)
    scaled = float(diff.max())
    del diff
    exact = sddmm_f64(an, bn_, bi, bj, bs, bs)
    rel64 = float((got.double() - exact).norm() / exact.norm())
    print(f"sddmm: standard-normal data: normwise {rel:.3g} against plain "
          f"(IEEE f32 bmm), {rel64:.3g} against float64; max |diff| / "
          f"sum_k |a b| {scaled:.3g} against plain")
    check(max(rel, rel64) <= 2e-6, f"SDDMM on float data within 2e-6 "
          f"normwise of plain and of float64 (got {rel:.3g}, {rel64:.3g})")
    check(scaled <= 1e-5, f"SDDMM on float data within 1e-5 of "
          f"sum_k |a b| elementwise (got {scaled:.3g})")
    del an, bn_, got, want, exact

    def run_library():      # gather the panels of block views, one bmm
        a_pan = a.view(n // bs, bs, k)[bi.long()]
        b_pan = b.view(k, n // bs, bs).permute(1, 0, 2)[bj.long()]
        return torch.bmm(a_pan, b_pan)

    kernel_ms = device_ms(lambda: kernel.masked_matmul_kernel(
        a, b, bi, bj, bm=bs, bn=bs, bk=bs), dev, reps=7, warm=2)
    plain_ms = device_ms(lambda: kernel.masked_matmul_plain(
        a, b, bi, bj, bm=bs, bn=bs), dev, reps=5, warm=1)
    library_ms = device_ms(run_library, dev, reps=5, warm=1)
    flops = 2.0 * nnzb * bs * bs * k
    nbytes = a.nbytes + b.nbytes + 8 * nnzb + nnzb * bs * bs * 4
    bound_ms, by = bound(flops, nbytes, PEAK_F32_ACCURATE_FLOPS)
    f32_ms = flops / PEAK_F32_FLOPS * 1e3
    print(f"sddmm: M=N={n} K={k} blocks {bs} nnzb={nnzb}: {flops / 1e9:.1f} "
          f"GFLOP, {nbytes / 1e6:.0f} MB; launches {launches}; equals plain "
          f"exactly on integers")
    print(f"sddmm: kernel {kernel_ms:.3f} ms ({flops / kernel_ms / 1e9:.1f} "
          f"TFLOP/s; PR 12: {PR12_MS['masked_matmul']:.3f} ms); plain "
          f"{plain_ms:.3f} ms; library (block-view gather + torch.bmm) "
          f"{library_ms:.3f} ms; bound {bound_ms:.3f} ms (by {by}, three "
          f"TF32 passes; {f32_ms:.3f} ms on f32 CUDA cores); kernel at "
          f"{bound_ms / kernel_ms:.1%} of it")
    return {"name": "masked_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/masked_matmul/csrc/"
                      "masked_matmul.cu",
            "replaces": "src/repro/kernels/masked_matmul/kernel.py:50",
            "launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms,
            "design": "mma.sync tensor cores: 3xTF32 (f32 operands split "
                      "hi + lo, three m16n8k8 passes) or one bf16 m16n8k16 "
                      "pass; 3-stage cp.async ring of 32-deep K chunks; "
                      "128x128 CTA tile, 8 warps of 64x32"}


# ---------------------------------------------------------------------------
# Phase 9: flash attention (flash_mask)
# ---------------------------------------------------------------------------


FLASH_PATTERNS = (dict(causal=True, window=0, prefix=0),
                  dict(causal=True, window=16, prefix=0),
                  dict(causal=True, window=16, prefix=8),
                  dict(causal=False, window=0, prefix=0))


def flash_compare(q, k, v, *, bq, bk, q_offset, tol, atol=None,
                  normwise=None, **pattern):
    """Kernel against plain on the same (B, H, S, D) tensors, elementwise
    within rtol ``tol`` and atol ``atol`` (default ``tol``) and, if given,
    within ``normwise`` of |want| in the 2-norm: returns max |diff| and the
    normwise error."""
    sched = [torch.as_tensor(x, device=q.device) for x in flash.build_schedule(
        q.shape[-2], k.shape[-2], bq=bq, bk=bk, q_offset=q_offset,
        **pattern)]
    kw = dict(bq=bq, bk=bk, scale=q.shape[-1] ** -0.5, q_offset=q_offset,
              **pattern)
    got = flash.flash_mask_kernel(q, k, v, *sched, **kw)
    want = flash.flash_mask_plain(q, k, v, *sched, **kw)
    sync(q.device)
    check(got.dtype == q.dtype, "flash output in q.dtype")
    atol = tol if atol is None else atol
    diff = got.float() - want.float()
    err = float(diff.abs().max())
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=atol),
          f"flash {tuple(q.shape)} {q.dtype} {pattern} within rtol {tol} "
          f"atol {atol} (max err {err})")
    rel = float(diff.norm() / want.float().norm())
    if normwise is not None:
        check(rel <= normwise, f"flash {tuple(q.shape)} {q.dtype} {pattern} "
              f"within {normwise} normwise (got {rel:.3g})")
    return err, rel


def flash_vs_plain(dev) -> float:
    """The reference's sweep (tests/test_kernels_flash_mask.py): four
    patterns x three shapes x f32/bf16 with q_offset = s_k - s_q, the
    decode offset and the GQA op, within 2e-5 / 3e-2, and bf16 also within
    the layer's 2e-3 normwise (one bf16 term for p, instead of the kernel's
    two, exceeds it at the layer's shape: test_torch_tc_numerics)."""
    err = rel_bf16 = 0.0
    d = 16
    tc_before, f32_before = flash.TC_LAUNCHES, flash.F32_LAUNCHES
    for pattern in FLASH_PATTERNS:
        for s_q, s_k, bq, bk in ((32, 32, 8, 8), (64, 64, 16, 16),
                                 (32, 64, 8, 16)):
            for dtype, tol, normwise in ((torch.float32, 2e-5, None),
                                         (torch.bfloat16, 3e-2, 2e-3)):
                rng = np.random.default_rng(11)
                q, k, v = (torch.as_tensor(
                    rng.standard_normal((1, 1, s, d)) * 0.5,
                    device=dev).to(dtype) for s in (s_q, s_k, s_k))
                e, rel = flash_compare(q, k, v, bq=bq, bk=bk,
                                       q_offset=s_k - s_q, tol=tol,
                                       normwise=normwise, **pattern)
                err = max(err, e)
                if dtype == torch.bfloat16:
                    rel_bf16 = max(rel_bf16, rel)
    check(flash.TC_LAUNCHES - tc_before == 24
          and flash.F32_LAUNCHES - f32_before == 12, "the 24 cases ran "
          "tensor-core kernels, the 12 f32 ones the 3xTF32 kernel")
    rng = np.random.default_rng(9)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 1, s, d)) * 0.5,
                               dtype=torch.float32, device=dev)
               for s in (8, 64, 64))
    err = max(err, flash_compare(q, k, v, bq=8, bk=8, q_offset=56, tol=2e-5,
                                 **FLASH_PATTERNS[0])[0])
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.standard_normal((2, 4, 32, d)) * 0.3,
                        dtype=torch.float32, device=dev)
    k, v = (torch.as_tensor(rng.standard_normal((2, 2, 32, d)) * 0.3,
                            dtype=torch.float32, device=dev)
            for _ in range(2))
    got = flash_mask_attention(q, k, v, causal=True, bq=8, bk=8)
    sched = [torch.as_tensor(x, device=dev) for x in flash.build_schedule(
        32, 32, bq=8, bk=8, causal=True, window=0, prefix=0, q_offset=0)]
    want = flash.flash_mask_plain(q, k, v, *sched, bq=8, bk=8,
                                  scale=d ** -0.5, causal=True, window=0,
                                  prefix=0, q_offset=0)
    sync(dev)
    e = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
          f"GQA op within 2e-5 (max err {e})")
    err = max(err, e)
    print(f"flash-vs-plain: reference sweep, decode offset and GQA op "
          f"agree (2e-5 f32, 3e-2 bf16), max abs err {err:.3g}; bf16 "
          f"normwise at most {rel_bf16:.3g} (limit 2e-3)")
    return err


def flash_layer(dev, b: int = LM_BATCH, s: int = LM_SEQ) -> dict:
    """One full-width llama3.2-1b attention layer: kernel, plain, library."""
    cfg = get_config("llama3_2_1b")
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    blk = cfg.attn_block
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = ((torch.randn(shape, generator=g, device=dev) * 0.5)
               .to(torch.bfloat16)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    sched = [torch.as_tensor(x, device=dev) for x in flash.build_schedule(
        s, s, bq=blk, bk=blk, causal=True, window=0, prefix=0, q_offset=0)]
    pairs = int(sched[0].shape[0])
    # most outputs are averages over many keys, of magnitude ~0.5/sqrt(i+1)
    # at row i, so hold the layer far below the sweep's 3e-2: rtol 1e-2
    # admits one bf16 rounding flip at any magnitude (2^-7 relative), atol
    # 1e-3 lies under the typical output, and 2e-3 normwise catches a lost
    # tile or a wrong rescale (either moves late rows by percents)
    err, rel = flash_compare(q, k, v, bq=blk, bk=blk, q_offset=0, tol=1e-2,
                             atol=1e-3, normwise=2e-3, **FLASH_PATTERNS[0])
    kw = dict(bq=blk, bk=blk, scale=d ** -0.5, causal=True, window=0,
              prefix=0, q_offset=0)
    kernel_ms = device_ms(lambda: flash.flash_mask_kernel(q, k, v, *sched,
                                                          **kw),
                          dev, reps=7, warm=2)
    plain_ms = device_ms(lambda: flash.flash_mask_plain(q, k, v, *sched,
                                                        **kw),
                         dev, reps=3, warm=1)
    library_ms = device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), dev, reps=7, warm=2)
    # the function needs q.k and p.v only at the allowed (q, k) elements;
    # the worklist's tiles also cover the masked halves of diagonal tiles
    allowed = int(mask_allowed(s, s, causal=True, window=0, prefix=0,
                               q_offset=0).sum())
    flops = 4.0 * b * hq * allowed * d
    tile_flops = 4.0 * b * hq * pairs * blk * blk * d
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + 12 * pairs
    bound_ms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    f32_ms = bound(flops, nbytes, PEAK_F32_ACCURATE_FLOPS)[0]
    f32 = f32_instance(dev, q.shape, k.shape, sched, kw, allowed, pairs)
    print(f"flash: B={b} Hq={hq} Hkv={hkv} S={s} D={d} blocks {blk} causal "
          f"bf16: {pairs} pairs per (batch, head), {flops / 1e9:.2f} GFLOP "
          f"at the allowed elements ({tile_flops / 1e9:.1f} over whole "
          f"tiles, {1.5 * tile_flops / 1e9:.1f} issued with p.v in two "
          f"terms), {nbytes / 1e6:.0f} MB")
    print(f"flash: kernel vs plain at the layer: max |diff| {err:.3g}, "
          f"normwise {rel:.3g} (limits rtol 1e-2, atol 1e-3, 2e-3 normwise)")
    print(f"flash: kernel {kernel_ms:.3f} ms ({flops / kernel_ms / 1e9:.1f} "
          f"TFLOP/s; PR 12: {PR12_MS['flash_mask']:.3f} ms); plain "
          f"{plain_ms:.3f} ms; library (scaled_dot_product_attention, "
          f"causal, GQA) {library_ms:.3f} ms; bound {bound_ms:.4f} ms (by "
          f"{by}, bf16 tensor cores; the f32 instance's, three TF32 passes: "
          f"{f32_ms:.3f} ms); kernel at {bound_ms / kernel_ms:.2%} of it")
    return {"name": "flash_mask", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_mask/csrc/flash_mask.cu",
            "replaces": "src/repro/kernels/flash_mask/kernel.py:121",
            "launches": 0, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms,
            **f32,
            "design": "bf16: mma.sync m16n8k16 tensor cores, q tile in "
                      "shared memory, k/v in a 2-stage cp.async ring, online "
                      "softmax in registers, p.v as two bf16 terms (p = hi + "
                      "lo); f32: mma.sync m16n8k8 tf32 tensor cores in "
                      "3xTF32 (q.k^T and p.v; hi/lo splits rounded in "
                      "integer arithmetic, IEEE k-step adds), k/v in a "
                      "2-stage cp.async ring of 64-key chunks"}


def f32_instance(dev, q_shape, kv_shape, sched, kw, allowed: int,
                 pairs: int) -> dict:
    """The f32 (3xTF32) flash instance at the layer's shape, on f32 inputs
    of full precision (0.5 randn, seed 8): against its plain version (the
    sweep's rtol = atol = 2e-5) at B 1 and float64 (2e-6 normwise) at B 1
    and B 4; its times at B 1 (the f32 prefill's shape) and B 4 beside its
    bound, the plain version and f32 ``scaled_dot_product_attention``
    (causal, with the kv heads expanded to the query heads before the clock
    starts), whose error from float64 is reported too.  Returns the f32
    fields of the flash entry of the JSON line."""
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(shape, generator=gen, device=dev) * 0.5
               for shape in (q_shape, kv_shape, kv_shape))
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    out = {"f32_ms": {}, "f32_bound_ms": {}, "f32_plain_ms": {},
           "f32_library_ms": {}, "f32_vs_f64": {}, "f32_library_vs_f64": {}}
    for bb in sorted({1, b}):
        qf, kf, vf = (x[:bb] for x in (q, k, v))
        ke, ve = (x.repeat_interleave(g, dim=1) for x in (kf, vf))
        got = flash.flash_mask_kernel(qf, kf, vf, *sched, **kw)
        lib = torch.nn.functional.scaled_dot_product_attention(
            qf, ke, ve, is_causal=True)
        # float64 one batch row at a time: the scores of all four are 4 GB
        num = den = lib_num = 0.0
        for i in range(bb):
            sc = (qf[i].double() @ ke[i].double().transpose(-1, -2)) * kw[
                "scale"]
            sc.masked_fill_(torch.ones(s, s, dtype=torch.bool, device=dev)
                            .triu_(1), float("-inf"))
            exact = torch.softmax(sc, dim=-1) @ ve[i].double()
            del sc
            num += float((got[i].double() - exact).norm()) ** 2
            lib_num += float((lib[i].double() - exact).norm()) ** 2
            den += float(exact.norm()) ** 2
            del exact
        rel, lib_rel = (num / den) ** 0.5, (lib_num / den) ** 0.5
        if bb == 1:
            want = flash.flash_mask_plain(qf, kf, vf, *sched, **kw)
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
                  f"f32 flash at the layer's shape within 2e-5 of plain "
                  f"(max err {err})")
            out["f32_max_abs_err"] = err
            del want
        check(rel <= 2e-6, f"f32 flash at B {bb} within 2e-6 normwise of "
              f"float64 (got {rel:.3g})")
        t_ms = device_ms(lambda: flash.flash_mask_kernel(qf, kf, vf, *sched,
                                                         **kw),
                         dev, reps=7, warm=2)
        plain_ms = device_ms(lambda: flash.flash_mask_plain(qf, kf, vf,
                                                            *sched, **kw),
                             dev, reps=3, warm=1)
        lib_ms = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qf, ke, ve, is_causal=True), dev, reps=7, warm=2)
        bd = bound(4.0 * bb * hq * allowed * d,
                   4 * (qf.numel() * 2 + kf.numel() + vf.numel())
                   + 12 * pairs, PEAK_F32_ACCURATE_FLOPS)[0]
        key = f"B{bb}"
        out["f32_ms"][key], out["f32_bound_ms"][key] = t_ms, bd
        out["f32_plain_ms"][key], out["f32_library_ms"][key] = (plain_ms,
                                                                lib_ms)
        out["f32_vs_f64"][key], out["f32_library_vs_f64"][key] = rel, lib_rel
        print(f"flash: f32 instance (3xTF32 tensor cores) B={bb}: kernel "
              f"{t_ms:.3f} ms against its 3xTF32 bound {bd:.3f} ms "
              f"({bd / t_ms:.1%}; the CUDA-core kernel it replaced "
              f"{CUDA_CORE_F32_FLASH_MS.get(key, float('nan')):.3f} ms); "
              f"plain {plain_ms:.3f} ms; library (f32 "
              f"scaled_dot_product_attention, causal, kv heads expanded) "
              f"{lib_ms:.3f} ms; normwise from float64: kernel {rel:.3g}, "
              f"library {lib_rel:.3g}")
        del qf, kf, vf, ke, ve, got, lib
    del q, k, v
    info = _build.kernel_info("flash_mask", "flash_mask_f32_info", 128, 128,
                              64)
    out["f32_instance"] = (f"flash_mask_f32_tc_kernel<128, 64>: "
                           f"{info['registers']} registers, "
                           f"{info['local_bytes']} B local memory, "
                           f"{info['ctas_per_sm']} CTAs per SM")
    print(f"flash: f32 instance at the layer's shape within 2e-5 of plain "
          f"(max err {out['f32_max_abs_err']:.3g}); {out['f32_instance']}")
    return out


# ---------------------------------------------------------------------------
# Phase 10: LM serving at full width (llama3.2-1b, flash_pallas)
# ---------------------------------------------------------------------------


#: kernel-name groups of the prefill profile, first match wins
PROFILE_GROUPS = (("flash kernel", ("flash_mask",)),
                  ("GEMMs", ("nvjet", "gemm", "xmma", "cutlass")),
                  ("casts and copies", ("copy",)),
                  ("elementwise", ("elementwise", "vectorized")))


def prefill_breakdown(model, cfg, tokens, dev, top: int = 8) -> None:
    """Device time by kernel over one warm prefill (``torch.profiler``),
    and the device's idle share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        T.forward(model, cfg, {"tokens": tokens})
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    if not by_name:
        print("lm: profile: the profiler saw no device time (no CUPTI)")
        return
    print(f"lm: profile of one warm prefill: wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.1%}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in ranked[:top]:
        print(f"lm: profile: {ms:9.2f} ms {ms / busy_ms:6.1%} x{n:<5d} "
              f"{name[:90]}")
    groups: dict = {}
    for name, (ms, n) in by_name.items():
        group = next((g for g, keys in PROFILE_GROUPS
                      if any(key in name for key in keys)), "other")
        gms, gn = groups.get(group, (0.0, 0))
        groups[group] = (gms + ms, gn + n)
    print("lm: profile by group: " + "; ".join(
        f"{g} {ms:.2f} ms {ms / busy_ms:.1%} x{n}"
        for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))


def lm_serving(dev, batch: int = LM_BATCH, seq: int = LM_SEQ,
               smoke: bool = False) -> int:
    """Returns the flash kernel's launches in the main path's (bf16)
    prefill and the f32 instance's in the f32 prefill.  ``smoke`` takes
    the reduced config (for a rehearsal on the CPU)."""
    cfg = get_config("llama3_2_1b", smoke=smoke).replace(
        attn_impl="flash_pallas", dtype="bfloat16")
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    sync(dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"lm: {cfg.name} attn_impl={cfg.attn_impl} dtype={cfg.dtype}: "
          f"{n_params / 1e9:.3f} B parameters (f32, "
          f"{n_params * 4 / 1e9:.2f} GB) initialised on the card from seed 0 "
          f"in {time.perf_counter() - t0:.1f} s")
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))

    # the main path, once: prefill through the flash kernel
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    logits = T.forward(model, cfg, {"tokens": tokens})
    sync(dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = flash.LAUNCHES
    check(kernel.LAUNCHES == kernel.FUSED_LAUNCHES
          == kernel.MASKED_MATMUL_LAUNCHES == 0,
          "prefill launches no masked product")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    check(launches == flash.TC_LAUNCHES == cfg.n_layers
          and flash.F32_LAUNCHES == 0, f"the bf16 tensor-core flash kernel "
          f"launched once per layer ({cfg.n_layers}), got "
          f"{flash.TC_LAUNCHES} of {launches} launches, "
          f"{flash.F32_LAUNCHES} f32")
    check(logits.shape == (batch, seq, cfg.vocab_size)
          and logits.dtype == torch.bfloat16, "prefill logits shape, bf16")
    check(bool(torch.isfinite(logits).all()), "prefill logits are finite")
    warm_ms = host_ms(lambda: T.forward(model, cfg, {"tokens": tokens}), dev,
                      reps=3)
    prefill_breakdown(model, cfg, tokens, dev)

    # the same forward with dense attention: both keep scores and softmax
    # in f32 and round the attention output to bf16, so they differ where
    # a bf16 rounding flips, carried through 16 layers of a bf16 residual
    # stream; the bounds sit above that noise (what this script read is in
    # PERF.md, section 6)
    dense = T.forward(model, cfg.replace(attn_impl="dense_masked"),
                      {"tokens": tokens}).float()
    diff = (logits.float() - dense).abs()
    rel = float(diff.norm() / dense.norm())
    top = float(dense.abs().max())
    agree = float((logits.argmax(-1) == dense.argmax(-1)).float().mean())
    print(f"lm: prefill B={batch} S={seq} vs dense_masked: max |diff| "
          f"{float(diff.max()):.4g} (max |logit| {top:.4g}), normwise "
          f"{rel:.3g}, argmax agreement {agree:.4f}")
    check(rel <= 2e-2 and float(diff.max()) <= 5e-2 * top,
          "flash prefill within 2e-2 normwise and 5 % of max |logit| of "
          "dense_masked")
    del dense, diff, logits

    # the same comparison in f32 over the full 2,048 tokens, where the
    # flash kernel crosses 16 q-blocks: both sides differ only in
    # summation order (the CPU tests hold them within 1e-5 at the SMOKE
    # size), so a bf16-noise bound cannot hide a wrong attention here
    f32 = cfg.replace(dtype="float32")
    one = tokens[:1]
    reset_counts()
    got = T.forward(model, f32, {"tokens": one})
    sync(dev)
    f32_launches = flash.F32_LAUNCHES
    check(f32_launches == flash.TC_LAUNCHES == flash.LAUNCHES
          == cfg.n_layers, f"f32 prefill runs the tensor-core f32 flash "
          f"kernel once per layer (got {f32_launches} f32 of "
          f"{flash.LAUNCHES} launches)")
    dense = T.forward(model, f32.replace(attn_impl="dense_masked"),
                      {"tokens": one})
    diff = (got - dense).abs()
    rel32 = float(diff.norm() / dense.norm())
    print(f"lm: f32 prefill B=1 S={seq} vs dense_masked: max |diff| "
          f"{float(diff.max()):.3g} (max |logit| "
          f"{float(dense.abs().max()):.4g}), normwise {rel32:.3g}; "
          f"{f32_launches} launches of the f32 tensor-core flash kernel")
    check(rel32 <= 1e-4 and float(diff.max()) <= 1e-3,
          "f32 flash prefill within 1e-4 normwise and 1e-3 of dense_masked")
    del got, dense, diff
    tok_s = batch * seq / (warm_ms / 1e3)
    print(f"lm: prefill {batch}x{seq} bf16: first {first_ms:.1f} ms, warm "
          f"{warm_ms:.1f} ms ({tok_s:.0f} tokens/s); peak memory "
          f"{peak / 2**20:.0f} MiB; flash launches {launches}")

    # the reference's decode-consistency property, in f32; the steps run
    # unchecked and unsynchronised, and are compared after the clock stops
    short = tokens[:2, :128]
    want = T.forward(model, f32, {"tokens": short})
    cache = T.init_cache(f32, 2, 128, device=dev)
    steps = []
    sync(dev)
    t0 = time.perf_counter()
    for t in range(short.shape[1]):
        got, cache = T.decode_step(model, f32, short[:, t], cache,
                                   torch.full((2,), t, dtype=torch.int32,
                                              device=dev))
        steps.append(got)
    sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e3 / short.shape[1]
    err = float((torch.stack(steps, 1) - want).abs().max())
    check(err < 2e-2, f"f32 prefill matches teacher-forced decode within "
          f"2e-2 (max err {err:.3g})")
    print(f"lm: f32 decode consistency B={short.shape[0]} "
          f"S={short.shape[1]}: max |prefill - decode| "
          f"{err:.3g} (< 2e-2); {step_ms:.2f} ms per decode step")

    # generate: 32-token prompts, 16 new tokens
    prompt = tokens[:, :32]
    generate(model, cfg, prompt, max_new=2)           # warm-up
    sync(dev)
    t0 = time.perf_counter()
    out = generate(model, cfg, prompt, max_new=16)
    sync(dev)
    gen_s = time.perf_counter() - t0
    check(out.shape == (batch, 48) and torch.equal(out[:, :32],
                                                   prompt.to(torch.int32)),
          "generate keeps the prompt and adds 16 tokens")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generated tokens lie in the vocabulary")
    print(f"lm: generate B={batch} prompt 32 + 16 new: {gen_s * 1e3:.1f} ms "
          f"({batch * 16 / gen_s:.1f} new tokens/s, "
          f"{batch * 48 / gen_s:.1f} tokens/s with the teacher-forced "
          f"prompt)")
    return launches, f32_launches


def main() -> int:
    device = card()
    dev = torch.device("cuda", 0)
    build(dev)
    t_start = time.perf_counter()
    err = kernel_vs_plain(dev)
    mask_tiles, ops, entry = tile_route(dev)
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    row_route(dev)
    t_serving = time.perf_counter()
    serving = serving_path(dev, ops)
    entry["serving_launches"] = serving["tile"]["launches"]
    entry["serving"] = serving
    t_delta = time.perf_counter()
    delta = delta_path(dev, ops)
    entry["delta_launches"] = delta["tile"]["launches"]
    entry["delta"] = delta
    t_tuning = time.perf_counter()
    tuned = tuning_phase(dev, ops)
    entry["tuning_launches"] = tuned["launches"]
    entry["tuning"] = tuned
    t_health = time.perf_counter()
    healthy = health_phase(dev, ops)
    del ops
    entry["health_launches"] = healthy["launches"]
    entry["health"] = {k: healthy[k] for k in ("overhead", "pressure")}
    t_sddmm = time.perf_counter()
    err = sddmm_vs_plain(dev)
    sddmm = sddmm_path(dev, mask_tiles)
    sddmm["max_abs_err"] = max(sddmm["max_abs_err"], err)
    t_flash = time.perf_counter()
    err = flash_vs_plain(dev)
    flash_entry = flash_layer(dev)
    flash_entry["max_abs_err"] = max(flash_entry["max_abs_err"], err)
    t_lm = time.perf_counter()
    flash_entry["launches"], flash_entry["f32_launches"] = lm_serving(dev)
    t_end = time.perf_counter()
    print(f"phases: spgemm {t_serving - t_start:.1f} s, serving "
          f"{t_delta - t_serving:.1f} s, delta {t_tuning - t_delta:.1f} s, "
          f"tuning {t_health - t_tuning:.1f} s, "
          f"health {t_sddmm - t_health:.1f} s, "
          f"sddmm {t_flash - t_sddmm:.1f} s, "
          f"flash {t_lm - t_flash:.1f} s, lm {t_end - t_lm:.1f} s")
    print(json.dumps({"kernels": [entry, sddmm, flash_entry]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
