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
   (every ``block_spgemm`` instance, the Hopper one at bs 128 among them,
   the bf16 and f32 flash and SDDMM instances, Hopper and mma.sync);
3. kernel against plain: the ``block_spgemm`` kernel, values only and
   fused with the structural counts, against its plain PyTorch version at
   block sizes 4, 8, 32, 48 and 128 (every instance; bs 128 on the Hopper
   kernel, ``block_spgemm_sm90.cu``, and on the mma.sync one by
   ``variant="mma_sync"``, each launch counted in ``SM90_LAUNCHES`` or
   not), with zero-fill entries, an empty B and a worklist padded with
   all-flags-off entries; standard-normal data also within 2e-6 normwise
   of float64;
4. tile route: ``masked_spgemm(A, B, M)`` (algorithm "auto") on an
   n = 8192 block-sparse problem; the planner must elect the tile route
   at block size 128, the fused kernel must launch exactly once, on the
   Hopper kernel (``SM90_LAUNCHES``), and no plain version run, the values
   must equal the dense product at the mask and ``present`` the
   structural product; the call's peak device memory; both kernels bit for
   bit on the path's worklist; then the fused and the values-only replay
   timed on the Hopper and the mma.sync kernel in turns, and the steps of
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
8. tile SDDMM: the ``masked_matmul`` kernels against their plain version
   over the reference's test sweep (the ``mma.sync`` kernel's small
   blocks), at K = 384 and 128-blocks on both kernels (f32 within 1e-5 of
   float64, bf16 within 2e-2 of plain) and with out-of-range tiles (zeros
   from both); then ``ops.masked_matmul`` once at M = N = 8192, K = 256,
   128-blocks on the tile-8192 mask (one launch, on the Hopper kernel,
   ``masked_matmul_sm90.cu``, by ``MASKED_MATMUL_SM90_LAUNCHES``; equal to
   the plain version on integer data, f32 and bf16), the same call on
   standard-normal data (f32 accuracy: 2e-6 normwise of plain and of
   float64, 1e-5 of sum_k |a b| elementwise; bf16 2e-2 of plain); then the
   Hopper and the mma.sync kernels timed in turns (``kernel_ms``), f32
   and bf16, beside the plain version, the library call and the bounds;
9. flash attention: the ``flash_mask`` kernel against its plain version
   over the reference's test sweep (bf16 also within 2e-3 normwise; every
   case on tensor cores, the f32 ones on a 3xTF32 kernel: the f32 Hopper
   kernel at D 112 and 128, the mma.sync one at the sweep's small blocks),
   the decode offset and the GQA op; the Hopper bf16 kernel
   (``flash_mask_sm90``, ``SM90_LAUNCHES``) at the path's four shapes cut
   to S 512, a window with a prefix, q_offset > 0, bq 64, a never-visited
   q-block and out-of-range kv-blocks; then one full-width llama3.2-1b
   layer (B 4, 32/8 heads, S 2048, D 64, causal, bf16) on it; then its
   timings beside the mma.sync kernel's in the same run and
   ``scaled_dot_product_attention``; the f32 instance at the layer's shape
   on the f32 Hopper kernel (``flash_mask_f32_sm90``) against its plain
   version, the mma.sync f32 kernel and float64, and its times at B 1 (the
   f32 prefill's shape) and B 4 beside the mma.sync f32 kernel's in the
   same run and f32 ``scaled_dot_product_attention``;
10. LM serving: llama3.2-1b at full width with ``attn_impl="flash_pallas"``
   and random weights from seed 0: a bf16 prefill of 4 x 2,048 tokens (the
   bf16 flash kernel must launch once per layer, 16 times, each on the
   Hopper kernel by ``SM90_LAUNCHES``, as in phases 14 and 15; logits finite
   and close to the same forward with dense attention), a
   ``torch.profiler`` breakdown of one warm prefill by kernel with the
   device's idle share, an f32 prefill of 2,048 tokens (the f32 tensor-core
   flash kernel must launch once per layer, each on the f32 Hopper kernel
   by ``SM90_LAUNCHES``, as in phases 14 and 15) against dense attention, f32
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
13. distributed (runs after phase 12, on tile-8192's operands revalued to
   integers 1-4): the sparse ring (``core.distributed``) on
   ``make_mesh(p)`` at p = 2, 4 and 8 (one card: every shard on it),
   ``algorithm="ring"`` at block 128: bit for bit the single-device tile
   call and the dense product at the mask, the fused kernel launched p²
   times per call, each on the Hopper kernel (``SM90_LAUNCHES``), and no
   plain version; the first call (ring prep built)
   and the ring-prep hit's warm time (median of 5) and peak memory
   beside the single-device call's; shard 0's stage-0 kernel time (CUDA
   events) on the Hopper and the mma.sync kernel in turns, W and bound;
   the bytes a real ring would put on its links.
   Standard-normal values at p = 4 within 2e-6 normwise of float64. The
   row route at p = 4 on tc-rmat14's (L, L, L), bit for bit the
   single-device row kernel; ``algorithm="auto"`` at p = 4 on tc-rmat14
   and tile-8192 (elected route, the model ms of each candidate from
   ``explain``, both routes measured and bit for bit equal). The dense
   ``ring_masked_matmul`` at p = 4, (8192, 256) x (256, 8192) f32 on the
   tile-8192 mask, within 2e-6 normwise of masked ``torch.matmul`` and
   float64. ``QueryEngine.submit(mesh=make_mesh(4))``: a bucket of 4
   tile-8192 queries, one dist plan and one ring prep, 4 x 16 fused
   launches, each bit for bit its one-shot call. The dist probes (smoke
   grid) on the card and ``fit_dist`` on them (finite; printed, not
   registered: one card's rotations cross no link);
14. families (runs last, after phase 10, with every port cache cleared
   and the allocator's free blocks released; random f32 weights from seed
   0 on the card, cast at use, bf16 activations; each model freed before
   the next): ``block_masked`` attention at llama3.2-1b's layer (B 4,
   32/8 heads, S 2048, D 64, causal) within 1e-2 normwise of f32
   ``dense_masked`` and of the flash kernel, one worklist call and no
   fallback, its tiles (the flash worklist's) against the dense grid's,
   its time beside the flash op and causal SDPA; at starcoder2-7b's layer
   (B 1, 36/4, S 8192, D 128, window 4096) against flash.  llama3.2-1b's
   published config (``block_masked``) at full width, a bf16 prefill of
   4 x 2,048 tokens against phase 10's flash forward, timed beside it.
   deepseek-v2-lite-16b at full width and depth (27 layers, 62.8 GB of
   f32 weights; depth is cut only where the card's free memory, less
   8 GiB, cannot hold them): a bf16 ``block_masked`` prefill of 1 x 2,048
   (logits finite, (1, 2048, 102400)), tokens per expert, expert
   matmuls, ms, tokens/s, peak memory, a ``torch.profiler`` breakdown by
   group with the idle share, absorbed-MLA decode ms a step at B 1 and
   B 4, ``generate``; f32 decode consistency at 2 layers (2e-2); MLA
   under ``flash_pallas`` raises before any launch.  moonshot-v1-16b-a3b
   at full width, 24 of 48 layers (55.4 GB): the bf16 flash kernel once
   per layer at D 128 and no plain version, logits within 5e-2 normwise
   of ``block_masked`` with the same routing; in f32 (the f32 flash
   instance) within 1e-4, with the routings' differences counted; both
   impls' prefill ms, decode ms a step; the kernel at the layer's shape
   against its plain version, beside causal SDPA and its bound.
   internvl2-2b at full width (256 patches + 1,792 tokens): logits
   against ``dense_masked``, the prefix's rows within 5e-2 and ten times
   closer than a causal-only prefix (flash).  deepseek runs at full
   depth where 71.4 GB are free (its weights and 8 GiB of headroom);
15. families II (after phase 14, every port cache cleared; random f32
   weights from seed 0, bf16 activations, full width and full depth, each
   model freed before the next): zamba2-7b (81 Mamba2 blocks and one
   shared attention block applied 13 times, D 112), a prefill of
   1 x 2,048 under the published ``block_masked`` (13 worklist calls, no
   flash launch) and under ``flash_pallas`` (13 bf16 launches, no plain
   version): bf16 logits within 5e-2 normwise of ``block_masked``'s, or
   within 1.5 times the bf16 floor (``dense_masked`` against
   ``block_masked``) where that floor exceeds 5e-2, and the f32 prefill
   under the f32 instance within 1e-4 normwise and 1e-3; cold and warm
   ms, tokens/s, peak
   memory, a ``torch.profiler`` breakdown by group (projections, SSD
   intra-chunk, chunk states and recurrence, conv, attention, casts) with
   the idle share; decode ms a step at B 1 over 2,048 and 32,768 slots,
   ``generate`` 16 + 16, f32 decode against prefill over 64 tokens
   (2e-2); the kernel at the shared block's shape against its plain
   version, causal SDPA and its bound.  xlstm-1.3b (42 mLSTM and 6 sLSTM
   blocks): prefill, its kernels launched and idle share, decode,
   ``generate``, the f32 check.  seamless-m4t-large-v2 (24 + 24 layers):
   2,048 frames and 2,048 tokens under ``block_masked`` (24 causal
   worklist calls, 24 bidirectional encoder layers on the dense path) and
   ``flash_pallas`` (24 non-causal then 24 causal launches), held as
   zamba2's; the encoder computed once, decode with cross-attention over it,
   ``generate``; the non-causal kernel at the encoder's shape against
   non-causal SDPA and its bound.  Phase 9's sweep also holds D 112 and
   D 128, causal and non-causal, f32 and bf16, against the plain version;
16. training (after phase 15, every port cache cleared): llama-train,
   the published llama3.2-1b (bf16 activations, f32 masters, remat
   "full", block_masked, tied embeddings, 1,235,814,400 parameters) from
   seed 0 under ``AdamW(3e-4, warmup 2, 8 steps)`` on
   ``SyntheticLM(seq 2,048, batch 4, seed 0)``: a warm-up step, 4 timed
   steps each ended by a synchronise, one more under the profiler; step
   ms, tokens/s, the model-FLOP share of the bf16 peak (``mfu``, 6 N T a
   step), peak memory, busy ms, idle share, kernels a step, ``grad_norm``;
   every loss and gradient finite, the first loss within the reference's
   band (0.1, 3) x ln V, no flash or block_spgemm launch, block_masked
   twice a layer a step (forward and recompute).  f32 at full width and
   2 of 16 layers (1 x 256 tokens): gradients on the card against the
   CPU port's (1e-4 normwise, loss 1e-5), block_masked against
   dense_masked (1e-4), remat "full" and "dots" against "none" (1e-6),
   microbatches 2 against 1 (accumulated gradients 1e-5 normwise; loss
   and grad_norm 1e-5; after one AdamW step the reference's rtol 2e-4 /
   atol 2e-5 plus Adam's normalisation of each path's gradient).  One
   training step of each of the ten SMOKE configs: f32 gradients against
   the CPU port's (1e-4), then bf16 (``_bmm_f32``'s CUDA backward): loss
   within 5e-2 relative of f32, parameters finite.  flash_pallas under
   gradients raises with no launch.  Checkpoint and resume on the card:
   6 SMOKE steps with an async save every 2, a fresh state restored from
   step 4 runs steps 4-5 to the uninterrupted losses (1e-6 relative);
17. lint (after phase 16, on the host): the port's invariant linter,
   ``python -m repro_torch.lint --format=json --baseline none`` over
   ``src/repro_torch`` in a child process; it must exit 0 with no
   finding at all.  It launches nothing on the card; its counts and
   seconds are printed;
18. one JSON line with every kernel's numbers, then the result line
   ``{"ok": true, "device": {...}}``.

Wherever phases 4, 6, 7, 11, 12 and 13 drive the path, every block
product at bs 128 must have run the Hopper kernel and every other one the
mma.sync kernel, and ``SM90_LAUNCHES`` must count the former
(``launch_shapes``).

Any failure raises, and the script exits non-zero without the result line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
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
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    distributed_masked_spgemm, make_mesh, ring_masked_matmul)
from repro_torch.core import formats as F  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.masked_spgemm import (  # noqa: E402
    gather_mask_aligned, masked_spgemm)
from repro_torch.graphs import betweenness_centrality, ktruss  # noqa: E402
from repro_torch.graphs.triangle_counting import (  # noqa: E402
    degree_relabel, triangle_count)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_mask import kernel as flash  # noqa: E402
from repro_torch.kernels.flash_mask import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_mask.ops import (  # noqa: E402
    flash_mask_attention)
from repro_torch.kernels.flash_mask.ref import mask_allowed  # noqa: E402
from repro_torch.kernels.masked_matmul import kernel, ops  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as SSD  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.decode import generate  # noqa: E402
from repro_torch.core.semiring import PLUS_TIMES  # noqa: E402
from repro_torch.serving import QueryEngine, burst  # noqa: E402
from repro_torch.serving import trace as serve_trace  # noqa: E402
from repro_torch.tuning import autotune, fit, probes  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, batch_for  # noqa: E402
from repro_torch.launch.specs import concrete_batch  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    init_state, make_train_step)

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
    kernel.SM90_LAUNCHES = 0
    kernel.MASKED_MATMUL_LAUNCHES = 0
    kernel.MASKED_MATMUL_SM90_LAUNCHES = 0
    flash.LAUNCHES = 0
    flash.TC_LAUNCHES = 0
    flash.F32_LAUNCHES = 0
    flash.SM90_LAUNCHES = 0


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


def chained_ms(fn, dev, calls: int = 10, reps: int = 5,
               warm: int = 2) -> float:
    """Median over ``reps`` of the ms per call of ``calls`` back-to-back
    calls of ``fn()`` between two CUDA events (the host clock elsewhere):
    the device time of a kernel whose wrapper's host work would otherwise
    open a gap inside a single call's events (60-100 us on the card's
    hosts, PERF.md)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(times)


#: device clock cycles of the sleep that ``kernel_ms`` queues ahead of the
#: calls it times (about 20 ms at the H100's 1.98 GHz)
SLEEP_CYCLES = 40_000_000


def kernel_ms(fn, dev, calls: int = 10, warm: int = 2) -> float:
    """Device milliseconds per call of ``fn()``: ``calls`` calls queued
    behind a device-side sleep, so that the CUDA events around them time
    their kernels back to back, without the wrappers' host work (which a
    single call's events hold, and which at a 0.04 ms kernel back-to-back
    calls do not hide); checked that the host queued every call before
    the sleep ended.  The host clock of a call elsewhere."""
    if dev.type != "cuda":
        return device_ms(fn, dev, reps=calls, warm=warm)
    for _ in range(warm):
        fn()
    sync(dev)
    slept, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    t0 = time.perf_counter()
    slept.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    sleep_ms = slept.elapsed_time(start)
    check(host_ms < sleep_ms, f"the host queued {calls} calls in "
          f"{host_ms:.2f} ms, within the device's {sleep_ms:.2f} ms sleep")
    return start.elapsed_time(end) / calls


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
            print(f"build: block_spgemm bs {bs} "
                  f"({block_instance(bs, 'mma_sync')}): "
                  f"{info['threads']} threads, {info['smem_bytes']} B dynamic "
                  f"shared memory, {info['registers']} registers and "
                  f"{info['local_bytes']} B local memory per thread, "
                  f"{info['ctas_per_sm']} CTAs per SM")
        info = _build.kernel_info("block_spgemm_sm90",
                                  "block_spgemm_sm90_info")
        print(f"build: block_spgemm bs 128 ({SM90_INSTANCE}): "
              f"{info['threads']} threads, {info['smem_bytes']} B dynamic "
              f"shared memory, {info['registers']} registers at launch and "
              f"{info['local_bytes']} B local memory per thread, "
              f"{info['ctas_per_sm']} CTAs per SM")
        for what, info in (
                ("flash_mask_sm90 (wgmma + TMA) bf16 128/128, D 64",
                 _build.kernel_info("flash_mask_sm90",
                                    "flash_mask_sm90_info", 128, 128, 64)),
                ("flash_mask_sm90 (wgmma + TMA) bf16 128/128, D 112 and 128",
                 _build.kernel_info("flash_mask_sm90",
                                    "flash_mask_sm90_info", 128, 128, 128)),
                ("flash_mask mma.sync bf16 128/128, D 64",
                 _build.kernel_info("flash_mask", "flash_mask_tc_info", 128,
                                    128, 64)),
                ("flash_mask mma.sync bf16 128/128, D 112 and 128 (the D 128 "
                 "tile)",
                 _build.kernel_info("flash_mask", "flash_mask_tc_info", 128,
                                    128, 112)),
                ("flash_mask_f32_sm90 (tf32 wgmma + TMA) f32 128/128, D 64",
                 _build.kernel_info("flash_mask_f32_sm90",
                                    "flash_mask_f32_sm90_info", 128, 128,
                                    64)),
                ("flash_mask_f32_sm90 (tf32 wgmma + TMA) f32 64/64, D 64",
                 _build.kernel_info("flash_mask_f32_sm90",
                                    "flash_mask_f32_sm90_info", 64, 64, 64)),
                ("flash_mask_f32_sm90 (tf32 wgmma + TMA) f32, D 112 and 128",
                 _build.kernel_info("flash_mask_f32_sm90",
                                    "flash_mask_f32_sm90_info", 128, 128,
                                    128)),
                ("flash_mask f32 (3xTF32) 128/128, D 64",
                 _build.kernel_info("flash_mask", "flash_mask_f32_info", 128,
                                    128, 64)),
                ("masked_matmul_sm90 (wgmma + TMA) f32 128x128",
                 _build.kernel_info("masked_matmul_sm90",
                                    "masked_matmul_sm90_info", 0)),
                ("masked_matmul_sm90 (wgmma + TMA) bf16 128x128",
                 _build.kernel_info("masked_matmul_sm90",
                                    "masked_matmul_sm90_info", 1)),
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


#: the Hopper kernel (csrc/block_spgemm_sm90.cu), which bs 128 runs
SM90_INSTANCE = "block_spgemm_sm90_kernel (wgmma + TMA)"


def block_instance(bs: int, variant: str = None) -> str:
    """The block_spgemm kernel instance that block size ``bs`` runs (by
    default, or under ``variant``)."""
    if bs == kernel.SM90_BLOCK and variant != "mma_sync":
        return SM90_INSTANCE
    t, wm, wn = next(c for c in ((16, 1, 1), (32, 2, 1), (64, 2, 2),
                                 (128, 2, 4)) if bs <= c[0] or c[0] == 128)
    return f"block_spgemm_tc_kernel<{t}, {wm}, {wn}> (mma.sync)"


class launch_shapes:
    """Within the block, record the block size and the kernel chosen of
    every block_spgemm launch (the wrappers look ``choose_variant`` up at
    call time); ``check(what)`` then holds every bs-128 launch to the
    Hopper kernel and ``kernel.SM90_LAUNCHES`` to their number (the counts
    reset with the block)."""

    def __enter__(self):
        self.calls = []
        self.saved = kernel.choose_variant

        def recorded(variant, a_blocks, *rest):
            chosen = self.saved(variant, a_blocks, *rest)
            self.calls.append((int(a_blocks.shape[1]), chosen))
            return chosen

        kernel.choose_variant = recorded
        return self

    def __exit__(self, *exc):
        kernel.choose_variant = self.saved

    def at_128(self) -> int:
        return sum(bs == kernel.SM90_BLOCK for bs, _ in self.calls)

    def check(self, what: str) -> int:
        """Checks and returns the bs-128 launches (all on the Hopper
        kernel, each counted once in ``SM90_LAUNCHES``)."""
        n = self.at_128()
        check(all(c == "sm90" for bs, c in self.calls
                  if bs == kernel.SM90_BLOCK)
              and all(c == "mma_sync" for bs, c in self.calls
                      if bs != kernel.SM90_BLOCK),
              f"{what}: every bs-128 block product ran the Hopper kernel and "
              f"every other one mma.sync (got {self.calls[:8]}...)")
        check(kernel.SM90_LAUNCHES == n, f"{what}: SM90_LAUNCHES equals the "
              f"{n} bs-128 launches (got {kernel.SM90_LAUNCHES})")
        return n


def block_f64(a_blocks, b_blocks, wl, nnzb_out) -> torch.Tensor:
    """The worklist replay in float64: the exact value to f32 accuracy."""
    rank, pa, pb, flags = (x.long() for x in wl)
    real = ((flags >> 1) & 1).double()
    out = torch.zeros((nnzb_out,) + tuple(a_blocks.shape[1:]),
                      dtype=torch.float64, device=a_blocks.device)
    prods = torch.bmm(a_blocks.double()[pa], b_blocks.double()[pb])
    return out.index_add_(0, rank, prods * real[:, None, None])


def compare(a_blocks, b_blocks, wl, nnzb_out, exact: bool,
            variant: str = None) -> float:
    """Kernel (``variant``, default: the one the wrapper picks) against
    plain on the same tensors, values only and fused with the counts over
    the operands' 0/1 patterns: returns max |diff|.  On float data the
    values are also held to 2e-6 normwise of float64.  Checks that both
    launches ran the kernel asked for, by ``SM90_LAUNCHES``."""
    a_pat, b_pat = ((x != 0).float() for x in (a_blocks, b_blocks))
    sm90 = kernel.choose_variant(variant, a_blocks, b_blocks) == "sm90"
    before = kernel.SM90_LAUNCHES
    got = kernel.block_spgemm_kernel(a_blocks, b_blocks, *wl, nnzb_out,
                                     variant=variant)
    vals, counts = kernel.block_spgemm_with_structure_kernel(
        a_blocks, b_blocks, a_pat, b_pat, *wl, nnzb_out, variant=variant)
    check(kernel.SM90_LAUNCHES == before + 2 * (sm90 and nnzb_out > 0),
          f"SM90_LAUNCHES counted the {variant or 'default'} kernel's "
          f"launches")
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
        # bs 128: the Hopper kernel (the default) and the mma.sync one
        variants = ((None, "mma_sync") if bs == kernel.SM90_BLOCK
                    else (None,))
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
                for variant in variants:
                    err = max(err, compare(A.blocks, B.blocks,
                                           worklist(sched, dev, pad), M.nnzb,
                                           exact=ints, variant=variant))
        # an empty B: only zero-fill entries, over one zero block
        Bz = F.bcsr_from_dense(np.zeros((n, n), np.float32), bs, device=dev)
        sched = ops.build_spgemm_schedule(A, Bz, M)
        check(not (sched[3] & 2).any(), "empty B gives zero-fill only")
        zero = torch.zeros((1, bs, bs), device=dev)
        for variant in variants:
            err = max(err, compare(A.blocks, zero, worklist(sched, dev),
                                   M.nnzb, exact=True, variant=variant))
        print(f"kernel-vs-plain: bs={bs} ("
              + " and ".join(block_instance(bs, v) for v in variants)
              + f") n={n} W={len(sched[0])}.. ok")
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
    """Within the block, count the calls of a kernel's plain versions (the
    wrapper's module looks them up at call time): by default the block
    product's, in ``kernel.py``."""

    NAMES = ("block_spgemm_plain", "block_spgemm_with_structure_plain")

    def __init__(self, module=kernel, names=NAMES):
        self.module, self.names = module, names

    def __enter__(self):
        self.calls = 0
        self.saved = {name: getattr(self.module, name) for name in self.names}

        def counted(fn):
            def call(*args, **kw):
                self.calls += 1
                return fn(*args, **kw)
            return call

        for name, fn in self.saved.items():
            setattr(self.module, name, counted(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


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
    with count_plain() as plain, launch_shapes() as shapes:
        res = masked_spgemm(A, B, M, device=dev)
        sync(dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = kernel.FUSED_LAUNCHES
    sm90_launches = shapes.check("tile route")
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
    check(sm90_launches == 1, "the fused launch ran the Hopper kernel")

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
    err = max(compare(Ab.blocks, Bb.blocks, wl, Mb.nnzb, exact=True,
                      variant=v) for v in kernel.VARIANTS)
    same = [kernel.block_spgemm_with_structure_kernel(
        Ab.blocks, Bb.blocks, a_pat, b_pat, *wl, Mb.nnzb, variant=v)
        for v in kernel.VARIANTS]
    check(all(torch.equal(x, y) for x, y in zip(*same)), "the Hopper and "
          "mma.sync kernels agree bit for bit at tile-8192 (integer data)")
    del same

    def run_fused(variant="sm90"):
        return kernel.block_spgemm_with_structure_kernel(
            Ab.blocks, Bb.blocks, a_pat, b_pat, *wl, Mb.nnzb,
            variant=variant)

    def run_values(variant="sm90"):
        return kernel.block_spgemm_kernel(Ab.blocks, Bb.blocks, *wl,
                                          Mb.nnzb, variant=variant)

    def run_plain():
        return kernel.block_spgemm_with_structure_plain(
            Ab.blocks, Bb.blocks, a_pat, b_pat, *wl, Mb.nnzb)

    # both kernels in turns (sm90, mma.sync, mma.sync, sm90): a call's
    # device time (the kernel and the wrapper's segment offsets), and one
    # call's CUDA events, its host work included; medians of the turns
    turns = {(r, v): [] for r in ("fused", "values", "fused call")
             for v in kernel.VARIANTS}
    for order in (kernel.VARIANTS, kernel.VARIANTS[::-1]):
        for v in order:
            turns[("fused", v)].append(kernel_ms(lambda: run_fused(v), dev))
            turns[("values", v)].append(kernel_ms(lambda: run_values(v),
                                                  dev))
            turns[("fused call", v)].append(device_ms(
                lambda: run_fused(v), dev, reps=5, warm=1))
    tmed = {k: statistics.median(x) for k, x in turns.items()}
    fused_ms, values_ms = tmed[("fused", "sm90")], tmed[("values", "sm90")]
    fused_mma_ms = tmed[("fused", "mma_sync")]
    values_mma_ms = tmed[("values", "mma_sync")]
    call_ms = {v: tmed[("fused call", v)] for v in kernel.VARIANTS}
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
    print(f"tile [{CARD}]: fused kernel (Hopper, wgmma + TMA) "
          f"{fused_ms:.4f} ms per tile call (values and counts; the "
          f"mma.sync kernel in the same run {fused_mma_ms:.4f} ms, "
          f"{fused_mma_ms / fused_ms:.2f}x; the CUDA-core kernel before "
          f"them: 2 x {CUDA_CORE_BLOCK_SPGEMM_MS:.3f} ms); bound "
          f"{bound_ms:.4f} ms (by {by}: three TF32 passes at "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s plus one bf16 pass at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f}); at {bound_ms / fused_ms:.1%} of "
          f"it (mma.sync {bound_ms / fused_mma_ms:.1%}); plain "
          f"{plain_ms:.3f} ms; one call's events, wrapper included: "
          f"{call_ms['sm90']:.4f} / {call_ms['mma_sync']:.4f} ms; turns "
          f"(ms) " + json.dumps({f"{r} {v}": x
                                 for (r, v), x in turns.items()}))
    print(f"tile [{CARD}]: values-only replay {values_ms:.4f} ms "
          f"({flops / values_ms / 1e9:.1f} TF32-accurate TFLOP/s; mma.sync "
          f"{values_mma_ms:.4f} ms); bound {values_bound:.4f} ms "
          f"(by {values_by}); at {values_bound / values_ms:.1%} of it "
          f"(mma.sync {values_bound / values_mma_ms:.1%}); the counting "
          f"CTAs add {fused_ms - values_ms:.4f} ms")
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
                  "block_spgemm_sm90.cu",
        "mma_sync_source": "src/repro_torch/kernels/masked_matmul/csrc/"
                           "block_spgemm.cu",
        "replaces": "src/repro/kernels/masked_matmul/kernel.py:105",
        "launches": launches, "sm90_launches": sm90_launches,
        "max_abs_err": err, "ms": fused_ms, "mma_sync_ms": fused_mma_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
        "library_ms": None,
        "instance": block_instance(bs) + ", fused values and counts",
        "call_ms": call_ms["sm90"], "call_mma_sync_ms": call_ms["mma_sync"],
        "values_ms": values_ms, "values_mma_sync_ms": values_mma_ms,
        "values_bound_ms": values_bound,
        "tile_call_ms": e2e_ms, "tile_peak_mib": peak / 2**20,
        "tile_steps_ms": steps, "card": CARD,
        "design": "Hopper, bs 128: the output tile computed transposed "
                  "(C^T = B^T A^T) on wgmma; values 3xTF32 with B^T split "
                  "in registers (m64n128k8 RS, 64 columns per consumer "
                  "warpgroup) against A's hi and lo in shared memory "
                  "(split once per tile by the producer warpgroup's idle "
                  "warps), a truncating partial sum per 32-deep stage "
                  "added to the f32 accumulator with IEEE rounding; counts "
                  "one bf16 m64n128k16 pass, B's pattern read transposed; "
                  "TMA loads in the 128-byte swizzle into a 4-stage ring "
                  "behind full, ready and empty mbarriers, one producer "
                  "thread; both CTA kinds in one grid, one CTA an SM. "
                  "Other block sizes: mma.sync 3xTF32 in a 3-stage "
                  "cp.async ring (block_spgemm.cu)"}


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
    with count_plain() as plain, launch_shapes() as shapes:
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
    check(shapes.check("tile bucket") == queries, "each tile query ran the "
          "Hopper kernel")
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
    with count_plain() as plain, launch_shapes() as shapes:
        got = eng.serve([(a, B, M) for a in As])
        sync(dev)
    launches = kernel.FUSED_LAUNCHES
    check(launches == queries and kernel.LAUNCHES == 0,
          f"the post-delta bucket launches the fused kernel {queries} times "
          f"(got {launches}, values only {kernel.LAUNCHES})")
    check(shapes.check("delta-tile") == queries, "each post-delta query "
          "ran the Hopper kernel")
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
        with count_plain() as plain, launch_shapes() as shapes:
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
        # the smoke grid's calls at bs 128 (as probes.tile_calls counts)
        at_128 = sum((len(tds) * len(mos) + 1) * (probes.WARMUP + it)
                     for _, bss, tds, mos, it in probes.TILE_GRID_SMOKE
                     for b in bss if b == kernel.SM90_BLOCK)
        check(shapes.check("tuning probes") == at_128, f"the tile probes' "
              f"bs-128 calls ({at_128}) ran the Hopper kernel")
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
            with count_plain() as plain, launch_shapes() as shapes:
                eng.serve([(revalue(A, 0, ints=True), B, M)])
            launches = kernel.FUSED_LAUNCHES
            check(launches == 1 and kernel.LAUNCHES == 0 and plain.calls == 0,
                  f"the tile query launched the fused kernel once and no "
                  f"plain version ran (got {launches}, {kernel.LAUNCHES}, "
                  f"{plain.calls})")
            check(shapes.check("health pressure") == 1, "the tile query ran "
                  "the Hopper kernel")
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
            with count_plain() as plain, obs.tracing(mon), \
                    launch_shapes() as shapes:
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
            sm90_n = shapes.check(f"drift under {label}")
            check(sm90_n == queries * (planner.plan(A, B, M, device=dev)
                                       .tile_block == kernel.SM90_BLOCK),
                  f"{label}: the tile queries at bs 128 ran the Hopper "
                  f"kernel (got {sm90_n})")
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
                           "launches": kernel.FUSED_LAUNCHES,
                           "sm90_launches": sm90_n}
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
# Phase 13: the distributed routes (core.distributed) on the card
# ---------------------------------------------------------------------------

#: ring sizes of the phase; p = DIST_P for the other checks
DIST_MESH_SIZES = (2, 4, 8)
DIST_P = 4
#: warm ring calls timed (median kept), each ended by a synchronise
DIST_REPS = 5
#: the dense ring's K: (n, K) x (K, n) on the tile-8192 mask
DIST_DENSE_K = 256
#: a distributed row route whose first call takes longer than this many
#: seconds is not timed again
DIST_ROW_REPEAT_S = 5.0


def mesh_on(dev, p: int):
    """``make_mesh(p)`` on the card (the shards cycle over the visible
    cards; with one card all share it), every shard on ``dev`` elsewhere."""
    return make_mesh(p) if dev.type == "cuda" else make_mesh(p, device=dev)


def masked_entries(res, M, dev):
    """(row, column, slot) of every mask entry, as device index tensors."""
    mr = F._expand_rows(M.indptr)
    slots = np.arange(M.nnz) - M.indptr[mr]
    return torch.as_tensor(np.stack([mr, M.indices, slots]), device=dev)


def dense_on(x, dev, dtype=torch.float32) -> torch.Tensor:
    """A host CSR as a dense tensor on ``dev`` (scattered there)."""
    d = torch.zeros(x.shape, dtype=dtype, device=dev)
    rows = torch.as_tensor(F._expand_rows(x.indptr), device=dev)
    d[rows, torch.as_tensor(x.indices.astype(np.int64), device=dev)] = \
        torch.as_tensor(x.data, device=dev).to(dtype)
    return d


def ring_stage(st, A, B, bs: int, dev):
    """Shard 0's stage-0 operands of a cached ring state: its A panel and
    B slab (values and patterns) and its stage-0 worklist."""
    sh = st.shards[0]
    a = dist._panel_values(F._to_device(A.data[sh.a_rows[0]:sh.a_rows[1]],
                                        dev), sh.a_flat, st.wa, bs)
    b = dist._panel_values(F._to_device(B.data[sh.b_rows[0]:sh.b_rows[1]],
                                        dev), sh.b_flat, st.wb, bs)
    return a, b, sh.a_pat, sh.b_pat, sh.sched[0]


def ring_sizes(dev, ops, single, bs: int = TILE_BS) -> dict:
    """The sparse ring at every p of ``DIST_MESH_SIZES`` on tile-8192's
    integer operands: bit for bit the single-device tile call and the
    dense product at the mask, p² fused launches per call and no plain
    version; first and warm times and peak memory beside the single
    device's; shard 0's stage-0 kernel time, W and bound; link bytes."""
    A, B, M = ops
    out = {}
    for p in DIST_MESH_SIZES:
        mesh = mesh_on(dev, p)
        dist.clear_ring_prep_cache()
        gc_collect(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        with count_plain() as plain, launch_shapes() as shapes:
            t0 = time.perf_counter()
            res = distributed_masked_spgemm(A, B, M, mesh, algorithm="ring",
                                            block_size=bs)
            sync(dev)
            first_ms = (time.perf_counter() - t0) * 1e3
        launches = kernel.FUSED_LAUNCHES
        check(shapes.check(f"ring p={p}") == p * p, f"ring p={p}: SM90_"
              f"LAUNCHES == p² (every stage on the Hopper kernel)")
        peak_first = (torch.cuda.max_memory_allocated(dev)
                      if dev.type == "cuda" else 0)
        check(launches == p * p and kernel.LAUNCHES == 0,
              f"ring p={p}: {p * p} fused launches and no values-only one "
              f"(got {launches}, {kernel.LAUNCHES})")
        check(plain.calls == 0, f"ring p={p}: no plain version ran (got "
              f"{plain.calls})")
        check(same_result(res, single["res"]), f"ring p={p} equals the "
              f"single-device tile call bit for bit")
        check(res.vals.device == torch.device(mesh.devices[0]),
              f"ring p={p}: the result lies on mesh.devices[0]")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        times = []
        with launch_shapes() as shapes:
            for _ in range(DIST_REPS):
                t0 = time.perf_counter()
                res = distributed_masked_spgemm(A, B, M, mesh,
                                                algorithm="ring",
                                                block_size=bs)
                sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
        check(shapes.check(f"ring p={p} warm") == DIST_REPS * p * p,
              f"ring p={p}: p² Hopper launches per warm call")
        warm_ms = statistics.median(times)
        peak_warm = (torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else 0)
        check(kernel.FUSED_LAUNCHES == DIST_REPS * p * p,
              f"ring p={p}: {p * p} fused launches per warm call")
        check(same_result(res, single["res"]), f"ring p={p}: a warm call "
              f"(ring-prep hit) equals the single-device call bit for bit")
        info = dist.ring_prep_cache_info()
        check(info["misses"] == 1 and info["hits"] == DIST_REPS,
              f"ring p={p}: one prep, then {DIST_REPS} hits (got {info})")

        # shard 0's stage-0 replay: the per-stage kernel time and its bound
        st = dist._ring_state(A, B, M, bs, mesh, "data", None)
        link, prep_bytes = st.link_bytes(), st.nbytes()
        a, b, a_pat, b_pat, wl = ring_stage(st, A, B, bs, dev)
        W = int(wl.shape[1])
        wl_host = wl.cpu().numpy()
        on = ((wl_host[3] >> 1) & 1).astype(bool)
        real = int(on.sum())
        # the A and B blocks the stage's real products read (values and
        # patterns), not the whole panel and slab
        read_blocks = (len(np.unique(wl_host[1][on]))
                       + len(np.unique(wl_host[2][on])))

        def stage(variant="sm90"):
            return kernel.block_spgemm_with_structure_kernel(
                a, b, a_pat, b_pat, wl[0], wl[1], wl[2], wl[3],
                st.wm_blocks, variant=variant)

        def stage_plain():
            return kernel.block_spgemm_with_structure_plain(
                a, b, a_pat, b_pat, wl[0], wl[1], wl[2], wl[3],
                st.wm_blocks)

        # both kernels in turns (sm90, mma.sync, mma.sync, sm90), a call's
        # device time; and one call's CUDA events
        turns = {v: [] for v in kernel.VARIANTS}
        for order in (kernel.VARIANTS, kernel.VARIANTS[::-1]):
            for v in order:
                turns[v].append(kernel_ms(lambda: stage(v), dev))
        stage_ms = statistics.median(turns["sm90"])
        stage_mma_ms = statistics.median(turns["mma_sync"])
        stage_call_ms = device_ms(stage, dev, reps=7, warm=2)
        stage_plain_ms = device_ms(stage_plain, dev, reps=3, warm=1)
        pv, pc = stage_plain()
        for v in kernel.VARIANTS:
            sv, sc = stage(v)
            err = float((sv - pv).abs().max())
            check(torch.equal(sc, pc) and err == 0.0, f"ring p={p}: the "
                  f"stage replay ({v}) equals its plain version (integer "
                  f"data)")
        flops = 2.0 * real * bs ** 3
        out_bytes = st.wm_blocks * bs * bs * 4
        t_ops = flops / PEAK_F32_ACCURATE_FLOPS + flops / PEAK_BF16_FLOPS
        t_bytes = (read_blocks * bs * bs * (4 + 2) + 2 * out_bytes
                   + 16 * W) / PEAK_BYTES_PER_S
        stage_bound = max(t_ops, t_bytes) * 1e3
        stage_by = "operations" if t_ops >= t_bytes else "bytes"
        slab = st.wb * bs * bs * 6
        print(f"dist [{CARD}]: ring p={p}: first {first_ms:.1f} ms (prep "
              f"built), warm {warm_ms:.2f} ms (median of {DIST_REPS}, "
              f"ring-prep hit) against the single-device tile call "
              f"{single['warm_ms']:.2f} ms; peak memory first "
              f"{peak_first / 2**20:.1f} MiB, warm {peak_warm / 2**20:.1f} "
              f"MiB (single {single['peak_mib']:.1f} MiB); {p * p} fused "
              f"launches per call, no plain version; bit for bit the single "
              f"device and the dense product; the cached prep holds "
              f"{prep_bytes / 2**20:.1f} MiB on the card")
        print(f"dist [{CARD}]: ring p={p}: shard 0 stage 0: W={W} (real "
              f"{real}), {st.wm_blocks} output blocks, kernel (Hopper) "
              f"{stage_ms:.4f} ms, mma.sync in the same run "
              f"{stage_mma_ms:.4f} ms ({stage_mma_ms / stage_ms:.2f}x; turns "
              f"{json.dumps(turns)}; one call's events, wrapper included, "
              f"{stage_call_ms:.4f}), plain {stage_plain_ms:.3f} ms, bound "
              f"{stage_bound:.4f} ms (by {stage_by}); slab "
              f"{slab / 2**20:.1f} MiB (wb {st.wb}); a "
              f"real ring would move {link / p / 2**20:.1f} MiB per link "
              f"per call ({link / 2**20:.1f} MiB over {p} links; one card: "
              f"no copy made)")
        out[p] = {"first_ms": first_ms, "warm_ms": warm_ms,
                  "warm_runs_ms": times, "peak_first_mib": peak_first / 2**20,
                  "peak_warm_mib": peak_warm / 2**20, "launches": launches,
                  "stage_ms": stage_ms, "stage_mma_sync_ms": stage_mma_ms,
                  "stage_call_ms": stage_call_ms,
                  "stage_plain_ms": stage_plain_ms,
                  "stage_bound_ms": stage_bound, "stage_bound_by": stage_by,
                  "W": W, "real": real, "read_blocks": read_blocks,
                  "wm_blocks": st.wm_blocks, "link_bytes": link,
                  "slab_bytes": slab, "prep_bytes": prep_bytes}
        del res, st, a, b, a_pat, b_pat, wl, sv, sc, pv, pc
    dist.clear_ring_prep_cache()
    return out


def ring_normal(dev, ops, single, bs: int = TILE_BS) -> dict:
    """The same structure on standard-normal values at p = DIST_P: within
    2e-6 normwise of float64 and 1e-4 of the single-device call."""
    A, B, M = ops
    rng = np.random.default_rng(21)
    An = F.CSR(A.indptr, A.indices,
               rng.standard_normal(A.nnz).astype(np.float32), A.shape)
    Bn = F.CSR(B.indptr, B.indices,
               rng.standard_normal(B.nnz).astype(np.float32), B.shape)
    mesh = mesh_on(dev, DIST_P)
    reset_counts()
    with launch_shapes() as shapes:
        res = distributed_masked_spgemm(An, Bn, M, mesh, algorithm="ring",
                                        block_size=bs)
        sync(dev)
    check(kernel.FUSED_LAUNCHES == DIST_P ** 2, "normal data: p² fused "
          "launches")
    check(shapes.check("ring, normal data") == DIST_P ** 2, "normal data: "
          "p² Hopper launches")
    one = masked_spgemm(An, Bn, M, algorithm="tile", tile_block=bs,
                        device=dev)
    idx = masked_entries(res, M, dev)
    C = dense_on(An, dev, torch.float64) @ dense_on(Bn, dev, torch.float64)
    want = C[idx[0], idx[1]]
    got = res.vals[idx[0], idx[2]].double()
    err = float((got - want).norm() / want.norm())
    check(err <= 2e-6, f"normal data: the ring within 2e-6 normwise of "
          f"float64 (got {err:.3g})")
    one_err = float((res.vals - one.vals).abs().max())
    check(torch.allclose(res.vals, one.vals, rtol=1e-4, atol=1e-4)
          and torch.equal(res.present, one.present),
          "normal data: the ring within 1e-4 of the single-device call")
    print(f"dist [{CARD}]: normal data p={DIST_P}: {err:.3g} normwise from "
          f"float64 (limit 2e-6); max |ring - single device| {one_err:.3g}")
    del C, want, got, res, one
    dist.clear_ring_prep_cache()
    return {"normwise_f64": err, "max_abs_vs_single": one_err}


def timed_route(call, dev) -> tuple:
    """(first ms, warm ms or None, result): the warm time is the median of
    3 calls, taken when the first took under ``DIST_ROW_REPEAT_S``."""
    t0 = time.perf_counter()
    res = call()
    sync(dev)
    first = (time.perf_counter() - t0) * 1e3
    if first > DIST_ROW_REPEAT_S * 1e3:
        return first, None, res
    return first, host_ms(call, dev, reps=3), res


def row_and_auto(dev, ops, scale: int = RMAT_SCALE) -> dict:
    """The row route at p = DIST_P on tc-rmat14's (L, L, L), bit for bit
    the single-device row kernel; then ``algorithm="auto"`` at p = DIST_P
    on tc-rmat14 and tile-8192: the elected route, every candidate's model
    ms from ``explain``, and both routes measured (ring and row agree bit
    for bit)."""
    g = F.rmat(scale, RMAT_EDGE_FACTOR, seed=scale)
    L = F.tril(degree_relabel(g), strict=True)
    mesh = mesh_on(dev, DIST_P)
    cells = {f"tc-rmat{scale}": (L, L, L), f"tile-{ops[2].shape[0]}": ops}
    planner.clear_plan_cache()
    alg = planner.decide(planner.collect_stats(L, L, L),
                         allow_tile=False).algorithm
    reset_counts()
    first, warm, res = timed_route(lambda: distributed_masked_spgemm(
        L, L, L, mesh, algorithm="row"), dev)
    check(kernel.FUSED_LAUNCHES == kernel.LAUNCHES == 0,
          "the row route launches no block kernel")
    one = masked_spgemm(L, L, L, algorithm=alg, device=dev)
    check(same_result(res, one), f"row p={DIST_P} on tc-rmat14 equals the "
          f"single-device {alg} call bit for bit")
    warm_s = f"{warm:.1f} ms" if warm is not None else "not timed"
    print(f"dist [{CARD}]: row p={DIST_P} tc-rmat{scale} ({alg}): first "
          f"{first:.1f} ms, warm {warm_s}; bit for bit the single device")
    out = {"row_tc": {"algorithm": alg, "first_ms": first, "warm_ms": warm}}
    for name, (A, B, M) in cells.items():
        dplan = planner.plan_distributed(A, B, M, DIST_P)
        info = planner.explain(dplan)
        reset_counts()
        auto = distributed_masked_spgemm(A, B, M, mesh, algorithm="auto")
        sync(dev)
        check(kernel.FUSED_LAUNCHES == (
            DIST_P ** 2 if dplan.route == "ring" else 0),
            f"{name}: auto ran the elected {dplan.route} route")
        measured, results = {}, {}
        for route in ("ring", "row"):
            first, warm, results[route] = timed_route(
                lambda route=route: distributed_masked_spgemm(
                    A, B, M, mesh, algorithm=route), dev)
            measured[route] = {"first_ms": first, "warm_ms": warm}
        check(same_result(results["ring"], results["row"])
              and same_result(auto, results[dplan.route]),
              f"{name}: ring, row and auto agree bit for bit")
        print(f"dist [{CARD}]: auto p={DIST_P} {name}: elects {dplan.route} "
              f"(block {dplan.tile_block}, row kernel {dplan.row_algorithm});"
              f" model " + ", ".join(f"{k} {v:.4g}" for k, v in
                                     info["costs_ms"].items())
              + " ms; measured " + ", ".join(
                  f"{k} first {v['first_ms']:.1f} warm "
                  + (f"{v['warm_ms']:.1f}" if v["warm_ms"] is not None
                     else "not timed") + " ms"
                  for k, v in measured.items()))
        out[name] = {"elected": dplan.route, "model_ms": info["costs_ms"],
                     "measured": measured}
        del auto, results
    dist.clear_ring_prep_cache()
    return out


def dense_ring(dev, ops, k: int = DIST_DENSE_K) -> dict:
    """``ring_masked_matmul`` at p = DIST_P: (n, K) x (K, n) f32 on the
    tile-8192 mask against ``torch.matmul`` masked once (TF32 off) and
    float64, within 2e-6 normwise."""
    _, _, M = ops
    n = M.shape[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn((n, k), generator=gen, device=dev)
    b = torch.randn((k, n), generator=gen, device=dev)
    mask = dense_on(M, dev)
    mesh = mesh_on(dev, DIST_P)
    got = ring_masked_matmul(a, b, mask, mesh)
    # every shard sends its f32 (K / p, n) B panel on p - 1 times
    link = DIST_P * (DIST_P - 1) * (k // DIST_P) * n * 4
    want = torch.where(mask != 0, a @ b, 0.0)
    want64 = torch.where(mask != 0, a.double() @ b.double(), 0.0)
    err = float((got - want).norm() / want.norm())
    err64 = float((got.double() - want64).norm() / want64.norm())
    check(err <= 2e-6 and err64 <= 2e-6, f"the dense ring within 2e-6 "
          f"normwise of masked torch.matmul ({err:.3g}) and float64 "
          f"({err64:.3g})")
    ring_ms = device_ms(lambda: ring_masked_matmul(a, b, mask, mesh), dev,
                        reps=3, warm=1)
    mm_ms = device_ms(lambda: torch.where(mask != 0, a @ b, 0.0), dev,
                      reps=5, warm=1)
    print(f"dist [{CARD}]: dense ring p={DIST_P} ({n}, {k}) x ({k}, {n}) "
          f"f32: {err:.3g} normwise from masked torch.matmul, {err64:.3g} "
          f"from float64; {ring_ms:.2f} ms against masked torch.matmul "
          f"{mm_ms:.2f} ms; a real ring would move "
          f"{link / DIST_P / 2**20:.1f} MiB per link")
    del a, b, mask, got, want, want64
    return {"normwise": err, "normwise_f64": err64, "ms": ring_ms,
            "matmul_ms": mm_ms, "link_bytes": link}


def dist_serving(dev, ops, queries: int = SERVE_TILE_QUERIES) -> dict:
    """``QueryEngine.submit(mesh=make_mesh(DIST_P))``: a bucket of
    ``queries`` tile-8192 queries, each bit for bit its one-shot
    ``distributed_masked_spgemm``; the dist plan and the ring prep built
    once for the bucket; p² fused launches per query."""
    A, B, M = ops
    As = [revalue(A, s, ints=True) for s in range(queries)]
    mesh = mesh_on(dev, DIST_P)
    planner.clear_plan_cache()
    dist.clear_ring_prep_cache()
    plans0, prep0 = planner.plan_cache_info(), dist.ring_prep_cache_info()
    eng = QueryEngine(max_batch=queries, cache_results=False, device=dev)
    reset_counts()
    with count_plain() as plain, launch_shapes() as shapes:
        t0 = time.perf_counter()
        tickets = [eng.submit(a, B, M, mesh=mesh) for a in As]
        got = [t.result() for t in tickets]
        sync(dev)
        bucket_ms = (time.perf_counter() - t0) * 1e3
    launches = kernel.FUSED_LAUNCHES
    plans1, prep1 = planner.plan_cache_info(), dist.ring_prep_cache_info()
    (row,) = eng.metrics.bucket_log()
    eng.close()
    check(row["route"] == "distributed" and row["algorithm"] == "ring"
          and row["size"] == queries, f"the mesh bucket runs the ring (got "
          f"{row['route']}, {row['algorithm']}, {row['size']})")
    check(plans1["misses"] - plans0["misses"] == 1
          and prep1["misses"] - prep0["misses"] == 1
          and prep1["hits"] - prep0["hits"] == queries - 1,
          f"the bucket built one dist plan and one ring prep (plans "
          f"{plans0} -> {plans1}, prep {prep0} -> {prep1})")
    check(launches == queries * DIST_P ** 2 and plain.calls == 0,
          f"{queries} x {DIST_P ** 2} fused launches and no plain version "
          f"(got {launches}, plain {plain.calls})")
    sm90_n = shapes.check("mesh bucket")
    for a, g in zip(As, got):
        check(same_result(g, distributed_masked_spgemm(a, B, M, mesh)),
              "each mesh-bucket result equals its one-shot call bit for bit")
    print(f"dist [{CARD}]: engine mesh bucket {queries} x "
          f"tile-{M.shape[0]} at p={DIST_P}: {bucket_ms:.1f} ms submit to results, serve.exec "
          f"{row['exec_s'] * 1e3:.1f} ms; plan cache {plans0['misses']} -> "
          f"{plans1['misses']} misses, ring prep {prep0} -> {prep1}; "
          f"{launches} fused launches ({sm90_n} at bs 128 on the Hopper "
          f"kernel), no plain version; bitwise one-shot")
    del got
    dist.clear_ring_prep_cache()
    return {"launches": launches, "sm90_launches": sm90_n,
            "bucket_ms": bucket_ms, "exec_ms": row["exec_s"] * 1e3}


def dist_fit(dev) -> dict:
    """The dist probes on their smoke grid on the card (one ring call
    launches p² fused kernels) and ``fit_dist`` on them: finite residual.
    The fit is printed, never registered: on one card the rotations cross
    no link."""
    reset_counts()
    with launch_shapes() as shapes:
        ms = probes.probe_dist(smoke=True, device=dev, log=lambda line: None)
    calls = probes.dist_calls(smoke=True)
    sm90_n = shapes.check("dist probes")
    check(kernel.FUSED_LAUNCHES == calls, f"the dist probes launched the "
          f"fused kernel {calls} times (got {kernel.FUSED_LAUNCHES})")
    fitted, resid = fit.fit_dist(ms, acc.COST_CONSTANTS, planner.TILE_COST,
                                 planner.DIST_COST)
    check(math.isfinite(resid) and all(
        math.isfinite(v) and v >= 0 for v in fitted.values()),
        f"fit_dist gives finite constants and residual ({fitted}, {resid})")
    print(f"dist [{CARD}]: dist probes (smoke): {len(ms)} points, "
          f"{calls} fused launches ({sm90_n} at bs 128 on the Hopper "
          f"kernel); " + "; ".join(
              f"{m.point} {m.target} {m.seconds * 1e3:.2f} ms" for m in ms))
    print(f"dist [{CARD}]: fit_dist on them: {fitted}, residual "
          f"{resid:.3f} (builtin {planner.DIST_COST}); one card, so the "
          f"rotations crossed no link: not registered")
    dist.clear_ring_prep_cache()
    return {"fitted": fitted, "residual": resid, "launches": calls}


def dist_phase(dev, ops) -> dict:
    """Phase 13: the distributed routes on tile-8192's operands revalued
    to integers 1-4, the row route and auto on tc-rmat14, the dense ring,
    a mesh bucket of the engine and the dist probes and fit."""
    A, B, M = ops
    ops = (revalue(A, 0, ints=True), revalue(B, 1, ints=True), M)
    A, B, M = ops
    gc_collect(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = masked_spgemm(A, B, M, algorithm="tile", tile_block=TILE_BS,
                        device=dev)
    sync(dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    warm_ms = host_ms(lambda: masked_spgemm(
        A, B, M, algorithm="tile", tile_block=TILE_BS, device=dev), dev,
        reps=DIST_REPS)
    idx = masked_entries(res, M, dev)
    C = dense_on(A, dev) @ dense_on(B, dev)
    check(torch.equal(res.vals[idx[0], idx[2]], C[idx[0], idx[1]]),
          "the single-device call equals the dense product at the mask")
    del C, idx
    single = {"res": res, "warm_ms": warm_ms, "peak_mib": peak / 2**20}
    print(f"dist [{CARD}]: single-device tile call on the integer "
          f"tile-{M.shape[0]}: warm {warm_ms:.2f} ms (median of "
          f"{DIST_REPS}), peak {peak / 2**20:.1f} MiB")
    out = {"single": {"warm_ms": warm_ms, "peak_mib": peak / 2**20}}
    out["ring"] = ring_sizes(dev, ops, single)
    out["normal"] = ring_normal(dev, ops, single)
    del single, res
    out["auto"] = row_and_auto(dev, ops)
    out["dense"] = dense_ring(dev, ops)
    out["serving"] = dist_serving(dev, ops)
    out["fit"] = dist_fit(dev)
    planner.clear_plan_cache()
    gc_collect(dev)
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
    version, and f32 also within 1e-5 of float64 (blocks the mma.sync
    kernel takes).  Then the GPU tests' 128-block cases on both kernels
    (the Hopper one by default, each launch counted or not in
    ``MASKED_MATMUL_SM90_LAUNCHES``): f32 with K = 384, where the plain
    version's own IEEE f32 bmm strays past 1e-5 of float64 at some
    outputs, so each kernel is held to 1e-5 of float64 and the outputs
    beyond 1e-5 are counted; bf16 within 2e-2 of plain; and integer data
    with tiles outside A or B, which both kernels must give as zeros and
    the rest bit for bit the plain version."""
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

    # tests/test_torch_cuda.py's 128-block cases, on both kernels
    rng = np.random.default_rng(256)
    a = torch.as_tensor(rng.standard_normal((512, 384)), dtype=torch.float32,
                        device=dev)
    b = torch.as_tensor(rng.standard_normal((384, 384)), dtype=torch.float32,
                        device=dev)
    ok = rng.random((4, 3)) < 0.5
    ok[0, 0] = True
    bi, bj = (torch.as_tensor(x.astype(np.int32), device=dev)
              for x in np.nonzero(ok))
    plain = kernel.masked_matmul_plain(a, b, bi, bj, bm=128, bn=128)
    exact = sddmm_f64(a, b, bi, bj, 128, 128)
    beyond = {"plain vs float64": int((~torch.isclose(
        plain.double(), exact, rtol=1e-5, atol=1e-5)).sum())}
    ab, bb = a.bfloat16(), b.bfloat16()
    plain16 = kernel.masked_matmul_plain(ab, bb, bi, bj, bm=128, bn=128)
    for variant in ("sm90", "mma_sync"):
        before = kernel.MASKED_MATMUL_SM90_LAUNCHES
        got = kernel.masked_matmul_kernel(a, b, bi, bj, bm=128, bn=128,
                                          bk=128, variant=variant)
        got16 = kernel.masked_matmul_kernel(ab, bb, bi, bj, bm=128, bn=128,
                                            bk=128, variant=variant)
        sync(dev)
        check(kernel.MASKED_MATMUL_SM90_LAUNCHES
              == before + 2 * (variant == "sm90"),
              f"the 128-block cases ran the {variant} kernel")
        if variant == "sm90":
            check(torch.equal(got, kernel.masked_matmul_kernel(
                a, b, bi, bj, bm=128, bn=128, bk=128)), "the default "
                "variant at 128-blocks is the Hopper kernel's result")
        beyond[f"{variant} vs plain"] = int((~torch.isclose(
            got.double(), plain.double(), rtol=1e-5, atol=1e-5)).sum())
        beyond[f"{variant} vs float64"] = n64 = int((~torch.isclose(
            got.double(), exact, rtol=1e-5, atol=1e-5)).sum())
        check(n64 == 0, f"f32 SDDMM at K = 384 on the {variant} kernel "
              f"within 1e-5 of float64")
        e16 = float((got16 - plain16).abs().max())
        check(torch.allclose(got16, plain16, rtol=2e-2, atol=2e-2),
              f"bf16 SDDMM at K = 384 on the {variant} kernel within 2e-2 "
              f"of plain (max err {e16})")
        err = max(err, float((got - plain).abs().max()), e16)

    # tiles outside A or B come out as zeros (the outputs are not cleared
    # first); integer data: the rest bit for bit
    rng = np.random.default_rng(7)
    inside = [(0, 0), (2, 1), (1, 2)]
    outside = [(-1, 0), (3, 0), (0, 3), (0, -2), (1 << 20, 1 << 20)]
    bi, bj = (torch.tensor(x, dtype=torch.int32, device=dev)
              for x in zip(*(inside + outside)))
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.as_tensor(rng.integers(-4, 5, (384, 256)), dtype=dtype,
                            device=dev)
        b = torch.as_tensor(rng.integers(-4, 5, (256, 384)), dtype=dtype,
                            device=dev)
        want = kernel.masked_matmul_plain(a, b, bi[:3], bj[:3], bm=128,
                                          bn=128)
        for variant in ("sm90", "mma_sync"):
            got = kernel.masked_matmul_kernel(a, b, bi, bj, bm=128, bn=128,
                                              bk=128, variant=variant)
            sync(dev)
            check(torch.equal(got[:3], want) and not got[3:].any(),
                  f"{dtype} {variant}: tiles inside equal plain, "
                  f"{len(outside)} tiles outside A or B zeros")
    print(f"sddmm-vs-plain: reference sweep agrees (1e-5 f32, also against "
          f"float64; 2e-2 bf16), max abs err {err:.3g}; at K = 384 and "
          f"128-blocks ({plain.numel()} outputs; bf16 within 2e-2 on both "
          f"kernels), outputs beyond 1e-5: "
          + ", ".join(f"{k} {v}" for k, v in beyond.items())
          + f"; {len(outside)} out-of-range tiles zeros on both kernels, "
          f"f32 and bf16")
    return err


#: the Hopper SDDMM kernel (csrc/masked_matmul_sm90.cu), which the path's
#: 128-blocks run, and the mma.sync one it replaced there
SDDMM_SOURCE = ("src/repro_torch/kernels/masked_matmul/csrc/"
                "masked_matmul_sm90.cu")
SDDMM_MMA_SYNC_SOURCE = ("src/repro_torch/kernels/masked_matmul/csrc/"
                         "masked_matmul.cu")
SDDMM_DESIGN = (
    "persistent CTAs (one an SM) walking the mask's tiles in CSR order; TMA "
    "loads of A's 128-row and B's 128-column panels, 128 bytes of K a "
    "stage, behind full / ready / empty mbarriers; a producer warpgroup "
    "(one thread issues copies, three warps split A into tf32 hi and lo) "
    "and two consumer warpgroups on wgmma (setmaxnreg 56 / 224); each "
    "warpgroup's 64 x 128 share of a tile staged in shared memory and "
    "stored by TMA. f32: 3xTF32 as C^T = B^T A^T (B^T split in registers, "
    "m64n128k8 RS; hi = rna(x), lo = rna(x - hi)), a partial every 2 k8 "
    "steps added with IEEE rounding, a 3-stage ring. bf16: two m64n64k16 SS "
    "a k16 step (B's two 64-column panels read MN-major through the "
    "transpose bit), a 4-stage ring. Other shapes on the mma.sync kernel")


def sddmm_sm90_and_mma_sync_ms(a, b, bi, bj, bs: int, dev) -> tuple:
    """The Hopper and the mma.sync SDDMM kernels' device ms per call on the
    same inputs (``kernel_ms``), in turns (sm90, mma.sync, mma.sync, sm90;
    the median of each one's two)."""
    times = {"sm90": [], "mma_sync": []}
    for variant in ("sm90", "mma_sync", "mma_sync", "sm90"):
        times[variant].append(kernel_ms(
            lambda: kernel.masked_matmul_kernel(a, b, bi, bj, bm=bs, bn=bs,
                                                bk=bs, variant=variant),
            dev))
    return (statistics.median(times["sm90"]),
            statistics.median(times["mma_sync"]))


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
    sm90_launches = kernel.MASKED_MATMUL_SM90_LAUNCHES
    check(launches == 1, f"masked_matmul launched once (got {launches})")
    check(sm90_launches == 1, f"the path's call ran the Hopper SDDMM kernel "
          f"(MASKED_MATMUL_SM90_LAUNCHES {sm90_launches})")
    check(kernel.LAUNCHES == kernel.FUSED_LAUNCHES == flash.LAUNCHES
          == kernel.SM90_LAUNCHES == 0,
          "the SDDMM path launches no other kernel")
    want = kernel.masked_matmul_plain(a, b, bi, bj, bm=bs, bn=bs)
    check(torch.equal(got, want), "masked_matmul equals plain exactly on "
          "integer data")
    check(bool(torch.isfinite(got).all()), "SDDMM values are finite")
    err = float((got - want).abs().max())
    del got, want
    ab, bb = a.bfloat16(), b.bfloat16()      # integers: exact in bf16
    before = kernel.MASKED_MATMUL_SM90_LAUNCHES
    got = ops.masked_matmul(ab, bb, bi, bj, bm=bs, bn=bs, bk=bs)
    sync(dev)
    check(kernel.MASKED_MATMUL_SM90_LAUNCHES == before + 1, "the bf16 call "
          "ran the Hopper SDDMM kernel")
    check(torch.equal(got, kernel.masked_matmul_plain(ab, bb, bi, bj, bm=bs,
                                                      bn=bs)),
          "bf16 masked_matmul equals plain exactly on integer data")
    del got

    # the same call on standard-normal data, where precision shows: the
    # plain version runs bmm in IEEE f32, 3xTF32 keeps f32 accuracy and
    # one TF32 pass misses 2e-6 by more than 10x (test_torch_tc_numerics).
    # Any f32 summation order errs by up to ~1e-5 of the dot products'
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
    del got, want, exact
    an16, bn16 = an.bfloat16(), bn_.bfloat16()
    got = ops.masked_matmul(an16, bn16, bi, bj, bm=bs, bn=bs, bk=bs)
    want = kernel.masked_matmul_plain(an16, bn16, bi, bj, bm=bs, bn=bs)
    err16 = float((got - want).abs().max())
    rel16 = float((got - want).norm() / want.norm())
    ok16 = torch.allclose(got, want, rtol=2e-2, atol=2e-2)
    del got, want, an16, bn16
    print(f"sddmm: standard-normal data: f32 normwise {rel:.3g} against "
          f"plain (IEEE f32 bmm), {rel64:.3g} against float64; max |diff| / "
          f"sum_k |a b| {scaled:.3g} against plain; bf16 max |diff| "
          f"{err16:.3g}, normwise {rel16:.3g} against plain")
    check(max(rel, rel64) <= 2e-6, f"SDDMM on float data within 2e-6 "
          f"normwise of plain and of float64 (got {rel:.3g}, {rel64:.3g})")
    check(scaled <= 1e-5, f"SDDMM on float data within 1e-5 of "
          f"sum_k |a b| elementwise (got {scaled:.3g})")
    check(ok16, f"bf16 SDDMM on float data within 2e-2 of plain (max err "
          f"{err16:.3g})")
    del an, bn_

    def library(x, y):      # gather the panels of block views, one bmm
        x_pan = x.view(n // bs, bs, k)[bi.long()]
        y_pan = y.view(k, n // bs, bs).permute(1, 0, 2)[bj.long()]
        if x.dtype == torch.float32:
            return torch.bmm(x_pan, y_pan)
        if dev.type == "cuda":
            return torch.bmm(x_pan, y_pan, out_dtype=torch.float32)
        return torch.bmm(x_pan.float(), y_pan.float())

    flops = 2.0 * nnzb * bs * bs * k
    out = {}
    for key, x, y, peak in (("", a, b, PEAK_F32_ACCURATE_FLOPS),
                            ("bf16_", ab, bb, PEAK_BF16_FLOPS)):
        out[key + "ms"], out[key + "mma_sync_ms"] = (
            sddmm_sm90_and_mma_sync_ms(x, y, bi, bj, bs, dev))
        out[key + "plain_ms"] = device_ms(lambda: kernel.masked_matmul_plain(
            x, y, bi, bj, bm=bs, bn=bs), dev, reps=5, warm=1)
        out[key + "library_ms"] = chained_ms(lambda: library(x, y), dev)
        nbytes = x.nbytes + y.nbytes + 8 * nnzb + nnzb * bs * bs * 4
        out[key + "bound_ms"], out[key + "bound_by"] = bound(flops, nbytes,
                                                             peak)
        out[key + "gbytes"] = nbytes / 1e9
    f32_ms = flops / PEAK_F32_FLOPS * 1e3
    print(f"sddmm: M=N={n} K={k} blocks {bs} nnzb={nnzb}: {flops / 1e9:.1f} "
          f"GFLOP, {out['gbytes'] * 1e3:.0f} MB f32, "
          f"{out['bf16_gbytes'] * 1e3:.0f} MB bf16; launches {launches} "
          f"({sm90_launches} on the Hopper kernel); equals plain exactly on "
          f"integers, f32 and bf16")
    for key, what in (("", "f32 (3xTF32)"), ("bf16_", "bf16")):
        ms, old, bd = (out[key + "ms"], out[key + "mma_sync_ms"],
                       out[key + "bound_ms"])
        print(f"sddmm: {what}: Hopper kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), the mma.sync kernel in "
              f"this run {old:.4f} ms (in turns, kernel_ms); plain "
              f"{out[key + 'plain_ms']:.3f} ms; library (block-view gather "
              f"+ torch.bmm) {out[key + 'library_ms']:.3f} ms; bound "
              f"{bd:.4f} ms (by {out[key + 'bound_by']}"
              + (f", three TF32 passes; {f32_ms:.3f} ms on f32 CUDA cores"
                 if not key else "")
              + f"); {bd / ms:.1%} / {bd / old:.1%} of it")
    info = _build.kernel_info("masked_matmul_sm90", "masked_matmul_sm90_info",
                              0)
    return {"name": "masked_matmul", "route": "cuda",
            "source": SDDMM_SOURCE,
            "replaces": "src/repro/kernels/masked_matmul/kernel.py:50",
            "launches": launches, "sm90_launches": sm90_launches,
            "max_abs_err": max(err, err16), "ms": out["ms"],
            "plain_ms": out["plain_ms"], "bound_ms": out["bound_ms"],
            "bound_by": out["bound_by"], "library_ms": out["library_ms"],
            "mma_sync_source": SDDMM_MMA_SYNC_SOURCE,
            "mma_sync_ms": out["mma_sync_ms"],
            "bf16_ms": out["bf16_ms"],
            "bf16_mma_sync_ms": out["bf16_mma_sync_ms"],
            "bf16_bound_ms": out["bf16_bound_ms"],
            "bf16_plain_ms": out["bf16_plain_ms"],
            "bf16_library_ms": out["bf16_library_ms"],
            "f32_vs_f64": rel64, "bf16_vs_plain": rel16,
            "design": SDDMM_DESIGN,
            "sm90_instance": (f"masked_matmul_sm90_kernel<float>: "
                              f"{info['threads']} threads, "
                              f"{info['registers']} registers at launch, "
                              f"{info['local_bytes']} B local memory, "
                              f"{info['smem_bytes']} B shared memory, "
                              f"{info['ctas_per_sm']} CTAs per SM")}


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
    patterns x three shapes x f32/bf16 with q_offset = s_k - s_q; then the
    model layers' head dims D 112 and 128, causal and non-causal, 4/2
    heads, S 256 in 128-blocks, f32/bf16; the decode offset and the GQA
    op; within 2e-5 / 3e-2, and bf16 also within the layer's 2e-3
    normwise (one bf16 term for p, instead of the kernel's two, exceeds it
    at the layer's shape: test_torch_tc_numerics).  Counts the f32 cases
    that ran the f32 Hopper kernel: each case where ``choose_variant``
    picks it (D 112 and 128 at 128-blocks), and no other."""
    err = rel_bf16 = 0.0
    d = 16
    tc_before, f32_before = flash.TC_LAUNCHES, flash.F32_LAUNCHES
    f32_sm90 = f32_sm90_expected = 0

    def compare(q, k, v, **kw):
        nonlocal f32_sm90, f32_sm90_expected
        before = flash.SM90_LAUNCHES
        out = flash_compare(q, k, v, **kw)
        if q.dtype == torch.float32:
            f32_sm90 += flash.SM90_LAUNCHES - before
            f32_sm90_expected += flash.choose_variant(
                None, q, k, v, kw["bq"], kw["bk"]) == "sm90"
        return out

    for pattern in FLASH_PATTERNS:
        for s_q, s_k, bq, bk in ((32, 32, 8, 8), (64, 64, 16, 16),
                                 (32, 64, 8, 16)):
            for dtype, tol, normwise in ((torch.float32, 2e-5, None),
                                         (torch.bfloat16, 3e-2, 2e-3)):
                rng = np.random.default_rng(11)
                q, k, v = (torch.as_tensor(
                    rng.standard_normal((1, 1, s, d)) * 0.5,
                    device=dev).to(dtype) for s in (s_q, s_k, s_k))
                e, rel = compare(q, k, v, bq=bq, bk=bk,
                                 q_offset=s_k - s_q, tol=tol,
                                 normwise=normwise, **pattern)
                err = max(err, e)
                if dtype == torch.bfloat16:
                    rel_bf16 = max(rel_bf16, rel)
    # the model layers' head dims beyond the sweep's: D 112 (zamba2-7b,
    # the D 128 tile with a zero-filled tail) and D 128 (moonshot), causal
    # and non-causal (seamless's encoder), GQA heads, 128-blocks
    for d_big in (112, 128):
        for pattern in (FLASH_PATTERNS[0], FLASH_PATTERNS[3]):
            for dtype, tol, normwise in ((torch.float32, 2e-5, None),
                                         (torch.bfloat16, 3e-2, 2e-3)):
                rng = np.random.default_rng(d_big)
                q, k, v = (torch.as_tensor(
                    rng.standard_normal((1, h, 256, d_big)) * 0.5,
                    device=dev).to(dtype) for h in (4, 2, 2))
                e, rel = compare(q, k, v, bq=128, bk=128, q_offset=0,
                                 tol=tol, normwise=normwise, **pattern)
                err = max(err, e)
                if dtype == torch.bfloat16:
                    rel_bf16 = max(rel_bf16, rel)
    check(flash.TC_LAUNCHES - tc_before == 32
          and flash.F32_LAUNCHES - f32_before == 16, "the 32 cases ran "
          "tensor-core kernels, the 16 f32 ones a 3xTF32 kernel")
    check(f32_sm90 == f32_sm90_expected == 4, f"the f32 cases at D 112 and "
          f"128 ran the f32 Hopper kernel and no other f32 case did (got "
          f"{f32_sm90} of {f32_sm90_expected} expected)")
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
    print(f"flash-vs-plain: reference sweep, D 112 and 128 (causal and "
          f"non-causal), decode offset and GQA op "
          f"agree (2e-5 f32, 3e-2 bf16), max abs err {err:.3g}; bf16 "
          f"normwise at most {rel_bf16:.3g} (limit 2e-3); {f32_sm90} of the "
          f"16 f32 cases on the f32 Hopper kernel")
    return max(err, flash_sm90_cases(dev))


def flash_sm90_cases(dev) -> float:
    """The Hopper bf16 kernel against plain (the sweep's 3e-2 and 2e-3
    normwise) at the four path shapes cut to S 512 (llama's layer at B 1),
    a window with a prefix at 128-blocks, q_offset > 0, bq 64 with bk 64
    and 128, a never-visited and a never-flushed q-block (zeros: the
    kernel writes them, the output is not cleared first) and out-of-range
    kv-blocks (which leave the result bit for bit as without them); every
    launch on the Hopper kernel, counted by SM90_LAUNCHES."""
    sm90_before = flash.SM90_LAUNCHES
    err = rel_max = 0.0
    launches = 0

    def qkv(seed, hq, hkv, s_q, s_k, d):
        g = torch.Generator(device=dev).manual_seed(seed)
        return ((torch.randn(shape, generator=g, device=dev) * 0.5)
                .to(torch.bfloat16)
                for shape in ((1, hq, s_q, d), (1, hkv, s_k, d),
                              (1, hkv, s_k, d)))

    cases = (  # what, Hq, Hkv, S_q, S_k, D, bq, bk, pattern
        ("llama", 32, 8, 512, 512, 64, 128, 128, FLASH_PATTERNS[0]),
        ("moonshot", 16, 16, 512, 512, 128, 128, 128, FLASH_PATTERNS[0]),
        ("zamba2 (D 112)", 32, 32, 512, 512, 112, 128, 128,
         FLASH_PATTERNS[0]),
        ("seamless (non-causal)", 16, 16, 512, 512, 64, 128, 128,
         FLASH_PATTERNS[3]),
        ("window 200 + prefix 100", 4, 2, 512, 512, 64, 128, 128,
         dict(causal=True, window=200, prefix=100)),
        ("q_offset 256", 4, 2, 256, 512, 64, 128, 128, FLASH_PATTERNS[0]),
        ("bq 64, bk 64", 4, 2, 512, 512, 64, 64, 64, FLASH_PATTERNS[0]),
        ("bq 64, bk 128, D 128", 4, 2, 512, 512, 128, 64, 128,
         FLASH_PATTERNS[0]))
    for i, (what, hq, hkv, s_q, s_k, d, bq, bk, pattern) in enumerate(cases):
        q, k, v = qkv(20 + i, hq, hkv, s_q, s_k, d)
        e, rel = flash_compare(q, k, v, bq=bq, bk=bk, q_offset=s_k - s_q,
                               tol=3e-2, normwise=2e-3, **pattern)
        err, rel_max, launches = max(err, e), max(rel_max, rel), launches + 1
    # worklist edits: q-block 0 never visited; out-of-range kv-blocks (5
    # and -1) inside q-block 1's segment
    q, k, v = qkv(40, 4, 2, 256, 256, 64)
    qi, ki, flags = flash.build_schedule(256, 256, bq=128, bk=128,
                                         causal=True, window=0, prefix=0,
                                         q_offset=0)
    keep = qi != 0
    at = int(np.nonzero(qi == 1)[0][1])
    kw = dict(bq=128, bk=128, scale=0.125, causal=True, window=0, prefix=0,
              q_offset=0)
    worklists = {
        "never-visited q-block": (qi[keep], ki[keep], flags[keep]),
        "q-block never flushed": (qi, ki, np.where(qi == 1, flags & 1,
                                                   flags)),
        "plain": (qi, ki, flags),
        "out-of-range kv-blocks": (np.insert(qi, at, [1, 1]),
                                   np.insert(ki, at, [5, -1]),
                                   np.insert(flags, at, [0, 0]))}
    got = {name: flash.flash_mask_kernel(
        q, k, v, *(torch.as_tensor(x, device=dev) for x in wl), **kw)
        for name, wl in worklists.items()}
    launches += len(worklists)
    for name in ("never-visited q-block", "q-block never flushed", "plain"):
        want = flash.flash_mask_plain(
            q, k, v, *(torch.as_tensor(x, device=dev)
                       for x in worklists[name]), **kw)
        sync(dev)
        diff = got[name].float() - want.float()
        e, rel = float(diff.abs().max()), float(diff.norm()
                                                / want.float().norm())
        check(torch.allclose(got[name].float(), want.float(), rtol=3e-2,
                             atol=3e-2) and rel <= 2e-3,
              f"sm90 flash, {name}: within 3e-2 and 2e-3 normwise of plain "
              f"(max err {e}, normwise {rel:.3g})")
        err, rel_max = max(err, e), max(rel_max, rel)
    check(bool((got["never-visited q-block"][:, :, :128] == 0).all())
          and bool((got["q-block never flushed"][:, :, 128:] == 0).all()),
          "sm90 flash: a never-visited or never-flushed q-block stays zero")
    check(torch.equal(got["out-of-range kv-blocks"], got["plain"]),
          "sm90 flash: out-of-range kv-blocks change nothing")
    check(flash.SM90_LAUNCHES - sm90_before == launches,
          f"the {launches} Hopper cases ran the sm90 kernel (got "
          f"{flash.SM90_LAUNCHES - sm90_before})")
    print(f"flash-sm90: {len(cases)} shapes (the path's four at S 512, "
          f"window + prefix, q_offset, bq 64) and four worklists "
          f"(never-visited and never-flushed q-blocks, out-of-range "
          f"kv-blocks) agree with "
          f"plain (3e-2, 2e-3 normwise): max abs err {err:.3g}, normwise at "
          f"most {rel_max:.3g}; {launches} sm90 launches")
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
    kernel_ms, mma_sync_ms = sm90_and_mma_sync_ms(q, k, v, sched, kw, dev)
    plain_ms = device_ms(lambda: flash.flash_mask_plain(q, k, v, *sched,
                                                        **kw),
                         dev, reps=3, warm=1)
    library_ms = chained_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), dev)
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
    print(f"flash: kernel (sm90) {kernel_ms:.3f} ms "
          f"({flops / kernel_ms / 1e9:.1f} TFLOP/s; the mma.sync kernel in "
          f"this run {mma_sync_ms:.3f} ms; the first CUDA-core kernel "
          f"{PR12_MS['flash_mask']:.3f} ms); plain "
          f"{plain_ms:.3f} ms; library (scaled_dot_product_attention, "
          f"causal, GQA) {library_ms:.3f} ms; bound {bound_ms:.4f} ms (by "
          f"{by}, bf16 tensor cores; the f32 instance's, three TF32 passes: "
          f"{f32_ms:.3f} ms); kernel at {bound_ms / kernel_ms:.2%} of it")
    return {"name": "flash_mask", "route": "cuda", "source": SM90_SOURCE,
            "replaces": "src/repro/kernels/flash_mask/kernel.py:121",
            "launches": 0, "max_abs_err": err, "ms": kernel_ms,
            "mma_sync_ms": mma_sync_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms,
            **f32, "f32_source": F32_SM90_SOURCE,
            "f32_mma_sync_source": MMA_SYNC_SOURCE,
            "sm90_instance": sm90_instance(64),
            "design": SM90_DESIGN + "; " + F32_SM90_DESIGN}


#: the flash kernels: the Hopper ones the path runs (bf16 and f32), and the
#: mma.sync ones that keep the other shapes
SM90_SOURCE = "src/repro_torch/kernels/flash_mask/csrc/flash_mask_sm90.cu"
F32_SM90_SOURCE = ("src/repro_torch/kernels/flash_mask/csrc/"
                   "flash_mask_f32_sm90.cu")
MMA_SYNC_SOURCE = "src/repro_torch/kernels/flash_mask/csrc/flash_mask.cu"
SM90_DESIGN = ("bf16: wgmma.mma_async (q.k^T m64n128k16 from shared memory, "
               "p.v m64n64k16 with p = hi + lo as register A operands and v "
               "read transposed, in four batches of keys), q/k/v by TMA in "
               "the 128-byte swizzle behind full/empty mbarriers, a producer "
               "warp and two consumer warpgroups of 64 rows (setmaxnreg 24 / "
               "232), a 2-stage k/v ring, online softmax in registers with "
               "ex2.approx and the scale folded into its fma; other bf16 "
               "shapes on the mma.sync kernel")
F32_SM90_DESIGN = (
    "f32: tf32 wgmma.mma_async in 3xTF32 (q.k^T m64n64k8 with q and k from "
    "shared memory; p.v m64n64k8 with p's hi and lo as register A operands "
    "and v^T from shared memory), every element split once (hi the raw f32 "
    "word, lo = rna(x - trunc x); q's lo by its consumer warpgroup, k's lo "
    "and v^T's hi and lo by three producer warps, v^T's keys in the S "
    "fragment's order), partial sums flushed with IEEE adds (q.k^T every 8 "
    "k8 steps, p.v every one), q/k/v by TMA behind full / k-ready / v-ready "
    "/ empty mbarriers, a 2-stage ring of 64-key chunks, two consumer "
    "warpgroups taking turns at q.k^T (setmaxnreg 72 / 216); D 112 and 128 "
    "in CTAs of 64 rows and 32-key chunks; other f32 shapes on the mma.sync "
    "kernel")


def sm90_expected(cfg, seq: int, launches: int,
                  dtype=torch.bfloat16) -> int:
    """How many of a forward's ``launches`` flash launches in ``dtype`` run
    a Hopper kernel: all where its dispatch predicate takes the model's
    blocks (attn_block cut to the sequence) and head dim, as every LM at
    full width in bf16 and in f32 (D 64, 112 and 128), else none (the
    reduced configs' 16-blocks)."""
    blk = min(cfg.attn_block, seq)
    x = torch.empty((0, 0, 0, cfg.hd), dtype=dtype)
    return launches if flash.sm90_takes(x, x, x, blk, blk) else 0


def sm90_and_mma_sync_ms(q, k, v, sched, kw, dev) -> tuple:
    """The Hopper kernel's and the mma.sync kernel's ms on the same
    inputs, timed back to back (``chained_ms``) in turns (sm90, mma.sync,
    mma.sync, sm90; the median of each one's two).  The first is the
    kernel the wrapper picks: the Hopper one at every path shape (the
    reduced configs' 16-blocks keep mma.sync)."""
    chosen = flash.choose_variant(None, q, k, v, kw["bq"], kw["bk"])
    times = {chosen: [], "mma_sync": []}
    for variant in (chosen, "mma_sync", "mma_sync", chosen):
        times[variant].append(chained_ms(
            lambda: flash.flash_mask_kernel(q, k, v, *sched, variant=variant,
                                            **kw), dev))
    return (statistics.median(times[chosen]),
            statistics.median(times["mma_sync"]))


def sm90_instance(d: int) -> str:
    """Registers, spills, shared memory and CTAs per SM of the Hopper
    kernel at 128-blocks and head dim d, on the card."""
    info = _build.kernel_info("flash_mask_sm90", "flash_mask_sm90_info",
                              128, 128, d)
    return (f"flash_mask_sm90_kernel<128, 128, {64 if d <= 64 else 128}>: "
            f"{info['threads']} threads, {info['registers']} registers at "
            f"launch, {info['local_bytes']} B local memory, "
            f"{info['smem_bytes']} B shared memory, {info['ctas_per_sm']} "
            f"CTAs per SM")


def f32_instance(dev, q_shape, kv_shape, sched, kw, allowed: int,
                 pairs: int) -> dict:
    """The f32 (3xTF32) flash instance at the layer's shape, on f32 inputs
    of full precision (0.5 randn, seed 8), on the kernel the wrapper picks
    (the f32 Hopper kernel, by ``SM90_LAUNCHES``): against its plain
    version (the sweep's rtol = atol = 2e-5) at B 1 and float64 (2e-6
    normwise) at B 1 and B 4; its times at B 1 (the f32 prefill's shape)
    and B 4 beside flash_mask.cu's mma.sync f32 kernel in the same run
    (back to back, in turns: ``sm90_and_mma_sync_ms``), its bound, the
    plain version and f32 ``scaled_dot_product_attention`` (causal, with
    the kv heads expanded to the query heads before the clock starts),
    whose error from float64 is reported too, as is the mma.sync
    kernel's.  The Hopper kernel passes raw f32 words as the hi terms of
    its splits, which holds only where tf32 wgmma truncates them: a
    rounding tensor core would put it near 1e-4 from float64, far past the
    2e-6.  Returns the f32 fields of the flash entry of the JSON line."""
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(shape, generator=gen, device=dev) * 0.5
               for shape in (q_shape, kv_shape, kv_shape))
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    out = {"f32_ms": {}, "f32_mma_sync_ms": {}, "f32_bound_ms": {},
           "f32_plain_ms": {}, "f32_library_ms": {}, "f32_vs_f64": {},
           "f32_mma_sync_vs_f64": {}, "f32_library_vs_f64": {}}
    for bb in sorted({1, b}):
        qf, kf, vf = (x[:bb] for x in (q, k, v))
        ke, ve = (x.repeat_interleave(g, dim=1) for x in (kf, vf))
        before = flash.SM90_LAUNCHES
        got = flash.flash_mask_kernel(qf, kf, vf, *sched, **kw)
        check(flash.SM90_LAUNCHES == before + 1, "the f32 layer runs the "
              "f32 Hopper kernel")
        old = flash.flash_mask_kernel(qf, kf, vf, *sched, variant="mma_sync",
                                      **kw)
        lib = torch.nn.functional.scaled_dot_product_attention(
            qf, ke, ve, is_causal=True)
        # float64 one batch row at a time: the scores of all four are 4 GB
        num = den = lib_num = old_num = 0.0
        for i in range(bb):
            sc = (qf[i].double() @ ke[i].double().transpose(-1, -2)) * kw[
                "scale"]
            sc.masked_fill_(torch.ones(s, s, dtype=torch.bool, device=dev)
                            .triu_(1), float("-inf"))
            exact = torch.softmax(sc, dim=-1) @ ve[i].double()
            del sc
            num += float((got[i].double() - exact).norm()) ** 2
            old_num += float((old[i].double() - exact).norm()) ** 2
            lib_num += float((lib[i].double() - exact).norm()) ** 2
            den += float(exact.norm()) ** 2
            del exact
        rel, lib_rel = (num / den) ** 0.5, (lib_num / den) ** 0.5
        old_rel = (old_num / den) ** 0.5
        if bb == 1:
            want = flash.flash_mask_plain(qf, kf, vf, *sched, **kw)
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
                  f"f32 flash at the layer's shape within 2e-5 of plain "
                  f"(max err {err})")
            out["f32_max_abs_err"] = err
            old_err = float((got - old).abs().max())
            check(torch.allclose(got, old, rtol=2e-5, atol=2e-5),
                  f"f32 Hopper flash within 2e-5 of the mma.sync kernel "
                  f"(max diff {old_err})")
            del want
        check(rel <= 2e-6, f"f32 flash at B {bb} within 2e-6 normwise of "
              f"float64 (got {rel:.3g})")
        t_ms, old_ms = sm90_and_mma_sync_ms(qf, kf, vf, sched, kw, dev)
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
        out["f32_mma_sync_ms"][key] = old_ms
        out["f32_plain_ms"][key], out["f32_library_ms"][key] = (plain_ms,
                                                                lib_ms)
        out["f32_vs_f64"][key], out["f32_library_vs_f64"][key] = rel, lib_rel
        out["f32_mma_sync_vs_f64"][key] = old_rel
        print(f"flash: f32 instance (3xTF32 tensor cores) B={bb}: Hopper "
              f"kernel {t_ms:.3f} ms, the mma.sync kernel in this run "
              f"{old_ms:.3f} ms (back to back), against the 3xTF32 bound "
              f"{bd:.3f} ms ({bd / t_ms:.1%} / {bd / old_ms:.1%}; the "
              f"first CUDA-core kernel "
              f"{CUDA_CORE_F32_FLASH_MS.get(key, float('nan')):.3f} ms); "
              f"plain {plain_ms:.3f} ms; library (f32 "
              f"scaled_dot_product_attention, causal, kv heads expanded) "
              f"{lib_ms:.3f} ms; normwise from float64: Hopper kernel "
              f"{rel:.3g}, mma.sync kernel {old_rel:.3g}, library "
              f"{lib_rel:.3g}")
        del qf, kf, vf, ke, ve, got, old, lib
    del q, k, v
    info = _build.kernel_info("flash_mask_f32_sm90",
                              "flash_mask_f32_sm90_info", 128, 128, 64)
    old = _build.kernel_info("flash_mask", "flash_mask_f32_info", 128, 128,
                             64)
    out["f32_instance"] = (f"flash_mask_f32_sm90_kernel<128, 64>: "
                           f"{info['threads']} threads, "
                           f"{info['registers']} registers at launch, "
                           f"{info['local_bytes']} B local memory, "
                           f"{info['smem_bytes']} B shared memory, "
                           f"{info['ctas_per_sm']} CTAs per SM")
    out["f32_mma_sync_instance"] = (
        f"flash_mask_f32_tc_kernel<128, 64>: {old['registers']} registers, "
        f"{old['local_bytes']} B local memory, {old['ctas_per_sm']} CTAs "
        f"per SM")
    print(f"flash: f32 instance at the layer's shape within 2e-5 of plain "
          f"(max err {out['f32_max_abs_err']:.3g}) and of the mma.sync "
          f"kernel; {out['f32_instance']}; {out['f32_mma_sync_instance']}")
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
               smoke: bool = False) -> tuple:
    """Returns the flash kernel's launches in the main path's (bf16)
    prefill, the f32 instance's in the f32 prefill and the bf16 prefill's
    warm ms.  ``smoke`` takes
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
    check(flash.SM90_LAUNCHES == sm90_expected(cfg, seq, launches),
          f"every bf16 flash launch of the prefill ran the Hopper kernel "
          f"(SM90_LAUNCHES {flash.SM90_LAUNCHES} of {launches})")
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
    f32_sm90 = sm90_expected(cfg, seq, f32_launches, torch.float32)
    check(f32_launches == flash.TC_LAUNCHES == flash.LAUNCHES
          == cfg.n_layers and flash.SM90_LAUNCHES == f32_sm90,
          f"f32 prefill runs the tensor-core f32 flash kernel once per "
          f"layer, each launch the Hopper one where it takes the shape (got "
          f"{f32_launches} f32 of {flash.LAUNCHES} launches, "
          f"{flash.SM90_LAUNCHES} sm90 of {f32_sm90} expected)")
    dense = T.forward(model, f32.replace(attn_impl="dense_masked"),
                      {"tokens": one})
    diff = (got - dense).abs()
    rel32 = float(diff.norm() / dense.norm())
    print(f"lm: f32 prefill B=1 S={seq} vs dense_masked: max |diff| "
          f"{float(diff.max()):.3g} (max |logit| "
          f"{float(dense.abs().max()):.4g}), normwise {rel32:.3g}; "
          f"{f32_launches} launches of the f32 tensor-core flash kernel, "
          f"{flash.SM90_LAUNCHES} of them on the Hopper one")
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
    return launches, f32_launches, warm_ms


# ---------------------------------------------------------------------------
# Phase 14: block_masked attention and the MoE, MLA and VLM families
# ---------------------------------------------------------------------------


#: starcoder2-7b's attention layer: B 1, 36 query heads on 4 kv heads,
#: S 8192, D 128, a 4,096-token window, causal
STARCODER_LAYER = dict(b=1, hq=36, hkv=4, s=8192, d=128, window=4096)
#: deepseek-v2-lite-16b's prefill: 1 x 2,048 tokens (also its decode
#: cache's length)
DEEPSEEK_SEQ = 2048
#: moonshot-v1-16b-a3b at full width, cut to this many of its 48 layers:
#: all 48 hold about 110 GB of f32 weights, more than the card
MOONSHOT_LAYERS = 24
#: internvl2-2b: its 256-patch image prefix, then this many text tokens
INTERNVL_TEXT = 1792
#: device memory kept free beside a model's f32 weights (prefill
#: activations, logits, per-use weight casts)
LM_HEADROOM_BYTES = 8 << 30
#: decode steps timed per batch size, after two warm steps
DECODE_STEPS = 8


def free_port_memory(dev) -> int:
    """Empty every port cache (the registry holds the schedules, the ring
    prep and every engine's result cache), collect and hand the
    allocator's free blocks back; returns the device's free bytes (0 on
    the CPU)."""
    caches.clear_all()
    gc_collect(dev)
    if dev.type != "cuda":
        return 0
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info(dev)[0]


def n_params(cfg) -> int:
    """Parameters of a port ``Transformer`` of ``cfg``, from its shapes."""
    d, h = cfg.d_model, cfg.n_heads
    if cfg.mla is not None:
        m = cfg.mla
        attn = (d * h * (m.qk_nope_dim + m.qk_rope_dim)
                + d * (m.kv_lora_rank + m.qk_rope_dim)
                + m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)
                + h * m.v_head_dim * d)
    else:
        attn = 2 * d * h * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
        attn += (h + 2 * cfg.n_kv_heads) * cfg.hd if cfg.qkv_bias else 0
    norm = d * (2 if cfg.norm == "layernorm" else 1)

    def mlp(f):
        return 3 * d * f if cfg.act == "swiglu" else 2 * d * f + f + d

    head = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2) + norm
    if cfg.family == "ssm":
        xc = cfg.xlstm
        hd = xc.head_dim or d // h
        d_in, r = h * hd, xc.slstm_every
        mlstm = 4 * d * d_in + 2 * d * h + 2 * h + d_in + d_in * d + norm
        slstm = 4 * d * d_in + 4 * h * hd * hd + 5 * d_in + d_in * d + norm
        return head + cfg.n_layers // r * ((r - 1) * mlstm + slstm)
    if cfg.family == "hybrid":
        sc = cfg.ssm
        d_in = sc.expand * d
        nh, conv = d_in // sc.head_dim, d_in + 2 * sc.d_state
        ssm = (d * (conv + d_in + nh) + (sc.conv_width + 1) * conv
               + 3 * nh + d_in + d_in * d + norm)
        return (head + cfg.n_layers * ssm + attn + 2 * norm
                + mlp(cfg.d_ff))
    if cfg.family == "audio":
        enc = attn + 2 * norm + mlp(cfg.d_ff)
        dec = 2 * attn + 3 * norm + mlp(cfg.d_ff)
        return (head + cfg.n_enc_layers * enc + cfg.n_dec_layers * dec
                + norm + (cfg.d_frontend or d) * d)
    kd = T.n_dense_layers(cfg)
    total = kd * (attn + 2 * norm + mlp(cfg.d_ff)) + norm
    if cfg.moe is not None:
        mo = cfg.moe
        moe = mo.n_experts * (d + 3 * d * mo.d_ff_expert)
        moe += mlp(mo.d_ff_shared * mo.n_shared) if mo.n_shared else 0
        total += (cfg.n_layers - kd) * (attn + 2 * norm + moe)
    total += cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return total + (cfg.d_frontend * d if cfg.family == "vlm" else 0)


def fit_depth(cfg, free: int) -> int:
    """The most layers (at most the config's) whose f32 weights fit in
    ``free`` bytes beside ``LM_HEADROOM_BYTES``; every layer on the CPU."""
    if not free:
        return cfg.n_layers
    n = cfg.n_layers
    while n > 1 and 4 * n_params(cfg.replace(n_layers=n)) \
            + LM_HEADROOM_BYTES > free:
        n -= 1
    return n


def build_lm(cfg, dev, what: str):
    """A ``Transformer`` of ``cfg`` with random f32 weights from seed 0 on
    the device, its parameter count checked against ``n_params``."""
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    sync(dev)
    n = sum(p.numel() for p in model.parameters())
    check(n == n_params(cfg), f"{what}: {n} parameters, {n_params(cfg)} "
          f"from the config's shapes")
    print(f"{what}: {cfg.name} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, attn_impl={cfg.attn_impl} dtype={cfg.dtype}: "
          f"{n / 1e9:.3f} B parameters (f32, {4 * n / 1e9:.2f} GB) "
          f"initialised on the card from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    return model


def lm_tokens(cfg, shape, dev):
    return torch.randint(0, cfg.vocab_size, shape, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))


def normwise(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def logits_agree(what: str, got, want) -> float:
    """bf16 logits against another attention impl's on the same weights
    (and, in a MoE model, the same routing): within 5e-2 normwise and 10 %
    of max |logit|.  The impls round p at other places (block_masked to
    bf16, flash in two bf16 terms, dense not at all), and the flips
    compound through the layers' bf16 residual stream (phase 10 reads
    1.3e-2 between flash and dense at 16 layers); a lost tile or a wrong
    mask moves the logits by O(1)."""
    diff = (got.float() - want.float()).abs()
    rel = float(diff.norm() / want.float().norm())
    top = float(want.float().abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"{what}: max |diff| {float(diff.max()):.4g} (max |logit| "
          f"{top:.4g}), normwise {rel:.3g}, argmax agreement {agree:.4f}")
    check(rel <= 5e-2 and float(diff.max()) <= 0.1 * top,
          f"{what} within 5e-2 normwise and 10 % of max |logit|")
    return rel


def bm_counts():
    return A.BLOCK_MASKED_CALLS, A.BLOCK_MASKED_FALLBACKS


def bm_case(dev, what: str, b: int, hq: int, hkv: int, s: int, d: int,
            window: int, blk: int, dense: bool) -> dict:
    """One block_masked layer (bf16, causal): one call through the tile
    worklist (no fallback, no flash launch), within 1e-2 normwise of the
    flash kernel and, when ``dense``, of dense_masked in f32; its tiles
    against the dense grid's and the flash worklist's; its time beside the
    flash op and, with no window, causal SDPA."""
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = ((torch.randn(shape, generator=g, device=dev) * 0.5)
               .to(torch.bfloat16)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    kw = dict(causal=True, window=window, prefix=0)
    before = bm_counts()
    reset_counts()
    got = A.attention(q, k, v, impl="block_masked", block=blk, **kw)
    sync(dev)
    check(bm_counts() == (before[0] + 1, before[1]) and flash.LAUNCHES == 0,
          f"{what}: block_masked ran its tile worklist once, no dense "
          f"fallback and no flash launch")
    check(got.dtype == torch.bfloat16 and got.shape == q.shape,
          f"{what}: block_masked output bf16 of q's shape")
    out = {"flash_vs": normwise(got, flash_mask_attention(
        q, k, v, bq=blk, bk=blk, **kw))}
    if dense:
        out["dense_vs"] = normwise(got, A.dense_masked_attention(
            q.float(), k.float(), v.float(), **kw))
    for name, rel in out.items():
        check(rel <= 1e-2, f"{what}: block_masked within 1e-2 normwise of "
              f"{name.split('_')[0]} (got {rel:.3g})")
    _, _, _, _, valid, chunk = A._balanced_schedule(s, s, blk, blk, True,
                                                    window, 0, 0)
    tiles, grid = int(valid.sum()), (s // blk) ** 2
    pairs = len(flash.build_schedule(s, s, bq=blk, bk=blk, q_offset=0,
                                     **kw)[0])
    check(tiles == pairs, f"{what}: block_masked visits the flash "
          f"worklist's {pairs} tiles (got {tiles})")
    out.update(tiles=tiles, grid=grid, groups=int(valid.shape[0]),
               entries=int(valid.shape[1]), chunk=int(chunk))
    out["ms"] = device_ms(lambda: A.attention(q, k, v, impl="block_masked",
                                              block=blk, **kw),
                          dev, reps=5, warm=1)
    out["flash_ms"] = device_ms(lambda: flash_mask_attention(
        q, k, v, bq=blk, bk=blk, **kw), dev, reps=7, warm=2)
    out["library_ms"] = None if window else device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), dev, reps=7, warm=2)
    lib = ("" if out["library_ms"] is None else
           f", causal SDPA {out['library_ms']:.3f} ms")
    print(f"block_masked: {what} layer B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
          f"window {window} blocks {blk} bf16: {tiles} of the dense grid's "
          f"{grid} tiles ({tiles / grid:.1%}; {grid - tiles} saved) in "
          f"{out['groups']} folded groups of {out['entries']} entries, "
          f"chunk {chunk}; normwise from flash {out['flash_vs']:.3g}"
          + (f", from f32 dense_masked {out['dense_vs']:.3g}" if dense else "")
          + f" (limit 1e-2); block_masked {out['ms']:.3f} ms, flash op "
          f"{out['flash_ms']:.3f} ms ({out['ms'] / out['flash_ms']:.1f}x)"
          + lib)
    return out


def block_masked_layers(dev, smoke: bool = False) -> dict:
    """block_masked at llama3.2-1b's layer shape and at starcoder2-7b's
    (``smoke``: small shapes for a rehearsal on the CPU)."""
    cfg = get_config("llama3_2_1b")
    st = dict(STARCODER_LAYER)
    b, s, blk = LM_BATCH, LM_SEQ, cfg.attn_block
    if smoke:
        b, s, blk, st = 1, 128, 32, dict(b=1, hq=4, hkv=2, s=256, d=16,
                                          window=64)
    return {"llama": bm_case(dev, "llama3.2-1b", b, cfg.n_heads,
                             cfg.n_kv_heads, s, cfg.hd, 0, blk, True),
            "starcoder": bm_case(dev, "starcoder2-7b", st["b"], st["hq"],
                                 st["hkv"], st["s"], st["d"], st["window"],
                                 blk, False)}


def llama_block_masked(dev, flash_warm_ms: float, batch: int = LM_BATCH,
                       seq: int = LM_SEQ, smoke: bool = False) -> dict:
    """llama3.2-1b's published config (``attn_impl="block_masked"``) at full
    width: a bf16 prefill of ``batch`` x ``seq`` tokens on phase 10's weights
    and tokens, against phase 10's flash forward."""
    cfg = get_config("llama3_2_1b", smoke=smoke)
    check(cfg.attn_impl == "block_masked", "llama3.2-1b's published "
          "attn_impl is block_masked")
    cfg = cfg.replace(dtype="bfloat16")
    model = build_lm(cfg, dev, "llama-block-masked")
    batch_in = {"tokens": lm_tokens(cfg, (batch, seq), dev)}
    want = T.forward(model, cfg.replace(attn_impl="flash_pallas"), batch_in)
    before = bm_counts()
    reset_counts()
    got = T.forward(model, cfg, batch_in)
    sync(dev)
    check(bm_counts() == (before[0] + cfg.n_layers, before[1])
          and flash.LAUNCHES == 0, f"llama prefill ran block_masked once per "
          f"layer ({cfg.n_layers}), no fallback, no flash launch")
    check(got.shape == (batch, seq, cfg.vocab_size) and bool(
        torch.isfinite(got).all()), "llama block_masked logits finite")
    rel = logits_agree(f"llama-block-masked: prefill {batch}x{seq} vs the "
                       f"flash prefill", got, want)
    del got, want
    warm_ms = host_ms(lambda: T.forward(model, cfg, batch_in), dev, reps=3)
    print(f"llama-block-masked: prefill {batch}x{seq} bf16 warm "
          f"{warm_ms:.1f} ms ({batch * seq / (warm_ms / 1e3):.0f} tokens/s) "
          f"against the flash prefill's {flash_warm_ms:.1f} ms (phase 10)")
    del model
    return {"warm_ms": warm_ms, "flash_warm_ms": flash_warm_ms,
            "vs_flash": rel}


#: groups of the MoE prefill profile
MOE_PROFILE_GROUPS = ("expert matmuls", "router/sort/gather/combine",
                      "attention", "casts", "the rest")


def ranged_profile(run, dev, what: str, ranges, classify,
                   groups) -> dict:
    """Device time of one ``run()`` by group (``torch.profiler``): a range
    (``record_function``) is opened around each ``(owner, attribute,
    range name)`` of ``ranges`` for the call, and each kernel goes to the
    group ``classify(chain, op name)`` names, from the names of the ranges
    and ops it ran inside (innermost first) and its op's; returns the
    call's wall time under the profiler, the device's busy time, its idle
    share, the ms by group and the kernels launched."""
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in ranges]

    def ranged(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    for (owner, attr, fn), (_, _, name) in zip(saved, ranges):
        setattr(owner, attr, ranged(name, fn))
    try:
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    by = {g: [0.0, 0] for g in groups}
    for e in prof.events():
        if not e.kernels:
            continue
        chain, p = [], e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        group = classify(chain, e.name)
        for k in e.kernels:
            by[group][0] += k.duration / 1e3
            by[group][1] += 1
    busy = sum(ms for ms, _ in by.values())
    if not busy:
        print(f"{what}: profile: the profiler saw no device time (no CUPTI)")
        return {}
    idle = 1 - busy / wall_ms
    kernels = sum(n for _, n in by.values())
    print(f"{what}: profile of one warm run: wall {wall_ms:.1f} ms under "
          f"the profiler, device busy {busy:.1f} ms, idle share {idle:.1%}, "
          f"{kernels} kernels; by group: "
          + "; ".join(f"{g} {ms:.2f} ms {ms / busy:.1%} x{n}"
                      for g, (ms, n) in by.items()))
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": idle,
            "kernels": kernels, "groups": {g: ms for g, (ms, _) in by.items()}}


#: the ops of a product
PRODUCTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul")


def moe_profile(model, cfg, batch_in, dev, what: str) -> dict:
    """Device time of one warm prefill by group, with ranges around the
    port's ``attention``, ``MoE.forward``, ``MoE.route`` and
    ``MLP.forward``: a kernel goes to attention when its op ran inside
    attention, else to casts when inside a cast (``aten::_to_copy``), else
    to expert matmuls when it is a product inside the MoE layer (not the
    router's, not a shared expert's), else to router/sort/gather/combine
    when inside the MoE layer, else to the rest (projections, dense and
    shared MLPs, norms, logits)."""
    def classify(chain, name):
        if "smoke.attention" in chain:
            return "attention"
        if "aten::_to_copy" in chain:
            return "casts"
        if "smoke.mlp" in chain or "smoke.moe" not in chain:
            return "the rest"
        if name in PRODUCTS[:3] and "smoke.router" not in chain:
            return "expert matmuls"
        return "router/sort/gather/combine"

    return ranged_profile(
        lambda: T.forward(model, cfg, batch_in), dev, what,
        ((L, "attention", "smoke.attention"),
         (L.MoE, "forward", "smoke.moe"), (L.MoE, "route", "smoke.router"),
         (L.MLP, "forward", "smoke.mlp")), classify, MOE_PROFILE_GROUPS)


def decode_step_ms(model, cfg, tokens, batch: int, length: int, dev,
                   encoder_out=None) -> float:
    """Host milliseconds of one ``decode_step`` at batch ``batch`` over a
    cache of ``length`` slots: the mean of ``DECODE_STEPS`` steps after two
    warm ones, ended by a synchronise."""
    cache = T.init_cache(cfg, batch, length, device=dev)
    row = tokens[0]

    def step(t):
        T.decode_step(model, cfg, row[t].expand(batch), cache,
                      torch.full((batch,), t, dtype=torch.int32, device=dev),
                      encoder_out=encoder_out)
    for t in range(2):
        step(t)
    sync(dev)
    t0 = time.perf_counter()
    for t in range(2, 2 + DECODE_STEPS):
        step(t)
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / DECODE_STEPS


class routing_log:
    """Within the block, ``MoE.route`` appends each call's (weights,
    experts) to ``calls``; given ``replay`` (an earlier block's calls), it
    returns those instead, in call order, so a second forward routes every
    token as the first did."""

    def __init__(self, replay=None):
        self.replay = None if replay is None else iter(replay)
        self.calls = []

    def __enter__(self):
        self.saved = L.MoE.route

        def route(module, xt, cfg):
            if self.replay is not None:
                return next(self.replay)
            self.calls.append(self.saved(module, xt, cfg))
            return self.calls[-1]

        L.MoE.route = route
        return self

    def __exit__(self, *exc):
        L.MoE.route = self.saved


def moe_prefill(model, cfg, batch_in, dev, what: str):
    """One bf16 prefill of a MoE model under ``cfg.attn_impl``: its logits
    (checked finite, of the right shape and dtype) and its counts, the
    tokens each expert received and the peak memory."""
    moes = [blk.ffn for blk in model.blocks if isinstance(blk.ffn, L.MoE)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before, matmuls = bm_counts(), L.EXPERT_MATMULS
    reset_counts()
    t0 = time.perf_counter()
    logits = T.forward(model, cfg, batch_in)
    sync(dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    n_tok = batch_in["tokens"].numel()
    check(logits.shape == (1, n_tok, cfg.vocab_size)
          and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()),
          f"{what}: logits finite, bf16, of shape (1, {n_tok}, "
          f"{cfg.vocab_size})")
    sizes = [m.group_sizes for m in moes]
    check(all(sum(g) == n_tok * cfg.moe.top_k for g in sizes),
          f"{what}: every MoE layer routed {cfg.moe.top_k} experts a token")
    flat = [n for g in sizes for n in g]
    out = {"first_ms": first_ms, "moe_layers": len(moes),
           "tokens_per_expert": (min(flat), max(flat)),
           "expert_matmuls": L.EXPERT_MATMULS - matmuls,
           "host_reads": len(moes),
           "block_masked_calls": bm_counts()[0] - before[0],
           "fallbacks": bm_counts()[1] - before[1],
           "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                        if dev.type == "cuda" else 0.0)}
    check(out["expert_matmuls"] == 3 * sum(n > 0 for n in flat),
          f"{what}: three products per expert that received tokens")
    return out, logits


def deepseek_phase(dev, smoke: bool = False) -> dict:
    """deepseek-v2-lite-16b at full width and, where it fits, full depth:
    a bf16 block_masked prefill of 1 x 2,048 tokens, its profile, absorbed
    MLA decode and ``generate``; then f32 decode consistency at two layers
    and MLA's refusal of ``flash_pallas``."""
    what = "deepseek"
    cfg = get_config("deepseek_v2_lite_16b", smoke=smoke).replace(
        dtype="bfloat16")
    seq = 32 if smoke else DEEPSEEK_SEQ
    free = free_port_memory(dev)
    depth = fit_depth(cfg, free)
    print(f"{what}: {free / 2**30:.1f} GiB free on the card; full depth "
          f"{cfg.n_layers} layers = {4 * n_params(cfg) / 1e9:.2f} GB of f32 "
          f"weights; running {depth} layers"
          + ("" if depth == cfg.n_layers else
             f" (cut from {cfg.n_layers}: depth only, width kept)"))
    cfg = cfg.replace(n_layers=depth)
    model = build_lm(cfg, dev, what)
    batch_in = {"tokens": lm_tokens(cfg, (1, seq), dev)}
    out, logits = moe_prefill(model, cfg, batch_in, dev, what)
    check(out["block_masked_calls"] == cfg.n_layers and out["fallbacks"] == 0
          and flash.LAUNCHES == kernel.LAUNCHES == kernel.FUSED_LAUNCHES
          == kernel.MASKED_MATMUL_LAUNCHES == 0,
          f"{what}: block_masked once per layer ({cfg.n_layers}), no "
          f"fallback, no kernel launch")
    del logits
    out["warm_ms"] = host_ms(lambda: T.forward(model, cfg, batch_in), dev,
                             reps=3)
    print(f"{what}: prefill 1x{seq} bf16 block_masked: first "
          f"{out['first_ms']:.1f} ms, warm {out['warm_ms']:.1f} ms "
          f"({seq / (out['warm_ms'] / 1e3):.0f} tokens/s); peak memory "
          f"{out['peak_mib']:.0f} MiB; {out['moe_layers']} MoE layers: "
          f"tokens per expert min {out['tokens_per_expert'][0]} max "
          f"{out['tokens_per_expert'][1]} (of {seq * cfg.moe.top_k} "
          f"assignments a layer over {cfg.moe.n_experts} experts), "
          f"{out['expert_matmuls']} expert matmuls, {out['host_reads']} host "
          f"reads of the group sizes")
    out["profile"] = moe_profile(model, cfg, batch_in, dev, what)
    if out["profile"]:
        out["idle_share_warm"] = 1 - out["profile"]["busy_ms"] / out["warm_ms"]
        print(f"{what}: the profile's device busy time against the "
              f"unprofiled warm prefill ({out['warm_ms']:.1f} ms): idle share "
              f"{out['idle_share_warm']:.1%}")
    out["decode_ms"] = {bb: decode_step_ms(model, cfg, batch_in["tokens"],
                                           bb, seq, dev) for bb in (1, 4)}
    out["generate_ms"] = timed_generate(model, cfg,
                                        batch_in["tokens"][:, :16], dev, what)
    print(f"{what}: absorbed-MLA decode over a {seq}-slot latent cache "
          f"({cfg.mla.kv_lora_rank} + {cfg.mla.qk_rope_dim} per token): "
          f"{out['decode_ms'][1]:.2f} ms a step at B 1, "
          f"{out['decode_ms'][4]:.2f} at B 4; generate 16 + 16 tokens "
          f"{out['generate_ms']:.1f} ms "
          f"({16e3 / out['generate_ms']:.1f} new tokens/s)")
    del model
    free_port_memory(dev)

    # the reference's decode-consistency property in f32 at two layers
    # (one dense, one MoE) of full width
    f32 = cfg.replace(n_layers=2, dtype="float32")
    model = build_lm(f32, dev, f"{what}-f32")
    short = batch_in["tokens"][:, :32]
    err = out["decode_consistency"] = decode_consistency(model, f32, short,
                                                         dev, what)
    # MLA's q.k head dim (192) is not its v head dim (128), which the flash
    # op refuses before any launch, as the reference's does
    reset_counts()
    raised = None
    try:
        T.forward(model, f32.replace(attn_impl="flash_pallas"),
                  {"tokens": short})
    except ValueError as e:
        raised = str(e)
    check(raised is not None and flash.LAUNCHES == 0, f"{what}: MLA under "
          f"flash_pallas raises before any launch")
    print(f"{what}: f32 decode consistency at 2 layers, full width, 32 "
          f"tokens: max |prefill - decode| {err:.3g} (< 2e-2); MLA under "
          f"flash_pallas raises before any launch: {raised}")
    del model
    return out


def decode_consistency(model, f32, tokens, dev, what: str) -> float:
    """The reference's property in f32 (``tests/test_models.py``):
    teacher-forced ``decode_step`` over ``tokens`` (B, S) reproduces the
    f32 prefill's logits within 2e-2; returns the max |difference|."""
    want = T.forward(model, f32, {"tokens": tokens})
    cache = T.init_cache(f32, tokens.shape[0], tokens.shape[1], device=dev)
    steps = []
    for t in range(tokens.shape[1]):
        got, cache = T.decode_step(model, f32, tokens[:, t], cache,
                                   torch.full((tokens.shape[0],), t,
                                              dtype=torch.int32, device=dev))
        steps.append(got)
    err = float((torch.stack(steps, 1) - want).abs().max())
    check(err < 2e-2, f"{what}: f32 teacher-forced decode reproduces the "
          f"f32 prefill within 2e-2 (max err {err:.3g})")
    return err


def moonshot_phase(dev, smoke: bool = False):
    """moonshot-v1-16b-a3b at full width, depth cut to fit: a bf16 prefill
    under flash_pallas (the bf16 flash kernel once per layer at D 128, no
    plain version) against block_masked on the same weights, both timed,
    decode ms a step; then the flash kernel at this layer's shape against
    its plain version, beside causal SDPA and its bound.  Returns the
    phase's numbers and the kernel's JSON entry."""
    what = "moonshot"
    cfg = get_config("moonshot_v1_16b_a3b", smoke=smoke).replace(
        dtype="bfloat16")
    seq = 32 if smoke else LM_SEQ
    free = free_port_memory(dev)
    depth = min(cfg.n_layers if smoke else MOONSHOT_LAYERS,
                fit_depth(cfg, free))
    print(f"{what}: {free / 2**30:.1f} GiB free on the card; "
          f"{cfg.n_layers} layers = {4 * n_params(cfg) / 1e9:.2f} GB of f32 "
          f"weights; running {depth} of them (depth cut, width kept)")
    cfg = cfg.replace(n_layers=depth)
    model = build_lm(cfg, dev, what)
    batch_in = {"tokens": lm_tokens(cfg, (1, seq), dev)}
    fcfg = cfg.replace(attn_impl="flash_pallas")
    with count_plain(flash, ("flash_mask_plain",)) as plain, \
            routing_log() as log:
        out, flash_logits = moe_prefill(model, fcfg, batch_in, dev, what)
    launches = flash.LAUNCHES
    check(launches == flash.TC_LAUNCHES == cfg.n_layers
          and flash.F32_LAUNCHES == 0 and plain.calls == 0
          and out["block_masked_calls"] == 0,
          f"{what}: the bf16 flash kernel launched once per layer "
          f"({cfg.n_layers}) and no plain version ran (got {launches} "
          f"launches, {plain.calls} plain calls)")
    check(flash.SM90_LAUNCHES == sm90_expected(cfg, seq, launches),
          f"{what}: every bf16 flash launch ran the Hopper kernel "
          f"(SM90_LAUNCHES {flash.SM90_LAUNCHES} of {launches})")
    out["flash_launches"] = launches
    # block_masked on the same weights, every token routed as the flash
    # run routed it: a token at a router's near-tie would otherwise move to
    # other experts under the impls' bf16 differences (an O(1) change of
    # its logits, which the f32 comparison below counts)
    with routing_log(replay=log.calls):
        blocked, logits = moe_prefill(model, cfg, batch_in, dev,
                                      f"{what} (block_masked)")
    check(blocked["block_masked_calls"] == cfg.n_layers
          and blocked["fallbacks"] == 0 and flash.LAUNCHES == 0,
          f"{what}: block_masked once per layer, no flash launch")
    out["vs_block_masked"] = logits_agree(
        f"{what}: flash_pallas prefill vs block_masked with its routing",
        flash_logits, logits)
    del flash_logits, logits, log
    # in f32 the impls differ only in summation order, but a token whose
    # router sees a near-tie may still pick other experts; with the
    # block_masked run's routing replayed into the flash run, what is left
    # is the attention: the f32 flash instance (D 128) against block_masked
    f32 = cfg.replace(dtype="float32")
    moes = [blk.ffn for blk in model.blocks if isinstance(blk.ffn, L.MoE)]
    with routing_log() as log:
        want = T.forward(model, f32, batch_in)
    sizes = [list(m.group_sizes) for m in moes]
    reset_counts()
    free_run = T.forward(model, f32.replace(attn_impl="flash_pallas"),
                         batch_in)
    sync(dev)
    check(flash.F32_LAUNCHES == flash.LAUNCHES == cfg.n_layers
          and flash.SM90_LAUNCHES == sm90_expected(cfg, seq, cfg.n_layers,
                                                   torch.float32),
          f"{what}: f32 prefill runs the f32 flash kernel once per layer, "
          f"each launch the Hopper one where it takes the shape (got "
          f"{flash.F32_LAUNCHES} f32 and {flash.SM90_LAUNCHES} sm90 of "
          f"{flash.LAUNCHES})")
    moved = [i for i, m in enumerate(moes) if m.group_sizes != sizes[i]]
    free_rel = normwise(free_run, want)
    del free_run
    with routing_log(replay=log.calls):
        got = T.forward(model, f32.replace(attn_impl="flash_pallas"),
                        batch_in)
    diff = (got - want).abs()
    out["f32_vs_block_masked"] = float(diff.norm() / want.norm())
    out["f32_free_vs_block_masked"] = free_rel
    out["f32_layers_routed_apart"] = len(moved)
    print(f"{what}: f32 prefill 1x{seq}, flash_pallas vs block_masked: "
          f"{len(moved)} of {len(moes)} MoE layers route differently "
          f"(first: MoE layer {moved[0] if moved else None}), normwise "
          f"{free_rel:.3g}; with block_masked's routing replayed: max |diff| "
          f"{float(diff.max()):.3g} (max |logit| "
          f"{float(want.abs().max()):.4g}), normwise "
          f"{out['f32_vs_block_masked']:.3g}")
    check(out["f32_vs_block_masked"] <= 1e-4 and float(diff.max()) <= 1e-3,
          f"{what}: f32 flash prefill with block_masked's routing within 1e-4 "
          f"normwise and 1e-3 of block_masked")
    del got, want, diff, log
    out["flash_warm_ms"] = host_ms(lambda: T.forward(model, fcfg, batch_in),
                                   dev, reps=3)
    out["block_warm_ms"] = host_ms(lambda: T.forward(model, cfg, batch_in),
                                   dev, reps=3)
    out["decode_ms"] = decode_step_ms(model, fcfg, batch_in["tokens"], 1,
                                      seq, dev)
    flash_tok_s = seq / (out["flash_warm_ms"] / 1e3)
    print(f"{what}: prefill 1x{seq} bf16: flash_pallas warm "
          f"{out['flash_warm_ms']:.1f} ms ({flash_tok_s:.0f} tokens/s), "
          f"block_masked {out['block_warm_ms']:.1f} ms "
          f"({seq / (out['block_warm_ms'] / 1e3):.0f} tokens/s); peak memory "
          f"{out['peak_mib']:.0f} MiB; tokens per expert min "
          f"{out['tokens_per_expert'][0]} max {out['tokens_per_expert'][1]}, "
          f"{out['expert_matmuls']} expert matmuls; decode "
          f"{out['decode_ms']:.2f} ms a step at B 1")
    del model
    free_port_memory(dev)

    # the kernel at this layer's shape: B 1, 16/16 heads, S, D 128
    entry = flash_path_layer(
        dev, what, "flash_mask (moonshot-v1-16b-a3b layer, D 128)",
        cfg.n_heads, cfg.n_kv_heads, seq, cfg.hd, min(cfg.attn_block, seq),
        causal=True, launches=launches)
    return out, entry


def flash_path_layer(dev, what: str, name: str, hq: int, hkv: int, s: int,
                     d: int, blk: int, causal: bool, launches: int) -> dict:
    """The bf16 flash kernel at a model layer's shape (B 1, 0.5 randn from
    seed 7): against its plain version (rtol 1e-2, atol 1e-3, 2e-3
    normwise), its time beside the plain version, ``scaled_dot_product_
    attention`` under the same mask (causal or none) and its bound at the
    allowed elements.  Returns the layer's JSON entry with ``launches``
    (the main path's)."""
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = ((torch.randn(shape, generator=g, device=dev) * 0.5)
               .to(torch.bfloat16)
               for shape in ((1, hq, s, d), (1, hkv, s, d), (1, hkv, s, d)))
    pattern = FLASH_PATTERNS[0] if causal else FLASH_PATTERNS[3]
    sched = [torch.as_tensor(x, device=dev) for x in flash.build_schedule(
        s, s, bq=blk, bk=blk, q_offset=0, **pattern)]
    pairs = int(sched[0].shape[0])
    err, rel = flash_compare(q, k, v, bq=blk, bk=blk, q_offset=0, tol=1e-2,
                             atol=1e-3, normwise=2e-3, **pattern)
    kw = dict(bq=blk, bk=blk, scale=d ** -0.5, q_offset=0, **pattern)
    kernel_ms, mma_sync_ms = sm90_and_mma_sync_ms(q, k, v, sched, kw, dev)
    plain_ms = device_ms(lambda: flash.flash_mask_plain(q, k, v, *sched,
                                                        **kw),
                         dev, reps=3, warm=1)
    library_ms = chained_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=hq != hkv), dev)
    allowed = int(mask_allowed(s, s, q_offset=0, **pattern).sum())
    flops = 4.0 * hq * allowed * d
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + 12 * pairs
    bound_ms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    mask = "causal" if causal else "non-causal"
    print(f"{what}: flash kernel at the layer's shape B=1 Hq={hq} Hkv={hkv} "
          f"S={s} D={d} blocks {blk} {mask} bf16 ({pairs} tiles): vs plain "
          f"max |diff| {err:.3g}, normwise {rel:.3g} (limits rtol 1e-2, atol "
          f"1e-3, 2e-3 normwise); kernel (sm90) {kernel_ms:.3f} ms "
          f"({flops / kernel_ms / 1e9:.1f} TFLOP/s; the mma.sync kernel in "
          f"this run {mma_sync_ms:.3f} ms); plain {plain_ms:.3f} "
          f"ms; library ({mask} SDPA) {library_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms (by {by}); kernel at {bound_ms / kernel_ms:.2%} "
          f"of it")
    del q, k, v
    return {"name": name, "route": "cuda", "source": SM90_SOURCE,
            "replaces": "src/repro/kernels/flash_mask/kernel.py:121",
            "launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "mma_sync_ms": mma_sync_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms, "design": SM90_DESIGN,
            "sm90_instance": sm90_instance(d)}


def internvl_phase(dev, smoke: bool = False) -> dict:
    """internvl2-2b at full width under block_masked with its image prefix
    (256 patches + 1,792 tokens): logits against dense_masked on the same
    weights (both honour the prefix-LM rule), overall and over the prefix's
    rows, where flash_pallas (no prefix rule) is far off."""
    what = "internvl"
    cfg = get_config("internvl2_2b", smoke=smoke).replace(dtype="bfloat16")
    text = 16 if smoke else INTERNVL_TEXT
    free_port_memory(dev)
    model = build_lm(cfg, dev, what)
    g = torch.Generator(device=dev).manual_seed(2)
    batch_in = {"tokens": lm_tokens(cfg, (1, text), dev),
                "patches": torch.randn((1, cfg.img_tokens, cfg.d_frontend),
                                       generator=g, device=dev) * 0.2}
    p = cfg.img_tokens
    before = bm_counts()
    reset_counts()
    got = T.forward(model, cfg, batch_in)
    sync(dev)
    check(bm_counts() == (before[0] + cfg.n_layers, before[1])
          and flash.LAUNCHES == 0, f"{what}: block_masked once per layer "
          f"({cfg.n_layers}), no fallback, no flash launch")
    check(got.shape == (1, p + text, cfg.vocab_size) and bool(
        torch.isfinite(got).all()), f"{what}: logits finite, of shape "
          f"(1, {p + text}, {cfg.vocab_size})")
    dense = T.forward(model, cfg.replace(attn_impl="dense_masked"), batch_in)
    rel = logits_agree(f"{what}: prefill {p} + {text} vs dense_masked", got,
                       dense)
    rel_prefix = normwise(got[:, :p], dense[:, :p])
    causal = T.forward(model, cfg.replace(attn_impl="flash_pallas"),
                       batch_in)
    rel_causal = normwise(causal[:, :p], dense[:, :p])
    check(rel_prefix <= 5e-2 and rel_causal >= 10 * rel_prefix,
          f"{what}: the prefix's rows within 5e-2 normwise of dense_masked "
          f"(got {rel_prefix:.3g}), ten times closer than a causal-only "
          f"prefix ({rel_causal:.3g})")
    del causal, dense, got
    warm_ms = host_ms(lambda: T.forward(model, cfg, batch_in), dev, reps=3)
    print(f"{what}: the image prefix's rows vs dense_masked normwise "
          f"{rel_prefix:.3g} (a causal-only prefix, flash_pallas: "
          f"{rel_causal:.3g}); prefill {p} + {text} bf16 block_masked warm "
          f"{warm_ms:.1f} ms ({(p + text) / (warm_ms / 1e3):.0f} tokens/s)")
    del model
    return {"vs_dense": rel, "prefix_vs_dense": rel_prefix,
            "causal_prefix_vs_dense": rel_causal, "warm_ms": warm_ms}


def families_phase(dev, flash_warm_ms: float):
    """Phase 14; returns its numbers and the moonshot flash entry."""
    free = free_port_memory(dev)
    print(f"families: {free / 2**30:.1f} GiB free after clearing every port "
          f"cache")
    out = {"block_masked": block_masked_layers(dev),
           "llama": llama_block_masked(dev, flash_warm_ms),
           "deepseek": deepseek_phase(dev)}
    out["moonshot"], entry = moonshot_phase(dev)
    out["internvl"] = internvl_phase(dev)
    free_port_memory(dev)
    return out, entry


# ---------------------------------------------------------------------------
# Phase 15: the xLSTM, hybrid (Zamba2) and encoder-decoder families
# ---------------------------------------------------------------------------


#: the phase's prefill: 1 x 2,048 tokens (and 2,048 frames for seamless,
#: which the reference's ``concrete_batch`` makes as long as the tokens)
FAMILIES2_SEQ = 2048
#: zamba2-7b's long decode cache: decode_32k's length
ZAMBA_LONG_CACHE = 32768
#: tokens of the f32 decode-vs-prefill checks
CONSISTENCY_TOKENS = 64
#: groups of the hybrid prefill's profile
HYBRID_PROFILE_GROUPS = ("projections", "SSD intra-chunk",
                         "chunk states and recurrence", "conv", "attention",
                         "casts", "the rest")


class flash_log:
    """Within the block, record the ``causal`` flag of every call the
    attention op makes of the flash kernel's wrapper."""

    def __enter__(self):
        self.causal = []
        self.saved = flash_ops.flash_mask_kernel

        def call(*args, **kw):
            self.causal.append(bool(kw["causal"]))
            return self.saved(*args, **kw)

        flash_ops.flash_mask_kernel = call
        return self

    def __exit__(self, *exc):
        flash_ops.flash_mask_kernel = self.saved


def device_profile(run, dev, what: str) -> dict:
    """The kernels one ``run()`` launches and their device time
    (``torch.profiler`` tracing the device only: no op tree to build, so
    a prefill of hundreds of thousands of launches stays cheap to read),
    and the device's idle share of the call's wall time under the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        print(f"{what}: profile: no device to trace")
        return {}
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if not busy:
        print(f"{what}: profile: the profiler saw no device time (no CUPTI)")
        return {}
    out = {"wall_ms": wall_ms, "busy_ms": busy,
           "idle_share": 1 - busy / wall_ms, "kernels": len(kernels)}
    print(f"{what}: device profile of one warm run: wall {wall_ms:.1f} "
          f"ms under the profiler, device busy {busy:.1f} ms, idle share "
          f"{out['idle_share']:.1%}, {len(kernels)} kernels")
    return out


def family_prefill(model, cfg, batch_in, dev, what: str):
    """One bf16 prefill under ``cfg.attn_impl``: its logits (checked
    finite, bf16, of shape (1, S, V)) and its first call's ms, counts
    (block_masked calls and dense fallbacks, flash launches; no masked
    product) and peak memory."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = bm_counts()
    reset_counts()
    t0 = time.perf_counter()
    logits = T.forward(model, cfg, batch_in)
    sync(dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    seq = batch_in["tokens"].shape[1]
    check(logits.shape == (1, seq, cfg.vocab_size)
          and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()),
          f"{what}: logits finite, bf16, of shape (1, {seq}, "
          f"{cfg.vocab_size})")
    check(kernel.LAUNCHES == kernel.FUSED_LAUNCHES
          == kernel.MASKED_MATMUL_LAUNCHES == 0,
          f"{what}: the prefill launches no masked product")
    return {"first_ms": first_ms,
            "block_masked_calls": bm_counts()[0] - before[0],
            "fallbacks": bm_counts()[1] - before[1],
            "flash_launches": flash.LAUNCHES,
            "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                         if dev.type == "cuda" else 0.0)}, logits


def timed_generate(model, cfg, prompt, dev, what: str,
                   encoder_out=None) -> float:
    """Milliseconds of ``generate`` of 16 tokens after ``prompt`` (after a
    short warm-up), checked to keep the prompt and stay in the
    vocabulary."""
    generate(model, cfg, prompt, max_new=2, encoder_out=encoder_out)
    sync(dev)
    t0 = time.perf_counter()
    gen = generate(model, cfg, prompt, max_new=16, encoder_out=encoder_out)
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    b, s0 = prompt.shape
    check(gen.shape == (b, s0 + 16)
          and torch.equal(gen[:, :s0], prompt.to(torch.int32))
          and bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
          f"{what}: generate keeps the prompt and adds 16 tokens")
    return ms


def print_prefill(what: str, cfg, out: dict, seq: int) -> None:
    print(f"{what}: prefill 1x{seq} bf16 {cfg.attn_impl}: first "
          f"{out['first_ms']:.1f} ms, warm {out['warm_ms']:.1f} ms "
          f"({seq / (out['warm_ms'] / 1e3):.0f} tokens/s); peak memory "
          f"{out['peak_mib']:.0f} MiB; block_masked calls "
          f"{out['block_masked_calls']}, dense fallbacks {out['fallbacks']}, "
          f"flash launches {out['flash_launches']}")


def idle_against_warm(out: dict, what: str) -> None:
    """The profile's device busy time against the unprofiled warm call
    (a prefill, a training step): the idle share a user's call sees."""
    if out["profile"]:
        out["idle_share_warm"] = 1 - out["profile"]["busy_ms"] / out[
            "warm_ms"]
        print(f"{what}: the profile's device busy time against the "
              f"unprofiled warm call ({out['warm_ms']:.1f} ms): idle "
              f"share {out['idle_share_warm']:.1%}")


def flash_agreement(model, cfg, batch_in, flash_logits, logits, dev,
                    what: str, launches: int) -> dict:
    """flash_pallas against block_masked on the same weights and inputs.
    In bf16 every pair of impls parts by the rounding noise the model's
    depth amplifies (they round p at other places), so the floor is
    measured: dense_masked against block_masked; flash must lie within
    5e-2 normwise of block_masked, or within 1.5 times that floor where
    the floor itself exceeds 5e-2.  In f32 the impls differ only in
    summation order: the f32 flash instance (``launches`` launches) must
    lie within 1e-4 normwise and 1e-3 of block_masked, where a lost tile
    or a wrong mask moves the logits by O(1); every launch at a shape the
    f32 Hopper kernel takes must have run it."""
    dense = T.forward(model, cfg.replace(attn_impl="dense_masked"),
                      batch_in)
    out = {"vs_block_masked": normwise(flash_logits, logits),
           "dense_vs_block_masked": normwise(dense, logits)}
    del dense
    limit = max(5e-2, 1.5 * out["dense_vs_block_masked"])
    top = float(logits.float().abs().max())
    diff = float((flash_logits.float() - logits.float()).abs().max())
    agree = float((flash_logits.argmax(-1) == logits.argmax(-1)).float()
                  .mean())
    print(f"{what}: bf16 logits, flash_pallas vs block_masked: normwise "
          f"{out['vs_block_masked']:.4g}, max |diff| {diff:.4g} (max |logit| "
          f"{top:.4g}), argmax agreement {agree:.4f}; dense_masked vs "
          f"block_masked (the bf16 floor) {out['dense_vs_block_masked']:.4g}"
          f"; limit {limit:.3g}")
    check(out["vs_block_masked"] <= limit, f"{what}: bf16 flash prefill "
          f"within {limit:.3g} normwise of block_masked")
    f32 = cfg.replace(dtype="float32")
    want = T.forward(model, f32, batch_in)
    reset_counts()
    got = T.forward(model, f32.replace(attn_impl="flash_pallas"), batch_in)
    sync(dev)
    sm90 = sm90_expected(cfg, batch_in["tokens"].shape[1], launches,
                         torch.float32)
    check(flash.F32_LAUNCHES == flash.LAUNCHES == launches
          and flash.SM90_LAUNCHES == sm90,
          f"{what}: the f32 prefill runs the f32 flash kernel {launches} "
          f"times, {sm90} of them on the Hopper one (got "
          f"{flash.F32_LAUNCHES} f32 and {flash.SM90_LAUNCHES} sm90 of "
          f"{flash.LAUNCHES})")
    out["f32_vs_block_masked"] = normwise(got, want)
    out["f32_max_diff"] = float((got - want).abs().max())
    print(f"{what}: f32 logits, flash_pallas vs block_masked: normwise "
          f"{out['f32_vs_block_masked']:.3g}, max |diff| "
          f"{out['f32_max_diff']:.3g} (max |logit| "
          f"{float(want.abs().max()):.4g}); limits 1e-4 and 1e-3")
    check(out["f32_vs_block_masked"] <= 1e-4 and out["f32_max_diff"] <= 1e-3,
          f"{what}: f32 flash prefill within 1e-4 normwise and 1e-3 of "
          f"block_masked")
    return out


def zamba_phase(dev, smoke: bool = False):
    """zamba2-7b at full width and depth (81 Mamba2 blocks and 13
    applications of one shared attention block, D 112): a bf16 prefill
    of 1 x 2,048 under the published block_masked (13 worklist calls) and
    under flash_pallas (13 launches of the bf16 kernel, no plain version),
    held to each other as ``flash_agreement`` says; the profile by group;
    decode ms a
    step over 2,048 and 32,768 slots; ``generate``; the f32
    decode-vs-prefill check over 64 tokens; the kernel at the shared
    block's shape.  Returns the phase's numbers and the kernel's JSON
    entry."""
    what = "zamba2"
    cfg = get_config("zamba2_7b", smoke=smoke).replace(dtype="bfloat16")
    seq = 64 if smoke else FAMILIES2_SEQ
    free = free_port_memory(dev)
    depth = fit_depth(cfg, free)
    print(f"{what}: {free / 2**30:.1f} GiB free on the card; full depth "
          f"{cfg.n_layers} layers = {4 * n_params(cfg) / 1e9:.2f} GB of f32 "
          f"weights; running {depth} layers"
          + ("" if depth == cfg.n_layers else
             f" (cut from {cfg.n_layers}: depth only, width kept)"))
    cfg = cfg.replace(n_layers=depth)
    model = build_lm(cfg, dev, what)
    batch_in = {"tokens": lm_tokens(cfg, (1, seq), dev)}
    n_attn = T.n_shared_attn(cfg)
    out, logits = family_prefill(model, cfg, batch_in, dev, what)
    check(out["block_masked_calls"] == n_attn and out["fallbacks"] == 0
          and out["flash_launches"] == 0, f"{what}: block_masked once per "
          f"shared-block application ({n_attn}), no fallback, no flash "
          f"launch")
    out["warm_ms"] = host_ms(lambda: T.forward(model, cfg, batch_in), dev,
                             reps=3)
    print_prefill(what, cfg, out, seq)
    out["profile"] = ranged_profile(
        lambda: T.forward(model, cfg, batch_in), dev, what,
        ((L, "attention", "smoke.attention"),
         (SSD, "_ssd_intra", "smoke.ssd_intra"),
         (SSD, "_ssd_inter", "smoke.ssd_inter"),
         (SSD, "_causal_conv", "smoke.conv")),
        lambda chain, name: next(
            (g for key, g in (("smoke.attention", "attention"),
                              ("smoke.ssd_intra", "SSD intra-chunk"),
                              ("smoke.ssd_inter",
                               "chunk states and recurrence"),
                              ("smoke.conv", "conv"),
                              ("aten::_to_copy", "casts"))
             if key in chain),
            "projections" if name in PRODUCTS else "the rest"),
        HYBRID_PROFILE_GROUPS)
    idle_against_warm(out, what)

    fcfg = cfg.replace(attn_impl="flash_pallas")
    with count_plain(flash, ("flash_mask_plain",)) as plain:
        flashed, flash_logits = family_prefill(model, fcfg, batch_in, dev,
                                               f"{what} (flash_pallas)")
    launches = flashed["flash_launches"]
    check(launches == flash.TC_LAUNCHES == n_attn
          and flash.F32_LAUNCHES == 0 and plain.calls == 0
          and flashed["block_masked_calls"] == 0,
          f"{what}: the bf16 flash kernel launched once per shared-block "
          f"application ({n_attn}) and no plain version ran (got "
          f"{launches} launches, {plain.calls} plain calls)")
    check(flash.SM90_LAUNCHES == sm90_expected(cfg, seq, launches),
          f"{what}: every bf16 flash launch ran the Hopper kernel "
          f"(SM90_LAUNCHES {flash.SM90_LAUNCHES} of {launches})")
    out["flash_launches"] = launches
    out.update(flash_agreement(model, cfg, batch_in, flash_logits, logits,
                               dev, what, n_attn))
    del logits, flash_logits
    out["flash_warm_ms"] = host_ms(lambda: T.forward(model, fcfg, batch_in),
                                   dev, reps=3)
    long = 128 if smoke else ZAMBA_LONG_CACHE
    out["decode_ms"] = {n: decode_step_ms(model, cfg, batch_in["tokens"], 1,
                                          n, dev) for n in (seq, long)}
    out["generate_ms"] = timed_generate(model, cfg,
                                        batch_in["tokens"][:, :16], dev, what)
    out["decode_consistency"] = decode_consistency(
        model, cfg.replace(dtype="float32"),
        batch_in["tokens"][:, :CONSISTENCY_TOKENS], dev, what)
    print(f"{what}: prefill under flash_pallas warm "
          f"{out['flash_warm_ms']:.1f} ms "
          f"({seq / (out['flash_warm_ms'] / 1e3):.0f} tokens/s), {launches} "
          f"launches at D {cfg.hd}; decode at B 1 "
          f"{out['decode_ms'][seq]:.2f} ms a step over {seq} slots, "
          f"{out['decode_ms'][long]:.2f} over {long} ({n_attn} KV caches; "
          f"the SSM state is O(1)); generate 16 + 16 tokens "
          f"{out['generate_ms']:.1f} ms; f32 decode consistency at "
          f"{cfg.n_layers} layers over {CONSISTENCY_TOKENS} tokens: max "
          f"|prefill - decode| {out['decode_consistency']:.3g} (< 2e-2)")
    del model
    free_port_memory(dev)
    entry = flash_path_layer(
        dev, what, "flash_mask (zamba2-7b shared attention, D 112)",
        cfg.n_heads, cfg.n_kv_heads, seq, cfg.hd, min(cfg.attn_block, seq),
        causal=True, launches=launches)
    return out, entry


def xlstm_phase(dev, smoke: bool = False) -> dict:
    """xlstm-1.3b at full width and depth (6 super-blocks of 7 mLSTM and
    one sLSTM block): a bf16 prefill of 1 x 2,048 (no attention, no
    kernel of the port), its device profile (kernels launched, idle
    share), decode ms a step, ``generate`` and the f32 decode-vs-prefill
    check over 64 tokens.  The sLSTM's per-token loop is the reference's
    recurrence, one cell step after another."""
    what = "xlstm"
    cfg = get_config("xlstm_1_3b", smoke=smoke).replace(dtype="bfloat16")
    seq = 64 if smoke else FAMILIES2_SEQ
    free = free_port_memory(dev)
    depth = fit_depth(cfg, free)
    check(depth == cfg.n_layers, f"{what}: full depth fits")
    model = build_lm(cfg, dev, what)
    batch_in = {"tokens": lm_tokens(cfg, (1, seq), dev)}
    out, logits = family_prefill(model, cfg, batch_in, dev, what)
    del logits
    check(out["block_masked_calls"] == out["fallbacks"]
          == out["flash_launches"] == 0, f"{what}: no attention")
    out["warm_ms"] = host_ms(lambda: T.forward(model, cfg, batch_in), dev,
                             reps=1)
    print_prefill(what, cfg, out, seq)
    r = cfg.xlstm.slstm_every
    out["slstm_steps"] = cfg.n_layers // r * seq
    out["profile"] = device_profile(lambda: T.forward(model, cfg, batch_in),
                                    dev, what)
    idle_against_warm(out, what)
    out["decode_ms"] = decode_step_ms(model, cfg, batch_in["tokens"], 1, seq,
                                      dev)
    out["generate_ms"] = timed_generate(model, cfg,
                                        batch_in["tokens"][:, :16], dev, what)
    out["decode_consistency"] = decode_consistency(
        model, cfg.replace(dtype="float32"),
        batch_in["tokens"][:, :CONSISTENCY_TOKENS], dev, what)
    print(f"{what}: {cfg.n_layers // r} sLSTM blocks run "
          f"{out['slstm_steps']} sequential cell steps a prefill; decode "
          f"{out['decode_ms']:.2f} ms a step at B 1; generate 16 + 16 "
          f"tokens {out['generate_ms']:.1f} ms; f32 decode consistency "
          f"over {CONSISTENCY_TOKENS} tokens: max |prefill - decode| "
          f"{out['decode_consistency']:.3g} (< 2e-2)")
    del model
    return out


def seamless_phase(dev, smoke: bool = False):
    """seamless-m4t-large-v2 at full width and depth (24 encoder and 24
    decoder layers): frames 1 x 2,048 x 1,024 and tokens 1 x 2,048; a
    bf16 prefill under block_masked (24 causal worklist calls in the
    decoder, the encoder's 24 bidirectional layers on the dense path) and
    under flash_pallas (24 non-causal encoder and 24 causal decoder
    launches, no plain version), held to each other as
    ``flash_agreement`` says; the
    encoder output computed once, decode ms a step with cross-attention
    over it and ``generate``; the kernel at the encoder's shape.  Returns
    the phase's numbers and the kernel's JSON entry."""
    what = "seamless"
    cfg = get_config("seamless_m4t_large_v2", smoke=smoke).replace(
        dtype="bfloat16")
    seq = 64 if smoke else FAMILIES2_SEQ
    free = free_port_memory(dev)
    check(fit_depth(cfg, free) == cfg.n_layers, f"{what}: full depth fits")
    model = build_lm(cfg, dev, what)
    g = torch.Generator(device=dev).manual_seed(2)
    batch_in = {"tokens": lm_tokens(cfg, (1, seq), dev),
                "frames": torch.randn((1, seq, cfg.d_frontend), generator=g,
                                      device=dev) * 0.2}
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_dec_layers
    out, logits = family_prefill(model, cfg, batch_in, dev, what)
    check(out["block_masked_calls"] == n_dec and out["fallbacks"] == n_enc
          and out["flash_launches"] == 0, f"{what}: block_masked's worklist "
          f"once per decoder layer ({n_dec}), the dense path once per "
          f"bidirectional encoder layer ({n_enc}), no flash launch")
    out["warm_ms"] = host_ms(lambda: T.forward(model, cfg, batch_in), dev,
                             reps=3)
    print_prefill(what, cfg, out, seq)
    fcfg = cfg.replace(attn_impl="flash_pallas")
    with flash_log() as log, \
            count_plain(flash, ("flash_mask_plain",)) as plain:
        flashed, flash_logits = family_prefill(model, fcfg, batch_in, dev,
                                               f"{what} (flash_pallas)")
    launches = flashed["flash_launches"]
    check(log.causal == [False] * n_enc + [True] * n_dec
          and launches == flash.TC_LAUNCHES == n_enc + n_dec
          and flash.F32_LAUNCHES == 0 and plain.calls == 0
          and flashed["block_masked_calls"] == flashed["fallbacks"] == 0,
          f"{what}: the bf16 flash kernel launched {n_enc} times non-causal "
          f"(encoder) then {n_dec} times causal (decoder), no plain version "
          f"(got {launches} launches, {plain.calls} plain calls)")
    check(flash.SM90_LAUNCHES == sm90_expected(cfg, seq, launches),
          f"{what}: every bf16 flash launch ran the Hopper kernel "
          f"(SM90_LAUNCHES {flash.SM90_LAUNCHES} of {launches})")
    out["flash_launches"] = launches
    out.update(flash_agreement(model, cfg, batch_in, flash_logits, logits,
                               dev, what, n_enc + n_dec))
    del logits, flash_logits
    out["flash_warm_ms"] = host_ms(lambda: T.forward(model, fcfg, batch_in),
                                   dev, reps=3)
    enc = model.encode(batch_in["frames"], cfg)
    out["encode_ms"] = host_ms(lambda: model.encode(batch_in["frames"], cfg),
                               dev, reps=3)
    out["decode_ms"] = decode_step_ms(model, cfg, batch_in["tokens"], 1, seq,
                                      dev, encoder_out=enc)
    out["generate_ms"] = timed_generate(model, cfg,
                                        batch_in["tokens"][:, :16], dev, what,
                                        encoder_out=enc)
    print(f"{what}: prefill under flash_pallas warm "
          f"{out['flash_warm_ms']:.1f} ms "
          f"({seq / (out['flash_warm_ms'] / 1e3):.0f} tokens/s); the encoder "
          f"alone {out['encode_ms']:.1f} ms, computed once; decode at B 1 "
          f"with cross-attention over {seq} encoder positions "
          f"{out['decode_ms']:.2f} ms a step; generate 16 + 16 tokens "
          f"{out['generate_ms']:.1f} ms")
    del model, enc
    free_port_memory(dev)
    entry = flash_path_layer(
        dev, what, "flash_mask (seamless-m4t-large-v2 encoder, D 64, "
        "non-causal)", cfg.n_heads, cfg.n_kv_heads, seq, cfg.hd,
        min(cfg.attn_block, seq), causal=False, launches=launches)
    entry["launches_noncausal"], entry["launches_causal"] = n_enc, n_dec
    return out, entry


def families2_phase(dev):
    """Phase 15; returns its numbers and the flash kernel's entries at the
    zamba2 and seamless shapes."""
    free = free_port_memory(dev)
    print(f"families II: {free / 2**30:.1f} GiB free after clearing every "
          f"port cache")
    out, t0 = {}, time.perf_counter()
    out["zamba2"], zamba_entry = zamba_phase(dev)
    t1 = time.perf_counter()
    out["xlstm"] = xlstm_phase(dev)
    t2 = time.perf_counter()
    out["seamless"], seamless_entry = seamless_phase(dev)
    t3 = time.perf_counter()
    print(f"families II: zamba2 {t1 - t0:.1f} s, xlstm {t2 - t1:.1f} s, "
          f"seamless {t3 - t2:.1f} s")
    free_port_memory(dev)
    zamba_entry["families_ii"] = out
    return zamba_entry, seamless_entry


# ---------------------------------------------------------------------------
# Phase 16: training
# ---------------------------------------------------------------------------

#: the llama-train cell: llama3.2-1b's published config (bf16 activations,
#: f32 masters, remat "full", block_masked, tied embeddings), 4 x 2,048
#: tokens a step from SyntheticLM(seed 0), AdamW(3e-4, warmup 2, 8 steps)
TRAIN_BATCH = 4
TRAIN_SEQ = 2048
TRAIN_TIMED_STEPS = 4
#: the f32 checks: llama3.2-1b at full width and 2 of 16 layers
TRAIN_CUT_LAYERS = 2
TRAIN_CUT_SEQ = 256
#: llama-train's profile: the backward's own kernels, the attention's
#: forward (block_masked, run again by remat in the backward), the rest of
#: the forward and the optimizer
TRAIN_PROFILE_GROUPS = ("forward", "attention forward and recompute",
                        "backward and recompute", "AdamW")
#: one training step of every SMOKE config: B 2 x 32 tokens
TRAIN_SMOKE_BATCH = 2
TRAIN_SMOKE_SEQ = 32
#: the card's bf16 gradients against the CPU's f32 ones (SMOKE configs):
#: the worst parameter normwise, and all parameters together.  Sound runs
#: read at most 0.336 and 0.157 (moonshot's MoE) on the H100; a
#: transposed cotangent in ``_BmmF32``'s backward reads 1.31 and 0.89 or
#: more (tests/test_torch_train.py, tests/test_torch_cuda.py)
TRAIN_BF16_PARAM_TOL = 0.6
TRAIN_BF16_TOL = 0.3
#: microbatches 2 against 1 after one AdamW step: an element may pass on
#: Adam's normalisation of its two gradients (beyond the reference's
#: rtol 2e-4 / atol 2e-5) only where both clipped gradients are within
#: this many eps of zero, and no more than this many elements may
TRAIN_ADAM_NEAR_ZERO_EPS = 100
TRAIN_ADAM_MAX_NORMALISED = 64


def grads_of(model, cfg, batch) -> tuple:
    """(loss, {name: gradient}) of one backward of ``loss_fn``; a parameter
    the loss does not reach gets zeros, as the reference's tree has."""
    for p in model.parameters():
        p.grad = None
    loss = T.loss_fn(model, cfg, batch)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), grads


def grads_agree(what: str, got, want, tol: float, loss_tol: float = 1e-5
                ) -> float:
    """Two (loss, gradients) pairs: loss relative ``loss_tol``, every
    gradient within ``tol`` normwise (to a zero gradient: exactly zero).
    Returns the worst gradient's normwise distance."""
    (lg, gg), (lw, gw) = got, want
    check(math.isfinite(lg) and abs(lg - lw) <= loss_tol * abs(lw),
          f"{what}: loss {lg!r} against {lw!r} (relative {loss_tol})")
    worst, name = 0.0, None
    for n, w in gw.items():
        g = gg[n].to(w.device).float()
        check(bool(torch.isfinite(g).all()), f"{what}: {n}'s gradient "
              f"finite")
        den = float(w.float().norm())
        err = float((g - w.float()).norm()) / den if den else float(
            g.abs().max())
        if err > worst:
            worst, name = err, n
    check(worst <= tol, f"{what}: gradients within {tol} normwise (worst "
          f"{name}: {worst:.3g})")
    return worst


def bf16_grads_agree(what: str, got, want) -> tuple:
    """bf16 gradients against f32 ones: the loss within 5e-2 relative, the
    worst parameter within ``TRAIN_BF16_PARAM_TOL`` normwise, all of them
    together within ``TRAIN_BF16_TOL``.  Returns (worst, its name,
    together)."""
    (lg, gg), (lw, gw) = got, want
    check(math.isfinite(lg) and abs(lg - lw) <= 5e-2 * abs(lw),
          f"{what}: loss {lg} finite and within 5e-2 of the f32 loss {lw}")
    worst, name, num, den = 0.0, None, 0.0, 0.0
    for n, w in gw.items():
        g = gg[n].to(w.device).float()
        check(bool(torch.isfinite(g).all()), f"{what}: {n}'s gradient "
              f"finite")
        d2 = float((g - w.float()).double().norm()) ** 2
        w2 = float(w.double().norm()) ** 2
        num, den = num + d2, den + w2
        err = (d2 / w2) ** 0.5 if w2 else d2 ** 0.5
        if err > worst:
            worst, name = err, n
    total = (num / den) ** 0.5
    check(worst <= TRAIN_BF16_PARAM_TOL and total <= TRAIN_BF16_TOL,
          f"{what}: gradients within {TRAIN_BF16_PARAM_TOL} normwise per "
          f"parameter (worst {name}: {worst:.3g}) and {TRAIN_BF16_TOL} "
          f"together ({total:.3g})")
    return worst, name, total


def state_on(state, dev):
    """A copy of a ``TrainState`` on ``dev`` (the same parameters, moments
    and step)."""
    import copy
    other = copy.deepcopy(state)
    other.model.to(dev)
    return other._replace(opt=other.opt._replace(
        step=other.opt.step.to(dev),
        m={n: t.to(dev) for n, t in other.opt.m.items()},
        v={n: t.to(dev) for n, t in other.opt.v.items()}))


def llama_train(dev, smoke: bool = False) -> dict:
    """llama-train: the published llama3.2-1b at full width and depth, a
    warm-up step, then ``TRAIN_TIMED_STEPS`` steps of 4 x 2,048 tokens each
    ended by a synchronise; step ms, tokens/s, the model-FLOP share of the
    bf16 peak (6 N T a step), peak memory, the device profile of one more
    step (busy ms, idle share, kernels), ``grad_norm``.  Every loss and
    gradient finite, the first loss within the reference's band
    0.1 ln V < loss < 3 ln V, no flash or tile-kernel launch."""
    what = "llama-train"
    cfg = get_config("llama3_2_1b", smoke=smoke)
    if smoke:
        cfg = cfg.replace(dtype="bfloat16", remat="full")
    b, s = (2, 64) if smoke else (TRAIN_BATCH, TRAIN_SEQ)
    free = free_port_memory(dev)
    opt = AdamW(lr=3e-4, warmup=2, total_steps=8)
    t0 = time.perf_counter()
    state = init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0))
    sync(dev)
    n = sum(p.numel() for p in state.model.parameters())
    check(n == n_params(cfg), f"{what}: {n} parameters, {n_params(cfg)} "
          f"from the config's shapes")
    print(f"{what}: {cfg.name} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, attn_impl={cfg.attn_impl} dtype={cfg.dtype} "
          f"remat={cfg.remat} tie_embeddings={cfg.tie_embeddings}: "
          f"{n:,} parameters (f32 masters, gradients, m and v "
          f"{16 * n / 1e9:.1f} GB) initialised on the card from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s; {free / 2**30:.1f} GiB were "
          f"free")
    pipe = SyntheticLM(cfg.vocab_size, s, b, seed=0)
    step_fn = make_train_step(cfg, opt)
    reset_counts()
    bm0 = A.BLOCK_MASKED_CALLS
    losses, norms, times = [], [], []

    def one(i):
        nonlocal state
        batch = batch_for(cfg, pipe, i, device=dev)
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        sync(dev)
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        check(math.isfinite(losses[-1]) and math.isfinite(norms[-1]),
              f"{what}: step {i} loss {losses[-1]} and grad_norm "
              f"{norms[-1]} finite (the global norm is finite only if every "
              f"gradient is)")

    one(0)
    lnv = math.log(cfg.vocab_size)
    check(0.1 * lnv < losses[0] < 3 * lnv, f"{what}: first loss "
          f"{losses[0]:.4f} within the reference's band (0.1, 3) x ln V = "
          f"({0.1 * lnv:.3f}, {3 * lnv:.3f})")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(1, 1 + TRAIN_TIMED_STEPS):
        one(i)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    prof = ranged_profile(
        lambda: one(1 + TRAIN_TIMED_STEPS), dev, what,
        ((A, "block_masked_attention", "smoke.attention"),
         (AdamW, "update", "smoke.adamw")),
        lambda chain, name: next(
            (g for key, g in (("smoke.adamw", "AdamW"),
                              ("smoke.attention",
                               "attention forward and recompute"),
                              ("autograd::engine", "backward and recompute"))
             if any(key in c for c in chain)), "forward"),
        TRAIN_PROFILE_GROUPS)
    check(all(bool(torch.isfinite(p).all())
              for p in state.model.parameters()),
          f"{what}: every parameter finite after {len(losses)} steps")
    check(flash.TC_LAUNCHES == 0 and kernel.FUSED_LAUNCHES == 0
          and kernel.LAUNCHES == 0, f"{what}: the training path launches no "
          f"flash or block_spgemm kernel (TC_LAUNCHES {flash.TC_LAUNCHES}, "
          f"FUSED_LAUNCHES {kernel.FUSED_LAUNCHES})")
    calls = A.BLOCK_MASKED_CALLS - bm0
    check(calls == 2 * cfg.n_layers * len(losses),
          f"{what}: block_masked ran twice a layer a step (forward and "
          f"remat's recompute): {calls}")
    warm = statistics.median(times[1:1 + TRAIN_TIMED_STEPS])
    tokens = b * s
    flops = 6 * n * tokens
    out = {"params": n, "tokens_per_step": tokens, "cold_ms": times[0],
           "step_ms": times[1:1 + TRAIN_TIMED_STEPS], "warm_ms": warm,
           "tokens_per_s": tokens / (warm / 1e3),
           "mfu": flops / (warm / 1e3) / PEAK_BF16_FLOPS,
           "peak_mib": peak / 2**20, "losses": losses, "grad_norms": norms,
           "profile": prof, "block_masked_calls": calls}
    idle_against_warm(out, what)
    print(f"{what}: losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"grad_norm {', '.join(f'{x:.4g}' for x in norms)}")
    print(f"{what}: step ms cold {times[0]:.1f}, warm "
          f"{', '.join(f'{x:.1f}' for x in out['step_ms'])} (median "
          f"{warm:.1f}); {out['tokens_per_s']:.0f} tokens/s; mfu "
          f"{out['mfu']:.2%} (6 N T = {flops / 1e12:.1f} TFLOP a step "
          f"against {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16); peak memory "
          f"{out['peak_mib']:.0f} MiB; device busy "
          f"{prof.get('busy_ms', float('nan')):.1f} ms a step, idle share "
          f"{out.get('idle_share_warm', float('nan')):.1%} of the warm "
          f"step, {prof.get('kernels', 0)} kernels a step; {CARD}")
    del state, step_fn
    free_port_memory(dev)
    return out


def train_cut_checks(dev, smoke: bool = False) -> dict:
    """f32 at full width and 2 of 16 layers (remat "none"), 1 x 256
    tokens: the card's gradients against the CPU port's on the same state
    and batch, block_masked against dense_masked on the card, microbatches
    2 against 1 after one AdamW step (2 x 256 tokens; the reference's
    rtol 2e-4 / atol 2e-5, and Adam's normalisation of near-zero
    gradients at no more than ``TRAIN_ADAM_MAX_NORMALISED`` elements),
    remat "full" and "dots" against "none"."""
    what = "train-f32-cut"
    cfg = get_config("llama3_2_1b", smoke=smoke).replace(
        n_layers=TRAIN_CUT_LAYERS, dtype="float32", remat="none")
    s = 32 if smoke else TRAIN_CUT_SEQ
    opt = AdamW(lr=1e-3, warmup=1, total_steps=10)
    state = init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0))
    cpu = state_on(state, torch.device("cpu"))
    pipe = SyntheticLM(cfg.vocab_size, s, 2, seed=0)
    batch2 = batch_for(cfg, pipe, 0, device=dev)
    batch = {k: v[:1] for k, v in batch2.items()}
    out = {}
    t0 = time.perf_counter()
    card_g = grads_of(state.model, cfg, batch)
    cpu_g = grads_of(cpu.model, cfg, {k: v.cpu() for k, v in batch.items()})
    out["card_vs_cpu"] = grads_agree(f"{what}: card against CPU", card_g,
                                     cpu_g, 1e-4)
    dense = grads_of(state.model, cfg.replace(attn_impl="dense_masked"),
                     batch)
    out["block_vs_dense"] = grads_agree(
        f"{what}: block_masked against dense_masked", card_g, dense, 1e-4)
    for mode in ("full", "dots"):
        out[f"remat_{mode}"] = grads_agree(
            f"{what}: remat {mode} against none",
            grads_of(state.model, cfg.replace(remat=mode), batch), card_g,
            1e-6, loss_tol=1e-6)
    del cpu, card_g, cpu_g, dense
    # microbatches: the gradient the two halves accumulate against the
    # whole batch's, then one AdamW step of each path
    whole = grads_of(state.model, cfg, batch2)
    for p in state.model.parameters():
        p.grad = None
    halves = 0.0
    for i in range(2):
        li = T.loss_fn(state.model, cfg, {k: v[i:i + 1]
                                          for k, v in batch2.items()})
        li.backward()
        halves += float(li.detach()) / 2
    acc = {n: (p.grad / 2 if p.grad is not None else torch.zeros_like(p))
           for n, p in state.model.named_parameters()}
    for p in state.model.parameters():
        p.grad = None
    out["microbatch_grads"] = grads_agree(
        f"{what}: microbatches 2 against 1, accumulated gradients",
        (halves, acc), whole, 1e-5)
    other = state_on(state, dev)
    s1, m1 = make_train_step(cfg, opt)(state, batch2)
    s2, m2 = make_train_step(cfg, opt, microbatches=2)(other, batch2)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    n1, n2 = float(m1["grad_norm"]), float(m2["grad_norm"])
    lr = float(m1["lr"])
    check(abs(l1 - l2) <= 1e-5 * abs(l1) and abs(n1 - n2) <= 1e-5 * n1,
          f"{what}: microbatches 2 against 1: loss {l2!r} / {l1!r}, "
          f"grad_norm {n2!r} / {n1!r} (rtol 1e-5)")
    # Adam's first update moves an element by lr * g / (|g| + eps) (g
    # clipped): near |g| ~ eps a gradient's last bits move it by a share
    # of lr, and opposite signs by up to 2 lr.  So each element must meet
    # the reference's rtol 2e-4 / atol 2e-5; only where both paths'
    # gradients lie within TRAIN_ADAM_NEAR_ZERO_EPS eps of zero may it add
    # what Adam makes of the two, and at most TRAIN_ADAM_MAX_NORMALISED
    # elements may need that.  A sign divergence at a larger |g| fails
    near = TRAIN_ADAM_NEAR_ZERO_EPS * opt.eps
    flipped = total = 0
    worst = small = 0.0
    with torch.no_grad():
        for (n, x), (_, y) in zip(s1.model.named_parameters(),
                                  s2.model.named_parameters()):
            g1 = whole[1][n] * min(1.0, opt.grad_clip / n1)
            g2 = acc[n] * min(1.0, opt.grad_clip / n2)
            step_gap = (g1 / (g1.abs() + opt.eps)
                        - g2 / (g2.abs() + opt.eps)).abs()
            g_max = torch.maximum(g1.abs(), g2.abs())
            diff = (x - y).abs()
            ref_tol = 2e-5 + 2e-4 * y.abs()
            adam = torch.where(g_max <= near,
                               lr * step_gap * (1 + 1e-3) + 1e-7, 0.0)
            check(bool((diff <= ref_tol + adam).all()),
                  f"{what}: microbatches 2 against 1 after one AdamW step, "
                  f"{n}: every element within rtol 2e-4 / atol 2e-5, plus "
                  f"Adam's normalisation of the two gradients only where "
                  f"both lie within {near:.3g} of zero")
            out_tol = diff > ref_tol
            flipped += int(out_tol.sum())
            total += x.numel()
            worst = max(worst, float(diff.max()))
            if bool(out_tol.any()):
                small = max(small, float(g_max[out_tol].max()))
    del whole, acc
    check(flipped <= TRAIN_ADAM_MAX_NORMALISED,
          f"{what}: microbatches 2 against 1 after one AdamW step: "
          f"{flipped} elements outside rtol 2e-4 / atol 2e-5, at most "
          f"{TRAIN_ADAM_MAX_NORMALISED} may be")
    out["microbatch_reversed"] = flipped
    out["microbatch_max_abs"] = worst
    out["microbatch_largest_g"] = small
    print(f"{what}: {cfg.name} f32 at {cfg.n_layers} of 16 layers, 1 x {s} "
          f"tokens: gradients card against CPU {out['card_vs_cpu']:.3g} "
          f"normwise (worst parameter; 1e-4), block_masked against "
          f"dense_masked {out['block_vs_dense']:.3g} (1e-4), remat full "
          f"{out['remat_full']:.3g} and dots {out['remat_dots']:.3g} "
          f"against none (1e-6); microbatches 2 against 1 at 2 x {s}: "
          f"accumulated gradients {out['microbatch_grads']:.3g} normwise "
          f"(1e-5), after one AdamW step loss {l2:.6f} / {l1:.6f}, "
          f"grad_norm {n2:.6g} / {n1:.6g}, parameters max |diff| "
          f"{worst:.3g}; {flipped:,} of {total:,} elements "
          f"({flipped / total:.2g}; at most {TRAIN_ADAM_MAX_NORMALISED}) "
          f"outside rtol 2e-4 / atol 2e-5, each one Adam's first update "
          f"normalises from a near-zero gradient (largest clipped |g| of "
          f"the two paths among them {small:.3g}, at most {near:.3g}; lr "
          f"{lr:.3g}); "
          f"{time.perf_counter() - t0:.1f} s")
    del state, other, s1, s2
    free_port_memory(dev)
    return out


def train_families(dev) -> dict:
    """One training step of each of the ten SMOKE configs on the card,
    against the CPU port on the same state and batch: f32 gradients within
    1e-4 normwise; bf16 gradients (``_bmm_f32``'s CUDA backward in
    block_masked, MLA and the SSD tile) against the CPU's f32 ones
    (``bf16_grads_agree``); then the step in bf16: its loss finite and
    within 5e-2 relative of the f32 loss, every parameter finite after the
    AdamW update."""
    from repro_torch.configs.base import ARCH_IDS
    out = {}
    t0 = time.perf_counter()
    opt = AdamW(lr=1e-3, warmup=1, total_steps=10)
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        cpu = init_state(cfg, opt, seed=0, device="cpu")
        card_state = state_on(cpu, dev)
        batch = concrete_batch(cfg, TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ,
                               seed=1, device="cpu")
        g32 = grads_of(card_state.model, cfg,
                       {k: v.to(dev) for k, v in batch.items()})
        cpu_g = grads_of(cpu.model, cfg, batch)
        err = grads_agree(f"train {arch} f32: card against CPU", g32,
                          cpu_g, 1e-4)
        bcfg = cfg.replace(dtype="bfloat16")
        bbatch = concrete_batch(bcfg, TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ,
                                seed=1, device=dev)
        bworst, bname, btotal = bf16_grads_agree(
            f"train {arch} bf16 gradients on the card against f32 on the "
            f"CPU", grads_of(card_state.model, bcfg, bbatch), cpu_g)
        card_state, m = make_train_step(bcfg, opt)(card_state, bbatch)
        lb = float(m["loss"])
        check(math.isfinite(lb) and abs(lb - g32[0]) <= 5e-2 * abs(g32[0]),
              f"train {arch} bf16: loss {lb} finite and within 5e-2 of the "
              f"f32 loss {g32[0]}")
        check(math.isfinite(float(m["grad_norm"])) and all(
            bool(torch.isfinite(p).all())
            for p in card_state.model.parameters()),
            f"train {arch} bf16: gradients and updated parameters finite")
        out[arch] = {"f32_grad_err": err, "f32_loss": g32[0],
                     "bf16_loss": lb, "bf16_grad_worst": bworst,
                     "bf16_grad_worst_name": bname,
                     "bf16_grad_err": btotal,
                     "bf16_grad_norm": float(m["grad_norm"])}
        print(f"train {arch}: f32 gradients card against CPU {err:.3g} "
              f"normwise (1e-4); bf16 gradients on the card against f32 on "
              f"the CPU: worst {bname} {bworst:.3g} "
              f"({TRAIN_BF16_PARAM_TOL}), together {btotal:.3g} "
              f"({TRAIN_BF16_TOL}); loss f32 {g32[0]:.5f}, bf16 step "
              f"{lb:.5f} (relative {abs(lb - g32[0]) / abs(g32[0]):.2g}; "
              f"5e-2)")
        del cpu, card_state, g32, cpu_g
    print(f"train families: ten SMOKE configs in "
          f"{time.perf_counter() - t0:.1f} s")
    free_port_memory(dev)
    return out


def train_flash_refuses(dev) -> None:
    """flash_pallas under gradients raises NotImplementedError before any
    launch (the reference's Pallas kernel has no backward either)."""
    cfg = get_config("llama3_2_1b", smoke=True).replace(
        attn_impl="flash_pallas")
    state = init_state(cfg, AdamW(), torch.Generator(device=dev)
                       .manual_seed(0))
    batch = concrete_batch(cfg, 1, TRAIN_SMOKE_SEQ, device=dev)
    before = (flash.LAUNCHES, flash.TC_LAUNCHES)
    try:
        T.loss_fn(state.model, cfg, batch)
    except NotImplementedError as e:
        print(f"train flash_pallas: raises NotImplementedError ({e})")
    else:
        check(False, "flash_pallas under gradients raises")
    check((flash.LAUNCHES, flash.TC_LAUNCHES) == before,
          "flash_pallas under gradients launched no kernel")


def train_resume(dev) -> dict:
    """Checkpoint and resume on the card (SMOKE llama): 6 steps with an
    async save every 2, then a fresh state restored from step 4 runs steps
    4 and 5; its losses equal the uninterrupted run's to 1e-6 relative
    (and say whether bitwise)."""
    import tempfile
    cfg = get_config("llama3_2_1b", smoke=True)
    opt = AdamW(lr=1e-3, warmup=2, total_steps=6)
    pipe = SyntheticLM(cfg.vocab_size, 16, 8, seed=11)
    step_fn = make_train_step(cfg, opt)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        state = init_state(cfg, opt, torch.Generator(device=dev)
                           .manual_seed(7))
        losses = []
        for step in range(6):
            state, m = step_fn(state, batch_for(cfg, pipe, step, device=dev))
            losses.append(float(m["loss"]))
            if (step + 1) % 2 == 0:
                mgr.save(step + 1, state, asynchronous=True)
        mgr.wait()
        check(mgr.all_steps() == [2, 4, 6] and mgr.latest_step() == 6,
              f"train resume: checkpoints {mgr.all_steps()}")
        fresh = mgr.restore(4, init_state(
            cfg, opt, torch.Generator(device=dev).manual_seed(99)))
        check(int(fresh.opt.step) == 4 and fresh.opt.step.device.type
              == dev.type, "train resume: step 4 restored on the card")
        resumed = []
        for step in (4, 5):
            fresh, m = step_fn(fresh, batch_for(cfg, pipe, step, device=dev))
            resumed.append(float(m["loss"]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[4:]))
    check(rel <= 1e-6, f"train resume: steps 4-5 {resumed} against the "
          f"uninterrupted {losses[4:]} (1e-6 relative)")
    bitwise = resumed == losses[4:]
    print(f"train resume: 6 steps, async saves at 2, 4, 6; restored step 4 "
          f"into a fresh state on the card; steps 4-5 {resumed} against "
          f"{losses[4:]}: relative {rel:.3g}, "
          f"{'bitwise equal' if bitwise else 'not bitwise'}")
    return {"resumed": resumed, "uninterrupted": losses[4:],
            "bitwise": bitwise}


def training_phase(dev) -> dict:
    """Phase 16; returns its numbers."""
    free = free_port_memory(dev)
    print(f"training: {free / 2**30:.1f} GiB free after clearing every "
          f"port cache")
    out, t0 = {}, time.perf_counter()
    out["llama_train"] = llama_train(dev)
    t1 = time.perf_counter()
    out["cut"] = train_cut_checks(dev)
    t2 = time.perf_counter()
    out["families"] = train_families(dev)
    train_flash_refuses(dev)
    t3 = time.perf_counter()
    out["resume"] = train_resume(dev)
    print(f"training: llama-train {t1 - t0:.1f} s, f32 cut checks "
          f"{t2 - t1:.1f} s, families and flash {t3 - t2:.1f} s, resume "
          f"{time.perf_counter() - t3:.1f} s")
    free_port_memory(dev)
    return out


def lint_phase() -> dict:
    """Phase 17: ``python -m repro_torch.lint`` over the port's own tree in
    a child process.  A finding or a crash of the linter fails the run."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", "--format=json",
         "--baseline", "none"], cwd=root, env=env, capture_output=True,
        text=True, timeout=300)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"the port's linter exited {proc.returncode}: "
          f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout)
    counts = report["counts"]
    check(counts["total"] == 0, f"the port's linter found {counts}")
    check(report["roots"] == [str(root / "src" / "repro_torch")],
          f"the linter ran over {report['roots']}")
    print(f"lint: {len(report['rules'])} rules over src/repro_torch, "
          f"counts {json.dumps(counts)}, {seconds:.2f} s (Python "
          f"{sys.version.split()[0]})")
    return {"counts": counts, "rules": report["rules"], "seconds": seconds}


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
    entry["health_launches"] = healthy["launches"]
    entry["health"] = {k: healthy[k] for k in ("overhead", "pressure")}
    t_dist = time.perf_counter()
    distributed = dist_phase(dev, ops)
    del ops
    ring = distributed["ring"]
    entry["ring_launches"] = {p: r["launches"] for p, r in ring.items()}
    entry["ring_stage_ms"] = {p: r["stage_ms"] for p, r in ring.items()}
    entry["ring_stage_mma_sync_ms"] = {p: r["stage_mma_sync_ms"]
                                       for p, r in ring.items()}
    entry["ring_stage_real"] = {p: r["real"] for p, r in ring.items()}
    entry["ring_stage_out_blocks"] = {p: r["wm_blocks"]
                                      for p, r in ring.items()}
    entry["ring_stage_W"] = {p: r["W"] for p, r in ring.items()}
    entry["ring_stage_bound_ms"] = {p: r["stage_bound_ms"]
                                    for p, r in ring.items()}
    entry["ring_stage_plain_ms"] = {p: r["stage_plain_ms"]
                                    for p, r in ring.items()}
    entry["dist_serving_launches"] = distributed["serving"]["launches"]
    entry["dist_probe_launches"] = distributed["fit"]["launches"]
    entry["distributed"] = distributed
    t_sddmm = time.perf_counter()
    err = sddmm_vs_plain(dev)
    sddmm = sddmm_path(dev, mask_tiles)
    sddmm["max_abs_err"] = max(sddmm["max_abs_err"], err)
    t_flash = time.perf_counter()
    err = flash_vs_plain(dev)
    flash_entry = flash_layer(dev)
    flash_entry["max_abs_err"] = max(flash_entry["max_abs_err"], err)
    t_lm = time.perf_counter()
    (flash_entry["launches"], flash_entry["f32_launches"],
     flash_warm_ms) = lm_serving(dev)
    t_families = time.perf_counter()
    families, moonshot_entry = families_phase(dev, flash_warm_ms)
    moonshot_entry["families"] = families
    t_families2 = time.perf_counter()
    zamba_entry, seamless_entry = families2_phase(dev)
    t_training = time.perf_counter()
    training = training_phase(dev)
    t_lint = time.perf_counter()
    linted = lint_phase()
    t_end = time.perf_counter()
    print(f"phases: spgemm {t_serving - t_start:.1f} s, serving "
          f"{t_delta - t_serving:.1f} s, delta {t_tuning - t_delta:.1f} s, "
          f"tuning {t_health - t_tuning:.1f} s, "
          f"health {t_dist - t_health:.1f} s, "
          f"distributed {t_sddmm - t_dist:.1f} s, "
          f"sddmm {t_flash - t_sddmm:.1f} s, "
          f"flash {t_lm - t_flash:.1f} s, lm {t_families - t_lm:.1f} s, "
          f"families {t_families2 - t_families:.1f} s, "
          f"families II {t_training - t_families2:.1f} s, "
          f"training {t_lint - t_training:.1f} s, "
          f"lint {t_end - t_lint:.1f} s")
    print("training numbers: " + json.dumps(training))
    print("lint numbers: " + json.dumps(linted))
    print(json.dumps({"kernels": [entry, sddmm, flash_entry,
                                  moonshot_entry, zamba_entry,
                                  seamless_entry]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
