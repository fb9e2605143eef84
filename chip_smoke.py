#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root; needs CUDA

Phases, each printing its own lines:

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
   TF32 is switched off for matmuls and cuDNN;
2. build: the CUDA kernels, compiled with ``nvcc`` from the sources in
   ``src/repro_torch/kernels/*/csrc`` into ``build/repro_torch/``;
3. kernel against plain: the ``block_spgemm`` kernel against its plain
   PyTorch version at block sizes 4, 8, 32 and 128, with zero-fill
   entries, an empty B and a worklist padded with all-flags-off entries;
4. tile route: ``masked_spgemm(A, B, M)`` (algorithm "auto") on an
   n = 8192 block-sparse problem; the planner must elect the tile route
   at block size 128, the kernel must launch exactly twice, and the result
   must equal the dense product gathered at the mask; then timings;
5. row route: triangle counting on R-MAT scale 14 (algorithm "auto"),
   checked against scipy;
6. one JSON line with every kernel's numbers, then the result line
   ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero without the result line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import formats as F  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.masked_spgemm import (  # noqa: E402
    gather_mask_aligned, masked_spgemm)
from repro_torch.graphs.triangle_counting import (  # noqa: E402
    degree_relabel, triangle_count)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.masked_matmul import kernel, ops  # noqa: E402

#: NVIDIA H100 SXM data sheet: f32 on CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

#: the tile-route workload: A, B, M from ``block_sparse`` at n = 8192
TILE_N = 8192
TILE_BS = 128
#: the row-route workload: triangle counting on R-MAT(scale, edge factor)
RMAT_SCALE = 14
RMAT_EDGE_FACTOR = 16


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


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
    print(smi)
    print(f"card: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}; matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def build() -> None:
    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {len(paths)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in paths.values()))
    for name, log in _build.PTXAS_LOG.items():
        used = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"build: ptxas {name}: " + " | ".join(used))


# ---------------------------------------------------------------------------
# Phase 3: kernel against plain
# ---------------------------------------------------------------------------


def compare(a_blocks, b_blocks, wl, nnzb_out, exact: bool) -> float:
    """Kernel against plain on the same tensors: returns max |diff|."""
    got = kernel.block_spgemm_kernel(a_blocks, b_blocks, *wl, nnzb_out)
    want = kernel.block_spgemm_plain(a_blocks, b_blocks, *wl, nnzb_out)
    sync(a_blocks.device)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if exact:
        check(torch.equal(got, want), "kernel equals plain exactly")
    else:
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
              f"kernel within 1e-4 of plain (max err {err})")
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
    for bs, nb in ((4, 64), (8, 48), (32, 16), (128, 8)):
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
        print(f"kernel-vs-plain: bs={bs} n={n} W={len(sched[0])}.. ok")
    print(f"kernel-vs-plain: all block sizes agree (exact on integers, "
          f"1e-4 otherwise), max abs err {err:.3g}")
    return err


# ---------------------------------------------------------------------------
# Phase 4: main path, tile route
# ---------------------------------------------------------------------------


def tile_problem(n: int, bs: int):
    a = F.block_sparse(n, bs, 0.3, 0.9, seed=1)
    b = F.block_sparse(n, bs, 0.3, 0.9, seed=2)
    m = F.block_sparse(n, bs, 0.6, 1.0, seed=3, mask=True)
    return a, b, m


def tile_route(dev, n: int = TILE_N, bs: int = TILE_BS) -> dict:
    t0 = time.perf_counter()
    a, b, m = tile_problem(n, bs)
    A, B, M = (F.csr_from_dense(x) for x in (a, b, m))
    print(f"tile: problem n={n} nnz A={A.nnz} B={B.nnz} M={M.nnz} built in "
          f"{time.perf_counter() - t0:.1f} s")

    # the main path, once, through the user's entry point
    planner.clear_plan_cache()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    res = masked_spgemm(A, B, M, device=dev)
    sync(dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = kernel.LAUNCHES
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    p = planner.plan(A, B, M, device=dev)        # the cached plan
    print(f"tile: plan algorithm={p.algorithm} block={p.tile_block} costs="
          + ", ".join(f"{k}={v:.4g}" for k, v in p.costs[:3]))
    check(p.algorithm == "tile" and p.tile_block == bs,
          f"planner elects tile at block {bs}")
    check(launches == 2, f"kernel launched twice (got {launches})")

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
    print(f"tile: result equals dense matmul at the mask "
          f"({int(got_p.sum())} of {M.nnz} present); first call "
          f"{first_ms:.1f} ms incl. planning; peak memory "
          f"{peak / 2**20:.1f} MiB")
    del S

    # stage timings at the main-path shapes
    t0 = time.perf_counter()
    Ab, Bb, Mb = (F.bcsr_from_csr(x, bs, device=dev) for x in (A, B, M))

    def pattern(x):
        ones = F.CSR(x.indptr, x.indices, np.ones(x.nnz, np.float32),
                     x.shape)
        return F.bcsr_from_csr(ones, bs, device=dev).blocks

    a_pat, b_pat = pattern(A), pattern(B)
    sched = ops.build_spgemm_schedule(Ab, Bb, Mb)
    sync(dev)
    prep_ms = (time.perf_counter() - t0) * 1e3
    wl = worklist(sched, dev)
    W = len(sched[0])
    real = int(((sched[3] >> 1) & 1).sum())
    err = max(compare(Ab.blocks, Bb.blocks, wl, Mb.nnzb, exact=True),
              compare(a_pat, b_pat, wl, Mb.nnzb, exact=True))

    def run_kernel():
        return kernel.block_spgemm_kernel(Ab.blocks, Bb.blocks, *wl,
                                          Mb.nnzb)

    def run_plain():
        return kernel.block_spgemm_plain(Ab.blocks, Bb.blocks, *wl, Mb.nnzb)

    kernel_ms = device_ms(run_kernel, dev, reps=7, warm=2)
    plain_ms = device_ms(run_plain, dev, reps=3, warm=1)
    Cb, Sb = run_kernel(), kernel.block_spgemm_kernel(a_pat, b_pat, *wl,
                                                      Mb.nnzb)
    gather_ms = host_ms(lambda: gather_mask_aligned(M, Mb, Cb, Sb, n=n), dev)
    e2e_ms = host_ms(lambda: masked_spgemm(A, B, M, device=dev), dev)
    dense_ms = device_ms(lambda: Ad @ Bd, dev, reps=5, warm=2)

    flops = 2.0 * real * bs ** 3
    nbytes = (Ab.blocks.nbytes + Bb.blocks.nbytes + 16 * W
              + 4 * (Mb.nnzb + 1) + Mb.nnzb * bs * bs * 4)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    print(f"tile: W={W} real={real} nnzb A={Ab.nnzb} B={Bb.nnzb} "
          f"out={Mb.nnzb}; {flops / 1e9:.1f} GFLOP and {nbytes / 1e6:.0f} "
          f"MB per replay")
    print(f"tile: host prep (bcsr + patterns + schedule, with upload) "
          f"{prep_ms:.1f} ms; kernel {kernel_ms:.3f} ms per replay "
          f"({flops / kernel_ms / 1e9:.1f} TFLOP/s); plain {plain_ms:.3f} "
          f"ms per replay; gather {gather_ms:.1f} ms; end to end "
          f"{e2e_ms:.1f} ms")
    print(f"tile: bound {bound_ms:.3f} ms per replay (by "
          f"{'operations' if t_ops >= t_bytes else 'bytes'}, data-sheet "
          f"peaks); kernel at {bound_ms / kernel_ms:.1%} of it")
    print(f"tile: dense torch.matmul {n}^3 f32 (SpGEMM-then-mask "
          f"baseline, NOT the same function) {dense_ms:.3f} ms")
    return {"name": "block_spgemm", "route": "cuda",
            "source": "src/repro_torch/kernels/masked_matmul/csrc/"
                      "block_spgemm.cu",
            "replaces": "src/repro/kernels/masked_matmul/kernel.py:105",
            "launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


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
    kernel.LAUNCHES = 0
    count, seconds = triangle_count(g, device=dev)
    check(planner.plan_cache_info()["hits"] == hits + 1,
          "triangle_count ran the planner's pick")
    check(kernel.LAUNCHES == 0, "the row route launches no block kernel")
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


def main() -> int:
    device = card()
    dev = torch.device("cuda", 0)
    build()
    err = kernel_vs_plain(dev)
    entry = tile_route(dev)
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    row_route(dev)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
