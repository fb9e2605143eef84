#!/usr/bin/env python3
"""Compare build variants of the Hopper block product on one GPU.

    python3 tools/block_spgemm_sm90_variants.py     # from the repository root

Each variant is the package's ``block_spgemm_sm90.cu`` with text
substitutions, compiled with the package's ``nvcc`` flags into
``build/block_spgemm_sm90_variants/`` (one ``nvcc`` per variant, all
started together) and launched through the package's wrapper on the same
tensors at the four shapes the main path gives the kernel, all on
tile-8192's operands revalued to integers 1-4 as chip_smoke.py's phase 13
does: the fused tile call (and its values-only replay), and shard 0's
stage-0 replay of the sparse ring at p = 2, 4 and 8.  The variants: the
stage ring 2 or 3 deep instead of 4, the IEEE flush every 2 k8 steps
instead of once per 32-deep stage, the counting CTAs first in the grid,
and the split of A with other register budgets (setmaxnreg: the
producer warpgroup's and the consumers' registers, adopted 56 / 224) and
batches (the 16-byte words a splitter loads before splitting any,
adopted 4 of its 11): 40 / 232 a word at a time, 88 / 208 all 11, and no
setmaxnreg with all 11; and two ablations, exact only on integer data (where every lo term
is zero): one tf32 pass (a_hi b_hi only), with and without the producer's
split of A.  Every variant is first held to the plain version at each shape
(exact: integer data); then all of them and the ``mma.sync`` kernel are
timed in turns (forward, backward, forward, backward), each turn the
device time per call over 10 calls after 2 warm-ups
(``chip_smoke.kernel_ms``: the calls queued behind a device-side sleep,
so the kernel and the wrapper's segment offsets without its host work),
and the median of each one's turns is
printed with its registers, spills and ptxas's notes; the static opcode
histogram of the adopted kernel comes first (``cuobjdump -sass``).
"""
from __future__ import annotations

import collections
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core import formats as F  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.masked_matmul import kernel  # noqa: E402

OUT = REPO / "build" / "block_spgemm_sm90_variants"
STAGES = "constexpr int STAGES = 4;"
FLUSH = "constexpr int FLUSH = 4;"
ORDER = "constexpr bool COUNTS_FIRST = false;"
THREE = """            sm90::wgmma_rs_tf32_n128(
                part, bhi[s], sm90::desc_sw128(alo + 32 * s, 16, 1024),
                s > s0);
            sm90::wgmma_rs_tf32_n128(
                part, blo[s], sm90::desc_sw128(ahi + 32 * s, 16, 1024), 1);
            sm90::wgmma_rs_tf32_n128(
                part, bhi[s], sm90::desc_sw128(ahi + 32 * s, 16, 1024), 1);
"""
ONE = """            sm90::wgmma_rs_tf32_n128(
                part, bhi[s], sm90::desc_sw128(ahi + 32 * s, 16, 1024),
                s > s0);
"""
SPLIT = "for (int e1 = e0; e1 < TILE_BYTES / 16;"
BATCH = "constexpr int SPLIT_BATCH = 4;"
PRODUCER = "constexpr int PRODUCER_REGS = 56;"
CONSUMER = "constexpr int CONSUMER_REGS = 224;"
DEC = "    sm90::setmaxnreg_dec<PRODUCER_REGS>();\n"
INC = "  sm90::setmaxnreg_inc<CONSUMER_REGS>();\n"

#: variant name -> text substitutions in block_spgemm_sm90.cu; the first is
#: the source as it stands
VARIANTS = {
    "adopted": [],
    "2 stages": [(STAGES, STAGES.replace("4", "2"))],
    "3 stages": [(STAGES, STAGES.replace("4", "3"))],
    "flush every 2 k8 steps": [(FLUSH, FLUSH.replace("4", "2"))],
    "counting CTAs first": [(ORDER, ORDER.replace("false", "true"))],
    "40 / 232 registers, a word at a time": [
        (BATCH, BATCH.replace("4", "1")),
        (PRODUCER, PRODUCER.replace("56", "40")),
        (CONSUMER, CONSUMER.replace("224", "232"))],
    "88 / 208 registers, 11 words at a time": [
        (BATCH, BATCH.replace("4", "11")),
        (PRODUCER, PRODUCER.replace("56", "88")),
        (CONSUMER, CONSUMER.replace("224", "208"))],
    "no setmaxnreg, 11 words at a time": [
        (BATCH, BATCH.replace("4", "11")), (DEC, ""), (INC, "")],
    # ablations, exact only on integer data (there lo = 0): one tf32 pass
    # (a_hi b_hi), with and without the A split
    "ablation: one pass": [(THREE, ONE)],
    "ablation: one pass, no A split": [(THREE, ONE),
                                       (SPLIT, SPLIT.replace(
                                           "TILE_BYTES / 16", "0"))],
}
#: the ring sizes whose stage-0 replay is timed
RING_SIZES = (2, 4, 8)


def build_variants():
    """(name, library path, ptxas log) of every variant, built together."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = _build.SOURCES["block_spgemm_sm90"].read_text()
    procs = []
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} not found")
            text = text.replace(old, new)
        cu, lib = OUT / f"v{i}.cu", OUT / f"libv{i}.so"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    built = []
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        built.append((name, lib, log))
        (OUT / f"v{len(built) - 1}.ptxas.txt").write_text(log)
    return built


def ptxas_notes(log: str) -> str:
    """Registers, spills and performance notes of the kernel."""
    out, keep = [], False
    for ln in log.splitlines():
        if "C75" in ln and "C7519" not in ln:
            out.append(ln.split(")", 1)[-1].strip()[:100])
        elif "Compiling entry function" in ln:
            keep = "block_spgemm_sm90_kernel" in ln
        elif keep and ("Used" in ln or "spill" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return "; ".join(out)


def sass_histogram(lib: Path) -> str:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    ops_, inside = collections.Counter(), False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = "block_spgemm_sm90_kernel" in ln
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z0-9_.]+)", ln)
            if m:
                ops_[m.group(2).split(".")[0]] += 1
    return (f"{sum(ops_.values())} instructions; " + ", ".join(
        f"{op} {n}" for op, n in ops_.most_common(28)))


def shapes(dev):
    """(name, fused, a, b, a_pat, b_pat, worklist, nnzb_out, real) of the
    four path shapes on tile-8192's integer operands, plus tile-8192's
    values-only replay."""
    a, b, m = smoke.tile_problem(smoke.TILE_N, smoke.TILE_BS)
    A, B, M = (F.csr_from_dense(x) for x in (a, b, m))
    A, B = smoke.revalue(A, 0, ints=True), smoke.revalue(B, 1, ints=True)
    bs = smoke.TILE_BS
    _, (Ab, Bb, Mb), (ap, bp), sched = smoke.host_steps(A, B, M, dev, bs)
    wl = smoke.worklist(sched, dev)
    real = int(((sched[3] >> 1) & 1).sum())
    out = [("tile-8192 fused", True, Ab.blocks, Bb.blocks, ap, bp, wl,
            Mb.nnzb, real),
           ("tile-8192 values only", False, Ab.blocks, Bb.blocks, ap, bp,
            wl, Mb.nnzb, real)]
    for p in RING_SIZES:
        st = dist._ring_state(A, B, M, bs, smoke.mesh_on(dev, p), "data",
                              None)
        sa, sb, sap, sbp, swl = smoke.ring_stage(st, A, B, bs, dev)
        sreal = int(((swl[3] >> 1) & 1).sum())
        out.append((f"ring p={p} stage (W={int(swl.shape[1])})", True, sa,
                    sb, sap, sbp, list(swl), st.wm_blocks, sreal))
        dist.clear_ring_prep_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    built = build_variants()
    libs = {}
    for name, lib, log in built:
        libs[name] = ctypes.CDLL(str(lib))
        fn = libs[name].block_spgemm_sm90_info
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        info = (ctypes.c_int * 5)()
        err = fn(ctypes.addressof(info))
        if err:
            raise RuntimeError(f"{name}: info failed with CUDA error {err}")
        print(f"variant {name}: {dict(zip(_build.INFO_FIELDS, info))}; "
              f"{ptxas_notes(log)}")
    print("sass adopted: block_spgemm_sm90_kernel: "
          + sass_histogram(built[0][1]))

    def loader(name):
        def load(lib_name, symbol, argtypes):
            fn = getattr(libs[name], symbol)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            return fn
        return load

    def run(name, fused, a, b, ap, bp, wl, nnzb):
        variant = "mma_sync" if name is None else "sm90"
        saved = _build.load
        if name is not None:
            _build.load = loader(name)
        try:
            if fused:
                return kernel.block_spgemm_with_structure_kernel(
                    a, b, ap, bp, *wl, nnzb, variant=variant)
            return (kernel.block_spgemm_kernel(a, b, *wl, nnzb,
                                               variant=variant),)
        finally:
            _build.load = saved

    contenders = list(VARIANTS) + [None]
    for what, fused, a, b, ap, bp, wl, nnzb, real in shapes(dev):
        want = (kernel.block_spgemm_with_structure_plain(
            a, b, ap, bp, *wl, nnzb) if fused else
            (kernel.block_spgemm_plain(a, b, *wl, nnzb),))
        for name in contenders:
            got = run(name, fused, a, b, ap, bp, wl, nnzb)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise RuntimeError(f"{name or 'mma.sync'} at {what}: not "
                                   f"equal to the plain version")
        times = collections.defaultdict(list)
        for turn in range(4):
            for name in (contenders if turn % 2 == 0 else contenders[::-1]):
                times[name].append(smoke.kernel_ms(
                    lambda: run(name, fused, a, b, ap, bp, wl, nnzb), dev))
        print(f"{what}: {real} real pairs, {nnzb} output blocks")
        for name in contenders:
            print(f"{what} {name or 'mma.sync kernel'}: median "
                  f"{statistics.median(times[name]):.4f} ms over 4 turns ("
                  + ", ".join(f"{t:.4f}" for t in times[name]) + ")")
        del want
    return 0


if __name__ == "__main__":
    sys.exit(main())
