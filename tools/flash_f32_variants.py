#!/usr/bin/env python3
"""Compare build variants of the f32 (3xTF32) flash kernel on one GPU.

    python3 tools/flash_f32_variants.py        # from the repository root

Each variant is the package's ``flash_mask.cu`` with text substitutions,
compiled with the package's ``nvcc`` flags into
``build/flash_f32_variants/`` (one ``nvcc`` per variant, all started
together) and launched through the package's wrapper on the same tensors:
the full-width llama3.2-1b attention layer in f32 (Hq 32, Hkv 8, S 2048,
D 64, 128-blocks, causal) at B 1 and B 4.  Every variant is first held to
rtol = atol = 2e-5 of the plain version at B 1 and compared bit for bit
with the adopted kernel at B 4 (the variant with ``cvt.rna.tf32.f32``
splits must equal it: the adopted integer split rounds the same way); then
all are timed with CUDA events in turns (forward, backward, forward,
backward), and the median of each variant's turns is printed beside its
registers, spills and CTAs per SM.  Last, the static opcode histogram of
``flash_mask_f32_tc_kernel<128, 64>`` in the first three variants, from
``cuobjdump -sass``.
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

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_mask import kernel as flash  # noqa: E402

OUT = REPO / "build" / "flash_f32_variants"
KC_LINE = "static constexpr int KC = BT < 64 ? BT : 64;"
BOUNDS = ("__launch_bounds__(BT * 2, (DM <= 64 ? 2 : 1))\n"
          "flash_mask_f32_tc_kernel")
INT_SPLIT = ("  hi = rna_bits(x);\n"
             "  lo = rna_bits(x - __uint_as_float(hi));")
CVT_SPLIT = "  tc::split_tf32(x, hi, lo);"
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
QK_UNROLL = ("#pragma unroll 2\n"
             "      for (int kk = 0; kk < DM / 8; ++kk) {")
STAGES = "static constexpr int STAGES = 2;"
KC32 = "static constexpr int KC = BT < 32 ? BT : 32;"

#: variant name -> text substitutions in flash_mask.cu; the first is the
#: source as it stands
VARIANTS = {
    "adopted": [],
    "cvt.rna split (mma.cuh's split_tf32)": [(INT_SPLIT, CVT_SPLIT)],
    "cvt.rna split and exp2f": [(INT_SPLIT, CVT_SPLIT),
                                (EX2, "y = exp2f(x);")],
    "q.k^T loop fully unrolled": [(QK_UNROLL, QK_UNROLL.replace(
        "unroll 2", "unroll"))],
    "32-key chunks": [(KC_LINE, KC32)],
    "3-stage ring": [(STAGES, STAGES.replace("2", "3"))],
    "32-key chunks, 3-stage ring": [(KC_LINE, KC32),
                                    (STAGES, STAGES.replace("2", "3"))],
    "32-key chunks, 4-stage ring": [(KC_LINE, KC32),
                                    (STAGES, STAGES.replace("2", "4"))],
    "128-key chunks (the whole tile)": [(KC_LINE,
                                         "static constexpr int KC = BT;")],
    "up to 255 registers (1 CTA/SM)": [
        (BOUNDS, "__launch_bounds__(BT * 2, 1)\nflash_mask_f32_tc_kernel")],
}
#: the variant whose outputs must equal the adopted one's bit for bit: the
#: integer split is cvt.rna.tf32.f32's rounding
SAME_BITS = "cvt.rna split (mma.cuh's split_tf32)"


def build_variants():
    """(name, library path, ptxas log) of every variant, built together."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = _build.SOURCES["flash_mask"].read_text()
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
    return built


def ptxas_line(log: str) -> str:
    """Registers and spills of flash_mask_f32_tc_kernel<128, 64>."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if ("Compiling entry function" in ln
                and "flash_mask_f32_tc_kernelILi128ELi64E" in ln):
            spill = next(x for x in lines[i + 1:i + 4] if "spill" in x)
            regs = next(x for x in lines[i + 1:i + 5] if "registers" in x)
            return (regs.split("Used")[1].split(",")[0].strip() + "; "
                    + spill.strip())
    return "not found"


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    built = build_variants()
    fns, info = {}, {}
    for name, lib, log in built:
        cdll = ctypes.CDLL(str(lib))
        fn = cdll.flash_mask
        fn.argtypes, fn.restype = flash._ARGS, ctypes.c_int
        q_info = cdll.flash_mask_f32_info
        q_info.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(dev):
            err = q_info(128, 128, 64, ctypes.addressof(out))
        fns[name] = fn
        info[name] = (f"{ptxas_line(log)}; {out[1]} B shared memory, "
                      f"{out[4]} CTAs per SM" if err == 0
                      else f"info failed: CUDA error {err}")

    def run(fn, *args, **kw):
        saved = _build.load
        _build.load = lambda *a: fn
        try:
            return flash.flash_mask_kernel(*args, **kw)
        finally:
            _build.load = saved

    gen = torch.Generator(device=dev).manual_seed(8)
    b, hq, hkv, s, d, blk = 4, 32, 8, 2048, 64, 128
    q = torch.randn((b, hq, s, d), generator=gen, device=dev) * 0.5
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev) * 0.5
            for _ in range(2))
    sched = [torch.as_tensor(x, device=dev) for x in flash.build_schedule(
        s, s, bq=blk, bk=blk, causal=True, window=0, prefix=0, q_offset=0)]
    kw = dict(bq=blk, bk=blk, scale=d ** -0.5, causal=True, window=0,
              prefix=0, q_offset=0)
    want = flash.flash_mask_plain(q[:1], k[:1], v[:1], *sched, **kw)
    adopted = run(fns["adopted"], q, k, v, *sched, **kw)
    for name, fn in fns.items():
        got = run(fn, q, k, v, *sched, **kw)
        torch.cuda.synchronize()
        err = float((got[:1] - want).abs().max())
        if not torch.allclose(got[:1], want, rtol=2e-5, atol=2e-5):
            raise RuntimeError(f"{name}: not within 2e-5 of plain ({err})")
        same = torch.equal(got, adopted)
        if name == SAME_BITS and not same:
            raise RuntimeError(f"{name}: differs from the adopted kernel")
        print(f"variant {name}: {info[name]}; within 2e-5 of plain at B 1 "
              f"(max err {err:.3g}); at B {b} "
              f"{'equal' if same else 'not equal'} to the adopted kernel "
              f"bit for bit")

    for bb in (1, b):
        args = (q[:bb], k[:bb], v[:bb], *sched)
        times = collections.defaultdict(list)
        order = list(fns)
        for turn in range(4):
            for name in (order if turn % 2 == 0 else order[::-1]):
                fn = fns[name]
                for _ in range(2):
                    run(fn, *args, **kw)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                reps = 10
                start.record()
                for _ in range(reps):
                    run(fn, *args, **kw)
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / reps)
        for name in order:
            print(f"B={bb} {name}: median {statistics.median(times[name]):.3f}"
                  f" ms over 4 turns (" + ", ".join(
                      f"{t:.3f}" for t in times[name]) + ")")

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, lib, _ in built[:3]:
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        ops, inside = collections.Counter(), False
        for ln in sass.splitlines():
            if "Function :" in ln:
                inside = "flash_mask_f32_tc_kernelILi128ELi64E" in ln
            elif inside:
                m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                             r"([A-Z0-9_.]+)", ln)
                if m:
                    ops[m.group(2).split(".")[0]] += 1
        print(f"sass {name}: flash_mask_f32_tc_kernel<128, 64>: "
              f"{sum(ops.values())} instructions; " + ", ".join(
                  f"{op} {n}" for op, n in ops.most_common(16)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
