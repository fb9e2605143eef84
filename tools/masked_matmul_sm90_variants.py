#!/usr/bin/env python3
"""Compare build variants of the Hopper tile SDDMM on one GPU.

    python3 tools/masked_matmul_sm90_variants.py [variant ...]

(from the repository root).  Each variant is the package's
``masked_matmul_sm90.cu`` with some of its constants set otherwise and
some of its text substituted (the pre-pass split, one CTA a tile, the
8-byte stores and the ablations), compiled with the package's
``nvcc`` flags into ``build/masked_matmul_sm90_variants/`` (one ``nvcc``
per variant, all started together) and launched through the package's
wrapper on the same tensors at the path's shape, sddmm-8192 (M = N = 8192,
K = 256, the 2,432 mask tiles of the tile-8192 mask in CSR order), in f32
and in bf16, on integer data (-4 .. 4, where every variant, the ablations
too, is exact).  The variants: other ring depths, the IEEE flush every 4 k8
steps or every one instead of every 2, the raw f32 word as the hi of A's
or B^T's split instead of rna (tf32 wgmma reads the word truncated), A's
split by a pre-pass kernel into scratch memory (loaded by TMA) instead of
the producer's idle warps, one CTA a tile instead of the persistent grid,
8-byte stores from the accumulators (the rings a stage deeper) instead of
TMA stores from a staging tile, other register budgets of the split
(setmaxnreg: the producer warpgroup's and the consumers', adopted 56 /
224, with the words a splitter loads before splitting, adopted 4 of its
11); and two f32 ablations: one tf32 pass (a_hi b_hi), and no lo of A
(a_hi b_lo + a_hi b_hi, no split).  Named variants (the keys of ``VARIANTS``) limit the run
to them and the adopted build; a variant whose settings are the source's
own is not built twice.  A variant that does not build, or that
differs from the plain version, is reported and left out of the timing.
Every variant is first held to the plain version (exact); then all of
them and the ``mma.sync`` kernel are timed in turns (forward, backward,
forward, backward), each turn the device time per call over 10 calls after
2 warm-ups (``chip_smoke.kernel_ms``: the calls queued behind a device-side
sleep, so the kernels without the wrapper's host work), and the median of
each one's turns is printed with its registers, spills and ptxas's notes
and the bound (``chip_smoke.bound``).  Last, each f32 variant's accuracy
on standard-normal data: normwise from float64, the outputs beyond rtol =
atol = 1e-5 of float64 and the largest error over sum_k |a b|, at
sddmm-8192 and at tests/test_torch_cuda.py's 128-block case with K = 384.
The static opcode histogram of the adopted f32 kernel comes first
(``cuobjdump -sass``).  About 40 s of command on the card.
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

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.masked_matmul import kernel  # noqa: E402

OUT = REPO / "build" / "masked_matmul_sm90_variants"
LO_B_HI = """              sm90::wgmma_rs_tf32_n128(
                  part, bhi[s], sm90::desc_sw128(alo + 32 * s, 16, 1024),
                  s > s0);
              sm90::wgmma_rs_tf32_n128(
                  part, blo[s], sm90::desc_sw128(ahi + 32 * s, 16, 1024), 1);
"""
HI_B_LO = """              sm90::wgmma_rs_tf32_n128(
                  part, blo[s], sm90::desc_sw128(ahi + 32 * s, 16, 1024),
                  s > s0);
"""
HI_B_HI = """              sm90::wgmma_rs_tf32_n128(
                  part, bhi[s], sm90::desc_sw128(ahi + 32 * s, 16, 1024), 1);
"""
ONE = """              sm90::wgmma_rs_tf32_n128(
                  part, bhi[s], sm90::desc_sw128(ahi + 32 * s, 16, 1024),
                  s > s0);
"""
SPLIT = "for (int e1 = e0; e1 < TILE_BYTES / 16;"

#: one CTA a tile instead of the persistent grid
ONE_CTA_A_TILE = [("const int grid = sms < x.nnzb ? sms : x.nnzb;",
                   "const int grid = x.nnzb;")]

#: 8-byte stores straight from the accumulators (the kernel gets the
#: output's pointer) instead of the staging tiles and TMA stores, whose
#: 64 KiB of shared memory goes to the rings
DIRECT_STORES = [
    ("const int* __restrict__ bj, int nnzb,",
     "const int* __restrict__ bj, float* __restrict__ out, int nnzb,"),
    ("am, bm, om, x.bi, x.bj, x.nnzb,",
     "am, bm, om, x.bi, x.bj, x.out, x.nnzb,"),
    ("static constexpr int BAR_OFF = STAGING_OFF + 2 * 32768;",
     "static constexpr int BAR_OFF = STAGING_OFF;"),
    # f32: accumulator rows g, g + 8 are output columns j, j + 1
    ("""      staging_free();
      stage_transposed(acc, stg, j - wg * 64, t);
      store_staged(r * BT, wg * 64);
""", """      {
        float* const O = out + (size_t)r * BT * BT;
#pragma unroll
        for (int jn = 0; jn < 16; ++jn)
#pragma unroll
          for (int b = 0; b < 2; ++b)
            *reinterpret_cast<float2*>(O + (8 * jn + 2 * t + b) * BT + j) =
                make_float2(acc[4 * jn + b], acc[4 * jn + 2 + b]);
      }
"""),
    # bf16: accumulator row 16 wq + g + 8 h is output row i0 + 8 h
    ("""      staging_free();
      stage_rows(acc, stg, wq * 16 + g, t);
      store_staged(r * BT + wg * 64, 0);
""", """      {
        float* const O = out + (size_t)r * BT * BT;
        const int i0 = wg * 64 + wq * 16 + g;
#pragma unroll
        for (int jn = 0; jn < 16; ++jn)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(O + (i0 + 8 * h) * BT + 8 * jn +
                                       2 * t) =
                make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
      }
"""),
]

#: f32: A's split by a pre-pass kernel, once a call, into scratch memory
#: (A's hi, unless RAW_HI_A, and its lo), which the producer thread loads
#: by TMA beside A's hi; the producer's three idle warps split nothing
PRE_PASS = [
    ("const __grid_constant__ CUtensorMap out_map,",
     "const __grid_constant__ CUtensorMap out_map,\n"
     "                          const __grid_constant__ CUtensorMap lo_map,"),
    ("static constexpr int STAGE_TX = 2 * TILE_BYTES;",
     "static constexpr int STAGE_TX = (F32 ? 3 : 2) * TILE_BYTES;"),
    ("""          sm90::tma_load_2d(s + C::A_OFF, &a_map, full(st), kc * C::KC,
                            ib * BT);
""", """          sm90::tma_load_2d(s + C::A_OFF, &a_map, full(st), kc * C::KC,
                            ib * BT);
          if constexpr (C::F32)
            sm90::tma_load_2d(s + C::LO_OFF, &lo_map, full(st), kc * C::KC,
                              ib * BT);
"""),
    ("} else if constexpr (C::F32) {", "} else if constexpr (false) {"),
    ("sm90::mbar_wait(ready(st), ph);         // A's lo written", ""),
    ("""struct Args {""", """__global__ void split_kernel(const float4* __restrict__ a,
                             float4* __restrict__ hi,
                             float4* __restrict__ lo, size_t n4) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n4;
       e += (size_t)gridDim.x * blockDim.x) {
    const float4 x = a[e];
    uint32_t h[4], l[4];
    split_tf32<RAW_HI_A>(x.x, h[0], l[0]);
    split_tf32<RAW_HI_A>(x.y, h[1], l[1]);
    split_tf32<RAW_HI_A>(x.z, h[2], l[2]);
    split_tf32<RAW_HI_A>(x.w, h[3], l[3]);
    if (!RAW_HI_A)
      hi[e] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                          __uint_as_float(h[2]), __uint_as_float(h[3]));
    lo[e] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                        __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// the pre-pass's scratch, grown on demand and kept for the process
float* scratch(size_t floats) {
  static float* p = nullptr;
  static size_t cap = 0;
  if (floats > cap) {
    if (p != nullptr) cudaFree(p);
    cap = cudaMalloc(&p, floats * 4) == cudaSuccess ? floats : 0;
    if (cap == 0) p = nullptr;
  }
  return p;
}

struct Args {"""),
    ("  CUtensorMap am{}, bm{}, om{};\n", """  const size_t plane = (size_t)x.M * x.K;
  float* const sc =
      C::F32 && reads ? scratch((RAW_HI_A ? 1 : 2) * plane) : nullptr;
  if (C::F32 && reads && sc == nullptr) return cudaErrorMemoryAllocation;
  float* const a_lo = sc == nullptr ? nullptr : sc + (RAW_HI_A ? 0 : plane);
  const void* const a_src = sc != nullptr && !RAW_HI_A ? sc : x.a;
  CUtensorMap lom{};
  if (sc != nullptr) {
    if ((err = sm90::map_2d(&lom, type, 4, a_lo, x.M, x.K, C::KC, BT)))
      return err;
    split_kernel<<<4 * sms, 256, 0, x.stream>>>(
        static_cast<const float4*>(x.a), reinterpret_cast<float4*>(sc),
        reinterpret_cast<float4*>(a_lo), plane / 4);
  }
  CUtensorMap am{}, bm{}, om{};
"""),
    ("sm90::map_2d(&am, type, sizeof(E), x.a,",
     "sm90::map_2d(&am, type, sizeof(E), a_src,"),
    ("am, bm, om, x.bi,", "am, bm, om, lom, x.bi,"),
]

#: variant name -> the source's constants it sets (and, for the
#: ablations, text substitutions); a variant whose settings are the
#: source's own is the adopted build and is not built twice
VARIANTS = {
    "adopted": {},
    "2 f32 stages": {"STAGES": 2},
    "3 bf16 stages": {"STAGES_BF16": 3},
    "5 bf16 stages": {"STAGES_BF16": 5},
    "flush every 4 k8 steps": {"FLUSH": 4},
    "flush every k8 step": {"FLUSH": 1},
    "raw hi for A": {"RAW_HI_A": True},
    "raw hi for B^T": {"RAW_HI_B": True},
    "raw hi for A and B^T, flush every 4": {
        "RAW_HI_A": True, "RAW_HI_B": True, "FLUSH": 4},
    "A split by a pre-pass": {"text": PRE_PASS},
    "A split by a pre-pass, raw hi for A and B^T, flush every 4": {
        "RAW_HI_A": True, "RAW_HI_B": True, "FLUSH": 4, "text": PRE_PASS},
    "one CTA a tile": {"text": ONE_CTA_A_TILE},
    "8-byte stores, 4 f32 / 6 bf16 stages": {
        "STAGES": 4, "STAGES_BF16": 6, "text": DIRECT_STORES},
    "40 / 232 registers, a word at a time": {
        "SPLIT_BATCH": 1, "PRODUCER_REGS": 40, "CONSUMER_REGS": 232},
    "88 / 208 registers, 11 words at a time": {
        "SPLIT_BATCH": 11, "PRODUCER_REGS": 88, "CONSUMER_REGS": 208},
    # ablations, exact only on integer data (there lo = 0)
    "ablation: one tf32 pass": {"text": [(LO_B_HI + HI_B_HI, ONE)]},
    "ablation: no lo of A": {"text": [
        (LO_B_HI, HI_B_LO), (SPLIT, SPLIT.replace("TILE_BYTES / 16", "0"))]},
}
#: variants that change only one dtype's instance, timed on that one
BF16_ONLY = {"3 bf16 stages", "5 bf16 stages"}
F32_ONLY = {name for name in VARIANTS
            if name not in BF16_ONLY | {"adopted", "one CTA a tile",
                                        "8-byte stores, 4 f32 / 6 bf16 "
                                        "stages"}}


def apply(src: str, settings: dict) -> str:
    """The source with ``settings`` applied (constants, then texts)."""
    for name, value in settings.items():
        if name == "text":
            continue
        kind = "bool" if isinstance(value, bool) else "int"
        pattern = rf"constexpr {kind} {name} = [^;]+;"
        if not re.search(pattern, src):
            raise RuntimeError(f"constant {name} not in the source")
        literal = str(value).lower() if kind == "bool" else str(value)
        src = re.sub(pattern, f"constexpr {kind} {name} = {literal};", src)
    for old, new in settings.get("text", []):
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} not once in the source")
        src = src.replace(old, new)
    return src


def accuracy(got, exact, scale) -> str:
    """Normwise error from float64, outputs beyond rtol = atol = 1e-5 of
    it, and the largest error over sum_k |a b|."""
    d = (got.double() - exact).abs()
    beyond = int((d > 1e-5 + 1e-5 * exact.abs()).sum())
    return (f"normwise {float(d.norm() / exact.norm()):.3g}, {beyond} "
            f"beyond 1e-5 of float64, max |diff| / sum_k |a b| "
            f"{float((d / scale).max()):.3g}")


def build_variants(names):
    """(name, library path, ptxas log) of every variant of ``names`` that
    builds, built together; a variant the same as the source is left
    out."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = _build.SOURCES["masked_matmul_sm90"].read_text()
    procs = []
    for i, name in enumerate(names):
        text = apply(src, VARIANTS[name])
        if name != "adopted" and text == src:
            print(f"variant {name}: the adopted source's own settings")
            continue
        cu, lib = OUT / f"v{i}.cu", OUT / f"libv{i}.so"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    built = []
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        (OUT / f"{lib.stem}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            print(f"variant {name}: nvcc failed, left out:\n{log[-2000:]}")
            continue
        built.append((name, lib, log))
    return built


def ptxas_notes(log: str) -> str:
    """Registers, spills and performance notes of the SDDMM kernels (the
    f32 instance first)."""
    out, keep = [], False
    for ln in log.splitlines():
        if "C75" in ln and "C7519" not in ln:
            out.append(ln.split(")", 1)[-1].strip()[:100])
        elif "Compiling entry function" in ln:
            keep = "masked_matmul_sm90_kernel" in ln
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
            inside = ("masked_matmul_sm90_kernel" in ln
                      and "IfEEv" in ln)       # the f32 instance
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z0-9_.]+)", ln)
            if m:
                ops_[m.group(2).split(".")[0]] += 1
    return (f"{sum(ops_.values())} instructions; " + ", ".join(
        f"{op} {n}" for op, n in ops_.most_common(28)))


def mask_tiles():
    """The tile-8192 mask's 128-blocks, in CSR order (chip_smoke's
    ``tile_problem``)."""
    m = smoke.tile_problem(smoke.TILE_N, smoke.TILE_BS)[2]
    nb = smoke.TILE_N // smoke.TILE_BS
    blk = (m.reshape(nb, smoke.TILE_BS, nb, smoke.TILE_BS) != 0).any(
        axis=(1, 3))
    return np.nonzero(blk)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    asked = sys.argv[1:]
    unknown = [x for x in asked if x not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}")
    built = build_variants(["adopted"] + [x for x in VARIANTS if x in asked
                                          and x != "adopted"] if asked
                           else list(VARIANTS))
    if not built or built[0][0] != "adopted":
        raise RuntimeError("the adopted source does not build")
    libs = {}
    for name, lib, log in built:
        fn = ctypes.CDLL(str(lib)).masked_matmul_sm90_info
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        infos = []
        for dtype in (0, 1):
            info = (ctypes.c_int * 5)()
            err = fn(dtype, ctypes.addressof(info))
            infos.append(f"CUDA error {err}" if err else
                         dict(zip(_build.INFO_FIELDS, info)))
        print(f"variant {name}: f32 {infos[0]}; bf16 {infos[1]}; "
              f"{ptxas_notes(log)}")
        if all(isinstance(x, dict) for x in infos):
            libs[name] = ctypes.CDLL(str(lib))
        elif name == "adopted":
            raise RuntimeError(f"the adopted build cannot launch: {infos}")
        else:
            print(f"variant {name}: cannot launch, left out")
    print("sass adopted: masked_matmul_sm90_kernel<float>: "
          + sass_histogram(built[0][1]))

    def loader(name):
        def load(lib_name, symbol, argtypes):
            fn = getattr(libs[name], symbol)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            return fn
        return load

    def run(name, a, b, bi, bj):
        variant = "mma_sync" if name is None else "sm90"
        saved = _build.load
        if name is not None:
            _build.load = loader(name)
        try:
            return kernel.masked_matmul_kernel(a, b, bi, bj, bm=128, bn=128,
                                               bk=128, variant=variant)
        finally:
            _build.load = saved

    n, k, bs = smoke.TILE_N, smoke.SDDMM_K, smoke.TILE_BS
    bi, bj = (torch.as_tensor(x.astype(np.int32), device=dev)
              for x in mask_tiles())
    nnzb = int(bi.shape[0])
    rng = np.random.default_rng(5)
    for dtype, peak in ((torch.float32, smoke.PEAK_F32_ACCURATE_FLOPS),
                        (torch.bfloat16, smoke.PEAK_BF16_FLOPS)):
        a = torch.as_tensor(rng.integers(-4, 5, (n, k)), dtype=dtype,
                            device=dev)
        b = torch.as_tensor(rng.integers(-4, 5, (k, n)), dtype=dtype,
                            device=dev)
        want = kernel.masked_matmul_plain(a, b, bi, bj, bm=bs, bn=bs)
        skip = BF16_ONLY if dtype == torch.float32 else F32_ONLY
        contenders = [v for v in libs if v not in skip]
        contenders.append(None)
        for name in list(contenders):
            got = run(name, a, b, bi, bj)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                diff = float((got - want).abs().max())
                if name in (None, "adopted"):
                    raise RuntimeError(f"{name or 'mma.sync'} {dtype}: "
                                       f"max |diff| {diff} from plain")
                print(f"variant {name} {dtype}: max |diff| {diff} from the "
                      f"plain version, left out")
                contenders.remove(name)
            del got
        del want
        times = collections.defaultdict(list)
        for turn in range(4):
            for name in (contenders if turn % 2 == 0 else contenders[::-1]):
                times[name].append(smoke.kernel_ms(
                    lambda: run(name, a, b, bi, bj), dev))
        flops = 2.0 * nnzb * bs * bs * k
        nbytes = a.nbytes + b.nbytes + 8 * nnzb + nnzb * bs * bs * 4
        bound_ms, by = smoke.bound(flops, nbytes, peak)
        what = f"sddmm-8192 {str(dtype).split('.')[-1]}"
        print(f"{what}: M=N={n} K={k} nnzb={nnzb}: bound {bound_ms:.4f} ms "
              f"(by {by})")
        for name in contenders:
            t = statistics.median(times[name])
            print(f"{what} {name or 'mma.sync kernel'}: median {t:.4f} ms "
                  f"over 4 turns ({bound_ms / t:.1%} of the bound; "
                  + ", ".join(f"{x:.4f}" for x in times[name]) + ")")
        del a, b

    # f32 accuracy on standard-normal data: at the path's shape, and at
    # the GPU tests' 128-block case with K = 384 (tests/test_torch_cuda.py
    # test_masked_matmul_kernel_matches_plain, seed 256), which holds each
    # output to rtol = atol = 1e-5 of float64
    r384 = np.random.default_rng(256)
    cases = [("sddmm-8192", rng.standard_normal((n, k)),
              rng.standard_normal((k, n)), bi, bj),
             ("K = 384 test case", r384.standard_normal((512, 384)),
              r384.standard_normal((384, 384)), None, None)]
    ok = r384.random((4, 3)) < 0.5
    ok[0, 0] = True
    cases[1] = cases[1][:3] + tuple(
        torch.as_tensor(x.astype(np.int32), device=dev)
        for x in np.nonzero(ok))
    for what, x, y, ti, tj in cases:
        x, y = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                for v in (x, y))
        exact = smoke.sddmm_f64(x, y, ti, tj, bs, bs)
        scale = kernel.masked_matmul_plain(x.abs(), y.abs(), ti, tj, bm=bs,
                                           bn=bs)
        for name in [v for v in libs if v not in BF16_ONLY
                     and not v.startswith("ablation")] + [None]:
            got = run(name, x, y, ti, tj)
            print(f"{what} f32 accuracy, {name or 'mma.sync kernel'}: "
                  f"{accuracy(got, exact, scale)}")
            del got
        del exact, scale
    return 0


if __name__ == "__main__":
    sys.exit(main())
