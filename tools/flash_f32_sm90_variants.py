#!/usr/bin/env python3
"""Compare build variants of the Hopper f32 flash kernel on one GPU.

    python3 tools/flash_f32_sm90_variants.py     # from the repository root

Each variant is the package's ``flash_mask_f32_sm90.cu`` with text
substitutions, compiled with the package's ``nvcc`` flags into
``build/flash_f32_sm90_variants/`` (one ``nvcc`` per variant, all started
together) and launched through the package's wrapper on the same f32
tensors (0.5 randn) at the shapes the main path gives the f32 kernel, all
at 128-blocks and S 2048: the llama3.2-1b layer at B 1 (its f32 prefill)
and B 4 (Hq 32, Hkv 8, D 64, causal), moonshot's (B 1, 16/16, D 128,
causal), zamba2's (B 1, 32/32, D 112, causal) and seamless's encoder (B 1,
16/16, D 64, non-causal).  The variants: the q.k^T flush every 4 k8
steps instead of 8, the p.v flush every 2 or 4 k8 steps instead of every
one (at D 64), chunks of 32 keys at D 64 instead of 64, one stage instead
of two (two is the most that shared memory holds), the two consumer
warpgroups issuing q.k^T without taking turns, the register split
(setmaxnreg: producer / consumers) 56 / 224 or 88 / 208 instead of
72 / 216, the splitters' loads one 16-byte word at a time, the hi of every
split rounded (rna) and stored instead of the raw f32 word (which tf32
wgmma reads as its upper 19 bits, truncated), p's hi passed to wgmma as
the S accumulator's own register instead of a truncated copy; and three
ablations that do not keep f32 accuracy or the result, reported but not
held: one tf32 pass for each product (hi.hi only), no split of k or v at
all (the producer's three warps only arrive), and p.v without p's lo
term.  Every variant is first held to the plain version at each shape
(rtol = atol = 2e-5) and to float64 (2e-6 normwise, at llama B 1), the
ablations only reported; then all of them and the ``mma.sync`` kernel are
timed in turns (forward, backward, forward, backward), each turn the
device time per call over the calls queued behind a device-side sleep
(``chip_smoke.kernel_ms``), and the median of each one's turns is printed
with its registers, spills and ptxas's notes and each shape's f32 bound
(as ``chip_smoke.f32_instance`` computes it); the static opcode histogram
of the adopted ``<128, 64>`` instance comes first (``cuobjdump -sass``).
About 85 s of command on the card.
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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_mask import kernel as flash  # noqa: E402

OUT = REPO / "build" / "flash_f32_sm90_variants"
FQK = "constexpr int FLUSH_QK = 8;"
FPV = "constexpr int FLUSH_PV = 1;"
STAGES = "constexpr int STAGES = 2;"
PRODUCER = "constexpr int PRODUCER_REGS = 72;"
CONSUMER = "constexpr int CONSUMER_REGS = 216;"
BATCH = "constexpr int SPLIT_BATCH = 4;"
RAW = "constexpr bool RAW_HI = true;"
KC = "KC = DP == 64 ? 64 : 32;"
P_HI = """  hi = RAW_HI ? __float_as_uint(x) & 0xffffe000u : rna_bits(x);
  lo = rna_bits(x - __uint_as_float(hi));
"""
TURNS = "constexpr bool PINGPONG = true;"
K_SPLIT = "        if (in) {\n          // k: lo beside"
V_SPLIT = "        if (in) {\n          // v^T: lane"
QK3 = """            Scores<KC>::mma(d, dql, dkh, kk > g0);
            Scores<KC>::mma(d, dqh, dkl, 1);
            Scores<KC>::mma(d, dqh, dkh, 1);
"""
PV3 = """            Values<DP>::mma(part, lo[i], dvh, i > 0);
            Values<DP>::mma(part, hi[i], dvl, 1);
            Values<DP>::mma(part, hi[i], dvh, 1);
"""

#: variant name -> (text substitutions in flash_mask_f32_sm90.cu, held to
#: f32 accuracy); the first is the source as it stands
VARIANTS = {
    "adopted": ([], True),
    "q.k^T flush every 4": ([(FQK, FQK.replace("8", "4"))], True),
    "p.v flush every 2": ([(FPV, FPV.replace("1", "2"))], True),
    "p.v flush every 4": ([(FPV, FPV.replace("1", "4"))], True),
    "32-key chunks at D 64": ([(KC, KC.replace("64 ? 64", "64 ? 32"))],
                              True),
    "1 stage": ([(STAGES, STAGES.replace("2", "1"))], True),
    "no ping-pong": ([(TURNS, TURNS.replace("true", "false"))], True),
    "registers 56 / 224": ([(PRODUCER, PRODUCER.replace("72", "56")),
                            (CONSUMER, CONSUMER.replace("216", "224"))],
                           True),
    "registers 88 / 208": ([(PRODUCER, PRODUCER.replace("72", "88")),
                            (CONSUMER, CONSUMER.replace("216", "208"))],
                           True),
    "splitters load 1 word": ([(BATCH, BATCH.replace("4", "1"))], True),
    "hi rounded and stored": ([(RAW, RAW.replace("true", "false"))], True),
    "p's hi its S register": ([(P_HI, """  const uint32_t h = __float_as_uint(x) & 0xffffe000u;
  hi = __float_as_uint(x);
  lo = rna_bits(x - __uint_as_float(h));
""")], True),
    "ablation: one tf32 pass": ([
        (QK3, "            Scores<KC>::mma(d, dqh, dkh, kk > g0);\n"),
        (PV3, "            Values<DP>::mma(part, hi[i], dvh, i > 0);\n")],
        False),
    "ablation: no split of k or v": ([
        (K_SPLIT, K_SPLIT.replace("(in)", "(false)")),
        (V_SPLIT, V_SPLIT.replace("(in)", "(false)"))], False),
    "ablation: p.v without p_lo": ([
        (PV3, """            Values<DP>::mma(part, hi[i], dvl, i > 0);
            Values<DP>::mma(part, hi[i], dvh, 1);
""")], False),
}
#: (name, B, Hq, Hkv, D, causal) of the main path's f32 shapes, S 2048
SHAPES = (("llama B1", 1, 32, 8, 64, True), ("llama B4", 4, 32, 8, 64, True),
          ("moonshot", 1, 16, 16, 128, True),
          ("zamba2", 1, 32, 32, 112, True),
          ("seamless", 1, 16, 16, 64, False))


def build_variants():
    """(name, library path, ptxas log) of every variant, built together."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = _build.SOURCES["flash_mask_f32_sm90"].read_text()
    procs = []
    for i, (name, (subs, _)) in enumerate(VARIANTS.items()):
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
    """Registers, spills and performance notes of each instance."""
    out, keep = [], None
    for ln in log.splitlines():
        m = re.search(r"kernelILi(\d+)ELi(\d+)E", ln)
        if "Compiling entry function" in ln and m:
            keep = f"<{m.group(1)}, {m.group(2)}>"
            out.append(keep)
        elif "C75" in ln and m and "C7519" not in ln:
            out.append(ln.split(")", 1)[1].split(" for the function")[0]
                       .split(" in function")[0].strip()[:90]
                       + f" <{m.group(1)}, {m.group(2)}>")
        elif keep and ("Used" in ln or "spill" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return "; ".join(out)


def normwise_f64(q, k, v, got, causal: bool) -> float:
    """|got - exact| / |exact| over the batch, float64 one row at a
    time."""
    g = q.shape[1] // k.shape[1]
    num = den = 0.0
    s = q.shape[2]
    for i in range(q.shape[0]):
        ke, ve = (x[i].repeat_interleave(g, dim=0).double() for x in (k, v))
        sc = (q[i].double() @ ke.transpose(-1, -2)) * q.shape[-1] ** -0.5
        if causal:
            sc.masked_fill_(torch.ones(s, s, dtype=torch.bool,
                                       device=q.device).triu_(1),
                            float("-inf"))
        exact = torch.softmax(sc, -1) @ ve
        num += float((got[i].double() - exact).norm()) ** 2
        den += float(exact.norm()) ** 2
    return (num / den) ** 0.5


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    built = build_variants()
    fns = {}
    for name, lib, log in built:
        fn = getattr(ctypes.CDLL(str(lib)), "flash_mask_f32_sm90")
        fn.argtypes, fn.restype = flash._SM90_ARGS, ctypes.c_int
        fns[name] = fn
        print(f"variant {name}: {ptxas_notes(log)}")

    def run(fn, *args, **kw):
        if fn is None:
            return flash.flash_mask_kernel(*args, variant="mma_sync", **kw)
        saved = _build.load
        _build.load = lambda *a: fn
        try:
            return flash.flash_mask_kernel(*args, variant="sm90", **kw)
        finally:
            _build.load = saved

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(built[0][1])],
                          capture_output=True, text=True).stdout
    ops, inside = collections.Counter(), False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = "kernelILi128ELi64E" in ln
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z0-9_.]+)", ln)
            if m:
                ops[m.group(2).split(".")[0]] += 1
    print(f"sass adopted: flash_mask_f32_sm90_kernel<128, 64>: "
          f"{sum(ops.values())} instructions; " + ", ".join(
              f"{op} {n}" for op, n in ops.most_common(24)))

    contenders = dict(fns)
    contenders["mma.sync kernel"] = None
    held = {name: gate for name, (_, gate) in VARIANTS.items()}
    held["mma.sync kernel"] = True
    for what, b, hq, hkv, d, causal in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(8)
        q, k, v = (torch.randn(shape, generator=gen, device=dev) * 0.5
                   for shape in ((b, hq, 2048, d), (b, hkv, 2048, d),
                                 (b, hkv, 2048, d)))
        sched = [torch.as_tensor(x, device=dev) for x in flash.build_schedule(
            2048, 2048, bq=128, bk=128, causal=causal, window=0, prefix=0,
            q_offset=0)]
        kw = dict(bq=128, bk=128, scale=d ** -0.5, causal=causal, window=0,
                  prefix=0, q_offset=0)
        args = (q, k, v, *sched)
        want = flash.flash_mask_plain(*args, **kw)
        for name, fn in contenders.items():
            got = run(fn, *args, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            note = f"{what} {name}: max |diff| from plain {err:.3g}"
            if what == "llama B1":
                rel = normwise_f64(q, k, v, got, causal)
                note += f", normwise from float64 {rel:.3g}"
                if held[name] and rel > 2e-6:
                    raise RuntimeError(note + " (limit 2e-6)")
            if held[name] and not torch.allclose(got, want, rtol=2e-5,
                                                 atol=2e-5):
                raise RuntimeError(note + " (limit 2e-5)")
            print(note + ("" if held[name] else " (ablation: not held)"))
        times = collections.defaultdict(list)
        order = list(contenders)
        for turn in range(4):
            for name in (order if turn % 2 == 0 else order[::-1]):
                fn = contenders[name]
                times[name].append(smoke.kernel_ms(
                    lambda: run(fn, *args, **kw), dev,
                    calls=8 if b > 1 else 10))
        # the bound as chip_smoke's f32_instance computes it: the allowed
        # elements' operations at three TF32 passes, q, k, v and the
        # output read or written once, 12 bytes a worklist entry
        allowed = int(smoke.mask_allowed(2048, 2048, causal=causal,
                                         window=0, prefix=0,
                                         q_offset=0).sum())
        bound_ms, by = smoke.bound(
            4.0 * b * hq * allowed * d,
            4 * (q.numel() * 2 + k.numel() + v.numel())
            + 12 * int(sched[0].shape[0]), smoke.PEAK_F32_ACCURATE_FLOPS)
        print(f"{what}: B={b} Hq={hq} Hkv={hkv} S=2048 D={d} "
              f"{'causal' if causal else 'non-causal'}: f32 bound "
              f"{bound_ms:.4f} ms (by {by}, three TF32 passes)")
        for name in order:
            t = statistics.median(times[name])
            print(f"{what} {name}: median {t:.4f} ms over 4 turns "
                  f"({bound_ms / t:.1%} of the bound; "
                  + ", ".join(f"{x:.4f}" for x in times[name]) + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
