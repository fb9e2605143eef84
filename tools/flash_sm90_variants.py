#!/usr/bin/env python3
"""Compare build variants of the Hopper bf16 flash kernel on one GPU.

    python3 tools/flash_sm90_variants.py        # from the repository root

Each variant is the package's ``flash_mask_sm90.cu`` with text
substitutions, compiled with the package's ``nvcc`` flags into
``build/flash_sm90_variants/`` (one ``nvcc`` per variant, all started
together) and launched through the package's wrapper on the same tensors at
the four shapes the main path gives the bf16 kernel: the full-width
llama3.2-1b layer (B 4, Hq 32, Hkv 8, S 2048, D 64, causal), moonshot's
(B 1, 16/16, D 128, causal), zamba2's (B 1, 32/32, D 112, causal) and
seamless's encoder (B 1, 16/16, D 64, non-causal), all at 128-blocks.
The variants: p.v in one, two or four batches of keys (four adopted: at
D 112 and 128 fewer left ptxas serialising the wgmma for want of
registers) and the scores scaled before the row max instead of the scale
folded into the exponential.
Every variant is first held to the plain version at each shape (rtol 1e-2,
atol 1e-3 and 2e-3 normwise, the layer's limits); then all of them and the
``mma.sync`` kernel are timed with CUDA events in turns (forward, backward,
forward, backward), and the median of each one's turns is printed beside
its registers, spills and ptxas's performance notes (ptxas prints the
notes before the "Compiling entry" lines); the static opcode
histogram of the adopted ``flash_mask_sm90_kernel<128, 128, 64>`` comes
first (``cuobjdump -sass``).
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

OUT = REPO / "build" / "flash_sm90_variants"
BATCHES = "constexpr int PV_BATCHES = 4;"
FOLD = "        if (scale_log2 > 0.0f)\n"

#: variant name -> text substitutions in flash_mask_sm90.cu; the first is
#: the source as it stands
VARIANTS = {
    "adopted": [],
    "p.v in one batch": [(BATCHES, BATCHES.replace("4", "1"))],
    "p.v in two batches": [(BATCHES, BATCHES.replace("4", "2"))],
    "scores scaled before the max": [(FOLD, "        if (false)\n")],
}
#: (name, B, Hq, Hkv, D, causal) of the main path's shapes, S 2048
SHAPES = (("llama", 4, 32, 8, 64, True), ("moonshot", 1, 16, 16, 128, True),
          ("zamba2", 1, 32, 32, 112, True),
          ("seamless", 1, 16, 16, 64, False))

def build_variants():
    """(name, library path, ptxas log) of every variant, built together."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = _build.SOURCES["flash_mask_sm90"].read_text()
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
    """Registers, spills and performance notes of the <128, 128, *>
    instances."""
    out, keep = [], False
    for ln in log.splitlines():
        if ("C75" in ln and "kernelILi128ELi128E" in ln
                and "C7519" not in ln):
            out.append(ln.split(")", 1)[1].split(" for the function")[0]
                       .split(" in function")[0].strip()[:90] + " <128, 128, "
                       + ln.split("kernelILi128ELi128ELi")[1].split("E")[0]
                       + ">")
            continue
        if "Compiling entry function" in ln:
            keep = "kernelILi128ELi128E" in ln
            if keep:
                out.append("<128, 128, " + ln.split("kernelILi128ELi128ELi")[1]
                           .split("E")[0] + ">")
        elif keep and ("Used" in ln or "spill" in ln or "C75" in ln
                       or "Performance" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return "; ".join(out)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    built = build_variants()
    fns = {}
    for name, lib, log in built:
        fn = getattr(ctypes.CDLL(str(lib)), "flash_mask_sm90")
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
            inside = "kernelILi128ELi128ELi64E" in ln
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z0-9_.]+)", ln)
            if m:
                ops[m.group(2).split(".")[0]] += 1
    print(f"sass adopted: flash_mask_sm90_kernel<128, 128, 64>: "
          f"{sum(ops.values())} instructions; " + ", ".join(
              f"{op} {n}" for op, n in ops.most_common(24)))

    contenders = dict(fns)
    contenders["mma.sync kernel"] = None
    for what, b, hq, hkv, d, causal in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(7)
        q, k, v = ((torch.randn(shape, generator=gen, device=dev) * 0.5)
                   .to(torch.bfloat16) for shape in (
                       (b, hq, 2048, d), (b, hkv, 2048, d),
                       (b, hkv, 2048, d)))
        sched = [torch.as_tensor(x, device=dev) for x in flash.build_schedule(
            2048, 2048, bq=128, bk=128, causal=causal, window=0, prefix=0,
            q_offset=0)]
        kw = dict(bq=128, bk=128, scale=d ** -0.5, causal=causal, window=0,
                  prefix=0, q_offset=0)
        args = (q, k, v, *sched)
        want = flash.flash_mask_plain(*args, **kw).float()
        for name, fn in contenders.items():
            got = run(fn, *args, **kw).float()
            torch.cuda.synchronize()
            diff = got - want
            rel = float(diff.norm() / want.norm())
            if not (torch.allclose(got, want, rtol=1e-2, atol=1e-3)
                    and rel <= 2e-3):
                raise RuntimeError(f"{name} at {what}: not within the "
                                   f"layer's limits (normwise {rel:.3g}, "
                                   f"max {float(diff.abs().max()):.3g})")
        times = collections.defaultdict(list)
        order = list(contenders)
        for turn in range(4):
            for name in (order if turn % 2 == 0 else order[::-1]):
                fn = contenders[name]
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
            print(f"{what} {name}: median "
                  f"{statistics.median(times[name]):.4f} ms over 4 turns ("
                  + ", ".join(f"{t:.4f}" for t in times[name]) + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
