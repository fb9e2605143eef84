#!/usr/bin/env python3
"""A cold burst program's build time and device bytes at serve-burst-8192
on one GPU.

    python3 tools/burst_program_cost.py [--src DIR]   # from the repo root

Builds ``chip_smoke.py``'s burst structure (A and B
``erdos_renyi(8192, 2, seed=100/200)``, M ``er_mask(8192, 1024,
seed=300)``), plans it on the card, then builds its ``BurstProgram`` cold
five times, each build ended by a synchronise.  For each: the build's ms
and the device bytes the program holds (``torch.cuda.memory_allocated``
with the program alive, less before its build).  ``--src`` imports
``repro_torch`` from another checkout's ``src`` directory, to compare two
commits in one run.  Prints the card's name and power limit, then one
JSON line.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

N = 8192
BUILDS = 5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(
        Path(__file__).resolve().parents[1] / "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("burst_program_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.core import formats as F
    from repro_torch.core import planner
    from repro_torch.core.semiring import PLUS_TIMES
    from repro_torch.serving import burst

    dev = torch.device("cuda")
    A, B = F.erdos_renyi(N, 2, seed=100), F.erdos_renyi(N, 2, seed=200)
    M = F.er_mask(N, N // 8, seed=300)
    wm = planner.plan(A, B, M, device=dev).widths[2]
    ms, held = [], []
    for _ in range(BUILDS):
        gc.collect()
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        prog = burst.BurstProgram(A, B, M, PLUS_TIMES, wm, device=dev)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        held.append(torch.cuda.memory_allocated(dev) - before)
        del prog
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps({"src": args.src, "build_ms": ms,
                      "median_build_ms": statistics.median(ms),
                      "device_bytes": held}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
