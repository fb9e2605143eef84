#!/usr/bin/env python3
"""The two ways ``apply_csr_delta`` builds the post-delta CSR, timed on
tile-8192's A, alone and inside ``QueryEngine.submit_delta`` on one GPU.

    python3 tools/apply_delta_paths.py        # from the repository root

``apply_csr_delta`` splices the changed rows into a copy of the operand
when every row is column-sorted (O(nnz) copies of the runs of unchanged
rows), and otherwise re-sorts every entry as the reference does
(``csr_from_coo``'s lexsort).  This builds tile-8192's operands
(``chip_smoke.py``'s ``tile_problem``; A has 18.3 M entries, every row
sorted) and the delta-tile-8192 delta (64 upserts in 16 rows of A), then
times the splice and the re-sort (forced by reporting A's rows as
unsorted) in turns, the first of each pair alternating:

  * ``apply_csr_delta`` alone, given the old incremental signature (as
    ``submit_delta``'s memo gives it), five pairs;
  * ``submit_delta`` on the card with the tile plan warm and the
    signature memoized, three pairs, each call ended by a synchronise.

Checks that both ways give the same arrays, and prints the card's name and
power limit, then every time and the medians (ms) as one JSON line.
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

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import formats as F  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.serving import QueryEngine  # noqa: E402

N, BS = 8192, 128
DELTA_ROWS, DELTA_UPSERTS = 16, 64


class resorted:
    """Within the block, ``apply_csr_delta`` takes its re-sort path."""

    def __enter__(self):
        self.saved = F._rows_ascending
        F._rows_ascending = lambda x: False

    def __exit__(self, *exc):
        F._rows_ascending = self.saved


def timed(fn, dev=None) -> float:
    t0 = time.perf_counter()
    fn()
    if dev is not None:
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3


def pairs(fn, turns: int) -> dict:
    """``fn`` timed ``turns`` times each way, the first of a pair
    alternating."""
    out = {"splice": [], "resort": []}
    for t in range(turns):
        order = ("splice", "resort") if t % 2 == 0 else ("resort", "splice")
        for way in order:
            if way == "resort":
                with resorted():
                    out[way].append(fn())
            else:
                out[way].append(fn())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("apply_delta_paths: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    A = F.csr_from_dense(F.block_sparse(N, BS, 0.3, 0.9, seed=1))
    B = F.csr_from_dense(F.block_sparse(N, BS, 0.3, 0.9, seed=2))
    M = F.csr_from_dense(F.block_sparse(N, BS, 0.6, 1.0, seed=3, mask=True))
    rng = np.random.default_rng(17)
    rows = np.repeat(rng.choice(N, DELTA_ROWS, replace=False),
                     DELTA_UPSERTS // DELTA_ROWS)
    d = F.CSRDelta.upserts(rows, rng.integers(0, N, len(rows)),
                           rng.integers(1, 5, len(rows)).astype(np.float32))
    sig = F.incremental_signature(A)

    spliced = F.apply_csr_delta(A, d, old_signature=sig)
    with resorted():
        resort = F.apply_csr_delta(A, d, old_signature=sig)
    for name in ("indptr", "indices", "data"):
        x, y = getattr(spliced.csr, name), getattr(resort.csr, name)
        if not (x.dtype == y.dtype and np.array_equal(x, y)):
            print(f"apply_delta_paths: the two ways differ in {name}",
                  file=sys.stderr)
            return 1
    if spliced.signature != resort.signature:
        print("apply_delta_paths: the two ways differ in the signature",
              file=sys.stderr)
        return 1

    apply_ms = pairs(lambda: timed(
        lambda: F.apply_csr_delta(A, d, old_signature=sig)), 5)

    planner.clear_plan_cache()
    eng = QueryEngine(device=dev)
    eng.submit_delta(A, B, M, delta_a=d)        # plans, memoizes the sig
    out = eng.submit_delta(A, B, M, delta_a=d)
    if not (out.plan_survived and out.plan.algorithm == "tile"):
        print("apply_delta_paths: the tile plan did not survive",
              file=sys.stderr)
        return 1
    submit_ms = pairs(lambda: timed(
        lambda: eng.submit_delta(A, B, M, delta_a=d), dev), 3)
    eng.close()

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    report = {"nnz_a": int(A.nnz), "delta": len(d),
              "apply_ms": apply_ms, "submit_delta_ms": submit_ms,
              "median_apply_ms": {k: statistics.median(v)
                                  for k, v in apply_ms.items()},
              "median_submit_delta_ms": {k: statistics.median(v)
                                         for k, v in submit_ms.items()}}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
