#!/usr/bin/env python3
"""Fit planner cost profiles on the card on two probe grids and hold each
fit against the cells' measured times.

    python3 tools/h100_calibration.py [--outdir build/calibration]
                                      [--passes 3]

Runs on one CUDA card (it fails without one):

1. the probes of ``repro_torch.tuning`` (``row`` and ``tile``) on the
   reference's full grids, the first entries of ``probes.ROW_GRID`` and
   ``probes.TILE_GRID`` (the planner's elections at the cells sit at
   n = 8192-16384, far beyond them), and fitted from the builtin
   constants as ``python -m repro_torch.tune`` fits them: ``ref``;
2. the same on the port's full grids, which add points of the same
   generator families at n = 4096 and 8192: ``ext``;
3. ``--passes`` - 1 more fits of the extended measurements, each with the
   previous fit as its base (the prior and the per-constant floor,
   ``fit.FLOOR_FRAC`` of the base, move with it): ``ext2``, ``ext3``, ...;
4. ``chip_smoke.elections`` at the cells (tile-8192, tc-rmat14,
   serve-burst-8192, serve-mixed-8192's other structures) under the
   builtin constants and every fit: the elected route, each elected
   route's model ms under every profile, its measured warm ms, and the
   results of routes that differ compared bit for bit; then every row
   algorithm's warm ms at the row cells, for any later fit to be held
   against.

Writes each fit's profile, the measurements and ``summary.json`` into
``--outdir``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import tuning  # noqa: E402
from repro_torch.core import formats as F  # noqa: E402
from repro_torch.core.masked_spgemm import ALGORITHMS  # noqa: E402
from repro_torch.core.masked_spgemm import masked_spgemm  # noqa: E402
from repro_torch.tuning import fit, probes  # noqa: E402

#: a row algorithm whose per-row expansion (wa * wb * m) exceeds this is
#: not timed at the row cells
ROW_WORK_LIMIT = 2e10


def probe(dev, row_grid, tile_grid, log):
    probes.ROW_GRID, probes.TILE_GRID = row_grid, tile_grid
    t0 = time.perf_counter()
    ms = probes.run_probes(("row", "tile"), device=dev, log=log)
    return ms, time.perf_counter() - t0


def warm_ms(call, dev, reps: int = cs.ELECTION_REPS) -> float:
    call()
    cs.sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        cs.sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--outdir", default="build/calibration")
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args(argv)
    out = Path(args.outdir)
    out.mkdir(parents=True, exist_ok=True)
    cs.card()
    dev = torch.device("cuda", 0)
    backend = tuning.backend_signature(dev)
    meta = tuning.profile.device_meta(dev)
    builtin = cs.builtin_profile(dev)
    summary = {"card": cs.CARD, "backend": backend, "fits": {}}
    profiles = {"builtin": builtin}

    def log(line):
        print(line, flush=True)

    grids = {"ref": (probes.ROW_GRID[:2], probes.TILE_GRID[:1]),
             "ext": (probes.ROW_GRID, probes.TILE_GRID)}
    for name, (row_grid, tile_grid) in grids.items():
        ms, secs = probe(dev, row_grid, tile_grid, log)
        (out / f"measurements_{name}.json").write_text(
            json.dumps([m.to_dict() for m in ms]))
        base = builtin
        for k in range(1 if name == "ref" else args.passes):
            label = name if k == 0 else f"{name}{k + 1}"
            prof = fit.fit_profile(ms, base, families=("row", "tile"),
                                   name=label, backend=backend, **meta)
            prof.save(str(out / f"{label}.json"))
            profiles[label] = prof
            summary["fits"][label] = {
                "probe_s": secs, "measurements": len(ms),
                "residuals": prof.residuals, "tile_cost": prof.tile_cost,
                "tile_gates": prof.tile_gates,
                "cost_constants": prof.cost_constants}
            print(f"calibration [{cs.CARD}]: fit {label}: {len(ms)} "
                  f"measurements ({secs:.1f} s of probes), residuals "
                  f"{prof.residuals}, tile cost {prof.tile_cost}, gates "
                  f"{prof.tile_gates}", flush=True)
            base = prof

    tile_ops = tuple(F.csr_from_dense(x)
                     for x in cs.tile_problem(cs.TILE_N, cs.TILE_BS))
    cells = cs.tuning_cells(tile_ops)
    try:
        summary["elections"] = cs.elections(dev, cells, profiles)
    finally:
        tuning.activate(builtin)
    row_ms = {}
    for name, (A, B, M) in cells.items():
        if name.startswith("tile"):
            continue
        stats = cs.planner.collect_stats(A, B, M)
        row_ms[name] = {}
        for alg in ALGORITHMS:
            if alg in ("heap", "heapdot") and (
                    stats.wa * stats.wb * stats.m > ROW_WORK_LIMIT):
                row_ms[name][alg] = None
                continue
            row_ms[name][alg] = warm_ms(
                lambda alg=alg: masked_spgemm(A, B, M, algorithm=alg,
                                              device=dev), dev)
        print(f"calibration [{cs.CARD}]: {name}: every row algorithm (ms, "
              f"median of {cs.ELECTION_REPS} warm): {row_ms[name]}",
              flush=True)
    summary["row_ms"] = row_ms
    (out / "summary.json").write_text(json.dumps(summary, indent=1,
                                                 sort_keys=True))
    print(f"calibration: wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
