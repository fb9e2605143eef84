"""Microbenchmark probe suite: the measurements the fit solves against.

Three probe families mirror the three constant tables:

* ``row``  — every row kernel on an ER input-degree x mask-degree grid,
  solving for ``accumulators.COST_CONSTANTS``;
* ``tile`` — the end-to-end BCSR tile route (on a CUDA device: the fused
  ``block_spgemm`` kernel) on block-structured operands plus uniform-ER
  controls, with one reference row-kernel timing per point, solving for
  ``planner.TILE_COST`` and informing the ``TILE_MIN_*`` gates;
* ``dist`` — the distributed routes (the sparse ring and row-parallel)
  over meshes of 2 and 4 shards on block-structured operands plus an ER
  control, solving for ``planner.DIST_COST``.  The mesh is
  ``make_mesh(p, device)``: on a one-card host every shard shares the card,
  so the rotations cross no link and the fit prices none.

Every probe runs on ``device`` (default ``"cuda"``; pass ``"cpu"`` to
probe the host): each timed call is the user's ``masked_spgemm`` on host
CSR operands, uploads included, ended by ``torch.cuda.synchronize`` on a
CUDA device.  The generators (``erdos_renyi``, ``er_mask``,
``block_sparse``) draw what the reference's draw, point for point.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

#: probe families, in fit order (tile consumes row's fit, dist both)
FAMILIES = ("row", "tile", "dist")

#: row grids: (n, input degrees, mask degrees, timed iterations).  The
#: smoke grid and the first two full entries are the reference's.  On an
#: H100 those calls are launch-bound (1-5 ms), and a fit on them alone
#: predicted the cells (n = 8192-16384) 22-67x too slow, so the full grid
#: adds the same ER families at n = 4096 and 8192, with the serving
#: burst's mask degree n / 8 beside the reference's mask degrees
ROW_GRID_SMOKE = ((256, (2, 8), (2, 8), 1),)
ROW_GRID = ((512, (2, 8, 32), (2, 8, 32), 2),
            (1024, (2, 8, 32), (2, 8, 32), 2),
            (4096, (2, 8, 32), (2, 8, 32, 512), 2),
            (8192, (2, 8, 32), (2, 8, 32, 1024), 2))
#: tile grids: (n, block sizes, tile densities, mask occupancies, timed
#: iterations).  The smoke grid and the first full entry are the
#: reference's and keep its point labels; the entries at n = 4096 and
#: 8192 (the block sizes the planner elects there, the reference's
#: densities) add ``n<n>_`` to theirs
TILE_GRID_SMOKE = ((128, (8, 16), (0.3,), (0.5,), 1),)
TILE_GRID = ((512, (8, 32), (0.1, 0.3), (0.2, 0.6), 2),
             (4096, (32, 128), (0.1, 0.3), (0.2, 0.6), 2),
             (8192, (128,), (0.1, 0.3), (0.2, 0.6), 2))
#: untimed calls before each timed point
WARMUP = 1

@dataclasses.dataclass(frozen=True)
class Measurement:
    """One timed probe point.

    ``features`` carries the PlanStats fields (plus family extras such as
    ``bs``/``p``) the fit needs to rebuild the model's feature vector —
    the probe records *what was measured*, the fit decides *how to use
    it*.
    """

    family: str          # "row" | "tile" | "dist"
    target: str          # algorithm or route that was timed
    point: str           # grid-point label (diagnostics)
    seconds: float       # min-of-k wall seconds
    features: Dict[str, float]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Measurement":
        return cls(family=d["family"], target=d["target"], point=d["point"],
                   seconds=float(d["seconds"]), features=dict(d["features"]))


def _device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA request without a card
    raises (a probe never falls back to the host)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return dev


def _min_time(fn, iters: int, warmup: int = WARMUP) -> float:
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _timed_call(device: torch.device, **kw):
    """A probe call: ``masked_spgemm(**kw)`` on ``device``, ended by a
    synchronise on a CUDA device (nothing on the CPU)."""
    from repro_torch.core.masked_spgemm import masked_spgemm

    def go():
        masked_spgemm(device=device, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    return go


def _stats_features(stats) -> Dict[str, float]:
    return {k: float(v) if not isinstance(v, (str, bool)) else v
            for k, v in dataclasses.asdict(stats).items()}


# ---------------------------------------------------------------------------
# Row-kernel probes
# ---------------------------------------------------------------------------


def probe_row(*, smoke: bool = False, log=print,
              device="cuda") -> List[Measurement]:
    """Time every row kernel on an ER degree grid; one Measurement per
    (point, algorithm)."""
    from repro_torch.core.formats import er_mask, erdos_renyi
    from repro_torch.core.masked_spgemm import ALGORITHMS
    from repro_torch.core.planner import collect_stats

    dev = _device(device)
    out: List[Measurement] = []
    for n, degrees, mask_degrees, iters in (ROW_GRID_SMOKE if smoke
                                            else ROW_GRID):
        for d in degrees:
            A = erdos_renyi(n, d, seed=10 + d)
            B = erdos_renyi(n, d, seed=20 + d)
            for dm in mask_degrees:
                M = er_mask(n, dm, seed=30 + dm)
                stats = collect_stats(A, B, M)
                feats = _stats_features(stats)
                point = f"row_n{n}_d{d}_m{dm}"
                for algo in ALGORITHMS:
                    secs = _min_time(_timed_call(dev, A=A, B=B, M=M,
                                                 algorithm=algo), iters)
                    out.append(Measurement("row", algo, point, secs, feats))
                log(f"[tune/row] {point}: " + " ".join(
                    f"{m.target}={m.seconds * 1e3:.1f}ms"
                    for m in out[-len(ALGORITHMS):]))
    return out


# ---------------------------------------------------------------------------
# Tile-route probes
# ---------------------------------------------------------------------------


def tile_points(n: int, bs: int, tds: Sequence[float],
                mos: Sequence[float], label_n: bool = False):
    """The tile family's operands at one (n, bs), one point at a time:
    ``(point, A, B, M)`` dense arrays, the block-sparse points then the
    uniform-ER control (the regime the gates must keep OUT of the tile
    route — its loss margin anchors the density/occupancy fit)."""
    from repro_torch.core.formats import block_sparse, er_mask, erdos_renyi

    tag = f"n{n}_" if label_n else ""
    for td in tds:
        for mo in mos:
            yield (f"tile_{tag}bs{bs}_td{td}_mo{mo}",
                   block_sparse(n, bs, td, 0.9, seed=100 + bs),
                   block_sparse(n, bs, td, 0.9, seed=200 + bs),
                   block_sparse(n, bs, mo, 1.0, seed=300 + int(mo * 10),
                                mask=True))
    yield (f"tile_{tag}bs{bs}_er_control",
           erdos_renyi(n, 4, seed=bs).to_dense(),
           erdos_renyi(n, 4, seed=bs + 1).to_dense(),
           er_mask(n, 8, seed=bs + 2).to_dense())


def probe_tile(*, smoke: bool = False, log=print,
               device="cuda") -> List[Measurement]:
    """Time the BCSR tile route (and, per point, the modeled-best row
    kernel as the win/loss reference the gate fit needs)."""
    from repro_torch.core.formats import csr_from_dense
    from repro_torch.core.planner import collect_stats, rank_algorithms

    dev = _device(device)
    grid = TILE_GRID_SMOKE if smoke else TILE_GRID
    out: List[Measurement] = []
    for i, (n, block_sizes, tds, mos, iters) in enumerate(grid):
        for bs in block_sizes:
            for point, A, B, M in tile_points(n, bs, tds, mos,
                                              label_n=i > 0):
                Ac, Bc, Mc = (csr_from_dense(np.asarray(x))
                              for x in (A, B, M))
                del A, B, M
                stats = collect_stats(Ac, Bc, Mc)
                feats = dict(_stats_features(stats), bs=float(bs))
                t_tile = _min_time(_timed_call(
                    dev, A=Ac, B=Bc, M=Mc, algorithm="tile",
                    tile_block=bs), iters)
                out.append(Measurement("tile", "tile", point, t_tile, feats))
                row_alg = rank_algorithms(stats)[0][0]
                t_row = _min_time(_timed_call(
                    dev, A=Ac, B=Bc, M=Mc, algorithm=row_alg), iters)
                out.append(Measurement("tile", f"row:{row_alg}", point,
                                       t_row, feats))
                log(f"[tune/tile] {point}: tile={t_tile * 1e3:.1f}ms "
                    f"{row_alg}={t_row * 1e3:.1f}ms")
    return out


def tile_calls(smoke: bool = False) -> int:
    """Tile-route calls ``probe_tile`` makes (warm-ups included): on a
    CUDA device, its launches of the fused block kernel."""
    grid = TILE_GRID_SMOKE if smoke else TILE_GRID
    return sum(len(bss) * (len(tds) * len(mos) + 1) * (WARMUP + iters)
               for _, bss, tds, mos, iters in grid)


# ---------------------------------------------------------------------------
# Distributed probes
# ---------------------------------------------------------------------------


def _dist_spec(smoke: bool) -> dict:
    if smoke:
        return dict(n=256, mesh_sizes=(2, 4), densities_b=(0.02, 0.3),
                    iters=1)
    return dict(n=1024, mesh_sizes=(2, 4), densities_b=(0.02, 0.1, 0.3),
                iters=2)


def dist_points(n: int, densities_b: Sequence[float]):
    """The dist family's operands, ``(point, A, B, M)`` dense arrays: A
    and M block-structured at block 32, B at each density, then an ER
    control."""
    from repro_torch.core.formats import block_sparse, erdos_renyi

    bs = 32
    for td in densities_b:
        yield (f"dist_tdb{td}", block_sparse(n, bs, 0.1, 0.9, seed=1),
               block_sparse(n, bs, td, 0.9, seed=2),
               block_sparse(n, bs, 0.2, 1.0, seed=3, mask=True))
    yield ("dist_er_control", erdos_renyi(n, 8, seed=1).to_dense(),
           erdos_renyi(n, 8, seed=2).to_dense(),
           erdos_renyi(n, 8, seed=3).to_dense())


def _measure_dist(n: int, mesh_sizes: Sequence[int],
                  densities_b: Sequence[float], iters: int, *,
                  device: torch.device, log=print) -> List[Measurement]:
    """Time the ring and row routes on ``make_mesh(p, device)`` for each
    mesh size; each timed call ends by a synchronise of the mesh's CUDA
    devices."""
    from repro_torch.core.distributed import (distributed_masked_spgemm,
                                              make_mesh,
                                              ring_sparse_masked_spgemm)
    from repro_torch.core.formats import csr_from_dense
    from repro_torch.core.planner import collect_stats, decide_distributed

    bs = 32
    out: List[Measurement] = []
    for point, A, B, M in dist_points(n, densities_b):
        Ac, Bc, Mc = (csr_from_dense(np.asarray(x)) for x in (A, B, M))
        del A, B, M
        stats = collect_stats(Ac, Bc, Mc)
        base_feats = _stats_features(stats)
        for p in mesh_sizes:
            mesh = make_mesh(p, device=device)
            cards = {str(d): d for d in mesh.devices
                     if d.type == "cuda"}.values()
            dplan = decide_distributed(stats, p)
            ring_bs = dplan.tile_block or bs
            feats = dict(base_feats, p=float(p), bs=float(ring_bs),
                         row_algorithm=dplan.row_algorithm)

            def synced(fn):
                def go():
                    fn()
                    for d in cards:
                        torch.cuda.synchronize(d)
                return go

            go_ring = synced(lambda: ring_sparse_masked_spgemm(
                Ac, Bc, Mc, mesh, block_size=ring_bs))
            go_row = synced(lambda: distributed_masked_spgemm(
                Ac, Bc, Mc, mesh, algorithm="row",
                row_algorithm=dplan.row_algorithm))
            pt = f"{point}_p{p}"
            t_ring = _min_time(go_ring, iters)
            out.append(Measurement("dist", "ring", pt, t_ring, feats))
            t_row = _min_time(go_row, iters)
            out.append(Measurement("dist", "row", pt, t_row, feats))
            log(f"[tune/dist] {pt}: ring={t_ring * 1e3:.1f}ms "
                f"row={t_row * 1e3:.1f}ms ({dplan.row_algorithm})")
    return out


def probe_dist(*, smoke: bool = False, log=print,
               device="cuda") -> List[Measurement]:
    """Time the distributed routes (the sparse ring and row-parallel) over
    meshes on ``device``; one Measurement per (point, mesh size, route)."""
    return _measure_dist(device=_device(device), log=log,
                         **_dist_spec(smoke))


def dist_calls(smoke: bool = False) -> int:
    """Ring calls ``probe_dist`` makes (warm-ups included): on a CUDA
    device, each launches the fused block kernel p² times."""
    spec = _dist_spec(smoke)
    return ((len(spec["densities_b"]) + 1) * (WARMUP + spec["iters"])
            * sum(p * p for p in spec["mesh_sizes"]))


def run_probes(families: Sequence[str], *, smoke: bool = False,
               log=print, device="cuda") -> List[Measurement]:
    """Run the selected probe families in canonical order."""
    unknown = sorted(set(families) - set(FAMILIES))
    if unknown:
        raise ValueError(f"unknown probe families {unknown}; "
                         f"valid: {list(FAMILIES)}")
    runners = {"row": probe_row, "tile": probe_tile, "dist": probe_dist}
    out: List[Measurement] = []
    for fam in FAMILIES:
        if fam in families:
            out.extend(runners[fam](smoke=smoke, log=log, device=device))
    return out
