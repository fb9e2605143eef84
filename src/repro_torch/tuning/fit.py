"""Fit the planner's cost constants to probe measurements.

Every cost model in the planner is *linear in its constants* (the
feature decompositions live next to the models: ``accumulators.
COST_FEATURES``, ``planner.tile_cost_features``, ``planner.
ring_cost_features``), so calibration is weighted non-negative least
squares — solved by projected coordinate descent on the regularized
normal equations, with

* relative weighting (``1/t^2``): the planner only needs the *ranking*
  right, so a 2x error on a 5 ms point must matter as much as on a
  500 ms point;
* a ridge prior toward the incumbent constants, scaled per-constant: on
  thin grids (``--smoke``) the data pins the well-observed directions and
  the prior holds the rest, instead of letting a rank-deficient system
  send a constant to zero or infinity.

Families fit in dependency order: ``row`` first (the distributed row
route re-uses the row hooks), then ``tile`` (the ring shares its
host/mac/gather decomposition), then ``dist`` (fits only the
communication constants against the residual the first two leave).
The ``TILE_MIN_*`` gates are not regression constants; they move only
when the tile probes' win/loss outcomes cleanly separate by density /
occupancy, and stay at the incumbent values otherwise.

Pure numpy over measurements, the reference's arithmetic step for step:
on the same measurements it gives the reference's constants.  The port
has no distributed probes yet, but ``fit_dist`` fits measurements taken
elsewhere.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .probes import FAMILIES, Measurement
from .profile import CalibrationProfile, ProfileError, required_table_keys

#: prior strength, in pseudo-observations per constant at 100% relative
#: deviation from the incumbent value.  Deliberately weak: with ~N
#: samples the prior pulls a well-observed constant only ~RIDGE*P/N of
#: the way back toward the incumbent, while still pinning directions the
#: grid cannot see (near-collinear features, e.g. hash's per_slot vs
#: per_mask at a fixed load factor)
DEFAULT_RIDGE = 0.05

#: clip range for a fitted TILE_MIN_DENSITY gate
DENSITY_GATE_RANGE = (0.005, 0.45)
#: clip range for a fitted TILE_MIN_OCCUPANCY gate
OCCUPANCY_GATE_RANGE = (1.0, 64.0)

_STATS_INT_FIELDS = ("m", "k", "n", "nnz_a", "nnz_b", "nnz_m",
                     "wa", "wb", "wbt", "pm")


def _stats_from_features(f: Dict) -> "PlanStats":
    from repro_torch.core.planner import PlanStats
    kw = {k: int(f[k]) for k in _STATS_INT_FIELDS}
    kw["complement"] = bool(f.get("complement", False))
    kw["semiring"] = str(f.get("semiring", "plus_times"))
    kw["flops"] = float(f.get("flops", 0.0))
    kw["out_nnz"] = float(f.get("out_nnz", 0.0))
    kw["b_transposable"] = bool(f.get("b_transposable", True))
    return PlanStats(**kw)


#: per-constant lower bound as a fraction of the incumbent value: a thin
#: or noisy grid may measure ~zero sensitivity to a term the incumbent
#: model knows exists (e.g. msa's per_n on a grid that never varies n),
#: and erasing it would flip asymptotic regimes the grid never visited.
#: 0.02 still allows a 50x reduction — enough for any real architecture
#: shift — while keeping every term's asymptotics alive.
FLOOR_FRAC = 0.02


def nnls_ridge(F: np.ndarray, t: np.ndarray, prior: np.ndarray, *,
               offset: Optional[np.ndarray] = None,
               ridge: float = DEFAULT_RIDGE,
               floor: float = FLOOR_FRAC,
               iters: int = 2000) -> Tuple[np.ndarray, float]:
    """Solve  min_{x >= floor*prior}
                  sum_i w_i (offset_i + F_i.x - t_i)^2
                  + ridge * sum_j ((x_j - prior_j) / s_j)^2

    with relative weights ``w_i = 1/t_i^2`` and prior scales ``s_j =
    prior_j`` (floored).  Returns ``(x, rel_rms)`` where ``rel_rms`` is
    the relative RMS residual of the FULL prediction (offset + F.x)
    against ``t``.  Projected coordinate descent; the ridge keeps the
    normal matrix positive definite, so every pass is well defined even
    for rank-deficient ``F``.
    """
    F = np.asarray(F, float)
    t = np.asarray(t, float)
    prior = np.asarray(prior, float)
    off = np.zeros_like(t) if offset is None else np.asarray(offset, float)
    w = 1.0 / np.maximum(t, 1e-9) ** 2
    y = t - off
    A = F.T @ (F * w[:, None])
    b = F.T @ (w * y)
    s = np.maximum(prior, max(1e-9, 1e-6 * float(np.max(prior, initial=0))))
    r = ridge / s ** 2
    A[np.diag_indices_from(A)] += r
    b = b + r * prior
    lo = floor * np.maximum(prior, 0.0)
    x = np.maximum(prior, lo).astype(float).copy()
    for _ in range(iters):
        x_prev = x.copy()
        for j in range(len(x)):
            num = b[j] - A[j] @ x + A[j, j] * x[j]
            x[j] = max(lo[j], num / A[j, j])
        if np.max(np.abs(x - x_prev)) <= 1e-12 * (1.0 + np.max(x)):
            break
    pred = off + F @ x
    rel = (pred - t) / np.maximum(t, 1e-12)
    return x, float(np.sqrt(np.mean(rel ** 2)))


def _select(ms: Iterable[Measurement], family: str,
            target: Optional[str] = None) -> List[Measurement]:
    return [m for m in ms if m.family == family
            and (target is None or m.target == target)]


# ---------------------------------------------------------------------------
# Row family: COST_CONSTANTS
# ---------------------------------------------------------------------------


def fit_row(ms: Sequence[Measurement],
            base: Dict[str, Dict[str, float]], *,
            ridge: float = DEFAULT_RIDGE
            ) -> Tuple[Dict[str, Dict[str, float]], float]:
    """Refit every row algorithm's constants; algorithms with no probe
    coverage keep the incumbent table.  Returns (constants, rel RMS
    pooled over all fitted algorithms)."""
    from repro_torch.core import accumulators as acc

    out = {alg: dict(tbl) for alg, tbl in base.items()}
    sq_sum, n_samples = 0.0, 0
    for alg, keys in required_table_keys()[0].items():
        recs = _select(ms, "row", alg)
        if not recs:
            continue
        feat_fn = acc.COST_FEATURES[alg]
        F, t = [], []
        for m in recs:
            s = _stats_from_features(m.features)
            f = feat_fn(n=s.n, wa=s.wa, wb=s.wb, wbt=s.wbt, pm=s.pm)
            scale = s.m / 1024.0   # hooks are per 1024 output rows
            F.append([f[k] * scale for k in keys])
            t.append(m.seconds * 1e3)
        prior = np.array([base[alg][k] for k in keys])
        x, rel = nnls_ridge(np.array(F), np.array(t), prior, ridge=ridge)
        out[alg] = {k: float(v) for k, v in zip(keys, x)}
        sq_sum += rel ** 2 * len(recs)
        n_samples += len(recs)
    if n_samples == 0:
        raise ProfileError("row fit: no row measurements")
    return out, math.sqrt(sq_sum / n_samples)


# ---------------------------------------------------------------------------
# Tile family: TILE_COST + TILE_MIN_* gates
# ---------------------------------------------------------------------------


def fit_tile(ms: Sequence[Measurement],
             base_cost: Dict[str, float],
             base_gates: Dict[str, float], *,
             ridge: float = DEFAULT_RIDGE
             ) -> Tuple[Dict[str, float], Dict[str, float], float]:
    from repro_torch.core.planner import tile_cost_features

    recs = _select(ms, "tile", "tile")
    if not recs:
        raise ProfileError("tile fit: no tile measurements")
    keys = list(required_table_keys()[1])
    F, t = [], []
    for m in recs:
        s = _stats_from_features(m.features)
        f = tile_cost_features(s, int(m.features["bs"]))
        F.append([f[k] for k in keys])
        t.append(m.seconds * 1e3)
    prior = np.array([base_cost[k] for k in keys])
    x, rel = nnls_ridge(np.array(F), np.array(t), prior, ridge=ridge)
    cost = {k: float(v) for k, v in zip(keys, x)}
    return cost, _fit_gates(ms, base_gates), rel


def _fit_gates(ms: Sequence[Measurement],
               base_gates: Dict[str, float]) -> Dict[str, float]:
    """Move the density/occupancy gates only where the probe outcomes
    separate cleanly: the gate lands at the geometric midpoint between
    the densest point the tile route LOST and the sparsest it WON.
    Overlapping or one-sided outcomes keep the incumbent gate — the cost
    model (also refitted) still ranks those points."""
    row_ref = {m.point: m.seconds for m in ms
               if m.family == "tile" and m.target.startswith("row:")}
    wins_d, loss_d, wins_o, loss_o = [], [], [], []
    for m in _select(ms, "tile", "tile"):
        if m.point not in row_ref:
            continue
        s = _stats_from_features(m.features)
        bs = float(m.features["bs"])
        dens = min(s.nnz_a / max(1, s.m * s.k), s.nnz_b / max(1, s.k * s.n))
        occ = dens * bs * bs
        if m.seconds < row_ref[m.point]:
            wins_d.append(dens)
            wins_o.append(occ)
        else:
            loss_d.append(dens)
            loss_o.append(occ)
    gates = dict(base_gates)

    def separated(losses, wins, clip_range):
        if not losses or not wins or max(losses) >= min(wins):
            return None
        lo, hi = clip_range
        return float(np.clip(math.sqrt(max(losses) * min(wins)), lo, hi))

    d = separated(loss_d, wins_d, DENSITY_GATE_RANGE)
    if d is not None:
        gates["min_density"] = d
    o = separated(loss_o, wins_o, OCCUPANCY_GATE_RANGE)
    if o is not None:
        gates["min_occupancy"] = o
    # min_hit_rate: the probe masks always intersect the product, so the
    # grid carries no signal for it — always inherited
    return gates


# ---------------------------------------------------------------------------
# Dist family: DIST_COST (against the residual row + tile leave)
# ---------------------------------------------------------------------------


def fit_dist(ms: Sequence[Measurement],
             row_constants: Dict[str, Dict[str, float]],
             tile_cost_table: Dict[str, float],
             base: Dict[str, float], *,
             ridge: float = DEFAULT_RIDGE
             ) -> Tuple[Dict[str, float], float]:
    """Fit the three communication constants.  The compute part of each
    route is predicted with the (already fitted) row/tile constants and
    enters as a fixed offset; only the communication terms are free."""
    from repro_torch.core import accumulators as acc
    from repro_torch.core.planner import (ring_cost_features,
                                    row_replication_elems)

    row_recs = _select(ms, "dist", "row")
    ring_recs = _select(ms, "dist", "ring")
    if not row_recs or not ring_recs:
        raise ProfileError("dist fit: need both row and ring measurements")

    # -- per_bcast_elem from the row route --------------------------------
    F, t, off = [], [], []
    for m in row_recs:
        s = _stats_from_features(m.features)
        p = float(m.features["p"])
        alg = str(m.features["row_algorithm"])
        f = acc.COST_FEATURES[alg](n=s.n, wa=s.wa, wb=s.wb, wbt=s.wbt,
                                   pm=s.pm)
        compute = sum(row_constants[alg][k] * f[k] for k in f) \
            * (s.m / 1024.0) / p
        F.append([row_replication_elems(s, alg)])
        t.append(m.seconds * 1e3)
        off.append(compute)
    x_b, rel_row = nnls_ridge(
        np.array(F), np.array(t), np.array([base["per_bcast_elem"]]),
        offset=np.array(off), ridge=ridge)

    # -- remaining comm constants from the ring route ---------------------
    keys = [k for k in required_table_keys()[2] if k != "per_bcast_elem"]
    F, t, off = [], [], []
    for m in ring_recs:
        s = _stats_from_features(m.features)
        p, bs = int(m.features["p"]), int(m.features["bs"])
        tile_f, comm_f = ring_cost_features(s, p, bs)
        off.append(sum(tile_cost_table[k] * tile_f[k] for k in tile_f))
        F.append([comm_f[k] for k in keys])
        t.append(m.seconds * 1e3)
    x_r, rel_ring = nnls_ridge(
        np.array(F), np.array(t), np.array([base[k] for k in keys]),
        offset=np.array(off), ridge=ridge)

    out = {"per_bcast_elem": float(x_b[0]),
           **{k: float(v) for k, v in zip(keys, x_r)}}
    n_row, n_ring = len(row_recs), len(ring_recs)
    rel = math.sqrt((rel_row ** 2 * n_row + rel_ring ** 2 * n_ring)
                    / (n_row + n_ring))
    return out, rel


# ---------------------------------------------------------------------------
# Whole-profile fit
# ---------------------------------------------------------------------------


def fit_profile(ms: Sequence[Measurement],
                base: CalibrationProfile, *,
                families: Sequence[str] = FAMILIES,
                name: str = "fitted",
                backend: Optional[Dict] = None,
                ridge: float = DEFAULT_RIDGE,
                **meta) -> CalibrationProfile:
    """Fit the selected families against ``ms``; unfitted families (and
    their residual entries) are inherited from ``base``.  Families fit
    in dependency order regardless of the order given."""
    unknown = sorted(set(families) - set(FAMILIES))
    if unknown:
        raise ProfileError(f"unknown fit families {unknown}; "
                           f"valid: {list(FAMILIES)}")
    cost_constants = {a: dict(t) for a, t in base.cost_constants.items()}
    tile_cost_table = dict(base.tile_cost)
    tile_gates = dict(base.tile_gates)
    dist_cost = dict(base.dist_cost)
    residuals = {k: float(v) for k, v in base.residuals.items()}

    if "row" in families:
        cost_constants, residuals["row"] = fit_row(
            ms, cost_constants, ridge=ridge)
    if "tile" in families:
        tile_cost_table, tile_gates, residuals["tile"] = fit_tile(
            ms, tile_cost_table, tile_gates, ridge=ridge)
    if "dist" in families:
        dist_cost, residuals["dist"] = fit_dist(
            ms, cost_constants, tile_cost_table, dist_cost, ridge=ridge)

    if backend is None:
        from .profile import backend_signature
        backend = backend_signature()
    return CalibrationProfile(
        name=name,
        backend=backend,
        cost_constants=cost_constants,
        tile_cost=tile_cost_table,
        tile_gates=tile_gates,
        dist_cost=dist_cost,
        residuals=residuals,
        meta=dict(meta, fitted_families=sorted(families),
                  n_measurements=len(ms), base_profile=base.name,
                  fitted_at=time.strftime("%Y-%m-%dT%H:%M:%S")),
    ).validate()
