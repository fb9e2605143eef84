"""Adaptive algorithm planner for Masked SpGEMM (paper Sec. 7-8).

The paper's headline result is that no single Masked-SpGEMM algorithm wins
everywhere.  This module turns its guidelines into an explicit,
deterministic decision function:

    stats  = collect_stats(A, B, M, ...)      # cheap structural statistics
    plan   = decide(stats)                    # pure: stats -> Plan
    result = masked_spgemm(A, B, M)           # algorithm="auto" runs both

``plan()`` memoizes Plans in an LRU cache keyed on a structural signature
(shapes + nnz + CRC of the index arrays) and the cost-model token, so
repeated shapes skip re-planning entirely.  ``decide`` ranks algorithms
with the per-algorithm cost hooks exported by ``accumulators.py``, plus the
BCSR tile route when the operands' block occupancy makes it eligible.

The shipped cost constants are the reference's, calibrated on a CPU.  A
profile fitted on another backend (``repro_torch.tuning``; one for the
H100 is committed under ``results/profiles/``) replaces them through
``tuning.activate`` or ``$REPRO_TUNE_PROFILE``; nothing activates one by
default.

When the model ranks two candidates within ``TRIAL_RATIO`` of each other
the tie is resolved empirically: ``plan()`` times the contenders once on
the real operands, on the caller's device, and caches the winner.  The
pure ``decide`` path never measures — only ``plan`` does, and only on a
cache miss for large non-complemented problems.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import caches, obs
from repro_torch.tuning import profile as tuning_profile

from . import accumulators as acc
from .formats import CSR, PaddedCSR
from .semiring import Semiring, PLUS_TIMES

#: candidate algorithms, in cost-hook order
CANDIDATES = tuple(acc.COST_HOOKS)

#: rows sampled by the symbolic probe
PROBE_ROWS = 64
#: per-row flop budget above which the probe falls back to upper bounds
PROBE_FLOP_CAP = 1 << 16

#: candidates whose modeled cost is within this factor of the best are
#: resolved by a one-shot measured trial on the real operands
TRIAL_RATIO = 1.25
#: at most this many candidates enter a trial
TRIAL_MAX_CANDIDATES = 3
#: timed repetitions per trial candidate (plus one warmup call); the
#: minimum is kept (robust to additive noise)
TRIAL_ITERS = 3
#: problems smaller than this are too fast for a meaningful trial (and any
#: choice is fine); the modeled ranking is used directly
TRIAL_MIN_ROWS = 256

#: minimum input density for the tile path: dense (bs x bs) tiles compute
#: bs^3 flops regardless of occupancy, so sparse operands would be mostly
#: padding (the reference's CPU-tuned gate)
TILE_MIN_DENSITY = 0.05
#: minimum expected nonzeros per (bs x bs) tile for a block size to be
#: worth scheduling
TILE_MIN_OCCUPANCY = 4.0
#: block sizes the tile path will consider, largest first
TILE_BLOCK_SIZES = (128, 32, 8)
#: minimum fraction of mask nonzeros the symbolic probe must see hit by
#: the product for the tile path to stay eligible
TILE_MIN_HIT_RATE = 0.05

#: tile-route cost model constants (ms), the reference's CPU calibration
#: (a fitted profile overwrites them in place):
#: host covers the bcsr_from_csr scatters + schedule build (per element /
#: worklist entry), mac the block products of the two replays (values +
#: structure), gather the per-mask-element result extraction
TILE_COST = dict(base=3.0, per_host=2.5e-4, per_mac=1.6e-7,
                 per_gather=3.0e-4)

#: distributed cost-model constants (ms), the reference's:
#: ``per_bcast_elem`` prices replicating one padded B element to every
#: device (the row route's set-up traffic), ``per_ring_byte`` the bytes of
#: one rotating value+pattern slab per stage, ``stage_base`` the fixed
#: cost of one ring stage.  ``python -m repro_torch.tune --only dist``
#: refits them on a mesh
DIST_COST = dict(per_bcast_elem=1.5e-6, per_ring_byte=2.0e-7,
                 stage_base=0.15)


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """Cheap structural statistics driving the decision function.

    Widths are the padded row widths the row kernels will actually run
    (``wa``/``wb`` = max row nnz of A/B, ``wbt`` = max *column* nnz of B =
    row width of B^T for Inner, ``pm`` = max mask-row nnz).  ``flops`` /
    ``out_nnz`` come from the sampled symbolic probe, scaled to the full
    matrix; ``compression`` is their ratio (paper Sec. 7).
    """

    m: int
    k: int
    n: int
    nnz_a: int
    nnz_b: int
    nnz_m: int
    wa: int
    wb: int
    wbt: int
    pm: int
    complement: bool
    semiring: str = "plus_times"
    flops: float = 0.0
    out_nnz: float = 0.0
    #: False when B is device-resident row-major (PaddedCSR): Inner needs
    #: B^T, which a padded B cannot give without a host round-trip
    b_transposable: bool = True

    @property
    def compression(self) -> float:
        return self.flops / max(1.0, self.out_nnz)

    @property
    def mask_density(self) -> float:
        return self.nnz_m / max(1, self.m * self.n)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Executable decision: which kernel, with which static parameters."""

    algorithm: str
    widths: Tuple[int, int, int]  # (wa, wb_or_wbt, wm) pad widths
    two_phase: bool
    n_inspect: Optional[int]
    tile_eligible: bool
    tile_block: int               # suggested BCSR block size (0 = n/a)
    costs: Tuple[Tuple[str, float], ...]
    stats: PlanStats
    trialed: Tuple[str, ...] = ()  # candidates resolved by measured trial

    def cost(self, algorithm: str) -> float:
        return dict(self.costs)[algorithm]


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """Executable distributed decision for ``distributed_masked_spgemm``."""

    route: str                    # "row" | "ring"
    p: int                        # ring/mesh axis size
    tile_block: int               # BCSR block size for the ring (0 = n/a)
    row_algorithm: str            # row kernel if route == "row"
    costs: Tuple[Tuple[str, float], ...]
    stats: PlanStats

    def cost(self, route: str) -> float:
        return dict(self.costs)[route]


def _max_row_nnz(x: CSR) -> int:
    return max(1, int(np.diff(x.indptr).max(initial=0)))


def _max_col_nnz(x: CSR) -> int:
    if x.nnz == 0:
        return 1
    return max(1, int(np.bincount(x.indices, minlength=x.shape[1]).max()))


def _probe_rows(m: int, sample: int) -> np.ndarray:
    if m <= sample:
        return np.arange(m)
    return np.unique(np.linspace(0, m - 1, sample).astype(np.int64))


def symbolic_probe(A: CSR, B: CSR, M: CSR, *, complement: bool = False,
                   sample: int = PROBE_ROWS) -> Tuple[float, float]:
    """Sampled symbolic pass: (est. flops, est. nnz of the masked output).

    Walks ``sample`` evenly spaced rows; for each, flops_i is the exact
    Gustavson flop count and out_i the exact masked output nnz (union of the
    touched B rows intersected with — or minus, under complement — the mask
    row).  Rows whose flop count exceeds ``PROBE_FLOP_CAP`` fall back to the
    mask-row upper bound instead of materializing the union.
    """
    m, n = M.shape
    rows = _probe_rows(m, sample)
    b_nnz = B.row_nnz()
    flops = 0.0
    out = 0.0
    for i in rows:
        a_cols, _ = A.row(int(i))
        f_i = float(b_nnz[a_cols].sum()) if len(a_cols) else 0.0
        flops += f_i
        m_cols, _ = M.row(int(i))
        if f_i == 0.0:
            continue
        if f_i > PROBE_FLOP_CAP:
            out += float(n - len(m_cols)) if complement else float(len(m_cols))
            continue
        touched = np.unique(np.concatenate(
            [B.indices[B.indptr[j]: B.indptr[j + 1]] for j in a_cols]))
        if complement:
            out += float(len(touched) - np.isin(touched, m_cols).sum())
        else:
            out += float(np.isin(m_cols, touched).sum())
    scale = m / max(1, len(rows))
    return flops * scale, out * scale


def collect_stats(A: CSR, B: CSR, M: CSR, *, complement: bool = False,
                  semiring: Semiring = PLUS_TIMES,
                  probe: bool = True) -> PlanStats:
    """Gather the planner's statistics from host CSR operands."""
    m, k = A.shape
    _, n = B.shape
    flops, out_nnz = (symbolic_probe(A, B, M, complement=complement)
                      if probe else (0.0, 0.0))
    return PlanStats(
        m=m, k=k, n=n, nnz_a=A.nnz, nnz_b=B.nnz, nnz_m=M.nnz,
        wa=_max_row_nnz(A), wb=_max_row_nnz(B), wbt=_max_col_nnz(B),
        pm=_max_row_nnz(M), complement=complement, semiring=semiring.name,
        flops=flops, out_nnz=out_nnz)


# ---------------------------------------------------------------------------
# Decision function (pure, deterministic, testable)
# ---------------------------------------------------------------------------


def rank_algorithms(stats: PlanStats) -> Tuple[Tuple[str, float], ...]:
    """Per-algorithm cost estimates (ms for the whole product), cheapest
    first.  Pure function of ``stats``."""
    candidates = [a for a in CANDIDATES
                  if not stats.complement or a in acc.SUPPORTS_COMPLEMENT]
    if not stats.b_transposable:
        candidates = [a for a in candidates if a != "inner"]
    scale = stats.m / 1024.0
    costs = []
    for name in candidates:
        per_row = acc.COST_HOOKS[name](
            n=stats.n, wa=stats.wa, wb=stats.wb, wbt=stats.wbt, pm=stats.pm)
        costs.append((name, per_row * scale))
    return tuple(sorted(costs, key=lambda kv: (kv[1], kv[0])))


def _tile_path(stats: PlanStats) -> Tuple[bool, int]:
    """Eligibility of the BCSR tile route.

    Requires the plus_times semiring and an explicit mask (the block
    product accumulates with a dense block matmul), block-divisible dims,
    and enough expected nonzeros per tile that dense blocks are not mostly
    padding.
    """
    from repro_torch.kernels.masked_matmul.ops import tile_path_supported
    if not tile_path_supported(stats.semiring, stats.complement):
        return False, 0
    dens_a = stats.nnz_a / max(1, stats.m * stats.k)
    dens_b = stats.nnz_b / max(1, stats.k * stats.n)
    if min(dens_a, dens_b) < TILE_MIN_DENSITY:
        return False, 0
    # symbolic-probe gate: a mask that almost never hits the product makes
    # dense output tiles pointless (most scheduled tiles would be zero)
    if stats.flops > 0 and stats.out_nnz < TILE_MIN_HIT_RATE * stats.nnz_m:
        return False, 0
    for bs in TILE_BLOCK_SIZES:
        if stats.m % bs or stats.n % bs or stats.k % bs:
            continue
        occ = min(dens_a, dens_b) * bs * bs
        if occ >= TILE_MIN_OCCUPANCY:
            return True, bs
    return False, 0


def _block_occupancy(dens: float, bs: int) -> float:
    """P(a bs x bs block holds >= 1 nonzero) under uniform sparsity."""
    return float(-np.expm1(bs * bs * np.log1p(-min(dens, 1 - 1e-12))))


def _block_counts(stats: PlanStats, bs: int
                  ) -> Tuple[float, float, float]:
    """Random-occupancy block expectations: ``(m_blocks, b_blocks, pair)``
    — expected occupied output/mask blocks, occupied B blocks, and expected
    worklist entries per mask block."""
    m, k, n = stats.m, stats.k, stats.n
    dens_a = stats.nnz_a / max(1, m * k)
    dens_b = stats.nnz_b / max(1, k * n)
    dens_m = stats.nnz_m / max(1, m * n)
    mb, kb, nb = -(-m // bs), -(-k // bs), -(-n // bs)
    p_a = _block_occupancy(dens_a, bs)
    p_b = _block_occupancy(dens_b, bs)
    p_m = _block_occupancy(dens_m, bs)
    return mb * nb * p_m, kb * nb * p_b, kb * p_a * p_b


def _tile_feature_dict(stats: PlanStats, worklist: float, bs: int,
                       mac_div: float) -> Dict[str, float]:
    """The host/mac/gather decomposition of the block route, as a
    TILE_COST feature vector."""
    return {
        "base": 1.0,
        "per_host": float(stats.nnz_a + stats.nnz_b + stats.nnz_m
                          + worklist),
        "per_mac": 2.0 * worklist * bs ** 3 / mac_div,  # values + structure
        "per_gather": float(stats.nnz_m),
    }


def tile_cost_features(stats: PlanStats, bs: int) -> Dict[str, float]:
    """Feature vector of the tile-route model: ``tile_cost`` is the dot
    product of this with ``TILE_COST``."""
    m_blocks, _, pair = _block_counts(stats, bs)
    return _tile_feature_dict(stats, m_blocks * pair, bs, 1.0)


def tile_cost(stats: PlanStats, bs: int) -> float:
    """Modeled total ms of the BCSR tile route at block size ``bs``, in the
    row-kernel hooks' units so the planner can rank them side by side."""
    f = tile_cost_features(stats, bs)
    return sum(TILE_COST[k] * f[k] for k in f)


def decide(stats: PlanStats, *, allow_tile: bool = True) -> Plan:
    """Pure decision function: statistics -> Plan.

    ``allow_tile=False`` keeps the tile route out of the ranking (it still
    reports eligibility).
    """
    costs = rank_algorithms(stats)
    tile_eligible, tile_block = _tile_path(stats)
    # the tile route enters the ranking only when the stats carry a real
    # symbolic probe (flops > 0): width-only stats lack the occupancy
    # evidence the gate relies on
    if allow_tile and tile_eligible and stats.flops > 0:
        costs = tuple(sorted(
            costs + (("tile", tile_cost(stats, tile_block)),),
            key=lambda kv: (kv[1], kv[0])))
    algorithm = costs[0][0]
    wb = stats.wbt if algorithm == "inner" else stats.wb
    return Plan(
        algorithm=algorithm,
        widths=(stats.wa, wb, stats.pm),
        two_phase=False,           # 1P: the mask bounds the allocation
        n_inspect=None,            # per-algorithm default
        tile_eligible=tile_eligible,
        tile_block=tile_block,
        costs=costs,
        stats=stats)


def ring_cost_features(stats: PlanStats, p: int, bs: int
                       ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """``(tile_features, comm_features)`` of the sparse-ring model:
    ``ring_cost`` dots the first with ``TILE_COST`` and the second with
    ``DIST_COST`` (the calibration fit reuses both).

    The tile part is the tile route's host/mac/gather decomposition with
    the MACs split ``p`` ways; the comm part is ``p`` stages of the padded
    value+pattern B slab panel, the last one peeled (``p - 1`` rotations).
    """
    m_blocks, b_blocks, pair = _block_counts(stats, bs)
    worklist = m_blocks * pair + p * m_blocks  # + zero-fills/stage
    tile_f = _tile_feature_dict(stats, worklist, bs, float(p))
    slab_bytes = (b_blocks / p) * bs * bs * 4.0 * 2.0
    comm_f = {"per_ring_byte": slab_bytes * (p - 1),
              "stage_base": float(p)}
    return tile_f, comm_f


def row_replication_elems(stats: PlanStats, row_alg: str) -> float:
    """Elements of B the distributed row route replicates to every device:
    padded B (k x wb) for the row-major kernels, padded B^T (n x wbt) when
    the elected row kernel is Inner (the fit's ``per_bcast_elem``
    feature)."""
    return float(stats.n * stats.wbt if row_alg == "inner"
                 else stats.k * stats.wb)


def ring_cost(stats: PlanStats, p: int, bs: int) -> float:
    """Modeled total ms of the sparse BCSR ring at ``p`` devices, block
    size ``bs``."""
    tile_f, comm_f = ring_cost_features(stats, p, bs)
    return (sum(TILE_COST[k] * tile_f[k] for k in tile_f)
            + sum(DIST_COST[k] * comm_f[k] for k in comm_f))


def ring_block_candidates(m: int, k: int, n: int) -> Tuple[int, ...]:
    """BCSR block sizes the ring and tile routes may use for an (m, k, n)
    product, largest first."""
    lo = max(8, min(m, k, n))
    return (tuple(bs for bs in TILE_BLOCK_SIZES if bs <= lo)
            or (TILE_BLOCK_SIZES[-1],))


def _distributed_decision(stats: PlanStats, p: int
                          ) -> Tuple[Tuple[Tuple[str, float], ...], str, int]:
    """(costs, row_algorithm, ring tile_block), each modeled once."""
    from repro_torch.kernels.masked_matmul.ops import tile_path_supported
    row_alg, row_compute = rank_algorithms(stats)[0]
    costs = [("row", row_compute / p + DIST_COST["per_bcast_elem"]
              * row_replication_elems(stats, row_alg))]
    tile_block = 0
    if tile_path_supported(stats.semiring, stats.complement):
        by_bs = {bs: ring_cost(stats, p, bs)
                 for bs in ring_block_candidates(stats.m, stats.k, stats.n)}
        tile_block = min(by_bs, key=by_bs.get)
        costs.append(("ring", by_bs[tile_block]))
    return (tuple(sorted(costs, key=lambda kv: (kv[1], kv[0]))),
            row_alg, tile_block)


def distributed_costs(stats: PlanStats, p: int
                      ) -> Tuple[Tuple[str, float], ...]:
    """(route, modeled ms) pairs for the mesh, cheapest first.  The ring
    entry reports the best block size's cost; when the block product
    cannot express the product only the row route is listed."""
    return _distributed_decision(stats, p)[0]


def decide_distributed(stats: PlanStats, p: int) -> DistPlan:
    """Pure distributed decision: statistics + mesh size -> DistPlan."""
    costs, row_alg, tile_block = _distributed_decision(stats, p)
    return DistPlan(
        route=costs[0][0], p=p, tile_block=tile_block,
        row_algorithm=row_alg, costs=costs, stats=stats)


def plan_distributed(A: CSR, B: CSR, M: CSR, p: int, *,
                     complement: bool = False,
                     semiring: Semiring = PLUS_TIMES,
                     use_cache: bool = True) -> DistPlan:
    """Cached distributed decision: the mesh counterpart of ``plan``.

    Keyed on the operands' structural signatures, the ring size and the
    cost-model token, in the planner's LRU, so repeated structures (the
    serving case) skip the symbolic probe and the cost model.
    """
    key = None
    if use_cache:
        key = (structure_signature(A), structure_signature(B),
               structure_signature(M), p, complement, semiring.name, "dist",
               cost_model_token())
        hit = _cache.get(key)
        if hit is not None:
            return hit
    stats = collect_stats(A, B, M, complement=complement, semiring=semiring)
    d = decide_distributed(stats, p)
    if use_cache:
        _cache.put(key, d)
    return d


# ---------------------------------------------------------------------------
# Measured trial: resolve modeled near-ties empirically (cached with the plan)
# ---------------------------------------------------------------------------


def _trial_candidates(p: Plan) -> Tuple[str, ...]:
    best_cost = p.costs[0][1]
    cand = tuple(name for name, c in p.costs[:TRIAL_MAX_CANDIDATES]
                 if c <= best_cost * TRIAL_RATIO)
    return cand if len(cand) >= 2 else ()


#: measured-trial winners memoized by coarse shape class, so iterative
#: algorithms whose operand structure drifts every iteration pay for at
#: most one trial per shape class
_trial_winners: Dict[tuple, str] = {}
_TRIAL_MEMO_CAPACITY = 256
caches.register("planner-trials",
                clear=_trial_winners.clear,
                size=lambda: len(_trial_winners),
                capacity=lambda: _TRIAL_MEMO_CAPACITY)


def _shape_class(s: PlanStats) -> tuple:
    b = int.bit_length  # log2 buckets: widths within 2x share a class
    return (s.m, s.k, s.n, b(s.wa), b(s.wb), b(s.wbt), b(s.pm),
            s.semiring, s.complement)


def _refine_with_trial(A: CSR, B: CSR, M: CSR, p: Plan,
                       semiring: Semiring, device) -> Plan:
    """Time the near-tied candidates once on the real operands, on
    ``device``, and keep the winner.  On CUDA each timed call ends in
    ``torch.cuda.synchronize()``."""
    import time
    from .masked_spgemm import masked_spgemm  # deferred: no import cycle

    cand = _trial_candidates(p)
    if not cand:
        return p
    s = p.stats
    memo_key = _shape_class(s)
    with _cache_lock:
        winner = _trial_winners.get(memo_key)
    if winner is not None and winner in cand:
        wb = s.wbt if winner == "inner" else s.wb
        return dataclasses.replace(p, algorithm=winner,
                                   widths=(s.wa, wb, s.pm), trialed=cand)
    on_cuda = torch.device(device).type == "cuda"

    def make(name):
        widths = (s.wa, s.wbt if name == "inner" else s.wb, s.pm)
        tb = p.tile_block if name == "tile" else None

        def call():
            masked_spgemm(A, B, M, algorithm=name, semiring=semiring,
                          widths=widths, tile_block=tb, device=device)
            if on_cuda:
                torch.cuda.synchronize(device)

        return call

    calls = {name: make(name) for name in cand}
    for call in calls.values():        # warm
        call()
    # interleaved rounds, min per candidate: drift in machine conditions
    # during the trial hits every candidate alike
    timed = {name: float("inf") for name in cand}
    for _ in range(TRIAL_ITERS):
        for name, call in calls.items():
            t0 = time.perf_counter()
            call()
            timed[name] = min(timed[name], time.perf_counter() - t0)
    winner = min(timed, key=timed.get)
    with _cache_lock:
        if len(_trial_winners) >= _TRIAL_MEMO_CAPACITY:
            _trial_winners.clear()
        _trial_winners[memo_key] = winner
    wb = s.wbt if winner == "inner" else s.wb
    return dataclasses.replace(p, algorithm=winner,
                               widths=(s.wa, wb, s.pm), trialed=cand)


# ---------------------------------------------------------------------------
# Plan cache (structural-signature LRU)
# ---------------------------------------------------------------------------

#: default plan-cache entries; override with $REPRO_PLAN_CACHE_CAP or
#: ``repro_torch.caches.set_capacity("planner-plans", n)``
_CACHE_CAPACITY = 128
_cache = caches.LRUCache("planner-plans", _CACHE_CAPACITY,
                         env_var="REPRO_PLAN_CACHE_CAP")
_cache_lock = threading.Lock()


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def cost_model_token() -> str:
    """Identity of the cost model every cached Plan was decided under: the
    active version plus a fingerprint of the LIVE constant tables, so
    mutating ``COST_CONSTANTS`` / ``TILE_COST`` / ``DIST_COST`` / the gates
    in place changes every plan-cache key."""
    fp = tuning_profile.fingerprint_tables(
        acc.COST_CONSTANTS, TILE_COST,
        {"min_density": TILE_MIN_DENSITY,
         "min_occupancy": TILE_MIN_OCCUPANCY,
         "min_hit_rate": TILE_MIN_HIT_RATE},
        DIST_COST)
    return f"{tuning_profile.active_version()}-{fp}"


def structure_signature(x) -> tuple:
    """Structural identity of an operand: equal signatures => equal sparsity
    structure (up to CRC collision), values ignored.

    Memoized on the CSR instance: ``indptr``/``indices`` are never mutated
    in place, so the signature is stable for the object's lifetime.
    """
    if isinstance(x, CSR):
        sig = getattr(x, "_structure_sig", None)
        if sig is None:
            sig = ("csr", x.shape, x.nnz, _crc(x.indptr), _crc(x.indices))
            x._structure_sig = sig
        return sig
    if isinstance(x, PaddedCSR):
        # device-resident: identify by the host-visible static structure
        # only (no device sync); callers wanting exact reuse pass a Plan
        return ("padded", x.shape, x.width)
    raise TypeError(f"unsupported operand type {type(x)!r}")


def plan_cache_info() -> Dict[str, int]:
    return _cache.info()


def clear_plan_cache() -> None:
    _cache.clear()
    with _cache_lock:
        _trial_winners.clear()


#: serializes plan construction per key stripe: concurrent misses on the
#: SAME structure must resolve to ONE plan (the measured trial is
#: load-dependent, so two racing trials can elect different kernels)
_PLAN_LOCK_STRIPES = 16
_plan_build_locks = tuple(threading.Lock()
                          for _ in range(_PLAN_LOCK_STRIPES))


def _plan_build_lock(key) -> threading.Lock:
    return _plan_build_locks[hash(key) % _PLAN_LOCK_STRIPES]


def plan(A, B, M, *, complement: bool = False,
         semiring: Semiring = PLUS_TIMES, use_cache: bool = True,
         device="cuda") -> Plan:
    """Plan C = M (.) (A B): cached decision on structural signatures.

    ``A``/``B``/``M`` are host ``CSR`` (the common entry); ``PaddedCSR``
    operands are planned from their static widths without a probe.
    ``device`` is where a measured trial runs.
    """
    def build() -> Plan:
        if isinstance(A, CSR) and isinstance(B, CSR) and isinstance(M, CSR):
            stats = collect_stats(A, B, M, complement=complement,
                                  semiring=semiring)
        else:  # device-resident operands: widths are already static
            m, k = A.shape
            _, n = B.shape
            stats = PlanStats(
                m=m, k=k, n=n,
                nnz_a=m * A.width if isinstance(A, PaddedCSR) else A.nnz,
                nnz_b=(B.shape[0] * B.width if isinstance(B, PaddedCSR)
                       else B.nnz),
                nnz_m=m * M.width if isinstance(M, PaddedCSR) else M.nnz,
                wa=A.width if isinstance(A, PaddedCSR) else _max_row_nnz(A),
                wb=B.width if isinstance(B, PaddedCSR) else _max_row_nnz(B),
                wbt=B.width if isinstance(B, PaddedCSR) else _max_col_nnz(B),
                pm=M.width if isinstance(M, PaddedCSR) else _max_row_nnz(M),
                complement=complement, semiring=semiring.name,
                b_transposable=not isinstance(B, PaddedCSR))
        p = decide(stats)
        if (not complement and stats.m >= TRIAL_MIN_ROWS
                and isinstance(A, CSR) and isinstance(B, CSR)
                and isinstance(M, CSR)):
            p = _refine_with_trial(A, B, M, p, semiring, device)
        return p

    def traced_build() -> Plan:
        # the cold path only: cache hits stay span-free
        with obs.span("plan.build") as sp:
            p = build()
            if obs.enabled():
                sp.set(algorithm=p.algorithm, explain=explain_cached(p))
        return p

    if not use_cache:
        return traced_build()
    key = (structure_signature(A), structure_signature(B),
           structure_signature(M), complement, semiring.name,
           cost_model_token())
    hit = _cache.get(key)
    if hit is not None:
        return hit
    # double-checked build: concurrent misses on one structure must all
    # observe the SAME plan
    with _plan_build_lock(key):
        hit = _cache.peek(key)
        if hit is not None:
            return hit
        p = traced_build()
        _cache.put(key, p)
    return p


#: relative drift in nnz / pad widths a revalidation tolerates before
#: falling back to a cold plan: small deltas move the cost-model inputs a
#: little, and re-planning inside the band would thrash (delta -> cold
#: plan -> delta -> cold plan) for exactly the streams the delta path
#: exists for
REVALIDATE_HYSTERESIS = 0.25


def _within_band(new: float, old: float, band: float) -> bool:
    lo = old / (1.0 + band)
    hi = old * (1.0 + band)
    return lo <= max(new, 1e-12) <= hi if old > 0 else new <= 1


def revalidate(old: Plan, A: CSR, B: CSR, M: CSR, *,
               complement: bool = False,
               semiring: Semiring = PLUS_TIMES,
               use_cache: bool = True, device="cuda") -> Tuple[Plan, bool]:
    """Cheap plan refresh after a delta: ``(plan, survived)``.

    Re-checks the elected kernel's cost-model inputs (pad widths, nnz,
    tile-gate densities) against the post-delta operands WITHOUT the
    symbolic probe or a measured trial.  While every input stays inside
    the ``REVALIDATE_HYSTERESIS`` band and the elected kernel is still
    ranked within ``TRIAL_RATIO`` of the cheapest, the old plan survives,
    widths widened to cover the new operands, stamped into the plan cache
    under the post-delta structure signatures with the same
    ``cost_model_token()``.  Anything else falls back to a cold ``plan()``
    (``survived=False``), whose measured trial runs on ``device``.
    """
    def cold() -> Tuple[Plan, bool]:
        obs.event("plan.revalidate", survived=False,
                  algorithm=old.algorithm)
        return (plan(A, B, M, complement=complement, semiring=semiring,
                     use_cache=use_cache, device=device), False)

    if not (isinstance(A, CSR) and isinstance(B, CSR) and isinstance(M, CSR)):
        return cold()
    s0 = old.stats
    if ((s0.m, s0.k, s0.n) != (A.shape[0], A.shape[1], B.shape[1])
            or s0.complement != complement or s0.semiring != semiring.name):
        return cold()

    s1 = collect_stats(A, B, M, complement=complement, semiring=semiring,
                       probe=False)
    band = REVALIDATE_HYSTERESIS
    drifted = not all((
        _within_band(s1.nnz_a, s0.nnz_a, band),
        _within_band(s1.nnz_b, s0.nnz_b, band),
        _within_band(s1.nnz_m, s0.nnz_m, band),
        _within_band(s1.wa, s0.wa, band),
        _within_band(s1.wb, s0.wb, band),
        _within_band(s1.wbt, s0.wbt, band),
        _within_band(s1.pm, s0.pm, band),
    ))
    if drifted:
        return cold()

    # carry the probe estimates forward, scaled by the nnz drift (the only
    # consumer below is the tile gate's hit-rate test; the row-kernel cost
    # hooks read widths alone): a re-probe is exactly what this avoids
    fa = s1.nnz_a / max(1, s0.nnz_a)
    fb = s1.nnz_b / max(1, s0.nnz_b)
    fm = s1.nnz_m / max(1, s0.nnz_m)
    s1 = dataclasses.replace(s1, flops=s0.flops * fa * fb,
                             out_nnz=s0.out_nnz * fm)

    costs = rank_algorithms(s1)
    tile_eligible, tile_block = _tile_path(s1)
    if tile_eligible and s1.flops > 0:
        costs = tuple(sorted(costs + (("tile", tile_cost(s1, tile_block)),),
                             key=lambda kv: (kv[1], kv[0])))
    by_name = dict(costs)
    if old.algorithm == "tile":
        if not tile_eligible:
            return cold()
    elif (old.algorithm not in by_name
          or by_name[old.algorithm] > costs[0][1] * TRIAL_RATIO):
        return cold()

    wb = s1.wbt if old.algorithm == "inner" else s1.wb
    kept = dataclasses.replace(
        old, widths=(s1.wa, wb, s1.pm), stats=s1, costs=costs,
        tile_eligible=tile_eligible,
        tile_block=tile_block if tile_eligible else old.tile_block)
    if use_cache:
        key = (structure_signature(A), structure_signature(B),
               structure_signature(M), complement, semiring.name,
               cost_model_token())
        _cache.put(key, kept)
    obs.event("plan.revalidate", survived=True, algorithm=kept.algorithm)
    return kept, True


def explain(p) -> Dict:
    """Why the planner elected what it elected, as one JSON-safe record,
    for a :class:`Plan` or a :class:`DistPlan`: the elected algorithm or
    route, every candidate's modeled cost (ms), the per-candidate
    ``COST_FEATURES`` decomposition the linear model dotted with its
    constants (so each cost can be recomputed from the record), the
    driving statistics, and the ``cost_model_token()`` the decision was
    made under.  Attached to every ``plan.build`` span."""
    s = p.stats
    stats_d = {f.name: getattr(s, f.name)
               for f in dataclasses.fields(PlanStats)}
    stats_d["compression"] = float(s.compression)
    stats_d["mask_density"] = float(s.mask_density)
    costs = {name: float(c) for name, c in p.costs}
    features: Dict[str, Dict[str, float]] = {}
    for name in costs:
        if name in acc.COST_FEATURES:
            feats = acc.COST_FEATURES[name](
                n=s.n, wa=s.wa, wb=s.wb, wbt=s.wbt, pm=s.pm)
            features[name] = {k: float(v) for k, v in feats.items()}
    out: Dict = {
        "costs_ms": costs,
        "cost_scale_rows": float(s.m / 1024.0),
        "features": features,
        "stats": stats_d,
        "cost_model_token": cost_model_token(),
    }
    if isinstance(p, DistPlan):
        out["elected"] = p.route
        out["route"] = p.route
        out["p"] = p.p
        out["row_algorithm"] = p.row_algorithm
        if p.tile_block:
            tile_f, comm_f = ring_cost_features(s, p.p, p.tile_block)
            features["ring"] = {
                **{k: float(v) for k, v in tile_f.items()},
                **{k: float(v) for k, v in comm_f.items()}}
        out["elected_cost_ms"] = costs.get(p.route)
    else:
        out["elected"] = p.algorithm
        out["algorithm"] = p.algorithm
        out["widths"] = list(p.widths)
        out["two_phase"] = p.two_phase
        out["tile"] = {"eligible": p.tile_eligible, "block": p.tile_block}
        out["trialed"] = list(p.trialed)
        if "tile" in costs and p.tile_block:
            features["tile"] = {
                k: float(v)
                for k, v in tile_cost_features(s, p.tile_block).items()}
        out["elected_cost_ms"] = costs.get(p.algorithm)
    return out


#: memo for per-bucket span attachment: explain() recomputes every
#: candidate's features, and serving re-emits it on every bucket of the
#: same immutable plan; bounded, $REPRO_EXPLAIN_MEMO_CAP overrides
_explain_memo = caches.LRUCache("planner-explain", 256,
                                env_var="REPRO_EXPLAIN_MEMO_CAP")


def explain_cached(p) -> Dict:
    """:func:`explain` memoized by plan identity.  Safe because plans are
    frozen and the memo entry pins the plan object, so its id cannot be
    recycled while the record is held."""
    hit = _explain_memo.get(id(p))
    if hit is not None and hit[0] is p:
        return hit[1]
    info = explain(p)
    _explain_memo.put(id(p), (p, info))
    return info


def feature_regime(p) -> str:
    """Coarse log-bucketed feature signature of a plan's operands (a
    ``Plan`` or a ``DistPlan``): log2 buckets for sizes and widths, log10
    for densities."""
    s = p.stats

    def b2(x) -> int:
        return int(math.log2(max(1, int(x))))

    def b10(d: float) -> int:
        return int(math.floor(math.log10(max(d, 1e-9))))

    dens_a = s.nnz_a / max(1, s.m * s.k)
    dens_m = s.nnz_m / max(1, s.m * s.n)
    return (f"m{b2(s.m)}n{b2(s.n)}w{b2(s.pm)}"
            f"da{b10(dens_a)}dm{b10(dens_m)}")


def plan_batch(As: Sequence, B, Ms: Sequence, *, complement: bool = False,
               semiring: Semiring = PLUS_TIMES,
               allow_tile: bool = False) -> Plan:
    """One Plan for a batch of same-shape operands sharing B.

    Statistics come from the first (A, M) pair; pad widths are widened to
    the batch maxima so one row program fits every element.  The cache key
    covers the whole batch's structure.  ``allow_tile=True`` lets the tile
    route into the ranking (the batched driver then runs it per element);
    the default keeps batches on the row kernels.  No measured trial runs,
    so no device is needed.
    """
    if not As or len(As) != len(Ms):
        raise ValueError("batch needs equal-length non-empty As/Ms")
    key = (tuple(structure_signature(a) for a in As),
           structure_signature(B),
           tuple(structure_signature(m) for m in Ms),
           complement, semiring.name, "batch", allow_tile,
           cost_model_token())
    hit = _cache.get(key)
    if hit is not None:
        return hit

    def width(x):
        return x.width if isinstance(x, PaddedCSR) else _max_row_nnz(x)

    if (isinstance(As[0], CSR) and isinstance(B, CSR)
            and isinstance(Ms[0], CSR)):
        stats = collect_stats(As[0], B, Ms[0], complement=complement,
                              semiring=semiring)
    else:
        m, k = As[0].shape
        _, n = B.shape
        stats = PlanStats(
            m=m, k=k, n=n, nnz_a=m * width(As[0]),
            nnz_b=B.shape[0] * width(B), nnz_m=m * width(Ms[0]),
            wa=width(As[0]), wb=width(B),
            wbt=width(B) if isinstance(B, PaddedCSR) else _max_col_nnz(B),
            pm=width(Ms[0]), complement=complement, semiring=semiring.name)
    stats = dataclasses.replace(
        stats, wa=max(width(a) for a in As), pm=max(width(m) for m in Ms),
        b_transposable=not isinstance(B, PaddedCSR))
    p = decide(stats, allow_tile=allow_tile)
    _cache.put(key, p)
    return p


# A fitted calibration profile named by $REPRO_TUNE_PROFILE is installed
# as soon as the planner exists (this module's tables are the ones it
# overwrites), so child processes plan under the same fitted constants
# without code changes.  Errors propagate: a calibration that silently
# failed to apply would invalidate every measurement made under it.
tuning_profile.activate_from_env()
