"""Port parity: repro_torch.core.planner against repro.core.planner.

Statistics, rankings, tile eligibility and decisions must agree field for
field (the port carries the reference's constants and arithmetic).  Every
problem keeps m below ``TRIAL_MIN_ROWS`` so no measured trial makes an
election depend on timing.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import formats as rf
from repro.core import planner as rp
from repro_torch.convert import csr_from_reference, plan_from_reference
from repro_torch.core import accumulators as acc
from repro_torch.core import planner as tp
from repro_torch.core.formats import padded_from_csr
from repro_torch.core.semiring import REGISTRY as SR
from repro.core.semiring import REGISTRY as REF_SR


def er_problem(n, d_a, d_m, seed):
    A = rf.erdos_renyi(n, d_a, seed=seed)
    B = rf.erdos_renyi(n, d_a, seed=seed + 1)
    M = rf.er_mask(n, d_m, seed=seed + 2)
    return A, B, M


def block_problem(n=128, bs=8):
    return tuple(rf.csr_from_dense(x) for x in (
        rf.block_sparse(n, bs, 0.4, 0.9, seed=1),
        rf.block_sparse(n, bs, 0.4, 0.9, seed=2),
        rf.block_sparse(n, bs, 0.6, 1.0, seed=3, mask=True)))


PROBLEMS = {
    **{f"er_n{n}_a{da}_m{dm}": (lambda n=n, da=da, dm=dm:
                                er_problem(n, da, dm, n + int(da * dm)))
       for n in (96, 200) for da in (2.0, 8.0) for dm in (1.0, 16.0, 60.0)},
    "block_sparse": block_problem,
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("complement", [False, True])
def test_stats_rankings_and_decisions_match(name, complement):
    A, B, M = PROBLEMS[name]()
    At, Bt, Mt = (csr_from_reference(x) for x in (A, B, M))
    want = rp.collect_stats(A, B, M, complement=complement)
    got = tp.collect_stats(At, Bt, Mt, complement=complement)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tp.rank_algorithms(got) == rp.rank_algorithms(want)
    assert tp._tile_path(got) == rp._tile_path(want)
    for bs in tp.TILE_BLOCK_SIZES:
        assert tp.tile_cost(got, bs) == rp.tile_cost(want, bs)
    for allow_tile in (True, False):
        got_p = tp.decide(got, allow_tile=allow_tile)
        want_p = rp.decide(want, allow_tile=allow_tile)
        assert got_p == plan_from_reference(want_p)


def test_block_sparse_point_elects_tile():
    A, B, M = block_problem()
    p = tp.plan(*(csr_from_reference(x) for x in (A, B, M)), device="cpu")
    want = rp.plan(A, B, M)
    assert p.algorithm == want.algorithm == "tile"
    assert p.tile_block == want.tile_block


@pytest.mark.parametrize("sr", ["plus_times", "min_plus"])
def test_semiring_and_padded_operands_match(sr):
    A, B, M = er_problem(64, 4.0, 8.0, 5)
    At, Bt, Mt = (csr_from_reference(x) for x in (A, B, M))
    got = tp.plan(At, Bt, Mt, semiring=SR[sr], use_cache=False, device="cpu")
    want = rp.plan(A, B, M, semiring=REF_SR[sr], use_cache=False)
    assert got == plan_from_reference(want)
    # device-resident operands are planned from their static widths
    Ap = padded_from_csr(At, device="cpu")
    Bp = padded_from_csr(Bt, device="cpu")
    Mp = padded_from_csr(Mt, device="cpu")
    got = tp.plan(Ap, Bp, Mp, use_cache=False, device="cpu")
    want = rp.plan(rf.padded_from_csr(A), rf.padded_from_csr(B),
                   rf.padded_from_csr(M), use_cache=False)
    assert got == plan_from_reference(want)
    assert "inner" not in dict(got.costs)


def test_plan_cache_hits():
    tp.clear_plan_cache()
    A, B, M = (csr_from_reference(x) for x in er_problem(80, 3.0, 6.0, 9))
    p1 = tp.plan(A, B, M, device="cpu")
    p2 = tp.plan(A, B, M, device="cpu")
    assert p1 is p2
    info = tp.plan_cache_info()
    assert info["hits"] == 1 and info["misses"] == 1 and info["size"] == 1
    # same structure, other values: still a hit
    A2 = type(A)(A.indptr, A.indices, A.data * 2, A.shape)
    assert tp.plan(A2, B, M, device="cpu") is p1
    # other semiring / complement: separate entries
    tp.plan(A, B, M, semiring=SR["or_and"], device="cpu")
    tp.plan(A, B, M, complement=True, device="cpu")
    assert tp.plan_cache_info()["size"] == 3


def test_cost_model_token_tracks_constants(monkeypatch):
    token = tp.cost_model_token()
    # same tables, same fingerprint (the reference's version part may name
    # a profile another test activated)
    assert token.startswith("builtin-")
    assert token.split("-")[-1] == rp.cost_model_token().split("-")[-1]
    tp.clear_plan_cache()
    A, B, M = (csr_from_reference(x) for x in er_problem(80, 3.0, 6.0, 11))
    p1 = tp.plan(A, B, M, device="cpu")
    monkeypatch.setitem(acc.COST_CONSTANTS, "msa",
                        dict(acc.COST_CONSTANTS["msa"], base=1e6))
    assert tp.cost_model_token() != token
    assert tp.plan(A, B, M, device="cpu") is not p1
    monkeypatch.setitem(tp.TILE_COST, "base", 4.0)
    token2 = tp.cost_model_token()
    monkeypatch.setattr(tp, "TILE_MIN_DENSITY", 0.5)
    assert tp.cost_model_token() != token2


def test_measured_trial_elects_a_near_tied_candidate():
    """Above TRIAL_MIN_ROWS a near-tie is timed on the caller's device;
    which candidate wins depends on timing, so only membership is
    checked."""
    tp.clear_plan_cache()
    A, B, M = (csr_from_reference(x)
               for x in er_problem(tp.TRIAL_MIN_ROWS, 3.0, 20.0, 13))
    stats = tp.collect_stats(A, B, M)
    decided = tp.decide(stats)
    p = tp.plan(A, B, M, device="cpu")
    cand = tp._trial_candidates(decided)
    assert len(cand) >= 2                      # a real near-tie
    assert p.trialed == cand and p.algorithm in cand
    # the winner is memoized by shape class and reused without timing
    tp._cache.clear()
    assert tp.plan(A, B, M, device="cpu").algorithm == p.algorithm
