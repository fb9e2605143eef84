"""Port parity for planner calibration (``repro_torch.tuning``) against the
reference's ``repro.tuning`` and its ``tests/test_tuning.py``.

The contracts: one profile schema and registry in both packages (each
reads the other's files, versions and cost-model tokens agree), the fit is
the reference's arithmetic (same measurements, same constants to rtol
1e-12), activation rewrites the live tables in place and changes which
route runs, never what it returns, and the smoke probes measure the
reference's points.  Every test that activates a profile restores the
shipped constants in ``finally`` in both packages: the tables are
process-global and other files' tests on the same worker plan under them.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import accumulators as racc
from repro.core import formats as rf
from repro.core import planner as rp
from repro.core.masked_spgemm import ALGORITHMS as REF_ALGORITHMS
from repro.tuning import autotune as rautotune
from repro.tuning import fit as rfit
from repro.tuning import profile as rprofile
from repro.tuning.probes import Measurement as RefMeasurement
from repro_torch import tuning
from repro_torch.convert import csr_from_reference
from repro_torch.core import accumulators as acc
from repro_torch.core import planner
from repro_torch.core.formats import random_mask_like
from repro_torch.core.masked_spgemm import masked_spgemm
from repro_torch.serving.trace import Trace, golden_trace_path
from repro_torch.tuning import autotune, cli, fit, probes
from repro_torch.tuning import profile as tprofile
from repro_torch.tuning.probes import Measurement

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
TEST_BACKEND = {"platform": "test", "device_kind": "test", "device_count": 1}
H100_KEY = "gpu_NVIDIA-H100-80GB-HBM3_1"
#: the cost-model token of the shipped constants (both packages), as the
#: committed serving_default.json records it
BUILTIN_TOKEN = "builtin-cf91fbf2"


def _builtin(snapshot):
    """The shipped tables as a profile whose version is the builtin token,
    so activating it restores ``cost_model_token()`` exactly."""
    return dataclasses.replace(snapshot(name="builtin",
                                        backend=dict(TEST_BACKEND)),
                               version="builtin")


#: the shipped tables, captured before any test mutates them
BUILTIN = _builtin(tprofile.snapshot)
REF_BUILTIN = _builtin(rprofile.snapshot)


def restore_builtin():
    tuning.activate(BUILTIN)
    planner.clear_plan_cache()
    rprofile.activate(REF_BUILTIN)
    rp.clear_plan_cache()


@pytest.fixture
def builtin_tables():
    """Both packages under the shipped constants for the test, and again
    after it whatever it activated."""
    restore_builtin()
    try:
        yield
    finally:
        restore_builtin()


def perturbed(name="perturbed", scale=3.0, version="", cls=None):
    """A structurally valid profile with rescaled constants (a stand-in
    for a fit on very different hardware), as the reference's tests make
    it; ``cls`` picks the package's CalibrationProfile."""
    cls = cls or tuning.CalibrationProfile
    return cls(
        name=name,
        backend=dict(TEST_BACKEND),
        cost_constants={alg: {k: v * scale for k, v in tbl.items()}
                        for alg, tbl in BUILTIN.cost_constants.items()},
        tile_cost={k: v * scale for k, v in BUILTIN.tile_cost.items()},
        tile_gates=dict(BUILTIN.tile_gates),
        dist_cost={k: v * scale for k, v in BUILTIN.dist_cost.items()},
        residuals={"row": 0.1},
        version=version,
    )


def warped(cls=None, version="warped"):
    """The reference's ranking-inverting profile: each algorithm's
    constants x100 or x0.01 in alternation."""
    p = perturbed(scale=1.0, cls=cls)
    for i, (_alg, tbl) in enumerate(sorted(p.cost_constants.items())):
        for k in tbl:
            tbl[k] *= 100.0 if i % 2 else 0.01
    return dataclasses.replace(p, version=version)


def to_ref(p):
    return rprofile.CalibrationProfile.from_json(p.to_json())


# ---------------------------------------------------------------------------
# profiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale,gate,residual", [
    (0.05, 0.001, 0.0), (1.0, 0.05, 0.3), (7.5, 0.2, 2.5), (20.0, 0.5, 10.0)])
def test_profile_json_round_trip_and_reference_schema(scale, gate, residual):
    p = perturbed(scale=scale)
    p = dataclasses.replace(p, tile_gates=dict(p.tile_gates,
                                               min_density=gate),
                            residuals={"row": residual, "tile": residual},
                            version="")
    q = tuning.CalibrationProfile.from_json(p.to_json())
    assert q == p
    assert q.version == p.version == p.fingerprint()
    assert q.to_json() == p.to_json()
    # one schema: the reference reads it byte for byte, same version
    r = rprofile.CalibrationProfile.from_json(p.to_json())
    assert r.to_json() == p.to_json() and r.version == p.version


def test_version_token_tracks_constants_as_reference():
    assert perturbed(scale=2).version != perturbed(scale=3).version
    assert perturbed(scale=2).version == perturbed(scale=2).version
    assert perturbed(version="pinned").version == "pinned"
    for s in (0.5, 2.0, 3.0):
        assert (perturbed(scale=s).version
                == perturbed(scale=s,
                             cls=rprofile.CalibrationProfile).version)


CORRUPTIONS = {
    "no_cost_constants": lambda d: d.pop("cost_constants"),
    "missing_key": lambda d: d["cost_constants"]["msa"].pop("per_flop"),
    "nan": lambda d: d["tile_cost"].update(per_mac=float("nan")),
    "negative": lambda d: d["dist_cost"].update(stage_base=-1.0),
    "inf_residual": lambda d: d["residuals"].update(row=float("inf")),
    "schema": lambda d: d.update(schema=99),
    "missing_gate": lambda d: d["tile_gates"].pop("min_hit_rate"),
    "bool_constant": lambda d: d["tile_cost"].update(base=True),
}


@pytest.mark.parametrize("corrupt", sorted(CORRUPTIONS))
def test_profile_validation_rejects_what_reference_rejects(corrupt):
    d = json.loads(perturbed().to_json())
    CORRUPTIONS[corrupt](d)
    text = json.dumps(d)
    with pytest.raises(tuning.ProfileError):
        tuning.CalibrationProfile.from_json(text)
    with pytest.raises(rprofile.ProfileError):
        rprofile.CalibrationProfile.from_json(text)


def test_profile_rejects_non_json():
    with pytest.raises(tuning.ProfileError):
        tuning.CalibrationProfile.from_json("not json {")
    with pytest.raises(tuning.ProfileError):
        tuning.CalibrationProfile.from_json("[1, 2]")


def test_required_table_keys_equal_reference():
    assert tprofile.required_table_keys() == rprofile.required_table_keys()
    assert tprofile.TILE_GATE_KEYS == rprofile.TILE_GATE_KEYS


def test_fingerprint_and_token_equal_reference_under_builtin(monkeypatch):
    monkeypatch.setattr(tprofile, "_active", None)
    monkeypatch.setattr(rprofile, "_active", None)
    assert planner.cost_model_token() == rp.cost_model_token() \
        == BUILTIN_TOKEN
    serving = json.loads((REPO / "results" / "profiles"
                          / "serving_default.json").read_text())
    assert serving["cost_model_token"] == BUILTIN_TOKEN
    assert BUILTIN.fingerprint() == REF_BUILTIN.fingerprint() \
        == tprofile.fingerprint_tables(
            acc.COST_CONSTANTS, planner.TILE_COST,
            dict(BUILTIN.tile_gates), planner.DIST_COST)


@pytest.mark.parametrize("scale,version", [(3.0, ""), (0.25, "shared")])
def test_token_equals_reference_under_a_shared_profile(builtin_tables,
                                                       scale, version):
    p = perturbed(scale=scale, version=version)
    tuning.activate(p)
    rprofile.activate(to_ref(p))
    assert planner.cost_model_token() == rp.cost_model_token()
    assert planner.cost_model_token().startswith(p.version + "-")
    assert planner.cost_model_token() != BUILTIN_TOKEN


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_hit_miss_and_default_fallback(tmp_path):
    d = str(tmp_path)
    fitted = dataclasses.replace(perturbed(name="h100-fit"), backend={
        "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
        "device_count": 1})
    path = tuning.register(fitted, d)
    assert os.path.basename(path) == H100_KEY + ".json"
    got, exact = tuning.lookup(fitted.backend, d)
    assert exact and got == fitted
    # the reference finds the port's entry under the same key
    rgot, rexact = rprofile.lookup(fitted.backend, d)
    assert rexact and rgot.to_json() == fitted.to_json()
    other = {"platform": "gpu", "device_kind": "H200", "device_count": 2}
    with pytest.raises(FileNotFoundError):
        tuning.lookup(other, d)
    (tmp_path / "default.json").write_text(
        dataclasses.replace(BUILTIN, name="default").to_json())
    got, exact = tuning.lookup(other, d)
    assert not exact and got.name == "default"


@pytest.mark.parametrize("backend,key", [
    ({"platform": "tpu", "device_kind": "TPU v5e/lite:2",
      "device_count": 16}, "tpu_TPU-v5e-lite-2_16"),
    ({"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
      "device_count": 1}, H100_KEY),
    ({"platform": "cpu", "device_kind": "cpu", "device_count": 1},
     "cpu_cpu_1"),
    ({"platform": "gpu"}, "gpu_unknown_unknown"),
])
def test_registry_key_is_filesystem_safe_and_reference_equal(backend, key):
    assert tuning.profile_key(backend) == rprofile.profile_key(backend) == key
    path = tuning.profile_path(backend, "/x")
    assert path == rprofile.profile_path(backend, "/x")
    assert path.rsplit("/", 1)[1] == key + ".json"


def test_backend_signature_cpu_equals_reference():
    assert tuning.backend_signature(CPU) == rprofile.backend_signature()
    assert tuning.profile_key(tuning.backend_signature(CPU)) == "cpu_cpu_1"


def test_backend_signature_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA signature is real here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tuning.backend_signature()
    with pytest.raises(ValueError):
        tuning.backend_signature("meta")


def test_profile_dir_resolves_as_reference(monkeypatch, tmp_path):
    assert (tprofile._checkout_profile_dir()
            == rprofile._checkout_profile_dir()
            == str(REPO / "results" / "profiles"))
    monkeypatch.setenv(tprofile.PROFILE_DIR_ENV, str(tmp_path))
    assert tuning.profile_dir() == rprofile.profile_dir() == str(tmp_path)
    monkeypatch.delenv(tprofile.PROFILE_DIR_ENV)
    monkeypatch.chdir(tmp_path)         # no results/profiles here
    assert tuning.profile_dir() == tprofile._checkout_profile_dir()


def test_committed_default_profile_matches_shipped_tables():
    p = tuning.CalibrationProfile.load(
        str(REPO / "results" / "profiles" / "default.json"))
    p.validate()
    assert p.fingerprint() == BUILTIN.fingerprint()
    got, exact = tuning.lookup(tuning.backend_signature(CPU),
                               str(REPO / "results" / "profiles"))
    assert not exact and got == p


# ---------------------------------------------------------------------------
# fit: the reference's arithmetic on the reference tests' measurements
# ---------------------------------------------------------------------------


def row_measurements(gt, n_points=12, noise=0.0, seed=0):
    """``tests/test_tuning.py``'s synthetic row family (reference types)."""
    rng = np.random.default_rng(seed)
    ms = []
    for i in range(n_points):
        s = rp.PlanStats(
            m=int(rng.integers(128, 2048)), k=1024,
            n=int(2 ** rng.integers(8, 13)),
            nnz_a=9000, nnz_b=9000, nnz_m=9000,
            wa=int(rng.integers(2, 64)), wb=int(rng.integers(2, 64)),
            wbt=int(rng.integers(2, 64)), pm=int(rng.integers(2, 128)),
            complement=False)
        feats = dataclasses.asdict(s)
        for alg, fn in racc.COST_FEATURES.items():
            f = fn(n=s.n, wa=s.wa, wb=s.wb, wbt=s.wbt, pm=s.pm)
            t = sum(gt[alg][k] * f[k] for k in f) * (s.m / 1024.0)
            t *= 1.0 + noise * float(rng.uniform(-1, 1))
            ms.append(RefMeasurement("row", alg, f"syn{i}", t / 1e3, feats))
    return ms


def tile_measurements(gt_cost, seed=0):
    """``tests/test_tuning.py``'s synthetic tile family: tile wins iff the
    point is dense (density >= 0.1)."""
    rng = np.random.default_rng(seed)
    ms = []
    for i in range(10):
        n = 512
        bs = int(rng.choice([8, 16, 32]))
        dens = float(rng.uniform(0.02, 0.4))
        nnz = int(dens * n * n)
        s = rp.PlanStats(m=n, k=n, n=n, nnz_a=nnz, nnz_b=nnz, nnz_m=nnz,
                         wa=8, wb=8, wbt=8, pm=8, complement=False,
                         flops=1e5, out_nnz=1e4)
        f = rp.tile_cost_features(s, bs)
        t = sum(gt_cost[k] * f[k] for k in f)
        feats = dict(dataclasses.asdict(s), bs=float(bs))
        ms.append(RefMeasurement("tile", "tile", f"syn{i}", t / 1e3, feats))
        ms.append(RefMeasurement("tile", "row:msa", f"syn{i}",
                                 t * (0.5 if dens < 0.1 else 2.0) / 1e3,
                                 feats))
    return ms


def dist_measurements():
    """``tests/test_tuning.py``'s synthetic dist family (p = 2, 4, 8)."""
    s = rp.PlanStats(m=1024, k=1024, n=1024, nnz_a=90000, nnz_b=90000,
                     nnz_m=90000, wa=128, wb=128, wbt=128, pm=128,
                     complement=False)
    feats = dataclasses.asdict(s)
    gt = {k: v * 2.0 for k, v in REF_BUILTIN.dist_cost.items()}
    ms = []
    for p in (2, 4, 8):
        tile_f, comm_f = rp.ring_cost_features(s, p, 32)
        t_ring = (sum(REF_BUILTIN.tile_cost[k] * tile_f[k] for k in tile_f)
                  + sum(gt[k] * comm_f[k] for k in comm_f))
        f_row = racc.COST_FEATURES["msa"](n=s.n, wa=s.wa, wb=s.wb,
                                          wbt=s.wbt, pm=s.pm)
        t_row = (sum(REF_BUILTIN.cost_constants["msa"][k] * f_row[k]
                     for k in f_row) / p
                 + gt["per_bcast_elem"] * rp.row_replication_elems(s, "msa"))
        extra = dict(feats, p=float(p), bs=32.0, row_algorithm="msa")
        ms.append(RefMeasurement("dist", "ring", f"p{p}", t_ring / 1e3,
                                 extra))
        ms.append(RefMeasurement("dist", "row", f"p{p}", t_row / 1e3, extra))
    return ms


def ported(ms):
    return [Measurement.from_dict(m.to_dict()) for m in ms]


def assert_tables_close(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            assert_tables_close(got[k], want[k])
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nnls_ridge_equals_reference(seed):
    rng = np.random.default_rng(seed)
    F = rng.uniform(0, 10, (20, 4))
    t = F @ rng.uniform(0.1, 2, 4) * rng.uniform(0.9, 1.1, 20)
    prior = rng.uniform(0.1, 2, 4)
    off = rng.uniform(0, 1, 20) if seed else None
    x, rel = fit.nnls_ridge(F, t, prior, offset=off)
    rx, rrel = rfit.nnls_ridge(F, t, prior, offset=off)
    np.testing.assert_allclose(x, rx, rtol=1e-12, atol=0)
    assert rel == pytest.approx(rrel, rel=1e-12)


@pytest.mark.parametrize("scale,noise", [(2.5, 0.02), (0.1, 0.0)])
def test_fit_row_equals_reference(scale, noise):
    gt = {alg: {k: v * scale for k, v in tbl.items()}
          for alg, tbl in REF_BUILTIN.cost_constants.items()}
    ms = row_measurements(gt, noise=noise)
    got, resid = fit.fit_row(ported(ms), BUILTIN.cost_constants)
    want, rresid = rfit.fit_row(ms, REF_BUILTIN.cost_constants)
    assert_tables_close(got, want)
    assert resid == pytest.approx(rresid, rel=1e-12)
    assert math.isfinite(resid) and resid < 0.1


def test_fit_tile_equals_reference_gates_included():
    gt = {k: v * 4.0 for k, v in REF_BUILTIN.tile_cost.items()}
    ms = tile_measurements(gt)
    cost, gates, resid = fit.fit_tile(ported(ms), BUILTIN.tile_cost,
                                      BUILTIN.tile_gates)
    rcost, rgates, rresid = rfit.fit_tile(ms, REF_BUILTIN.tile_cost,
                                          REF_BUILTIN.tile_gates)
    assert_tables_close(cost, rcost)
    assert_tables_close(gates, rgates)
    assert resid == pytest.approx(rresid, rel=1e-12)
    # the synthetic outcomes separate at density 0.1: the gate moved
    assert gates["min_density"] != BUILTIN.tile_gates["min_density"]
    assert gates["min_hit_rate"] == BUILTIN.tile_gates["min_hit_rate"]


def test_fit_dist_equals_reference():
    ms = dist_measurements()
    got, resid = fit.fit_dist(ported(ms), BUILTIN.cost_constants,
                              BUILTIN.tile_cost, BUILTIN.dist_cost)
    want, rresid = rfit.fit_dist(ms, REF_BUILTIN.cost_constants,
                                 REF_BUILTIN.tile_cost,
                                 REF_BUILTIN.dist_cost)
    assert_tables_close(got, want)
    assert resid == pytest.approx(rresid, rel=1e-12)


def test_ring_features_and_replication_equal_reference():
    for s in (rp.PlanStats(m=1024, k=512, n=2048, nnz_a=9000, nnz_b=30000,
                           nnz_m=70000, wa=40, wb=90, wbt=70, pm=128,
                           complement=False),
              rp.PlanStats(m=64, k=64, n=64, nnz_a=1, nnz_b=4000, nnz_m=9,
                           wa=1, wb=64, wbt=64, pm=3, complement=False)):
        ts = planner.PlanStats(**dataclasses.asdict(s))
        for p in (1, 2, 4, 8):
            for bs in (8, 32, 128):
                assert (planner.ring_cost_features(ts, p, bs)
                        == rp.ring_cost_features(s, p, bs))
        for alg in REF_ALGORITHMS:
            assert (planner.row_replication_elems(ts, alg)
                    == rp.row_replication_elems(s, alg))


@pytest.mark.parametrize("families", [("row",), ("row", "tile"),
                                      ("row", "tile", "dist")])
def test_fit_profile_equals_reference(families):
    gt = {alg: {k: v * 1.7 for k, v in tbl.items()}
          for alg, tbl in REF_BUILTIN.cost_constants.items()}
    ms = (row_measurements(gt, n_points=6)
          + tile_measurements({k: v * 0.5
                               for k, v in REF_BUILTIN.tile_cost.items()})
          + dist_measurements())
    got = fit.fit_profile(ported(ms), BUILTIN, families=families,
                          name="fit", backend=dict(TEST_BACKEND))
    want = rfit.fit_profile(ms, REF_BUILTIN, families=families, name="fit",
                            backend=dict(TEST_BACKEND))
    for table in ("cost_constants", "tile_cost", "tile_gates", "dist_cost",
                  "residuals"):
        assert_tables_close(getattr(got, table), getattr(want, table))
    assert got.meta["fitted_families"] == sorted(families)
    if "dist" not in families:
        assert got.dist_cost == BUILTIN.dist_cost
        assert "dist" not in got.residuals
    with pytest.raises(tuning.ProfileError):
        fit.fit_profile([], BUILTIN, families=("bogus",))


# ---------------------------------------------------------------------------
# activation
# ---------------------------------------------------------------------------


def test_activation_changes_live_tables_and_token_then_restores(
        builtin_tables):
    before = planner.cost_model_token()
    assert before == BUILTIN_TOKEN
    p = perturbed(scale=7.0)
    tuning.activate(p)
    assert planner.cost_model_token() != before
    assert acc.COST_CONSTANTS["msa"]["base"] == \
        BUILTIN.cost_constants["msa"]["base"] * 7.0
    assert planner.TILE_COST["base"] == BUILTIN.tile_cost["base"] * 7.0
    assert planner.DIST_COST["stage_base"] == \
        BUILTIN.dist_cost["stage_base"] * 7.0
    assert tuning.active_version() == p.version
    assert tuning.active_profile() is p
    tuning.activate(dataclasses.replace(
        p, tile_gates=dict(p.tile_gates, min_density=0.3), version="g"))
    assert planner.TILE_MIN_DENSITY == 0.3
    restore_builtin()
    assert planner.cost_model_token() == before
    assert planner.TILE_MIN_DENSITY == BUILTIN.tile_gates["min_density"]


def test_new_version_token_invalidates_cached_plans(builtin_tables):
    g = csr_from_reference(rf.rmat(6, 4, seed=3))
    m = random_mask_like(g, 0.5, seed=4)
    tuning.activate(perturbed(scale=1.0, version="token-a"))
    planner.clear_plan_cache()
    planner.plan(g, g, m, device=CPU)
    assert planner.plan_cache_info()["misses"] == 1
    planner.plan(g, g, m, device=CPU)
    assert planner.plan_cache_info()["hits"] == 1
    tuning.activate(perturbed(scale=1.0, version="token-b"))
    planner.plan(g, g, m, device=CPU)
    assert planner.plan_cache_info()["misses"] == 2, \
        "stale plan served across activation"


def election_problems():
    """Reference operands, m below TRIAL_MIN_ROWS (no measured trial)."""
    g = rf.rmat(7, 4, seed=11)
    m = random_mask_like(csr_from_reference(g), 0.6, seed=12)
    return {
        "rmat7": (g, g, rf.CSR(m.indptr, m.indices, m.data, m.shape)),
        "er_sparse_mask": (rf.erdos_renyi(200, 3.0, seed=1),
                           rf.erdos_renyi(200, 3.0, seed=2),
                           rf.er_mask(200, 2.0, seed=3)),
        "er_dense_mask": (rf.erdos_renyi(160, 6.0, seed=4),
                          rf.erdos_renyi(160, 6.0, seed=5),
                          rf.er_mask(160, 60.0, seed=6)),
        "block": tuple(rf.csr_from_dense(x) for x in (
            rf.block_sparse(128, 8, 0.4, 0.9, seed=1),
            rf.block_sparse(128, 8, 0.4, 0.9, seed=2),
            rf.block_sparse(128, 8, 0.6, 1.0, seed=3, mask=True))),
    }


def test_auto_results_bitwise_equal_under_builtin_and_warped(builtin_tables):
    """Calibration may change WHICH algorithm runs, never WHAT it returns
    (integer-valued operands: exact on every route)."""
    changed = 0
    for name, ops in election_problems().items():
        A, B, M = (csr_from_reference(x) for x in ops)
        A = dataclasses.replace(A, data=np.round(A.data * 3 + 1))
        B = dataclasses.replace(B, data=np.round(B.data * 2 + 1))
        base = masked_spgemm(A, B, M, device=CPU)
        before = planner.plan(A, B, M, device=CPU).algorithm
        tuning.activate(warped())
        other = masked_spgemm(A, B, M, device=CPU)
        changed += planner.plan(A, B, M, device=CPU).algorithm != before
        assert torch.equal(base.vals, other.vals), name
        assert torch.equal(base.present, other.present), name
        restore_builtin()
    assert changed, "the warped profile changed no election"


def test_warped_elections_equal_reference(builtin_tables):
    w = warped()
    tuning.activate(w)
    rprofile.activate(to_ref(w))
    assert planner.cost_model_token() == rp.cost_model_token()
    for name, (A, B, M) in election_problems().items():
        want = rp.plan(A, B, M)
        got = planner.plan(*(csr_from_reference(x) for x in (A, B, M)),
                           device=CPU)
        assert (got.algorithm, got.tile_block, got.widths) == (
            want.algorithm, want.tile_block, tuple(want.widths)), name
        assert got.costs == tuple(tuple(c) for c in want.costs), name


def test_env_var_activates_profile_in_child_without_jax(tmp_path):
    p = warped(version="env-test")
    path = str(tmp_path / "env_profile.json")
    p.save(path)
    A, B, M = election_problems()["er_sparse_mask"]
    want = rp.decide(rp.collect_stats(A, B, M)).algorithm
    rprofile.activate(to_ref(p))
    try:
        want_env = rp.decide(rp.collect_stats(A, B, M)).algorithm
    finally:
        rprofile.activate(REF_BUILTIN)
    assert want_env != want, "pick an election the profile changes"
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.core.planner as pl\n"
        "import repro_torch.core.accumulators as acc\n"
        "import repro_torch.tuning as tu\n"
        "from repro_torch.core import formats as F\n"
        "assert tu.active_version() == 'env-test', tu.active_version()\n"
        f"assert acc.COST_CONSTANTS['msa']['base'] == "
        f"{p.cost_constants['msa']['base']!r}\n"
        "A = F.erdos_renyi(200, 3.0, seed=1)\n"
        "B = F.erdos_renyi(200, 3.0, seed=2)\n"
        "M = F.er_mask(200, 2.0, seed=3)\n"
        "p = pl.plan(A, B, M, device='cpu')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'repro']\n"
        "print('ok', pl.cost_model_token(), p.algorithm)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_TUNE_PROFILE=path)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    word, token, algorithm = out.stdout.split()
    assert word == "ok" and token.startswith("env-test-")
    assert algorithm == want_env
    # a requested profile that cannot load raises at import
    env["REPRO_TUNE_PROFILE"] = str(tmp_path / "missing.json")
    bad = subprocess.run([sys.executable, "-c",
                          "import repro_torch.core.planner"],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert bad.returncode != 0 and "missing.json" in bad.stderr


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------


def reference_smoke_points():
    """The reference's smoke grids, point for point: (family, target,
    point, features) from the reference's generators and collect_stats."""
    from repro.tuning.probes import _stats_features
    out = []
    n = 256
    for d in (2, 8):
        A = rf.erdos_renyi(n, d, seed=10 + d)
        B = rf.erdos_renyi(n, d, seed=20 + d)
        for dm in (2, 8):
            M = rf.er_mask(n, dm, seed=30 + dm)
            feats = _stats_features(rp.collect_stats(A, B, M))
            out += [("row", a, f"row_n{n}_d{d}_m{dm}", feats)
                    for a in REF_ALGORITHMS]
    n = 128
    for bs in (8, 16):
        points = [(f"tile_bs{bs}_td{td}_mo{mo}",
                   rf.block_sparse(n, bs, td, 0.9, seed=100 + bs),
                   rf.block_sparse(n, bs, td, 0.9, seed=200 + bs),
                   rf.block_sparse(n, bs, mo, 1.0, seed=300 + int(mo * 10),
                                   mask=True))
                  for td in (0.3,) for mo in (0.5,)]
        points.append((f"tile_bs{bs}_er_control",
                       rf.erdos_renyi(n, 4, seed=bs).to_dense(),
                       rf.erdos_renyi(n, 4, seed=bs + 1).to_dense(),
                       rf.er_mask(n, 8, seed=bs + 2).to_dense()))
        for point, A, B, M in points:
            stats = rp.collect_stats(*(rf.csr_from_dense(np.asarray(x))
                                       for x in (A, B, M)))
            feats = dict(_stats_features(stats), bs=float(bs))
            out.append(("tile", "tile", point, feats))
            out.append(("tile", f"row:{rp.rank_algorithms(stats)[0][0]}",
                        point, feats))
    return out


@pytest.fixture(scope="module")
def smoke_measurements():
    restore_builtin()
    return probes.run_probes(("row", "tile"), smoke=True, device=CPU,
                             log=lambda line: None)


def test_smoke_probes_measure_the_reference_points(smoke_measurements):
    got = [(m.family, m.target, m.point, m.features)
           for m in smoke_measurements]
    assert got == reference_smoke_points()
    assert all(m.seconds > 0 and math.isfinite(m.seconds)
               for m in smoke_measurements)


def test_smoke_probes_fit_and_count_their_tile_calls(smoke_measurements):
    tiles = [m for m in smoke_measurements if m.target == "tile"]
    assert probes.tile_calls(smoke=True) == 2 * len(tiles) == 8
    p = fit.fit_profile(smoke_measurements, BUILTIN,
                        families=("row", "tile"), name="smoke",
                        backend=tuning.backend_signature(CPU))
    assert set(p.residuals) == {"row", "tile"}
    assert all(math.isfinite(v) for v in p.residuals.values())
    assert p.dist_cost == BUILTIN.dist_cost
    assert to_ref(p).version == p.version


def test_grids_keep_the_reference_entries_first():
    assert probes.ROW_GRID_SMOKE == ((256, (2, 8), (2, 8), 1),)
    assert probes.TILE_GRID_SMOKE == ((128, (8, 16), (0.3,), (0.5,), 1),)
    assert probes.ROW_GRID[:2] == ((512, (2, 8, 32), (2, 8, 32), 2),
                                   (1024, (2, 8, 32), (2, 8, 32), 2))
    assert probes.TILE_GRID[0] == (512, (8, 32), (0.1, 0.3), (0.2, 0.6), 2)
    assert probes.FAMILIES == ("row", "tile", "dist")


def test_dist_probes_and_cuda_without_card_raise():
    """The dist probes are ported (``tests/test_torch_distributed.py``
    runs them): like every family they refuse a card that is not there,
    and unknown families are refused before anything runs."""
    with pytest.raises(ValueError, match="unknown"):
        probes.run_probes(("dist", "bogus"), device=CPU)
    with pytest.raises(ValueError, match="unknown"):
        probes.run_probes(("bogus",), device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            probes.probe_dist(smoke=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            probes.probe_row(smoke=True)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_export_defaults_and_validate(tmp_path, capsys, builtin_tables):
    path = str(tmp_path / "defaults.json")
    assert cli.main(["--export-defaults", path, "--device", CPU]) == 0
    p = tuning.CalibrationProfile.load(path)
    assert p.fingerprint() == BUILTIN.fingerprint()
    assert p.backend == tuning.backend_signature(CPU)
    assert rprofile.CalibrationProfile.load(path).version == p.version
    assert cli.main(["--validate", path]) == 0
    assert "validates" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(dict(json.loads(p.to_json()), schema=99)))
    with pytest.raises(tuning.ProfileError):
        cli.main(["--validate", str(bad)])


def test_cli_smoke_out_fits_row_tile_and_inherits_dist(tmp_path, capsys,
                                                       builtin_tables):
    path = str(tmp_path / "smoke.json")
    assert cli.main(["--smoke", "--out", path, "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "dist residual: inherited" in out
    assert "probing families: row, tile" in out
    p = tuning.CalibrationProfile.load(path)
    assert set(p.residuals) == {"row", "tile"}
    assert p.dist_cost == BUILTIN.dist_cost
    assert p.backend == tuning.backend_signature(CPU)
    assert p.meta["device"] == CPU and p.meta["smoke"] is True
    assert p.meta["fitted_families"] == ["row", "tile"]
    assert not os.path.exists(tuning.profile_path(p.backend))


def test_cli_fits_from_the_profile_named_in_the_environment(tmp_path):
    """``REPRO_TUNE_PROFILE`` names the base of a fit: its tables are the
    prior and the families not probed are inherited from it."""
    base = perturbed(name="env-base", scale=2.0)
    base_path = str(tmp_path / "base.json")
    base.save(base_path)
    out_path = str(tmp_path / "fit.json")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_TUNE_PROFILE=base_path)
    out = subprocess.run([sys.executable, "-m", "repro_torch.tune",
                          "--smoke", "--only", "row", "--device", CPU,
                          "--out", out_path], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    p = tuning.CalibrationProfile.load(out_path)
    assert p.meta["base_profile"] == "env-base"
    assert p.tile_cost == base.tile_cost and p.dist_cost == base.dist_cost
    assert set(p.residuals) == {"row"}


@pytest.mark.parametrize("only", ["dist,bogus", "row,dist,bogus", "bogus",
                                  ","])
def test_cli_only_dist_or_unknown_exits_nonzero(only):
    """``--only dist`` runs (``tests/test_torch_distributed.py``); an
    unknown family beside it, or no family, exits non-zero before any
    probe runs."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["--only", only, "--device", CPU, "--out", os.devnull])
    assert exc.value.code not in (0, None)
    if "bogus" in only:
        assert "unknown" in str(exc.value.code)


def test_tune_module_runs_as_a_program(tmp_path):
    path = str(tmp_path / "p.json")
    BUILTIN.save(path)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.tune",
                          "--validate", path], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "validates" in out.stdout


# ---------------------------------------------------------------------------
# serving-knob autotuner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False])
def test_knob_grid_equals_reference(smoke):
    assert autotune.knob_grid(smoke) == rautotune.knob_grid(smoke)
    assert autotune.DEFAULT_KNOBS == rautotune.DEFAULT_KNOBS
    assert autotune.knob_grid(smoke)[0] == autotune.DEFAULT_KNOBS


def test_evaluate_knobs_on_golden_trace_gives_committed_digest(
        builtin_tables):
    trace = Trace.load(golden_trace_path())
    grid = json.loads((REPO / "results" / "bench"
                       / "replay_grid.json").read_text())
    rec = autotune.evaluate_knobs(trace, autotune.DEFAULT_KNOBS, device=CPU)
    assert rec["digest"] == grid["digest"] == "08c64568"
    assert rec["buckets_executed"] == grid["counters"]["buckets_executed"]
    assert rec["qps"] > 0 and rec["knobs"] == autotune.DEFAULT_KNOBS


def tiny_trace():
    from repro_torch.serving.trace import synthesize_trace
    return synthesize_trace(name="tiny", n=48, n_structs=2, queries=10,
                            mean_gap_ms=0.3, seed=0)


def test_autotune_winner_not_worse_and_profile_round_trip(tmp_path,
                                                          builtin_tables):
    result = autotune.autotune(tiny_trace(), smoke=True, rounds=1,
                               verbose=False, device=CPU)
    assert result["winner"]["qps"] >= result["default"]["qps"]
    assert result["configs_evaluated"] == len(autotune.knob_grid(True))
    path = autotune.save_serving_profile(result,
                                         path=str(tmp_path / "knobs.json"))
    prof = autotune.load_serving_profile(path)
    assert prof["backend"] == tuning.backend_signature(CPU)
    assert prof["cost_model_token"] == BUILTIN_TOKEN
    assert prof["meta"]["device"] == CPU
    assert autotune.load_serving_knobs(path) == result["winner"]["knobs"]
    # the reference reads the port's knob profile
    assert rautotune.load_serving_profile(path)["knobs"] == prof["knobs"]


def test_serving_profile_staleness_guard(tmp_path, builtin_tables):
    result = autotune.autotune(tiny_trace(), smoke=True, rounds=1,
                               verbose=False, device=CPU)
    path = autotune.save_serving_profile(result,
                                         path=str(tmp_path / "knobs.json"))
    prof = autotune.load_serving_profile(path)
    assert not autotune.serving_knobs_stale(prof)
    tuning.activate(perturbed(scale=2.0))
    assert autotune.serving_knobs_stale(autotune.load_serving_profile(path))
    with pytest.raises(autotune.ServingProfileError, match="retune"):
        autotune.load_serving_knobs(path)
    assert autotune.load_serving_knobs(path, allow_stale=True) \
        == prof["knobs"]
    d = json.loads(open(path).read())
    d["schema"] = 99
    (tmp_path / "bad.json").write_text(json.dumps(d))
    with pytest.raises(autotune.ServingProfileError, match="schema"):
        autotune.load_serving_profile(str(tmp_path / "bad.json"))
    (tmp_path / "other.json").write_text(json.dumps({"kind": "x"}))
    with pytest.raises(autotune.ServingProfileError):
        autotune.load_serving_profile(str(tmp_path / "other.json"))


def test_committed_default_serving_profile_loads_fresh(builtin_tables):
    prof = autotune.load_serving_profile(
        directory=str(REPO / "results" / "profiles"), device=CPU)
    assert os.path.basename(prof["path"]) == "serving_default.json"
    assert not autotune.serving_knobs_stale(prof)
    assert autotune.load_serving_knobs(prof["path"]) == prof["knobs"]


# ---------------------------------------------------------------------------
# the committed H100 profiles
# ---------------------------------------------------------------------------


def h100_paths():
    d = REPO / "results" / "profiles"
    return d / f"{H100_KEY}.json", d / f"serving_{H100_KEY}.json"


def test_committed_h100_profile_loads_and_validates():
    path, _ = h100_paths()
    p = tuning.CalibrationProfile.load(str(path))
    assert tuning.profile_key(p.backend) == H100_KEY
    assert p.backend["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert set(p.residuals) == {"row", "tile"}
    assert all(math.isfinite(v) for v in p.residuals.values())
    assert p.meta["fitted_families"] == ["row", "tile"]
    assert p.meta["card"].startswith("NVIDIA H100 80GB HBM3, ")
    assert p.meta["card"].endswith(" W") and not p.meta["smoke"]
    assert p.dist_cost == BUILTIN.dist_cost
    assert rprofile.CalibrationProfile.load(str(path)).version == p.version
    assert tuning.lookup(p.backend)[0] == p
    assert p.fingerprint() != BUILTIN.fingerprint()


def test_committed_h100_serving_knobs_follow_the_h100_profile(
        builtin_tables):
    path, serving_path = h100_paths()
    p = tuning.CalibrationProfile.load(str(path))
    prof = autotune.load_serving_profile(str(serving_path))
    assert prof["backend"] == p.backend
    assert prof["meta"]["card"] == p.meta["card"]
    assert prof["trace"]["name"] == "golden_v1"
    assert prof["knobs"] in autotune.knob_grid(False)
    assert autotune.serving_knobs_stale(prof)        # builtin tables
    tuning.activate(p)
    assert prof["cost_model_token"] == planner.cost_model_token()
    assert autotune.load_serving_knobs(str(serving_path)) == prof["knobs"]
