"""examples_torch/ on the CPU.

Each example runs in a child process with jax and the reference package
blocked (``chip_smoke.EXAMPLE_PRELUDE``, as phase 18 runs them on the
card) and ``--device cpu``: quickstart, graph_analytics, serve_lm and
``train_lm --tiny``.  Their deterministic results are held to the
reference's API on the same seeded inputs, computed here (exact for counts
and nnz, betweenness scores to 1e-5); the reference's example scripts
themselves are not run.  Without a card and without ``--device cpu``,
every example refuses to start.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from repro import obs as ref_obs
from repro.configs.base import get_config as ref_get_config
from repro.core import formats as rf
from repro.core.distributed import distributed_masked_spgemm
from repro.core.formats import CSR, CSRDelta
from repro.core.masked_spgemm import masked_spgemm
from repro.core.semiring import MIN_PLUS
from repro.graphs import betweenness_centrality, ktruss, triangle_count
from repro.kernels.masked_matmul.ops import block_spgemm
from repro.obs.health import HealthMonitor
from repro.serving import QueryEngine

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

#: the children share the CPU with the test run's other workers
CHILD_ENV = {"OMP_NUM_THREADS": "2"}
TIMEOUT = 600
ARGS = {"quickstart": (), "graph_analytics": (), "serve_lm": (),
        "train_lm": ("--tiny",)}
REFUSAL = ("--device cuda: no CUDA device is visible "
           "(pass --device cpu to run on the CPU)")


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every example on the CPU, and every example with no card visible
    and no ``--device``, all started at once; each test waits for its
    own."""
    ckpt = str(tmp_path_factory.mktemp("train_lm"))
    procs = {name: chip_smoke.start_example(
        name, "--device", "cpu", *args,
        *(("--ckpt-dir", ckpt) if name == "train_lm" else ()),
        env=CHILD_ENV) for name, args in ARGS.items()}
    for name in ARGS:
        procs["refuse " + name] = chip_smoke.start_example(
            name, env={**CHILD_ENV, "CUDA_VISIBLE_DEVICES": ""})
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def quickstart_operands():
    """The quickstart's A, B, M and the block entry point's mask, drawn
    in its order."""
    rng = np.random.default_rng(0)
    m, k, n = 64, 48, 56
    A = ((rng.random((m, k)) < 0.2) * rng.uniform(1, 2, (m, k))
         ).astype(np.float32)
    B = ((rng.random((k, n)) < 0.2) * rng.uniform(1, 2, (k, n))
         ).astype(np.float32)
    M = (rng.random((m, n)) < 0.3).astype(np.float32)
    Mb = (rng.random((64, 48)) < 0.3).astype(np.float32)
    return A, B, M, Mb


def fresh_values(x, seed):
    r = np.random.default_rng(seed)
    return CSR(x.indptr, x.indices,
               r.uniform(1, 2, x.nnz).astype(np.float32), x.shape)


def test_quickstart_matches_reference(children):
    A, B, M, Mb = quickstart_operands()
    A_c, B_c, M_c = (rf.csr_from_dense(x) for x in (A, B, M))
    want = {"auto": int(masked_spgemm(A_c, B_c, M_c).nnz)}
    for algo in ("msa", "hash", "mca", "heap", "heapdot", "inner"):
        want[algo] = int(masked_spgemm(A_c, B_c, M_c, algorithm=algo).nnz)
    want["min_plus"] = int(masked_spgemm(A_c, B_c, M_c, algorithm="msa",
                                         semiring=MIN_PLUS).nnz)
    _, present = masked_spgemm(A_c, B_c, M_c, algorithm="msa",
                               complement=True)
    want["complement"] = int(np.asarray(present).sum())
    want["tile"] = int(masked_spgemm(A_c, B_c, M_c, algorithm="tile",
                                     tile_block=8).nnz)
    want["block_spgemm tiles"] = block_spgemm(
        rf.bcsr_from_csr(rf.csr_from_dense(A[:, :48]), 8),
        rf.bcsr_from_csr(rf.csr_from_dense(B[:48, :48]), 8),
        rf.bcsr_from_csr(rf.csr_from_dense(Mb), 8)).nnzb
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    want["distributed"] = int(distributed_masked_spgemm(A_c, B_c, M_c,
                                                        mesh).nnz)
    want["sparse ring"] = int(distributed_masked_spgemm(
        A_c, B_c, M_c, mesh, algorithm="ring", block_size=8).nnz)
    g = rf.erdos_renyi(512, 8, seed=1)
    triangles, _ = triangle_count(g, algorithm="msa")

    with QueryEngine(max_batch=32) as engine:
        tickets = [engine.submit(fresh_values(A_c, s), B_c, M_c)
                   for s in range(8)]
        tri_ticket = engine.submit_triangle(g)
        engine.flush()
        want["served"] = int(tickets[0].result().nnz)
        served_triangles = tri_ticket.result()
        cache_hit = engine.submit(fresh_values(A_c, 0), B_c, M_c).done()
    want["async"] = int(masked_spgemm(A_c, B_c, M_c).nnz)

    with QueryEngine(max_batch=8) as engine:
        engine.submit(A_c, B_c, M_c)
        engine.flush()
        out = engine.submit_delta(A_c, B_c, M_c, delta_a=CSRDelta.upserts(
            [0, 3], [5, 7], [1.5, 0.25]))
        snap = engine.metrics.snapshot()
    delta = {k: snap[k] for k in ("delta_applied", "plans_revalidated",
                                  "lanes_patched", "rows_invalidated")}

    with ref_obs.tracing() as trc:
        with QueryEngine(max_batch=8) as engine:
            for s in range(4):
                engine.submit(fresh_values(A_c, s), B_c, M_c)
            engine.flush()
    span_names = sorted({r["name"] for r in trc.sink.spans()})

    monitor = HealthMonitor()
    with ref_obs.tracing(monitor):
        with QueryEngine(monitor=monitor) as engine:
            for s in range(4):
                engine.submit(fresh_values(A_c, s), B_c, M_c)
            engine.flush()
            healthy = engine.health().status
            storm = [engine.submit(A_c, B_c, M_c, algorithm="hash",
                                   complement=True) for _ in range(8)]
            engine.flush()
            for t in storm:
                with pytest.raises(NotImplementedError):
                    t.result()
            pressured = engine.health().status

    got = chip_smoke.example_result("quickstart", children["quickstart"],
                                    TIMEOUT)["results"]
    assert got["nnz"] == want
    assert (got["triangles"], got["served_triangles"]) == (
        triangles, served_triangles)
    assert got["cache_hit"] is cache_hit is True
    assert got["calibration_exact"] is False      # no profile keyed cpu
    assert got["delta"] == delta
    assert got["plan_survived"] is out.plan_survived
    assert got["span_names"] == span_names
    assert got["health"] == [healthy, pressured]
    assert healthy == "ok" and pressured != "ok"
    assert got["digests"][0] == got["digests"][1]
    assert got["lint_findings"] == 0


def test_graph_analytics_matches_reference(children):
    g = rf.rmat(9, 8, seed=7)
    triangles, _ = triangle_count(g, algorithm="msa")
    truss, _, iters, _ = ktruss(g, k=5, algorithm="msa")
    srcs = np.random.default_rng(0).choice(g.shape[0], 16, replace=False)
    bc, _, _ = betweenness_centrality(g, sources=srcs, algorithm="msa")
    bc = np.asarray(bc, dtype=np.float64)

    got = chip_smoke.example_result(
        "graph_analytics", children["graph_analytics"], TIMEOUT)["results"]
    assert got["triangles"] == triangles
    assert (got["ktruss_edges"], got["ktruss_iterations"]) == (
        truss.nnz // 2, iters)
    np.testing.assert_allclose(got["bc"], bc, rtol=1e-5, atol=1e-5)
    assert chip_smoke.same_top(got["bc"], list(bc))
    assert got["bc_top5"] == np.argsort(-np.asarray(got["bc"]))[:5].tolist()


def test_serve_lm_shapes_and_caches(children):
    report = chip_smoke.example_result("serve_lm", children["serve_lm"],
                                       TIMEOUT)
    archs = ("llama3_2_1b", "deepseek_v2_lite_16b", "zamba2_7b")
    assert report["results"]["shapes"] == {a: [4, 20] for a in archs}
    for arch in archs:
        cfg = ref_get_config(arch, smoke=True)
        kind = ("MLA low-rank cache" if cfg.mla else
                "SSM state" if cfg.family in ("ssm", "hybrid")
                else "GQA KV cache")
        assert f"{arch:24s} [{kind:18s}] generated (4, 20) in " in \
            report["stdout"]


def test_train_lm_tiny_learns(children):
    report = chip_smoke.example_result("train_lm", children["train_lm"],
                                       TIMEOUT)
    res = report["results"]
    assert res["steps"] == len(report["step_s"]) == 30
    assert res["last"] < res["first"] - 0.5
    assert "OK: model learned the synthetic stream" in report["stdout"]


@pytest.mark.parametrize("name", list(ARGS))
def test_example_refuses_without_a_card(children, name):
    code, out, err = chip_smoke.example_output(children["refuse " + name],
                                               TIMEOUT)
    assert code != 0
    assert REFUSAL in err
    assert '"results"' not in out
