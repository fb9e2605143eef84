"""Port parity for the graph applications on the masked product: k-truss
and betweenness centrality against the reference package and networkx
(the reference's own ground truth, ``tests/test_graphs.py``), on the CPU.

Tolerances: equal edge sets for k-truss; 1e-5 (rtol and atol) for
betweenness against the reference, and networkx's 1e-3 as the reference
uses it.
"""
import networkx as nx
import numpy as np
import pytest

from repro.core import formats as rf
from repro.graphs import betweenness_centrality as ref_bc
from repro.graphs import ktruss as ref_ktruss
from repro.serving import QueryEngine as RefQueryEngine
from repro_torch.convert import csr_from_reference
from repro_torch.core.formats import CSR, csr_from_dense, rmat
from repro_torch.graphs import bc_teps, betweenness_centrality, ktruss
from repro_torch.serving import QueryEngine

CPU = "cpu"


def nx_to_csr(g: nx.Graph) -> CSR:
    n = g.number_of_nodes()
    a = np.zeros((n, n), np.float32)
    for u, v in g.edges():
        a[u, v] = a[v, u] = 1.0
    return csr_from_dense(a)


def ref(x: CSR) -> rf.CSR:
    return rf.CSR(x.indptr, x.indices, x.data, x.shape)


def random_graph(seed, n=40, p=0.15) -> nx.Graph:
    return nx.gnp_random_graph(n, p, seed=seed)


def edge_set(adj) -> set:
    d = np.asarray(adj.to_dense())
    return {(int(i), int(j)) for i, j in zip(*np.nonzero(d)) if i < j}


@pytest.mark.parametrize("k", [3, 4, 5])
def test_ktruss_matches_networkx_and_reference(k):
    g = random_graph(4, n=30, p=0.25)
    adj = nx_to_csr(g)
    truss, secs, iters, flops = ktruss(adj, k, device=CPU)
    want = {(min(u, v), max(u, v)) for u, v in nx.k_truss(g, k).edges()}
    assert edge_set(truss) == want
    r_truss, _, r_iters, r_flops = ref_ktruss(ref(adj), k)
    assert edge_set(truss) == edge_set(r_truss)
    assert (iters, flops) == (r_iters, r_flops)
    assert secs >= 0.0


@pytest.mark.parametrize("algorithm", ["msa", "mca", "inner"])
def test_ktruss_on_rmat_matches_reference(algorithm):
    g = rmat(8, 8, seed=3)
    truss, _, iters, _ = ktruss(g, 5, algorithm=algorithm, device=CPU)
    r_truss, _, r_iters, _ = ref_ktruss(ref(g), 5, algorithm=algorithm)
    assert edge_set(truss) == edge_set(r_truss)
    assert iters == r_iters
    # every kept edge has support >= k - 2 inside the truss
    d = truss.to_dense()
    support = (d @ d) * d
    assert (support[d != 0] >= 3).all()


def test_ktruss_two_phase_and_empty():
    g = random_graph(2, n=24, p=0.2)
    adj = nx_to_csr(g)
    a1, _, _, _ = ktruss(adj, 4, device=CPU)
    a2, _, _, _ = ktruss(adj, 4, two_phase=True, device=CPU)
    assert edge_set(a1) == edge_set(a2)
    empty = csr_from_dense(np.zeros((8, 8), np.float32))
    assert ktruss(empty, 3, device=CPU)[2] == 0


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("algorithm", ["msa", "heap"])
def test_betweenness_all_sources(seed, algorithm):
    g = random_graph(seed, n=25, p=0.2)
    adj = nx_to_csr(g)
    bc, _, calls = betweenness_centrality(adj, algorithm=algorithm,
                                          device=CPU)
    want = nx.betweenness_centrality(g, normalized=False)
    for v in want:
        assert abs(bc[v] - want[v]) < 1e-3, (v, bc[v], want[v])
    assert calls > 0


@pytest.mark.parametrize("algorithm", ["msa", "heap"])
def test_betweenness_matches_reference(algorithm):
    adj = nx_to_csr(random_graph(5, n=25, p=0.2))
    bc, _, calls = betweenness_centrality(adj, algorithm=algorithm,
                                          device=CPU)
    r_bc, _, r_calls = ref_bc(ref(adj), algorithm=algorithm)
    np.testing.assert_allclose(bc, r_bc, rtol=1e-5, atol=1e-5)
    assert calls == r_calls > 0


def test_betweenness_subset_sources():
    g = random_graph(7, n=20, p=0.25)
    srcs = [0, 3, 5]
    bc, _, _ = betweenness_centrality(nx_to_csr(g), sources=srcs,
                                      device=CPU)
    want = nx.betweenness_centrality_subset(g, sources=srcs,
                                            targets=list(g.nodes()),
                                            normalized=False)
    for v in want:
        assert abs(bc[v] - want[v]) < 1e-3, (v, bc[v], want[v])


@pytest.mark.parametrize("algorithm", ["mca", "hash", "inner"])
def test_betweenness_complement_incapable_algorithms(algorithm):
    g = random_graph(6, n=25, p=0.2)
    adj = nx_to_csr(g)
    bc, _, calls = betweenness_centrality(adj, algorithm=algorithm,
                                          device=CPU)
    want = nx.betweenness_centrality(g, normalized=False)
    for v in want:
        assert abs(bc[v] - want[v]) < 1e-3, (v, bc[v], want[v])
    assert calls > 0
    np.testing.assert_allclose(bc, ref_bc(ref(adj), algorithm=algorithm)[0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunks", [3])
def test_betweenness_chunked_sources_matches_unchunked(chunks):
    g = random_graph(9, n=22, p=0.25)
    a = nx_to_csr(g)
    srcs = [0, 2, 4, 7, 11]
    want, _, _ = betweenness_centrality(a, sources=srcs, algorithm="msa",
                                        device=CPU)
    got, _, calls = betweenness_centrality(a, sources=srcs, algorithm="msa",
                                           source_chunks=chunks, device=CPU)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    r_got, _, r_calls = ref_bc(ref(a), sources=srcs, algorithm="msa",
                               source_chunks=chunks)
    np.testing.assert_allclose(got, r_got, rtol=1e-5, atol=1e-5)
    assert calls == r_calls > 0


def test_betweenness_rmat_chunked_auto_matches_reference():
    g = csr_from_reference(rf.rmat(7, 8, seed=12))
    got, _, calls = betweenness_centrality(g, sources=range(16),
                                           source_chunks=4, device=CPU)
    want, _, r_calls = ref_bc(ref(g), sources=range(16), source_chunks=4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert calls == r_calls


def test_betweenness_engine_client_matches_reference_client():
    g = nx_to_csr(random_graph(11, n=30, p=0.15))
    with QueryEngine(max_batch=16, device=CPU) as eng:
        got, _, calls = betweenness_centrality(g, sources=range(10),
                                               source_chunks=2, engine=eng)
    with RefQueryEngine(max_batch=16) as ref_eng:
        want, _, r_calls = ref_bc(ref(g), sources=range(10),
                                  source_chunks=2, engine=ref_eng)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert calls == r_calls
    with QueryEngine(device=CPU) as eng:
        one, _, _ = betweenness_centrality(g, sources=range(10), engine=eng)
    np.testing.assert_allclose(one, want, rtol=1e-5, atol=1e-5)


def test_betweenness_rejects_two_phase_batched():
    g = nx_to_csr(random_graph(1, n=10, p=0.3))
    with pytest.raises(ValueError):
        betweenness_centrality(g, two_phase=True, source_chunks=2,
                               device=CPU)
    with QueryEngine(device=CPU) as eng:
        with pytest.raises(ValueError):
            betweenness_centrality(g, two_phase=True, engine=eng)
    assert bc_teps(g, 2.0, 4) == 4 * g.nnz / 2.0
