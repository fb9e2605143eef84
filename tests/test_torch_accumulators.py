"""Port parity: the six batched row accumulators of repro_torch against the
reference's vmapped row kernels, through ``masked_spgemm(algorithm=X)``.

Tolerances: msa, hash and mca keep the reference's per-slot fold (zero,
then one fused multiply-add per k in ascending order), so they are
array_equal on float data; heap (segmented scan) and inner (pairwise
tree) sum in other orders than the reference (``associative_scan``,
``lax.reduce``), so they get rtol = atol = 1e-5 on float data.  On small
integer data every order is exact, so everything is array_equal.
"""
import numpy as np
import pytest

from repro.core.formats import csr_from_dense as ref_csr
from repro.core.masked_spgemm import masked_spgemm as ref_masked_spgemm
from repro.core.masked_spgemm import symbolic_phase as ref_symbolic_phase
from repro.core.formats import padded_from_csr as ref_padded
from repro.core.semiring import REGISTRY as REF_SR
from repro_torch.core.accumulators import SUPPORTS_COMPLEMENT
from repro_torch.core.formats import CSR, padded_from_csr
from repro_torch.core.masked_spgemm import ALGORITHMS, masked_spgemm, \
    symbolic_phase
from repro_torch.core.semiring import REGISTRY as SR
from repro_torch.kernels.masked_matmul import ops

EXACT = {"msa", "hash", "mca"}
M_, K_, N_ = 24, 20, 28


def port(x):
    return CSR(x.indptr.copy(), x.indices.copy(), x.data.copy(), x.shape)


def operands(seed, ints=False):
    """(reference CSRs, port CSRs): A (24x20), B (20x28), M (24x28) with
    empty rows; ``ints`` puts small integers on the same structure."""
    rng = np.random.default_rng(seed)
    out = []
    for (m, n, d) in ((M_, K_, 0.3), (K_, N_, 0.3), (M_, N_, 0.4)):
        s = rng.random((m, n)) < d
        s[::5] = False
        v = (rng.integers(1, 5, (m, n)) if ints
             else rng.uniform(0.5, 1.5, (m, n)))
        out.append(ref_csr((s * v).astype(np.float32)))
    return out, [port(x) for x in out]


def unpack(res, complement):
    if complement:
        return [np.asarray(x) for x in res]
    return [np.asarray(res.vals), np.asarray(res.present),
            np.asarray(res.mask_cols)]


def unpack_port(res, complement):
    if complement:
        return [x.numpy() for x in res]
    return [res.vals.numpy(), res.present.numpy(), res.mask_cols.numpy()]


def assert_matches(got, want, exact):
    np.testing.assert_array_equal(got[1], want[1])            # present
    if len(got) > 2:
        np.testing.assert_array_equal(got[2], want[2])        # mask cols
    if exact:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)


CASES = [(alg, sr, comp) for alg in ALGORITHMS for sr in SR
         for comp in (False, True)
         if not comp or alg in SUPPORTS_COMPLEMENT]


@pytest.mark.parametrize("alg,sr,complement", CASES)
def test_row_algorithm_matches_reference(alg, sr, complement):
    (A, B, M), (At, Bt, Mt) = operands(0)
    want = ref_masked_spgemm(A, B, M, algorithm=alg, semiring=REF_SR[sr],
                             complement=complement)
    got = masked_spgemm(At, Bt, Mt, algorithm=alg, semiring=SR[sr],
                        complement=complement, device="cpu")
    assert_matches(unpack_port(got, complement), unpack(want, complement),
                   exact=alg in EXACT)


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_row_algorithm_exact_on_integers(alg):
    (A, B, M), (At, Bt, Mt) = operands(0, ints=True)
    want = ref_masked_spgemm(A, B, M, algorithm=alg)
    got = masked_spgemm(At, Bt, Mt, algorithm=alg, device="cpu")
    assert_matches(unpack_port(got, False), unpack(want, False), exact=True)


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_truncated_widths_match(alg):
    """Explicit pad widths below the true row widths drop the same
    entries in both packages."""
    (A, B, M), (At, Bt, Mt) = operands(1, ints=True)
    widths = (3, 4, 5)
    want = ref_masked_spgemm(A, B, M, algorithm=alg, widths=widths)
    got = masked_spgemm(At, Bt, Mt, algorithm=alg, widths=widths,
                        device="cpu")
    assert_matches(unpack_port(got, False), unpack(want, False), exact=True)


@pytest.mark.parametrize("alg", ["msa", "hash", "heap", "inner"])
def test_row_chunks_do_not_change_results(alg, monkeypatch):
    """A tiny batch budget splits the rows into many chunks; rows are
    independent, so the results are identical."""
    (_, _, _), (At, Bt, Mt) = operands(2)
    whole = masked_spgemm(At, Bt, Mt, algorithm=alg, device="cpu")
    monkeypatch.setattr(ops, "_XLA_CHUNK_ELEMS", 64)
    chunked = masked_spgemm(At, Bt, Mt, algorithm=alg, device="cpu")
    for g, w in zip(unpack_port(chunked, False), unpack_port(whole, False)):
        np.testing.assert_array_equal(g, w)


def test_two_phase_symbolic_counts_match():
    (A, B, M), (At, Bt, Mt) = operands(3)
    want = ref_symbolic_phase(ref_padded(A), ref_padded(M), ref_padded(B),
                              shape=(M_, N_), kdim=K_)
    got = symbolic_phase(padded_from_csr(At, device="cpu"),
                         padded_from_csr(Mt, device="cpu"),
                         padded_from_csr(Bt, device="cpu"),
                         shape=(M_, N_), kdim=K_)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the count equals the structural output nnz of every row algorithm
    res = masked_spgemm(At, Bt, Mt, algorithm="mca", two_phase=True,
                        device="cpu")
    np.testing.assert_array_equal(res.present.numpy().sum(1), got.numpy())


@pytest.mark.parametrize("alg", ["inner", "heapdot"])
def test_two_phase_result_matches(alg):
    (A, B, M), (At, Bt, Mt) = operands(4, ints=True)
    want = ref_masked_spgemm(A, B, M, algorithm=alg, two_phase=True)
    got = masked_spgemm(At, Bt, Mt, algorithm=alg, two_phase=True,
                        device="cpu")
    assert_matches(unpack_port(got, False), unpack(want, False), exact=True)


@pytest.mark.parametrize("alg", ["hash", "mca", "inner"])
def test_complement_unsupported_raises(alg):
    (A, B, M), (At, Bt, Mt) = operands(5)
    with pytest.raises(NotImplementedError):
        ref_masked_spgemm(A, B, M, algorithm=alg, complement=True)
    with pytest.raises(NotImplementedError):
        masked_spgemm(At, Bt, Mt, algorithm=alg, complement=True,
                      device="cpu")


def test_invalid_requests_raise():
    (_, _, _), (At, Bt, Mt) = operands(6)
    with pytest.raises(NotImplementedError):
        masked_spgemm(At, Bt, Mt, algorithm="tile", two_phase=True,
                      device="cpu")
    with pytest.raises(NotImplementedError):
        masked_spgemm(At, Bt, Mt, algorithm="tile", semiring=SR["min_plus"],
                      device="cpu")
    with pytest.raises(ValueError):
        masked_spgemm(At, Bt, Mt, algorithm="bogus", device="cpu")


def test_hash_probe_matches_scalar_linear_probing():
    """The batched probe equals one-key-at-a-time linear probing with the
    reference's multiplicative hash, at a load high enough to wrap around
    the table."""
    import torch
    from repro_torch.core.accumulators import _probe
    T = 16
    rng = np.random.default_rng(7)
    for _ in range(5):
        cols = rng.choice(1000, size=12, replace=False)
        table = [-1] * T
        for c in cols:                    # scalar reference inserts
            s = (int(c) * 2654435761 % 2 ** 32) & (T - 1)
            while table[s] not in (-1, c):
                s = (s + 1) & (T - 1)
            table[s] = int(c)
        keys = torch.full((1, T), -1, dtype=torch.int64)
        for c in cols:                    # batched probe, same order
            q = torch.tensor([[int(c)]])
            s, _ = _probe(keys, q, T)
            keys.scatter_(1, s, q)
        assert keys[0].tolist() == table
        queries = torch.as_tensor(np.concatenate(
            [cols, rng.integers(1000, 2000, 6)]))[None]
        slots, found = _probe(keys, queries, T)
        assert found[0].tolist() == [True] * 12 + [False] * 6
        assert [table[s] for s in slots[0, :12].tolist()] == cols.tolist()
        assert all(table[s] == -1 for s in slots[0, 12:].tolist())
