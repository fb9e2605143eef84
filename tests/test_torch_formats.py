"""Port parity: repro_torch.core.formats against repro.core.formats.

The generators must draw identical arrays from one seed, and every
converter must give the reference's structures and blocks exactly
(array_equal), including empty rows and shapes that do not divide the
block size.
"""
import numpy as np
import pytest

from repro.core import formats as rf
from repro_torch.core import formats as tf


def as_port(x):
    return tf.CSR(x.indptr.copy(), x.indices.copy(), x.data.copy(), x.shape)


def assert_csr_equal(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.dtype == want.data.dtype


def int_sparse(rng, m, n, density):
    return ((rng.random((m, n)) < density)
            * rng.integers(1, 5, (m, n))).astype(np.float32)


def with_empty_rows(rng, m, n, density):
    a = int_sparse(rng, m, n, density)
    a[::3] = 0.0          # every third row empty
    return a


@pytest.mark.parametrize("make", [
    lambda f: f.erdos_renyi(200, 6.0, seed=3),
    lambda f: f.erdos_renyi(150, 4.0, seed=4, values="ones"),
    lambda f: f.rmat(9, 8, seed=5),
    lambda f: f.rmat(8, 4, seed=6, symmetric=False, remove_self_loops=False),
    lambda f: f.er_mask(120, 5.0, seed=7),
    lambda f: f.tril(f.rmat(8, 8, seed=8)),
    lambda f: f.tril(f.erdos_renyi(100, 5.0, seed=9), strict=False),
], ids=["er", "er_ones", "rmat", "rmat_directed", "er_mask", "tril",
        "tril_nonstrict"])
def test_generators_identical(make):
    assert_csr_equal(make(tf), make(rf))


@pytest.mark.parametrize("mask", [False, True])
def test_block_sparse_identical(mask):
    np.testing.assert_array_equal(
        tf.block_sparse(64, 8, 0.3, 0.7, seed=11, mask=mask),
        rf.block_sparse(64, 8, 0.3, 0.7, seed=11, mask=mask))


def test_csr_constructors_and_transpose():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 20, 300)
    cols = rng.integers(0, 30, 300)
    vals = rng.uniform(0.5, 1.5, 300).astype(np.float32)
    for sum_dups in (True, False):
        got = tf.csr_from_coo(rows, cols, vals, (20, 30), sum_dups=sum_dups)
        want = rf.csr_from_coo(rows, cols, vals, (20, 30), sum_dups=sum_dups)
        assert_csr_equal(got, want)
    a = with_empty_rows(rng, 17, 23, 0.3)
    got, want = tf.csr_from_dense(a), rf.csr_from_dense(a)
    assert_csr_equal(got, want)
    assert_csr_equal(got.transpose(), want.transpose())
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())


@pytest.mark.parametrize("width", [None, 2, 9])
def test_padded_from_csr_matches(width):
    rng = np.random.default_rng(1)
    a = with_empty_rows(rng, 19, 25, 0.35)
    want = rf.padded_from_csr(rf.csr_from_dense(a), width)
    got = tf.padded_from_csr(as_port(rf.csr_from_dense(a)), width,
                             device="cpu")
    assert got.shape == want.shape and got.width == want.width
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
    np.testing.assert_array_equal(got.lens.numpy(), np.asarray(want.lens))
    assert got.cols.dtype.itemsize == 4 and got.lens.dtype.itemsize == 4
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))


@pytest.mark.parametrize("shape,bs", [((16, 16), 4), ((13, 21), 4),
                                      ((30, 17), 8), ((5, 40), 16)])
def test_bcsr_converters_match(shape, bs):
    rng = np.random.default_rng(shape[0] * 100 + bs)
    a = with_empty_rows(rng, *shape, 0.3)
    c = rf.csr_from_dense(a)
    want = rf.bcsr_from_csr(c, bs)
    got = tf.bcsr_from_csr(as_port(c), bs, device="cpu")
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(want.blocks))
    assert got.shape == want.shape and got.block_size == bs
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())

    dense_got = tf.bcsr_from_dense(a, bs, device="cpu")
    dense_want = rf.bcsr_from_dense(a, bs)
    np.testing.assert_array_equal(dense_got.indptr, dense_want.indptr)
    np.testing.assert_array_equal(dense_got.indices, dense_want.indices)
    np.testing.assert_array_equal(dense_got.blocks.numpy(),
                                  np.asarray(dense_want.blocks))

    for prune in (True, False):
        assert_csr_equal(tf.bcsr_to_csr(got, prune_zero=prune),
                         rf.bcsr_to_csr(want, prune_zero=prune))

    for g, w in zip(tf.bcsr_structure_transpose(got),
                    rf.bcsr_structure_transpose(want)):
        np.testing.assert_array_equal(g, w)

    bi = rng.integers(0, got.block_rows, 40)
    bj = rng.integers(0, got.block_cols, 40)
    np.testing.assert_array_equal(tf.bcsr_block_positions(got, bi, bj),
                                  rf.bcsr_block_positions(want, bi, bj))


def test_bcsr_of_empty_matrix():
    c = rf.csr_from_dense(np.zeros((12, 9), np.float32))
    want = rf.bcsr_from_csr(c, 4)
    got = tf.bcsr_from_csr(as_port(c), 4, device="cpu")
    assert got.nnzb == want.nnzb == 0
    np.testing.assert_array_equal(got.indptr, want.indptr)
    assert tuple(got.blocks.shape) == tuple(np.asarray(want.blocks).shape)
    np.testing.assert_array_equal(
        tf.bcsr_block_positions(got, np.array([0, 1]), np.array([0, 2])),
        rf.bcsr_block_positions(want, np.array([0, 1]), np.array([0, 2])))
