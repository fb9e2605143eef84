"""Port parity: the tile route's host prep, built on the device.

``bcsr_from_csr``, ``padded_from_csr``, the tile route's one-pass value and
pattern blocks, the mask's structure-only blocks and ``gather_mask_aligned``
run as torch ops on the requested device (here the CPU).  Each must give
the reference's arrays bit for bit (``array_equal``) on the same seeded
numpy input: edge blocks (shapes that the block size does not divide),
empty rows, an empty matrix, rows stored out of column order, explicitly
stored zeros and a truncated mask width.
"""
import importlib

import numpy as np
import pytest
import jax.numpy as jnp

from repro.core import formats as rf
from repro.core.masked_spgemm import gather_mask_aligned as ref_gather
from repro.core.masked_spgemm import masked_spgemm as ref_masked_spgemm
from repro_torch.core import formats as tf
from repro_torch.kernels.masked_matmul import ops

# the module (the package exports its function under the same name)
ms = importlib.import_module("repro_torch.core.masked_spgemm")


def as_port(x):
    return tf.CSR(x.indptr.copy(), x.indices.copy(), x.data.copy(), x.shape)


def sparse(seed, m, n, density=0.3, empty_rows=True, zeros=True):
    """A CSR with integer values, every third row empty and some entries
    stored as an explicit 0.0."""
    rng = np.random.default_rng(seed)
    a = ((rng.random((m, n)) < density)
         * rng.integers(1, 5, (m, n))).astype(np.float32)
    if empty_rows:
        a[::3] = 0.0
    c = rf.csr_from_dense(a)
    if zeros:
        c.data[::5] = 0.0
    return c


def unsorted(c, seed):
    """The same matrix with every row's entries stored in a shuffled
    order."""
    rng = np.random.default_rng(seed)
    order = np.concatenate([
        c.indptr[i] + rng.permutation(c.indptr[i + 1] - c.indptr[i])
        for i in range(c.shape[0])]).astype(np.int64)
    return type(c)(c.indptr.copy(), c.indices[order], c.data[order], c.shape)


SHAPES = [((16, 16), 4), ((13, 21), 4), ((30, 17), 8), ((70, 45), 32),
          ((5, 40), 8), ((64, 64), 32)]


def assert_same_structure(got, want):
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.indptr.dtype == want.indptr.dtype == np.int64
    assert got.indices.dtype == want.indices.dtype == np.int64
    assert got.shape == want.shape and got.block_size == want.block_size


@pytest.mark.parametrize("shape,bs", SHAPES)
def test_values_and_pattern_from_one_key_pass(shape, bs):
    c = sparse(shape[0] * 100 + bs, *shape)
    got, pattern = tf._bcsr_with_pattern(tf._upload(as_port(c), "cpu"), bs)
    want = rf.bcsr_from_csr(c, bs)
    ones = rf.CSR(c.indptr, c.indices, np.ones(c.nnz, np.float32), c.shape)
    want_pattern = np.asarray(rf.bcsr_from_csr(ones, bs).blocks)
    assert_same_structure(got, want)
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(want.blocks))
    assert got.blocks.dtype.itemsize == 4
    assert str(pattern.dtype) == "torch.bfloat16"
    # a stored 0.0 is a 1 in the pattern, a padded position a 0
    np.testing.assert_array_equal(pattern.float().numpy(), want_pattern)


@pytest.mark.parametrize("shape,bs", SHAPES)
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_bcsr_from_csr_on_the_device_path(shape, bs, dtype):
    import torch
    c = sparse(shape[1] * 7 + bs, *shape)
    tdt = None if dtype is None else getattr(torch, dtype)
    got = tf.bcsr_from_csr(as_port(c), bs, dtype=tdt, device="cpu")
    want = rf.bcsr_from_csr(c, bs)
    assert_same_structure(got, want)
    want_blocks = torch.as_tensor(np.array(want.blocks))
    if tdt is not None:
        want_blocks = want_blocks.to(tdt)
    assert got.blocks.dtype == want_blocks.dtype
    assert torch.equal(got.blocks, want_blocks)


@pytest.mark.parametrize("shape,bs", SHAPES)
def test_mask_structure_only(shape, bs):
    c = sparse(shape[0] + bs, *shape, density=0.5, zeros=False)
    d = tf._upload(as_port(c), "cpu", data=False)
    assert d.data is None
    rows = d.rows()
    np.testing.assert_array_equal(rows.numpy(), rf._expand_rows(c.indptr))
    got, pos = tf._bcsr_structure(d, rows, bs)
    want = rf.bcsr_from_csr(c, bs)
    assert_same_structure(got, want)
    assert got.blocks is None and got.nnzb == want.nnzb
    with pytest.raises(ValueError, match="structure-only"):
        got.to_dense()
    # every entry's block position is the reference's block search
    mr = rf._expand_rows(c.indptr)
    np.testing.assert_array_equal(
        pos.numpy(), rf.bcsr_block_positions(want, mr // bs, c.indices // bs))


@pytest.mark.parametrize("width", [None, 1, 3, 40])
@pytest.mark.parametrize("shuffle", [False, True], ids=["sorted", "unsorted"])
def test_padded_from_csr_on_the_device_path(width, shuffle):
    c = sparse(21, 19, 25, density=0.35)
    if shuffle:
        c = unsorted(c, 5)
        assert any(np.any(np.diff(c.indices[c.indptr[i]:c.indptr[i + 1]]) < 0)
                   for i in range(c.shape[0]))
    want = rf.padded_from_csr(c, width)
    got = tf.padded_from_csr(as_port(c), width, device="cpu")
    assert got.shape == want.shape and got.width == want.width
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
    np.testing.assert_array_equal(got.lens.numpy(), np.asarray(want.lens))
    assert got.cols.dtype.itemsize == 4 and got.lens.dtype.itemsize == 4


def test_padded_from_csr_keeps_the_reference_rounding():
    """float64 values round to f32 first, then to the requested dtype, as
    the reference's host array does."""
    import torch
    c = sparse(3, 12, 10)
    rng = np.random.default_rng(0)
    c = rf.CSR(c.indptr, c.indices, rng.standard_normal(c.nnz), c.shape)
    want = rf.padded_from_csr(c, None, dtype=jnp.bfloat16)
    got = tf.padded_from_csr(as_port(c), None, dtype=torch.bfloat16,
                             device="cpu")
    np.testing.assert_array_equal(got.vals.float().numpy(),
                                  np.asarray(want.vals, np.float32))


def test_empty_matrix():
    c = rf.csr_from_dense(np.zeros((12, 9), np.float32))
    p = as_port(c)
    got = tf.bcsr_from_csr(p, 4, device="cpu")
    want = rf.bcsr_from_csr(c, 4)
    assert_same_structure(got, want)
    assert tuple(got.blocks.shape) == (0, 4, 4)
    vals_pat = tf._bcsr_with_pattern(tf._upload(p, "cpu"), 4)
    assert_same_structure(vals_pat[0], want)
    assert tuple(vals_pat[1].shape) == (0, 4, 4)
    d = tf._upload(p, "cpu", data=False)
    s, pos = tf._bcsr_structure(d, d.rows(), 4)
    assert_same_structure(s, want)
    assert pos.numel() == 0
    for width in (None, 2):
        want_p = rf.padded_from_csr(c, width)
        got_p = tf.padded_from_csr(p, width, device="cpu")
        np.testing.assert_array_equal(got_p.cols.numpy(),
                                      np.asarray(want_p.cols))
        np.testing.assert_array_equal(got_p.vals.numpy(),
                                      np.asarray(want_p.vals))
        np.testing.assert_array_equal(got_p.lens.numpy(),
                                      np.asarray(want_p.lens))


def gather_case(seed, shape, bs, shuffle):
    """A mask, its reference block structure and random value and count
    blocks laid out in that structure."""
    m = sparse(seed, *shape, density=0.5, zeros=False)
    if shuffle:
        m = unsorted(m, seed)
    mb = rf.bcsr_from_csr(m, bs)
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((mb.nnzb, bs, bs)).astype(np.float32)
    s = (rng.integers(0, 3, (mb.nnzb, bs, bs))).astype(np.float32)
    return m, mb, c, s


@pytest.mark.parametrize("shape,bs", [((30, 17), 8), ((70, 45), 32),
                                      ((16, 16), 4)])
@pytest.mark.parametrize("wm", [None, 2])
@pytest.mark.parametrize("shuffle", [False, True], ids=["sorted", "unsorted"])
def test_gather_mask_aligned_matches(shape, bs, wm, shuffle):
    import torch
    m, mb, c, s = gather_case(shape[0] + bs, shape, bs, shuffle)
    want = ref_gather(m, mb, jnp.asarray(c), jnp.asarray(s), n=shape[1],
                      wm=wm)
    mb_port = tf.BCSR(mb.indptr, mb.indices, torch.as_tensor(c), mb.shape,
                      bs)
    cb, sb = torch.as_tensor(c), torch.as_tensor(s)
    got = ms.gather_mask_aligned(as_port(m), mb_port, cb, sb, n=shape[1],
                                 wm=wm)
    # the tile route's form: block positions from M's own key pass
    d = tf._upload(as_port(m), "cpu", data=False)
    rows = d.rows()
    _, pos = tf._bcsr_structure(d, rows, bs)
    width = tf._pad_width(as_port(m), wm)
    also = ms._gather(d, rows, pos, cb, sb, bs=bs, n=shape[1], width=width)
    for res in (got, also):
        np.testing.assert_array_equal(res.vals.numpy(), np.asarray(want.vals))
        np.testing.assert_array_equal(res.present.numpy(),
                                      np.asarray(want.present))
        np.testing.assert_array_equal(res.mask_cols.numpy(),
                                      np.asarray(want.mask_cols))
        assert res.vals.shape == tuple(np.asarray(want.vals).shape)


@pytest.mark.parametrize("bs", [4, 8, 32])
def test_tile_route_edge_blocks_and_empty_rows(bs):
    """Shapes that the block size does not divide, empty rows, stored
    zeros: the whole tile call equals the reference's."""
    a = sparse(bs + 1, 45, 38, density=0.4)
    b = sparse(bs + 2, 38, 51, density=0.4)
    m = sparse(bs + 3, 45, 51, density=0.5, zeros=False)
    want = ref_masked_spgemm(a, b, m, algorithm="tile", tile_block=bs)
    got = ms.masked_spgemm(as_port(a), as_port(b), as_port(m),
                           algorithm="tile", tile_block=bs, device="cpu")
    for g, w in ((got.vals, want.vals), (got.present, want.present),
                 (got.mask_cols, want.mask_cols)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


class NoValues:
    """Stands in for a mask's ``data``: any read of it fails the test."""

    def __array__(self, *args, **kwargs):
        raise AssertionError("the tile route read the mask's values")

    def __getattr__(self, name):
        raise AssertionError(f"the tile route read the mask's values "
                             f"({name})")


def test_tile_route_never_reads_mask_values(monkeypatch):
    a, b = sparse(1, 40, 40, 0.4), sparse(2, 40, 40, 0.4)
    m = sparse(3, 40, 40, density=0.5, zeros=False)
    want = ref_masked_spgemm(a, b, m, algorithm="tile", tile_block=8)
    seen = []
    real = ops.block_spgemm_with_structure

    def spy(A, B, M, **kw):
        seen.append(M.blocks)
        return real(A, B, M, **kw)

    monkeypatch.setattr(ops, "block_spgemm_with_structure", spy)
    mp = as_port(m)
    mp.data = NoValues()
    got = ms.masked_spgemm(as_port(a), as_port(b), mp, algorithm="tile",
                           tile_block=8, device="cpu")
    assert seen == [None]           # the mask's blocks are structure only
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
    np.testing.assert_array_equal(got.present.numpy(),
                                  np.asarray(want.present))


def test_tile_route_uploads_each_csr_once(monkeypatch):
    a, b = sparse(4, 32, 32, 0.4), sparse(5, 32, 32, 0.4)
    m = sparse(6, 32, 32, density=0.5, zeros=False)
    calls = []
    real = tf._upload

    def counted(x, device, data=True):
        calls.append((x.shape, x.nnz, data))
        return real(x, device, data)

    monkeypatch.setattr(ms, "_upload", counted)
    ms.masked_spgemm(as_port(a), as_port(b), as_port(m), algorithm="tile",
                     tile_block=8, device="cpu")
    assert calls == [(a.shape, a.nnz, True), (b.shape, b.nnz, True),
                     (m.shape, m.nnz, False)]
