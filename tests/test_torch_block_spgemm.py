"""Port parity: the masked block product (schedule, replay, structure
replay) of repro_torch against the reference's Pallas kernel (interpret
mode) and its XLA executor.

Tolerances: array_equal on small-integer data (every summation order is
exact); rtol = atol = 1e-4 on normal data, the reference's own tolerance
for block_spgemm.  The CUDA kernel itself runs only on a GPU: its tests are
in test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.formats import bcsr_from_dense as ref_bcsr_from_dense
from repro.kernels.masked_matmul import ops as ref_ops
from repro.kernels.masked_matmul.kernel import \
    block_spgemm_kernel as ref_block_spgemm_kernel
from repro.kernels.masked_matmul.ref import block_spgemm_ref as ref_oracle
from repro_torch.convert import bcsr_from_reference
from repro_torch.kernels.masked_matmul import kernel, ops
from repro_torch.kernels.masked_matmul.ref import block_spgemm_ref


def dense_operands(seed, m, k, n, dens, ints):
    rng = np.random.default_rng(seed)

    def one(r, c, d):
        s = rng.random((r, c)) < d
        v = (rng.integers(1, 5, (r, c)) if ints
             else rng.standard_normal((r, c)))
        return (s * v).astype(np.float32)

    return one(m, k, dens[0]), one(k, n, dens[1]), \
        (rng.random((m, n)) < dens[2]).astype(np.float32)


def both(a, b, mk, bs):
    ref = [ref_bcsr_from_dense(x, bs) for x in (a, b, mk)]
    return ref, [bcsr_from_reference(x, "cpu") for x in ref]


@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("dens", [(0.3, 0.3, 0.3), (0.1, 0.5, 0.2),
                                  (0.05, 0.05, 0.6)])
def test_schedule_matches_reference(bs, dens):
    a, b, mk = dense_operands(bs, 32, 24, 40, dens, ints=True)
    (A, B, M), (At, Bt, Mt) = both(a, b, mk, bs)
    for g, w in zip(ops.build_spgemm_schedule(At, Bt, Mt),
                    ref_ops.build_spgemm_schedule(A, B, M)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype == np.int32


@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("ints", [True, False])
@pytest.mark.parametrize("dens", [(0.3, 0.3, 0.3), (0.05, 0.05, 0.6)])
def test_block_spgemm_matches_reference(bs, ints, dens):
    """Sparse operands leave mask blocks without contribution: their
    zero-fill entries must come out as exact zero blocks."""
    a, b, mk = dense_operands(10 + bs, 32, 24, 32, dens, ints=ints)
    (A, B, M), (At, Bt, Mt) = both(a, b, mk, bs)
    schedule = ops.build_spgemm_schedule(At, Bt, Mt)
    got = ops.block_spgemm(At, Bt, Mt).blocks.numpy()
    pallas = np.asarray(ref_ops.block_spgemm(A, B, M, backend="pallas",
                                             interpret=True).blocks)
    xla = np.asarray(ref_ops.block_spgemm(A, B, M, backend="xla").blocks)
    mi = np.repeat(np.arange(Mt.block_rows), np.diff(Mt.indptr))
    oracle = block_spgemm_ref(a, b, mi, Mt.indices, bs=bs).numpy()
    np.testing.assert_array_equal(
        oracle, np.asarray(ref_oracle(jnp.asarray(a), jnp.asarray(b), mi,
                                      Mt.indices, bs=bs)))
    for want in (pallas, xla, oracle):
        if ints:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    zero_fill = schedule[0][(schedule[3] & 2) == 0]
    assert np.all(got[zero_fill] == 0.0)


@pytest.mark.parametrize("bs", [4, 8])
def test_block_spgemm_with_structure_matches_reference(bs):
    a, b, mk = dense_operands(20 + bs, 24, 32, 24, (0.3, 0.3, 0.4),
                              ints=True)
    (A, B, M), (At, Bt, Mt) = both(a, b, mk, bs)
    got_v, got_s = ops.block_spgemm_with_structure(At, Bt, Mt)
    want_v, want_s = ref_ops.block_spgemm_with_structure(
        A, B, M, backend="pallas", interpret=True)
    np.testing.assert_array_equal(got_v.blocks.numpy(),
                                  np.asarray(want_v.blocks))
    np.testing.assert_array_equal(got_s.blocks.numpy(),
                                  np.asarray(want_s.blocks))
    np.testing.assert_array_equal(got_v.indptr, want_v.indptr)
    np.testing.assert_array_equal(got_v.indices, want_v.indices)


@pytest.mark.parametrize("empty", ["a", "b", "mask"])
def test_empty_operands_match_reference(empty):
    a, b, mk = dense_operands(30, 16, 16, 16, (0.4, 0.4, 0.5), ints=True)
    if empty == "a":
        a[:] = 0
    elif empty == "b":
        b[:] = 0
    else:
        mk[:] = 0
    (A, B, M), (At, Bt, Mt) = both(a, b, mk, 4)
    got = ops.block_spgemm(At, Bt, Mt).blocks.numpy()
    want = np.asarray(ref_ops.block_spgemm(A, B, M, backend="xla").blocks)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if empty != "mask":
        assert got.shape[0] == Mt.nnzb and not got.any()


def padded_worklist(schedule, extra):
    """The schedule plus ``extra`` all-flags-off padding entries at the
    last rank (the distributed ring's padding), which must neither add
    nor write."""
    rank, pa, pb, flags = schedule
    r = np.full(extra, rank[-1], np.int32)
    z = np.zeros(extra, np.int32)
    return (np.concatenate([rank, r]), np.concatenate([pa, z]),
            np.concatenate([pb, z]), np.concatenate([flags, z]))


def test_flag_zero_padding_is_inert():
    a, b, mk = dense_operands(40, 24, 24, 24, (0.4, 0.4, 0.5), ints=True)
    (A, B, M), (At, Bt, Mt) = both(a, b, mk, 8)
    wl = padded_worklist(ops.build_spgemm_schedule(At, Bt, Mt), 5)
    got = kernel.block_spgemm_kernel(
        At.blocks, Bt.blocks, *(torch.as_tensor(x) for x in wl), Mt.nnzb)
    want = ref_block_spgemm_kernel(A.blocks, B.blocks,
                                   *(jnp.asarray(x) for x in wl), M.nnzb,
                                   bs=8, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  ops.block_spgemm(At, Bt, Mt).blocks.numpy())


def test_cpu_tensors_never_launch_the_kernel():
    before = kernel.LAUNCHES
    a, b, mk = dense_operands(50, 16, 16, 16, (0.4, 0.4, 0.5), ints=True)
    _, (At, Bt, Mt) = both(a, b, mk, 4)
    ops.block_spgemm_with_structure(At, Bt, Mt)
    assert kernel.LAUNCHES == before


def test_wrapper_rejects_bad_operands():
    blocks = torch.zeros((2, 4, 4))
    wl = [torch.zeros(3, dtype=torch.int32) for _ in range(4)]
    with pytest.raises(ValueError):
        kernel.block_spgemm_kernel(blocks.double(), blocks, *wl, 2)
    with pytest.raises(ValueError):
        kernel.block_spgemm_kernel(blocks, torch.zeros((2, 8, 8)), *wl, 2)
    with pytest.raises(ValueError):
        kernel.block_spgemm_kernel(blocks.transpose(1, 2), blocks, *wl, 2)
    with pytest.raises(ValueError):
        kernel.block_spgemm_kernel(blocks, blocks, wl[0].long(), *wl[1:], 2)
    with pytest.raises(ValueError):
        kernel.block_spgemm_kernel(blocks, blocks, *wl[:3],
                                   torch.zeros(2, dtype=torch.int32), 2)
    _, (At, Bt, Mt) = both(*dense_operands(60, 8, 8, 8, (0.5,) * 3, True), 4)
    rank, pa, pb, flags = ops.build_spgemm_schedule(At, Bt, Mt)
    with pytest.raises(ValueError):
        ops._run_schedule(Mt, (rank, pa + 100, pb, flags), At.blocks,
                          Bt.blocks)


def test_library_name_tracks_source_and_flags(monkeypatch):
    """An edited source or changed flags give a new library file, so a
    stale build is never loaded; the build lives under build/repro_torch."""
    from repro_torch.kernels import _build
    path = _build.library_path("block_spgemm")
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "repro_torch")
    assert path == _build.library_path("block_spgemm")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path("block_spgemm") != path


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("block_spgemm")


def stored_zero_case(bs, seed):
    """Reference operands with explicitly stored 0.0 entries in A and an
    empty block row in A (zero-fill entries), the stored-entry patterns of
    A and B, and the port's copies."""
    from repro.core.formats import CSR as RefCSR
    from repro.core.formats import bcsr_from_csr as ref_bcsr_from_csr
    from repro.core.formats import csr_from_dense as ref_csr_from_dense
    a, b, mk = dense_operands(seed, 24, 32, 24, (0.4, 0.3, 0.5), ints=True)
    a[:bs] = 0.0
    csrs = [ref_csr_from_dense(x) for x in (a, b, mk)]
    csrs[0].data[::4] = 0.0              # stored zeros stay structural
    ref = [ref_bcsr_from_csr(x, bs) for x in csrs]
    pats = [np.array(ref_bcsr_from_csr(
        RefCSR(x.indptr, x.indices, np.ones(x.nnz, np.float32), x.shape),
        bs).blocks) for x in csrs[:2]]
    return ref, [bcsr_from_reference(x, "cpu") for x in ref], pats


@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("pat_dtype", [torch.float32, torch.bfloat16])
def test_fused_wrapper_matches_reference_structure(bs, pat_dtype):
    """The fused wrapper on CPU tensors equals the reference's
    block_spgemm_with_structure (Pallas kernel, interpret mode) bitwise:
    zero-fill ranks come out as zero blocks, all-flags-off padding changes
    nothing, and a stored 0.0 counts where its value adds nothing."""
    (A, B, M), (At, Bt, Mt), (ap, bp) = stored_zero_case(bs, 70 + bs)
    want_v, want_s = ref_ops.block_spgemm_with_structure(
        A, B, M, a_pattern=jnp.asarray(ap), b_pattern=jnp.asarray(bp),
        backend="pallas", interpret=True)
    want_v, want_s = np.asarray(want_v.blocks), np.asarray(want_s.blocks)
    schedule = ops.build_spgemm_schedule(At, Bt, Mt)
    zero_fill = schedule[0][(schedule[3] & 2) == 0]
    assert len(zero_fill)
    ap_t, bp_t = (torch.as_tensor(x).to(pat_dtype) for x in (ap, bp))
    for extra in (0, 5):
        wl = padded_worklist(schedule, extra) if extra else schedule
        got_v, got_s = kernel.block_spgemm_with_structure_kernel(
            At.blocks, Bt.blocks, ap_t, bp_t,
            *(torch.as_tensor(x) for x in wl), Mt.nnzb)
        assert got_v.dtype == got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_v.numpy(), want_v)
        np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert not got_v[zero_fill].any() and not got_s[zero_fill].any()
    # outputs reached only through stored zeros: value 0, count > 0
    assert bool(((got_s > 0) & (got_v == 0)).any())
    by_value = ops.block_spgemm_with_structure(At, Bt, Mt)[1].blocks
    assert bool((got_s > by_value).any())
    got_ops = ops.block_spgemm_with_structure(At, Bt, Mt, a_pattern=ap_t,
                                              b_pattern=bp_t)
    np.testing.assert_array_equal(got_ops[0].blocks.numpy(), want_v)
    np.testing.assert_array_equal(got_ops[1].blocks.numpy(), want_s)


def test_fused_wrapper_rejects_bad_operands():
    blocks = torch.zeros((2, 4, 4))
    pat = torch.zeros((2, 4, 4), dtype=torch.bfloat16)
    wl = [torch.zeros(3, dtype=torch.int32) for _ in range(4)]
    fused = kernel.block_spgemm_with_structure_kernel
    for bad in ((blocks, blocks, pat.double(), pat, *wl, 2),
                (blocks, blocks, pat, pat.to(torch.int32), *wl, 2),
                (blocks, blocks, pat[:1], pat, *wl, 2),
                (blocks, blocks, pat, pat.transpose(1, 2), *wl, 2),
                (blocks.double(), blocks, pat, pat, *wl, 2),
                (blocks, blocks, pat, pat, wl[0].long(), *wl[1:], 2),
                (blocks, blocks, pat, pat, *wl[:3],
                 torch.zeros(2, dtype=torch.int32), 2),
                (blocks, blocks, pat, pat, *wl, -1)):
        with pytest.raises(ValueError):
            fused(*bad)


def test_cpu_tensors_never_launch_the_fused_kernel():
    before = kernel.FUSED_LAUNCHES, kernel.LAUNCHES
    _, (At, Bt, Mt), (ap, bp) = stored_zero_case(4, 80)
    ops.block_spgemm_with_structure(At, Bt, Mt, a_pattern=torch.as_tensor(ap),
                                    b_pattern=torch.as_tensor(bp))
    assert (kernel.FUSED_LAUNCHES, kernel.LAUNCHES) == before
