"""The port on a CUDA device: the block_spgemm (values only and fused with
the structural counts), masked_matmul and flash_mask kernels against their
plain versions (the Hopper block product, wgmma + TMA, at bs 128 and the
worklist's edges, and bit for bit the mma.sync kernel on integers; the
Hopper SDDMM at 128-blocks, f32 and bf16, several K and tile counts,
out-of-range tiles, no tiles, the mma.sync variant and refusals), both
routes of masked_spgemm, the batched driver, the serving engine's burst, batched and
tile buckets, lane patching, ``bcsr_apply_delta`` and scoped invalidation
(device memory released), the golden trace's replay, and the graph
applications against the same calls on the CPU, the distributed routes
(the sparse ring's p² fused launches, row-parallel, a mesh bucket of the
engine) against the single-device call, the calibration probes
(smoke grids) and auto results under the committed H100 profile against
the builtin constants, the LM forward with the flash kernel against
dense attention, the Hopper bf16 flash kernel (wgmma + TMA) at the path's
shapes and the worklist's edges, the Hopper f32 flash kernel (tf32 wgmma +
TMA) over the sweep's patterns, blocks and head dims, its worklist edges,
against float64 and the mma.sync kernel, block_masked attention, the MoE layer,
an MLA/MoE
model and the xLSTM, Zamba2 and encoder-decoder SMOKE models (under
block_masked and, with attention, flash_pallas) against the CPU, a
monitored engine's ``/metrics`` and ``/health``
answering while its async worker launches the fused kernel, and training:
a backward of each family's SMOKE model against the CPU (then a bf16
step), ``_bmm_f32``'s bf16 backward and flash refusing gradients, and the
dry run's rank on the card against its meta count.  Every test
needs a GPU and skips without one.

This file imports neither JAX nor the reference package, so it runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: exact on small-integer data and on structural counts; rtol =
atol = 1e-4 for the block product (and 2e-6 normwise from float64, which
one TF32 pass misses) and 1e-5 for the row kernels on normal data (atomics in the plain
version's ``index_add_`` and the reduction orders of heap/inner differ
between devices); the reference's 1e-5 / 2e-2 (f32 / bf16) for
masked_matmul and 2e-5 / 3e-2 for flash_mask.  The tensor-core schemes are
also held where one tensor-core pass would fail: bf16 flash to 2e-3
normwise (one bf16 term for p exceeds it at the layer's shape), the
f32 SDDMM at K = 256 to 2e-6 normwise (one TF32 pass misses it by over
10x) and f32 flash (3xTF32) to the sweep's 2e-5, which one TF32 pass
misses (tests/test_torch_tc_numerics.py emulates all three), the Hopper
f32 flash also to 2e-6 normwise of float64 at S 1,024
(tests/test_torch_flash_f32_sm90.py emulates its flushed scheme).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import formats as F
from repro_torch.core.masked_spgemm import ALGORITHMS, masked_spgemm
from repro_torch.kernels.flash_mask import kernel as flash
from repro_torch.kernels.flash_mask.ops import flash_mask_attention
from repro_torch.kernels.masked_matmul import kernel, ops
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def sddmm_f64(a, b, bi, bj, bm, bn):
    """The tile SDDMM in float64: the exact value to f32 accuracy."""
    rows = bi.long()[:, None] * bm + torch.arange(bm, device=a.device)
    cols = bj.long()[:, None] * bn + torch.arange(bn, device=a.device)
    return torch.bmm(a.double()[rows], b.double()[:, cols].permute(1, 0, 2))


def dense_operands(seed, n, dens, ints):
    rng = np.random.default_rng(seed)

    def one(d):
        s = rng.random((n, n)) < d
        v = (rng.integers(1, 5, (n, n)) if ints
             else rng.standard_normal((n, n)))
        return (s * v).astype(np.float32)

    return one(dens[0]), one(dens[1]), \
        (rng.random((n, n)) < dens[2]).astype(np.float32)


def padded_worklist(schedule, extra, dev):
    """The schedule plus ``extra`` all-flags-off entries at the last rank
    (the distributed ring's padding), as device tensors."""
    rank, pa, pb, flags = schedule
    z = np.zeros(extra, np.int32)
    parts = (np.concatenate([rank, np.full(extra, rank[-1], np.int32)]),
             np.concatenate([pa, z]), np.concatenate([pb, z]),
             np.concatenate([flags, z]))
    return [torch.as_tensor(x, device=dev) for x in parts]


@pytest.mark.parametrize("bs", [2, 4, 8, 12, 16, 32, 48, 128])
@pytest.mark.parametrize("ints", [True, False])
def test_kernel_matches_plain(cuda_device, bs, ints):
    nb = max(3, 256 // bs)
    a, b, mk = dense_operands(bs, nb * bs, (0.3, 0.3, 0.5), ints)
    a[:bs] = 0.0          # an empty block row leaves zero-fill entries
    A, B, M = (F.bcsr_from_dense(x, bs, device=cuda_device)
               for x in (a, b, mk))
    sched = ops.build_spgemm_schedule(A, B, M)
    assert ((sched[3] & 2) == 0).any()
    wl = padded_worklist(sched, 3, cuda_device)
    before = kernel.LAUNCHES
    got = kernel.block_spgemm_kernel(A.blocks, B.blocks, *wl, M.nnzb)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    want = kernel.block_spgemm_plain(A.blocks, B.blocks, *wl, M.nnzb)
    tol = 0 if ints else 1e-4
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def block_f64(a_blocks, b_blocks, wl, nnzb_out):
    """The worklist replay in float64."""
    rank, pa, pb, flags = (x.long() for x in wl)
    out = torch.zeros((nnzb_out,) + tuple(a_blocks.shape[1:]),
                      dtype=torch.float64, device=a_blocks.device)
    prods = torch.bmm(a_blocks.double()[pa], b_blocks.double()[pb])
    return out.index_add_(0, rank, prods * ((flags >> 1) & 1).double()
                          [:, None, None])


@pytest.mark.parametrize("bs", [2, 4, 8, 12, 16, 32, 48, 128])
@pytest.mark.parametrize("ints", [True, False])
def test_fused_kernel_matches_plain(cuda_device, bs, ints):
    """Values and structural counts in one launch: counts exact, values
    exact on integers, else within 1e-4 of the plain version and 2e-6
    normwise of float64; the values equal the values-only kernel's."""
    nb = max(3, 256 // bs)
    a, b, mk = dense_operands(bs + 1, nb * bs, (0.3, 0.3, 0.5), ints)
    a[:bs] = 0.0          # an empty block row leaves zero-fill entries
    A, B, M = (F.bcsr_from_dense(x, bs, device=cuda_device)
               for x in (a, b, mk))
    a_pat, b_pat = ((x != 0).to(torch.bfloat16) for x in (A.blocks,
                                                           B.blocks))
    wl = padded_worklist(ops.build_spgemm_schedule(A, B, M), 3, cuda_device)
    before = kernel.FUSED_LAUNCHES, kernel.LAUNCHES
    vals, counts = kernel.block_spgemm_with_structure_kernel(
        A.blocks, B.blocks, a_pat, b_pat, *wl, M.nnzb)
    torch.cuda.synchronize()
    assert (kernel.FUSED_LAUNCHES, kernel.LAUNCHES) == (before[0] + 1,
                                                       before[1])
    want, want_c = kernel.block_spgemm_with_structure_plain(
        A.blocks, B.blocks, a_pat, b_pat, *wl, M.nnzb)
    assert torch.equal(counts, want_c)
    assert torch.equal(vals, kernel.block_spgemm_kernel(A.blocks, B.blocks,
                                                        *wl, M.nnzb))
    tol = 0 if ints else 1e-4
    torch.testing.assert_close(vals, want, rtol=tol, atol=tol)
    exact = block_f64(A.blocks, B.blocks, wl, M.nnzb)
    assert float((vals.double() - exact).norm() / exact.norm()) <= 2e-6


def sm90_worklist(entries, dev):
    """(rank, pa, pb, flags) device tensors from (rank, pa, pb, flags)
    tuples, which must be sorted by rank."""
    cols = np.array(entries, np.int32).reshape(-1, 4).T
    return [torch.as_tensor(np.ascontiguousarray(x), device=dev)
            for x in cols]


def sm90_blocks(seed, nnzb, ints, dev, density=0.6):
    """(nnzb, 128, 128) f32 blocks, integers 1-4 or standard normal, each
    element nonzero with probability ``density``, and their bf16
    patterns."""
    rng = np.random.default_rng(seed)
    shape = (nnzb, 128, 128)
    v = rng.integers(1, 5, shape) if ints else rng.standard_normal(shape)
    x = torch.as_tensor((v * (rng.random(shape) < density))
                        .astype(np.float32), device=dev)
    return x, (x != 0).to(torch.bfloat16)


def sm90_against_plain(a, b, a_pat, b_pat, wl, nnzb_out, ints,
                       want_wl=None):
    """Both entry points on the Hopper kernel (one SM90 launch each)
    against their plain versions on ``want_wl`` (default ``wl``):
    counts exact, values exact on integers, else within 1e-4 of plain
    and 2e-6 normwise of float64.  Returns the values."""
    want_wl = wl if want_wl is None else want_wl
    before = kernel.SM90_LAUNCHES, kernel.LAUNCHES, kernel.FUSED_LAUNCHES
    got = kernel.block_spgemm_kernel(a, b, *wl, nnzb_out, variant="sm90")
    vals, counts = kernel.block_spgemm_with_structure_kernel(
        a, b, a_pat, b_pat, *wl, nnzb_out, variant="sm90")
    torch.cuda.synchronize()
    assert (kernel.SM90_LAUNCHES, kernel.LAUNCHES, kernel.FUSED_LAUNCHES) \
        == (before[0] + 2, before[1] + 1, before[2] + 1)
    want, want_c = kernel.block_spgemm_with_structure_plain(
        a, b, a_pat, b_pat, *want_wl, nnzb_out)
    assert torch.equal(counts, want_c)
    assert torch.equal(vals, got)
    if ints:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        exact = block_f64(a, b, want_wl, nnzb_out)
        assert float((got.double() - exact).norm() / exact.norm()) <= 2e-6
    return got


@pytest.mark.parametrize("ints", [True, False])
def test_block_spgemm_sm90_matches_plain(cuda_device, ints):
    """The Hopper kernel at bs 128 on a block-sparse problem with
    zero-fill entries (an empty block row of A) and an all-flags-off tail
    (the ring's padding), values only and fused; the default variant picks
    it."""
    a, b, mk = dense_operands(27, 128 * 6, (0.5, 0.5, 0.6), ints)
    a[:128] = 0.0
    A, B, M = (F.bcsr_from_dense(x, 128, device=cuda_device)
               for x in (a, b, mk))
    a_pat, b_pat = ((x != 0).to(torch.bfloat16) for x in (A.blocks,
                                                           B.blocks))
    sched = ops.build_spgemm_schedule(A, B, M)
    assert ((sched[3] & 2) == 0).any() and (sched[3] == 5).any()
    wl = padded_worklist(sched, 5, cuda_device)
    assert kernel.sm90_takes(A.blocks, B.blocks, a_pat, b_pat)
    sm90_against_plain(A.blocks, B.blocks, a_pat, b_pat, wl, M.nnzb, ints)
    before = kernel.SM90_LAUNCHES
    kernel.block_spgemm_with_structure_kernel(A.blocks, B.blocks, a_pat,
                                              b_pat, *wl, M.nnzb)
    assert kernel.SM90_LAUNCHES == before + 1


@pytest.mark.parametrize("ints", [True, False])
def test_block_spgemm_sm90_worklist_edges(cuda_device, ints):
    """Out-of-range pa and pb skipped, a write mid-segment, zero-fill and
    all-flags-off entries, ranks that no entry writes (zeros, though the
    output is not cleared first) and a segment of 24 pairs, which wraps the
    stage ring many times."""
    dev = cuda_device
    a, a_pat = sm90_blocks(31, 24, ints, dev)
    b, b_pat = sm90_blocks(32, 24, ints, dev)
    long_seg = [(1, i, (5 * i) % 24, 2 | (1 if i == 0 else 0)
                 | (4 if i in (11, 23) else 0)) for i in range(24)]
    entries = ([(0, 0, 0, 3), (0, -1, 1, 2), (0, 24, 2, 2), (0, 1, 24, 2),
                (0, 2, -3, 2), (0, 3, 4, 6)]
               + long_seg
               + [(3, 0, 0, 5), (3, 0, 0, 0), (4, 5, 6, 7), (4, 0, 0, 0),
                  (4, 0, 0, 0), (6, 7, 8, 1), (6, 9, 10, 2)])
    wl = sm90_worklist(entries, dev)
    # what the plain version (which ignores the write bit) computes for the
    # same replay: the out-of-range entries' add bit cleared and their
    # positions made valid, and rank 6, which adds but never writes, left
    # out
    fixed = [(r, min(max(i, 0), 23), min(max(j, 0), 23),
              f & ~2 if not (0 <= i < 24 and 0 <= j < 24) or r == 6 else f)
             for r, i, j, f in entries]
    got = sm90_against_plain(a, b, a_pat, b_pat, wl, 8, ints,
                             want_wl=sm90_worklist(fixed, dev))
    assert not got[[2, 5, 7]].any()         # ranks that no entry writes
    assert not got[6].any()                 # added, never written
    assert not got[3].any()                 # zero-fill


def test_block_spgemm_sm90_empty_b(cuda_device):
    """An empty B: only zero-fill and all-flags-off entries, no tensor map
    encoded, every block zeros (the outputs are not cleared first)."""
    dev = cuda_device
    a, a_pat = sm90_blocks(33, 3, True, dev)
    b = torch.zeros((0, 128, 128), device=dev)
    wl = sm90_worklist([(0, 0, 0, 5), (1, 1, 0, 5), (2, 2, 0, 0)], dev)
    before = kernel.SM90_LAUNCHES
    got = kernel.block_spgemm_kernel(a, b, *wl, 4, variant="sm90")
    vals, counts = kernel.block_spgemm_with_structure_kernel(
        a, b, a_pat, b.to(torch.bfloat16), *wl, 4, variant="sm90")
    torch.cuda.synchronize()
    assert kernel.SM90_LAUNCHES == before + 2
    for x in (got, vals, counts):
        assert x.shape == (4, 128, 128) and not x.any()


@pytest.mark.parametrize("fused", [False, True])
def test_block_spgemm_sm90_equals_mma_sync_on_integers(cuda_device, fused):
    """Both kernels bit for bit on integer data, and each counted."""
    a, b, mk = dense_operands(29, 128 * 5, (0.6, 0.6, 0.7), True)
    A, B, M = (F.bcsr_from_dense(x, 128, device=cuda_device)
               for x in (a, b, mk))
    a_pat, b_pat = ((x != 0).to(torch.bfloat16) for x in (A.blocks,
                                                           B.blocks))
    wl = padded_worklist(ops.build_spgemm_schedule(A, B, M), 2, cuda_device)
    outs = {}
    for variant in ("sm90", "mma_sync"):
        before = kernel.SM90_LAUNCHES
        if fused:
            outs[variant] = kernel.block_spgemm_with_structure_kernel(
                A.blocks, B.blocks, a_pat, b_pat, *wl, M.nnzb,
                variant=variant)
        else:
            outs[variant] = (kernel.block_spgemm_kernel(
                A.blocks, B.blocks, *wl, M.nnzb, variant=variant),)
        torch.cuda.synchronize()
        assert kernel.SM90_LAUNCHES == before + (variant == "sm90")
    for x, y in zip(outs["sm90"], outs["mma_sync"]):
        assert torch.equal(x, y)


def test_block_spgemm_sm90_refuses_other_shapes_on_cuda(cuda_device):
    a = torch.ones((2, 32, 32), device=cuda_device)
    wl = sm90_worklist([(0, 0, 1, 7)], cuda_device)
    with pytest.raises(ValueError, match="sm90"):
        kernel.block_spgemm_kernel(a, a, *wl, 1, variant="sm90")
    before = kernel.SM90_LAUNCHES
    got = kernel.block_spgemm_kernel(a, a, *wl, 1)
    torch.cuda.synchronize()
    assert kernel.SM90_LAUNCHES == before
    assert torch.equal(got, kernel.block_spgemm_plain(a, a, *wl, 1))


def test_kernel_empty_b_gives_zero_blocks(cuda_device):
    a, _, mk = dense_operands(3, 64, (0.4, 0.4, 0.5), True)
    A, M = (F.bcsr_from_dense(x, 8, device=cuda_device) for x in (a, mk))
    B = F.bcsr_from_dense(np.zeros((64, 64), np.float32), 8,
                          device=cuda_device)
    out = ops.block_spgemm(A, B, M).blocks
    assert out.is_cuda and out.shape[0] == M.nnzb
    assert not out.any()


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_row_algorithms_match_cpu(cuda_device, alg):
    A, B, M = (F.csr_from_dense(x) for x in
               dense_operands(7, 96, (0.1, 0.1, 0.2), True))
    got = masked_spgemm(A, B, M, algorithm=alg, device=cuda_device)
    want = masked_spgemm(A, B, M, algorithm=alg, device="cpu")
    assert got.vals.is_cuda
    for g, w in ((got.vals, want.vals), (got.present, want.present),
                 (got.mask_cols, want.mask_cols)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


def test_tile_route_matches_cpu(cuda_device):
    mats = [F.block_sparse(256, 32, 0.4, 0.9, seed=s) for s in (1, 2)]
    mats.append(F.block_sparse(256, 32, 0.6, 1.0, seed=3, mask=True))
    A, B, M = (F.csr_from_dense(x) for x in mats)
    before = kernel.FUSED_LAUNCHES, kernel.LAUNCHES
    got = masked_spgemm(A, B, M, algorithm="tile", tile_block=32,
                        device=cuda_device)
    torch.cuda.synchronize()
    # values and structure in one fused launch
    assert (kernel.FUSED_LAUNCHES, kernel.LAUNCHES) == (before[0] + 1,
                                                       before[1])
    want = masked_spgemm(A, B, M, algorithm="tile", tile_block=32,
                         device="cpu")
    torch.testing.assert_close(got.vals.cpu(), want.vals, rtol=0, atol=0)
    assert torch.equal(got.present.cpu(), want.present)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("route", ["ring", "row"])
def test_distributed_routes_on_cuda_match_single_device(cuda_device, route,
                                                        p):
    from repro_torch.core.distributed import (distributed_masked_spgemm,
                                              make_mesh)
    mats = [F.block_sparse(256, 32, 0.4, 0.9, seed=s) for s in (1, 2)]
    mats.append(F.block_sparse(256, 32, 0.6, 1.0, seed=3, mask=True))
    A, B, M = (F.csr_from_dense(x) for x in mats)
    mesh = make_mesh(p)
    assert all(d.type == "cuda" for d in mesh.devices)
    before = kernel.FUSED_LAUNCHES, kernel.LAUNCHES
    got = distributed_masked_spgemm(A, B, M, mesh, algorithm=route,
                                    block_size=32)
    torch.cuda.synchronize()
    assert got.vals.device == mesh.devices[0]
    # the ring: one fused launch per (shard, stage); the row route none
    assert (kernel.FUSED_LAUNCHES - before[0], kernel.LAUNCHES) == (
        p * p if route == "ring" else 0, before[1])
    want = masked_spgemm(A, B, M, algorithm="tile", tile_block=32,
                         device=cuda_device)
    for g, w in ((got.vals, want.vals), (got.present, want.present),
                 (got.mask_cols, want.mask_cols)):
        assert torch.equal(g, w)
    cpu = distributed_masked_spgemm(A, B, M, make_mesh(p, device="cpu"),
                                    algorithm=route, block_size=32)
    assert torch.equal(got.vals.cpu(), cpu.vals)
    assert torch.equal(got.present.cpu(), cpu.present)


def test_mesh_engine_bucket_on_cuda_is_bitwise_one_shot(cuda_device):
    from repro_torch.core.distributed import (distributed_masked_spgemm,
                                              make_mesh)
    from repro_torch.serving import QueryEngine
    mats = [F.block_sparse(256, 32, 0.4, 0.9, seed=s) for s in (1, 2)]
    mats.append(F.block_sparse(256, 32, 0.6, 1.0, seed=3, mask=True))
    A, B, M = (F.csr_from_dense(x) for x in mats)
    queries = [int_valued(A, s) for s in range(3)]
    mesh = make_mesh(4)
    kernel.FUSED_LAUNCHES = 0
    with QueryEngine(cache_results=False, device=cuda_device) as eng:
        tickets = [eng.submit(a, B, M, mesh=mesh, algorithm="ring")
                   for a in queries]
        eng.flush()
        assert kernel.FUSED_LAUNCHES == 3 * 16
        for a, t in zip(queries, tickets):
            want = distributed_masked_spgemm(a, B, M, mesh,
                                             algorithm="ring")
            assert torch.equal(t.result().vals, want.vals)
            assert torch.equal(t.result().present, want.present)


@pytest.mark.parametrize("dtype", [np.int64, np.float32, np.float64,
                                   np.bool_])
def test_staged_upload_equals_the_host_array(cuda_device, dtype):
    """Large host arrays reach the card in pieces through two page-locked
    buffers: every byte arrives, with a piece size that divides neither
    the array nor its element size."""
    rng = np.random.default_rng(4)
    x = (rng.random(300_001) < 0.5 if dtype is np.bool_
         else rng.integers(-1000, 1000, 300_001).astype(dtype))
    want = torch.from_numpy(x)
    got = F._Staging(chunk=4100)(x, cuda_device)
    assert got.is_cuda and got.dtype == want.dtype
    assert torch.equal(got.cpu(), want)
    assert torch.equal(F._to_device(x, cuda_device).cpu(), want)


def test_staged_uploads_from_many_threads(cuda_device):
    """The page-locked buffers are shared by the process: uploads from
    more threads than cores, each of its own array, all arrive whole."""
    import threading
    rng = np.random.default_rng(5)
    arrays = [rng.integers(0, 1 << 40, 150_000 + i) for i in range(16)]
    staging = F._Staging(chunk=64 << 10)
    got = [None] * len(arrays)

    def upload(i):
        with torch.cuda.device(cuda_device):
            got[i] = staging(arrays[i], torch.device(
                "cuda", torch.cuda.current_device())).cpu()

    threads = [threading.Thread(target=upload, args=(i,))
               for i in range(len(arrays))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for x, g in zip(arrays, got):
        assert torch.equal(g, torch.from_numpy(x))


def test_default_device_is_cuda(cuda_device):
    A, B, M = (F.csr_from_dense(x) for x in
               dense_operands(9, 64, (0.2, 0.2, 0.3), True))
    res = masked_spgemm(A, B, M)
    assert res.vals.is_cuda and res.present.is_cuda


def _revalue(x, seed, ints=False):
    rng = np.random.default_rng(seed)
    data = (rng.integers(1, 5, x.nnz) if ints
            else rng.uniform(0.5, 1.5, x.nnz)).astype(np.float32)
    return F.CSR(x.indptr, x.indices, data, x.shape)


def _same(got, want):
    for g, w in ((got.vals, want.vals), (got.present, want.present),
                 (got.mask_cols, want.mask_cols)):
        assert torch.equal(g.cpu(), w.cpu())


def _serving_case(route):
    """Operands whose bucket the engine serves by ``route``: a burst
    (mca-elected ER with a dense mask), a batched row program (inner
    elected), or the tile route (block-sparse)."""
    if route == "tile":
        mats = [F.block_sparse(256, 32, 0.4, 0.9, seed=s) for s in (1, 2)]
        mats.append(F.block_sparse(256, 32, 0.6, 1.0, seed=3, mask=True))
        return tuple(F.csr_from_dense(x) for x in mats)
    if route == "burst":
        return (F.erdos_renyi(192, 2, seed=100),
                F.erdos_renyi(192, 2, seed=200), F.er_mask(192, 24, seed=300))
    return (F.erdos_renyi(192, 6, seed=101), F.erdos_renyi(192, 6, seed=201),
            F.er_mask(192, 16, seed=301))


@pytest.mark.parametrize("route", ["burst", "batched", "tile"])
def test_engine_buckets_match_cpu(cuda_device, route):
    """Each route of the serving engine on the card: integer data equal to
    the same engine on the CPU, float data bitwise the one-shot call on
    the card; a tile bucket launches the fused kernel once per element."""
    from repro_torch.serving import QueryEngine
    A, B, M = _serving_case(route)
    for ints in (True, False):
        qs = [(_revalue(A, s, ints), B, M) for s in range(4)]
        with QueryEngine(device=cuda_device, cache_results=False) as eng:
            before = kernel.FUSED_LAUNCHES
            got = eng.serve(qs)
            launches = kernel.FUSED_LAUNCHES - before
            log = eng.metrics.bucket_log()
        assert [row["route"] for row in log] == [route]
        assert launches == (4 if route == "tile" else 0)
        assert all(g.vals.device.type == cuda_device.type for g in got)
        if ints:
            with QueryEngine(device="cpu", cache_results=False) as eng:
                want = eng.serve(qs)
        else:
            want = [masked_spgemm(*q, device=cuda_device) for q in qs]
        for g, w in zip(got, want):
            _same(g, w)


def test_async_engine_on_cuda_matches_one_shot(cuda_device):
    from repro_torch.serving import QueryEngine
    A, B, M = _serving_case("burst")
    qs = [(_revalue(A, s), B, M) for s in range(6)]
    with QueryEngine(device=cuda_device, async_mode=True, max_batch=4,
                     max_wait_ms=1.0, cache_results=False) as eng:
        tickets = [eng.submit(*q) for q in qs]
        got = [t.result(timeout=120) for t in tickets]
    for q, g in zip(qs, got):
        _same(g, masked_spgemm(*q, device=cuda_device))


@pytest.mark.parametrize("alg, complement", [
    (alg, False) for alg in ("auto", "msa", "hash", "mca", "heap", "inner")
] + [(alg, True) for alg in ("auto", "msa", "heap")])
def test_batched_driver_matches_cpu(cuda_device, alg, complement):
    from repro_torch.core.masked_spgemm import masked_spgemm_batched
    B = _revalue(F.erdos_renyi(96, 4, seed=11), 1, ints=True)
    As = [_revalue(F.erdos_renyi(96, 3 + i, seed=12 + i), i, ints=True)
          for i in range(3)]
    Ms = [F.er_mask(96, 8 + 4 * i, seed=20 + i) for i in range(3)]
    got = masked_spgemm_batched(As, B, Ms, algorithm=alg,
                                complement=complement, device=cuda_device)
    want = masked_spgemm_batched(As, B, Ms, algorithm=alg,
                                 complement=complement, device="cpu")
    if complement:
        assert got[0].device.type == cuda_device.type
        assert got[0].shape == (3, 96, 96)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        return
    for g, w in zip(got, want):
        assert g.vals.device.type == cuda_device.type
        _same(g, w)


def _burst_delta_case():
    A, B, M = _serving_case("burst")
    rng = np.random.default_rng(3)
    rows = rng.choice(A.shape[0], 4, replace=False).astype(np.int64)
    d = F.CSRDelta.upserts(rows, rng.integers(0, A.shape[1], 4),
                           rng.uniform(0.5, 1.5, 4).astype(np.float32))
    return A, B, M, F.apply_csr_delta(A, d)


@pytest.mark.parametrize("which", ["A", "M", "B values"])
def test_patched_program_on_cuda_equals_cold_rebuild(cuda_device, which):
    """A lane patch on the card: its device tables and results bit for bit
    a cold rebuild's, the parent's tables untouched."""
    from repro_torch.core.planner import plan
    from repro_torch.core.semiring import PLUS_TIMES
    from repro_torch.serving import burst
    A, B, M, res = _burst_delta_case()
    A1, B1, M1, changed = A, B, M, res.changed_rows
    if which == "A":
        A1 = res.csr
    elif which == "M":
        M1 = F.apply_csr_delta(M, F.CSRDelta.upserts(
            changed, (changed * 7) % M.shape[1],
            np.ones(len(changed), np.float32))).csr
    else:
        B1 = _revalue(B, 5)
        changed = np.zeros(0, np.int64)
    wm = plan(A, B, M, device=cuda_device).widths[2]
    parent = burst.BurstProgram(A, B, M, PLUS_TIMES, wm, device=cuda_device)
    assert isinstance(parent._BG, np.ndarray)     # host until patched
    before = [torch.as_tensor(t).clone() for t in (
        parent._IA, parent._BV, parent._BG, parent.present,
        parent.mask_cols)]
    prog, lanes = parent.patched(A1, B1, M1, changed)
    assert (lanes > 0) == (which != "B values")
    cold = burst.BurstProgram(A1, B1, M1, PLUS_TIMES, wm, device=cuda_device)
    for got, want in ((prog._IA, cold._IA), (prog._BV, cold._BV),
                      (prog._BG, cold._BG), (prog.present, cold.present),
                      (prog.mask_cols, cold.mask_cols)):
        assert got.device.type == cuda_device.type
        assert torch.equal(got.cpu(), torch.as_tensor(want).cpu())
    for t, b in zip((parent._IA, parent._BV, parent._BG, parent.present,
                     parent.mask_cols), before):
        assert torch.equal(t.cpu(), b.cpu())
    qs = [_revalue(A1, s) for s in range(3)]
    for g, w in zip(prog.run(qs), cold.run(qs)):
        _same(g, w)


def test_bcsr_apply_delta_on_cuda_equals_rebuild(cuda_device):
    x = F.csr_from_dense(F.block_sparse(256, 32, 0.4, 0.9, seed=4))
    b0 = F.bcsr_from_csr(x, 32, device=cuda_device)
    rng = np.random.default_rng(6)
    d = F.CSRDelta(rng.integers(0, 256, 16), rng.integers(0, 256, 16),
                   rng.integers(1, 5, 16).astype(np.float32),
                   rng.random(16) < 0.3)
    res = F.apply_csr_delta(x, d)
    got = F.bcsr_apply_delta(b0, res.csr, res.changed_rows)
    want = F.bcsr_from_csr(res.csr, 32, device=cuda_device)
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    assert got.blocks.device.type == cuda_device.type
    assert torch.equal(got.blocks, want.blocks)


def test_invalidation_releases_device_memory(cuda_device):
    """An entry evicted by a delta frees its device tensors: the device
    bytes allocated fall by one result's bytes.  (No burst program, so the
    delta allocates no patched tables.)"""
    from repro_torch.serving import QueryEngine
    A, B, M, res = _burst_delta_case()
    with QueryEngine(device=cuda_device, use_burst=False) as eng:
        eng.submit(A, B, M).result()      # warm: the plan
        eng.results.clear()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda_device)
        got = eng.submit(_revalue(A, 1), B, M).result()
        nbytes = sum(t.numel() * t.element_size()
                     for t in (got.vals, got.present, got.mask_cols))
        del got
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(cuda_device)
        assert held - base >= nbytes                   # the cached result
        d = F.CSRDelta.upserts(res.changed_rows, res.changed_rows,
                               np.ones(len(res.changed_rows), np.float32))
        out = eng.submit_delta(A, B, M, delta_a=d)
        assert out.entries_evicted == 1
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated(cuda_device)
        assert held - after >= nbytes


def test_golden_trace_replay_on_cuda_is_deterministic(cuda_device):
    from repro_torch.serving import Trace, replay_trace
    from repro_torch.serving.trace import golden_trace_path
    trace = Trace.load(golden_trace_path())
    r1 = replay_trace(trace, device=cuda_device)
    r2 = replay_trace(trace, device=cuda_device, async_mode=True)
    assert r1.digest == r2.digest and r1.schedule == r2.schedule
    assert (r1.counters["submitted"], r1.counters["buckets_executed"],
            r1.counters["result_cache_hits"]) == (48, 22, 7)


def test_graph_applications_on_cuda_match_cpu(cuda_device):
    from repro_torch.graphs import betweenness_centrality, ktruss
    g = F.rmat(8, 8, seed=12)
    truss, _, _, _ = ktruss(g, 4, device=cuda_device)
    want, _, _, _ = ktruss(g, 4, device="cpu")
    assert np.array_equal(truss.to_dense(), want.to_dense())
    bc, _, _ = betweenness_centrality(g, sources=range(32), source_chunks=4,
                                      device=cuda_device)
    bc_cpu, _, _ = betweenness_centrality(g, sources=range(32),
                                          source_chunks=4, device="cpu")
    np.testing.assert_allclose(bc, bc_cpu, rtol=1e-5, atol=1e-5)


def test_smoke_probes_on_cuda_fit_and_launch_the_fused_kernel(cuda_device):
    import math
    from repro_torch.tuning import fit, probes, snapshot
    from repro_torch.tuning import backend_signature
    base = snapshot(name="builtin", backend=backend_signature(cuda_device))
    kernel.FUSED_LAUNCHES = kernel.LAUNCHES = 0
    ms = probes.run_probes(("row", "tile"), smoke=True, device=cuda_device,
                           log=lambda line: None)
    assert kernel.FUSED_LAUNCHES == probes.tile_calls(smoke=True) == 8
    assert kernel.LAUNCHES == 0
    p = fit.fit_profile(ms, base, families=("row", "tile"), name="smoke",
                        backend=backend_signature(cuda_device))
    assert set(p.residuals) == {"row", "tile"}
    assert all(math.isfinite(v) for v in p.residuals.values())
    assert p.backend["platform"] == "gpu"


def int_valued(x, seed):
    rng = np.random.default_rng(seed)
    return F.CSR(x.indptr, x.indices,
                 rng.integers(1, 5, x.nnz).astype(np.float32), x.shape)


@pytest.mark.parametrize("kind", ["rmat", "block"])
def test_auto_results_equal_under_h100_profile_and_builtin(cuda_device,
                                                           kind):
    """The committed H100 profile changes which route runs, never what it
    returns: integer-valued operands, bit for bit."""
    import dataclasses
    from repro_torch import tuning
    from repro_torch.core import planner
    h100, exact = tuning.lookup()
    assert exact
    builtin = dataclasses.replace(
        tuning.snapshot(name="builtin",
                        backend=tuning.backend_signature(cuda_device)),
        version=tuning.BUILTIN_VERSION)
    if kind == "rmat":
        g = F.rmat(10, 8, seed=5)
        A, B, M = int_valued(g, 1), int_valued(g, 2), g
    else:
        A, B, M = (F.csr_from_dense(x) for x in (
            F.block_sparse(1024, 32, 0.3, 0.9, seed=1),
            F.block_sparse(1024, 32, 0.3, 0.9, seed=2),
            F.block_sparse(1024, 32, 0.6, 1.0, seed=3, mask=True)))
    try:
        tuning.activate(builtin)
        planner.clear_plan_cache()
        base = masked_spgemm(A, B, M, device=cuda_device)
        tuning.activate(h100)
        planner.clear_plan_cache()
        other = masked_spgemm(A, B, M, device=cuda_device)
    finally:
        tuning.activate(builtin)
        planner.clear_plan_cache()
    assert torch.equal(base.vals, other.vals)
    assert torch.equal(base.present, other.present)


@pytest.mark.parametrize("blocks", [(8, 8, 8), (16, 16, 16), (32, 32, 16),
                                    (128, 128, 128), (8, 128, 16),
                                    (8, 8, 5), (24, 40, 8), (256, 128, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ints", [True, False])
def test_masked_matmul_kernel_matches_plain(cuda_device, blocks, dtype,
                                            ints):
    """Every block shape against the plain version; the 128 x 128 cases
    run the Hopper kernel (masked_matmul_sm90.cu) by dispatch, the rest
    the mma.sync kernel, under the same assertions."""
    bm, bn, bk = blocks
    rng = np.random.default_rng(bm + bn)
    M, K, N = 4 * bm, 3 * bk, 3 * bn
    draw = ((lambda s: rng.integers(-4, 5, s)) if ints
            else rng.standard_normal)
    a = torch.as_tensor(draw((M, K)), dtype=dtype, device=cuda_device)
    b = torch.as_tensor(draw((K, N)), dtype=dtype, device=cuda_device)
    ok = rng.random((4, 3)) < 0.5
    ok[0, 0] = True
    bi, bj = (torch.as_tensor(x.astype(np.int32), device=cuda_device)
              for x in np.nonzero(ok))
    before = kernel.MASKED_MATMUL_LAUNCHES
    before_sm90 = kernel.MASKED_MATMUL_SM90_LAUNCHES
    got = ops.masked_matmul(a, b, bi, bj, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert kernel.MASKED_MATMUL_LAUNCHES == before + 1
    assert (kernel.MASKED_MATMUL_SM90_LAUNCHES - before_sm90
            == (bm == bn == 128))
    want = kernel.masked_matmul_plain(a, b, bi, bj, bm=bm, bn=bn)
    if ints or dtype == torch.bfloat16:
        tol = 0 if ints else 2e-2
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    else:
        # 3xTF32 sums in another order than the plain version's IEEE f32
        # bmm, and at K = 384 that bmm itself strays past 1e-5 of the exact
        # value at some outputs; so the 1e-5 is held against float64, and
        # the plain version within 2e-6 normwise
        exact = sddmm_f64(a, b, bi, bj, bm, bn)
        torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=1e-5)
        assert float((got - want).norm() / want.norm()) <= 2e-6


def test_masked_matmul_f32_keeps_f32_accuracy(cuda_device):
    """3xTF32 at K = 256 on standard-normal data: within 2e-6 normwise of
    the plain version (IEEE f32 bmm) and of float64, and elementwise within
    1e-5 of the dot products' absolute scale sum_k |a_ik b_kj|, which
    rounding in any f32 summation order stays under; one TF32 pass fails
    all three.  Its 128-blocks run the Hopper kernel by dispatch."""
    n, k, bs = 1024, 256, 128
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.standard_normal((n, k)), dtype=torch.float32,
                        device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((k, n)), dtype=torch.float32,
                        device=cuda_device)
    ok = rng.random((n // bs, n // bs)) < 0.5
    bi, bj = (torch.as_tensor(x.astype(np.int32), device=cuda_device)
              for x in np.nonzero(ok))
    got = ops.masked_matmul(a, b, bi, bj, bm=bs, bn=bs, bk=bs)
    want = kernel.masked_matmul_plain(a, b, bi, bj, bm=bs, bn=bs)
    scale = kernel.masked_matmul_plain(a.abs(), b.abs(), bi, bj, bm=bs,
                                       bn=bs)
    diff = got - want
    assert float(diff.norm() / want.norm()) <= 2e-6
    assert float((diff.abs() / scale).max()) <= 1e-5
    exact = sddmm_f64(a, b, bi, bj, bs, bs)
    assert float((got.double() - exact).norm() / exact.norm()) <= 2e-6


def sddmm_case(seed, m, k, n, dtype, ints, dev, frac=0.5):
    """Operands and a random mask of 128-blocks (tile (0, 0) always)."""
    rng = np.random.default_rng(seed)
    draw = ((lambda s: rng.integers(-4, 5, s)) if ints
            else rng.standard_normal)
    a = torch.as_tensor(draw((m, k)), dtype=dtype, device=dev)
    b = torch.as_tensor(draw((k, n)), dtype=dtype, device=dev)
    ok = rng.random((m // 128, n // 128)) < frac
    ok[0, 0] = True
    bi, bj = (torch.as_tensor(x.astype(np.int32), device=dev)
              for x in np.nonzero(ok))
    return a, b, bi, bj


@pytest.mark.parametrize("shape", [(512, 384, 384), (256, 32, 256),
                                   (384, 200, 640), (2048, 256, 2048),
                                   (256, 1024, 384)],
                         ids=["K384", "K32", "K200-208", "many-tiles",
                              "K1024"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ints", [True, False])
def test_masked_matmul_sm90_matches_plain(cuda_device, shape, dtype, ints):
    """The Hopper SDDMM kernel at several K (past a stage's depth and not
    a multiple of it: TMA's zero fill) and tile counts (more tiles than
    SMs: each persistent CTA walks several): integers bit for bit the
    plain version; normal data f32 within 2e-6 normwise of plain and of
    float64 and elementwise within 1e-5 of the dot products' absolute
    scale sum_k |a b| from float64 (at K = 1024 the plain version's own
    IEEE f32 bmm strays past rtol = atol = 1e-5 of float64 at some
    outputs), bf16 within 2e-2 of plain."""
    m, k, n = shape
    if dtype == torch.bfloat16 and k % 8:
        k += 8 - k % 8                  # bf16 rows of 16-byte multiples
    a, b, bi, bj = sddmm_case(k + m, m, k, n, dtype, ints, cuda_device,
                              frac=0.6)
    assert kernel.masked_matmul_sm90_takes(a, b, 128, 128)
    before = kernel.MASKED_MATMUL_SM90_LAUNCHES
    got = ops.masked_matmul(a, b, bi, bj, bm=128, bn=128, bk=k)
    torch.cuda.synchronize()
    assert kernel.MASKED_MATMUL_SM90_LAUNCHES == before + 1
    want = kernel.masked_matmul_plain(a, b, bi, bj, bm=128, bn=128)
    if ints:
        assert torch.equal(got, want)
    elif dtype == torch.bfloat16:
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    else:
        exact = sddmm_f64(a, b, bi, bj, 128, 128)
        scale = sddmm_f64(a.abs(), b.abs(), bi, bj, 128, 128)
        assert float(((got.double() - exact).abs() / scale).max()) <= 1e-5
        assert float((got - want).norm() / want.norm()) <= 2e-6
        assert float((got.double() - exact).norm() / exact.norm()) <= 2e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_matmul_sm90_out_of_range_tiles(cuda_device, dtype):
    """Tiles outside A or B come out as zeros (the output is not cleared
    first) between tiles inside, which equal the plain version."""
    a, b, _, _ = sddmm_case(11, 384, 256, 512, dtype, True, cuda_device)
    tiles = [(0, 0), (-1, 0), (2, 3), (3, 0), (0, 4), (1, -7), (1, 1),
             (1 << 24, 2)]
    inside = [i for i, (x, y) in enumerate(tiles) if 0 <= x < 3
              and 0 <= y < 4]
    bi, bj = (torch.tensor(x, dtype=torch.int32, device=cuda_device)
              for x in zip(*tiles))
    outs = {}
    for variant in ("sm90", "mma_sync"):
        outs[variant] = got = kernel.masked_matmul_kernel(
            a, b, bi, bj, bm=128, bn=128, bk=128, variant=variant)
        torch.cuda.synchronize()
        keep = torch.tensor(inside, device=cuda_device)
        want = kernel.masked_matmul_plain(a, b, bi[keep], bj[keep], bm=128,
                                          bn=128)
        assert torch.equal(got[keep], want)
        drop = [i for i in range(len(tiles)) if i not in inside]
        assert not got[drop].any()
    assert torch.equal(outs["sm90"], outs["mma_sync"])


def test_masked_matmul_sm90_no_tiles(cuda_device):
    """nnzb = 0: an empty result and no launch."""
    a, b, _, _ = sddmm_case(12, 256, 256, 256, torch.float32, True,
                            cuda_device)
    none = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    counts = (kernel.MASKED_MATMUL_LAUNCHES,
              kernel.MASKED_MATMUL_SM90_LAUNCHES)
    got = ops.masked_matmul(a, b, none, none, bm=128, bn=128, bk=128,
                            variant="sm90")
    torch.cuda.synchronize()
    assert got.shape == (0, 128, 128)
    assert (kernel.MASKED_MATMUL_LAUNCHES,
            kernel.MASKED_MATMUL_SM90_LAUNCHES) == counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_matmul_mma_sync_variant_is_not_counted_as_sm90(cuda_device,
                                                               dtype):
    """variant="mma_sync" at 128-blocks runs the old kernel: counted in
    MASKED_MATMUL_LAUNCHES only, and bit for bit the Hopper kernel on
    integers."""
    a, b, bi, bj = sddmm_case(13, 512, 256, 512, dtype, True, cuda_device)
    outs = {}
    for variant in ("mma_sync", "sm90"):
        launches = kernel.MASKED_MATMUL_LAUNCHES
        sm90 = kernel.MASKED_MATMUL_SM90_LAUNCHES
        outs[variant] = ops.masked_matmul(a, b, bi, bj, bm=128, bn=128,
                                          bk=128, variant=variant)
        torch.cuda.synchronize()
        assert kernel.MASKED_MATMUL_LAUNCHES == launches + 1
        assert kernel.MASKED_MATMUL_SM90_LAUNCHES == sm90 + (variant
                                                             == "sm90")
    assert torch.equal(outs["sm90"], outs["mma_sync"])


def test_masked_matmul_sm90_refuses_other_shapes_on_cuda(cuda_device):
    """"sm90" on a shape it does not take raises; the default runs the
    mma.sync kernel there, uncounted as sm90."""
    dev = cuda_device
    a = torch.ones((256, 256), device=dev)
    bi = bj = torch.zeros(1, dtype=torch.int32, device=dev)
    odd = torch.ones((256, 6), device=dev), torch.ones((6, 256), device=dev)
    for x, y, blk in ((a, a, 64), (*odd, 128)):
        with pytest.raises(ValueError, match="sm90 masked_matmul"):
            kernel.masked_matmul_kernel(x, y, bi, bj, bm=blk, bn=blk,
                                        bk=x.shape[1], variant="sm90")
        before = kernel.MASKED_MATMUL_SM90_LAUNCHES
        got = kernel.masked_matmul_kernel(x, y, bi, bj, bm=blk, bn=blk,
                                          bk=x.shape[1])
        torch.cuda.synchronize()
        assert kernel.MASKED_MATMUL_SM90_LAUNCHES == before
        assert torch.equal(got, kernel.masked_matmul_plain(
            x, y, bi, bj, bm=blk, bn=blk))
    with pytest.raises(ValueError, match="unknown masked_matmul variant"):
        kernel.masked_matmul_kernel(a, a, bi, bj, bm=128, bn=128, bk=128,
                                    variant="wgmma")


FLASH_PATTERNS = [dict(causal=True, window=0, prefix=0),
                  dict(causal=True, window=16, prefix=0),
                  dict(causal=True, window=16, prefix=8),
                  dict(causal=False, window=0, prefix=0)]


@pytest.mark.parametrize("pattern", FLASH_PATTERNS,
                         ids=["causal", "window", "window+prefix", "dense"])
@pytest.mark.parametrize("shape", [(32, 32, 8, 8, 16), (64, 64, 16, 16, 16),
                                   (32, 64, 8, 16, 16), (256, 256, 64, 32, 64),
                                   (256, 256, 128, 128, 128),
                                   (256, 256, 128, 128, 112),
                                   (8, 64, 8, 8, 16), (64, 64, 16, 32, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda_device, pattern, shape, dtype):
    s_q, s_k, bq, bk, d = shape
    b, hq, hkv = 2, 4, 2
    g = torch.Generator(device=cuda_device).manual_seed(s_q + bq + d)

    def mk(*shape):
        return (torch.randn(shape, generator=g, device=cuda_device)
                * 0.5).to(dtype)

    q, k, v = mk(b, hq, s_q, d), mk(b, hkv, s_k, d), mk(b, hkv, s_k, d)
    q_off = s_k - s_q
    sched = [torch.as_tensor(x, device=cuda_device) for x in
             flash.build_schedule(s_q, s_k, bq=bq, bk=bk, q_offset=q_off,
                                  **pattern)]
    kw = dict(bq=bq, bk=bk, scale=d ** -0.5, q_offset=q_off, **pattern)
    before = flash.LAUNCHES, flash.TC_LAUNCHES, flash.F32_LAUNCHES
    got = flash.flash_mask_kernel(q, k, v, *sched, **kw)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    # tensor cores for both dtypes: bf16, or f32 in 3xTF32
    assert (flash.LAUNCHES, flash.TC_LAUNCHES, flash.F32_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + (not bf16))
    want = flash.flash_mask_plain(q, k, v, *sched, **kw)
    tol = 3e-2 if bf16 else 2e-5
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if bf16:
        diff = got.float() - want.float()
        assert float(diff.norm() / want.float().norm()) <= 2e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_out_of_range_kv_block_is_fully_masked(cuda_device, dtype):
    """Worklist entries whose kv-block lies outside k and v change
    nothing: both kernels leave m, l and the accumulator as they were."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = ((torch.randn(1, 2, 128, 64, generator=g, device=cuda_device)
                * 0.5).to(dtype) for _ in range(3))
    qi, ki, flags = flash.build_schedule(128, 128, bq=32, bk=32, causal=True,
                                         window=0, prefix=0, q_offset=0)
    at = int(np.nonzero(qi == 3)[0][1])         # inside q-block 3's segment
    padded = (np.insert(qi, at, [3, 3]), np.insert(ki, at, [4, -1]),
              np.insert(flags, at, [0, 0]))
    kw = dict(bq=32, bk=32, scale=0.125, causal=True, window=0, prefix=0,
              q_offset=0)
    want, got = (flash.flash_mask_kernel(
        q, k, v, *(torch.as_tensor(x, device=cuda_device) for x in wl), **kw)
        for wl in ((qi, ki, flags), padded))
    assert torch.equal(got, want)


SM90_CASES = {  # Hq, Hkv, S_q, S_k, D, bq, bk, pattern
    "llama": (32, 8, 512, 512, 64, 128, 128, FLASH_PATTERNS[0]),
    "moonshot": (16, 16, 512, 512, 128, 128, 128, FLASH_PATTERNS[0]),
    "zamba2-d112": (32, 32, 512, 512, 112, 128, 128, FLASH_PATTERNS[0]),
    "seamless-noncausal": (16, 16, 512, 512, 64, 128, 128,
                           FLASH_PATTERNS[3]),
    "window+prefix": (4, 2, 512, 512, 64, 128, 128,
                      dict(causal=True, window=200, prefix=100)),
    "q_offset": (4, 2, 256, 512, 64, 128, 128, FLASH_PATTERNS[0]),
    "bq64-bk64": (4, 2, 512, 512, 64, 64, 64, FLASH_PATTERNS[0]),
    "bq64-bk128-d128": (4, 2, 512, 512, 128, 64, 128, FLASH_PATTERNS[0]),
}


@pytest.mark.parametrize("case", list(SM90_CASES))
def test_flash_sm90_matches_plain(cuda_device, case):
    """The Hopper bf16 kernel (wgmma + TMA) at the path's shapes cut to
    S 512 and B 1, and at its edges, against the plain version within the
    sweep's 3e-2 and 2e-3 normwise; the wrapper picks it unasked."""
    hq, hkv, s_q, s_k, d, bq, bk, pattern = SM90_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(s_q + d + bq)
    q, k, v = ((torch.randn(shape, generator=g, device=cuda_device) * 0.5)
               .to(torch.bfloat16)
               for shape in ((1, hq, s_q, d), (1, hkv, s_k, d),
                             (1, hkv, s_k, d)))
    q_off = s_k - s_q
    sched = [torch.as_tensor(x, device=cuda_device) for x in
             flash.build_schedule(s_q, s_k, bq=bq, bk=bk, q_offset=q_off,
                                  **pattern)]
    kw = dict(bq=bq, bk=bk, scale=d ** -0.5, q_offset=q_off, **pattern)
    before = flash.SM90_LAUNCHES, flash.TC_LAUNCHES
    got = flash.flash_mask_kernel(q, k, v, *sched, **kw)
    torch.cuda.synchronize()
    assert (flash.SM90_LAUNCHES, flash.TC_LAUNCHES) == (before[0] + 1,
                                                        before[1] + 1)
    want = flash.flash_mask_plain(q, k, v, *sched, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)
    diff = got.float() - want.float()
    assert float(diff.norm() / want.float().norm()) <= 2e-3


def test_flash_sm90_worklist_edges(cuda_device):
    """A q-block the worklist never visits, or never flushes, stays zero,
    and out-of-range kv-blocks (the producer arrives on their stage with
    no bytes) change nothing, bit for bit; mma_sync forced by name runs
    the old kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = ((torch.randn(1, 4, 256, 64, generator=g, device=cuda_device)
                * 0.5).to(torch.bfloat16) for _ in range(3))
    k, v = k[:, :2].contiguous(), v[:, :2].contiguous()
    qi, ki, flags = flash.build_schedule(256, 256, bq=128, bk=128,
                                         causal=True, window=0, prefix=0,
                                         q_offset=0)
    kw = dict(bq=128, bk=128, scale=0.125, causal=True, window=0, prefix=0,
              q_offset=0)
    at = int(np.nonzero(qi == 1)[0][1])
    keep = qi != 0

    def run(wl, **extra):
        return flash.flash_mask_kernel(
            q, k, v, *(torch.as_tensor(x, device=cuda_device) for x in wl),
            **kw, **extra)

    before = flash.SM90_LAUNCHES
    base = run((qi, ki, flags))
    padded = run((np.insert(qi, at, [1, 1]), np.insert(ki, at, [5, -1]),
                  np.insert(flags, at, [0, 0])))
    skipped = run((qi[keep], ki[keep], flags[keep]))
    # q-block 1 never flushed: its rows stay zero (the kernel writes them,
    # as the wrapper does not clear the output)
    unflushed = run((qi, ki, np.where(qi == 1, flags & 1, flags)))
    torch.cuda.synchronize()
    assert flash.SM90_LAUNCHES == before + 4
    assert torch.equal(padded, base)
    assert bool((skipped[:, :, :128] == 0).all())
    assert bool((unflushed[:, :, 128:] == 0).all())
    assert torch.equal(unflushed[:, :, :128], base[:, :, :128])
    want = flash.flash_mask_plain(
        q, k, v, *(torch.as_tensor(x, device=cuda_device)
                   for x in (qi[keep], ki[keep], flags[keep])), **kw)
    torch.testing.assert_close(skipped.float(), want.float(), rtol=3e-2,
                               atol=3e-2)
    old = run((qi, ki, flags), variant="mma_sync")
    torch.cuda.synchronize()
    assert flash.SM90_LAUNCHES == before + 4
    torch.testing.assert_close(old.float(), base.float(), rtol=3e-2,
                               atol=3e-2)


F32_SM90_PATTERNS = FLASH_PATTERNS + [dict(causal=True, window=384,
                                           prefix=128)]


def f32_qkv(seed, b, hq, hkv, s_q, s_k, d, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * 0.5
            for shape in ((b, hq, s_q, d), (b, hkv, s_k, d),
                          (b, hkv, s_k, d)))


@pytest.mark.parametrize("pattern", F32_SM90_PATTERNS,
                         ids=["causal", "window", "window+prefix", "dense",
                              "wide window+prefix"])
@pytest.mark.parametrize("bq,bk", [(64, 64), (64, 128), (128, 64),
                                   (128, 128)])
@pytest.mark.parametrize("d", [64, 112, 128])
def test_flash_f32_sm90_matches_plain(cuda_device, pattern, bq, bk, d):
    """The f32 Hopper kernel (tf32 wgmma + TMA, 3xTF32) against the plain
    version within the sweep's rtol = atol = 2e-5, at GQA 4/2 heads, B 2,
    q_offset = s_k - s_q; the wrapper picks it unasked and counts it in
    SM90_LAUNCHES and F32_LAUNCHES."""
    s_q, s_k = 256, 384
    q, k, v = f32_qkv(s_q + d + bq + bk, 2, 4, 2, s_q, s_k, d, cuda_device)
    q_off = s_k - s_q
    sched = [torch.as_tensor(x, device=cuda_device) for x in
             flash.build_schedule(s_q, s_k, bq=bq, bk=bk, q_offset=q_off,
                                  **pattern)]
    kw = dict(bq=bq, bk=bk, scale=d ** -0.5, q_offset=q_off, **pattern)
    before = (flash.LAUNCHES, flash.TC_LAUNCHES, flash.SM90_LAUNCHES,
              flash.F32_LAUNCHES)
    got = flash.flash_mask_kernel(q, k, v, *sched, **kw)
    torch.cuda.synchronize()
    assert (flash.LAUNCHES, flash.TC_LAUNCHES, flash.SM90_LAUNCHES,
            flash.F32_LAUNCHES) == tuple(x + 1 for x in before)
    want = flash.flash_mask_plain(q, k, v, *sched, **kw)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_f32_sm90_worklist_edges(cuda_device, d):
    """A q-block the worklist never visits, or never flushes, stays zero
    (the kernel writes it: the output is not cleared), and out-of-range
    kv-blocks (5 and -1: the producer arrives with no bytes, the splitters
    and consumers skip them) change nothing, bit for bit."""
    q, k, v = f32_qkv(4 + d, 1, 4, 2, 256, 256, d, cuda_device)
    qi, ki, flags = flash.build_schedule(256, 256, bq=128, bk=128,
                                         causal=True, window=0, prefix=0,
                                         q_offset=0)
    kw = dict(bq=128, bk=128, scale=d ** -0.5, causal=True, window=0,
              prefix=0, q_offset=0)
    at = int(np.nonzero(qi == 1)[0][1])
    keep = qi != 0

    def run(wl):
        return flash.flash_mask_kernel(
            q, k, v, *(torch.as_tensor(x, device=cuda_device) for x in wl),
            **kw)

    before = flash.SM90_LAUNCHES
    base = run((qi, ki, flags))
    padded = run((np.insert(qi, at, [1, 1]), np.insert(ki, at, [5, -1]),
                  np.insert(flags, at, [0, 0])))
    skipped = run((qi[keep], ki[keep], flags[keep]))
    unflushed = run((qi, ki, np.where(qi == 1, flags & 1, flags)))
    torch.cuda.synchronize()
    assert flash.SM90_LAUNCHES == before + 4
    assert torch.equal(padded, base)
    assert bool((skipped[:, :, :128] == 0).all())
    assert bool((unflushed[:, :, 128:] == 0).all())
    assert torch.equal(unflushed[:, :, :128], base[:, :, :128])
    want = flash.flash_mask_plain(
        q, k, v, *(torch.as_tensor(x, device=cuda_device)
                   for x in (qi[keep], ki[keep], flags[keep])), **kw)
    torch.testing.assert_close(skipped, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [64, 112, 128])
def test_flash_f32_sm90_keeps_f32_accuracy(cuda_device, d):
    """At S 1,024 (causal, 128-blocks, GQA 4/2) the f32 Hopper kernel lies
    within 2e-6 normwise of float64, and within 2e-5 of the mma.sync f32
    kernel forced by name (which SM90_LAUNCHES does not count)."""
    s = 1024
    q, k, v = f32_qkv(d, 1, 4, 2, s, s, d, cuda_device)
    sched = [torch.as_tensor(x, device=cuda_device) for x in
             flash.build_schedule(s, s, bq=128, bk=128, causal=True,
                                  window=0, prefix=0, q_offset=0)]
    kw = dict(bq=128, bk=128, scale=d ** -0.5, causal=True, window=0,
              prefix=0, q_offset=0)
    before = flash.SM90_LAUNCHES
    got = flash.flash_mask_kernel(q, k, v, *sched, **kw)
    old = flash.flash_mask_kernel(q, k, v, *sched, variant="mma_sync", **kw)
    torch.cuda.synchronize()
    assert flash.SM90_LAUNCHES == before + 1
    ke, ve = (x.repeat_interleave(2, dim=1).double() for x in (k, v))
    sc = (q.double() @ ke.transpose(-1, -2)) * d ** -0.5
    sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool,
                                   device=cuda_device).triu(1),
                        float("-inf"))
    exact = torch.softmax(sc, -1) @ ve
    assert float((got.double() - exact).norm() / exact.norm()) <= 2e-6
    torch.testing.assert_close(got, old, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bq,bk,d", [(128, 128, 16), (32, 32, 64),
                                     (128, 128, 96), (8, 8, 64)])
def test_flash_f32_sm90_refuses_other_shapes_on_cuda(cuda_device, bq, bk, d):
    """variant="sm90" on an f32 shape the Hopper kernel does not take
    raises before any launch; unasked, the shape runs the mma.sync f32
    kernel."""
    q, k, v = f32_qkv(1, 1, 2, 1, 128, 128, d, cuda_device)
    sched = [torch.as_tensor(x, device=cuda_device) for x in
             flash.build_schedule(128, 128, bq=bq, bk=bk, causal=True,
                                  window=0, prefix=0, q_offset=0)]
    kw = dict(bq=bq, bk=bk, scale=d ** -0.5, causal=True, window=0,
              prefix=0, q_offset=0)
    before = (flash.LAUNCHES, flash.SM90_LAUNCHES, flash.F32_LAUNCHES)
    with pytest.raises(ValueError, match="sm90 flash kernel takes"):
        flash.flash_mask_kernel(q, k, v, *sched, variant="sm90", **kw)
    assert (flash.LAUNCHES, flash.SM90_LAUNCHES,
            flash.F32_LAUNCHES) == before
    got = flash.flash_mask_kernel(q, k, v, *sched, **kw)
    torch.cuda.synchronize()
    assert (flash.LAUNCHES, flash.SM90_LAUNCHES, flash.F32_LAUNCHES) == (
        before[0] + 1, before[1], before[2] + 1)
    want = flash.flash_mask_plain(q, k, v, *sched, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_op_matches_cpu(cuda_device):
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.standard_normal((2, 8, 128, 64)) * 0.3,
                        dtype=torch.float32)
    k, v = (torch.as_tensor(rng.standard_normal((2, 2, 128, 64)) * 0.3,
                            dtype=torch.float32) for _ in range(2))
    want = flash_mask_attention(q, k, v, causal=True, bq=32, bk=32)
    got = flash_mask_attention(q.to(cuda_device), k.to(cuda_device),
                               v.to(cuda_device), causal=True, bq=32, bk=32)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)


def test_lm_forward_flash_matches_dense(cuda_device):
    cfg = get_config("llama3_2_1b", smoke=True).replace(
        attn_impl="flash_pallas")
    model = T.init_params(cfg, device=cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda_device,
                           generator=torch.Generator(
                               device=cuda_device).manual_seed(1))
    before = flash.LAUNCHES
    got = T.forward(model, cfg, {"tokens": tokens})
    torch.cuda.synchronize()
    assert flash.LAUNCHES == before + cfg.n_layers
    want = T.forward(model, cfg.replace(attn_impl="dense_masked"),
                     {"tokens": tokens})
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_masked_on_cuda_matches_cpu(cuda_device, dtype):
    """block_masked attention (GQA, causal, a window and a prefix, s_q !=
    s_k) on the card against the same call on the CPU: 1e-5 in f32, 2e-2
    in bf16 (both round p to bf16; the card's products sum in another
    order, so a rounding may flip)."""
    from repro_torch.models import attention as A
    rng = np.random.default_rng(6)
    q = torch.as_tensor(rng.standard_normal((2, 8, 128, 64)) * 0.5,
                        dtype=torch.float32).to(dtype)
    k, v = (torch.as_tensor(rng.standard_normal((2, 2, 256, 64)) * 0.5,
                            dtype=torch.float32).to(dtype) for _ in range(2))
    kw = dict(causal=True, window=96, prefix=32, q_offset=128, bq=32, bk=64)
    want = A.block_masked_attention(q, k, v, **kw)
    before = (A.BLOCK_MASKED_CALLS, A.BLOCK_MASKED_FALLBACKS)
    got = A.block_masked_attention(q.to(cuda_device), k.to(cuda_device),
                                   v.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert (A.BLOCK_MASKED_CALLS, A.BLOCK_MASKED_FALLBACKS) == (
        before[0] + 1, before[1])
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


def test_moe_on_cuda_matches_cpu(cuda_device):
    """The MoE layer (64 experts, top-6, renormalised, two shared experts)
    on the card against the CPU: the same routing and outputs within
    1e-5."""
    from repro_torch.configs.base import MoECfg
    from repro_torch.models import layers as L
    cfg = get_config("deepseek_v2_lite_16b", smoke=True).replace(
        moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=32, n_shared=2,
                   d_ff_shared=32, router_scale=True))
    moe = L.MoE(cfg, torch.Generator().manual_seed(3))
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    want = moe(x, cfg)
    sizes = list(moe.group_sizes)
    moe.to(cuda_device)
    before = L.EXPERT_MATMULS
    got = moe(x.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert moe.group_sizes == sizes
    assert L.EXPERT_MATMULS - before == 3 * sum(n > 0 for n in sizes)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_mla_moe_model_on_cuda_matches_cpu(cuda_device):
    """deepseek-v2-lite SMOKE (MLA, MoE, block_masked) on the card: f32
    forward and teacher-forced decode against the same weights on the
    CPU within 1e-5."""
    cfg = get_config("deepseek_v2_lite_16b", smoke=True)
    model = T.init_params(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(5))
    want = T.forward(model, cfg, {"tokens": tokens})
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    want_step, _ = T.decode_step(model, cfg, tokens[:, 0], cache,
                                 torch.zeros(2, dtype=torch.int32))
    model.to(cuda_device)
    got = T.forward(model, cfg, {"tokens": tokens.to(cuda_device)})
    cache = T.init_cache(cfg, 2, 32, device=cuda_device)
    got_step, _ = T.decode_step(model, cfg, tokens[:, 0].to(cuda_device),
                                cache, torch.zeros(2, dtype=torch.int32,
                                                   device=cuda_device))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_step.cpu(), want_step, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch,impl", [
    ("xlstm_1_3b", "block_masked"), ("zamba2_7b", "block_masked"),
    ("zamba2_7b", "flash_pallas"), ("seamless_m4t_large_v2", "block_masked"),
    ("seamless_m4t_large_v2", "flash_pallas")])
def test_recurrent_and_encdec_models_on_cuda_match_cpu(cuda_device, arch,
                                                       impl):
    """The xLSTM, Zamba2 and encoder-decoder SMOKE models (f32) on the card
    against the same weights on the CPU: forward (under flash_pallas one
    kernel launch per attention layer) and eight teacher-forced decode
    steps (the encoder output computed once), within rtol 1e-5 and an
    atol of 1e-5 of the largest |logit|: cuBLAS and the CPU sum in other
    orders, and zamba2's residual stream grows through its layers (the
    card read 1.5e-5 at 5 of 32,768 logits of magnitude up to 4.1)."""
    cfg = get_config(arch, smoke=True).replace(attn_impl=impl)
    model = T.init_params(cfg, device="cpu")
    gen = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                     generator=gen)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(2, 32, cfg.d_frontend,
                                      generator=gen) * 0.2

    def run(dev):
        b = {k: v.to(dev) for k, v in batch.items()}
        logits = T.forward(model, cfg, b)
        enc = model.encode(b["frames"]) if "frames" in b else None
        cache = T.init_cache(cfg, 2, 32, device=dev)
        steps = [T.decode_step(model, cfg, b["tokens"][:, t], cache,
                               torch.full((2,), t, dtype=torch.int32,
                                          device=dev), encoder_out=enc)[0]
                 for t in range(8)]
        return logits, torch.stack(steps, dim=1)

    want = run("cpu")
    model.to(cuda_device)
    before = flash.LAUNCHES
    got = run(cuda_device)
    torch.cuda.synchronize()
    if impl == "flash_pallas":
        layers = (T.n_shared_attn(cfg) if cfg.family == "hybrid"
                  else cfg.n_enc_layers + cfg.n_dec_layers)
        # the forward, then the encoder once more for the decode
        assert flash.LAUNCHES - before == layers + cfg.n_enc_layers
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))


def test_monitored_engine_answers_while_the_async_worker_serves(cuda_device):
    """A monitored async engine on the card serving tile queries
    (tile-8192's generator, block 128, at n = 2048): ``/metrics`` and
    ``/health`` answer while the worker launches the fused kernel, every
    scrape parses and its completed count never runs backwards, every
    query launches the fused kernel once and equals its one-shot call."""
    import json
    import urllib.request

    from repro_torch import obs
    from repro_torch.serving import QueryEngine
    mats = [F.block_sparse(2048, 128, 0.3, 0.9, seed=s) for s in (1, 2)]
    mats.append(F.block_sparse(2048, 128, 0.6, 1.0, seed=3, mask=True))
    A, B, M = (F.csr_from_dense(x) for x in mats)
    qs = [(_revalue(A, s, ints=True), B, M) for s in range(8)]
    mon = obs.HealthMonitor(inner=obs.InMemorySink(capacity=4096))
    scrapes = []
    before = kernel.FUSED_LAUNCHES
    with QueryEngine(device=cuda_device, async_mode=True, max_batch=2,
                     max_wait_ms=1.0, cache_results=False, monitor=mon,
                     expose_port=0) as eng:
        base = eng.obs_server.url
        with obs.tracing(mon):
            tickets = [eng.submit(*q) for q in qs]
            while not all(t.done() for t in tickets) or len(scrapes) < 2:
                with urllib.request.urlopen(f"{base}/metrics",
                                            timeout=30) as r:
                    samples = obs.parse_prometheus(r.read().decode())
                with urllib.request.urlopen(f"{base}/health",
                                            timeout=30) as r:
                    status = (r.status, json.loads(r.read())["status"])
                scrapes.append(
                    (samples[("repro_serve_completed_total", ())], status))
            got = [t.result(timeout=120) for t in tickets]
        launches = kernel.FUSED_LAUNCHES - before
        assert eng.health().status in ("ok", "degraded")
    assert launches == len(qs)
    counts = [c for c, _ in scrapes]
    assert counts == sorted(counts) and counts[-1] <= len(qs)
    assert all(code == 200 and s in ("ok", "degraded")
               for _, (code, s) in scrapes)
    execs = [r for r in mon.spans() if r["name"] == "serve.exec"]
    assert {r["attrs"]["route"] for r in execs} == {"tile"}
    assert sum(r["attrs"]["size"] for r in execs) == len(qs)
    for q, g in zip(qs, got):
        _same(g, masked_spgemm(*q, device=cuda_device))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


#: bf16 gradients on the card against f32 on the CPU: the worst
#: parameter normwise, and all together (as ``chip_smoke.py``'s
#: ``TRAIN_BF16_PARAM_TOL`` / ``TRAIN_BF16_TOL``; sound runs read at most
#: 0.336 and 0.157 on the H100, a transposed cotangent 1.31 and 0.89 on
#: the CPU)
BF16_GRAD_PARAM_TOL = 0.6
BF16_GRAD_TOL = 0.3


def _bf16_grad_errors(got, want):
    """(the worst parameter's normwise distance, its name, the distance of
    all gradients together)."""
    errs, num, den = {}, 0.0, 0.0
    for n, w in want.items():
        d = float((got[n].cpu().double() - w.double()).norm())
        wn = float(w.double().norm())
        errs[n] = d / wn if wn else d
        num, den = num + d * d, den + wn * wn
    worst = max(errs, key=errs.get)
    return errs[worst], worst, (num / den) ** 0.5


def _grads(model, cfg, batch):
    for p in model.parameters():
        p.grad = None
    loss = T.loss_fn(model, cfg, batch)
    loss.backward()
    return float(loss.detach()), {
        n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
        .clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_v2_lite_16b",
                                  "internvl2_2b", "xlstm_1_3b", "zamba2_7b",
                                  "seamless_m4t_large_v2"])
def test_train_step_on_cuda_matches_cpu(cuda_device, arch):
    """One backward of every family's SMOKE config on the card against the
    CPU port on the same state and batch (f32: gradients 1e-4 normwise,
    loss 1e-5 relative); the card's bf16 gradients (the CUDA ``_bmm_f32``
    backward) against the CPU's f32 ones; then a bf16 training step on the
    card: loss within 5e-2 of the f32 one, every updated parameter
    finite."""
    import copy

    from repro_torch.launch.specs import concrete_batch
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import init_state, make_train_step
    cfg = get_config(arch, smoke=True)
    opt = AdamW(lr=1e-3, warmup=1, total_steps=10)
    cpu = init_state(cfg, opt, seed=0, device="cpu")
    card = copy.deepcopy(cpu)
    card.model.to(cuda_device)
    for d in (card.opt.m, card.opt.v):
        for n in d:
            d[n] = d[n].to(cuda_device)
    card = card._replace(opt=card.opt._replace(
        step=card.opt.step.to(cuda_device)))
    batch = concrete_batch(cfg, 2, 32, seed=1, device="cpu")
    want_loss, want = _grads(cpu.model, cfg, batch)
    got_loss, got = _grads(card.model, cfg,
                           {k: v.to(cuda_device) for k, v in batch.items()})
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    for n, w in want.items():
        den = float(w.norm())
        err = float((got[n].cpu() - w).norm())
        assert err <= 1e-4 * den if den else err == 0.0, (n, err, den)
    bcfg = cfg.replace(dtype="bfloat16")
    bbatch = concrete_batch(bcfg, 2, 32, seed=1, device=cuda_device)
    _, got16 = _grads(card.model, bcfg, bbatch)
    worst, name, total = _bf16_grad_errors(got16, want)
    assert worst <= BF16_GRAD_PARAM_TOL, (name, worst)
    assert total <= BF16_GRAD_TOL, total
    card, m = make_train_step(bcfg, opt)(card, bbatch)
    assert abs(float(m["loss"]) - want_loss) <= 5e-2 * abs(want_loss)
    assert all(bool(torch.isfinite(p).all()) for p in card.model.parameters())


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_v2_lite_16b",
                                  "zamba2_7b"])
def test_bf16_gradient_check_on_cuda_catches_a_transposed_cotangent(
        cuda_device, monkeypatch, arch):
    """The bf16 comparison above fails when ``_BmmF32``'s backward returns
    each operand's gradient transposed where its tile is square."""
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import attention as A
    sound = A._BmmF32.backward

    def faulty(ctx, g):
        return tuple(x if x is None or x.shape[-1] != x.shape[-2]
                     else x.transpose(-1, -2).contiguous()
                     for x in sound(ctx, g))
    cfg = get_config(arch, smoke=True)
    model = T.init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    _, want = _grads(model, cfg, concrete_batch(cfg, 2, 32, seed=1,
                                                device="cpu"))
    model.to(cuda_device)
    bcfg = cfg.replace(dtype="bfloat16")
    bbatch = concrete_batch(bcfg, 2, 32, seed=1, device=cuda_device)
    monkeypatch.setattr(A._BmmF32, "backward", staticmethod(faulty))
    _, got = _grads(model, bcfg, bbatch)
    worst, name, total = _bf16_grad_errors(got, want)
    assert worst > BF16_GRAD_PARAM_TOL and total > BF16_GRAD_TOL, \
        (name, worst, total)


def test_bmm_f32_backward_in_bf16_on_cuda(cuda_device):
    """``_bmm_f32`` of bf16 operands differentiates on the card: the f32
    product, and bf16 gradients equal to the f32 products of the widened
    operands up to one bf16 rounding."""
    from repro_torch.models.attention import _bmm_f32
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(4, 64, 96, generator=g, device=cuda_device)
    b = torch.randn(4, 96, 48, generator=g, device=cuda_device)
    cot = torch.randn(4, 64, 48, generator=g, device=cuda_device)
    ab, bb = (x.to(torch.bfloat16).requires_grad_(True) for x in (a, b))
    out = _bmm_f32(ab, bb)
    assert out.dtype == torch.float32
    af, bf = ab.detach().float(), bb.detach().float()
    torch.testing.assert_close(out, af @ bf, rtol=1e-5, atol=1e-4)
    ga, gb = torch.autograd.grad(out, (ab, bb), cot)
    assert ga.dtype == gb.dtype == torch.bfloat16
    torch.testing.assert_close(ga.float(), cot @ bf.transpose(1, 2),
                               rtol=2 ** -8, atol=1e-5)
    torch.testing.assert_close(gb.float(), af.transpose(1, 2) @ cot,
                               rtol=2 ** -8, atol=1e-5)


def test_flash_refuses_gradients_on_cuda(cuda_device):
    from repro_torch.models.attention import attention
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(1, 2, 64, 64, generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    before = (flash.LAUNCHES, flash.TC_LAUNCHES)
    with pytest.raises(NotImplementedError):
        attention(q, k.requires_grad_(True), v, impl="flash_pallas",
                  block=64)
    assert (flash.LAUNCHES, flash.TC_LAUNCHES) == before
    with torch.no_grad():
        out = attention(q, k, v, impl="flash_pallas", block=64)
    torch.cuda.synchronize()
    assert out.shape == q.shape and flash.TC_LAUNCHES == before[1] + 1


@pytest.fixture(scope="module")
def sharded_decodes(tmp_path_factory):
    """The one-device decode on the card of each sharded-decode case, and
    the two ranks' decode of the same weights, cache and tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks share the card")
    import sys
    from pathlib import Path
    import torch.multiprocessing as mp
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_sharded_serve_ranks as R
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tmp = tmp_path_factory.mktemp("sharded_decode")
    want = {}
    for case in R.GPU_CASES:
        cfg = R.case_config(case)
        model = T.init_params(cfg, seed=4, device="cpu")
        cache, inp = R.seeded_cache(cfg), R.inputs(cfg)
        torch.save({"params": {n: p.detach().clone() for n, p in
                               model.named_parameters()},
                    "cache": cache, "inputs": inp},
                   tmp / f"{case.replace(' ', '_')}.pt")
        logits, cache = R.decode(model.to(dev), cfg, R.on(inp, dev),
                                 R.on(cache, dev))
        want[case] = (logits.cpu(), R.on(cache, "cpu"))
    mp.spawn(R.cuda_decode_ranks, args=(2, str(tmp)), nprocs=2, join=True)
    got = [torch.load(tmp / f"cuda.{r}.pt") for r in range(2)]
    return R, want, got


@pytest.mark.parametrize("case", ["deepseek_v2_lite_16b", "zamba2_7b",
                                  "xlstm_1_3b", "seamless_m4t_large_v2",
                                  "internvl2_2b vocab=515"])
def test_sharded_decode_on_cuda_matches_one_device(sharded_decodes, case):
    from repro_torch.launch.specs import cache_layout, cache_slice
    R, want, got = sharded_decodes
    logits, cache = want[case]
    layout = cache_layout(cache, {"data": 1, "model": 2})

    class Axis:
        def __init__(self, size, index):
            self.size, self.index = size, index
    for res in got:
        res = res[case]
        scale = max(1.0, float(logits.abs().max()))
        torch.testing.assert_close(res["decode"], logits, rtol=1e-5,
                                   atol=1e-5 * scale)
        axes = {"dp": Axis(1, 0), "model": Axis(2, res["model_index"])}
        for group, leaves in cache.items():
            for name, whole in (leaves or {}).items():
                mine = cache_slice(whole, layout[group][name], axes)
                scale = max(1.0, float(mine.abs().max()))
                torch.testing.assert_close(
                    res["cache"][group][name], mine, rtol=1e-5,
                    atol=1e-5 * scale, msg=f"{case} {group}.{name}")


#: a rank of the dry run on meta and on the card, in a child process (the
#: fake process group never enters the test process): llama3.2-1b SMOKE
#: on (2, 2) as rank 0 of a fake group of 4, a train step and a prefill on
#: the flash kernel (its 16-blocks run the mma.sync kernel)
DRYRUN_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.configs.base import ShapeCfg, get_config
from repro_torch.kernels.flash_mask import kernel as flash
from repro_torch.launch import dryrun as D
cfg = get_config("llama3_2_1b", smoke=True)
out = {}
with D.fake_group(4, 0):
    for name, c, shape in (
            ("train", cfg, ShapeCfg("t", 64, 8, "train")),
            ("prefill", cfg.replace(attn_impl="flash_pallas"),
             ShapeCfg("p", 128, 8, "prefill"))):
        meta = D.run_cell(c, shape, {"data": 2, "model": 2})
        flash.LAUNCHES = 0
        card = D.run_cell(c, shape, {"data": 2, "model": 2}, device="cuda")
        out[name] = {"meta": meta, "card": card, "launches": flash.LAUNCHES}
print(json.dumps(out))
"""


def test_dryrun_rank_on_cuda_counts_what_meta_counts():
    """The dry run's rank on the card holds the storages, runs the
    products and collectives, and moves the link bytes that it predicts
    on meta; the flash kernel launches once a layer a step (the counted
    step and the timed one) and its operations are the meta count's
    ``kernel_flops``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rank runs on the card")
    import json
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    r = subprocess.run([sys.executable, "-c", DRYRUN_CHILD, src],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    n_layers = get_config("llama3_2_1b", smoke=True).n_layers
    for name, res in out.items():
        meta, card = res["meta"], res["card"]
        for k in ("argument_size_in_bytes", "state_bytes"):
            assert card["memory_analysis"][k] == \
                meta["memory_analysis"][k], (name, k)
        # the kernel's own small buffers (the flash worklist's segment
        # offsets) are the card's alone: 1 % of the peak
        assert card["memory_analysis"]["peak_bytes"] == pytest.approx(
            meta["memory_analysis"]["peak_bytes"], rel=1e-2), name
        assert card["collective_op_counts"] == meta["collective_op_counts"]
        assert card["collective_bytes_per_device"] == \
            meta["collective_bytes_per_device"]
        assert card["measured"]["step_ms"] > 0
        assert card["measured"]["max_memory_allocated"] > 0
        if name == "train":
            assert card["cost_analysis"]["flops"] == \
                meta["cost_analysis"]["flops"]
        else:
            assert meta["cost_analysis"]["kernel_flops"] > 0
            assert card["cost_analysis"]["kernel_flops"] == 0
            assert res["launches"] == 2 * n_layers
