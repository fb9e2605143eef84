"""Masked tile products: the CUDA kernels' wrappers and their plain PyTorch
versions.

``block_spgemm_kernel`` replaces the TPU kernel
``repro/kernels/masked_matmul/kernel.py::block_spgemm_kernel``.  It replays
a rank-sorted worklist ``(rank, pa, pb, flags)``: flag bit 1 zeroes the f32
accumulator, bit 2 adds ``A[pa] @ B[pb]``, bit 4 writes the accumulator to
``out[rank]``.  One CTA per (output rank, output sub-tile) walks that rank's
worklist segment on tensor cores (3xTF32, f32 accuracy), so the result needs
no atomics and is deterministic.  ``block_spgemm_with_structure_kernel``
adds, in the same launch, the replay of the worklist over the operands' 0/1
patterns (structural counts, one exact bf16 pass).  Two kernels compute it:
``csrc/block_spgemm_sm90.cu`` for Hopper (TMA loads behind mbarriers, a
producer warpgroup, two consumer warpgroups on ``wgmma``) at block size 128
with f32 operands and bf16 patterns, contiguous and 16-byte aligned
(``sm90_takes``), and ``csrc/block_spgemm.cu`` (``mma.sync``, a
``cp.async`` ring) for every other block size.

``masked_matmul_kernel`` replaces the TPU kernel
``repro/kernels/masked_matmul/kernel.py::masked_matmul_kernel``, the tile
SDDMM ``out[r] = A[bi[r] row panel] @ B[bj[r] column panel]``: bf16
operands in one tensor-core pass, f32 operands in three TF32 passes of
split operands (3xTF32, f32 accuracy), each tile summed over all of K by
one CTA.  Two kernels compute it: ``csrc/masked_matmul_sm90.cu`` for Hopper
(persistent CTAs, TMA loads behind mbarriers, a producer warpgroup, two
consumer warpgroups on ``wgmma``) at 128 x 128 blocks with f32 or bf16
operands, contiguous, 16-byte aligned, with rows of a multiple of 16 bytes
(``masked_matmul_sm90_takes``), and ``csrc/masked_matmul.cu`` (``mma.sync``,
a ``cp.async`` ring, one CTA per mask tile and output sub-tile) for every
other shape; ``choose_masked_matmul_variant`` picks one.

The note at the top of each source gives its bound on an H100.  Each
wrapper launches its kernel for CUDA tensors (or raises) and runs its plain
version for CPU tensors; ``LAUNCHES``, ``FUSED_LAUNCHES`` and
``MASKED_MATMUL_LAUNCHES`` count the launches, ``SM90_LAUNCHES`` those of
the block product's (values only or fused) that ran the Hopper kernel and
``MASKED_MATMUL_SM90_LAUNCHES`` those of the SDDMM that did.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: peak f32 elements the plain version materializes per worklist chunk
#: (~64 MB); the row route's batch budget reuses it
_XLA_CHUNK_ELEMS = 1 << 24

#: number of times the block_spgemm kernel was launched for values only in
#: this process
LAUNCHES = 0
#: number of times it was launched for values and structure together
FUSED_LAUNCHES = 0
#: of the block_spgemm launches (values only and fused), those that ran
#: the Hopper kernel (wgmma + TMA)
SM90_LAUNCHES = 0
#: number of times a masked_matmul kernel was launched in this process
MASKED_MATMUL_LAUNCHES = 0
#: of the masked_matmul launches, those that ran the Hopper kernel (wgmma +
#: TMA)
MASKED_MATMUL_SM90_LAUNCHES = 0

#: the kernels a caller may ask for by name (``variant=``), of the block
#: product and of the SDDMM alike: the Hopper kernel, or the mma.sync one
#: (block_spgemm.cu, masked_matmul.cu)
VARIANTS = ("sm90", "mma_sync")
#: the one block size the Hopper kernel takes (the planner's largest tile
#: block)
SM90_BLOCK = 128
#: the SDDMM blocks (bm = bn) the Hopper SDDMM kernel takes (the path's)
MASKED_MATMUL_SM90_BLOCK = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signatures: pointers, then ints, then the stream
_BLOCK_SPGEMM_ARGS = [_P] * 7 + [_I] * 4 + [_P]
_FUSED_ARGS = [_P] * 10 + [_I] * 4 + [_P]
#: masked_matmul's, which masked_matmul_sm90 shares
_MASKED_MATMUL_ARGS = [_P] * 5 + [_I] * 7 + [_P]


def _check(a_blocks, b_blocks, rank, pa, pb, flags, nnzb_out):
    for name, x in (("a_blocks", a_blocks), ("b_blocks", b_blocks)):
        if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (nnzb, bs, bs) "
                             f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    bs = a_blocks.shape[1]
    if a_blocks.shape[2] != bs or b_blocks.shape[1:] != (bs, bs):
        raise ValueError(f"block shapes differ: {tuple(a_blocks.shape)} vs "
                         f"{tuple(b_blocks.shape)}")
    W = rank.shape[0]
    for name, x in (("rank", rank), ("pa", pa), ("pb", pb),
                    ("flags", flags)):
        if (x.dtype != torch.int32 or x.dim() != 1 or x.shape[0] != W
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({W},) int32 "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
    dev = a_blocks.device
    if any(x.device != dev for x in (b_blocks, rank, pa, pb, flags)):
        raise ValueError("all operands must lie on one device")
    if nnzb_out < 0:
        raise ValueError(f"nnzb_out must be >= 0, got {nnzb_out}")


def _check_patterns(a_blocks, b_blocks, a_pat, b_pat):
    for name, x, like in (("a_pat", a_pat, a_blocks),
                          ("b_pat", b_pat, b_blocks)):
        if (x.dtype not in (torch.bfloat16, torch.float32)
                or x.shape != like.shape or not x.is_contiguous()
                or x.device != like.device):
            raise ValueError(f"{name} must be a contiguous bfloat16 or "
                             f"float32 tensor of shape {tuple(like.shape)} "
                             f"on {like.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def block_spgemm_plain(a_blocks, b_blocks, rank, pa, pb, flags,
                       nnzb_out: int) -> torch.Tensor:
    """Plain version: gather, batched f32 matmul, rank segment-add weighted
    by the real bit, chunked at ``_XLA_CHUNK_ELEMS``.

    Chunks are independent partial sums into the same output (the
    segment-add is associative), so the first/last flags are irrelevant:
    an entry without the real bit adds nothing, and a rank no entry writes
    stays zero.
    """
    bs = a_blocks.shape[1]
    out = torch.zeros((nnzb_out, bs, bs), dtype=torch.float32,
                      device=a_blocks.device)
    W = int(rank.shape[0])
    chunk = max(1, _XLA_CHUNK_ELEMS // (bs * bs))
    for s in range(0, W, chunk):
        e = min(W, s + chunk)
        real = ((flags[s:e] >> 1) & 1).to(torch.float32)
        prods = torch.bmm(a_blocks[pa[s:e].long()],
                          b_blocks[pb[s:e].long()])
        out.index_add_(0, rank[s:e].long(), prods * real[:, None, None])
    return out


def sm90_takes(a_blocks, b_blocks, a_pat=None, b_pat=None) -> bool:
    """Whether the Hopper kernel takes these operands, as the kernel
    receives them (the patterns after the wrapper's cast to bfloat16):
    block size 128, float32 values and bfloat16 patterns, each contiguous
    with a 16-byte aligned base pointer (the outputs, which the wrapper
    allocates, are both)."""
    pats = () if a_pat is None else (a_pat, b_pat)
    return (a_blocks.dim() == 3 and a_blocks.shape[1] == SM90_BLOCK
            and a_blocks.dtype == b_blocks.dtype == torch.float32
            and all(x.dtype == torch.bfloat16 for x in pats)
            and all(x.is_contiguous() and x.data_ptr() % 16 == 0
                    for x in (a_blocks, b_blocks) + pats))


def choose_variant(variant, a_blocks, b_blocks, a_pat=None,
                   b_pat=None) -> str:
    """The kernel a launch runs: ``variant`` if given (one of ``VARIANTS``;
    "sm90" on operands that ``sm90_takes`` refuses raises), else "sm90"
    where ``sm90_takes`` holds and "mma_sync" elsewhere."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"unknown block_spgemm variant {variant!r}; "
                         f"expected one of {VARIANTS} or None")
    fits = sm90_takes(a_blocks, b_blocks, a_pat, b_pat)
    if variant == "sm90" and not fits:
        raise ValueError(
            f"the sm90 block_spgemm kernel takes block size {SM90_BLOCK}, "
            f"float32 values and bfloat16 patterns, contiguous and 16-byte "
            f"aligned; got blocks {tuple(a_blocks.shape)} "
            f"{a_blocks.dtype}" + ("" if a_pat is None else
                                   f", patterns {a_pat.dtype}"))
    if variant is None:
        return "sm90" if fits else "mma_sync"
    return variant


def _launch_block_spgemm(entry, argtypes, blocks, rank, pa, pb, flags,
                         nnzb_out, chosen):
    """Launch the C entry point ``<library>_<entry>`` of kernel ``chosen``'s
    library (``block_spgemm_sm90`` or ``block_spgemm``) on the current
    stream with ``blocks`` (the operand pointers, in order) and one output
    per operand pair; returns the outputs."""
    a_blocks = blocks[0]
    bs, dev = a_blocks.shape[1], a_blocks.device
    if dev.type != "cuda":
        raise ValueError(f"no block_spgemm kernel for device {dev}")
    outs = [torch.empty((nnzb_out, bs, bs), dtype=torch.float32, device=dev)
            for _ in range(len(blocks) // 2)]
    if nnzb_out == 0:
        return outs
    # segment offsets of the rank-sorted worklist, on the device
    seg_ptr = torch.searchsorted(
        rank, torch.arange(nnzb_out + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    lib = "block_spgemm_sm90" if chosen == "sm90" else "block_spgemm"
    fn = _build.load(lib, f"{lib}_{entry}", argtypes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(x.data_ptr() for x in blocks), pa.data_ptr(),
                 pb.data_ptr(), flags.data_ptr(), seg_ptr.data_ptr(),
                 *(o.data_ptr() for o in outs), nnzb_out, bs,
                 a_blocks.shape[0], blocks[1].shape[0], stream)
    if err != 0:
        raise RuntimeError(f"block_spgemm kernel ({chosen}) launch failed: "
                           f"CUDA error {err}")
    return outs


def block_spgemm_kernel(a_blocks, b_blocks, rank, pa, pb, flags,
                        nnzb_out: int, variant: str = None) -> torch.Tensor:
    """Masked BCSR product from a worklist sorted by rank.

    a_blocks: (nnzb_a, bs, bs) f32; b_blocks: (nnzb_b, bs, bs) f32.
    rank/pa/pb/flags: (W,) int32 — output block rank, A/B block positions,
    and the flag bitfield (1 = zero the accumulator, 2 = real product,
    4 = write the accumulator).  Returns (nnzb_out, bs, bs) f32.

    CPU tensors run ``block_spgemm_plain``.  CUDA tensors launch a kernel
    on the current stream without synchronising, or raise:
    ``choose_variant`` picks it (``variant`` None: the Hopper kernel where
    ``sm90_takes`` holds, else the mma.sync kernel; "mma_sync" forces the
    latter; "sm90" on operands it does not take raises, on the CPU too).
    Positions out of range are skipped by the kernels instead of faulting;
    callers validate them on the host.
    """
    global LAUNCHES, SM90_LAUNCHES
    _check(a_blocks, b_blocks, rank, pa, pb, flags, nnzb_out)
    chosen = choose_variant(variant, a_blocks, b_blocks)
    if a_blocks.device.type == "cpu":
        return block_spgemm_plain(a_blocks, b_blocks, rank, pa, pb, flags,
                                  nnzb_out)
    out, = _launch_block_spgemm("f32", _BLOCK_SPGEMM_ARGS,
                                (a_blocks, b_blocks), rank, pa, pb, flags,
                                nnzb_out, chosen)
    if nnzb_out:
        LAUNCHES += 1
        if chosen == "sm90":
            SM90_LAUNCHES += 1
    return out


def block_spgemm_with_structure_plain(a_blocks, b_blocks, a_pat, b_pat,
                                      rank, pa, pb, flags, nnzb_out: int):
    """Plain version of the fused replay: ``block_spgemm_plain`` over the
    values, then over the patterns in f32.  Returns (values, counts)."""
    return (block_spgemm_plain(a_blocks, b_blocks, rank, pa, pb, flags,
                               nnzb_out),
            block_spgemm_plain(a_pat.float(), b_pat.float(), rank, pa, pb,
                               flags, nnzb_out))


def block_spgemm_with_structure_kernel(a_blocks, b_blocks, a_pat, b_pat,
                                       rank, pa, pb, flags, nnzb_out: int,
                                       variant: str = None):
    """The masked BCSR product and its structural counts from one worklist.

    As ``block_spgemm_kernel``, plus ``a_pat`` and ``b_pat``: bf16 (or
    f32) blocks of the shapes of ``a_blocks`` and ``b_blocks`` holding 1 at
    the operands' stored entries and 0 elsewhere.  Returns (values,
    counts), both (nnzb_out, bs, bs) f32, where counts replays the worklist
    over the patterns: ``counts > 0`` is element-level structural presence.

    CPU tensors run ``block_spgemm_with_structure_plain``.  CUDA tensors
    launch one kernel for both on the current stream without
    synchronising, or raise; ``variant`` picks it as in
    ``block_spgemm_kernel``, on the patterns as the kernel reads them.  The
    kernels read the patterns in bf16 (f32 ones are converted first, one
    more pass over them) and count exactly while they hold integers up to
    256 in magnitude.
    """
    global FUSED_LAUNCHES, SM90_LAUNCHES
    _check(a_blocks, b_blocks, rank, pa, pb, flags, nnzb_out)
    _check_patterns(a_blocks, b_blocks, a_pat, b_pat)
    if a_blocks.device.type == "cpu":
        if variant is not None:      # checked as the kernel would get them
            choose_variant(variant, a_blocks, b_blocks,
                           *(x.to(torch.bfloat16) for x in (a_pat, b_pat)))
        return block_spgemm_with_structure_plain(
            a_blocks, b_blocks, a_pat, b_pat, rank, pa, pb, flags, nnzb_out)
    a_pat, b_pat = (x.to(torch.bfloat16) for x in (a_pat, b_pat))
    chosen = choose_variant(variant, a_blocks, b_blocks, a_pat, b_pat)
    vals, counts = _launch_block_spgemm(
        "with_structure", _FUSED_ARGS,
        (a_blocks, b_blocks, a_pat, b_pat), rank, pa, pb, flags, nnzb_out,
        chosen)
    if nnzb_out:
        FUSED_LAUNCHES += 1
        if chosen == "sm90":
            SM90_LAUNCHES += 1
    return vals, counts


# ---------------------------------------------------------------------------
# Tile SDDMM:  out[r] = A[bi[r], :] @ B[:, bj[r]]   for each mask tile r
# ---------------------------------------------------------------------------


def _check_sddmm(a, b, bi, bj, bm, bn, bk):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a (M, K) and b (K, N) do not chain: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"a and b must both be float32 or bfloat16, got "
                         f"{a.dtype} and {b.dtype}")
    M, K = a.shape
    N = b.shape[1]
    if min(bm, bn, bk) < 1 or M % bm or N % bn or K % bk:
        raise ValueError(f"blocks ({bm}, {bn}, {bk}) must divide "
                         f"(M, N, K) = ({M}, {N}, {K})")
    nnzb = bi.shape[0]
    for name, x in (("bi", bi), ("bj", bj)):
        if x.dtype != torch.int32 or x.dim() != 1 or x.shape[0] != nnzb:
            raise ValueError(f"{name} must be a ({nnzb},) int32 tensor, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if any(x.device != a.device for x in (b, bi, bj)):
        raise ValueError("all operands must lie on one device")


def masked_matmul_plain(a, b, bi, bj, *, bm: int, bn: int) -> torch.Tensor:
    """Plain version: gather A's row panels and B's column panels, then one
    batched f32 matmul.  Returns (nnzb, bm, bn) f32."""
    rows = bi.long()[:, None] * bm + torch.arange(bm, device=a.device)
    cols = bj.long()[:, None] * bn + torch.arange(bn, device=a.device)
    a_pan = a.float()[rows]                        # (nnzb, bm, K)
    b_pan = b.float()[:, cols].permute(1, 0, 2)    # (nnzb, K, bn)
    return torch.bmm(a_pan, b_pan)


def masked_matmul_sm90_takes(a, b, bm: int, bn: int) -> bool:
    """Whether the Hopper SDDMM kernel takes these operands, as the kernel
    receives them (after the wrapper's ``contiguous``): 128 x 128 blocks,
    ``a`` (M, K) and ``b`` (K, N) both float32 or both bfloat16, each
    contiguous with a 16-byte aligned base pointer and rows of a multiple
    of 16 bytes (TMA's rules: K and N multiples of 4 in f32, of 8 in
    bf16)."""
    return (bm == bn == MASKED_MATMUL_SM90_BLOCK
            and a.dim() == b.dim() == 2
            and a.dtype == b.dtype
            and a.dtype in (torch.float32, torch.bfloat16)
            and all(x.is_contiguous() and x.data_ptr() % 16 == 0
                    and (x.shape[1] * x.element_size()) % 16 == 0
                    for x in (a, b)))


def choose_masked_matmul_variant(variant, a, b, bm: int, bn: int) -> str:
    """The SDDMM kernel a launch runs: ``variant`` if given (one of
    ``VARIANTS``; "sm90" on operands that ``masked_matmul_sm90_takes``
    refuses raises), else "sm90" where it holds and "mma_sync" elsewhere."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"unknown masked_matmul variant {variant!r}; "
                         f"expected one of {VARIANTS} or None")
    fits = masked_matmul_sm90_takes(a, b, bm, bn)
    if variant == "sm90" and not fits:
        raise ValueError(
            f"the sm90 masked_matmul kernel takes blocks "
            f"{MASKED_MATMUL_SM90_BLOCK} x {MASKED_MATMUL_SM90_BLOCK} and "
            f"float32 or bfloat16 operands, contiguous, 16-byte aligned, "
            f"with rows of a multiple of 16 bytes; got blocks ({bm}, {bn}), "
            f"a {a.dtype} {tuple(a.shape)}, b {b.dtype} {tuple(b.shape)}")
    if variant is None:
        return "sm90" if fits else "mma_sync"
    return variant


def masked_matmul_kernel(a, b, bi, bj, *, bm: int, bn: int, bk: int,
                         variant: str = None) -> torch.Tensor:
    """C_tiles[r] = (A @ B) tile (bi[r], bj[r]); only allowed tiles computed.

    a: (M, K), b: (K, N), both float32 or both bfloat16, with
    M % bm == N % bn == K % bk == 0.  bi, bj: (nnzb,) int32 mask tile
    coordinates.  Returns (nnzb, bm, bn) float32.

    CPU tensors run ``masked_matmul_plain``.  CUDA tensors launch a kernel
    on the current stream without synchronising, or raise:
    ``choose_masked_matmul_variant`` picks it (``variant`` None: the Hopper
    kernel where ``masked_matmul_sm90_takes`` holds, else the mma.sync
    kernel; "mma_sync" forces the latter; "sm90" on operands it does not
    take raises, on the CPU too).  The kernels loop over all of K in chunks
    of their own, so ``bk`` only has to divide K, as the reference
    requires; a tile whose coordinates lie outside A or B comes out as
    zeros.
    """
    global MASKED_MATMUL_LAUNCHES, MASKED_MATMUL_SM90_LAUNCHES
    _check_sddmm(a, b, bi, bj, bm, bn, bk)
    dev = a.device
    if dev.type == "cpu":
        if variant is not None:      # checked as the kernel would get them
            choose_masked_matmul_variant(variant, a.contiguous(),
                                         b.contiguous(), bm, bn)
        return masked_matmul_plain(a, b, bi, bj, bm=bm, bn=bn)
    if dev.type != "cuda":
        raise ValueError(f"no masked_matmul kernel for device {dev}")
    a, b, bi, bj = (x.contiguous() for x in (a, b, bi, bj))
    chosen = choose_masked_matmul_variant(variant, a, b, bm, bn)
    nnzb = bi.shape[0]
    out = torch.empty((nnzb, bm, bn), dtype=torch.float32, device=dev)
    if nnzb == 0:
        return out
    M, K = a.shape
    dtype = 0 if a.dtype == torch.float32 else 1
    lib = "masked_matmul_sm90" if chosen == "sm90" else "masked_matmul"
    fn = _build.load(lib, lib, _MASKED_MATMUL_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), bi.data_ptr(), bj.data_ptr(),
                 out.data_ptr(), nnzb, M, K, b.shape[1], bm, bn, dtype, stream)
    if err != 0:
        raise RuntimeError(f"masked_matmul kernel ({chosen}) launch failed: "
                           f"CUDA error {err}")
    MASKED_MATMUL_LAUNCHES += 1
    if chosen == "sm90":
        MASKED_MATMUL_SM90_LAUNCHES += 1
    return out
