"""Host-side schedule construction and device dispatch for the masked
block product.

Building the schedule is the paper's symbolic phase: because the mask's block
structure bounds the output (paper §6, the 1P insight), the output
allocation and the worklist are fully determined on the host before any
device compute, so the device program is a single numeric phase.  The
construction is vectorized numpy, identical to the reference's, and so
are the distributed ring's per-stage K-slab worklists
(``build_spgemm_schedule_slab``, ``build_ring_schedules``).

``_run_schedule`` replays a worklist on the device its blocks lie on, and
``block_spgemm_with_structure`` replays it for values and structural
counts together: the CUDA kernel for CUDA tensors (one launch for both),
the plain PyTorch version for CPU tensors.
``masked_matmul`` is the tile SDDMM's entry point.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import (BCSR, bcsr_from_csr,
                                      bcsr_structure_transpose)
from .kernel import (_XLA_CHUNK_ELEMS, block_spgemm_kernel,
                     block_spgemm_with_structure_kernel, masked_matmul_kernel)

__all__ = ["Schedule", "tile_path_supported", "masked_matmul",
           "build_spgemm_schedule", "build_spgemm_schedule_slab",
           "build_ring_schedules",
           "block_spgemm", "block_spgemm_with_structure",
           "block_spgemm_from_csr", "_XLA_CHUNK_ELEMS"]

Schedule = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def tile_path_supported(semiring_name: str, complement: bool) -> bool:
    """Whether the block product can express this product.

    It accumulates with a dense block matmul, so only the plus_times
    semiring is representable, and the mask must be explicit (a
    complement's output is not bounded by the mask's block structure).
    """
    return semiring_name == "plus_times" and not complement


def masked_matmul(a, b, bi, bj, *, bm: int, bn: int, bk: int,
                  variant: Optional[str] = None) -> torch.Tensor:
    """Tile-MCA SDDMM: only mask-allowed output tiles are computed.

    a: (M, K), b: (K, N) float32 or bfloat16 tensors on one device; bi, bj:
    (nnzb,) int32 mask tile coordinates.  Returns (nnzb, bm, bn) float32.
    ``variant`` picks the kernel as ``masked_matmul_kernel``'s does.
    """
    return masked_matmul_kernel(a, b, bi, bj, bm=bm, bn=bn, bk=bk,
                                variant=variant)


# ---------------------------------------------------------------------------
# BCSR x BCSR schedule (host, vectorized)
# ---------------------------------------------------------------------------


def _empty_schedule() -> Schedule:
    z = np.zeros(0, np.int32)
    return z, z.copy(), z.copy(), z.copy()


def build_spgemm_schedule(A: BCSR, B: BCSR, M: BCSR) -> Schedule:
    """Worklist (rank, posA, posB, flags) for C = M (.) (A B) on block
    structures.

    For every mask block (i, j) [rank r in M's CSR order], the worklist
    holds one entry per block k with A[i, k] and B[k, j] both present, in
    ascending k; mask blocks with no contribution get a single zero-fill
    entry (flags real-bit = 0) so the kernel's output is fully defined.
    ``flags`` bits: 1 = first visit of rank, 2 = real product, 4 = last
    visit of rank.

    The candidate set (every (mask block, A block) pair sharing a block
    row) is expanded with segment ops, then matched against B's
    column-major structure with one searchsorted over composite
    (block-col, block-row) keys.
    """
    if M.nnzb == 0:
        return _empty_schedule()

    bt_indptr, bt_rows, bt_pos = bcsr_structure_transpose(B)

    nnzb_m = M.nnzb
    # mask block-row and block-col of every rank
    mi = np.repeat(np.arange(M.block_rows, dtype=np.int64),
                   np.diff(M.indptr))
    mj = M.indices

    # expand: one candidate per (rank, A block in block-row mi[rank])
    a_cnt = np.diff(A.indptr)
    counts = a_cnt[mi]
    total = int(counts.sum())
    rep_r = np.repeat(np.arange(nnzb_m, dtype=np.int64), counts)
    starts = np.zeros(nnzb_m, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    within = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    a_pos = A.indptr[mi[rep_r]] + within
    k = A.indices[a_pos]

    # match candidates against B's column-major structure: bt is sorted by
    # (block-col, block-row), so composite keys are globally sorted and one
    # searchsorted resolves every candidate
    kb = B.block_rows
    bt_cols = np.repeat(np.arange(B.block_cols, dtype=np.int64),
                        np.diff(bt_indptr))
    bt_key = bt_cols * kb + bt_rows
    cand_key = mj[rep_r] * kb + k
    if len(bt_key):
        pos = np.searchsorted(bt_key, cand_key)
        pos_c = np.minimum(pos, len(bt_key) - 1)
        hit = (pos < len(bt_key)) & (bt_key[pos_c] == cand_key)
    else:
        hit = np.zeros(total, dtype=bool)

    rank = rep_r[hit]                 # nondecreasing: rep_r was, filter keeps
    pa = a_pos[hit]
    pb = (bt_pos[np.minimum(pos[hit], max(0, len(bt_key) - 1))]
          if len(bt_key) else np.zeros(0, np.int64))
    real = np.ones(len(rank), dtype=np.int32)

    # zero-fill entries for mask blocks with no contribution
    per_rank = np.bincount(rank, minlength=nnzb_m)
    empty = np.nonzero(per_rank == 0)[0]
    if len(empty):
        rank = np.concatenate([rank, empty])
        pa = np.concatenate([pa, np.zeros(len(empty), np.int64)])
        pb = np.concatenate([pb, np.zeros(len(empty), np.int64)])
        real = np.concatenate([real, np.zeros(len(empty), np.int32)])
        order = np.argsort(rank, kind="stable")
        rank, pa, pb, real = rank[order], pa[order], pb[order], real[order]

    first = np.empty(len(rank), dtype=bool)
    first[:1] = True
    np.not_equal(rank[1:], rank[:-1], out=first[1:])
    last = np.empty(len(rank), dtype=bool)
    last[-1:] = True
    np.not_equal(rank[1:], rank[:-1], out=last[:-1])
    flags = first * 1 + real * 2 + last * 4
    return (rank.astype(np.int32), pa.astype(np.int32),
            pb.astype(np.int32), flags.astype(np.int32))


# ---------------------------------------------------------------------------
# K-slab schedules (the distributed sparse ring): one worklist per stage
# ---------------------------------------------------------------------------


def build_spgemm_schedule_slab(A: BCSR, B_slab: BCSR, M: BCSR,
                               k0_blocks: int) -> Schedule:
    """Worklist for C = M (.) (A[:, slab] @ B_slab), one ring stage.

    ``B_slab`` holds block rows [k0_blocks, k0_blocks + B_slab.block_rows)
    of the full B, rebased to start at 0 (its ``pb`` positions index the
    slab's own blocks).  ``pa`` positions index the full panel ``A.blocks``.
    Zero-fill semantics match ``build_spgemm_schedule``: every mask block
    gets at least one entry, so a per-stage replay's output is fully
    defined even for stages whose slab contributes nothing.
    """
    rows_slab = B_slab.block_rows
    in_slab = (A.indices >= k0_blocks) & (A.indices < k0_blocks + rows_slab)
    pos_map = np.nonzero(in_slab)[0]
    brow = np.repeat(np.arange(A.block_rows, dtype=np.int64),
                     np.diff(A.indptr))[in_slab]
    indptr_sub = np.zeros(A.block_rows + 1, dtype=np.int64)
    np.add.at(indptr_sub, brow + 1, 1)
    A_sub = BCSR(np.cumsum(indptr_sub), A.indices[in_slab] - k0_blocks,
                 A.blocks, (A.shape[0], rows_slab * A.block_size),
                 A.block_size)
    rank, pa, pb, flags = build_spgemm_schedule(A_sub, B_slab, M)
    # remap pa from slab-filtered positions back to the full panel's blocks
    # (zero-fill entries keep position 0: they never contribute)
    real = (flags >> 1) & 1
    if len(pos_map):
        pa = np.where(real == 1, pos_map[np.minimum(pa, len(pos_map) - 1)],
                      0).astype(np.int32)
    else:
        pa = np.zeros_like(pa)
    return rank, pa, pb, flags


def build_ring_schedules(A_panels, B_slabs, M_panels, *, out_pad: int
                         ) -> np.ndarray:
    """Stacked per-shard, per-stage worklists for the sparse ring.

    Returns int32 ``(p, p, 4, Ws)``: ``[d, s]`` is the worklist
    ``(rank, pa, pb, flags)`` shard ``d`` replays at ring stage ``s``,
    when it holds B K-slab ``(d - s) % p``.  All worklists are padded to
    one length ``Ws``:

    * ranks ``[nnzb(M_panel), out_pad)`` (the ring-wide output padding) get
      zero-fill entries (flags first|last, real off), so every output rank
      of a stage's replay is written;
    * trailing padding entries carry ``rank = out_pad - 1`` with all flags
      off (no write, no contribution), so rank-sortedness is preserved.
    """
    p = len(A_panels)
    if not len(B_slabs) == len(M_panels) == p:
        raise ValueError(f"{p} A panels, {len(B_slabs)} B slabs and "
                         f"{len(M_panels)} M panels do not form one ring")
    slab_rows = B_slabs[0].block_rows
    scheds = {}
    ws = 1
    for d in range(p):
        for s in range(p):
            src = (d - s) % p
            rank, pa, pb, flags = build_spgemm_schedule_slab(
                A_panels[d], B_slabs[src], M_panels[d], src * slab_rows)
            nloc = M_panels[d].nnzb
            if out_pad > nloc:
                extra = np.arange(nloc, out_pad, dtype=np.int32)
                z = np.zeros(len(extra), np.int32)
                rank = np.concatenate([rank, extra])
                pa = np.concatenate([pa, z])
                pb = np.concatenate([pb, z])
                flags = np.concatenate([flags, np.full(len(extra), 5,
                                                       np.int32)])
            scheds[d, s] = (rank, pa, pb, flags)
            ws = max(ws, len(rank))
    out = np.zeros((p, p, 4, ws), np.int32)
    out[:, :, 0, :] = max(0, out_pad - 1)
    for (d, s), parts in scheds.items():
        L = len(parts[0])
        for i, arr in enumerate(parts):
            out[d, s, i, :L] = arr
    return out


# ---------------------------------------------------------------------------
# Worklist replay
# ---------------------------------------------------------------------------


def _worklist(M: BCSR, schedule: Schedule, nnzb_a: int, nnzb_b: int,
              dev) -> torch.Tensor:
    """Validate ``schedule`` against the operands' block counts and upload
    it: one host-to-device copy of the four worklist arrays, (4, W) int32
    rows rank, pa, pb, flags."""
    rank, pa, pb, flags = schedule
    if len(rank) and (pa.min() < 0 or pa.max() >= nnzb_a
                      or pb.min() < 0 or pb.max() >= nnzb_b
                      or rank.min() < 0 or rank.max() >= M.nnzb
                      or np.any(np.diff(rank) < 0)):
        raise ValueError("worklist positions out of range or not rank-sorted")
    return torch.as_tensor(np.stack([rank, pa, pb, flags]).astype(np.int32),
                           device=dev)


def _operand(blocks: torch.Tensor, bs: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Contiguous ``dtype`` blocks; an empty operand becomes one zero block,
    because the zero-fill entries it leaves still address block 0."""
    if blocks.shape[0] == 0:
        return torch.zeros((1, bs, bs), dtype=dtype, device=blocks.device)
    return blocks.to(dtype).contiguous()


def _run_schedule(M: BCSR, schedule: Schedule, blocks_a: torch.Tensor,
                  blocks_b: torch.Tensor) -> torch.Tensor:
    """Replay ``schedule`` on the device the blocks lie on: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    bs = M.block_size
    blocks_a, blocks_b = _operand(blocks_a, bs), _operand(blocks_b, bs)
    wl = _worklist(M, schedule, blocks_a.shape[0], blocks_b.shape[0],
                   blocks_a.device)
    return block_spgemm_kernel(blocks_a, blocks_b, wl[0], wl[1], wl[2],
                               wl[3], M.nnzb)


def block_spgemm(A: BCSR, B: BCSR, M: BCSR, *,
                 schedule: Optional[Schedule] = None) -> BCSR:
    """C = M (.) (A B) at tile granularity.  Output structure == M structure
    (the 1P allocation); zero blocks are kept (callers may prune via
    ``bcsr_to_csr``).

    An all-empty mask is a defined degenerate case: the worklist is empty
    and an empty BCSR is returned without launching a kernel.  Pass a
    precomputed ``schedule`` to amortize the symbolic phase across several
    numeric replays (e.g. a values pass and a structure pass).
    """
    if not A.block_size == B.block_size == M.block_size:
        raise ValueError("operands must share one block size")
    bs = A.block_size
    shape = (M.shape[0], B.shape[1])
    if M.nnzb == 0:
        return BCSR(M.indptr.copy(), M.indices.copy(),
                    torch.zeros((0, bs, bs), dtype=torch.float32,
                                device=A.blocks.device), shape, bs)
    if schedule is None:
        schedule = build_spgemm_schedule(A, B, M)
    blocks = _run_schedule(M, schedule, A.blocks, B.blocks)
    return BCSR(M.indptr.copy(), M.indices.copy(), blocks, shape, bs)


def block_spgemm_with_structure(A: BCSR, B: BCSR, M: BCSR, *,
                                a_pattern=None, b_pattern=None
                                ) -> Tuple[BCSR, BCSR]:
    """(values, structural-counts) pair sharing ONE schedule build and, on
    CUDA, one launch of the fused kernel.

    The second BCSR replays the same worklist over the operands' 0/1
    patterns; its entries count structural contributions, so ``count > 0``
    is exact element-level presence — identical to the row kernels'
    structural semantics even when numeric cancellation produces a stored
    0.0 in the values pass.  ``a_pattern``/``b_pattern`` are optional
    (nnzb, bs, bs) 0/1 block tensors marking the operands' *stored entries*
    (the row kernels treat an explicitly stored 0.0 as structural), best
    bf16, the type the kernel reads; when omitted, value-nonzeroness of the
    blocks is used, which cannot tell a stored zero from block padding.
    """
    if not A.block_size == B.block_size == M.block_size:
        raise ValueError("operands must share one block size")
    bs = A.block_size
    shape = (M.shape[0], B.shape[1])
    if M.nnzb == 0:
        empty = torch.zeros((0, bs, bs), dtype=torch.float32,
                            device=A.blocks.device)
        return (BCSR(M.indptr.copy(), M.indices.copy(), empty, shape, bs),
                BCSR(M.indptr.copy(), M.indices.copy(), empty, shape, bs))
    schedule = build_spgemm_schedule(A, B, M)
    if a_pattern is None:
        a_pattern = A.blocks != 0
    if b_pattern is None:
        b_pattern = B.blocks != 0
    a, b = (_operand(x, bs) for x in (A.blocks, B.blocks))
    a_pat, b_pat = (_operand(x, bs, torch.bfloat16)
                    for x in (a_pattern, b_pattern))
    wl = _worklist(M, schedule, a.shape[0], b.shape[0], a.device)
    vals, struct = block_spgemm_with_structure_kernel(
        a, b, a_pat, b_pat, wl[0], wl[1], wl[2], wl[3], M.nnzb)
    return (BCSR(M.indptr.copy(), M.indices.copy(), vals, shape, bs),
            BCSR(M.indptr.copy(), M.indices.copy(), struct, shape, bs))


def block_spgemm_from_csr(A, B, M, *, block_size: int,
                          device="cuda") -> BCSR:
    """Tile path from host CSR operands.

    Densify-free: operands are scattered straight into their occupied
    blocks (``bcsr_from_csr``), so memory stays O(occupied blocks) instead
    of O(m*n).
    """
    Ab = bcsr_from_csr(A, block_size, device=device)
    Bb = bcsr_from_csr(B, block_size, device=device)
    Mb = bcsr_from_csr(M, block_size, device=device)
    return block_spgemm(Ab, Bb, Mb)
