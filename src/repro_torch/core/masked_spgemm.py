"""Row-parallel Masked SpGEMM (paper Sec. 5-6) and the BCSR tile route.

``masked_spgemm`` computes  C = M (.) (A B)  (or the complemented variant)
by running the batched row accumulators over all rows of A/M at once, like
the paper's OpenMP parallel-for over output rows.  One- vs two-phase:

  * 1P: numeric pass only; the output is allocated at the mask's size
        (output pattern is a subset of the mask pattern).
  * 2P: a symbolic pass first computes per-row output nnz; the numeric pass
        then writes into an exactly-sized allocation.

Outputs are returned mask-aligned: ``vals[i, p]`` / ``present[i, p]`` refer
to the p-th nonzero slot of mask row i (stable, sorted by construction).

Every entry point runs on ``device`` (default ``"cuda"``); pass
``device="cpu"`` to run on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import obs

from . import accumulators as acc
from .formats import (CSR, PaddedCSR, padded_from_csr, csr_from_coo,
                      _bcsr_structure, _bcsr_with_pattern, _DeviceCSR,
                      _pad_width, _padded, _slots, _upload)
from .semiring import Semiring, PLUS_TIMES

#: the batched row kernels; the BCSR tile route ("tile") runs the block
#: product instead and is planner- or caller-elected
ALGORITHMS = ("msa", "hash", "mca", "heap", "heapdot", "inner")


@dataclasses.dataclass(frozen=True)
class MaskedSpGEMMResult:
    vals: torch.Tensor       # (m, pm) mask-aligned values
    present: torch.Tensor    # (m, pm) bool
    mask_cols: torch.Tensor  # (m, pm) int32 column ids (pad = n)
    shape: Tuple[int, int]

    def to_dense(self) -> torch.Tensor:
        m, n = self.shape
        out = torch.zeros((m, n + 1), dtype=self.vals.dtype,
                          device=self.vals.device)
        cols = torch.where(self.present, self.mask_cols.long(), n)
        # absent slots all land in the dropped column n, with value 0
        out.scatter_(1, cols, torch.where(self.present, self.vals, 0))
        return out[:, :n]

    def to_csr(self) -> CSR:
        present = self.present.cpu().numpy()
        rows, slots = np.nonzero(present)
        cols = self.mask_cols.cpu().numpy()[rows, slots]
        vals = self.vals.cpu().numpy()[rows, slots]
        return csr_from_coo(rows, cols, vals, self.shape, sum_dups=False)

    @property
    def nnz(self) -> torch.Tensor:
        return self.present.sum(dtype=torch.int32)


def _rows_per_chunk(algorithm: str, *, n, wa, wb, pm,
                    complement=False) -> int:
    """Rows one chunk of ``algorithm`` (or "symbolic") may hold so that its
    tensors stay within the ``_XLA_CHUNK_ELEMS`` budget."""
    from repro_torch.kernels.masked_matmul.ops import _XLA_CHUNK_ELEMS
    if algorithm == "msa":
        per_row = n + 1 + wb
    elif algorithm == "hash":
        per_row = acc._hash_size(pm) + wb
    elif algorithm == "inner":
        per_row = pm * wa
    elif algorithm in ("heap", "heapdot"):
        per_row = wa * wb + (n + 1 if complement else pm)
    else:                       # mca and the symbolic pass
        per_row = pm + 1 + wb
    return max(1, _XLA_CHUNK_ELEMS // per_row)


def _check_algorithm(algorithm: str, complement: bool) -> None:
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if complement and algorithm == "hash":
        raise NotImplementedError(
            "hash complement: use msa (dense states) per paper Sec. 5.2")
    if complement and algorithm == "mca":
        raise NotImplementedError("MCA does not support complemented "
                                  "masks (paper Sec. 8.4)")
    if complement and algorithm == "inner":
        raise NotImplementedError("inner requires an explicit mask")


def _masked_spgemm_padded(M: PaddedCSR, A: PaddedCSR, B_or_Bt: PaddedCSR,
                          *, algorithm: str, sr: Semiring, complement: bool,
                          n_inspect: Optional[int], shape, kdim):
    """Run one row algorithm over every row, in row chunks that keep each
    chunk's tensors within the ``_XLA_CHUNK_ELEMS`` budget (rows are
    independent, so chunking leaves every result unchanged)."""
    _check_algorithm(algorithm, complement)
    m, n = shape
    Bc, Bv, Bl = B_or_Bt.cols.long(), B_or_Bt.vals, B_or_Bt.lens.long()
    Mc, Ac, Av, Al = M.cols.long(), A.cols.long(), A.vals, A.lens.long()
    rows = _rows_per_chunk(algorithm, n=n, wa=A.width, wb=B_or_Bt.width,
                           pm=M.width, complement=complement)

    if algorithm == "msa":
        def run(mc, ac, av, al):
            return acc.msa_rows(mc, ac, av, al, Bc, Bv, Bl, n, kdim, sr,
                                complement=complement)
    elif algorithm == "hash":
        def run(mc, ac, av, al):
            return acc.hash_rows(mc, ac, av, al, Bc, Bv, Bl, n, kdim, sr)
    elif algorithm == "mca":
        def run(mc, ac, av, al):
            return acc.mca_rows(mc, ac, av, al, Bc, Bv, Bl, n, kdim, sr)
    elif algorithm in ("heap", "heapdot"):
        ni = 1 if algorithm == "heap" else (0 if complement else 10 ** 9)
        ni = n_inspect if n_inspect is not None else ni

        def run(mc, ac, av, al):
            return acc.heap_rows(mc, ac, av, al, Bc, Bv, Bl, n, kdim, sr,
                                 n_inspect=ni, complement=complement)
    else:  # inner
        keys = acc.inner_keys(Bc, kdim)

        def run(mc, ac, av, al):
            return acc.inner_rows(mc, ac, av, al, Bc, Bv, Bl, n, kdim, sr,
                                  keys=keys)

    parts = [run(Mc[s:s + rows], Ac[s:s + rows], Av[s:s + rows],
                 Al[s:s + rows]) for s in range(0, max(m, 1), rows)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def masked_spgemm(A, B, M, *, algorithm: str = "auto",
                  semiring: Semiring = PLUS_TIMES, complement: bool = False,
                  two_phase: bool = False, n_inspect: Optional[int] = None,
                  widths: Optional[Tuple[int, int, int]] = None,
                  tile_block: Optional[int] = None, plan=None,
                  device="cuda"):
    """C = M (.) (A B)   [or  C = (not M) (.) (A B)].

    A, B, M: host CSR (or PaddedCSR already on a device).  Returns a
    MaskedSpGEMMResult (mask-aligned) for the normal mask; for the
    complemented mask returns (dense_vals, dense_present) since the output
    is not a subset of the mask pattern.

    ``algorithm="auto"`` (the default) consults the planner: cheap
    structural statistics pick the cheapest kernel per the paper's Sec. 7-8
    guidelines, memoized by structural signature plus the cost-model token.
    When the plan elects the BCSR tile route (``plan.algorithm == "tile"``)
    the product runs on the block product end to end — no densify anywhere
    on that path.  ``algorithm="tile"`` forces the tile route
    (``tile_block`` picks the block size; plus_times, explicit mask,
    host-CSR operands only).  A precomputed ``plan`` (from
    ``planner.plan``) overrides ``algorithm`` and ``widths``.

    ``device`` is where host-CSR operands are moved and the product runs.
    """
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {A.shape} x {B.shape}")
    if two_phase and algorithm == "tile":
        # the tile route's symbolic phase is the host schedule build; a 2P
        # padded-width pass has no meaning there
        raise NotImplementedError(
            "two_phase is not supported by the tile route (its symbolic "
            "phase is the host schedule build); use a row algorithm")
    if plan is None and algorithm == "auto":
        from .planner import plan as _plan
        plan = _plan(A, B, M, complement=complement, semiring=semiring,
                     device=device)
    if plan is not None:
        algorithm = plan.algorithm
        if algorithm == "tile" and two_phase:
            # an auto-elected tile route cannot honor two_phase: fall back
            # to the cheapest row kernel from the same plan's ranking
            algorithm = next(name for name, _ in plan.costs
                             if name != "tile")
            s = plan.stats
            if widths is None:
                widths = (s.wa, s.wbt if algorithm == "inner" else s.wb,
                          s.pm)
        if widths is None:
            widths = plan.widths
        if n_inspect is None:
            n_inspect = plan.n_inspect
        if tile_block is None and plan.tile_block:
            tile_block = plan.tile_block
    wa, wb, wm = widths or (None, None, None)

    if algorithm == "tile":
        from repro_torch.kernels.masked_matmul.ops import tile_path_supported
        if not tile_path_supported(semiring.name, complement):
            raise NotImplementedError(
                "tile route requires plus_times and an explicit mask")
        if not (isinstance(A, CSR) and isinstance(B, CSR)
                and isinstance(M, CSR)):
            raise NotImplementedError("tile route needs host CSR operands")
        return _masked_spgemm_tile(A, B, M, block_size=tile_block, wm=wm,
                                   device=device)

    with obs.span("spgemm.host_prep", algorithm=algorithm):
        A_p = (A if isinstance(A, PaddedCSR)
               else padded_from_csr(A, wa, device=device))
        M_p = (M if isinstance(M, PaddedCSR)
               else padded_from_csr(M, wm, device=device))
        B_p = _padded_b(B, algorithm, wb, device)

    if two_phase:
        # symbolic pass: exact output structure (counts).  It always walks
        # B row-major, so Inner (which multiplies against B^T) pads a
        # row-major copy just for this phase.
        if algorithm == "inner":
            B_sym = (B if isinstance(B, PaddedCSR)
                     else padded_from_csr(B, wb, device=device))
        else:
            B_sym = B_p
        symbolic_phase(A_p, M_p, B_sym, shape=(m, n), kdim=k)

    # host clock: on a CUDA device this times the kernels' dispatch
    with obs.span("spgemm.row", algorithm=algorithm, m=m, n=n):
        vals, present = _masked_spgemm_padded(
            M_p, A_p, B_p, algorithm=algorithm, sr=semiring,
            complement=complement, n_inspect=n_inspect, shape=(m, n),
            kdim=k)
    if complement:
        return vals, present
    return MaskedSpGEMMResult(vals, present, M_p.cols, (m, n))


def _padded_b(B, algorithm: str, wb: Optional[int], device) -> PaddedCSR:
    """B as the row kernels read it: B^T for inner, else B itself."""
    if algorithm == "inner":
        B = B.transpose() if isinstance(B, CSR) else B
    return (B if isinstance(B, PaddedCSR)
            else padded_from_csr(B, wb, device=device))


def symbolic_phase(A: PaddedCSR, M: PaddedCSR, B: PaddedCSR, *,
                   shape, kdim) -> torch.Tensor:
    """Two-phase symbolic pass: per-row output nnz (paper Sec. 6)."""
    m, n = shape
    Mc, Ac, Al = M.cols.long(), A.cols.long(), A.lens.long()
    Bc, Bl = B.cols.long(), B.lens.long()
    rows = _rows_per_chunk("symbolic", n=n, wa=A.width, wb=B.width,
                           pm=M.width)
    parts = [acc.symbolic_rows(Mc[s:s + rows], Ac[s:s + rows],
                               Al[s:s + rows], Bc, Bl, n, kdim)
             for s in range(0, max(m, 1), rows)]
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# BCSR tile route: block product end-to-end, densify-free
# ---------------------------------------------------------------------------


def _masked_spgemm_tile(A: CSR, B: CSR, M: CSR, *,
                        block_size: Optional[int] = None,
                        wm: Optional[int] = None,
                        device="cuda") -> MaskedSpGEMMResult:
    """Execute C = M (.) (A B) on the BCSR tile pipeline.

    Densify-free end to end: CSR operands scatter into occupied blocks,
    the host schedule replays on the block product, and the result is
    gathered straight from the output blocks into the same mask-aligned
    layout the row kernels produce.  ``present`` comes from a structural
    counting replay of the same schedule, so it is exact element-level
    structure — the row kernels' semantics, including numeric-cancellation
    cases.

    Every CSR is uploaded to ``device`` once and everything derived from
    it is built there: A's and B's value and pattern blocks from one key
    pass each, M's block structure only (nothing reads mask values), and
    the gather's addressing.  Only the block structures come back to the
    host, for the schedule.
    """
    from repro_torch.kernels.masked_matmul.ops import \
        block_spgemm_with_structure

    m, k = A.shape
    _, n = B.shape
    if M.nnz == 0:
        M_p = padded_from_csr(M, wm, device=device)
        z = torch.zeros((m, M_p.width), dtype=torch.float32, device=device)
        return MaskedSpGEMMResult(z, torch.zeros_like(z, dtype=torch.bool),
                                  M_p.cols, (m, n))
    if block_size is None:
        from .planner import ring_block_candidates
        block_size = ring_block_candidates(m, k, n)[0]
    bs = block_size
    # the host schedule waits for the device prep, so spgemm.tile covers
    # the prep; the kernel and the gather are only dispatched inside it
    with obs.span("spgemm.tile", block=bs, m=m, n=n):
        with obs.span("spgemm.host_prep", algorithm="tile"):
            Ab, a_pat = _bcsr_with_pattern(_upload(A, device), bs)
            Bb, b_pat = _bcsr_with_pattern(_upload(B, device), bs)
            Md = _upload(M, device, data=False)
            m_rows = Md.rows()
            Mb, m_pos = _bcsr_structure(Md, m_rows, bs)
        Cb, Sb = block_spgemm_with_structure(Ab, Bb, Mb, a_pattern=a_pat,
                                             b_pattern=b_pat)
        del Ab, Bb, a_pat, b_pat
        return _gather(Md, m_rows, m_pos, Cb.blocks, Sb.blocks, bs=bs, n=n,
                       width=_pad_width(M, wm))


def gather_mask_aligned(M: CSR, Mb_struct, c_blocks, s_blocks, *, n: int,
                        wm: Optional[int] = None) -> MaskedSpGEMMResult:
    """Extract a mask-aligned result from block-granular values/counts.

    ``c_blocks``/``s_blocks`` are ``(nnzb, bs, bs)`` tensors laid out in
    ``Mb_struct``'s block order (the 1P allocation: output structure ==
    mask block structure).  Mask entries whose slot lies beyond the padded
    width ``wm`` are dropped, as the reference's scatter drops them.  Runs
    on ``c_blocks``' device: M's index arrays are uploaded once and each
    entry's block is found by a search over the mask's block keys.
    """
    dev = c_blocks.device
    bs = Mb_struct.block_size
    Md = _upload(M, dev, data=False)
    rows = Md.rows()
    brow = np.repeat(np.arange(Mb_struct.block_rows, dtype=np.int64),
                     np.diff(Mb_struct.indptr))
    keys = torch.as_tensor(brow * Mb_struct.block_cols + Mb_struct.indices,
                           device=dev)
    pos = torch.searchsorted(
        keys, (rows // bs) * Mb_struct.block_cols + Md.indices // bs)
    return _gather(Md, rows, pos, c_blocks, s_blocks, bs=bs, n=n,
                   width=_pad_width(M, wm))


def _gather(Md: _DeviceCSR, rows, pos, c_blocks, s_blocks, *, bs: int,
            n: int, width: int) -> MaskedSpGEMMResult:
    """``gather_mask_aligned`` from M's device arrays, the row of every
    mask entry and the position of its block (every mask entry lies in a
    mask block by construction).  Each entry's value and count go to its
    row and slot in the given entry order, as the reference's gather puts
    them; ``mask_cols`` is ``padded_from_csr(M).cols``."""
    m = Md.shape[0]
    dest = _slots(Md, rows, width)
    mask_cols, _ = _padded(Md, rows, width, with_vals=False, dest=dest)
    src = (pos * bs + rows % bs) * bs + Md.indices % bs
    vals = torch.zeros(m * width + 1, dtype=c_blocks.dtype,
                       device=c_blocks.device)
    present = torch.zeros(m * width + 1, dtype=torch.bool,
                          device=c_blocks.device)
    vals[dest] = c_blocks.reshape(-1)[src]
    present[dest] = s_blocks.reshape(-1)[src] > 0
    return MaskedSpGEMMResult(vals[:-1].view(m, width),
                              present[:-1].view(m, width), mask_cols, (m, n))


# ---------------------------------------------------------------------------
# Batched driver: one plan and one row program for same-shape operands
# ---------------------------------------------------------------------------


def _stack_padded(mats, width: int, device) -> PaddedCSR:
    """Pad each operand to ``width`` and stack them along the rows: b
    operands of shape (m, n) give one (b * m)-row PaddedCSR whose rows
    ``i * m .. i * m + m - 1`` are operand i's.

    A batch of host CSRs becomes one host CSR and is uploaded and padded
    once; each row comes out as ``padded_from_csr`` pads it alone, so
    every row kernel reads the same row it would in a one-shot call."""
    b = len(mats)
    m, n = mats[0].shape
    if all(isinstance(x, CSR) for x in mats):
        offsets = np.cumsum([0] + [x.nnz for x in mats])
        indptr = np.concatenate(
            [x.indptr[:-1].astype(np.int64) + o
             for x, o in zip(mats, offsets)] + [offsets[-1:]])
        stacked = CSR(indptr, np.concatenate([x.indices for x in mats]),
                      np.concatenate([x.data for x in mats]), (b * m, n))
        return padded_from_csr(stacked, width, device=device)
    padded = [x if isinstance(x, PaddedCSR)
              else padded_from_csr(x, width, device=device) for x in mats]
    if len({p.width for p in padded}) != 1:
        raise ValueError("padded operands of one batch must share a width, "
                         f"got {sorted({p.width for p in padded})}")
    return PaddedCSR(torch.cat([p.cols for p in padded]),
                     torch.cat([p.vals for p in padded]),
                     torch.cat([p.lens for p in padded]), (b * m, n))


def masked_spgemm_batched(As, B, Ms, *, algorithm: str = "auto",
                          semiring: Semiring = PLUS_TIMES,
                          complement: bool = False, plan=None,
                          device="cuda"):
    """Batch of C_i = M_i (.) (A_i B) with ONE plan and ONE row program.

    ``As``/``Ms``: equal-length sequences of same-shape operands (CSR or
    PaddedCSR); ``B`` is shared.  This is the multi-source traversal case
    (betweenness centrality): per-element structures differ, but one plan,
    with pad widths widened to the batch maxima, serves every element.
    Every row kernel computes one output row from (A row, M row, B), so
    the batch is folded into the row dimension: the b operands stack into
    one (b * m)-row problem that runs as one launch sequence.

    Returns a list of MaskedSpGEMMResult (mask case), or stacked dense
    ``(vals, present)`` of shape (batch, m, n) under ``complement``.  A
    tile plan runs the tile route once per element.
    """
    As, Ms = list(As), list(Ms)
    if len(As) != len(Ms) or not As:
        raise ValueError("As/Ms must be equal-length, non-empty")
    m, k = As[0].shape
    _, n = B.shape
    if plan is None and algorithm == "auto":
        from .planner import plan_batch
        plan = plan_batch(As, B, Ms, complement=complement,
                          semiring=semiring)
    if plan is not None and plan.algorithm == "tile":
        from repro_torch.kernels.masked_matmul.ops import tile_path_supported
        if not tile_path_supported(semiring.name, complement):
            raise NotImplementedError(
                "tile route requires plus_times and an explicit mask")
        return [_masked_spgemm_tile(a, B, mm,
                                    block_size=plan.tile_block or None,
                                    wm=plan.widths[2], device=device)
                for a, mm in zip(As, Ms)]
    if plan is not None:
        algorithm = plan.algorithm
        wa, wb, wm = plan.widths
    else:
        def width(x):
            return (x.width if isinstance(x, PaddedCSR)
                    else int(x.row_nnz().max(initial=0)))

        wa = max(1, max(width(a) for a in As))
        wm = max(1, max(width(mm) for mm in Ms))
        wb = None

    b = len(As)
    A_b = _stack_padded(As, wa, device)
    M_b = _stack_padded(Ms, wm, device)
    B_p = _padded_b(B, algorithm, wb, device)
    vals, present = _masked_spgemm_padded(
        M_b, A_b, B_p, algorithm=algorithm, sr=semiring,
        complement=complement, n_inspect=None, shape=(b * m, n), kdim=k)
    if complement:
        return vals.view(b, m, n), present.view(b, m, n)
    return [MaskedSpGEMMResult(vals[i * m:(i + 1) * m],
                               present[i * m:(i + 1) * m],
                               M_b.cols[i * m:(i + 1) * m], (m, n))
            for i in range(b)]


# ---------------------------------------------------------------------------
# Dense oracle (tests): structural semantics under a semiring
# ---------------------------------------------------------------------------


def dense_oracle(a, b, m, *, semiring: Semiring = PLUS_TIMES,
                 complement: bool = False, device="cuda"):
    """Reference masked product on dense arrays.

    Returns (vals, present): present = structural nonzero AND mask allows;
    vals = semiring matmul where present (zero elsewhere).
    """
    a = torch.as_tensor(np.asarray(a), device=device)
    b = torch.as_tensor(np.asarray(b), device=device)
    m = torch.as_tensor(np.asarray(m), device=device)
    structure = ((a.abs() > 0).float() @ (b.abs() > 0).float()) > 0
    allowed = (m == 0) if complement else (m != 0)
    present = structure & allowed
    vals = semiring.matmul(a, b)
    return torch.where(present, vals, semiring.zero), present
