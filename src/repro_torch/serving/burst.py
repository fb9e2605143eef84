"""Structure-compiled burst programs: the serving layer's fast path.

A same-structure bucket (shared B values, shared A/M sparsity, values of A
varying per query, the burst case) re-derives NOTHING per query: the
Gustavson product structure restricted to the mask is compiled ONCE into a
flat gather program (lane tables, built on the host and uploaded to the
device once per program), and each query is then

    acc[slot] = sr.add(acc[slot], sr.mul(a_values[IA[l, slot]], BV[l, slot]))

for lane l = 0, 1, ..., one gather and one fused multiply-add over every
slot of every query of the bucket per lane.  The lanes are folded in a
fixed order by a Python loop, never by ``index_add_``/``scatter_add_``,
whose CUDA atomics add in no fixed order.

Bitwise contract: MSA, Hash and MCA all accumulate each output slot by the
identical sequence: start from ``sr.zero``, then add the products in
ascending-k order, each as one fused multiply-add under plus_times
(``Semiring.mul_add``; the reference's compiled fold contracts it the same
way).  The replay performs that same sequence (products sorted by (slot,
k); padded lanes add ``sr.zero`` times a zero value, which leaves the slot
unchanged), so its results are bitwise the row kernels'.  Heap and Inner
fold in other orders and stay on the batched row driver.

``present`` is pure structure (a slot is present iff >= 1 structural
product hits it) and is computed once per program, shared by every query.

Delta lifecycle: a row-local delta (A and/or M rows changed, B's structure
equal) re-emits only the changed rows' lane columns
(``BurstProgram.patched``).  They are built on the host, uploaded alone,
and written with ``index_copy_`` into a device copy of the parent's
tables, which stay untouched in the parent.  Because products stay
globally ordered by (slot, ascending k), a patched program's tables, and
so its results, are bit for bit the cold rebuild's.  A cold-built
program keeps its ``BG`` table (the B position of every lane) on the
host; its first patch uploads it, once.  Apart from that, tables of the
full size move only where a patch cannot apply (the lane count or the
mask width grew, or B's structure changed) and the program is rebuilt.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import caches
from repro_torch import obs
from repro_torch.core.formats import (CSR, _expand_rows, _to_device,
                                      padded_from_csr)
from repro_torch.core.masked_spgemm import MaskedSpGEMMResult
from repro_torch.core.planner import structure_signature
from repro_torch.core.semiring import Semiring

#: plan algorithms whose accumulation order the replay reproduces exactly
SEQ_SCATTER_ALGOS = ("msa", "hash", "mca")

#: caps beyond which the replay falls back to the row kernels: L bounds the
#: per-slot add chain (very dense product columns), F the gather footprint
MAX_PRODUCTS_PER_SLOT = 128
MAX_TOTAL_PRODUCTS = 1 << 22

#: burst programs, keyed by (A structure, B content, M structure,
#: semiring, pad width, device); $REPRO_BURST_PROG_CAP overrides the
#: capacity.  Each holds its lane tables on its device.
_programs = caches.LRUCache("serve-burst-programs", 64,
                            env_var="REPRO_BURST_PROG_CAP")

#: lane-PATCHED programs (delta path), same key shape as ``_programs`` but
#: capped separately so a churning delta stream cannot evict the cold-built
#: programs of stable structures; $REPRO_LANE_PATCH_CAP overrides.  Each
#: holds device tables of its parent's size.
_patches = caches.LRUCache("serve-lane-patches", 32,
                           env_var="REPRO_LANE_PATCH_CAP")

#: delta lineage: post-delta program key -> (parent program, changed rows),
#: recorded by the engine's ``submit_delta``; lets ``get_program`` re-derive
#: an evicted patched program from its parent instead of building cold.
#: An entry keeps its parent (and the parent's device tables) alive;
#: $REPRO_DELTA_LINEAGE_CAP overrides the capacity
_lineage = caches.LRUCache("serve-delta-lineage", 16,
                           env_var="REPRO_DELTA_LINEAGE_CAP")


def _padded_nnz(nnz: int) -> int:
    """Quantized value-vector length (power-of-two bucket >= nnz + 1).

    ``BurstProgram.run`` zero-pads every query's values to this length.
    The +1 reserves the pad-lane sentinel slot (``IA`` points pad lanes at
    index ``nnz``, which must read 0.0)."""
    return max(256, 1 << nnz.bit_length())


def _row_sort_perm(x: CSR) -> np.ndarray:
    """Permutation mapping ``x.sorted_rows()`` entry order back to ``x.data``
    (the kernels run on ``padded_from_csr``, which sorts rows first)."""
    rows = _expand_rows(x.indptr)
    return np.lexsort((x.indices, rows))


def _expand_products(a_rows: np.ndarray, a_cols: np.ndarray,
                     a_pos: np.ndarray, B_s: CSR, M_s: CSR,
                     pm: int, n: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gustavson expansion of the given A entries restricted to the mask.

    Returns ``(slot, a_gather, b_gather)`` sorted by (slot, ascending k):
    one product per (A entry at (r, k)) x (B entry at (k, c)) with (r, c)
    in M.  ``a_gather`` indexes A's data order (via ``a_pos``), ``b_gather``
    indexes ``B_s.data``.  The (slot, k) sort is the bitwise contract.
    """
    b_cnt = np.diff(B_s.indptr)[a_cols]
    ge_a = np.repeat(np.arange(len(a_cols)), b_cnt)       # index into entries
    ge_b = (np.repeat(B_s.indptr[a_cols], b_cnt)
            + (np.arange(b_cnt.sum()) - np.repeat(
                np.cumsum(b_cnt) - b_cnt, b_cnt)))        # index into B_s
    pr = a_rows[ge_a]                                     # product row
    pk = a_cols[ge_a]                                     # contraction index
    pc = B_s.indices[ge_b]                                # product col
    # mask membership -> slot (position within the sorted mask row),
    # via one searchsorted over the globally sorted (row, col) keys
    mkey = (_expand_rows(M_s.indptr).astype(np.int64) * (n + 1)
            + M_s.indices)
    q = pr.astype(np.int64) * (n + 1) + pc
    pos = np.searchsorted(mkey, q)
    posc = np.minimum(pos, max(len(mkey) - 1, 0))
    hit = (mkey[posc] == q) if len(mkey) else np.zeros(len(q), bool)
    keep = np.nonzero(hit)[0]
    slot = (pr[keep] * pm
            + (posc[keep] - M_s.indptr[pr[keep]])).astype(np.int64)
    kk = pk[keep]
    order = np.lexsort((kk, slot))                        # ascending k / slot
    return slot[order], a_pos[ge_a[keep][order]], ge_b[keep][order]


def _lane_tables(slot: np.ndarray, a_gather: np.ndarray,
                 b_gather: np.ndarray, b_data: np.ndarray, nslots: int,
                 n_lanes: Optional[int], nnz_a: int, zero: float
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(IA, BV, BG, counts) lane tables, laid out (n_lanes, nslots).

    IA[l] indexes the query's value vector (pad lanes -> the sentinel
    ``nnz_a``, which reads 0.0), BV[l] holds B's values (pad lanes carry
    ``zero``), BG[l] the position in sorted-B data each BV came from (-1
    for pads; a B-values patch regathers through it), counts the products
    per slot.  ``n_lanes=None`` sizes the tables to the longest chain; a
    patch passes the parent's lane count so the spliced columns fit.
    """
    F = len(slot)
    counts = np.zeros(nslots + 1, np.int64)
    np.add.at(counts, slot + 1, 1)
    starts = np.cumsum(counts)[:-1]
    L = int(counts[1:].max(initial=0))
    if n_lanes is None:
        n_lanes = max(L, 1)
    elif L > n_lanes:
        raise _TooLarge()
    P = np.full((nslots, n_lanes), F, np.int64)
    lane = np.arange(F) - starts[slot]
    P[slot, lane] = np.arange(F)
    IA = np.concatenate([a_gather.astype(np.int32),
                         np.full((1,), nnz_a, np.int32)])[P].T.copy()
    BV = np.concatenate([b_data[b_gather].astype(np.float32),
                         np.full((1,), zero, np.float32)])[P].T.copy()
    BG = np.concatenate([b_gather.astype(np.int32),
                         np.full((1,), -1, np.int32)])[P].T.copy()
    return IA, BV, BG, counts[1:]


class _TooLarge(Exception):
    """Structure exceeds the replay caps; callers fall back silently."""


class BurstProgram:
    """One compiled structure: executes any batch of value vectors for A
    on ``device``."""

    def __init__(self, A: CSR, B: CSR, M: CSR, semiring: Semiring,
                 wm: int = None, device="cuda"):
        from .cache import content_fingerprint  # deferred: no import cycle
        m, k = A.shape
        _, n = B.shape
        self.shape = (m, n)
        self.k = k
        self.nnz_a = A.nnz
        self.semiring = semiring
        self.wm = wm
        self.device = torch.device(device)
        #: host bytes a patch uploaded to make this program (None: built
        #: cold, every table uploaded whole)
        self.patch_bytes = None
        # delta-patch identity of the operands the lanes were built from
        self._a_indptr = A.indptr.copy()
        self._m_indptr = M.indptr.copy()
        self._b_sig = structure_signature(B)
        self._b_fp = content_fingerprint(B)

        a_perm = _row_sort_perm(A)          # kernels see sorted rows
        self._a_inv = np.empty(A.nnz, np.int64)
        self._a_inv[a_perm] = np.arange(A.nnz)
        a_rows = _expand_rows(A.indptr)[a_perm]
        a_cols = A.indices[a_perm]

        M_s = M.sorted_rows()
        M_p = padded_from_csr(M, wm, device=self.device)
        self.pm = pm = M_p.width
        self.mask_cols = M_p.cols

        # B's structure is pinned for the program's lifetime (patches check
        # the signature): keep the row-sort permutation so a patch takes
        # B's sorted view as a gather instead of a lexsort
        self._b_perm = _row_sort_perm(B)
        self._b_sorted_idx = B.indices[self._b_perm]
        B_s = CSR(B.indptr, self._b_sorted_idx, B.data[self._b_perm],
                  B.shape)
        slot, a_gather, b_gather = _expand_products(
            a_rows, a_cols, a_perm, B_s, M_s, pm, n)
        if len(slot) > MAX_TOTAL_PRODUCTS:
            raise _TooLarge()
        if int(np.bincount(slot, minlength=1).max()) > MAX_PRODUCTS_PER_SLOT:
            raise _TooLarge()
        self.n_products = len(slot)

        IA, BV, BG, counts = _lane_tables(
            slot, a_gather, b_gather, B_s.data, m * pm, None, A.nnz,
            semiring.zero)
        self.max_chain = IA.shape[0] if self.n_products else 0
        present = counts.reshape(m, pm) > 0
        present &= M_p.cols.cpu().numpy() < n            # pad slots absent
        self.present = _to_device(present, self.device)
        self._IA = _to_device(IA, self.device)
        self._BV = _to_device(BV, self.device)
        # BG serves only patches: it stays on the host until this
        # program's first patch uploads it
        self._BG = BG

    def device_bytes(self) -> int:
        """Bytes of the device tensors this program references: its lane
        tables (``BG`` once a patch has uploaded it), ``present`` and
        ``mask_cols`` (which a patch may share with its parent)."""
        return sum(t.numel() * t.element_size() for t in (
            self._IA, self._BV, self._BG, self.present, self.mask_cols)
            if isinstance(t, torch.Tensor))

    def run(self, As) -> list:
        """Serve a batch of same-structure A's: one upload of their values,
        then the lanes folded in order over the whole batch.  On a CUDA
        device the call ends in a synchronise."""
        sr = self.semiring
        m, _ = self.shape
        with obs.span("burst.run", size=len(As)):
            stack = np.zeros((len(As), _padded_nnz(self.nnz_a)), np.float32)
            for i, a in enumerate(As):
                stack[i, :self.nnz_a] = a.data
            av = _to_device(stack, self.device)
            acc = torch.full((len(As), self._IA.shape[1]), sr.zero,
                             dtype=torch.float32, device=self.device)
            for lane in range(self._IA.shape[0]):
                acc = sr.mul_add(acc, av.index_select(1, self._IA[lane]),
                                 self._BV[lane])
            vals = torch.where(self.present, acc.view(len(As), m, self.pm),
                               sr.zero)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return [MaskedSpGEMMResult(vals[i], self.present, self.mask_cols,
                                   self.shape)
                for i in range(len(As))]

    # -- delta lifecycle ---------------------------------------------------

    def patched(self, A: CSR, B: CSR, M: CSR,
                changed_rows: np.ndarray
                ) -> Optional[Tuple["BurstProgram", int]]:
        """Row-local lane patch: ``(program, lane columns re-emitted)``.

        Valid when A's and M's changes are confined to ``changed_rows`` and
        B's STRUCTURE is this program's (B's values may differ: they
        regather on the device through the ``BG`` lanes).  Only the changed
        rows' slot columns are re-expanded, on the host; they are uploaded
        alone and written into device copies of this program's tables,
        whose every other column (and the per-slot ascending-k fold
        sequence it encodes) is this program's, remapped where A's entry
        positions shifted.  So a patched run is bitwise the cold rebuild's.
        Returns ``None`` when the delta needs a different shape (mask pad
        width or lane count grew, B's structure changed): the caller
        rebuilds through ``get_program``.
        """
        from .cache import content_fingerprint  # deferred: no import cycle
        m, n = self.shape
        dev = self.device
        if (A.shape != (m, self.k) or B.shape != (self.k, n)
                or M.shape != (m, n)):
            return None
        if structure_signature(B) != self._b_sig:
            return None
        m_nnz = np.diff(M.indptr)
        w_max = int(m_nnz.max(initial=0))
        w = self.wm if self.wm is not None else max(1, w_max)
        if w != self.pm or w_max > self.pm:
            return None
        changed_rows = np.unique(np.asarray(changed_rows, np.int64))
        # unchanged rows must really be unchanged in A and M (the IA remap
        # and the mask-column splice below rely on their entry counts)
        unchanged = np.ones(m, bool)
        unchanged[changed_rows] = False
        if not np.array_equal(np.diff(self._a_indptr)[unchanged],
                              np.diff(A.indptr)[unchanged]):
            return None
        if not np.array_equal(np.diff(self._m_indptr)[unchanged],
                              m_nnz[unchanged]):
            return None

        zero = self.semiring.zero
        B_s = CSR(B.indptr, self._b_sorted_idx, B.data[self._b_perm],
                  B.shape)
        b_fp = content_fingerprint(B)
        uploaded = 0

        def up(x: np.ndarray) -> torch.Tensor:
            nonlocal uploaded
            uploaded += x.nbytes
            return _to_device(x, dev)

        # re-expand ONLY the changed rows' products (host)
        a_perm = _row_sort_perm(A)
        a_rows_all = _expand_rows(A.indptr)
        sel = (np.concatenate(
            [np.arange(A.indptr[r], A.indptr[r + 1]) for r in changed_rows]
        ).astype(np.int64) if len(changed_rows) else np.zeros(0, np.int64))
        inv = np.empty(A.nnz, np.int64)
        inv[a_perm] = np.arange(A.nnz)
        sub_pos = a_perm[sel]                 # data positions, sorted order
        sub_rows = a_rows_all[a_perm][sel]
        sub_cols = A.indices[a_perm][sel]
        pm = self.pm
        # sorted view of ONLY the changed rows of M, with global row ids:
        # the expansion queries no other rows, and within-row offsets (the
        # slot layout) do not depend on the untouched rows
        mcnt = m_nnz[changed_rows]
        msel = (np.concatenate(
            [np.arange(M.indptr[r], M.indptr[r + 1]) for r in changed_rows]
        ).astype(np.int64) if len(changed_rows) else np.zeros(0, np.int64))
        mrows = np.repeat(changed_rows, mcnt)
        mcols = M.indices[msel][np.lexsort((M.indices[msel], mrows))]
        sub_indptr = np.zeros(m + 1, np.int64)
        sub_indptr[changed_rows + 1] = mcnt
        M_s = CSR(np.cumsum(sub_indptr), mcols, np.zeros(len(mcols)), (m, n))
        try:
            slot, a_gather, b_gather = _expand_products(
                sub_rows, sub_cols, sub_pos, B_s, M_s, pm, n)
            # local slot index within the changed rows' column block
            rloc = np.searchsorted(changed_rows, slot // pm)
            lslot = rloc * pm + slot % pm
            IA_s, BV_s, BG_s, counts = _lane_tables(
                lslot, a_gather, b_gather, B_s.data,
                len(changed_rows) * pm, self._IA.shape[0], A.nnz, zero)
        except _TooLarge:
            return None

        # IA remap: unchanged rows' A-entry positions shift by the changed
        # rows' nnz drift (rank within a row is preserved): one gather of
        # the parent's table through an O(nnz_a) map, or a plain copy
        old_nnz = self.nnz_a
        shift = A.indptr[:-1] - self._a_indptr[:-1]
        posmap = np.empty(old_nnz + 1, np.int64)
        posmap[:old_nnz] = self._a_inv + shift[_expand_rows(self._a_indptr)]
        posmap[old_nnz] = A.nnz
        if np.array_equal(posmap, np.arange(old_nnz + 1)):
            IA = self._IA.clone()
        else:
            pmap = up(posmap.astype(np.int32))
            IA = pmap.index_select(0, self._IA.view(-1)).view_as(self._IA)
        if isinstance(self._BG, np.ndarray):
            self._BG = up(self._BG)         # once per cold-built program
        if b_fp != self._b_fp:
            # B's values drifted (same structure): regather every BV lane
            # through BG on the device; pads (-1) read the fold identity
            bdata = up(np.concatenate(
                [B_s.data.astype(np.float32), [np.float32(zero)]]))
            BG = self._BG.clone()
            at = torch.where(BG >= 0, BG, B_s.nnz)
            BV = bdata.index_select(0, at.view(-1)).view_as(BG)
        else:
            BV = self._BV.clone()
            BG = self._BG.clone()

        cols = (changed_rows[:, None] * pm + np.arange(pm)[None, :]).ravel()
        cols_d = up(cols)
        for table, part in ((IA, IA_s), (BV, BV_s), (BG, BG_s)):
            table.index_copy_(1, cols_d, up(part))
        # padded mask columns of the changed rows, laid out exactly as
        # padded_from_csr lays them out (sorted within a row, pad = n)
        ch_cols = np.full((len(changed_rows), pm), n, np.int32)
        if len(mcols):
            starts = np.cumsum(mcnt) - mcnt
            ch_cols[np.repeat(np.arange(len(changed_rows)), mcnt),
                    np.arange(len(mcols)) - np.repeat(starts, mcnt)] = mcols
        rows_d = up(changed_rows)
        if torch.equal(self.mask_cols.index_select(0, rows_d).cpu(),
                       torch.from_numpy(ch_cols)):
            # mask layout untouched (an A-only or values-only-M delta): the
            # parent's column table is reused as it is
            mask_cols = self.mask_cols
        else:
            mask_cols = self.mask_cols.clone()
            mask_cols.index_copy_(0, rows_d, up(ch_cols))
        present = self.present.clone()
        present.index_copy_(0, rows_d, up(
            (counts.reshape(len(changed_rows), pm) > 0) & (ch_cols < n)))

        clone = object.__new__(BurstProgram)
        clone.shape = self.shape
        clone.k = self.k
        clone.nnz_a = A.nnz
        clone.semiring = self.semiring
        clone.wm = self.wm
        clone.device = dev
        clone.patch_bytes = uploaded
        clone.pm = pm
        clone.mask_cols = mask_cols
        clone.present = present
        clone._IA, clone._BV, clone._BG = IA, BV, BG
        clone.n_products = int((IA != A.nnz).sum())
        clone.max_chain = self.max_chain
        clone._a_indptr = A.indptr.copy()
        clone._m_indptr = M.indptr.copy()
        clone._a_inv = inv
        clone._b_sig = self._b_sig
        clone._b_fp = b_fp
        clone._b_perm = self._b_perm
        clone._b_sorted_idx = self._b_sorted_idx
        return clone, len(cols)


def burst_eligible(plan_algorithm: str, complement: bool, A, B, M) -> bool:
    return (plan_algorithm in SEQ_SCATTER_ALGOS and not complement
            and isinstance(A, CSR) and isinstance(B, CSR)
            and isinstance(M, CSR))


def _program_key(A: CSR, B: CSR, M: CSR, semiring: Semiring, wm,
                 device) -> tuple:
    from .cache import content_fingerprint  # deferred: no import cycle
    return (structure_signature(A), content_fingerprint(B),
            structure_signature(M), semiring.name, wm, str(device))


def peek_program(A: CSR, B: CSR, M: CSR, semiring: Semiring, wm,
                 device="cuda") -> Optional[BurstProgram]:
    """Cached program for this structure if one exists: no build, no
    patch.  The delta path uses it to find a pre-delta parent worth
    patching without ever paying an eager cold build."""
    key = _program_key(A, B, M, semiring, wm, device)
    hit = _programs.peek(key)
    if hit is not None:
        return hit if hit is not _OVER_CAP else None
    return _patches.peek(key)


def record_lineage(A: CSR, B: CSR, M: CSR, semiring: Semiring, wm,
                   parent: BurstProgram, changed_rows: np.ndarray,
                   device="cuda") -> None:
    """Remember that the post-delta structure (A, B, M) descends from
    ``parent`` with only ``changed_rows`` touched.  If the patched program
    is later evicted from ``_patches``, ``get_program`` re-derives it from
    this lineage instead of building cold."""
    key = _program_key(A, B, M, semiring, wm, device)
    _lineage.put(key, (parent, np.asarray(changed_rows, np.int64)))


def get_program(A: CSR, B: CSR, M: CSR, semiring: Semiring,
                wm: int = None, device="cuda"):
    """Cached build of the bucket's structure on ``device`` (None when over
    the caps): a cold-built program, a patched one, or one re-derived from
    a recorded lineage.  A program encodes no planner election, only the
    structure's gather pattern, so its key carries no cost-model token."""
    key = _program_key(A, B, M, semiring, wm, device)
    hit = _programs.get(key)
    if hit is not None:
        return hit if hit is not _OVER_CAP else None
    hit = _patches.get(key)
    if hit is not None:
        return hit
    lin = _lineage.get(key)
    if lin is not None:
        with obs.span("burst.patch", source="lineage") as sp:
            got = lin[0].patched(A, B, M, lin[1])
            if got is not None:
                sp.set(lanes=got[1])
                _patches.put(key, got[0])
                return got[0]
    try:
        with obs.span("burst.compile", nnz_a=A.nnz, nnz_m=M.nnz):
            prog = BurstProgram(A, B, M, semiring, wm, device)
    except _TooLarge:
        _programs.put(key, _OVER_CAP)
        return None
    _programs.put(key, prog)
    return prog


def patch_program(old: BurstProgram, A: CSR, B: CSR, M: CSR,
                  semiring: Semiring, wm, changed_rows: np.ndarray,
                  device="cuda") -> Tuple[Optional[BurstProgram], int]:
    """Patch ``old`` onto the post-delta operands: ``(program, lanes)``.

    A memo hit (the same post-delta structure patched before) costs one
    lookup; a fresh patch re-emits only the changed rows' lane columns and
    is registered under the post-delta key, so later ``get_program`` calls
    for this structure serve it directly.  ``(None, 0)`` means the delta is
    not row-local at this program's shape: the caller rebuilds cold
    through ``get_program``.
    """
    key = _program_key(A, B, M, semiring, wm, device)
    hit = _patches.get(key)
    if hit is not None:
        return hit, 0
    hit = _programs.peek(key)
    if hit is not None and hit is not _OVER_CAP:
        return hit, 0
    with obs.span("burst.patch", source="delta") as sp:
        got = old.patched(A, B, M, changed_rows)
        if got is None:
            return None, 0
        prog, lanes = got
        sp.set(lanes=lanes)
    _patches.put(key, prog)
    return prog, lanes


#: cache sentinel: structure known to exceed the replay caps
_OVER_CAP = object()
