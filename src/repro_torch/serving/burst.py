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
"""
from __future__ import annotations

from typing import Tuple

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
                 nnz_a: int, zero: float
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(IA, BV, counts): lane tables laid out (n_lanes, nslots), sized to
    the longest chain.

    IA[l] indexes the query's value vector (pad lanes -> the sentinel
    ``nnz_a``, which reads 0.0), BV[l] holds B's values (pad lanes carry
    ``zero``), counts the products per slot.
    """
    F = len(slot)
    counts = np.zeros(nslots + 1, np.int64)
    np.add.at(counts, slot + 1, 1)
    starts = np.cumsum(counts)[:-1]
    n_lanes = max(int(counts[1:].max(initial=0)), 1)
    P = np.full((nslots, n_lanes), F, np.int64)
    lane = np.arange(F) - starts[slot]
    P[slot, lane] = np.arange(F)
    IA = np.concatenate([a_gather.astype(np.int32),
                         np.full((1,), nnz_a, np.int32)])[P].T.copy()
    BV = np.concatenate([b_data[b_gather].astype(np.float32),
                         np.full((1,), zero, np.float32)])[P].T.copy()
    return IA, BV, counts[1:]


class _TooLarge(Exception):
    """Structure exceeds the replay caps; callers fall back silently."""


class BurstProgram:
    """One compiled structure: executes any batch of value vectors for A
    on ``device``."""

    def __init__(self, A: CSR, B: CSR, M: CSR, semiring: Semiring,
                 wm: int = None, device="cuda"):
        m, k = A.shape
        _, n = B.shape
        self.shape = (m, n)
        self.k = k
        self.nnz_a = A.nnz
        self.semiring = semiring
        self.wm = wm
        self.device = torch.device(device)

        a_perm = _row_sort_perm(A)          # kernels see sorted rows
        a_rows = _expand_rows(A.indptr)[a_perm]
        a_cols = A.indices[a_perm]

        M_s = M.sorted_rows()
        M_p = padded_from_csr(M, wm, device=self.device)
        self.pm = pm = M_p.width
        self.mask_cols = M_p.cols

        b_perm = _row_sort_perm(B)
        B_s = CSR(B.indptr, B.indices[b_perm], B.data[b_perm], B.shape)
        slot, a_gather, b_gather = _expand_products(
            a_rows, a_cols, a_perm, B_s, M_s, pm, n)
        if len(slot) > MAX_TOTAL_PRODUCTS:
            raise _TooLarge()
        if int(np.bincount(slot, minlength=1).max()) > MAX_PRODUCTS_PER_SLOT:
            raise _TooLarge()
        self.n_products = len(slot)

        IA, BV, counts = _lane_tables(slot, a_gather, b_gather, B_s.data,
                                      m * pm, A.nnz, semiring.zero)
        self.max_chain = IA.shape[0] if self.n_products else 0
        present = counts.reshape(m, pm) > 0
        present &= M_p.cols.cpu().numpy() < n            # pad slots absent
        self.present = _to_device(present, self.device)
        self._IA = _to_device(IA, self.device)
        self._BV = _to_device(BV, self.device)

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


def burst_eligible(plan_algorithm: str, complement: bool, A, B, M) -> bool:
    return (plan_algorithm in SEQ_SCATTER_ALGOS and not complement
            and isinstance(A, CSR) and isinstance(B, CSR)
            and isinstance(M, CSR))


def get_program(A: CSR, B: CSR, M: CSR, semiring: Semiring,
                wm: int = None, device="cuda"):
    """Cached build of the bucket's structure on ``device`` (None when over
    the caps).  A program encodes no planner election, only the structure's
    gather pattern, so its key carries no cost-model token."""
    from .cache import content_fingerprint  # deferred: no import cycle
    key = (structure_signature(A), content_fingerprint(B),
           structure_signature(M), semiring.name, wm, str(device))
    hit = _programs.get(key)
    if hit is not None:
        return hit if hit is not _OVER_CAP else None
    try:
        with obs.span("burst.compile", nnz_a=A.nnz, nnz_m=M.nnz):
            prog = BurstProgram(A, B, M, semiring, wm, device)
    except _TooLarge:
        _programs.put(key, _OVER_CAP)
        return None
    _programs.put(key, prog)
    return prog


#: cache sentinel: structure known to exceed the replay caps
_OVER_CAP = object()
