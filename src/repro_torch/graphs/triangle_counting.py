"""Triangle Counting via Masked SpGEMM (paper §8.2).

With vertices relabelled in non-increasing degree order and L the strictly
lower-triangular part of the adjacency matrix, the triangle count is

    #tri = sum( L .* (L @ L) )

(one masked SpGEMM plus a reduction).  (L@L)_{ij} counts k with j < k < i
adjacent to both; masking by L_{ij} keeps each triangle exactly once.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.formats import CSR, csr_from_coo, tril, _expand_rows
from repro_torch.core.masked_spgemm import masked_spgemm
from repro_torch.core.semiring import PLUS_TIMES


def degree_relabel(a: CSR) -> CSR:
    """Relabel vertices in non-increasing degree order (paper: [29])."""
    deg = a.row_nnz()
    order = np.argsort(-deg, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    rows = rank[_expand_rows(a.indptr)]
    cols = rank[a.indices]
    return csr_from_coo(rows, cols, a.data, a.shape, sum_dups=False)


def triangle_count(adj: CSR, *, algorithm: str = "auto",
                   relabel: bool = True, two_phase: bool = False,
                   widths=None, device="cuda") -> Tuple[int, float]:
    """Returns (#triangles, masked-spgemm seconds).

    ``adj`` must be a symmetric 0/1 adjacency matrix without self-loops.
    Only the Masked SpGEMM and its reduction are timed (as in the paper's
    §8.2); the count is read back to the host, which ends the device work.
    """
    a = degree_relabel(adj) if relabel else adj
    L = tril(a, strict=True)
    t0 = time.perf_counter()
    out = masked_spgemm(L, L, L, algorithm=algorithm, semiring=PLUS_TIMES,
                        two_phase=two_phase, widths=widths, device=device)
    total = float(torch.where(out.present, out.vals, 0).sum(
        dtype=torch.float64))
    dt = time.perf_counter() - t0
    return int(round(total)), dt


def tc_flops(adj: CSR) -> int:
    """flops(L@L) = 2 * sum_k nnz(L_k*) over nonzeros L_ik (paper metric)."""
    L = tril(degree_relabel(adj), strict=True)
    row_nnz = L.row_nnz()
    return int(2 * row_nnz[L.indices].sum())
