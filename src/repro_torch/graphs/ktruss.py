"""k-truss via iterated Masked SpGEMM (paper §8.3).

The k-truss is the maximal subgraph in which every edge is supported by at
least k-2 triangles.  Each iteration computes every edge's support with one
Masked SpGEMM  S = A .* (A @ A)  (support of edge (i,j) = common neighbors),
prunes under-supported edges, and repeats until a fixed point.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.formats import CSR, csr_from_coo, _expand_rows
from repro_torch.core.masked_spgemm import masked_spgemm
from repro_torch.core.semiring import PLUS_TIMES


def ktruss(adj: CSR, k: int, *, algorithm: str = "auto",
           two_phase: bool = False, max_iter: int = 100, device="cuda"
           ) -> Tuple[CSR, float, int, int]:
    """Returns (truss_adjacency, masked_spgemm_seconds, iterations, flops).

    ``adj``: symmetric 0/1 adjacency, no self-loops.  Only the Masked
    SpGEMM calls are timed, each ended by a synchronise on a CUDA
    ``device``; flops is the summed flops(A@A) restricted to surviving
    structure per iteration (the paper's GFLOPS denominator).  The pruning
    runs on the host.
    """
    on_cuda = torch.device(device).type == "cuda"
    a = adj
    support_needed = k - 2
    spgemm_time = 0.0
    flops = 0
    for it in range(max_iter):
        if a.nnz == 0:
            return a, spgemm_time, it, flops
        t0 = time.perf_counter()
        out = masked_spgemm(a, a, a, algorithm=algorithm,
                            semiring=PLUS_TIMES, two_phase=two_phase,
                            device=device)
        if on_cuda:
            torch.cuda.synchronize(device)
        spgemm_time += time.perf_counter() - t0
        row_nnz = a.row_nnz()
        flops += int(2 * row_nnz[a.indices].sum())

        present = out.present.cpu().numpy()
        vals = out.vals.cpu().numpy()
        rows, slots = np.nonzero(present)
        cols = out.mask_cols.cpu().numpy()[rows, slots]
        support = vals[rows, slots]
        keep = support >= support_needed
        if keep.sum() == len(_expand_rows(a.indptr)):
            return a, spgemm_time, it + 1, flops
        pruned = csr_from_coo(rows[keep], cols[keep],
                              np.ones(int(keep.sum()), np.float32), a.shape,
                              sum_dups=False)
        if pruned.nnz == a.nnz:
            return pruned, spgemm_time, it + 1, flops
        a = pruned
    return a, spgemm_time, max_iter, flops
