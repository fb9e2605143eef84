"""Batched (multi-source) Betweenness Centrality via Masked SpGEMM
(paper §8.4; Brandes [8] in GraphBLAS form [11]).

The forward sweep uses the *complemented* mask (avoid re-discovering visited
vertices), the paper's motivating use of mask complement:

    F_{d+1} = ¬Visited ⊙ (F_d @ A)

and the backward sweep uses a normal masked SpGEMM per depth:

    W = Sigma_{d-1} ⊙ (W @ Aᵀ)

Only MSA (and Heap) support the complement (MCA cannot, §8.4), so callers
pick ``algorithm`` accordingly; the backward mask is unrestricted.  The
frontiers and path counts live on the host; each product runs on
``device``.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import CSR, csr_from_dense
from repro_torch.core.masked_spgemm import (masked_spgemm,
                                            masked_spgemm_batched)
from repro_torch.core.semiring import PLUS_TIMES


def _chunk_rows(dense: np.ndarray, chunks: int):
    """Split a (b, n) operand row-wise into ``chunks`` equal CSR pieces
    (the last is zero-padded), for the batched one-plan driver."""
    b, n = dense.shape
    size = -(-b // chunks)
    out = []
    for c in range(chunks):
        piece = np.zeros((size, n), dense.dtype)
        rows = dense[c * size:(c + 1) * size]
        piece[: len(rows)] = rows
        out.append(csr_from_dense(piece))
    return out, size


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def betweenness_centrality(adj: CSR, sources: Optional[Sequence[int]] = None,
                           *, algorithm: str = "auto",
                           backward_algorithm: Optional[str] = None,
                           two_phase: bool = False, source_chunks: int = 1,
                           engine=None, device="cuda"
                           ) -> Tuple[np.ndarray, float, int]:
    """Returns (bc values (n,), masked-spgemm seconds, #spgemm calls).

    ``adj``: symmetric 0/1 adjacency (undirected), no self-loops.
    ``sources``: batch of source vertices (default: all).
    ``source_chunks`` > 1 splits the source batch into that many same-shape
    chunks per sweep and runs them through ``masked_spgemm_batched``: one
    plan and one row program per depth instead of a call per chunk (the
    paper's multi-source batching, Sec. 8.4).
    Unnormalized, endpoints excluded, each unordered pair counted once.

    ``engine``: a ``repro_torch.serving.QueryEngine``; BC becomes a serving
    client: each chunk is submitted as a query and the engine's batcher
    reassembles the per-depth batch, on the engine's device (``device``
    then applies to nothing).  Results equal the direct driver's up to
    float summation order: the engine plans per chunk where the direct
    path plans the whole batch once.

    The timed quantity is the masked products alone, each ended by a
    synchronise on a CUDA device; host format conversions are untimed.
    """
    if two_phase and source_chunks > 1:
        raise ValueError("two_phase is not supported by the batched "
                         "(source_chunks > 1) driver")
    if engine is not None and two_phase:
        raise ValueError("two_phase is not supported by the serving engine")
    on_cuda = engine is None and torch.device(device).type == "cuda"
    n = adj.shape[0]
    At = adj.transpose()
    sources = np.arange(n) if sources is None else np.asarray(sources)
    b = len(sources)
    # the forward sweep runs under complement=True; hash/mca/inner cannot
    # complement (paper Sec. 8.4), so coerce them to msa up front ("auto"
    # plans the complement itself; msa/heap* pass through).  The backward
    # sweep has a normal mask, so the caller's algorithm is fine there.
    complement_capable = ("auto", "msa", "heap", "heapdot")
    forward_algorithm = (algorithm if algorithm in complement_capable
                         else "msa")
    backward_algorithm = backward_algorithm or algorithm

    spgemm_time = 0.0
    calls = 0

    def timed(fn):
        nonlocal spgemm_time
        t0 = time.perf_counter()
        out = fn()
        if on_cuda:
            torch.cuda.synchronize(device)
        spgemm_time += time.perf_counter() - t0
        return out

    def _serve_batch(As_, B_, Ms_, algo, complement):
        """One per-depth chunk batch through the serving engine: one
        ticket per chunk; the batcher re-fuses the same-shape tickets."""
        forced = None if algo == "auto" else algo
        tickets = [engine.submit(a, B_, mm, complement=complement,
                                 algorithm=forced)
                   for a, mm in zip(As_, Ms_)]
        engine.flush()
        outs = [t.result() for t in tickets]
        if complement:
            return (np.stack([_host(v) for v, _ in outs]),
                    np.stack([_host(p) for _, p in outs]))
        return outs

    def _serve_one(A_, B_, M_, algo, complement):
        forced = None if algo == "auto" else algo
        return engine.submit(A_, B_, M_, complement=complement,
                             algorithm=forced).result()

    # ---- forward: BFS wave with #shortest-paths accumulation -------------
    num_sp = np.zeros((b, n), np.float32)
    num_sp[np.arange(b), sources] = 1.0
    frontier = num_sp.copy()
    sigmas = []                                   # per-depth path counts
    while True:
        if not frontier.any():
            break
        visited = (num_sp != 0).astype(np.float32)
        if source_chunks > 1:
            f_chunks, _ = _chunk_rows(frontier, source_chunks)
            v_chunks, _ = _chunk_rows(visited, source_chunks)
            if engine is not None:
                vals, present = timed(lambda: _serve_batch(
                    f_chunks, adj, v_chunks, forward_algorithm, True))
            else:
                vals, present = timed(lambda: masked_spgemm_batched(
                    f_chunks, adj, v_chunks, algorithm=forward_algorithm,
                    semiring=PLUS_TIMES, complement=True, device=device))
                vals, present = _host(vals), _host(present)
            vals = vals.reshape(-1, n)[:b]
            present = present.reshape(-1, n)[:b]
        else:
            f_csr = csr_from_dense(frontier)
            visited_mask = csr_from_dense(visited)
            if engine is not None:
                vals, present = timed(lambda: _serve_one(
                    f_csr, adj, visited_mask, forward_algorithm, True))
            else:
                vals, present = timed(lambda: masked_spgemm(
                    f_csr, adj, visited_mask, algorithm=forward_algorithm,
                    semiring=PLUS_TIMES, complement=True,
                    two_phase=two_phase, device=device))
            vals, present = _host(vals), _host(present)
        calls += 1
        frontier = np.where(present, vals, 0.0)
        if not frontier.any():
            break
        sigmas.append(frontier.copy())
        num_sp += frontier

    # ---- backward: dependency accumulation -------------------------------
    bcu = np.ones((b, n), np.float32)
    inv_sp = np.where(num_sp != 0, 1.0 / np.maximum(num_sp, 1e-30), 0.0)
    for d in range(len(sigmas) - 1, 0, -1):
        w = np.where(sigmas[d] != 0, bcu * inv_sp, 0.0)
        mask_dense = (sigmas[d - 1] != 0).astype(np.float32)
        if source_chunks > 1:
            w_chunks, _ = _chunk_rows(w, source_chunks)
            m_chunks, _ = _chunk_rows(mask_dense, source_chunks)
            if engine is not None:
                outs = timed(lambda: _serve_batch(
                    w_chunks, At, m_chunks, backward_algorithm, False))
            else:
                outs = timed(lambda: masked_spgemm_batched(
                    w_chunks, At, m_chunks, algorithm=backward_algorithm,
                    semiring=PLUS_TIMES, device=device))
            w_next = np.concatenate([_host(o.to_dense()) for o in outs])[:b]
        else:
            w_csr = csr_from_dense(w)
            mask = csr_from_dense(mask_dense)
            if engine is not None:
                out = timed(lambda: _serve_one(
                    w_csr, At, mask, backward_algorithm, False))
            else:
                out = timed(lambda: masked_spgemm(
                    w_csr, At, mask, algorithm=backward_algorithm,
                    semiring=PLUS_TIMES, two_phase=two_phase,
                    device=device))
            w_next = _host(out.to_dense())
        calls += 1
        bcu += w_next * num_sp
    # depth-0 wave (sources' own row) contributes no centrality

    bc = (bcu - 1.0).sum(axis=0)
    return bc / 2.0, spgemm_time, calls


def bc_teps(adj: CSR, seconds: float, batch: int) -> float:
    """Paper §8.4 metric: batch_size * num_edges / total_time."""
    return batch * adj.nnz / max(seconds, 1e-12)
