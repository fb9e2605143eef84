"""Element-level Masked SpGEVM accumulators (paper Sec. 5), batched in torch.

Each accumulator implements the paper's interface

    SETALLOWED(key) / INSERT(key, value) / REMOVE(key)

with the three states NOTALLOWED / ALLOWED / SET, specialized as a row-level
masked SpGEVM  v = m (.)  (u^T B)  over an arbitrary semiring.

Every function here runs a whole batch of R rows at once: the row dimension
is written out as the leading axis of every tensor (the reference vmaps a
one-row function instead), and the reference's ``fori_loop`` over the
A-row slots is a Python loop whose body updates all R rows.  Shapes:

    m_cols (R, pm)   a_cols / a_vals (R, wa)   a_lens (R,)
    B_cols / B_vals (kdim, wb)   B_lens (kdim,)

All index tensors are int64 (``masked_spgemm`` converts the stored int32
once).

Faithfulness notes (as in the reference):
  * One B-row is processed as a whole per A-slot; column ids within a CSR
    row are unique, so the state transitions equal the paper's scalar loop.
  * msa, hash and mca keep the paper's per-slot fold: every accumulator
    slot starts at the semiring zero and adds products in ascending k, each
    as one fused multiply-add under plus_times (``Semiring.mul_add``), as
    the reference's compiled fold does, so they are bitwise equal to the
    reference on any data.
  * heap reduces each run by a segmented scan and inner by a pairwise tree:
    other summation orders than the reference's, exact on integer data.
  * Scatters with duplicate indices only ever land on a scratch slot (n,
    an EMPTY hash slot, or pm) that is never read as a result, so the
    unspecified winner of a duplicate write on CUDA cannot change a result.
"""
from __future__ import annotations

import math

import torch

from .semiring import Semiring

NOTALLOWED, ALLOWED, SET = 0, 1, 2


def _b_rows(B_cols, B_vals, B_lens, rows, kdim):
    """Fetch padded rows of B for an index tensor ``rows`` (any shape),
    masking padding and out-of-range rows: (cols, vals, valid) with one
    trailing axis of width wb."""
    safe = rows.clamp(max=kdim - 1)
    cols = B_cols[safe]
    vals = B_vals[safe]
    slot = torch.arange(cols.shape[-1], device=cols.device)
    valid = (slot < B_lens[safe].unsqueeze(-1)) & (rows < kdim).unsqueeze(-1)
    return cols, vals, valid


def _col_gather(x, idx):
    return torch.gather(x, 1, idx)


# ---------------------------------------------------------------------------
# MSA: dense values[n] + states[n]  (paper Sec. 5.2)
# ---------------------------------------------------------------------------


def msa_rows(m_cols, a_cols, a_vals, a_lens, B_cols, B_vals, B_lens,
             n: int, kdim: int, sr: Semiring, complement: bool = False):
    """Masked SpGEVM with the Masked Sparse Accumulator.

    Returns (vals, present) aligned to mask slots, (R, pm), when
    ``complement=False``; dense (R, n) rows otherwise (a complemented
    output is not mask-aligned).
    """
    R = m_cols.shape[0]
    dev = B_vals.device
    values = torch.full((R, n + 1), sr.zero, dtype=B_vals.dtype, device=dev)
    if complement:
        states = torch.full((R, n + 1), ALLOWED, dtype=torch.int8, device=dev)
        states.scatter_(1, m_cols, NOTALLOWED)       # SETNOTALLOWED
    else:
        states = torch.full((R, n + 1), NOTALLOWED, dtype=torch.int8,
                            device=dev)
        states.scatter_(1, m_cols, ALLOWED)          # SETALLOWED; pads hit n
    states[:, n] = NOTALLOWED                        # scratch slot

    for k in range(a_cols.shape[1]):
        uk = a_vals[:, k:k + 1]
        bcols, bvals, bvalid = _b_rows(B_cols, B_vals, B_lens, a_cols[:, k],
                                       kdim)
        bvalid = bvalid & (k < a_lens).unsqueeze(1)
        st = _col_gather(states, bcols)
        allowed = (st >= ALLOWED) & bvalid
        cur = _col_gather(values, bcols)
        # predicated lambda: the product only lands where allowed
        new = torch.where(allowed, sr.mul_add(cur, uk, bvals), cur)
        values.scatter_(1, bcols, new)                # cols unique within row
        states.scatter_(1, bcols,
                        torch.where(allowed, SET, st).to(torch.int8))
    if complement:
        present = states[:, :n] == SET
        return torch.where(present, values[:, :n], sr.zero), present
    # gather in mask order (REMOVE per mask nonzero) -> stable output
    out = _col_gather(values, m_cols)
    present = (_col_gather(states, m_cols) == SET) & (m_cols < n)
    return torch.where(present, out, sr.zero), present


# ---------------------------------------------------------------------------
# Hash: open addressing, linear probing, load factor 0.25 (paper Sec. 5.3)
# ---------------------------------------------------------------------------


def _hash_size(pm: int, load: float = 0.25) -> int:
    t = 1
    need = max(4, int(pm / load))
    while t < need:
        t <<= 1
    return t


def _probe(keys, queries, table_size):
    """Batched linear probing: slot of each query (or slot of its first
    EMPTY), and whether it was found.  EMPTY = -1.

    The probe sequence is the reference's multiplicative hash, stepped
    until every query has hit its key or an EMPTY slot.  The stop test is
    checked on the host once per step (on CUDA, one synchronisation per
    step); at load factor 0.25 a few steps suffice, and the loop can never
    run more than ``table_size`` steps because the table always keeps an
    EMPTY slot.
    """
    mask = table_size - 1
    # (q mod 2^32) * 2654435761 stays below 2^63 for q < 2^31, so the low
    # bits equal the reference's uint32 product
    slots = ((queries & 0xFFFFFFFF) * 2654435761) & mask
    done = torch.zeros_like(queries, dtype=torch.bool)
    for _ in range(table_size):
        at = _col_gather(keys, slots)
        done = done | (at == queries) | (at == -1)
        if bool(done.all()):
            break
        slots = torch.where(done, slots, (slots + 1) & mask)
    found = _col_gather(keys, slots) == queries
    return slots, found


def hash_rows(m_cols, a_cols, a_vals, a_lens, B_cols, B_vals, B_lens,
              n: int, kdim: int, sr: Semiring):
    """Masked SpGEVM with the hash accumulator (non-complemented mask)."""
    R, pm = m_cols.shape
    dev = B_vals.device
    T = _hash_size(pm)
    keys = torch.full((R, T), -1, dtype=torch.int64, device=dev)
    values = torch.full((R, T), sr.zero, dtype=B_vals.dtype, device=dev)
    states = torch.full((R, T), NOTALLOWED, dtype=torch.int8, device=dev)

    # SETALLOWED for every mask nonzero (sequential inserts, like the paper)
    for i in range(pm):
        c = m_cols[:, i:i + 1]
        valid = c < n
        s, _ = _probe(keys, c, T)
        keys.scatter_(1, s, torch.where(valid, c, _col_gather(keys, s)))
        states.scatter_(1, s, torch.where(
            valid, ALLOWED, _col_gather(states, s)).to(torch.int8))

    for k in range(a_cols.shape[1]):
        uk = a_vals[:, k:k + 1]
        bcols, bvals, bvalid = _b_rows(B_cols, B_vals, B_lens, a_cols[:, k],
                                       kdim)
        bvalid = bvalid & (k < a_lens).unsqueeze(1)
        slots, found = _probe(keys, bcols, T)
        st = _col_gather(states, slots)
        allowed = found & bvalid & (st >= ALLOWED)
        cur = _col_gather(values, slots)
        # a miss lands on an EMPTY slot and writes back what it read there
        values.scatter_(1, slots,
                        torch.where(allowed, sr.mul_add(cur, uk, bvals), cur))
        states.scatter_(1, slots, torch.where(allowed, SET, st).to(torch.int8))
    # REMOVE in mask order
    slots, found = _probe(keys, m_cols, T)
    present = found & (_col_gather(states, slots) == SET) & (m_cols < n)
    return torch.where(present, _col_gather(values, slots), sr.zero), \
        present


# ---------------------------------------------------------------------------
# MCA: compressed accumulator indexed by mask rank (paper Sec. 5.4; novel)
# ---------------------------------------------------------------------------


def mca_rows(m_cols, a_cols, a_vals, a_lens, B_cols, B_vals, B_lens,
             n: int, kdim: int, sr: Semiring):
    """Masked SpGEVM with the Mask Compressed Accumulator.

    Accumulator rows have length nnz(m) (= pm padded); keys are the *ranks*
    of mask nonzeros.  Only ALLOWED/SET states exist.  No complement support
    (faithful to the paper).  ``searchsorted`` plays the role of the sorted
    mask/B-row merge.
    """
    R, pm = m_cols.shape
    dev = B_vals.device
    # scratch slot pm absorbs every non-hit scatter
    values = torch.full((R, pm + 1), sr.zero, dtype=B_vals.dtype, device=dev)
    states = torch.zeros((R, pm + 1), dtype=torch.int8, device=dev)

    for k in range(a_cols.shape[1]):
        uk = a_vals[:, k:k + 1]
        bcols, bvals, bvalid = _b_rows(B_cols, B_vals, B_lens, a_cols[:, k],
                                       kdim)
        bvalid = bvalid & (k < a_lens).unsqueeze(1)
        idx = torch.searchsorted(m_cols, bcols)
        idxc = idx.clamp(max=pm - 1)
        hit = ((_col_gather(m_cols, idxc) == bcols) & (bcols < n) & bvalid
               & (idx < pm))
        tgt = torch.where(hit, idxc, pm)
        new = torch.where(hit, sr.mul_add(_col_gather(values, idxc), uk,
                                          bvals), sr.zero)
        values.scatter_(1, tgt, new)
        states.scatter_(1, tgt, hit.to(torch.int8))
    present = (states[:, :pm] == 1) & (m_cols < n)
    return torch.where(present, values[:, :pm], sr.zero), present


# ---------------------------------------------------------------------------
# Heap: multiway merge of scaled B-rows (paper Sec. 5.5)
# ---------------------------------------------------------------------------


def _segmented_reduce_sorted(cols, vals, sr: Semiring, n: int):
    """Combine values of equal, sorted cols along the last axis: returns
    (vals, is_tail).

    ``is_tail[..., i]`` marks the last element of each equal-col run; vals
    at the tail hold the run's semiring-sum (the paper's "accumulate into
    the last inserted output entry", Alg. 4 lines 14-18).  The segmented
    scan is a log-step (Hillis-Steele) scan of the reference's combine.
    """
    L = cols.shape[-1]
    seg = torch.ones_like(cols, dtype=torch.bool)
    seg[..., 1:] = cols[..., 1:] != cols[..., :-1]
    d = 1
    while d < L:
        va, sa = vals[..., :-d], seg[..., :-d]
        vb, sb = vals[..., d:], seg[..., d:]
        vals = torch.cat([vals[..., :d],
                          torch.where(sb, vb, sr.add(va, vb))], dim=-1)
        seg = torch.cat([seg[..., :d], sa | sb], dim=-1)
        d *= 2
    is_tail = torch.ones_like(cols, dtype=torch.bool)
    is_tail[..., :-1] = cols[..., 1:] != cols[..., :-1]
    return vals, is_tail & (cols < n)


def heap_rows(m_cols, a_cols, a_vals, a_lens, B_cols, B_vals, B_lens,
              n: int, kdim: int, sr: Semiring, n_inspect: int = 1,
              complement: bool = False):
    """Masked SpGEVM via multiway merge (Heap / HeapDot).

    ``n_inspect`` mirrors the paper's NInspect: 0 pushes every element and
    filters against the mask during the merge (Heap); >=1 ("HeapDot" when
    inf) checks mask membership *before* an element enters the merge.  The
    data-parallel merge is a stable sort + segmented semiring-reduction.
    """
    R, pm = m_cols.shape
    wa = a_cols.shape[1]
    bcols, bvals, bvalid = _b_rows(B_cols, B_vals, B_lens, a_cols, kdim)
    wb = bcols.shape[-1]
    slot = torch.arange(wa, device=a_cols.device)
    bvalid = bvalid & (slot < a_lens.unsqueeze(1)).unsqueeze(-1)
    prod = sr.mul(a_vals.unsqueeze(-1), bvals)
    bcols = bcols.reshape(R, wa * wb)
    bvalid = bvalid.reshape(R, wa * wb)
    prod = torch.broadcast_to(prod, (R, wa, wb)).reshape(R, wa * wb)
    if n_inspect > 0 and not complement:
        idx = torch.searchsorted(m_cols, bcols).clamp(max=pm - 1)
        bvalid = bvalid & (_col_gather(m_cols, idx) == bcols)
    cols = torch.where(bvalid, bcols, n)
    vals = torch.where(bvalid, prod, sr.zero)
    order = torch.argsort(cols, dim=1, stable=True)  # heap-ordered extraction
    cols = _col_gather(cols, order)
    vals = _col_gather(vals, order)
    vals, is_tail = _segmented_reduce_sorted(cols, vals, sr, n)

    if complement:
        # products for S \ m: drop merged entries whose col is in the mask
        idx = torch.searchsorted(m_cols, cols).clamp(max=pm - 1)
        keep = is_tail & ~(_col_gather(m_cols, idx) == cols)
        tgt = torch.where(keep, cols, n)
        dense = torch.full((R, n + 1), sr.zero, dtype=vals.dtype,
                           device=vals.device)
        densep = torch.zeros((R, n + 1), dtype=torch.bool, device=vals.device)
        dense.scatter_(1, tgt, vals)
        densep.scatter_(1, tgt, keep)
        return dense[:, :n], densep[:, :n]

    # align merged run-tails to mask slots (a slot is hit by at most one
    # run tail since mask cols are unique; misses land on scratch slot pm)
    idx = torch.searchsorted(m_cols, cols)
    idxc = idx.clamp(max=pm - 1)
    hit = (_col_gather(m_cols, idxc) == cols) & is_tail
    tgt = torch.where(hit, idxc, pm)
    out = torch.full((R, pm + 1), sr.zero, dtype=vals.dtype,
                     device=vals.device)
    present = torch.zeros((R, pm + 1), dtype=torch.bool, device=vals.device)
    out.scatter_(1, tgt, vals)
    present.scatter_(1, tgt, hit)
    return out[:, :pm], present[:, :pm] & (m_cols < n)


# ---------------------------------------------------------------------------
# Inner: pull-based dot products per mask nonzero (paper Sec. 4.1)
# ---------------------------------------------------------------------------


def _tree_reduce(x, sr: Semiring):
    """Semiring-sum over the last axis by pairwise halving."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            pad = torch.full(x.shape[:-1] + (1,), sr.zero, dtype=x.dtype,
                             device=x.device)
            x = torch.cat([x, pad], dim=-1)
        x = sr.add(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def inner_keys(Bt_cols, kdim: int):
    """Composite (row, col) keys of a padded B^T, flattened: sorted, since
    every row is sorted and its padding ``kdim`` stays below the next
    row's keys."""
    rows = torch.arange(Bt_cols.shape[0], device=Bt_cols.device)
    return (rows.unsqueeze(1) * (kdim + 1) + Bt_cols).reshape(-1)


def inner_rows(m_cols, a_cols, a_vals, a_lens, Bt_cols, Bt_vals, Bt_lens,
               n: int, kdim: int, sr: Semiring, keys=None):
    """Pull algorithm: for each mask nonzero j, sparse dot  A_i* . B_*j.

    ``Bt_*`` is B stored column-major (CSC == CSR of B^T), as the paper
    prescribes.  Each A-row index is located inside B's column-j index list
    by one searchsorted over composite (j, col) keys of the whole padded
    B^T (``inner_keys``; pass them in ``keys`` to reuse them across row
    chunks); that gives the reference's per-column insertion points
    without materializing an (R, pm, wbt) gather.
    """
    wa = a_cols.shape[1]
    wbt = Bt_cols.shape[1]
    if keys is None:
        keys = inner_keys(Bt_cols, kdim)
    j = m_cols.clamp(max=n - 1)                                # (R, pm)
    q = j.unsqueeze(-1) * (kdim + 1) + a_cols.unsqueeze(1)     # (R, pm, wa)
    local = torch.searchsorted(keys, q) - (j * wbt).unsqueeze(-1)
    idx = local.clamp(min=0, max=wbt - 1)
    flat = j.unsqueeze(-1) * wbt + idx
    slot = torch.arange(wa, device=a_cols.device)
    a_valid = slot < a_lens.unsqueeze(1)
    hit = ((Bt_cols.reshape(-1)[flat] == a_cols.unsqueeze(1))
           & (a_valid & (a_cols < kdim)).unsqueeze(1)
           & (idx < Bt_lens[j].unsqueeze(-1)))
    prod = sr.mul(a_vals.unsqueeze(1), Bt_vals.reshape(-1)[flat])
    contrib = torch.where(hit, prod, sr.zero)
    vals = _tree_reduce(contrib, sr)
    present = hit.any(dim=-1) & (m_cols < n)
    return torch.where(present, vals, sr.zero), present


# ---------------------------------------------------------------------------
# Symbolic (counting-only) pass for the two-phase pipeline (paper Sec. 6)
# ---------------------------------------------------------------------------


def symbolic_rows(m_cols, a_cols, a_lens, B_cols, B_lens, n: int, kdim: int):
    """Number of output nonzeros of each masked row (structure only).

    Mirrors MCA with boolean states and no value computation -- the cheapest
    faithful symbolic pass.
    """
    R, pm = m_cols.shape
    states = torch.zeros((R, pm + 1), dtype=torch.bool, device=m_cols.device)
    for k in range(a_cols.shape[1]):
        rows = a_cols[:, k]
        safe = rows.clamp(max=kdim - 1)
        bcols = B_cols[safe]
        slot = torch.arange(bcols.shape[1], device=bcols.device)
        bvalid = ((slot < B_lens[safe].unsqueeze(1))
                  & ((rows < kdim) & (k < a_lens)).unsqueeze(1))
        idx = torch.searchsorted(m_cols, bcols).clamp(max=pm - 1)
        hit = (_col_gather(m_cols, idx) == bcols) & (bcols < n) & bvalid
        states.scatter_(1, torch.where(hit, idx, pm), True)
    return (states[:, :pm] & (m_cols < n)).sum(dim=1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Cost hooks (planner): per-algorithm work models over padded row widths
# ---------------------------------------------------------------------------
#
# Copied unchanged from the reference.  The planner (``planner.py``) ranks
# the accumulators by evaluating these models on cheap structural
# statistics; only the *ranking* matters.  Units: estimated milliseconds
# per 1024 output rows on the host the reference was calibrated on (a CPU).
# A fitted profile (``repro_torch.tuning``) overwrites the constants in
# place for another backend.

#: Calibration constants — the reference's shipped CPU defaults.  The
#: planner keys its plan caches on a fingerprint of these tables, so any
#: change invalidates previously cached plans.
COST_CONSTANTS = {
    # dense (n+1)-wide state init/gather + wa sequential scatter rounds
    "msa": dict(base=12.0, per_n=0.035, per_flop=0.25, per_mask=0.5),
    # table build is a sequential probe loop over mask nonzeros; probing
    # inside the flop loop is a while-loop per batch of wb queries
    "hash": dict(base=40.0, per_flop=0.30, per_mask=1.5, per_slot=0.01),
    # wa merge rounds of wb searchsorted lookups into the pm-long mask row
    "mca": dict(base=45.0, per_merge=0.045),
    # sort of the wa*wb expansion + segmented reduce + mask alignment
    "heap": dict(base=25.0, per_sort=0.05, per_mask=1.0),
    "heapdot": dict(base=25.0, per_sort=0.05, per_mask=1.0, per_inspect=0.01),
    # one batched sparse dot per mask nonzero (no sequential flop loop);
    # the large base is the host-side B^T transpose+pad paid every call
    "inner": dict(base=51.0, per_dot=0.0157),
}


def _log2(x: float) -> float:
    return math.log2(max(2.0, float(x)))


# Each model is LINEAR in its constants: cost = sum_k c[k] * feature_k.


def _msa_features(*, n, wa, wb, wbt, pm):
    return {"base": 1.0, "per_n": float(n + 1), "per_flop": float(wa * wb),
            "per_mask": float(pm)}


def _hash_features(*, n, wa, wb, wbt, pm):
    return {"base": 1.0, "per_flop": float(wa * wb), "per_mask": float(pm),
            "per_slot": float(_hash_size(max(1, pm)))}


def _mca_features(*, n, wa, wb, wbt, pm):
    return {"base": 1.0, "per_merge": wa * wb * _log2(pm + 2)}


def _heap_features(*, n, wa, wb, wbt, pm):
    e = wa * wb
    return {"base": 1.0, "per_sort": e * _log2(e + 2), "per_mask": float(pm)}


def _heapdot_features(*, n, wa, wb, wbt, pm):
    e = wa * wb
    return {"base": 1.0, "per_sort": e * _log2(e + 2), "per_mask": float(pm),
            "per_inspect": e * _log2(pm + 2)}


def _inner_features(*, n, wa, wb, wbt, pm):
    return {"base": 1.0, "per_dot": pm * wa * _log2(wbt + 2)}


#: algorithm name -> feature decomposition of its cost model
COST_FEATURES = {
    "msa": _msa_features,
    "hash": _hash_features,
    "mca": _mca_features,
    "heap": _heap_features,
    "heapdot": _heapdot_features,
    "inner": _inner_features,
}


def _make_cost_hook(name):
    features = COST_FEATURES[name]

    def hook(*, n, wa, wb, wbt, pm):
        c = COST_CONSTANTS[name]
        f = features(n=n, wa=wa, wb=wb, wbt=wbt, pm=pm)
        return sum(c[k] * f[k] for k in f)

    hook.__name__ = f"{name}_cost"
    return hook


#: algorithm name -> cost hook; keys mirror masked_spgemm.ALGORITHMS
COST_HOOKS = {name: _make_cost_hook(name) for name in COST_FEATURES}

#: algorithms whose row kernels accept ``complement=True`` (paper Sec. 8.4:
#: hash/MCA/inner require an explicit mask)
SUPPORTS_COMPLEMENT = frozenset({"msa", "heap", "heapdot"})
