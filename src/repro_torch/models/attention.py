"""Attention as Masked SpGEMM (the paper's technique inside the LM stack).

``scores = M (.) (Q Kᵀ)`` is a masked matrix product with a *structured*
mask (causal / sliding-window / dense-prefix).  Three implementations, as
in the reference:

* ``dense_masked`` — compute ALL scores, then mask (the paper's Fig.-1
  strawman), in plain PyTorch.
* ``block_masked`` — the paper's pull algorithm at tile granularity: a
  host-built tile worklist of only the mask-admitted tiles, balanced by
  folding long rows with short ones into groups of two, executed as a
  loop of uniform chunks of gathers, batched products and a streaming
  softmax (torch code: the reference's is an XLA scan, not a kernel).
* ``flash_pallas`` — the block-masked flash kernel
  (``repro_torch.kernels.flash_mask``): only mask-admitted tiles, one CUDA
  launch for every (batch, head).

``decode_attention`` is the serve-time single-token path over a (possibly
ring-buffered) KV cache.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import caches

NEG_INF = -1e30

#: number of ``block_masked_attention`` calls that ran the tile worklist
BLOCK_MASKED_CALLS = 0
#: of its calls, those that fell back to ``dense_masked_attention``
#: (shapes that are not block multiples, or a fully dense mask)
BLOCK_MASKED_FALLBACKS = 0


def allowed_fn(qpos, kpos, *, causal: bool, window: int, prefix: int):
    """The mask of the dense paths.  Unlike the flash kernel's mask, it
    makes the prefix bidirectional when ``prefix > 0`` and ``window == 0``
    (prefix-LM); the reference has the same split."""
    ok = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                    dtype=torch.bool, device=qpos.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= ((qpos - kpos) < window) | (kpos < prefix)
    if prefix > 0 and window == 0:
        # prefix-LM: bidirectional within the prefix
        ok |= (kpos < prefix) & (qpos < prefix)
    return ok


def dense_masked_attention(q, k, v, *, causal=True, window=0, prefix=0,
                           q_offset=0, scale=None):
    """q: (B, Hq, S, D); k, v: (B, Hkv, T, D).  Full quadratic scores in
    f32; returns (B, Hq, S, Dv) in q.dtype."""
    b, hq, s_q, d = q.shape
    _, hkv, s_k, _ = k.shape
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, hkv, g, s_q, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    qpos = torch.arange(s_q, device=q.device)[:, None] + q_offset
    kpos = torch.arange(s_k, device=q.device)[None, :]
    ok = allowed_fn(qpos, kpos, causal=causal, window=window, prefix=prefix)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, s_q, v.shape[-1]).to(q.dtype)


_SCHEDULES = caches.LRUCache("attention-block-schedule", 256,
                             env_var="REPRO_ATTN_SCHED_CAP")
#: the schedules' device tensors, per step, keyed by schedule and device
_PLANS = caches.LRUCache("attention-block-plan", 256,
                         env_var="REPRO_ATTN_SCHED_CAP")


def _balanced_schedule(s_q: int, s_k: int, bq: int, bk: int, causal: bool,
                       window: int, prefix: int, q_offset: int,
                       chunk: int = 8):
    """Host symbolic phase: per-q-block tile lists, folded into G groups of
    2 rows with near-equal total work, padded to a common chunked length.
    Cached in the "attention-block-schedule" LRU.

    Returns numpy arrays, the reference's bit for bit:
      q_ids       (G, 2)  row ids of the two members
      scatter_ids (G, 2)  row each member writes (nq: a duplicate, dropped)
      kv_ids      (G, E)  gathered kv block per entry (pad: 0)
      member      (G, E)  0/1 member index per entry
      valid       (G, E)  entry is real
    and the chunk length (E is a multiple of it).
    """
    key = (s_q, s_k, bq, bk, causal, window, prefix, q_offset, chunk)
    hit = _SCHEDULES.get(key)
    if hit is not None:
        return hit
    nq, nk = s_q // bq, s_k // bk
    i = np.arange(nq)[:, None]
    j = np.arange(nk)[None, :]
    q_lo, q_hi = i * bq + q_offset, (i + 1) * bq - 1 + q_offset
    k_lo, k_hi = j * bk, (j + 1) * bk - 1
    ok = np.ones((nq, nk), bool)
    if causal:
        ok &= k_lo <= q_hi
    if window > 0:
        in_win = (q_lo - k_hi) < window
        if causal:
            in_win &= (q_hi - k_lo) >= 0
        else:
            in_win &= (k_lo - q_hi) < window
        ok &= in_win | np.broadcast_to(k_lo < prefix, in_win.shape)
    if prefix > 0 and window == 0:
        ok |= (k_lo < prefix) & (q_lo < prefix).reshape(-1, 1)
    ok[~ok.any(axis=1), 0] = True

    lists = [np.nonzero(ok[r])[0] for r in range(nq)]
    order = np.argsort([-len(l) for l in lists], kind="stable")
    if nq % 2:                      # odd: last group has one member
        order = np.concatenate([order, [order[-1]]])
    half = len(order) // 2
    groups = [(order[t], order[len(order) - 1 - t]) for t in range(half)]

    raw_e = max(len(lists[a]) + (len(lists[b]) if b != a else 0)
                for a, b in groups)
    steps = max(1, -(-raw_e // chunk))
    E = steps * (-(-raw_e // steps))
    G = len(groups)
    q_ids = np.zeros((G, 2), np.int32)
    scatter_ids = np.full((G, 2), nq, np.int32)   # nq == dropped write
    kv_ids = np.zeros((G, E), np.int32)
    member = np.zeros((G, E), np.int32)
    valid = np.zeros((G, E), bool)
    seen = set()
    for g, (a, b) in enumerate(groups):
        q_ids[g] = (a, b)
        for slot, row in ((0, int(a)), (1, int(b))):
            if row not in seen:        # duplicated rows write exactly once
                seen.add(row)
                scatter_ids[g, slot] = row
        ents = [(0, int(x)) for x in lists[a]]
        if b != a:
            ents += [(1, int(x)) for x in lists[b]]
        for e, (m, kvb) in enumerate(ents):
            member[g, e] = m
            kv_ids[g, e] = kvb
            valid[g, e] = True
    out = (q_ids, scatter_ids, kv_ids, member, valid, E // steps)
    _SCHEDULES.put(key, out)
    return out


def _device_plan(s_q, s_k, bq, bk, causal, window, prefix, q_offset, device):
    """The schedule on ``device``, cut into its steps: per step the chunk's
    q-block rows, kv blocks and members (each (G, c)) and its element mask
    (G, c, bq, bk), the ``valid`` flags folded in; and the scatter rows
    (2G,).  Cached in the "attention-block-plan" LRU."""
    key = (s_q, s_k, bq, bk, causal, window, prefix, q_offset, str(device))
    hit = _PLANS.get(key)
    if hit is not None:
        return hit
    q_ids, scatter_ids, kv_ids, member, valid, chunk = _balanced_schedule(
        s_q, s_k, bq, bk, causal, window, prefix, q_offset)
    G, E = kv_ids.shape
    qrow, kv, mem, val = (torch.as_tensor(x, device=device) for x in (
        np.take_along_axis(q_ids, member, axis=1).astype(np.int64),
        kv_ids.astype(np.int64), member.astype(np.int64), valid))
    qpos = qrow[:, :, None, None] * bq + torch.arange(
        bq, device=device)[:, None] + q_offset
    kpos = kv[:, :, None, None] * bk + torch.arange(bk, device=device)
    ok = allowed_fn(qpos, kpos, causal=causal, window=window, prefix=prefix)
    ok &= val[:, :, None, None]
    steps = [tuple(x[:, t * chunk:(t + 1) * chunk].contiguous()
                   for x in (qrow, kv, mem, ok))
             for t in range(E // chunk)]
    plan = (steps, torch.as_tensor(scatter_ids.reshape(-1).astype(np.int64),
                                   device=device), G, chunk)
    _PLANS.put(key, plan)
    return plan


def _bmm_f32(a, b):
    """``a @ b`` batched, accumulated and returned in f32 with the operands
    in their own dtype (the reference's ``preferred_element_type=f32``).
    On a CUDA device bf16 operands stay bf16 (``out_dtype``); the CPU has
    no such product, so there they are widened (exact) and multiplied in
    f32, the same arithmetic."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def block_masked_attention(q, k, v, *, causal=True, window=0, prefix=0,
                           q_offset=0, scale=None, bq=128, bk=128):
    """Pull-based masked attention: only mask-admitted tiles are computed.

    q: (B, Hq, S, Dqk); k: (B, Hkv, T, Dqk); v: (B, Hkv, T, Dv).  Returns
    (B, Hq, S, Dv) in q.dtype.

    Each step of the schedule gathers its chunk's q, k and v tiles for
    every group at once and runs one batched product over (group, entry,
    batch, kv-head), the GQA group's query heads stacked as rows; scores
    and ``p.v`` accumulate in f32 from operands in their own dtype, and
    each entry's partial softmax folds into its member's running max,
    denominator and sum.  Shapes that are not block multiples, and a
    non-causal mask with no window, fall back to dense attention, as in the
    reference.
    """
    global BLOCK_MASKED_CALLS, BLOCK_MASKED_FALLBACKS
    b, hq, s_q, d = q.shape
    _, hkv, s_k, _ = k.shape
    g_rep = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    bq_, bk_ = min(bq, s_q), min(bk, s_k)
    if s_q % bq_ or s_k % bk_:
        BLOCK_MASKED_FALLBACKS += 1
        return dense_masked_attention(q, k, v, causal=causal, window=window,
                                      prefix=prefix, q_offset=q_offset,
                                      scale=scale)
    if not causal and window == 0:
        # mask fully dense -> the plain product IS the masked product
        BLOCK_MASKED_FALLBACKS += 1
        return dense_masked_attention(q, k, v, causal=False, window=0,
                                      prefix=0, q_offset=q_offset,
                                      scale=scale)
    BLOCK_MASKED_CALLS += 1
    steps, scatter, G, c = _device_plan(s_q, s_k, bq_, bk_, bool(causal),
                                        int(window), int(prefix),
                                        int(q_offset), q.device)
    dv = v.shape[-1]
    nq, nk = s_q // bq_, s_k // bk_
    rows = g_rep * bq_                 # a GQA group's query rows of a tile
    p_dtype = torch.promote_types(v.dtype, torch.bfloat16)
    # tiles leading: q (nq, B, Hkv, g_rep * bq, D), k / v (nk, B, Hkv, bk, D)
    qt = (q.reshape(b, hkv, g_rep, nq, bq_, d).permute(3, 0, 1, 2, 4, 5)
          .reshape(nq, b, hkv, rows, d))
    kt = k.reshape(b, hkv, nk, bk_, d).permute(2, 0, 1, 3, 4).contiguous()
    vt = v.reshape(b, hkv, nk, bk_, dv).permute(2, 0, 1, 3, 4).contiguous()
    rest = (b, hkv, g_rep, bq_)        # one member's rows
    m_run = torch.full((G, 2) + rest, NEG_INF, device=q.device)
    l_run = torch.zeros((G, 2) + rest, device=q.device)
    acc = torch.zeros((G, 2) + rest + (dv,), device=q.device)
    n = G * c * b * hkv
    for qrow, kv_e, mem_e, ok in steps:
        qe = qt[qrow].reshape(n, rows, d)
        ke = kt[kv_e].reshape(n, bk_, d)
        ve = vt[kv_e].reshape(n, bk_, dv)
        s = _bmm_f32(qe, ke.transpose(1, 2)) * scale
        s = s.reshape(G, c, b, hkv, g_rep, bq_, bk_)
        okb = ok[:, :, None, None, None]        # (G, c, 1, 1, 1, bq, bk)
        s = torch.where(okb, s, NEG_INF)
        # per-entry partials
        m_e = s.amax(dim=-1)                            # (G, c, *rest)
        p = torch.where(okb, torch.exp(s - m_e[..., None]), 0.0)
        l_e = p.sum(dim=-1)
        o_e = _bmm_f32(p.to(p_dtype).reshape(n, rows, bk_), ve)
        o_e = o_e.reshape(G, c, b, hkv, g_rep, bq_, dv)
        # combine the chunk's entries into the 2 members
        sel = torch.nn.functional.one_hot(mem_e, 2).float()     # (G, c, 2)
        m_e = torch.where(l_e > 0, m_e, NEG_INF)
        mem_b = mem_e.reshape(G, c, 1, 1, 1, 1)
        m_grp = torch.stack(
            [torch.where(mem_b == m, m_e, NEG_INF).amax(dim=1)
             for m in (0, 1)], dim=1)                   # (G, 2, *rest)
        m_new = torch.maximum(m_run, m_grp)
        m_new_e = torch.where(mem_b == 1, m_new[:, 1:2], m_new[:, 0:1])
        w_e = torch.exp(m_e - m_new_e) * (l_e > 0)      # (G, c, *rest)
        l_add = torch.einsum("gcm,gcbhrq->gmbhrq", sel, w_e * l_e)
        o_add = torch.einsum("gcm,gcbhrqd->gmbhrqd", sel,
                             w_e[..., None] * o_e)
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + l_add
        acc = acc * alpha[..., None] + o_add
        m_run = m_new
    # where-guarded denominator (the reference's, kept for fully-masked
    # members)
    l_safe = torch.where(l_run > 0, l_run, 1.0)[..., None]
    out_g = torch.where(l_run[..., None] > 0, acc / l_safe, 0.0)
    # scatter rows back; duplicate members write the dropped row nq
    out = torch.zeros((nq + 1, b, hkv, g_rep, bq_, dv), device=q.device)
    out.index_copy_(0, scatter, out_g.reshape((2 * G,) + rest + (dv,)))
    out = out[:nq].permute(1, 2, 3, 0, 4, 5).reshape(b, hq, s_q, dv)
    return out.to(q.dtype)


def attention(q, k, v, *, impl="block_masked", causal=True, window=0,
              prefix=0, q_offset=0, scale=None, block=128):
    if impl == "dense_masked":
        return dense_masked_attention(q, k, v, causal=causal, window=window,
                                      prefix=prefix, q_offset=q_offset,
                                      scale=scale)
    if impl == "block_masked":
        return block_masked_attention(q, k, v, causal=causal, window=window,
                                      prefix=prefix, q_offset=q_offset,
                                      scale=scale, bq=block, bk=block)
    if impl == "flash_pallas":
        from repro_torch.kernels.flash_mask.ops import flash_mask_attention
        return flash_mask_attention(q, k, v, causal=causal, window=window,
                                    prefix=prefix, q_offset=q_offset,
                                    scale=scale, bq=block, bk=block)
    raise ValueError(f"unknown attention impl {impl!r}")


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0, prefix=0,
                     scale=None):
    """One-token decode in f32. q: (B, Hq, D); caches: (B, Hkv, T, D).

    ``cache_len``: (B,) int — valid prefix length (query position is
    cache_len - 1 after the cache insert).  Ring-buffered caches pass the
    physical layout; masking is by validity only, so ``window`` and
    ``prefix`` are accepted and unused, as in the reference.
    """
    b, hq, d = q.shape
    _, hkv, t, _ = k_cache.shape
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhtd->bhgt", qg.float(), k_cache.float()) * scale
    pos = torch.arange(t, device=q.device)[None, :]
    ok = pos < cache_len[:, None]                      # (B, T)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, v_cache.shape[-1]).to(q.dtype)
