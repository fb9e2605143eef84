"""Attention as Masked SpGEMM (the paper's technique inside the LM stack).

``scores = M (.) (Q Kᵀ)`` is a masked matrix product with a *structured*
mask (causal / sliding-window / dense-prefix).  The port has two of the
reference's three implementations:

* ``dense_masked`` — compute ALL scores, then mask (the paper's Fig.-1
  strawman), in plain PyTorch.
* ``flash_pallas`` — the block-masked flash kernel
  (``repro_torch.kernels.flash_mask``): only mask-admitted tiles, one CUDA
  launch for every (batch, head).

``block_masked`` (the reference's XLA scan of balanced tile chunks) is not
ported yet and raises.  ``decode_attention`` is the serve-time single-token
path over a (possibly ring-buffered) KV cache.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


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


def attention(q, k, v, *, impl="block_masked", causal=True, window=0,
              prefix=0, q_offset=0, scale=None, block=128):
    if impl == "dense_masked":
        return dense_masked_attention(q, k, v, causal=causal, window=window,
                                      prefix=prefix, q_offset=q_offset,
                                      scale=scale)
    if impl == "block_masked":
        raise NotImplementedError(
            "attention impl 'block_masked' is not ported yet (ROADMAP.md "
            "queue 1, item 9); use 'flash_pallas' or 'dense_masked'")
    if impl == "flash_pallas":
        from repro_torch.kernels.flash_mask.ops import flash_mask_attention
        return flash_mask_attention(q, k, v, causal=causal, window=window,
                                    prefix=prefix, q_offset=q_offset,
                                    scale=scale, bq=block, bk=block)
    raise ValueError(f"unknown attention impl {impl!r}")


def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None):
    """One-token decode in f32. q: (B, Hq, D); caches: (B, Hkv, T, D).

    ``cache_len``: (B,) int — valid prefix length (query position is
    cache_len - 1 after the cache insert).  Ring-buffered caches pass the
    physical layout; masking is by validity only.
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
