"""Dense oracle for block-masked flash attention.

The mask family is parametric (causal / sliding-window / dense-prefix):

    allowed(q, k) = causal_ok(q, k) AND (window_ok(q, k) OR k < prefix)

with absolute query position  q_abs = q + q_offset  (q_offset > 0 during
decode, where queries sit at the end of a longer KV history).
"""
from __future__ import annotations

import numpy as np
import torch


def mask_allowed(s_q: int, s_k: int, *, causal: bool, window: int,
                 prefix: int, q_offset: int) -> np.ndarray:
    """(s_q, s_k) bool array of the parametric mask."""
    q = np.arange(s_q)[:, None] + q_offset
    k = np.arange(s_k)[None, :]
    ok = np.ones((s_q, s_k), bool)
    if causal:
        ok &= k <= q
    if window > 0:
        ok &= ((q - k) < window) | (k < prefix)
    return ok


def flash_mask_ref(q, k, v, *, causal=True, window=0, prefix=0,
                   q_offset=0, scale=None) -> torch.Tensor:
    """Dense masked attention oracle in f32. q: (S, D); k, v: (T, D).
    Fully masked rows come out as zeros (the kernel's l == 0 rule)."""
    s_q, d = q.shape
    s_k = k.shape[0]
    scale = (d ** -0.5) if scale is None else scale
    s = (q.float() @ k.float().T) * scale
    ok = torch.as_tensor(mask_allowed(s_q, s_k, causal=causal, window=window,
                                      prefix=prefix, q_offset=q_offset),
                         device=q.device)
    s = torch.where(ok, s, -torch.inf)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.where(ok, torch.exp(s - torch.where(ok.any(-1, keepdim=True),
                                                  m, 0.0)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = p @ v.float()
    return torch.where(l > 0, o / torch.clamp(l, min=1e-30), 0.0)
