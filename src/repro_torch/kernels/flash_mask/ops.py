"""Public masked-attention op: schedule cache + batched, GQA-aware kernel.

``flash_mask_attention`` is ``attention(impl="flash_pallas")``'s runtime
path.  Unlike the reference, which vmaps a single-head kernel over batch
and heads, the whole (batch, head) loop runs inside one kernel launch.
"""
from __future__ import annotations

import torch

from repro_torch import caches

from .kernel import build_schedule, flash_mask_kernel

#: worklists on the device, keyed by shape, mask pattern and device
_SCHED = caches.LRUCache("flash-sched", 256, env_var="REPRO_FLASH_SCHED_CAP")


def _sched(s_q, s_k, bq, bk, causal, window, prefix, q_offset, device):
    key = (s_q, s_k, bq, bk, causal, window, prefix, q_offset, str(device))
    hit = _SCHED.get(key)
    if hit is None:
        arrays = build_schedule(s_q, s_k, bq=bq, bk=bk, causal=causal,
                                window=window, prefix=prefix,
                                q_offset=q_offset)
        hit = tuple(torch.as_tensor(x, device=device) for x in arrays)
        _SCHED.put(key, hit)
    return hit


def flash_mask_attention(q, k, v, *, causal=True, window=0, prefix=0,
                         q_offset=0, scale=None, bq=128, bk=128):
    """Masked multi-head attention, GQA-aware.

    q: (B, Hq, S, D);  k, v: (B, Hkv, T, D) with Hq % Hkv == 0.
    Returns (B, Hq, S, D) in q.dtype.  Blocks are cut to the sequence
    (``min(bq, S)``, ``min(bk, T)``); a sequence they do not divide raises.
    """
    d = q.shape[-1]
    s_q, s_k = q.shape[2], k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    bq_, bk_ = min(bq, s_q), min(bk, s_k)
    qi, ki, flags = _sched(s_q, s_k, bq_, bk_, bool(causal), int(window),
                           int(prefix), int(q_offset), q.device)
    return flash_mask_kernel(q, k, v, qi, ki, flags, bq=bq_, bk=bk_,
                             scale=scale, causal=causal, window=window,
                             prefix=prefix, q_offset=q_offset)
