"""Batched serving: token-by-token decode (greedy / temperature).

``serve_step`` is one new token for every sequence in the batch against
the KV cache.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def make_serve_step(cfg: ModelConfig):
    """The decode step for ``cfg``'s family (dense, MoE with or without
    MLA, and the VLM backbone on its text tokens, as the reference's)."""
    T._require_ported(cfg)

    def serve_step(model, token, cache, pos):
        return T.decode_step(model, cfg, token, cache, pos)
    return serve_step


@torch.no_grad()
def generate(model: T.Transformer, cfg: ModelConfig, prompt_tokens, *,
             max_new: int = 16, temperature: float = 0.0,
             generator: torch.Generator = None):
    """Greedy/temperature generation.  prompt_tokens: (B, S0) int.

    Teacher-forces the prompt through ``decode_step`` (exercising the cache
    path), then samples ``max_new`` tokens: the argmax at temperature 0,
    else a draw from softmax(logits / temperature) with ``generator``.
    Returns (B, S0 + max_new) int32.
    """
    b, s0 = prompt_tokens.shape
    dev = prompt_tokens.device
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs an explicit generator")
    cache = T.init_cache(cfg, b, s0 + max_new, device=dev)
    step = make_serve_step(cfg)
    logits = None
    for t in range(s0):
        logits, cache = step(model, prompt_tokens[:, t], cache,
                             torch.full((b,), t, dtype=torch.int32,
                                        device=dev))
    out = [prompt_tokens.to(torch.int32)]
    for i in range(max_new):
        if temperature > 0.0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            cur = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            cur = torch.argmax(logits, dim=-1)
        cur = cur.to(torch.int32)
        out.append(cur[:, None])
        if i < max_new - 1:
            logits, cache = step(model, cur, cache,
                                 torch.full((b,), s0 + i, dtype=torch.int32,
                                            device=dev))
    return torch.cat(out, dim=1)
