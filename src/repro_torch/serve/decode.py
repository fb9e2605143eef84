"""Batched serving: token-by-token decode (greedy / temperature).

``serve_step`` is one new token for every sequence in the batch against
the model's cache (KV, recurrent state, or both); the encoder-decoder's
also attends to the encoder output, computed once per request
(``Transformer.encode``).  On a sharded model (``train_step.shard_model``
with ``zero1=False``) each rank passes its rows of the tokens, positions
and encoder output (the reference's ``P(DP)``) and its slices of the
cache (``transformer.shard_cache``); ``generate`` makes those slices
itself, and every rank gets whole logits and its rows' tokens.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def make_serve_step(cfg: ModelConfig):
    """The decode step for ``cfg``'s family, as the reference's: every
    family of ``T.PORTED_FAMILIES``; ``encoder_out`` is passed on for the
    encoder-decoder only."""
    T._check_family(cfg)

    def serve_step(model, token, cache, pos, encoder_out=None):
        if cfg.family == "audio":
            return T.decode_step(model, cfg, token, cache, pos,
                                 encoder_out=encoder_out)
        return T.decode_step(model, cfg, token, cache, pos)
    return serve_step


@torch.no_grad()
def generate(model: T.Transformer, cfg: ModelConfig, prompt_tokens, *,
             max_new: int = 16, temperature: float = 0.0,
             generator: torch.Generator = None, encoder_out=None):
    """Greedy/temperature generation.  prompt_tokens: (B, S0) int.

    Teacher-forces the prompt through ``decode_step`` (exercising the cache
    path), then samples ``max_new`` tokens: the argmax at temperature 0,
    else a draw from softmax(logits / temperature) with ``generator``;
    the encoder-decoder attends to ``encoder_out`` at every step.  Returns
    (B, S0 + max_new) int32.  On a sharded model B is the rank's rows and
    the cache is made as its slices (``init_sharded_cache``).
    """
    b, s0 = prompt_tokens.shape
    dev = prompt_tokens.device
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs an explicit generator")
    lay = model.shard_layout
    if lay is None:
        cache = T.init_cache(cfg, b, s0 + max_new, device=dev)
    else:
        cache = T.init_sharded_cache(model, cfg, b * lay.axes["dp"].size,
                                     s0 + max_new, device=dev)
    step = make_serve_step(cfg)
    logits = None
    for t in range(s0):
        logits, cache = step(model, prompt_tokens[:, t], cache,
                             torch.full((b,), t, dtype=torch.int32,
                                        device=dev), encoder_out)
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
                                            device=dev), encoder_out)
    return torch.cat(out, dim=1)
