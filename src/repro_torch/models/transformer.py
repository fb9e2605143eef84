"""Model assembly: the dense decoder-only family.

``Transformer`` holds the embedding, an ``nn.ModuleList`` of pre-norm
residual blocks (attention, then MLP) and the final norm; the head is the
embedding's transpose when ``cfg.tie_embeddings``.  As in the reference,
the family exposes ``init_params``, ``forward`` (logits), ``init_cache`` and
``decode_step`` (one token), each taking the config beside the weights, so
one model runs under every config of its shapes (e.g. ``attn_impl`` or
``dtype`` replaced).  Layers run one after another (the reference scans
stacked layers).  The other families (MoE, MLA, SSM, xLSTM, hybrid,
audio, VLM) are not ported yet and raise.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from . import layers as Lyr
from .common import dense_init

#: families the port runs
PORTED_FAMILIES = ("dense",)


def _require_ported(cfg: ModelConfig) -> None:
    if (cfg.family not in PORTED_FAMILIES or cfg.moe is not None
            or cfg.mla is not None):
        raise NotImplementedError(
            f"model family {cfg.family!r} (moe={cfg.moe is not None}, "
            f"mla={cfg.mla is not None}) is not ported yet; the port runs "
            f"the dense family (ROADMAP.md queue 1, item 11)")


class Block(nn.Module):
    """Pre-norm residual block: x + attn(ln1(x)), then + mlp(ln2(x))."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.ln1 = Lyr.Norm(cfg, generator.device)
        self.attn = Lyr.Attention(cfg, generator)
        self.ln2 = Lyr.Norm(cfg, generator.device)
        self.ffn = Lyr.MLP(cfg, generator)

    def forward(self, x, positions, cfg: ModelConfig):
        x = x + self.attn(self.ln1(x), positions, cfg)
        return x + self.ffn(self.ln2(x))

    def decode(self, x, cache, pos, cfg: ModelConfig):
        h, cache = self.attn.decode(self.ln1(x), cache, pos, cfg)
        x = x + h
        return x + self.ffn(self.ln2(x)), cache


class Transformer(nn.Module):
    """Decoder-only LM of the dense family: ``embed`` (V, D), ``blocks``,
    ``final_ln`` and, unless tied, ``lm_head`` (D, V).  ``cfg`` is the
    config it was built with, the default of every call."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        self.embed = Lyr._param(dense_init(
            generator, (cfg.vocab_size, cfg.d_model), scale=1.0))
        self.lm_head = (None if cfg.tie_embeddings else Lyr._param(
            dense_init(generator, (cfg.d_model, cfg.vocab_size))))
        self.blocks = nn.ModuleList(Block(cfg, generator)
                                    for _ in range(cfg.n_layers))
        self.final_ln = Lyr.Norm(cfg, generator.device)

    def _embed(self, tokens, cfg: ModelConfig):
        return self.embed[tokens].to(cfg.activation_dtype)

    def _logits(self, x):
        head = self.embed.T if self.lm_head is None else self.lm_head
        return x @ head.to(x.dtype)

    def forward(self, tokens, cfg: ModelConfig = None):
        """tokens: (B, S) int -> logits (B, S, V) in the activation dtype."""
        cfg = self.cfg if cfg is None else cfg
        _require_ported(cfg)
        b, s = tokens.shape
        x = self._embed(tokens, cfg)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        for block in self.blocks:
            x = block(x, positions, cfg)
        return self._logits(self.final_ln(x))


def init_params(cfg: ModelConfig, generator: torch.Generator = None, *,
                seed: int = 0, device="cuda") -> Transformer:
    """A ``Transformer`` with random weights drawn from ``generator`` (or a
    new generator on ``device`` seeded with ``seed``), on its device."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return Transformer(cfg, generator)


@torch.no_grad()
def forward(model: Transformer, cfg: ModelConfig, batch: Dict[str, Any]):
    """batch: ``{"tokens": (B, S)}``.  Returns logits (B, S, V)."""
    return model(batch["tokens"], cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Per-layer KV caches stacked on a leading layer axis, as the
    reference lays them out: ``{"dense": {"k", "v"}, "moe": None}``."""
    _require_ported(cfg)
    return {"dense": Lyr.attn_cache_init(cfg, batch, max_len,
                                         cfg.activation_dtype, device,
                                         cfg.n_layers),
            "moe": None}


@torch.no_grad()
def decode_step(model: Transformer, cfg: ModelConfig, token, cache, pos):
    """One decode step.  token: (B,) int; pos: (B,) absolute position.
    Returns (logits (B, V), cache); the cache is updated in place."""
    _require_ported(cfg)
    x = model._embed(token, cfg)[:, None, :]
    stacked = cache["dense"]
    for i, block in enumerate(model.blocks):
        x, _ = block.decode(x, {"k": stacked["k"][i], "v": stacked["v"][i]},
                            pos, cfg)
    return model._logits(model.final_ln(x))[:, 0], cache
