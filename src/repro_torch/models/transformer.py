"""Model assembly: the decoder-only families (dense, MoE with or without
MLA, and the VLM backbone).

``Transformer`` holds the embedding, an ``nn.ModuleList`` of pre-norm
residual blocks (attention or MLA, then an MLP or MoE) and the final norm;
the head is the embedding's transpose when ``cfg.tie_embeddings``.  In the
``moe`` family the first ``cfg.first_k_dense`` blocks take a dense MLP and
the rest the MoE (the reference's ``layers_dense`` and ``layers_moe``
stacks); the ``vlm`` family projects precomputed image patches
(``patch_proj``) into a bidirectional prefix before the tokens.  As in
the reference, the family exposes ``init_params``, ``forward`` (logits),
``init_cache`` and ``decode_step`` (one token), each taking the config
beside the weights, so one model runs under every config of its shapes
(e.g. ``attn_impl`` or ``dtype`` replaced).  Layers run one after another
(the reference scans stacked layers).  The SSM, xLSTM, hybrid and audio
families are not ported yet and raise.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from . import layers as Lyr
from .common import dense_init

#: families the port runs
PORTED_FAMILIES = ("dense", "moe", "vlm")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; the port runs "
            f"the {', '.join(PORTED_FAMILIES)} families (ROADMAP.md queue 1, "
            f"item 11)")


def n_dense_layers(cfg: ModelConfig) -> int:
    """Leading blocks with a dense MLP (the reference's ``layers_dense``);
    the rest take the MoE."""
    return cfg.first_k_dense if cfg.moe is not None else cfg.n_layers


class Block(nn.Module):
    """Pre-norm residual block: x + attn(ln1(x)), then + ffn(ln2(x)); the
    attention is MLA when ``cfg.mla`` is set, the ffn a MoE when
    ``use_moe``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 use_moe: bool = False):
        super().__init__()
        self.ln1 = Lyr.Norm(cfg, generator.device)
        self.attn = (Lyr.MLA(cfg, generator) if cfg.mla is not None
                     else Lyr.Attention(cfg, generator))
        self.ln2 = Lyr.Norm(cfg, generator.device)
        self.ffn = (Lyr.MoE(cfg, generator) if use_moe
                    else Lyr.MLP(cfg, generator))

    def forward(self, x, positions, cfg: ModelConfig, prefix: int = 0):
        h = self.ln1(x)
        if isinstance(self.attn, Lyr.MLA):
            h = self.attn(h, positions, cfg)
        else:
            h = self.attn(h, positions, cfg, prefix=prefix)
        x = x + h
        return x + self.ffn(self.ln2(x), cfg)

    def decode(self, x, cache, pos, cfg: ModelConfig):
        h, cache = self.attn.decode(self.ln1(x), cache, pos, cfg)
        x = x + h
        return x + self.ffn(self.ln2(x), cfg), cache


class Transformer(nn.Module):
    """Decoder-only LM: ``embed`` (V, D), ``blocks``, ``final_ln``, unless
    tied ``lm_head`` (D, V), and for the VLM ``patch_proj`` (d_frontend,
    D).  ``cfg`` is the config it was built with, the default of every
    call."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        self.embed = Lyr._param(dense_init(
            generator, (cfg.vocab_size, cfg.d_model), scale=1.0))
        self.lm_head = (None if cfg.tie_embeddings else Lyr._param(
            dense_init(generator, (cfg.d_model, cfg.vocab_size))))
        kd = n_dense_layers(cfg)
        self.blocks = nn.ModuleList(Block(cfg, generator, use_moe=i >= kd)
                                    for i in range(cfg.n_layers))
        self.final_ln = Lyr.Norm(cfg, generator.device)
        self.patch_proj = (Lyr._param(dense_init(
            generator, (cfg.d_frontend, cfg.d_model)))
            if cfg.family == "vlm" else None)

    def _embed(self, tokens, cfg: ModelConfig):
        return self.embed[tokens].to(cfg.activation_dtype)

    def _logits(self, x):
        head = self.embed.T if self.lm_head is None else self.lm_head
        return x @ head.to(x.dtype)

    def forward(self, tokens, cfg: ModelConfig = None, patches=None):
        """tokens: (B, S) int [+ patches (B, P, d_frontend) for the VLM] ->
        logits (B, P + S, V) in the activation dtype."""
        cfg = self.cfg if cfg is None else cfg
        _require_ported(cfg)
        x = self._embed(tokens, cfg)
        prefix = 0
        if cfg.family == "vlm":
            pe = patches.to(x.dtype) @ self.patch_proj.to(x.dtype)
            x = torch.cat([pe, x], dim=1)
            prefix = cfg.img_tokens
        b, s = x.shape[:2]
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        for block in self.blocks:
            x = block(x, positions, cfg, prefix)
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
    """batch: ``{"tokens": (B, S)}`` [+ ``"patches"`` (B, P, d_frontend)
    for the VLM].  Returns logits (B, P + S, V)."""
    return model(batch["tokens"], cfg, batch.get("patches"))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Per-layer caches stacked on a leading layer axis, as the reference
    lays them out: ``{"dense": ..., "moe": ...}`` for the dense-MLP and MoE
    blocks (None where a model has none), each ``{"k", "v"}`` or, with
    MLA, ``{"kv_c", "k_rope"}``."""
    _require_ported(cfg)
    kd = n_dense_layers(cfg)
    dt = cfg.activation_dtype

    def stack(n):
        if not n:
            return None
        if cfg.mla is not None:
            return Lyr.mla_cache_init(cfg, batch, max_len, dt, device, n)
        return Lyr.attn_cache_init(cfg, batch, max_len, dt, device, n)
    return {"dense": stack(kd), "moe": stack(cfg.n_layers - kd)}


@torch.no_grad()
def decode_step(model: Transformer, cfg: ModelConfig, token, cache, pos):
    """One decode step.  token: (B,) int; pos: (B,) absolute position.
    Returns (logits (B, V), cache); the cache is updated in place."""
    _require_ported(cfg)
    x = model._embed(token, cfg)[:, None, :]
    kd = n_dense_layers(cfg)
    for i, block in enumerate(model.blocks):
        stacked = cache["dense"] if i < kd else cache["moe"]
        j = i if i < kd else i - kd
        x, _ = block.decode(x, {name: t[j] for name, t in stacked.items()},
                            pos, cfg)
    return model._logits(model.final_ln(x))[:, 0], cache
