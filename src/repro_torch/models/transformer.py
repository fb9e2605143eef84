"""Model assembly for every architecture family.

``Transformer`` holds the embedding, an ``nn.ModuleList`` of pre-norm
residual blocks and the final norm; the head is the embedding's transpose
when ``cfg.tie_embeddings``.  The families:

* ``dense``, ``moe``, ``vlm``: blocks of attention (MLA when ``cfg.mla``)
  then an MLP, or a MoE after the first ``cfg.first_k_dense`` blocks (the
  reference's ``layers_dense`` and ``layers_moe`` stacks); the VLM
  projects precomputed image patches (``patch_proj``) into a
  bidirectional prefix before the tokens;
* ``ssm`` with ``cfg.xlstm`` (xLSTM): ``n_layers // slstm_every``
  super-blocks of (slstm_every - 1) mLSTM blocks and one sLSTM block,
  flattened in execution order;
* ``hybrid`` (Zamba2): Mamba2 SSM blocks, and one ``shared_attn``
  attention+MLP block (a single weight set) applied after block i when
  (i + 1) % ``hybrid_attn_every`` == 0, each application with its own KV
  cache;
* ``audio`` (encoder-decoder): ``frame_proj``, bidirectional encoder
  blocks (``enc_blocks``, ``encfinal_ln``; ``encode`` computes the
  encoder output once for a server), then decoder blocks of causal
  self-attention, cross-attention over the encoder output and an MLP.

As in the reference, the family exposes ``init_params``, ``forward``
(logits), ``init_cache`` and ``decode_step`` (one token), each taking the
config beside the weights, so one model runs under every config of its
shapes (e.g. ``attn_impl`` or ``dtype`` replaced).  Layers run one after
another (the reference scans stacked layers).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from . import layers as Lyr
from . import ssm as SSM
from . import xlstm as XL
from .common import dense_init

#: the families the port runs, as the reference's ``init_params`` knows
#: them (``ssm`` only with ``cfg.xlstm``)
PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES or (cfg.family == "ssm"
                                             and cfg.xlstm is None):
        raise ValueError(f"family {cfg.family}")


def n_dense_layers(cfg: ModelConfig) -> int:
    """Leading blocks with a dense MLP (the reference's ``layers_dense``);
    the rest take the MoE."""
    return cfg.first_k_dense if cfg.moe is not None else cfg.n_layers


def n_shared_attn(cfg: ModelConfig) -> int:
    """Applications of the hybrid's shared attention block (one KV cache
    each)."""
    return cfg.n_layers // cfg.hybrid_attn_every


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

    def forward(self, x, positions, cfg: ModelConfig, prefix: int = 0, *,
                causal: bool = True, window=None):
        h = self.ln1(x)
        if isinstance(self.attn, Lyr.MLA):
            h = self.attn(h, positions, cfg)
        else:
            h = self.attn(h, positions, cfg, prefix=prefix, causal=causal,
                          window=window)
        x = x + h
        return x + self.ffn(self.ln2(x), cfg)

    def decode(self, x, cache, pos, cfg: ModelConfig):
        h, cache = self.attn.decode(self.ln1(x), cache, pos, cfg)
        x = x + h
        return x + self.ffn(self.ln2(x), cfg), cache


class MixerBlock(nn.Module):
    """Pre-norm residual block around a recurrent mixer (``SSM``, ``mLSTM``
    or ``sLSTM``): x + mixer(ln1(x))."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, kind):
        super().__init__()
        self.ln1 = Lyr.Norm(cfg, generator.device)
        self.mixer = kind(cfg, generator)

    def forward(self, x, cfg: ModelConfig):
        return x + self.mixer(self.ln1(x), cfg)

    def decode(self, x, cache, cfg: ModelConfig):
        h, cache = self.mixer.decode(self.ln1(x), cache, cfg)
        return x + h, cache


class DecoderBlock(nn.Module):
    """The encoder-decoder's decoder block: x + attn(ln1(x)) (causal), then
    + cross(ln2(x), encoder output), then + ffn(ln3(x))."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        dev = generator.device
        self.ln1 = Lyr.Norm(cfg, dev)
        self.attn = Lyr.Attention(cfg, generator)
        self.ln2 = Lyr.Norm(cfg, dev)
        self.cross = Lyr.Attention(cfg, generator)
        self.ln3 = Lyr.Norm(cfg, dev)
        self.ffn = Lyr.MLP(cfg, generator)

    def forward(self, x, positions, enc, cfg: ModelConfig):
        x = x + self.attn(self.ln1(x), positions, cfg)
        x = x + self.cross.cross(self.ln2(x), enc, cfg)
        return x + self.ffn(self.ln3(x), cfg)

    def decode(self, x, cache, pos, enc, cfg: ModelConfig):
        h, cache = self.attn.decode(self.ln1(x), cache, pos, cfg)
        x = x + h
        x = x + self.cross.cross(self.ln2(x), enc, cfg)
        return x + self.ffn(self.ln3(x), cfg), cache


def _xlstm_kind(cfg: ModelConfig, i: int):
    """Block i of an xLSTM stack: the last of each super-block is sLSTM."""
    r = cfg.xlstm.slstm_every
    return XL.sLSTM if i % r == r - 1 else XL.mLSTM


class Transformer(nn.Module):
    """The LM: ``embed`` (V, D), ``blocks``, ``final_ln``, unless tied
    ``lm_head`` (D, V); for the VLM ``patch_proj`` (d_frontend, D); for
    the hybrid ``shared_attn`` (a ``Block``); for the encoder-decoder
    ``frame_proj`` (d_frontend, D), ``enc_blocks`` and ``encfinal_ln``
    (``blocks`` are then the decoder's).  ``cfg`` is the config it was
    built with, the default of every call."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        dev = generator.device
        fam = cfg.family
        self.embed = Lyr._param(dense_init(
            generator, (cfg.vocab_size, cfg.d_model), scale=1.0))
        self.lm_head = (None if cfg.tie_embeddings else Lyr._param(
            dense_init(generator, (cfg.d_model, cfg.vocab_size))))
        self.patch_proj = self.shared_attn = self.frame_proj = None
        self.enc_blocks = self.encfinal_ln = None
        if fam in ("dense", "moe", "vlm"):
            kd = n_dense_layers(cfg)
            self.blocks = nn.ModuleList(
                Block(cfg, generator, use_moe=i >= kd)
                for i in range(cfg.n_layers))
            if fam == "vlm":
                self.patch_proj = Lyr._param(dense_init(
                    generator, (cfg.d_frontend, cfg.d_model)))
        elif fam == "ssm":
            n = cfg.n_layers // cfg.xlstm.slstm_every * cfg.xlstm.slstm_every
            self.blocks = nn.ModuleList(
                MixerBlock(cfg, generator, _xlstm_kind(cfg, i))
                for i in range(n))
        elif fam == "hybrid":
            self.blocks = nn.ModuleList(MixerBlock(cfg, generator, SSM.SSM)
                                        for _ in range(cfg.n_layers))
            self.shared_attn = Block(cfg, generator)
        else:                                            # audio
            self.enc_blocks = nn.ModuleList(Block(cfg, generator)
                                            for _ in range(cfg.n_enc_layers))
            self.blocks = nn.ModuleList(DecoderBlock(cfg, generator)
                                        for _ in range(cfg.n_dec_layers))
            self.encfinal_ln = Lyr.Norm(cfg, dev)
            self.frame_proj = Lyr._param(dense_init(
                generator, (cfg.d_frontend or cfg.d_model, cfg.d_model)))
        self.final_ln = Lyr.Norm(cfg, dev)

    def _embed(self, tokens, cfg: ModelConfig):
        return self.embed[tokens].to(cfg.activation_dtype)

    def _logits(self, x):
        head = self.embed.T if self.lm_head is None else self.lm_head
        return x @ head.to(x.dtype)

    def _shared(self, i: int, cfg: ModelConfig) -> bool:
        """Whether the hybrid's shared block runs after block i."""
        return (i + 1) % cfg.hybrid_attn_every == 0

    def encode(self, frames, cfg: ModelConfig = None):
        """The encoder-decoder's encoder: frames (B, S_src, d_frontend) ->
        the encoder output (B, S_src, D) in the activation dtype, which
        ``forward`` and every ``decode_step`` attend to."""
        cfg = self.cfg if cfg is None else cfg
        act = cfg.activation_dtype
        enc = frames.to(act) @ self.frame_proj.to(act)
        b, s = enc.shape[:2]
        positions = torch.arange(s, device=enc.device).expand(b, s)
        for block in self.enc_blocks:
            enc = block(enc, positions, cfg, causal=False, window=0)
        return self.encfinal_ln(enc)

    def forward(self, tokens, cfg: ModelConfig = None, patches=None,
                frames=None):
        """tokens: (B, S) int [+ patches (B, P, d_frontend) for the VLM;
        frames (B, S_src, d_frontend) for the encoder-decoder] -> logits
        (B, P + S, V) in the activation dtype."""
        cfg = self.cfg if cfg is None else cfg
        _check_family(cfg)
        fam = cfg.family
        enc = self.encode(frames, cfg) if fam == "audio" else None
        x = self._embed(tokens, cfg)
        prefix = 0
        if fam == "vlm":
            pe = patches.to(x.dtype) @ self.patch_proj.to(x.dtype)
            x = torch.cat([pe, x], dim=1)
            prefix = cfg.img_tokens
        b, s = x.shape[:2]
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        for i, block in enumerate(self.blocks):
            if fam in ("ssm", "hybrid"):
                x = block(x, cfg)
                if fam == "hybrid" and self._shared(i, cfg):
                    x = self.shared_attn(x, positions, cfg)
            elif fam == "audio":
                x = block(x, positions, enc, cfg)
            else:
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
    for the VLM, ``"frames"`` (B, S_src, d_frontend) for the
    encoder-decoder].  Returns logits (B, P + S, V)."""
    return model(batch["tokens"], cfg, batch.get("patches"),
                 batch.get("frames"))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Per-layer caches stacked on leading layer axes, as the reference
    lays them out:

    * dense, MoE, VLM: ``{"dense", "moe"}`` for the dense-MLP and MoE
      blocks (None where a model has none), each ``{"k", "v"}`` or, with
      MLA, ``{"kv_c", "k_rope"}``;
    * xLSTM: ``{"mlstm": {"C", "n", "m"}}`` on (n_super, r - 1) axes and
      ``{"slstm": {"c", "n", "m", "h"}}`` on (n_super,);
    * hybrid: ``{"ssm": {"S", "conv"}}`` per SSM block and ``{"attn":
      {"k", "v"}}`` per application of the shared block;
    * encoder-decoder: ``{"self": {"k", "v"}}`` per decoder block (cross-
      attention reads the encoder output, which has no cache).
    """
    _check_family(cfg)
    dt = cfg.activation_dtype
    fam = cfg.family
    if fam == "ssm":
        r = cfg.xlstm.slstm_every
        n_super = cfg.n_layers // r
        return {"mlstm": XL.mlstm_cache_init(cfg, batch, device,
                                             (n_super, r - 1)),
                "slstm": XL.slstm_cache_init(cfg, batch, device,
                                             (n_super,))}
    if fam == "hybrid":
        return {"ssm": SSM.ssm_cache_init(cfg, batch, dt, device,
                                          cfg.n_layers),
                "attn": Lyr.attn_cache_init(cfg, batch, max_len, dt, device,
                                            n_shared_attn(cfg))}
    if fam == "audio":
        return {"self": Lyr.attn_cache_init(cfg, batch, max_len, dt, device,
                                            cfg.n_dec_layers)}
    kd = n_dense_layers(cfg)

    def stack(n):
        if not n:
            return None
        if cfg.mla is not None:
            return Lyr.mla_cache_init(cfg, batch, max_len, dt, device, n)
        return Lyr.attn_cache_init(cfg, batch, max_len, dt, device, n)
    return {"dense": stack(kd), "moe": stack(cfg.n_layers - kd)}


def _at(stacked, *idx):
    """One layer's cache: each tensor indexed at ``idx`` (views, so an
    in-place update lands in the stack)."""
    return {name: t[idx] for name, t in stacked.items()}


@torch.no_grad()
def decode_step(model: Transformer, cfg: ModelConfig, token, cache, pos,
                encoder_out=None):
    """One decode step.  token: (B,) int; pos: (B,) absolute position;
    ``encoder_out`` (B, S_src, D): the encoder-decoder's ``encode`` output.
    Returns (logits (B, V), cache); the cache is updated in place."""
    _check_family(cfg)
    fam = cfg.family
    if fam == "audio" and encoder_out is None:
        raise ValueError("the encoder-decoder's decode_step needs "
                         "encoder_out (Transformer.encode)")
    x = model._embed(token, cfg)[:, None, :]
    kd = n_dense_layers(cfg)
    ai = 0
    for i, block in enumerate(model.blocks):
        if fam == "ssm":
            r = cfg.xlstm.slstm_every
            c = (_at(cache["slstm"], i // r) if i % r == r - 1
                 else _at(cache["mlstm"], i // r, i % r))
            x, _ = block.decode(x, c, cfg)
        elif fam == "hybrid":
            x, _ = block.decode(x, _at(cache["ssm"], i), cfg)
            if model._shared(i, cfg):
                x, _ = model.shared_attn.decode(x, _at(cache["attn"], ai),
                                                pos, cfg)
                ai += 1
        elif fam == "audio":
            x, _ = block.decode(x, _at(cache["self"], i), pos, encoder_out,
                                cfg)
        else:
            stacked = cache["dense"] if i < kd else cache["moe"]
            x, _ = block.decode(x, _at(stacked, i if i < kd else i - kd),
                                pos, cfg)
    return model._logits(model.final_ln(x))[:, 0], cache
