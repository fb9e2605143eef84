"""Per-layer building blocks as ``nn.Module``s: the norm, GQA attention with
RoPE (prefill and one-token decode over a KV cache) and the dense MLP.

Parameters keep the reference's names and layouts (a projection is a
``(d_in, d_out)`` matrix applied as ``x @ w``), so a reference parameter
tree maps onto the modules one to one (``repro_torch.convert``).  As in
the reference, the config is an argument of every apply: one set of
weights runs under any config of the same shapes (another attention impl
or activation dtype).  They are
stored in f32, as the reference keeps them, and cast to the activation
dtype at each use.  The port serves inference only: no parameter requires
a gradient.  MLA, MoE and cross-attention are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from .attention import attention, decode_attention
from .common import dense_init, layer_norm, rms_norm, rope


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``) over d_model,
    as ``cfg.norm`` says."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.kind = cfg.norm
        self.scale = _param(torch.ones(cfg.d_model, device=device))
        self.bias = (_param(torch.zeros(cfg.d_model, device=device))
                     if cfg.norm == "layernorm" else None)

    def forward(self, x):
        if self.kind == "rmsnorm":
            return rms_norm(x, self.scale)
        return layer_norm(x, self.scale, self.bias)


class Attention(nn.Module):
    """GQA self-attention with RoPE: ``wq`` (d, Hq*hd), ``wk``/``wv``
    (d, Hkv*hd), ``wo`` (Hq*hd, d), and ``bq``/``bk``/``bv`` when
    ``cfg.qkv_bias``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        hd, d = cfg.hd, cfg.d_model
        dev = generator.device
        self.wq = _param(dense_init(generator, (d, cfg.n_heads * hd)))
        self.wk = _param(dense_init(generator, (d, cfg.n_kv_heads * hd)))
        self.wv = _param(dense_init(generator, (d, cfg.n_kv_heads * hd)))
        self.wo = _param(dense_init(generator, (cfg.n_heads * hd, d)))
        if cfg.qkv_bias:
            self.bq = _param(torch.zeros(cfg.n_heads * hd, device=dev))
            self.bk = _param(torch.zeros(cfg.n_kv_heads * hd, device=dev))
            self.bv = _param(torch.zeros(cfg.n_kv_heads * hd, device=dev))

    def _project(self, x, cfg: ModelConfig):
        q = x @ self.wq.to(x.dtype)
        k = x @ self.wk.to(x.dtype)
        v = x @ self.wv.to(x.dtype)
        if cfg.qkv_bias:
            q = q + self.bq.to(x.dtype)
            k = k + self.bk.to(x.dtype)
            v = v + self.bv.to(x.dtype)
        return q, k, v

    def qkv(self, x, positions, cfg: ModelConfig):
        """x: (B, S, D), positions: (B, S) -> q (B, Hq, S, hd) and k, v
        (B, Hkv, S, hd), RoPE applied to q and k."""
        b, s, _ = x.shape
        q, k, v = self._project(x, cfg)
        q = q.reshape(b, s, cfg.n_heads, cfg.hd).transpose(1, 2)
        k = k.reshape(b, s, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
        v = v.reshape(b, s, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
        q = rope(q, positions[:, None, :], cfg.rope_theta)
        k = rope(k, positions[:, None, :], cfg.rope_theta)
        return q, k, v

    def forward(self, x, positions, cfg: ModelConfig):
        """Causal self-attention over ``cfg.window``. x: (B, S, D) ->
        (B, S, D)."""
        b, s, _ = x.shape
        q, k, v = self.qkv(x, positions, cfg)
        out = attention(q, k, v, impl=cfg.attn_impl, causal=True,
                        window=cfg.window, block=cfg.attn_block)
        out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
        return out @ self.wo.to(x.dtype)

    def decode(self, x, cache: Dict[str, torch.Tensor], pos,
               cfg: ModelConfig):
        """One-token decode. x: (B, 1, D); pos: (B,) absolute position;
        cache: this layer's ``{"k", "v"}`` (B, Hkv, T, hd), updated in place
        (the reference returns new arrays; writing the one new slot saves a
        copy of the cache per step).  Returns (out (B, 1, D), cache)."""
        b = x.shape[0]
        q, k, v = self._project(x[:, 0], cfg)
        q = q.reshape(b, cfg.n_heads, cfg.hd)
        k = k.reshape(b, cfg.n_kv_heads, cfg.hd)
        v = v.reshape(b, cfg.n_kv_heads, cfg.hd)
        p3 = pos[:, None, None]
        q = rope(q[:, :, None, :], p3, cfg.rope_theta)[:, :, 0]
        k = rope(k[:, :, None, :], p3, cfg.rope_theta)[:, :, 0]
        k_cache, v_cache = cache["k"], cache["v"]
        t = k_cache.shape[2]
        slot = pos % t if cfg.window > 0 else torch.clamp(pos, max=t - 1)
        bidx = torch.arange(b, device=x.device)
        k_cache[bidx, :, slot] = k.to(k_cache.dtype)
        v_cache[bidx, :, slot] = v.to(v_cache.dtype)
        valid = torch.clamp(pos + 1, max=t)
        out = decode_attention(q, k_cache, v_cache, valid)
        out = out.reshape(b, 1, cfg.n_heads * cfg.hd)
        return out @ self.wo.to(x.dtype), cache


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device, layers: int) -> Dict[str, torch.Tensor]:
    """KV caches of ``layers`` layers stacked on a leading axis,
    ring-buffered when windowed: physical length min(max_len, window)."""
    t = min(max_len, cfg.window) if cfg.window > 0 else max_len
    shape = (layers, batch, cfg.n_kv_heads, t, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class MLP(nn.Module):
    """Dense MLP: SwiGLU (``w_gate``, ``w_up``, ``w_down``) or tanh-GELU
    (``w_up``, ``b_up``, ``w_down``, ``b_down``), as ``cfg.act`` says."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d, d_ff = cfg.d_model, cfg.d_ff
        dev = generator.device
        self.act = cfg.act
        if cfg.act == "swiglu":
            self.w_gate = _param(dense_init(generator, (d, d_ff)))
            self.w_up = _param(dense_init(generator, (d, d_ff)))
            self.w_down = _param(dense_init(generator, (d_ff, d)))
        else:
            self.w_up = _param(dense_init(generator, (d, d_ff)))
            self.w_down = _param(dense_init(generator, (d_ff, d)))
            self.b_up = _param(torch.zeros(d_ff, device=dev))
            self.b_down = _param(torch.zeros(d, device=dev))

    def forward(self, x):
        if self.act == "swiglu":
            h = (F.silu(x @ self.w_gate.to(x.dtype))
                 * (x @ self.w_up.to(x.dtype)))
            return h @ self.w_down.to(x.dtype)
        h = F.gelu(x @ self.w_up.to(x.dtype) + self.b_up.to(x.dtype),
                   approximate="tanh")
        return h @ self.w_down.to(x.dtype) + self.b_down.to(x.dtype)
