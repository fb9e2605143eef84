"""Per-layer building blocks as ``nn.Module``s: the norm, GQA attention with
RoPE (and cross-attention on the same weights) and MLA (DeepSeek-V2's
low-rank attention), each with prefill and one-token decode over a cache,
the dense MLP and the top-k MoE.

Parameters keep the reference's names and layouts (a projection is a
``(d_in, d_out)`` matrix applied as ``x @ w``), so a reference parameter
tree maps onto the modules one to one (``repro_torch.convert``).  As in
the reference, the config is an argument of every apply: one set of
weights runs under any config of the same shapes (another attention impl
or activation dtype).  They are
stored in f32, as the reference keeps them, and cast to the activation
dtype at each use.  They are built without gradients, for serving;
training turns them on (``repro_torch.train.train_step.init_state``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from .attention import _bmm_f32, attention, decode_attention
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

    def forward(self, x, positions, cfg: ModelConfig, *, causal=True,
                prefix=0, q_offset=0, window=None):
        """Self-attention, causal over ``cfg.window`` unless told otherwise;
        ``prefix`` leading positions form the VLM's image prefix.  x:
        (B, S, D) -> (B, S, D)."""
        b, s, _ = x.shape
        q, k, v = self.qkv(x, positions, cfg)
        window = cfg.window if window is None else window
        out = attention(q, k, v, impl=cfg.attn_impl, causal=causal,
                        window=window, prefix=prefix, q_offset=q_offset,
                        block=cfg.attn_block)
        out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
        return out @ self.wo.to(x.dtype)

    def cross(self, x, kv_src, cfg: ModelConfig):
        """Cross-attention (the reference's ``apply_cross_attn``): q from x,
        k and v from ``kv_src`` (B, T, D), no RoPE and no biases, every
        source position visible, always on ``dense_masked``.  x: (B, S, D)
        -> (B, S, D)."""
        b, s, _ = x.shape
        t, hd = kv_src.shape[1], cfg.hd
        q = (x @ self.wq.to(x.dtype)).reshape(
            b, s, cfg.n_heads, hd).transpose(1, 2)
        k = (kv_src @ self.wk.to(x.dtype)).reshape(
            b, t, cfg.n_kv_heads, hd).transpose(1, 2)
        v = (kv_src @ self.wv.to(x.dtype)).reshape(
            b, t, cfg.n_kv_heads, hd).transpose(1, 2)
        out = attention(q, k, v, impl="dense_masked", causal=False)
        out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
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


class MLA(nn.Module):
    """DeepSeek-V2's multi-head latent attention: ``wq`` (d, H*(dn+dr)),
    ``wkv_a`` (d, r), ``wk_rope`` (d, dr), ``wk_b`` (r, H*dn), ``wv_b``
    (r, H*dv), ``wo`` (H*dv, d), with dn, dr, dv and r from ``cfg.mla``.
    Prefill expands the latent into per-head keys and values; decode keeps
    only the latent ``kv_c`` and the shared rope key per token and absorbs
    ``wk_b`` and ``wv_b`` into the query and the output."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
        qk = m.qk_nope_dim + m.qk_rope_dim
        self.wq = _param(dense_init(generator, (d, h * qk)))
        self.wkv_a = _param(dense_init(generator, (d, m.kv_lora_rank)))
        self.wk_rope = _param(dense_init(generator, (d, m.qk_rope_dim)))
        self.wk_b = _param(dense_init(generator,
                                      (m.kv_lora_rank, h * m.qk_nope_dim)))
        self.wv_b = _param(dense_init(generator,
                                      (m.kv_lora_rank, h * m.v_head_dim)))
        self.wo = _param(dense_init(generator, (h * m.v_head_dim, d)))

    def forward(self, x, positions, cfg: ModelConfig, *, causal=True):
        """x: (B, S, D) -> (B, S, D).  The q.k head dim (dn + dr) differs
        from v's (dv), which ``flash_pallas`` does not take: it raises, as
        the reference's does."""
        m = cfg.mla
        b, s, _ = x.shape
        h = cfg.n_heads
        q = (x @ self.wq.to(x.dtype)).reshape(
            b, s, h, m.qk_nope_dim + m.qk_rope_dim).transpose(1, 2)
        q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
        q_rope = rope(q_rope, positions[:, None, :], cfg.rope_theta)
        kv_c = x @ self.wkv_a.to(x.dtype)                     # (B, S, r)
        k_rope = rope((x @ self.wk_rope.to(x.dtype))[:, None],
                      positions[:, None, :], cfg.rope_theta)  # (B, 1, S, dr)
        k_nope = (kv_c @ self.wk_b.to(x.dtype)).reshape(
            b, s, h, m.qk_nope_dim).transpose(1, 2)
        v = (kv_c @ self.wv_b.to(x.dtype)).reshape(
            b, s, h, m.v_head_dim).transpose(1, 2)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        kf = torch.cat([k_nope, k_rope.expand(b, h, s, m.qk_rope_dim)],
                       dim=-1)
        scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
        out = attention(qf, kf, v, impl=cfg.attn_impl, causal=causal,
                        scale=scale, block=cfg.attn_block)
        out = out.transpose(1, 2).reshape(b, s, h * m.v_head_dim)
        return out @ self.wo.to(x.dtype)

    def decode(self, x, cache: Dict[str, torch.Tensor], pos,
               cfg: ModelConfig):
        """Weight-absorbed one-token decode: attention runs in the latent
        space, so the cache is rank r + dr per token instead of 2*H*hd.
        x: (B, 1, D); pos: (B,); cache: this layer's ``{"kv_c"}`` (B, T, r)
        and ``{"k_rope"}`` (B, T, dr), updated in place at slot
        min(pos, T - 1).  Scores and ``p.kv_c`` accumulate in f32 from
        operands in the cache's dtype, as the reference's."""
        m = cfg.mla
        b = x.shape[0]
        h = cfg.n_heads
        q = (x[:, 0] @ self.wq.to(x.dtype)).reshape(
            b, h, m.qk_nope_dim + m.qk_rope_dim)
        q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
        p3 = pos[:, None, None]
        q_rope = rope(q_rope[:, :, None], p3, cfg.rope_theta)[:, :, 0]
        kv_c_new = x[:, 0] @ self.wkv_a.to(x.dtype)           # (B, r)
        k_rope_new = rope((x[:, 0] @ self.wk_rope.to(x.dtype))[:, None, None],
                          p3, cfg.rope_theta)[:, 0, 0]
        kv_c, k_rope = cache["kv_c"], cache["k_rope"]
        t = kv_c.shape[1]
        bidx = torch.arange(b, device=x.device)
        slot = torch.clamp(pos, max=t - 1)
        kv_c[bidx, slot] = kv_c_new.to(kv_c.dtype)
        k_rope[bidx, slot] = k_rope_new.to(k_rope.dtype)
        # absorb wk_b into q: q_lat (B, H, r) = q_nope @ wk_b^T per head
        wk_b = self.wk_b.to(x.dtype).reshape(m.kv_lora_rank, h, m.qk_nope_dim)
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope, wk_b)
        s_lat = _bmm_f32(q_lat, kv_c.transpose(1, 2))         # (B, H, T)
        s_rope = _bmm_f32(q_rope, k_rope.transpose(1, 2))
        scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
        s = (s_lat + s_rope) * scale
        valid = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
        s = torch.where(valid[:, None, :], s, -1e30)
        p = torch.softmax(s, dim=-1)
        p = p.to(torch.promote_types(kv_c.dtype, torch.bfloat16))
        o_lat = _bmm_f32(p, kv_c)                              # (B, H, r)
        wv_b = self.wv_b.to(x.dtype).reshape(m.kv_lora_rank, h, m.v_head_dim)
        out = torch.einsum("bhr,rhd->bhd", o_lat.to(x.dtype), wv_b)
        out = out.reshape(b, 1, h * m.v_head_dim)
        return out @ self.wo.to(x.dtype), cache


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device, layers: int) -> Dict[str, torch.Tensor]:
    """MLA latent caches of ``layers`` layers stacked on a leading axis."""
    m = cfg.mla
    return {"kv_c": torch.zeros((layers, batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((layers, batch, max_len, m.qk_rope_dim),
                                  dtype=dtype, device=device)}


class MLP(nn.Module):
    """Dense MLP: SwiGLU (``w_gate``, ``w_up``, ``w_down``) or tanh-GELU
    (``w_up``, ``b_up``, ``w_down``, ``b_down``), as ``cfg.act`` says;
    hidden width ``d_ff`` (default ``cfg.d_ff``)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 d_ff: Optional[int] = None):
        super().__init__()
        d, d_ff = cfg.d_model, d_ff or cfg.d_ff
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

    def forward(self, x, cfg: Optional[ModelConfig] = None):
        """x: (..., D) -> (..., D); ``cfg`` is accepted for a uniform call
        with ``MoE`` and unused (the activation is fixed at build)."""
        if self.act == "swiglu":
            h = (F.silu(x @ self.w_gate.to(x.dtype))
                 * (x @ self.w_up.to(x.dtype)))
            return h @ self.w_down.to(x.dtype)
        h = F.gelu(x @ self.w_up.to(x.dtype) + self.b_up.to(x.dtype),
                   approximate="tanh")
        return h @ self.w_down.to(x.dtype) + self.b_down.to(x.dtype)


#: expert products (three per expert that received tokens) launched by
#: ``MoE`` in this process
EXPERT_MATMULS = 0


class MoE(nn.Module):
    """Top-k routed SwiGLU experts: ``router`` (d, E), ``experts_gate`` and
    ``experts_up`` (E, d, f), ``experts_down`` (E, f, d), and ``shared``
    (an ``MLP`` of width ``d_ff_shared * n_shared``) when ``n_shared``.

    The dispatch is a masked product: the routing assignment is a sparse
    (token, expert) mask, a stable sort by expert materialises its
    worklist, and only the admitted (token, expert) products run, dropless.
    The reference's grouped product (``jax.lax.ragged_dot``) is a loop
    here, one ``torch.matmul`` per expert segment of the sorted rows, with
    the expert's weights cast at use.  Its cost: one host read of the group
    sizes per call (``group_sizes``, a device synchronisation), then three
    products per expert that received tokens (``EXPERT_MATMULS``).
    """

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        mo, d = cfg.moe, cfg.d_model
        self.router = _param(dense_init(generator, (d, mo.n_experts),
                                        scale=0.1))
        self.experts_gate = _param(dense_init(
            generator, (mo.n_experts, d, mo.d_ff_expert)))
        self.experts_up = _param(dense_init(
            generator, (mo.n_experts, d, mo.d_ff_expert)))
        self.experts_down = _param(dense_init(
            generator, (mo.n_experts, mo.d_ff_expert, d)))
        self.shared = (MLP(cfg, generator, d_ff=mo.d_ff_shared * mo.n_shared)
                       if mo.n_shared else None)
        #: tokens routed to each expert in the last call (host ints)
        self.group_sizes: List[int] = []

    def route(self, xt, cfg: ModelConfig):
        """xt: (T, D) -> the top-k experts of each token (T, k) by f32
        router softmax, and their weights (T, k), renormalised to sum 1
        when ``router_scale``."""
        probs = torch.softmax((xt @ self.router.to(xt.dtype)).float(), dim=-1)
        top_w, top_e = torch.topk(probs, cfg.moe.top_k, dim=-1)
        if cfg.moe.router_scale:
            top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        return top_w, top_e

    def forward(self, x, cfg: ModelConfig):
        """x: (B, S, D) -> (B, S, D), the reference's dense (no mesh) path."""
        global EXPERT_MATMULS
        mo = cfg.moe
        b, s, d = x.shape
        xt = x.reshape(b * s, d)
        top_w, top_e = self.route(xt, cfg)
        n_tok = xt.shape[0]
        flat_e = top_e.reshape(-1)                             # (T*k,)
        flat_w = top_w.reshape(-1)
        src = torch.arange(n_tok, device=x.device).repeat_interleave(
            mo.top_k)
        order = torch.argsort(flat_e, stable=True)             # by expert
        rows = src[order]
        gathered = xt[rows]                                    # (T*k, D)
        self.group_sizes = torch.bincount(
            flat_e, minlength=mo.n_experts).tolist()           # host sync
        out_sorted = torch.empty_like(gathered)
        start = 0
        for e, n in enumerate(self.group_sizes):
            if n == 0:
                continue
            seg = gathered[start:start + n]
            h = (F.silu(seg @ self.experts_gate[e].to(x.dtype))
                 * (seg @ self.experts_up[e].to(x.dtype)))
            out_sorted[start:start + n] = h @ self.experts_down[e].to(x.dtype)
            EXPERT_MATMULS += 3
            start += n
        # combine: weight each row, then add it back onto its token
        contrib = out_sorted * flat_w[order][:, None].to(out_sorted.dtype)
        out = torch.zeros((n_tok, d), dtype=contrib.dtype, device=x.device)
        out.index_add_(0, rows, contrib)
        out = out.reshape(b, s, d)
        if self.shared is not None:
            out = out + self.shared(x)
        return out.to(x.dtype)


def moe_aux_loss(moe: MoE, cfg: ModelConfig, x):
    """The Switch-style load-balance loss of ``moe``'s router on x (B, S,
    D): ``n_experts * sum(frac * importance)``, with ``frac`` the share of
    tokens whose top expert is each expert and ``importance`` the mean f32
    router probability.  As in the reference, nothing adds it to the
    training loss."""
    mo = cfg.moe
    logits = (x.reshape(-1, x.shape[-1]) @ moe.router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_e = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top_e, mo.n_experts).float().mean(dim=0)
    imp = probs.mean(dim=0)
    return mo.n_experts * torch.sum(frac * imp)
