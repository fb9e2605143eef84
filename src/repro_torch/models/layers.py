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

Tensor parallelism.  ``train_step.shard_model`` replaces the parameters
of every layer by a rank's shards, as the reference's rules place them,
and sets ``tp`` (the model axis, ``repro_torch.parallel.Axis``) and
``tp_dims`` (parameter name -> the dim the model axis splits, None where
the parameter is whole).  Then ``wq``/``wk``/``wv``/``w_gate``/``w_up``
(and MLA's ``wk_b``/``wv_b``) hold column blocks and ``wo``/``w_down`` row
blocks: the input enters by ``copy_to``, the rank computes its heads (a
contiguous block of whole q heads, ``head_blocks``, and the K/V heads they
read) or its hidden columns, and the output leaves by ``reduce_from``
(Megatron's f and g).  Cross-attention runs its heads so too.  Where the
q heads do not divide the axis, the shards of ``wq`` and ``wo`` (and of
``wk``/``wv``, split mid-head) hold parts of heads (the reference's
placements): a rank runs its block of whole heads, the first ``Hq mod
tp`` ranks one head more, on the columns of those heads fetched from the
shards that hold them (``parallel.regroup``: one all-to-all that moves
only those columns, and its inverse for the gradient).  A weight that
takes a gradient is exchanged in every forward; otherwise (prefill and
decode of served weights) the rank's block is fetched once a weight
version and kept on the module, outside its parameters, buffers and
checkpoints.  Where the q heads divide the axis and the K/V heads do not
(llama3.2-1b on 16), ``wk``/``wv`` are still gathered whole, so those
configs' link bytes stay as they were.  A whole parameter read in part
(a bias, ``wk``/``wv`` under ``kv_replicated``, MLA's latent projections
``wkv_a`` and ``wk_rope``) enters by ``copy_to`` too, so its gradient is
summed over the axis, as do the routing weights in expert parallelism
(every rank routes alike; each uses the weights of its own experts).  The
MoE runs the
reference's expert-parallel dispatch (``_apply_moe_ep``) when
``cfg.moe.ep`` and the experts split evenly over the axis, else the dense
dispatch on experts all-gathered.

Sharded decode takes each layer's cache slice and its ``place`` (the dims
the model and data axes split, ``transformer.shard_cache``): attention
runs its q heads on its K/V heads' cache, or, where the reference's
``fit_spec`` moved the model axis onto T (K/V heads that do not divide
it), scores every head against its block of T and combines the softmax
over the axis, as MLA's context-parallel latent cache always does
(``_cp_softmax``).  Only the rank that holds a new token's slot writes
it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import parallel
from repro_torch.configs.base import ModelConfig
from .attention import NEG_INF, _bmm_f32, attention, decode_attention
from .common import dense_init, layer_norm, rms_norm, rope


#: a decode cache tensor's place on this rank: the dims of the per-layer
#: tensor that the model axis and the data axes split (None: whole along
#: them) and its whole per-layer shape (``transformer.shard_cache``)
Place = Tuple[Optional[int], Optional[int], Tuple[int, ...]]


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
    ``cfg.qkv_bias``.  Under ``tp`` rank i runs the i-th block of whole q
    heads of ``balanced_sizes(Hq, tp)`` (Hq / tp each where they divide
    the axis; else the first Hq mod tp ranks one more) and the K/V heads
    they read (``tp_heads``).  Its columns of ``wq`` and rows of ``wo``
    are its shards where those hold exactly its heads, else its heads'
    block regrouped from the shards in the activation dtype
    (``_head_weight``); ``wk``/``wv`` likewise where the q heads do not
    divide the axis (``_kv_weight``).
    Where its heads read parts of two K/V groups, its K/V heads are
    indexed once per q head (``_kv_per_q_head``), else GQA runs as is."""

    tp = None
    tp_dims: Dict[str, Optional[int]] = {}

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
        #: (name, dtype) -> (weight, its _version and data_ptr, the rank's
        #: block): the blocks fetched without gradients (``_regrouped``),
        #: no parameter or buffer, so no checkpoint holds them
        self._fetched: Dict[tuple, tuple] = {}

    def tp_heads(self, cfg: ModelConfig):
        """(first q head, end q head, first K/V head, end K/V head) of this
        rank (``head_blocks``): all of them without ``tp``."""
        if self.tp is None:
            return 0, cfg.n_heads, 0, cfg.n_kv_heads
        return head_blocks(cfg.n_heads, cfg.n_kv_heads, self.tp.size,
                           self.tp.index)

    def _head_weight(self, name: str, dim: int, cfg: ModelConfig, dtype):
        """This rank's q heads' block of ``wq`` (columns, ``dim`` 1) or
        ``wo`` (rows, ``dim`` 0): the shard itself when it holds exactly
        those heads, else the shard cast to ``dtype`` and regrouped
        (``_regrouped``: the columns of the rank's heads from the shards
        that hold them)."""
        w, placed = getattr(self, name), self.tp_dims.get(name)
        h0, h1, _, _ = self.tp_heads(cfg)
        n = (h1 - h0) * cfg.hd
        if placed == dim and w.shape[dim] == n \
                and self.tp.index * n == h0 * cfg.hd:
            return w
        if placed is None:
            return parallel.copy_to(w.to(dtype), self.tp).narrow(
                dim, h0 * cfg.hd, n)
        return self._regrouped(name, dim, self._ranges(cfg, kv=False),
                               dtype)

    def _ranges(self, cfg: ModelConfig, kv: bool):
        """Every rank's [lo, hi) columns of its q heads' (or, ``kv``, its
        K/V heads') block (``head_blocks``), in rank order."""
        tp, hd = self.tp, cfg.hd
        blocks = [head_blocks(cfg.n_heads, cfg.n_kv_heads, tp.size, r)
                  for r in range(tp.size)]
        return tuple((b[2 * kv] * hd, b[2 * kv + 1] * hd) for b in blocks)

    def _regrouped(self, name: str, dim: int, want, dtype):
        """``parallel.regroup`` of the shard ``name`` cast to ``dtype``
        into this rank's range of ``want`` along ``dim``: on every call
        where the weight takes a gradient, else once a weight and dtype
        (the weight's identity, ``_version`` and storage), the block kept
        in ``_fetched``."""
        w = getattr(self, name)
        if torch.is_grad_enabled() and w.requires_grad:
            return parallel.regroup(w.to(dtype), self.tp, dim, want)
        stamp = (w._version, w.data_ptr())
        hit = self._fetched.get((name, dtype))
        if hit is None or hit[0] is not w or hit[1] != stamp:
            with torch.no_grad():
                block = parallel.regroup(w.to(dtype), self.tp, dim, want)
            hit = self._fetched[(name, dtype)] = (w, stamp, block)
        return hit[2]

    def fetch_blocks(self, cfg: ModelConfig, dtype) -> List[torch.Tensor]:
        """Fetch, without gradients, the blocks that a forward in ``dtype``
        would fetch (``_head_weight``, ``_kv_weight``: only where the q
        heads do not divide the axis), and return every block held: a
        served model's one-time fetch, done before its first step
        (``launch.dryrun`` counts it apart from a step)."""
        if self.tp is not None and cfg.n_heads % self.tp.size:
            with torch.no_grad():
                self._head_weight("wq", 1, cfg, dtype)
                self._head_weight("wo", 0, cfg, dtype)
                self._kv_weight("wk", cfg)
                self._kv_weight("wv", cfg)
        return [block for _, _, block in self._fetched.values()]

    def _kv_per_q_head(self, cfg: ModelConfig, *kv):
        """The rank's K/V heads (B, k1 - k0, ...) as GQA reads them: as
        they are where each K/V head serves a run of the rank's q heads of
        one length, else indexed once per q head (B, h1 - h0, ...: a rank
        whose heads straddle a group boundary)."""
        h0, h1, k0, k1 = self.tp_heads(cfg)
        g = cfg.n_heads // cfg.n_kv_heads
        idx = [h // g - k0 for h in range(h0, h1)]
        hq, hkv = h1 - h0, k1 - k0
        if hq % hkv == 0 and idx == [j // (hq // hkv) for j in range(hq)]:
            return kv
        idx = torch.tensor(idx, device=kv[0].device)
        return tuple(t.index_select(1, idx) for t in kv)

    def _kv_weight(self, name: str, cfg: ModelConfig):
        """This rank's columns of ``wk``/``wv`` (its K/V heads): the shard
        itself when it holds exactly those heads; where the q heads do not
        divide the axis, the shard regrouped (``_regrouped``, in the
        parameter's dtype); else the whole weight (read in part, so entered
        by ``copy_to`` or all-gathered with a summed gradient), sliced."""
        w, dim = getattr(self, name), self.tp_dims.get(name)
        _, _, k0, k1 = self.tp_heads(cfg)
        hd = cfg.hd
        if dim == 1 and w.shape[1] == (k1 - k0) * hd:
            return w
        if dim == 1 and cfg.n_heads % self.tp.size:
            return self._regrouped(name, 1, self._ranges(cfg, kv=True),
                                   w.dtype)
        w = (parallel.copy_to(w, self.tp) if dim is None
             else parallel.gather_partial(w, self.tp, dim))
        return w[:, k0 * hd:k1 * hd]

    def _bias(self, name: str, lo: int, hi: int):
        """Columns lo..hi of a whole bias, read in part."""
        return parallel.copy_to(getattr(self, name), self.tp)[lo:hi]

    def _project(self, x, cfg: ModelConfig):
        wq, wk, wv = self.wq, self.wk, self.wv
        if cfg.qkv_bias:
            bq, bk, bv = self.bq, self.bk, self.bv
        if self.tp is not None:
            hd = cfg.hd
            h0, h1, k0, k1 = self.tp_heads(cfg)
            x = parallel.copy_to(x, self.tp)
            wq = self._head_weight("wq", 1, cfg, x.dtype)
            wk = self._kv_weight("wk", cfg)
            wv = self._kv_weight("wv", cfg)
            if cfg.qkv_bias:
                bq = self._bias("bq", h0 * hd, h1 * hd)
                bk = self._bias("bk", k0 * hd, k1 * hd)
                bv = self._bias("bv", k0 * hd, k1 * hd)
        q = x @ wq.to(x.dtype)
        k = x @ wk.to(x.dtype)
        v = x @ wv.to(x.dtype)
        if cfg.qkv_bias:
            q = q + bq.to(x.dtype)
            k = k + bk.to(x.dtype)
            v = v + bv.to(x.dtype)
        return q, k, v

    def qkv(self, x, positions, cfg: ModelConfig):
        """x: (B, S, D), positions: (B, S) -> q (B, Hq, S, hd) and k, v
        (B, Hkv, S, hd), RoPE applied to q and k (this rank's heads under
        ``tp``)."""
        b, s, _ = x.shape
        h0, h1, k0, k1 = self.tp_heads(cfg)
        q, k, v = self._project(x, cfg)
        q = q.reshape(b, s, h1 - h0, cfg.hd).transpose(1, 2)
        k = k.reshape(b, s, k1 - k0, cfg.hd).transpose(1, 2)
        v = v.reshape(b, s, k1 - k0, cfg.hd).transpose(1, 2)
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
        k, v = self._kv_per_q_head(cfg, k, v)
        window = cfg.window if window is None else window
        out = attention(q, k, v, impl=cfg.attn_impl, causal=causal,
                        window=window, prefix=prefix, q_offset=q_offset,
                        block=cfg.attn_block)
        out = out.transpose(1, 2).reshape(b, s, q.shape[1] * cfg.hd)
        return self._out(out, cfg)

    def _out(self, out, cfg: ModelConfig):
        """``out @ wo`` over this rank's heads, summed over the axis."""
        wo = self.wo if self.tp is None else \
            self._head_weight("wo", 0, cfg, out.dtype)
        return parallel.reduce_from(out @ wo.to(out.dtype), self.tp)

    def cross(self, x, kv_src, cfg: ModelConfig):
        """Cross-attention (the reference's ``apply_cross_attn``): q from x,
        k and v from ``kv_src`` (B, T, D), no RoPE and no biases, every
        source position visible, always on ``dense_masked``; under ``tp``
        on this rank's heads, as self-attention.  x: (B, S, D) -> (B, S,
        D)."""
        b, s, _ = x.shape
        t, hd = kv_src.shape[1], cfg.hd
        h0, h1, k0, k1 = self.tp_heads(cfg)
        wq, wk, wv = self.wq, self.wk, self.wv
        if self.tp is not None:
            x = parallel.copy_to(x, self.tp)
            kv_src = parallel.copy_to(kv_src, self.tp)
            wq = self._head_weight("wq", 1, cfg, x.dtype)
            wk = self._kv_weight("wk", cfg)
            wv = self._kv_weight("wv", cfg)
        q = (x @ wq.to(x.dtype)).reshape(b, s, h1 - h0, hd).transpose(1, 2)
        k = (kv_src @ wk.to(x.dtype)).reshape(
            b, t, k1 - k0, hd).transpose(1, 2)
        v = (kv_src @ wv.to(x.dtype)).reshape(
            b, t, k1 - k0, hd).transpose(1, 2)
        k, v = self._kv_per_q_head(cfg, k, v)
        out = attention(q, k, v, impl="dense_masked", causal=False)
        out = out.transpose(1, 2).reshape(b, s, (h1 - h0) * hd)
        return self._out(out, cfg)

    def decode(self, x, cache: Dict[str, torch.Tensor], pos,
               cfg: ModelConfig, place: Optional[Dict[str, Place]] = None):
        """One-token decode. x: (B, 1, D); pos: (B,) absolute position;
        cache: this layer's ``{"k", "v"}`` (B, Hkv, T, hd), updated in place
        (the reference returns new arrays; writing the one new slot saves a
        copy of the cache per step).  Returns (out (B, 1, D), cache).

        Under ``tp`` the cache is this rank's slice as ``place`` says: its
        K/V heads (it runs its q heads on them), or, where the reference's
        ``fit_spec`` moved the model axis onto T, its block of T for every
        head (``_decode_context_parallel``)."""
        mdim = _model_dim(self, place, "k")
        if mdim == 2:
            return self._decode_context_parallel(x, cache, pos, cfg)
        if mdim not in (None, 1) or (self.tp is not None and mdim is None):
            raise NotImplementedError(
                f"attention decode with the model axis on dim {mdim} of its "
                f"(B, Hkv, T, hd) cache: heads or T only")
        b = x.shape[0]
        h0, h1, k0, k1 = self.tp_heads(cfg)
        hq = h1 - h0
        q, k, v = self._project(x[:, 0], cfg)
        q = q.reshape(b, hq, cfg.hd)
        k = k.reshape(b, k1 - k0, cfg.hd)
        v = v.reshape(b, k1 - k0, cfg.hd)
        p3 = pos[:, None, None]
        q = rope(q[:, :, None, :], p3, cfg.rope_theta)[:, :, 0]
        k = rope(k[:, :, None, :], p3, cfg.rope_theta)[:, :, 0]
        k_cache, v_cache = cache["k"], cache["v"]
        if k_cache.shape[1] != k1 - k0:
            raise NotImplementedError(
                f"a rank's {k1 - k0} K/V heads against a cache of "
                f"{k_cache.shape[1]}")
        t = k_cache.shape[2]
        slot = pos % t if cfg.window > 0 else torch.clamp(pos, max=t - 1)
        bidx = torch.arange(b, device=x.device)
        k_cache[bidx, :, slot] = k.to(k_cache.dtype)
        v_cache[bidx, :, slot] = v.to(v_cache.dtype)
        valid = torch.clamp(pos + 1, max=t)
        out = decode_attention(q, *self._kv_per_q_head(cfg, k_cache, v_cache),
                               valid)
        out = out.reshape(b, 1, hq * cfg.hd)
        return self._out(out, cfg), cache

    def _decode_context_parallel(self, x, cache, pos, cfg: ModelConfig):
        """Decode on a cache whose T is split over the model axis (the K/V
        heads do not divide it): every rank's q heads and new K/V heads are
        all-gathered (``all_gather_uneven``: ranks may hold different
        counts), the rank that holds the slot writes it, each rank
        scores every head against its block of T and the softmax and
        ``p.v`` are summed over the axis (``_cp_softmax``); the rank then
        keeps its q heads for ``wo``."""
        tp, hd, b = self.tp, cfg.hd, x.shape[0]
        h0, h1, k0, k1 = self.tp_heads(cfg)
        g = cfg.n_heads // cfg.n_kv_heads
        q, k, v = self._project(x[:, 0], cfg)
        p3 = pos[:, None, None]
        q = rope(q.reshape(b, h1 - h0, 1, hd), p3, cfg.rope_theta)[:, :, 0]
        k = rope(k.reshape(b, k1 - k0, 1, hd), p3, cfg.rope_theta)[:, :, 0]
        v = v.reshape(b, k1 - k0, hd)
        blocks = [head_blocks(cfg.n_heads, cfg.n_kv_heads, tp.size, r)
                  for r in range(tp.size)]
        q_all = parallel.all_gather_uneven(             # (B, Hq, hd)
            q, tp, 1, [e - f for f, e, _, _ in blocks])
        kv = parallel.all_gather_uneven(
            torch.cat([k, v], dim=-1), tp, 1, [e - f for _, _, f, e in blocks])
        # each K/V head once, from the first rank that computed it
        heads, at = [], 0
        for _, _, f, e in blocks:
            heads += [at + j - f for j in range(max(f, len(heads)), e)]
            at += e - f
        k_all, v_all = kv[:, heads, :hd], kv[:, heads, hd:]
        k_cache, v_cache = cache["k"], cache["v"]
        t_loc = k_cache.shape[2]
        t = t_loc * tp.size
        slot = pos % t if cfg.window > 0 else torch.clamp(pos, max=t - 1)
        mine, local = _slot_owner(slot, t_loc, tp)
        bidx = torch.arange(b, device=x.device)
        for cache_t, new in ((k_cache, k_all), (v_cache, v_all)):
            keep = cache_t[bidx, :, local]
            cache_t[bidx, :, local] = torch.where(
                mine[:, None, None], new.to(cache_t.dtype), keep)
        valid = torch.clamp(pos + 1, max=t)
        qg = q_all.reshape(b, cfg.n_kv_heads, g, hd)
        s = torch.einsum("bhgd,bhtd->bhgt", qg.float(),
                         k_cache.float()) * hd ** -0.5
        at = tp.index * t_loc + torch.arange(t_loc, device=x.device)
        ok = at[None, :] < valid[:, None]
        s = torch.where(ok[:, None, None, :], s, NEG_INF)
        p = _cp_softmax(s, tp)
        o = parallel.all_reduce(
            torch.einsum("bhgt,bhtd->bhgd", p, v_cache.float()), tp)
        o = o.reshape(b, cfg.n_heads, hd)[:, h0:h1]
        out = o.to(q.dtype).reshape(b, 1, (h1 - h0) * hd)
        return self._out(out, cfg), cache


def head_blocks(n_heads: int, n_kv_heads: int, tp: int, index: int
                ) -> Tuple[int, int, int, int]:
    """Rank ``index`` of a model axis of ``tp``'s q heads [h0, h1) (the
    ``index``-th contiguous block of ``balanced_sizes(n_heads, tp)``: the
    first ``n_heads mod tp`` ranks one head more) and the K/V heads [k0,
    k1) those read (q head h reads K/V head h // (n_heads /
    n_kv_heads))."""
    sizes = balanced_sizes(n_heads, tp)
    h0 = sum(sizes[:index])
    h1 = h0 + sizes[index]
    g = n_heads // n_kv_heads
    return h0, h1, h0 // g, (h1 - 1) // g + 1


def _model_dim(module, place, name: str) -> Optional[int]:
    """The dim of the per-layer cache tensor ``name`` that the model axis
    splits on this rank (None without ``tp`` or where the tensor is
    whole)."""
    if module.tp is None or place is None:
        return None
    return place[name][0]


def _slot_owner(slot, t_loc: int, tp):
    """Rows whose cache slot lies in this rank's block of T (of ``t_loc``
    positions), and the slot's index in the block (clamped)."""
    local = slot - tp.index * t_loc
    mine = (local >= 0) & (local < t_loc)
    return mine, local.clamp(0, t_loc - 1)


def _cp_softmax(s, tp):
    """This rank's block of ``softmax(s)`` over the last dim, the scores
    ``s`` (f32) split over the model axis by blocks of that dim: the
    maximum and the sum of exponentials are reduced over the axis, so the
    probabilities are the one-device softmax's (their sum in another
    order)."""
    m = parallel.all_reduce(s.amax(dim=-1), tp, op="max")
    e = torch.exp(s - m[..., None])
    return e / parallel.all_reduce(e.sum(dim=-1), tp)[..., None]


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
    ``wk_b`` and ``wv_b`` into the query and the output.

    Under ``tp`` ``wq``, ``wk_b`` and ``wv_b`` hold a rank's heads' column
    blocks and ``wo`` their rows; ``wkv_a`` and ``wk_rope`` are whole, as
    the reference keeps them, so every rank computes the whole latent and
    reads it for its heads (they enter by ``copy_to``).  Decode is
    context-parallel: the latent caches hold the rank's block of T."""

    tp = None
    tp_dims: Dict[str, Optional[int]] = {}

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

    def _heads(self, cfg: ModelConfig) -> int:
        return cfg.n_heads if self.tp is None else \
            cfg.n_heads // self.tp.size

    def _latent_weights(self, dtype):
        """``wkv_a`` and ``wk_rope`` in ``dtype``; under ``tp`` each rank
        reads them whole for its heads, so their gradient is summed."""
        return (parallel.copy_to(self.wkv_a, self.tp).to(dtype),
                parallel.copy_to(self.wk_rope, self.tp).to(dtype))

    def forward(self, x, positions, cfg: ModelConfig, *, causal=True):
        """x: (B, S, D) -> (B, S, D).  The q.k head dim (dn + dr) differs
        from v's (dv), which ``flash_pallas`` does not take: it raises, as
        the reference's does."""
        m = cfg.mla
        b, s, _ = x.shape
        h = self._heads(cfg)
        x = parallel.copy_to(x, self.tp)
        wkv_a, wk_rope = self._latent_weights(x.dtype)
        q = (x @ self.wq.to(x.dtype)).reshape(
            b, s, h, m.qk_nope_dim + m.qk_rope_dim).transpose(1, 2)
        q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
        q_rope = rope(q_rope, positions[:, None, :], cfg.rope_theta)
        kv_c = x @ wkv_a                                      # (B, S, r)
        k_rope = rope((x @ wk_rope)[:, None],
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
        return parallel.reduce_from(out @ self.wo.to(x.dtype), self.tp)

    def decode(self, x, cache: Dict[str, torch.Tensor], pos,
               cfg: ModelConfig, place: Optional[Dict[str, Place]] = None):
        """Weight-absorbed one-token decode: attention runs in the latent
        space, so the cache is rank r + dr per token instead of 2*H*hd.
        x: (B, 1, D); pos: (B,); cache: this layer's ``{"kv_c"}`` (B, T, r)
        and ``{"k_rope"}`` (B, T, dr), updated in place at slot
        min(pos, T - 1).  Scores and ``p.kv_c`` accumulate in f32 from
        operands in the cache's dtype, as the reference's.

        Under ``tp`` (``place``: T over the model axis, the reference's
        context-parallel latents) the rank absorbs ``wk_b`` into its heads'
        queries, the latent queries of every head are all-gathered, the
        rank that holds slot ``pos`` writes the new latent, each rank
        scores every head against its block of T, the softmax and
        ``p.kv_c`` are summed over the axis (flash-decoding's
        combination), and the rank keeps its heads for ``wv_b`` and
        ``wo``."""
        m = cfg.mla
        b = x.shape[0]
        h = self._heads(cfg)
        tp = self.tp
        mdim = _model_dim(self, place, "kv_c")
        if tp is not None and (mdim != 1 or _model_dim(
                self, place, "k_rope") != 1):
            raise NotImplementedError(
                f"MLA decode with the model axis on dim {mdim} of its "
                f"(B, T, r) latent cache: T only (context-parallel)")
        wkv_a, wk_rope = self._latent_weights(x.dtype)
        q = (x[:, 0] @ self.wq.to(x.dtype)).reshape(
            b, h, m.qk_nope_dim + m.qk_rope_dim)
        q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
        p3 = pos[:, None, None]
        q_rope = rope(q_rope[:, :, None], p3, cfg.rope_theta)[:, :, 0]
        kv_c_new = x[:, 0] @ wkv_a                            # (B, r)
        k_rope_new = rope((x[:, 0] @ wk_rope)[:, None, None],
                          p3, cfg.rope_theta)[:, 0, 0]
        kv_c, k_rope = cache["kv_c"], cache["k_rope"]
        t_loc = kv_c.shape[1]
        t = t_loc * (1 if tp is None else tp.size)
        bidx = torch.arange(b, device=x.device)
        slot = torch.clamp(pos, max=t - 1)
        if tp is None:
            kv_c[bidx, slot] = kv_c_new.to(kv_c.dtype)
            k_rope[bidx, slot] = k_rope_new.to(k_rope.dtype)
        else:
            mine, local = _slot_owner(slot, t_loc, tp)
            for cache_t, new in ((kv_c, kv_c_new), (k_rope, k_rope_new)):
                cache_t[bidx, local] = torch.where(
                    mine[:, None], new.to(cache_t.dtype),
                    cache_t[bidx, local])
        # absorb wk_b into q: q_lat (B, H, r) = q_nope @ wk_b^T per head
        wk_b = self.wk_b.to(x.dtype).reshape(m.kv_lora_rank, h, m.qk_nope_dim)
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope, wk_b)
        if tp is not None:                    # every head's latent query
            q_lat = parallel.all_gather_cat(q_lat, tp, 1)
            q_rope = parallel.all_gather_cat(q_rope, tp, 1)
        s_lat = _bmm_f32(q_lat, kv_c.transpose(1, 2))         # (B, H, T)
        s_rope = _bmm_f32(q_rope, k_rope.transpose(1, 2))
        scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
        s = (s_lat + s_rope) * scale
        at = torch.arange(t_loc, device=x.device)
        if tp is not None:
            at = at + tp.index * t_loc
        valid = at[None, :] <= pos[:, None]
        s = torch.where(valid[:, None, :], s, -1e30)
        p = torch.softmax(s, dim=-1) if tp is None else _cp_softmax(s, tp)
        p = p.to(torch.promote_types(kv_c.dtype, torch.bfloat16))
        o_lat = _bmm_f32(p, kv_c)                              # (B, H, r)
        if tp is not None:
            o_lat = parallel.all_reduce(o_lat, tp)
            o_lat = o_lat[:, tp.index * h:(tp.index + 1) * h]
        wv_b = self.wv_b.to(x.dtype).reshape(m.kv_lora_rank, h, m.v_head_dim)
        out = torch.einsum("bhr,rhd->bhd", o_lat.to(x.dtype), wv_b)
        out = out.reshape(b, 1, h * m.v_head_dim)
        return parallel.reduce_from(out @ self.wo.to(x.dtype), tp), cache


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
    hidden width ``d_ff`` (default ``cfg.d_ff``).  Under ``tp`` a rank
    computes its block of hidden columns."""

    tp = None
    tp_dims: Dict[str, Optional[int]] = {}

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
        tp = self.tp
        x = parallel.copy_to(x, tp)
        if self.act == "swiglu":
            h = (F.silu(x @ self.w_gate.to(x.dtype))
                 * (x @ self.w_up.to(x.dtype)))
            return parallel.reduce_from(h @ self.w_down.to(x.dtype), tp)
        b_up = self.b_up
        if tp is not None:
            f = self.w_up.shape[1]
            b_up = parallel.copy_to(b_up, tp)[tp.index * f:(tp.index + 1) * f]
        h = F.gelu(x @ self.w_up.to(x.dtype) + b_up.to(x.dtype),
                   approximate="tanh")
        return parallel.reduce_from(h @ self.w_down.to(x.dtype), tp) + \
            self.b_down.to(x.dtype)


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
    products per expert that received tokens (``EXPERT_MATMULS``).  On
    ``meta`` the group sizes are ``balanced_sizes``, as no routing can be
    read there.
    """

    tp = None
    tp_dims: Dict[str, Optional[int]] = {}

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
        """x: (B, S, D) -> (B, S, D).  Without ``tp`` the reference's dense
        (no mesh) path; under ``tp`` its expert-parallel path when
        ``cfg.moe.ep`` and ``n_experts`` divides over the axis, else its
        dense path on experts gathered from the shards.  (The reference
        also takes the dense path when the batch does not divide over the
        data ranks; a sharded step refuses such a batch.)"""
        tp = self.tp
        if tp is None:
            return self._dense(x, cfg, self.experts_gate, self.experts_up,
                               self.experts_down)
        if cfg.moe.ep and cfg.moe.n_experts % tp.size == 0:
            return self._expert_parallel(x, cfg)
        experts = [parallel.gather_replicated(
            getattr(self, n), tp, self.tp_dims[n])
            if self.tp_dims.get(n) is not None else getattr(self, n)
            for n in ("experts_gate", "experts_up", "experts_down")]
        return self._dense(x, cfg, *experts)

    def _dense(self, x, cfg: ModelConfig, gate, up, down):
        """The dropless dispatch over every expert (weights given whole)."""
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
        if x.device.type == "meta":
            self.group_sizes = balanced_sizes(flat_e.numel(), mo.n_experts)
        else:
            self.group_sizes = torch.bincount(
                flat_e, minlength=mo.n_experts).tolist()       # host sync
        out_sorted = torch.empty_like(gathered)
        start = 0
        for e, n in enumerate(self.group_sizes):
            if n == 0:
                continue
            seg = gathered[start:start + n]
            h = (F.silu(seg @ gate[e].to(x.dtype))
                 * (seg @ up[e].to(x.dtype)))
            out_sorted[start:start + n] = h @ down[e].to(x.dtype)
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

    def _expert_parallel(self, x, cfg: ModelConfig):
        """The reference's ``_apply_moe_ep`` on this rank: the local
        experts' share of the data shard's tokens, summed over the model
        axis, plus the shared expert."""
        tp = self.tp
        b, s, d = x.shape
        xt = x.reshape(b * s, d)
        # every rank routes alike; the weights and x then feed only this
        # rank's experts, so their gradients are summed over the axis
        top_w, top_e = self.route(xt, cfg)
        combined, self.group_sizes = ep_local(
            parallel.copy_to(xt, tp), cfg, parallel.copy_to(top_w, tp),
            top_e, self.experts_gate, self.experts_up, self.experts_down,
            tp.size, tp.index)
        out = parallel.reduce_from(combined, tp).reshape(b, s, d)
        out = out.to(x.dtype)
        if self.shared is not None:
            out = out + self.shared(x)
        return out


def balanced_sizes(assignments: int, n_experts: int) -> List[int]:
    """The routing assumed on ``meta``, where none can be read: the
    ``assignments`` (tokens times top-k) split evenly over ``n_experts``,
    the remainder one each to the first experts.  The dropless dispatch
    does the same products whatever the split; under expert parallelism a
    rank's rows are this split's, up to its capacity."""
    q, r = divmod(assignments, n_experts)
    return [q + (e < r) for e in range(n_experts)]


def ep_capacity(cfg: ModelConfig, t_local: int, ep: int) -> int:
    """Token assignments a rank keeps of its data shard's ``t_local``
    tokens (the reference's fixed per-rank capacity)."""
    mo = cfg.moe
    cap = int(np.ceil(t_local * mo.top_k / ep * mo.capacity_factor))
    return min(cap, t_local * mo.top_k)


def ep_local(xt, cfg: ModelConfig, top_w, top_e, gate, up, down, ep: int,
             rank: int):
    """Rank ``rank`` of ``ep``'s part of the reference's expert-parallel
    MoE on tokens xt (T, D) routed to experts ``top_e`` with weights
    ``top_w`` (T, k) (``MoE.route``), ``gate``/``up``/``down`` its
    ``E / ep`` experts: keep the assignments to local experts by a stable
    sort of ``where(mine, e, E)``, the first ``ep_capacity`` of them (the
    rest dropped, as the reference drops them), run each local expert on
    its rows, weight them and add them onto their tokens.  Returns ((T, D)
    in xt's dtype, the rows each local expert ran (host ints))."""
    global EXPERT_MATMULS
    mo = cfg.moe
    e_local = mo.n_experts // ep
    n_tok, d = xt.shape
    cap = ep_capacity(cfg, n_tok, ep)
    flat_e = top_e.reshape(-1)
    flat_w = top_w.reshape(-1)
    src = torch.arange(n_tok, device=xt.device).repeat_interleave(mo.top_k)
    mine = torch.div(flat_e, e_local, rounding_mode="floor") == rank
    key = torch.where(mine, flat_e, torch.full_like(flat_e, mo.n_experts))
    sel = torch.argsort(key, stable=True)[:cap]
    valid = mine[sel]
    rows = src[sel]
    gathered = xt[rows] * valid[:, None].to(xt.dtype)
    le = torch.where(valid, flat_e[sel] - rank * e_local,
                     torch.full_like(sel, e_local))
    if xt.device.type == "meta":
        # the balanced split's local experts, in order, up to the capacity
        sizes, left = [], cap
        for n in balanced_sizes(flat_e.numel(), mo.n_experts)[
                rank * e_local:(rank + 1) * e_local]:
            sizes.append(min(n, left))
            left -= sizes[-1]
    else:
        sizes = torch.bincount(le, minlength=e_local + 1)[:e_local].tolist()
    parts, start = [], 0
    for e, n in enumerate(sizes):
        if n == 0:
            continue
        seg = gathered[start:start + n]
        h = F.silu(seg @ gate[e].to(xt.dtype)) * (seg @ up[e].to(xt.dtype))
        parts.append(h @ down[e].to(xt.dtype))
        EXPERT_MATMULS += 3
        start += n
    parts.append(gathered.new_zeros((cap - start, d)))
    out_rows = torch.cat(parts) * (flat_w[sel] * valid.float())[:, None].to(
        xt.dtype)
    combined = torch.zeros((n_tok, d), dtype=out_rows.dtype,
                           device=xt.device).index_add(0, rows, out_rows)
    return combined, sizes


@torch.no_grad()
def moe_ep_plain(moe: MoE, cfg: ModelConfig, x, ep: int):
    """The expert-parallel MoE of ``ep`` ranks restated on one device with
    the whole weights: each rank's ``ep_local`` part on the data shard x
    (B, S, D), summed in rank order, plus the shared expert.  Returns
    (out, each rank's rows per local expert)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    e_local = cfg.moe.n_experts // ep
    top_w, top_e = moe.route(xt, cfg)
    total, sizes = None, []
    for r in range(ep):
        w = slice(r * e_local, (r + 1) * e_local)
        part, n = ep_local(xt, cfg, top_w, top_e, moe.experts_gate[w],
                           moe.experts_up[w], moe.experts_down[w], ep, r)
        total = part if total is None else total + part
        sizes.append(n)
    out = total.reshape(b, s, d).to(x.dtype)
    if moe.shared is not None:
        out = out + moe.shared(x)
    return out, sizes


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
