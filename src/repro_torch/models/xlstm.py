"""xLSTM blocks: chunkwise-parallel mLSTM and sequential sLSTM.

The mLSTM's chunkwise-parallel form computes, inside each chunk,

    H = (D (.) (Q Kᵀ)) V

where D is the lower-triangular exp-gate decay mask: the same masked tile
product as the paper's C = M (.) (A B).  Cross-chunk state is a (dk x dv)
matrix-memory recurrence with the reference's log-space stabiliser, run
as a Python loop over chunks; the sLSTM is a loop over tokens.  Gates,
states and stabilisers are f32 on the reference's formulas; every product
is a plain torch ``einsum``/``matmul``, as the reference's are XLA dots.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, XLSTMCfg
from .common import dense_init, rms_norm
from .layers import _param

NEG = -1e30


def _dims(cfg: ModelConfig):
    x: XLSTMCfg = cfg.xlstm
    hd = x.head_dim or (cfg.d_model // cfg.n_heads)
    return x, cfg.n_heads, hd


def _log_sigmoid(x):
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class mLSTM(nn.Module):
    """Parameters named as the reference's ``init_mlstm``: ``wq``, ``wk``,
    ``wv``, ``w_og`` (d, nh*hd), ``w_if`` (d, 2 nh) and ``b_if`` (2 nh,)
    (input gates, then forget gates, biased to 3), ``norm_scale`` (nh*hd,),
    ``out_proj`` (nh*hd, d)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        _, nh, hd = _dims(cfg)
        d, d_in, dev = cfg.d_model, nh * hd, generator.device
        self.wq = _param(dense_init(generator, (d, d_in)))
        self.wk = _param(dense_init(generator, (d, d_in)))
        self.wv = _param(dense_init(generator, (d, d_in)))
        self.w_if = _param(dense_init(generator, (d, 2 * nh), scale=0.5))
        self.b_if = _param(torch.cat([torch.zeros(nh, device=dev),
                                      torch.full((nh,), 3.0, device=dev)]))
        self.w_og = _param(dense_init(generator, (d, d_in), scale=0.5))
        self.norm_scale = _param(torch.ones(d_in, device=dev))
        self.out_proj = _param(dense_init(generator, (d_in, d)))

    def forward(self, x, cfg: ModelConfig):
        return apply_mlstm(self, cfg, x)

    def decode(self, x, cache: Dict[str, torch.Tensor], cfg: ModelConfig):
        return apply_mlstm_decode(self, cfg, x, cache)


def _mlstm_gates(p: mLSTM, cfg: ModelConfig, x):
    _, nh, hd = _dims(cfg)
    b, L, _ = x.shape
    q = (x @ p.wq.to(x.dtype)).reshape(b, L, nh, hd)
    k = (x @ p.wk.to(x.dtype)).reshape(b, L, nh, hd)
    v = (x @ p.wv.to(x.dtype)).reshape(b, L, nh, hd)
    if_pre = (x @ p.w_if.to(x.dtype)).float() + p.b_if
    log_i = if_pre[..., :nh]                       # i = exp(i_pre)
    log_f = _log_sigmoid(if_pre[..., nh:])         # f = sigmoid(f_pre)
    og = torch.sigmoid(x @ p.w_og.to(x.dtype))
    return q, k, v, log_i, log_f, og


def apply_mlstm(p: mLSTM, cfg: ModelConfig, x):
    """Chunkwise-parallel mLSTM. x: (B, L, D) -> (B, L, D); L must be a
    multiple of the chunk (or shorter than it)."""
    xc, nh, hd = _dims(cfg)
    b, L, _ = x.shape
    Q = min(xc.chunk, L)
    if L % Q:
        raise ValueError(f"sequence {L} is not a multiple of the chunk {Q}")
    nc = L // Q
    q, k, v, log_i, log_f, og = _mlstm_gates(p, cfg, x)
    scale = hd ** -0.5

    qh = q.reshape(b, nc, Q, nh, hd).float() * scale
    kh = k.reshape(b, nc, Q, nh, hd).float()
    vh = v.reshape(b, nc, Q, nh, hd).float()
    li = log_i.reshape(b, nc, Q, nh)
    lf = log_f.reshape(b, nc, Q, nh)

    Fc = torch.cumsum(lf, dim=2)                   # within-chunk cum log f
    Ftot = Fc[:, :, -1, :]                         # (b, nc, nh)

    # ---- intra-chunk masked product:  D_ij = exp(F_i - F_j + li_j) --------
    logD = Fc[:, :, :, None, :] - Fc[:, :, None, :, :] + li[:, :, None, :, :]
    ii = torch.arange(Q, device=x.device)
    tri = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    logD = torch.where(tri, logD, NEG)
    m_intra = logD.amax(dim=3)                     # (b, nc, Q, nh)

    # ---- cross-chunk recurrence with stabiliser: the state before each
    # chunk (C (b,nh,dk,dv), n (b,nh,dk), m (b,nh)) is kept for that chunk
    C = torch.zeros((b, nh, hd, hd), device=x.device)
    n = torch.zeros((b, nh, hd), device=x.device)
    m = torch.full((b, nh), NEG, device=x.device)
    C_prev = torch.empty((b, nc, nh, hd, hd), device=x.device)
    n_prev = torch.empty((b, nc, nh, hd), device=x.device)
    m_prev = torch.empty((b, nc, nh), device=x.device)
    for c in range(nc):
        C_prev[:, c], n_prev[:, c], m_prev[:, c] = C, n, m
        kh_c, vh_c, Ftot_c = kh[:, c], vh[:, c], Ftot[:, c]
        # per-position source log-weights for the state update
        lw = Ftot_c[:, None, :] - Fc[:, c] + li[:, c]   # (b, Q, nh)
        m_loc = lw.amax(dim=1)                          # (b, nh)
        m_new = torch.maximum(Ftot_c + m, m_loc)
        w = torch.exp(lw - m_new[:, None, :])           # (b, Q, nh)
        decay = torch.exp(Ftot_c + m - m_new)           # (b, nh)
        kw = kh_c * w[..., None]
        C = C * decay[..., None, None] + torch.einsum("bqhk,bqhv->bhkv", kw,
                                                      vh_c)
        n = n * decay[..., None] + kw.sum(dim=1)
        m = m_new

    # combined stabiliser per position: max(intra row max, inter decay + m)
    log_inter = Fc + m_prev[:, :, None, :]         # (b, nc, Q, nh)
    m_row = torch.maximum(m_intra, log_inter)

    D = torch.exp(logD - m_row[:, :, :, None, :])
    s = torch.einsum("bcqhd,bckhd->bcqkh", qh, kh) * D
    h_intra = torch.einsum("bcqkh,bckhv->bcqhv", s, vh)
    l_intra = s.sum(dim=3)                         # (b, nc, Q, nh)

    w_inter = torch.exp(log_inter - m_row)         # (b, nc, Q, nh)
    qw = qh * w_inter[..., None]
    h_inter = torch.einsum("bcqhk,bchkv->bcqhv", qw, C_prev)
    l_inter = torch.einsum("bcqhk,bchk->bcqh", qw, n_prev)

    l = l_intra + l_inter
    denom = torch.maximum(l.abs(), torch.exp(-m_row))
    h = (h_intra + h_inter) / denom[..., None]

    h = h.reshape(b, L, nh * hd).to(x.dtype) * og
    h = rms_norm(h, p.norm_scale)
    return h @ p.out_proj.to(x.dtype)


def mlstm_cache_init(cfg: ModelConfig, batch: int, device,
                     lead=()) -> Dict[str, torch.Tensor]:
    """mLSTM states, f32, with leading axes ``lead``: ``C`` (B, nh, hd,
    hd), ``n`` (B, nh, hd), ``m`` (B, nh) at NEG."""
    _, nh, hd = _dims(cfg)
    lead = tuple(lead)
    return {
        "C": torch.zeros(lead + (batch, nh, hd, hd), device=device),
        "n": torch.zeros(lead + (batch, nh, hd), device=device),
        "m": torch.full(lead + (batch, nh), NEG, device=device),
    }


def apply_mlstm_decode(p: mLSTM, cfg: ModelConfig, x,
                       cache: Dict[str, torch.Tensor]):
    """Exact sequential recurrence, one step. x: (B, 1, D); cache: this
    layer's ``{"C", "n", "m"}``, updated in place."""
    _, nh, hd = _dims(cfg)
    b = x.shape[0]
    q, k, v, log_i, log_f, og = _mlstm_gates(p, cfg, x)
    qf = q[:, 0].float() * hd ** -0.5              # (b, nh, hd)
    kf = k[:, 0].float()
    vf = v[:, 0].float()
    li, lf = log_i[:, 0], log_f[:, 0]              # (b, nh)
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(lf + m, li)
    decay = torch.exp(lf + m - m_new)
    inp = torch.exp(li - m_new)
    C_new = C * decay[..., None, None] + torch.einsum(
        "bhk,bhv->bhkv", kf * inp[..., None], vf)
    n_new = n * decay[..., None] + kf * inp[..., None]
    h_num = torch.einsum("bhk,bhkv->bhv", qf, C_new)
    l = torch.einsum("bhk,bhk->bh", qf, n_new)
    denom = torch.maximum(l.abs(), torch.exp(-m_new))
    h = (h_num / denom[..., None]).reshape(b, 1, nh * hd).to(x.dtype)
    h = rms_norm(h * og, p.norm_scale)
    out = h @ p.out_proj.to(x.dtype)
    C.copy_(C_new)
    n.copy_(n_new)
    m.copy_(m_new)
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM (sequential scalar recurrence, block-diagonal recurrent weights)
# ---------------------------------------------------------------------------


class sLSTM(nn.Module):
    """Parameters named as the reference's ``init_slstm``: ``w_in``
    (d, 4 nh*hd), ``r_blocks`` (4, nh, hd, hd), ``b_gates`` (4 nh*hd,)
    (input, forget biased to 3, cell, output), ``norm_scale`` (nh*hd,),
    ``out_proj`` (nh*hd, d)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        _, nh, hd = _dims(cfg)
        d, d_in, dev = cfg.d_model, nh * hd, generator.device
        self.w_in = _param(dense_init(generator, (d, 4 * d_in)))
        self.r_blocks = _param(dense_init(generator, (4, nh, hd, hd),
                                          scale=0.5))
        self.b_gates = _param(torch.cat([
            torch.zeros(d_in, device=dev), torch.full((d_in,), 3.0,
                                                      device=dev),
            torch.zeros(2 * d_in, device=dev)]))
        self.norm_scale = _param(torch.ones(d_in, device=dev))
        self.out_proj = _param(dense_init(generator, (d_in, d)))

    def forward(self, x, cfg: ModelConfig):
        return apply_slstm(self, cfg, x)

    def decode(self, x, cache: Dict[str, torch.Tensor], cfg: ModelConfig):
        return apply_slstm_decode(self, cfg, x, cache)


def _slstm_cell(r_blocks, b_gates, cfg: ModelConfig, x_pre, state):
    """One step. x_pre: (B, 4*d_in) input preactivations (no recurrent);
    ``r_blocks`` and ``b_gates`` already in h's dtype; the recurrent
    product is in h's dtype, the gates and states in f32."""
    _, nh, hd = _dims(cfg)
    c, n, m, h = state
    hb = h.reshape(-1, nh, hd)
    rec = torch.einsum("bhd,ghde->bghe", hb, r_blocks)   # (b, 4, nh, hd)
    pre = x_pre.reshape(-1, 4, nh, hd) + rec + b_gates
    pre = pre.float()
    li = pre[:, 0]                                  # log input gate
    lf = _log_sigmoid(pre[:, 1])                    # log sigmoid forget
    z = torch.tanh(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(lf + m, li)
    c_new = torch.exp(lf + m - m_new) * c + torch.exp(li - m_new) * z
    n_new = torch.exp(lf + m - m_new) * n + torch.exp(li - m_new)
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, m_new, h_new.to(h.dtype)


def _slstm_weights(p: sLSTM, cfg: ModelConfig, dtype):
    _, nh, hd = _dims(cfg)
    return (p.r_blocks.to(dtype), p.b_gates.reshape(4, nh, hd).to(dtype))


def apply_slstm(p: sLSTM, cfg: ModelConfig, x):
    """Sequential loop over time. x: (B, L, D) -> (B, L, D)."""
    _, nh, hd = _dims(cfg)
    b, L, _ = x.shape
    d_in = nh * hd
    x_pre = x @ p.w_in.to(x.dtype)                 # (B, L, 4*d_in)
    r_blocks, b_gates = _slstm_weights(p, cfg, x.dtype)
    init = slstm_cache_init(cfg, b, x.device)
    state = (init["c"], init["n"], init["m"],
             torch.zeros((b, nh, hd), dtype=x.dtype, device=x.device))
    hs = torch.empty((b, L, nh, hd), dtype=x.dtype, device=x.device)
    for t in range(L):
        state = _slstm_cell(r_blocks, b_gates, cfg, x_pre[:, t], state)
        hs[:, t] = state[3]
    h = rms_norm(hs.reshape(b, L, d_in), p.norm_scale)
    return h @ p.out_proj.to(x.dtype)


def slstm_cache_init(cfg: ModelConfig, batch: int, device,
                     lead=()) -> Dict[str, torch.Tensor]:
    """sLSTM states, f32, each (B, nh, hd) after the leading axes ``lead``:
    ``c``, ``n``, ``m`` (at NEG) and ``h``."""
    _, nh, hd = _dims(cfg)
    shape = tuple(lead) + (batch, nh, hd)
    return {
        "c": torch.zeros(shape, device=device),
        "n": torch.zeros(shape, device=device),
        "m": torch.full(shape, NEG, device=device),
        "h": torch.zeros(shape, device=device),
    }


def apply_slstm_decode(p: sLSTM, cfg: ModelConfig, x,
                       cache: Dict[str, torch.Tensor]):
    """One step. x: (B, 1, D); cache: this layer's ``{"c", "n", "m", "h"}``,
    updated in place."""
    _, nh, hd = _dims(cfg)
    b = x.shape[0]
    x_pre = x[:, 0] @ p.w_in.to(x.dtype)
    r_blocks, b_gates = _slstm_weights(p, cfg, x.dtype)
    state = (cache["c"], cache["n"], cache["m"], cache["h"].to(x.dtype))
    c, n, m, h = _slstm_cell(r_blocks, b_gates, cfg, x_pre, state)
    out = rms_norm(h.reshape(b, 1, nh * hd), p.norm_scale)
    out = out @ p.out_proj.to(x.dtype)
    for name, new in (("c", c), ("n", n), ("m", m), ("h", h.float())):
        cache[name].copy_(new)
    return out, cache
