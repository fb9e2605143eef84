"""Mamba2 mixer via the SSD chunked-matmul algorithm.

The SSD decomposition computes, per chunk of Q timesteps,

    Y_intra = (L (.) (C Bᵀ)) X          -- a masked tile product: L is the
                                           lower-triangular decay mask, the
                                           paper's C = M (.) (A B) with a
                                           structured mask
    Y_inter = decay-weighted C @ S_prev -- cross-chunk recurrence

Shapes follow the Mamba2 reference: d_inner = expand * d_model, nh heads of
head_dim p, shared B/C of state size n (ngroups = 1).  The reference's
chunk scan is a Python loop over chunks here; every product is a plain
torch ``matmul``/``einsum`` (the reference's are XLA dots, no Pallas
kernel), with the intra-chunk product's bf16 operands summed in f32
(``_bmm_f32``).

Tensor parallelism (``tp``, set by ``train_step.shard_model``).  The
reference splits ``in_proj`` by columns and ``out_proj`` by rows; the
column blocks cut across the z | x | B | C | dt segments (zamba2-7b's
14,576 columns give rank 0 of two all of z and 120 columns of x), so no
rank can run its heads from its own block.  The projection's output is
all-gathered instead (``gather_partial``: (B, L, 14,576) a layer, where
all-gathering the weight would move its 104 MB every forward), and a
rank then takes its heads' z, x and dt and the whole B and C, runs the
causal conv on those channels (``conv_w`` / ``conv_b`` whole, read in
part), the SSD on its heads and the gated RMSNorm with its sum of squares
summed over the axis (``parallel.sum_partials``), and leaves through its
rows of ``out_proj`` by ``reduce_from``.  Decode keeps the reference's
cache placements: the state ``S`` by heads and the conv history by its
channels over the model axis; a rank convolves its own channels and the
conv output (C channels a token) is all-gathered.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, SSMCfg
from .attention import _bmm_f32
from repro_torch import parallel
from .common import dense_init, rms_norm
from .layers import Place, _model_dim, _param


def _dims(cfg: ModelConfig):
    s: SSMCfg = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nh = d_inner // s.head_dim
    return s, d_inner, nh


class SSM(nn.Module):
    """The Mamba2 mixer's parameters, named as the reference's
    ``init_ssm``: ``in_proj`` (d, 2 d_inner + 2 n + nh), ``conv_w`` (W, C)
    and ``conv_b`` (C,) with C = d_inner + 2 n, ``a_log``, ``dt_bias``,
    ``d_skip`` (nh,), ``norm_scale`` (d_inner,), ``out_proj`` (d_inner, d).
    Under ``tp`` a rank runs heads [i nh / tp, (i + 1) nh / tp).
    """

    tp = None
    tp_dims: Dict[str, Optional[int]] = {}

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        s, d_inner, nh = _dims(cfg)
        dev = generator.device
        conv_ch = d_inner + 2 * s.d_state
        self.in_proj = _param(dense_init(
            generator, (cfg.d_model, 2 * d_inner + 2 * s.d_state + nh)))
        self.conv_w = _param(dense_init(generator, (s.conv_width, conv_ch),
                                        scale=1.0))
        self.conv_b = _param(torch.zeros(conv_ch, device=dev))
        self.a_log = _param(torch.zeros(nh, device=dev))
        self.dt_bias = _param(torch.zeros(nh, device=dev))
        self.d_skip = _param(torch.ones(nh, device=dev))
        self.norm_scale = _param(torch.ones(d_inner, device=dev))
        self.out_proj = _param(dense_init(generator, (d_inner, cfg.d_model)))

    def forward(self, x, cfg: ModelConfig):
        return apply_ssm(self, cfg, x)

    def decode(self, x, cache: Dict[str, torch.Tensor], cfg: ModelConfig,
               place: Optional[Dict[str, Place]] = None):
        return apply_ssm_decode(self, cfg, x, cache, place)

    def heads(self, cfg: ModelConfig):
        """(first head, end head) of this rank: all of them without
        ``tp``."""
        nh = _dims(cfg)[2]
        if self.tp is None:
            return 0, nh
        n = nh // self.tp.size
        return self.tp.index * n, (self.tp.index + 1) * n


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, L, C); w: (W, C).  A shifted
    multiply-add over the width in x's dtype, in the reference's order."""
    width, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for t in range(width):
        out = out + pad[:, t:t + L] * w[t].to(x.dtype)
    return F.silu(out + b.to(x.dtype))


def _split_proj(p: SSM, cfg: ModelConfig, x, gather):
    """``x @ in_proj`` split into z, xs (d_inner each), B, C (n each) and
    dt (nh); under ``tp`` the rank's column block all-gathered by
    ``gather`` (``parallel.gather_partial`` in a forward, the plain
    all-gather in decode) into the whole projection."""
    s, d_inner, nh = _dims(cfg)
    zxbcdt = x @ p.in_proj.to(x.dtype)
    if p.tp is not None:
        zxbcdt = gather(zxbcdt, p.tp, -1)
    return torch.split(zxbcdt, [d_inner, d_inner, s.d_state, s.d_state, nh],
                       dim=-1)


def _local(p: SSM, cfg: ModelConfig, z, xs, dt):
    """z, xs and dt cut to this rank's heads, and the conv channels (of
    the C = d_inner + 2 n) those heads read: their xs, then B and C."""
    s, d_inner, _ = _dims(cfg)
    h0, h1 = p.heads(cfg)
    c0, c1 = h0 * s.head_dim, h1 * s.head_dim
    chans = torch.cat([torch.arange(c0, c1), torch.arange(
        d_inner, d_inner + 2 * s.d_state)]).to(z.device)
    return z[..., c0:c1], xs[..., c0:c1], dt[..., h0:h1], chans


def _whole(p: SSM, name: str, lo: int = 0, hi: Optional[int] = None):
    """A whole parameter, read in part under ``tp`` (so its gradient is
    summed over the axis), cut to [lo, hi) on its last dim."""
    w = parallel.copy_to(getattr(p, name), p.tp)
    return w[..., lo:hi]


def _gated_norm(p: SSM, cfg: ModelConfig, y, z):
    """``rms_norm(y * silu(z), norm_scale)`` over d_inner, of which this
    rank holds its heads' channels: their sum of squares is summed over
    the model axis."""
    if p.tp is None:
        return rms_norm(y * F.silu(z), p.norm_scale)
    s, d_inner, _ = _dims(cfg)
    h0, h1 = p.heads(cfg)
    g = y * F.silu(z)
    gf = g.float()
    ss = parallel.sum_partials(gf.square().sum(dim=-1, keepdim=True), p.tp)
    scale = _whole(p, "norm_scale", h0 * s.head_dim, h1 * s.head_dim)
    return (gf * torch.rsqrt(ss / d_inner + 1e-5) * scale.float()).to(g.dtype)


def _ssd_intra(Ch, Bh, dth, xh, cum, act):
    """The masked tile product of every chunk, Y_intra = (L (.) C Bᵀ) X with
    L_ij = exp(cum_i - cum_j) dt_j on and below the diagonal, 0 above it
    (with a finite gradient there, where the reference's is NaN once the
    masked exponent overflows).  Ch, Bh (b, nc, Q,
    n), dth, cum (b, nc, Q, nh) and xh (b, nc, Q, nh, p) in f32; the decay
    tile and the gated scores are in ``act`` (decays are <= 1), the product
    sums in f32.  Returns (b, nc, Q, nh, p) f32."""
    b, nc, Q, nh, hp = xh.shape
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,Q,Q,nh)
    ii = torch.arange(Q, device=xh.device)
    tri = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # exp of -inf above the diagonal, not exp(diff) masked after: the
    # reference's where(tri, exp(diff), 0) overflows there (diff is a
    # positive sum of dt |A| over up to a chunk) and its backward gives
    # 0 * inf = NaN; the forward values are the same
    Lmask = torch.exp(diff.masked_fill(~tri, -torch.inf)).to(act)
    del diff
    scores = torch.einsum("bcqn,bckn->bcqk", Ch, Bh)     # (b, nc, Q, Q)
    gated = (scores[..., None].to(act) * Lmask
             * dth[:, :, None, :, :].to(act))            # (b,nc,Q,K,nh)
    del Lmask
    # y[b,c,q,h,:] = sum_k gated[b,c,q,k,h] x[b,c,k,h,:]: one batched
    # product over (b, c, h)
    g3 = gated.permute(0, 1, 4, 2, 3).reshape(b * nc * nh, Q, Q)
    x3 = xh.to(act).permute(0, 1, 3, 2, 4).reshape(b * nc * nh, Q, hp)
    return (_bmm_f32(g3, x3).reshape(b, nc, nh, Q, hp)
            .permute(0, 1, 3, 2, 4))


def _ssd_inter(Ch, Bh, dth, xh, cum):
    """The chunk states S_c = sum_j exp(cum_last - cum_j) dt_j B_j (x) X_j
    and the cross-chunk recurrence, a loop over chunks that computes each
    chunk's Y_inter = exp(cum) C S_prev inside it, so one chunk's state is
    live at a time, as in the reference.  All f32; returns (b, nc, Q, nh,
    p)."""
    b, nc, Q, nh, hp = xh.shape
    decay_state = torch.exp(cum[:, :, -1:, :] - cum)     # (b, nc, Q, nh)
    wX = xh * (dth * decay_state)[..., None]             # (b,nc,Q,nh,p)
    S_c = torch.einsum("bcqn,bcqhp->bchnp", Bh, wX)      # (b,nc,nh,n,p)
    del wX
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (b, nc, nh)
    inter_decay = torch.exp(cum)                         # (b, nc, Q, nh)
    S = torch.zeros((b, nh, Bh.shape[-1], hp), device=xh.device)
    y_inter = torch.empty_like(xh)
    for c in range(nc):
        y_inter[:, c] = (torch.einsum("bqn,bhnp->bqhp", Ch[:, c], S)
                         * inter_decay[:, c, :, :, None])
        S = S * chunk_decay[:, c, :, None, None] + S_c[:, c]
    return y_inter


def apply_ssm(p: SSM, cfg: ModelConfig, x):
    """x: (B, L, D) -> (B, L, D) via the SSD chunked scan; L must be a
    multiple of the chunk (or shorter than it)."""
    s, d_inner, _ = _dims(cfg)
    b, L, _ = x.shape
    Q = min(s.chunk, L)
    if L % Q:
        raise ValueError(f"sequence {L} is not a multiple of the chunk {Q}")
    nc = L // Q
    hp = s.head_dim
    h0, h1 = p.heads(cfg)
    nh = h1 - h0

    x = parallel.copy_to(x, p.tp)
    z, xs, B, C, dt = _split_proj(p, cfg, x, parallel.gather_partial)
    z, xs, dt, chans = _local(p, cfg, z, xs, dt)
    conv_w, conv_b = p.conv_w, p.conv_b
    if p.tp is not None:
        conv_w = _whole(p, "conv_w")[:, chans]
        conv_b = _whole(p, "conv_b")[chans]
    conv_in = torch.cat([xs, B, C], dim=-1)
    conv_out = _causal_conv(conv_in, conv_w, conv_b)
    xs, B, C = torch.split(conv_out, [nh * hp, s.d_state, s.d_state], dim=-1)

    dt = F.softplus(dt.float() + _whole(p, "dt_bias", h0, h1))  # (B, L, nh)
    A = -torch.exp(_whole(p, "a_log", h0, h1))           # (nh,)
    xh = xs.reshape(b, nc, Q, nh, hp).float()
    Bh = B.reshape(b, nc, Q, s.d_state).float()
    Ch = C.reshape(b, nc, Q, s.d_state).float()
    dth = dt.reshape(b, nc, Q, nh)
    cum = torch.cumsum(dth * A, dim=2)                   # within-chunk csum

    y = (_ssd_intra(Ch, Bh, dth, xh, cum, cfg.activation_dtype)
         + _ssd_inter(Ch, Bh, dth, xh, cum)).reshape(b, L, nh, hp)
    y = y + xh.reshape(b, L, nh, hp) * _whole(p, "d_skip", h0, h1)[:, None]
    y = y.reshape(b, L, nh * hp)
    y = _gated_norm(p, cfg, y.to(x.dtype), z)
    return parallel.reduce_from(y @ p.out_proj.to(x.dtype), p.tp)


# ---------------------------------------------------------------------------
# decode (single-step recurrence)
# ---------------------------------------------------------------------------


def ssm_cache_init(cfg: ModelConfig, batch: int, dtype, device,
                   layers: int) -> Dict[str, torch.Tensor]:
    """SSM states of ``layers`` layers stacked on a leading axis: ``S``
    (layers, B, nh, n, p) in f32 and the conv history ``conv``
    (layers, B, W - 1, C) in ``dtype``."""
    s, d_inner, nh = _dims(cfg)
    conv_ch = d_inner + 2 * s.d_state
    return {
        "S": torch.zeros((layers, batch, nh, s.d_state, s.head_dim),
                         device=device),
        "conv": torch.zeros((layers, batch, s.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
    }


def apply_ssm_decode(p: SSM, cfg: ModelConfig, x,
                     cache: Dict[str, torch.Tensor],
                     place: Optional[Dict[str, Place]] = None):
    """One-token recurrence. x: (B, 1, D); cache: this layer's ``{"S",
    "conv"}``, updated in place.  Returns (out (B, 1, D), cache).  Under
    ``tp`` (``place``: ``S`` by heads, ``conv`` by channels) the rank
    updates its heads' state and its channels' conv history."""
    s, d_inner, _ = _dims(cfg)
    b = x.shape[0]
    h0, h1 = p.heads(cfg)
    nh, hp = h1 - h0, s.head_dim
    tp = p.tp
    if tp is not None and (_model_dim(p, place, "S") != 1
                           or _model_dim(p, place, "conv") != 2):
        raise NotImplementedError(
            f"SSM decode with the model axis on dims "
            f"{_model_dim(p, place, 'S')} and {_model_dim(p, place, 'conv')} "
            f"of S (B, nh, n, p) and conv (B, W - 1, C): heads and channels "
            f"only")
    z, xs, B, C, dt = _split_proj(p, cfg, x, parallel.all_gather_cat)
    conv_in = torch.cat([xs, B, C], dim=-1)[:, 0]        # (B, C)
    conv_w, conv_b = p.conv_w, p.conv_b
    if tp is not None:                                   # this rank's channels
        n_ch = cache["conv"].shape[-1]
        lo = tp.index * n_ch
        conv_in = conv_in[:, lo:lo + n_ch]
        conv_w, conv_b = conv_w[:, lo:lo + n_ch], conv_b[lo:lo + n_ch]
    hist = torch.cat([cache["conv"],
                      conv_in[:, None].to(cache["conv"].dtype)],
                     dim=1)                              # (B, W, C)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist.to(x.dtype),
                                   conv_w.to(x.dtype))
                      + conv_b.to(x.dtype))
    if tp is not None:
        conv_out = parallel.all_gather_cat(conv_out, tp, -1)
    xs, B, C = torch.split(conv_out, [d_inner, s.d_state, s.d_state],
                           dim=-1)
    z, xs, dt, _ = _local(p, cfg, z, xs, dt)
    dt = F.softplus(dt[:, 0].float() + p.dt_bias[h0:h1])  # (B, nh)
    A = -torch.exp(p.a_log[h0:h1])
    dec = torch.exp(dt * A)                              # (B, nh)
    xh = xs.reshape(b, nh, hp).float()
    Bf, Cf = B.float(), C.float()
    S = cache["S"] * dec[..., None, None] + torch.einsum(
        "bn,bhp->bhnp", Bf, xh * dt[..., None])
    y = torch.einsum("bn,bhnp->bhp", Cf, S)
    y = y + xh * p.d_skip[h0:h1, None]
    y = y.reshape(b, 1, nh * hp)
    y = _gated_norm(p, cfg, y.to(x.dtype), z)
    out = parallel.reduce_from(y @ p.out_proj.to(x.dtype), tp)
    cache["S"].copy_(S)
    cache["conv"].copy_(hist[:, 1:])
    return out, cache
