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
another (the reference scans stacked layers).  For training, ``loss_fn``
is the reference's next-token loss, and with gradients on each block body
the reference wraps in ``jax.checkpoint`` is recomputed in the backward as
``cfg.remat`` says (``_remat``).

Sharded (``train_step.shard_model``, every family): ``tp`` is the model
axis and ``tp_dims`` the dims it splits of ``embed`` and ``lm_head``, as
the reference's rules and ``fit_spec`` place them.  An embedding split by
vocabulary rows gives a rank the tokens it holds (zeros elsewhere) and the
ranks' rows are summed; one split by d_model columns (a vocabulary that
does not divide the axis: internvl2's 92,553 rows) gives a rank its
columns of every token, all-gathered.  A head split by vocabulary gives
each rank its block of the logits, and ``loss_fn`` is then vocabulary
parallel (the maximum and the sum of exponentials reduced over the axis,
the gold logit from the rank that holds it); a head split by d_model rows
gives partial sums of whole logits, which leave by ``reduce_from``.
``gather_logits`` makes a rank's vocabulary block whole.

Sharded decode: ``shard_cache`` gives a rank its slices of ``init_cache``'s
cache as the reference places them (``launch.specs.cache_layout``: its
``cache_specs`` under ``fit_spec``) and records the layout on the model;
``init_sharded_cache`` makes the slices without the whole.
``decode_step`` takes the rank's rows of the tokens and positions (and of
the encoder output) and passes each layer the place of its cache.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch import parallel
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import specs as SP
from . import layers as Lyr
from . import ssm as SSM
from . import xlstm as XL
from .common import (axis_dim, dense_init, fit_spec, mesh_sizes,
                     param_generator)

#: the families the port runs, as the reference's ``init_params`` knows
#: them (``ssm`` only with ``cfg.xlstm``)
PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES or (cfg.family == "ssm"
                                             and cfg.xlstm is None):
        raise ValueError(f"family {cfg.family}")


#: the products ``remat="dots"`` keeps: 2-D matmuls, the counterpart of
#: the reference's ``dots_with_no_batch_dims_saveable``
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, recomputed in the backward as ``cfg.remat``
    says (the reference's ``_remat``): ``"none"`` keeps every activation,
    ``"dots"`` only the 2-D matmul outputs, anything else (``"full"``)
    only the inputs.  Unless gradients are on and the block's input ``x``
    (the first argument) requires one, as it does in training, it is a
    plain call: serving outside ``no_grad`` runs what it runs under it.
    The numbers do not change, but the recompute runs the forward code
    again, so the module counters (``BLOCK_MASKED_CALLS``,
    ``EXPERT_MATMULS``, ``MoE.group_sizes``) count it too."""
    if cfg.remat == "none" or not (torch.is_grad_enabled()
                                   and args[0].requires_grad):
        return fn(*args, **kwargs)
    context = _ckpt.noop_context_fn
    if cfg.remat == "dots":
        context = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            context_fn=context, **kwargs)


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

    def decode(self, x, cache, pos, cfg: ModelConfig, place=None):
        h, cache = self.attn.decode(self.ln1(x), cache, pos, cfg, place)
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

    def decode(self, x, cache, cfg: ModelConfig, place=None):
        h, cache = self.mixer.decode(self.ln1(x), cache, cfg, place)
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

    def decode(self, x, cache, pos, enc, cfg: ModelConfig, place=None):
        h, cache = self.attn.decode(self.ln1(x), cache, pos, cfg, place)
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
    built with, the default of every call.  ``tp`` is the model axis of a
    sharded model (else None) and ``tp_dims`` the dims it splits of
    ``embed`` and ``lm_head``; ``shard_layout`` is set by
    ``train_step.shard_model``, ``cache_layout`` by ``shard_cache``."""

    tp = None
    tp_dims: Dict[str, Optional[int]] = {}
    shard_layout = None
    cache_layout = None

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

    def _split(self, name: str) -> Optional[int]:
        return None if self.tp is None else self.tp_dims.get(name)

    def head_split(self) -> Optional[str]:
        """What the model axis splits of the head: ``"vocab"``,
        ``"d_model"`` or None (whole)."""
        if self.lm_head is None:
            d = self._split("embed")
            return {0: "vocab", 1: "d_model"}.get(d)
        return {1: "vocab", 0: "d_model"}.get(self._split("lm_head"))

    @property
    def vocab_parallel(self) -> bool:
        """Whether the logits are a rank's vocabulary block."""
        return self.head_split() == "vocab"

    def vocab_start(self) -> int:
        """The first vocabulary row of this rank's block of the logits."""
        if not self.vocab_parallel:
            return 0
        head = self.embed if self.lm_head is None else self.lm_head.T
        return self.tp.index * head.shape[0]

    def _embed(self, tokens, cfg: ModelConfig):
        split = self._split("embed")
        if split is None:
            return self.embed[tokens].to(cfg.activation_dtype)
        if split == 1:                       # d_model columns, gathered
            x = self.embed[tokens].to(cfg.activation_dtype)
            return parallel.gather_replicated(x, self.tp, -1)
        rows = self.embed.shape[0]
        local = tokens.long() - self.tp.index * rows
        held = (local >= 0) & (local < rows)
        x = self.embed[local.clamp(0, rows - 1)].to(cfg.activation_dtype)
        return parallel.reduce_from(x * held[..., None].to(x.dtype), self.tp)

    def _logits(self, x):
        """The logits, this rank's vocabulary block of them under a
        vocabulary-parallel head."""
        head = self.embed.T if self.lm_head is None else self.lm_head
        x = parallel.copy_to(x, self.tp)
        if self.head_split() == "d_model":
            x = parallel.local_slice(x, self.tp, -1)
            return parallel.reduce_from(x @ head.to(x.dtype), self.tp)
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
            enc = _remat(cfg, block, enc, positions, cfg, causal=False,
                         window=0)
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
            if fam == "ssm" and isinstance(block.mixer, XL.sLSTM):
                x = block(x, cfg)       # the reference remats mLSTMs only
            elif fam in ("ssm", "hybrid"):
                x = _remat(cfg, block, x, cfg)
                if fam == "hybrid" and self._shared(i, cfg):
                    x = _remat(cfg, self.shared_attn, x, positions, cfg)
            elif fam == "audio":
                x = _remat(cfg, block, x, positions, enc, cfg)
            else:
                x = _remat(cfg, block, x, positions, cfg, prefix)
        return self._logits(self.final_ln(x))


def init_params(cfg: ModelConfig, generator: torch.Generator = None, *,
                seed: int = 0, device="cuda") -> Transformer:
    """A ``Transformer`` with random weights drawn from ``generator`` (or a
    new generator on ``device`` seeded with ``seed``), on its device.
    On ``meta`` the model has every parameter's shape and dtype and no
    storage (``common.param_generator``)."""
    if generator is None:
        generator = param_generator(device, seed)
    return Transformer(cfg, generator)


@torch.no_grad()
def forward(model: Transformer, cfg: ModelConfig, batch: Dict[str, Any]):
    """batch: ``{"tokens": (B, S)}`` [+ ``"patches"`` (B, P, d_frontend)
    for the VLM, ``"frames"`` (B, S_src, d_frontend) for the
    encoder-decoder].  Returns logits (B, P + S, V): this rank's
    vocabulary block of them on a sharded model whose head is vocabulary
    parallel (``gather_logits``)."""
    return model(batch["tokens"], cfg, batch.get("patches"),
                 batch.get("frames"))


def loss_fn(model: Transformer, cfg: ModelConfig, batch: Dict[str, Any]):
    """The mean next-token cross-entropy of ``forward``'s logits against
    ``batch["labels"]`` (B, S), the reference's ``loss_fn``: logits in f32,
    the VLM's image prefix dropped, ``logsumexp`` minus the gold logit at
    the labels ``>= 0``.  The gold logit is gathered where the reference
    contracts a one-hot: the same value, without a (B, S, V) one-hot.
    Differentiable; returns a 0-d f32 tensor."""
    total, count = nll_sum(model, cfg, batch)
    return total / torch.clamp(count, min=1.0)


def nll_sum(model: Transformer, cfg: ModelConfig, batch: Dict[str, Any]):
    """(the summed cross-entropy over the labels ``>= 0``, their count as
    an f32 tensor): ``loss_fn``'s numerator and denominator.  Vocabulary
    parallel under ``model.tp``."""
    logits = model(batch["tokens"], cfg, batch.get("patches"),
                   batch.get("frames")).float()
    labels = batch["labels"]
    if cfg.family == "vlm":          # the image prefix produces no loss
        logits = logits[:, cfg.img_tokens:]
    gold_at = labels.clamp(min=0).long()
    tp = model.tp
    if not model.vocab_parallel:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, gold_at[..., None])[..., 0]
    else:
        m = parallel.all_reduce(logits.detach().amax(dim=-1), tp, op="max")
        sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
        lse = m + torch.log(parallel.reduce_from(sumexp, tp))
        rows = logits.shape[-1]
        local = gold_at - model.vocab_start()
        held = (local >= 0) & (local < rows)
        gold = torch.gather(logits, -1,
                            local.clamp(0, rows - 1)[..., None])[..., 0]
        gold = parallel.reduce_from(gold * held.float(), tp)
    mask = (labels >= 0).float()
    return torch.sum((lse - gold) * mask), mask.sum()


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


def gather_logits(model: Transformer, logits):
    """Whole logits from a rank's vocabulary block of them (the identity
    unless the model's head is vocabulary parallel).  Collective."""
    if not model.vocab_parallel:
        return logits
    return parallel.all_gather_cat(logits, model.tp, -1)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _whole_rows_spec(path, shape, dp: int, sizes) -> tuple:
    """A cache tensor's spec for rows that the data axes do not split
    (fewer rows than data ranks, or a number they do not divide, as batch
    1 at ``long_500k``): the layout its layer decodes, each data rank
    holding every row.  The model axis lies where the reference's rule
    puts it for rows that the data axes split (fitted to a per-layer shape
    of ``dp`` rows), the data axes on no dim."""
    n = {"mlstm": 2}.get(path[0], 1)
    rule = SP.cache_rule(path, len(shape))[n:]
    m = axis_dim(fit_spec(rule, (dp,) + tuple(shape[n + 1:]), sizes),
                 "model")
    return tuple("model" if m is not None and i == n + m else None
                 for i in range(len(shape)))


def _record_cache_layout(model: Transformer, shapes) -> dict:
    """Fit the reference's cache specs to the whole cache's ``shapes`` on
    the model's mesh (``_whole_rows_spec`` where the data axes do not
    split its rows), record them as ``model.cache_layout`` and return
    them; a mesh axis on a stacked layer axis raises."""
    lay = model.shard_layout
    if lay is None:
        raise ValueError("shard the model first (train_step.shard_model)")
    lead = {"mlstm": 2}
    dp = lay.axes["dp"].size
    rows = []
    SP.cache_map(lambda path, t: rows.append(
        t.shape[lead.get(path[0], 1)]), shapes)
    if dp > 1 and rows[0] % dp:
        sizes = mesh_sizes(lay.mesh)
        specs = SP.cache_map(lambda path, t: _whole_rows_spec(
            path, tuple(t.shape), dp, sizes), shapes)
    else:
        specs = SP.cache_layout(shapes, lay.mesh)

    def check(path, spec):
        n = lead.get(path[0], 1)
        if any(e is not None for e in spec[:n]):
            raise NotImplementedError(f"cache {'.'.join(path)}: the "
                                      f"reference shards its stacked layer "
                                      f"axis on this mesh ({spec})")
        return spec
    SP.cache_map(check, specs)
    model.cache_layout = {"specs": specs, "shapes": SP.cache_map(
        lambda _, t: tuple(t.shape), shapes)}
    return specs


def shard_cache(model: Transformer, cache):
    """This rank's slices (copies) of a whole cache from ``init_cache``,
    placed as the reference's ``cache_specs`` under ``fit_spec`` place them
    on the model's mesh (rows that the data axes do not split are held
    whole on each data rank: ``_whole_rows_spec``); records the layout as
    ``model.cache_layout`` for ``decode_step`` (one sharded cache layout a
    model at a time)."""
    specs = _record_cache_layout(model, cache)
    axes = model.shard_layout.axes
    return SP.cache_map(lambda path, t: SP.cache_slice(
        t, _leaf(specs, path), axes).clone(), cache)


def init_sharded_cache(model: Transformer, cfg: ModelConfig, batch: int,
                       max_len: int, device="cuda"):
    """``shard_cache(model, init_cache(cfg, batch, max_len))`` without the
    whole cache: this rank's slices made directly, ``batch`` and
    ``max_len`` the whole cache's."""
    whole = init_cache(cfg, batch, max_len, device="meta")
    specs = _record_cache_layout(model, whole)
    axes = model.shard_layout.axes

    def one(path, t):
        shape = SP.cache_slice(t, _leaf(specs, path), axes).shape
        fill = XL.NEG if path[-1] == "m" else 0.0
        return torch.full(shape, fill, dtype=t.dtype, device=device)
    return SP.cache_map(one, whole)


def _places(model: Transformer, cache):
    """Each cache group's ``{name: (model dim, data dim, whole shape)}`` of
    its per-layer tensors, for a sharded model's cache (None unsharded);
    raises unless the cache's shapes are the rank's slices of the recorded
    layout."""
    if model.shard_layout is None:
        return None
    rec = model.cache_layout
    if rec is None:
        raise ValueError("a sharded model decodes a sharded cache: make it "
                         "with shard_cache or init_sharded_cache")
    axes = model.shard_layout.axes
    lead = {"mlstm": 2}
    out = {}
    for group, leaves in cache.items():
        if leaves is None:
            continue
        out[group] = {}
        n = lead.get(group, 1)
        for name, t in leaves.items():
            spec = rec["specs"][group][name]
            whole = rec["shapes"][group][name]
            want = SP.slice_shape(whole, spec, axes)
            if tuple(t.shape) != tuple(want):
                raise ValueError(
                    f"cache {group}.{name} of shape {tuple(t.shape)} is not "
                    f"this rank's slice {tuple(want)} of the recorded layout "
                    f"(shard_cache / init_sharded_cache)")
            ddim = axis_dim(spec, "data")
            if ddim is None:
                ddim = axis_dim(spec, "pod")
            mdim = axis_dim(spec, "model")
            out[group][name] = (None if mdim is None else mdim - n,
                                None if ddim is None else ddim - n,
                                tuple(whole[n:]))
    return out


def _at(stacked, *idx):
    """One layer's cache: each tensor indexed at ``idx`` (views, so an
    in-place update lands in the stack)."""
    return {name: t[idx] for name, t in stacked.items()}


@torch.no_grad()
def decode_step(model: Transformer, cfg: ModelConfig, token, cache, pos,
                encoder_out=None):
    """One decode step.  token: (B,) int; pos: (B,) absolute position;
    ``encoder_out`` (B, S_src, D): the encoder-decoder's ``encode`` output.
    Returns (logits (B, V), cache); the cache is updated in place.  On a
    sharded model, the rank's rows of token, pos and encoder_out (the
    reference's ``P(DP)``: all of them where the data axes do not split
    the batch) and its slices of the cache (``shard_cache``); the logits
    are whole."""
    _check_family(cfg)
    fam = cfg.family
    if fam == "audio" and encoder_out is None:
        raise ValueError("the encoder-decoder's decode_step needs "
                         "encoder_out (Transformer.encode)")
    places = _places(model, cache)
    at = (lambda g: None) if places is None else places.get
    x = model._embed(token, cfg)[:, None, :]
    kd = n_dense_layers(cfg)
    ai = 0
    for i, block in enumerate(model.blocks):
        if fam == "ssm":
            r = cfg.xlstm.slstm_every
            g = "slstm" if i % r == r - 1 else "mlstm"
            c = (_at(cache[g], i // r) if g == "slstm"
                 else _at(cache[g], i // r, i % r))
            x, _ = block.decode(x, c, cfg, at(g))
        elif fam == "hybrid":
            x, _ = block.decode(x, _at(cache["ssm"], i), cfg, at("ssm"))
            if model._shared(i, cfg):
                x, _ = model.shared_attn.decode(x, _at(cache["attn"], ai),
                                                pos, cfg, at("attn"))
                ai += 1
        elif fam == "audio":
            x, _ = block.decode(x, _at(cache["self"], i), pos, encoder_out,
                                cfg, at("self"))
        else:
            g = "dense" if i < kd else "moe"
            x, _ = block.decode(x, _at(cache[g], i if i < kd else i - kd),
                                pos, cfg, at(g))
    logits = model._logits(model.final_ln(x))[:, 0]
    return gather_logits(model, logits), cache
