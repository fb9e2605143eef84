"""Model input stand-ins: ``train_input_specs`` and ``decode_input_specs``,
one step's inputs for every (arch x shape) cell as tensors on ``meta`` (the
reference's ShapeDtypeStructs, for the dry run), and ``concrete_batch``, a
small real batch for smoke tests and examples, the reference's arrays bit
for bit as tensors on a device.

The decode caches' placements, the reference's ``_CACHE_RULES`` and
``cache_specs`` (``launch/dryrun.py``), are here: ``cache_layout`` fits
them to a cache on a mesh and ``cache_slice`` cuts a rank's slice of one
tensor (``transformer.shard_cache`` slices a whole cache and records the
layout on the model for ``decode_step``)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import parallel
from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.data.pipeline import _features, _on
from repro_torch.models.common import axis_dim, fit_spec, mesh_sizes


def train_input_specs(cfg: ModelConfig, shape: ShapeCfg,
                      device="meta") -> Dict[str, torch.Tensor]:
    """One train or prefill step's whole batch as zeros on ``device`` (no
    storage on ``meta``): int32 ``tokens`` and ``labels`` (B, S), the
    VLM's text cut to ``S - img_tokens`` beside its ``patches`` (B,
    img_tokens, d_frontend), the encoder-decoder's ``frames`` (B, S,
    d_frontend or D), features in the activation dtype."""
    b, s = shape.global_batch, shape.seq_len
    act = cfg.activation_dtype
    s_txt = s - cfg.img_tokens if cfg.family == "vlm" else s
    out = {k: torch.zeros((b, s_txt), dtype=torch.int32, device=device)
           for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        out["patches"] = torch.zeros((b, cfg.img_tokens, cfg.d_frontend),
                                     dtype=act, device=device)
    if cfg.family == "audio":
        out["frames"] = torch.zeros((b, s, cfg.d_frontend or cfg.d_model),
                                    dtype=act, device=device)
    return out


def decode_input_specs(cfg: ModelConfig, shape: ShapeCfg,
                       device="meta") -> Dict[str, object]:
    """One decode step's whole inputs on ``device``: int32 ``token`` and
    ``pos`` (B,), the ``cache`` of ``seq_len`` positions
    (``transformer.init_cache``) and the encoder-decoder's ``encoder_out``
    (B, S, D) in the activation dtype."""
    from repro_torch.models.transformer import init_cache
    b, s = shape.global_batch, shape.seq_len
    out = {"token": torch.zeros((b,), dtype=torch.int32, device=device),
           "pos": torch.zeros((b,), dtype=torch.int32, device=device),
           "cache": init_cache(cfg, b, s, device=device)}
    if cfg.family == "audio":
        out["encoder_out"] = torch.zeros((b, s, cfg.d_model),
                                         dtype=cfg.activation_dtype,
                                         device=device)
    return out


def concrete_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Uniform tokens (B, S) from ``default_rng(seed)``, labels the tokens
    rolled by one, plus the VLM's ``patches`` (the text cut by
    ``img_tokens``) or the encoder-decoder's ``frames``, normal draws times
    0.2 in the activation dtype."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    out = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    act = cfg.activation_dtype
    if cfg.family == "vlm":
        s_txt = seq - cfg.img_tokens
        out = {"tokens": tok[:, :s_txt], "labels": out["labels"][:, :s_txt]}
        out["patches"] = _features(rng.standard_normal(
            (batch, cfg.img_tokens, cfg.d_frontend)), act)
    if cfg.family == "audio":
        out["frames"] = _features(rng.standard_normal(
            (batch, seq, cfg.d_frontend or cfg.d_model)), act)
    return _on(out, device)


# ---------------------------------------------------------------------------
# decode cache placements (the reference's ``launch/dryrun.py``)
# ---------------------------------------------------------------------------

DP = ("pod", "data")

#: the reference's ``_CACHE_RULES``, by cache leaf name, on the trailing
#: dims: K/V heads over the model axis; the MLA latents context-parallel
#: (their sequence T over model); the SSM state's heads and the conv
#: history's channels; the mLSTM matrix memory's first head dim; the
#: sLSTM states' head dim.  ``"m"`` is written for the mLSTM's (B, nh), so
#: on the sLSTM's (B, nh, hd) it puts the data axes on the heads (a
#: reference fault the port keeps).
_CACHE_RULES = {
    "k": (DP, "model", None, None), "v": (DP, "model", None, None),
    "kv_c": (DP, "model", None), "k_rope": (DP, "model", None),
    "S": (DP, "model", None, None), "conv": (DP, None, "model"),
    "C": (DP, None, "model", None), "n": (DP, None, "model"),
    "m": (DP, None), "c": (DP, None, "model"), "h": (DP, None, "model"),
}


def cache_map(fn, cache, path=()):
    """``fn(path, leaf)`` over a cache's nested dicts (the path a tuple of
    keys), in a tree of the same structure; a None subtree stays None."""
    if cache is None:
        return None
    if isinstance(cache, dict):
        return {k: cache_map(fn, v, path + (k,)) for k, v in cache.items()}
    return fn(path, cache)


def cache_rule(path, ndim: int):
    """The spec of a cache tensor of ``ndim`` dims at ``path`` (its keys):
    the rule of the last key that has one, on the trailing dims, None in
    front; a leaf without a rule is ``(DP,)`` on its first trailing
    dim."""
    name = next((k for k in reversed(path) if k in _CACHE_RULES), None)
    base = _CACHE_RULES.get(name, (DP,))
    return (None,) * (ndim - len(base)) + tuple(base)


def cache_specs(cache):
    """The reference's ``cache_specs``: a tree of specs (tuples, one entry
    per dim) parallel to ``cache`` (``transformer.init_cache``'s nested
    dicts of tensors, any device, ``meta`` included), ``cache_rule``'s
    for each leaf."""
    return cache_map(lambda path, leaf: cache_rule(path, leaf.dim()), cache)


def cache_layout(cache, mesh):
    """Each leaf's spec fitted to its shape on ``mesh`` (a ``DeviceMesh``
    or ``{axis: size}``): ``fit_spec(cache_specs(cache))``, one entry per
    dim."""
    sizes = mesh_sizes(mesh)
    specs = cache_specs(cache)

    def one(path, leaf):
        spec = specs
        for k in path:
            spec = spec[k]
        return fit_spec(spec, tuple(leaf.shape), sizes)
    return cache_map(one, cache)


def _split_dims(spec):
    """``(axis, dim)`` of each mesh axis that splits a tensor under its
    fitted ``spec``: the data axes (``pod`` then ``data``) as the pair
    ``dp``, and ``model``."""
    d = axis_dim(spec, "data")
    if d is None:
        d = axis_dim(spec, "pod")
    m = axis_dim(spec, "model")
    return [(name, dim) for name, dim in (("dp", d), ("model", m))
            if dim is not None]


def slice_shape(shape, spec, axes) -> tuple:
    """The shape of ``cache_slice`` of a tensor of ``shape``, without
    one."""
    out = list(shape)
    for name, d in _split_dims(spec):
        out[d] //= axes[name].size
    return tuple(out)


def cache_slice(t: torch.Tensor, spec, axes) -> torch.Tensor:
    """This rank's slice of one whole cache tensor under its fitted
    ``spec`` (a view): each dim an axis splits cut to the rank's block
    along it (``axes``: ``parallel.mesh_axes``; the data axes, ``pod``
    then ``data``, as the pair ``dp``)."""
    for name, d in _split_dims(spec):
        t = parallel.local_slice(t, axes[name], d)
    return t

