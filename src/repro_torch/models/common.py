"""Shared model numerics (norms, RoPE, the initializer) and the
reference's parameter shardings.

The shardings are the reference's rules, copied: ``_RULES`` and
``spec_for`` give a parameter's spec from its reference path,
``filter_pspec`` drops the axes a mesh lacks and ``fit_spec`` moves an
entry that does not divide its dim, as the reference decides legality at
its jit boundary.  A spec is a tuple with one entry per dim: None, a mesh
axis name or a tuple of names.  ``placements`` turns one into the
``Shard(dim)`` / ``Replicate()`` of each mesh axis.  Which port parameter
has which reference path is ``repro_torch.convert.reference_paths``; the
per-parameter layout of a sharded model is
``repro_torch.train.train_step.state_specs``.  The reference's ``shard``
constraints and ``pscan`` have no counterpart: layers run one after
another and call their collectives themselves (``repro_torch.parallel``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

DP = ("pod", "data")     # data-parallel axes (logical); absent axes dropped
TP = "model"             # tensor/expert-parallel axis


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding. x: (..., S, D) with D even; positions: (..., S).
    Angles and the rotation are computed in f32, then cast back."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs        # (..., S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Draws:
    """A generator and the device its draws land on, where that is not the
    generator's own: a CPU generator drawing onto ``meta`` (PyTorch makes
    no generator there).  The model's constructors take one wherever they
    take a generator and put their parameters on its ``device``."""

    def __init__(self, generator: torch.Generator, device):
        self.generator = generator
        self.device = torch.device(device)


def param_generator(device, seed: int = 0):
    """A generator seeded with ``seed`` whose draws land on ``device``: a
    ``torch.Generator`` there, or on ``meta`` a CPU one in ``Draws``."""
    if torch.device(device).type == "meta":
        return Draws(torch.Generator().manual_seed(seed), "meta")
    return torch.Generator(device=device).manual_seed(seed)


def dense_init(generator, shape: Sequence[int], dtype=torch.float32,
               scale: Optional[float] = None):
    """Normal(0, scale / sqrt(fan_in)) on the generator's device (a
    ``torch.Generator`` or ``Draws``), where fan_in is the second-to-last
    dim (the last for a vector)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = (scale if scale is not None else 1.0) / np.sqrt(fan_in)
    source = generator.generator if isinstance(generator, Draws) \
        else generator
    w = torch.randn(tuple(shape), generator=source, dtype=torch.float32,
                    device=generator.device)
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# parameter shardings by path convention (the reference's rules)
# ---------------------------------------------------------------------------

_RULES = (
    # (substring, ndim -> spec entries applied to the TRAILING dims)
    ("embed",   {2: (TP, None)}),                    # (V, D) vocab on TP
    ("lm_head", {2: (None, TP)}),                    # (D, V)
    ("patch_proj", {2: (None, None)}),
    ("wq",      {2: (None, TP)}),
    ("wk_rep",  {2: (None, None)}),
    ("wv_rep",  {2: (None, None)}),
    ("wkv_a",   {2: (None, None)}),
    ("wk_rope", {2: (None, None)}),
    ("wk",      {2: (None, TP)}),
    ("wv",      {2: (None, TP)}),
    ("wkv",     {2: (None, TP)}),
    ("wo",      {2: (TP, None)}),
    ("w_gate",  {2: (None, TP)}),
    ("w_up",    {2: (None, TP)}),
    ("w_down",  {2: (TP, None)}),
    ("experts", {3: (TP, None, None)}),              # (E, d, f) experts on TP
    ("router",  {2: (None, None)}),
    ("in_proj", {2: (None, TP)}),                    # ssm/xlstm big in-proj
    ("out_proj", {2: (TP, None)}),
    ("conv",    {2: (None, None), 3: (None, None, None)}),
)

STACKED_PREFIXES = ("layers", "blocks")


def spec_for(path: str, ndim: int, stacked: bool) -> Tuple:
    """A parameter's spec by name convention: the first rule whose
    substring is in ``path`` and which has an entry for the trailing
    ndim; ``stacked`` (a scan-stacked parameter) puts None on the leading
    layer dim."""
    trailing = ndim - (1 if stacked else 0)
    for needle, table in _RULES:
        if needle in path and trailing in table:
            entries = table[trailing]
            break
    else:
        entries = (None,) * trailing
    return ((None,) if stacked else ()) + tuple(entries)


def is_stacked(path: str, ndim: int) -> bool:
    """The reference's test for a scan-stacked parameter."""
    return any(s in path for s in STACKED_PREFIXES) and ndim >= 2


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or such a dict)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _norm_entry(e, sizes):
    if e is None:
        return None
    if isinstance(e, (tuple, list)):
        kept = tuple(a for a in e if a in sizes)
        return kept if kept else None
    return e if e in sizes else None


def filter_pspec(spec, mesh) -> Tuple:
    """Drop the axis names ``mesh`` does not have (pod vs single pod), and
    trailing Nones."""
    sizes = mesh_sizes(mesh)
    out = [_norm_entry(e, sizes) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def fit_spec(spec, shape: Sequence[int], mesh) -> Tuple:
    """Make a spec legal for a concrete (shape, mesh), as the reference
    does: axis names missing from the mesh are dropped; an entry whose
    mesh-axis product does not divide its dim is moved to the next free
    dim that divides (later dims first, then earlier ones), else dropped.
    One entry per dim."""
    sizes = mesh_sizes(mesh)

    def axsize(e):
        if isinstance(e, tuple):
            n = 1
            for a in e:
                n *= sizes[a]
            return n
        return sizes[e]

    entries = [_norm_entry(e, sizes) for e in tuple(spec)]
    entries += [None] * (len(shape) - len(entries))
    out = [None] * len(shape)
    for i, e in enumerate(entries):
        if e is None:
            continue
        n = axsize(e)
        if n <= 1:
            continue
        for j in [i] + list(range(i + 1, len(shape))) + \
                list(range(i - 1, -1, -1)):
            if out[j] is None and shape[j] % n == 0 and shape[j] >= n:
                out[j] = e
                break
    return tuple(out)


def make_param_specs(paths: Dict[str, Tuple[str, Tuple[int, ...]]]
                     ) -> Dict[str, Tuple]:
    """Specs by name for ``{name: (reference path, reference shape)}``
    (``convert.reference_paths``): the reference's ``make_param_specs``,
    on the reference's stacked shapes."""
    return {n: spec_for(path, len(shape), is_stacked(path, len(shape)))
            for n, (path, shape) in paths.items()}


def axis_dim(spec, axis: str) -> Optional[int]:
    """The dim whose entry holds mesh axis ``axis`` in a fitted spec, else
    None."""
    for d, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return d
    return None


def placements(spec, mesh_names: Sequence[str]):
    """The DTensor placement of each mesh axis in ``mesh_names`` order:
    ``Shard(dim)`` where the fitted ``spec`` puts the axis, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_names:
        d = axis_dim(spec, name)
        out.append(Replicate() if d is None else Shard(d))
    return tuple(out)
