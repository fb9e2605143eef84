"""Shared model numerics: norms, RoPE and the initializer.

The reference's sharding helpers, ``pscan`` and remat have no counterpart:
the port runs inference on one device, layer by layer.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


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


def dense_init(generator: torch.Generator, shape: Sequence[int],
               dtype=torch.float32, scale: Optional[float] = None):
    """Normal(0, scale / sqrt(fan_in)) on the generator's device, where
    fan_in is the second-to-last dim (the last for a vector)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = (scale if scale is not None else 1.0) / np.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * std).to(dtype)
