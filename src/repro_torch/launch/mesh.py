"""The elastic mesh's arithmetic (the reference's ``make_elastic_mesh``).

The reference's ``make_production_mesh`` (a 16 x 16 or 2 x 16 x 16 TPU
pod) has no counterpart: sharded training waits for a multi-GPU host.
"""
from __future__ import annotations

from typing import Dict


def make_elastic_mesh(n_devices: int, *,
                      model_parallel: int = 16) -> Dict[str, int]:
    """The largest (data, model) mesh shape for a degraded device set (an
    elastic restart after failures): keep TP, halving it until it divides
    ``n_devices``, and DP = n_devices / TP.  Returns ``{"data": dp,
    "model": tp}``, as the reference's mesh's ``shape`` reads."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got "
                         f"{n_devices}")
    tp = model_parallel
    while tp > 1 and n_devices % tp:
        tp //= 2
    return {"data": n_devices // tp, "model": tp}
