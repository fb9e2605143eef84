"""Error-feedback int8 gradient compression for the data-parallel
all-reduce (the reference's ``repro/train/compression.py``).

The reference runs the reduction explicitly under ``shard_map``.
``allreduce_compressed_group`` is its counterpart on ranks: each rank
passes its own gradient dict and the reduction runs over a process group
(``repro_torch.parallel.Axis``), a ``MAX`` all-reduce for the scale (the
reference's ``pmax``), then an int32 ``SUM`` of the int8 payload (its
``psum``).  ``allreduce_compressed`` runs it over the shards of a
one-process mesh (``repro_torch.core.distributed``), one gradient dict per
shard, each on its shard's device:

  1. the max over shards of each shard's ``|grad + error|`` maximum gives
     one shared scale per tensor (the reference's ``pmax``);
  2. each shard quantizes ``grad + error`` to int8 with that scale;
  3. the int8 payloads are summed in int32 (the reference's ``psum``);
  4. the sum is dequantized and divided by the shard count; each shard
     keeps its own quantization residual as the next step's error.

Every shard uses the same scale, so the summed payload dequantizes exactly
to ``sum(q_i) * scale`` and ``sum(deq_i) + sum(err_i) = sum(g_i + e_i)``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch import parallel


def quantize_int8(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def allreduce_compressed(grads_per_shard: Sequence[Dict[str, torch.Tensor]],
                         error_per_shard: Sequence[Dict[str, torch.Tensor]]
                         ) -> Tuple[Dict[str, torch.Tensor],
                                    List[Dict[str, torch.Tensor]]]:
    """EF-int8 mean all-reduce of p shards' gradient dicts.  Returns (the
    f32 mean on shard 0's device, each shard's new f32 error on its
    device)."""
    p = len(grads_per_shard)
    if p == 0 or len(error_per_shard) != p:
        raise ValueError(f"{p} gradient shards against "
                         f"{len(error_per_shard)} error shards")
    dev0 = next(iter(grads_per_shard[0].values())).device
    mean: Dict[str, torch.Tensor] = {}
    errors: List[Dict[str, torch.Tensor]] = [{} for _ in range(p)]
    for name in grads_per_shard[0]:
        xs = [g[name].float() + e[name]
              for g, e in zip(grads_per_shard, error_per_shard)]
        amax = torch.stack([torch.max(torch.abs(x)).to(dev0) for x in xs])
        scale = torch.clamp(torch.max(amax), min=1e-12) / 127.0
        tot = None
        for i, x in enumerate(xs):
            s = scale.to(x.device)
            q = quantize_int8(x, s)
            errors[i][name] = x - q.float() * s
            q32 = q.to(device=dev0, dtype=torch.int32)
            tot = q32 if tot is None else tot + q32
        mean[name] = tot.float() * scale / p
    return mean, errors


def allreduce_compressed_group(grads: Dict[str, torch.Tensor],
                               error: Dict[str, torch.Tensor],
                               axis: "parallel.Axis"
                               ) -> Tuple[Dict[str, torch.Tensor],
                                          Dict[str, torch.Tensor]]:
    """EF-int8 mean all-reduce of this rank's gradient dict over ``axis``
    (collective: every rank of the axis calls it with the same names and
    shapes).  Returns (the f32 mean, this rank's new f32 error)."""
    mean: Dict[str, torch.Tensor] = {}
    new_error: Dict[str, torch.Tensor] = {}
    for name, g in grads.items():
        x = g.float() + error[name]
        amax = parallel.all_reduce(torch.max(torch.abs(x)).reshape(1), axis,
                                   op="max")[0]
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = quantize_int8(x, scale)
        new_error[name] = x - q.float() * scale
        tot = parallel.all_reduce(q.to(torch.int32), axis)
        mean[name] = tot.float() * scale / axis.size
    return mean, new_error


def init_error(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero f32 errors beside each parameter."""
    return {n: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for n, x in params.items()}
