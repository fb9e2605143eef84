"""AdamW with global-norm clipping and a warmup-cosine schedule (the
reference's ``repro/optim/adamw.py``, without optax there and without
``torch.optim`` here).

``torch.optim.AdamW`` is not this arithmetic: it decays the weights before
the moment step and adds eps after its own bias correction.  This one
follows the reference's order, on f32 tensors: the clip scale
``min(1, grad_clip / sqrt(sum g^2 + 1e-12))``, the moments, their bias
corrections, ``delta = mhat / (sqrt(vhat) + eps) + weight_decay * p`` and
``p - lr * delta``.  Parameters are f32 masters (the layers cast them to
the activation dtype at use); moments are f32.

Sharded (``update_sharded``): each rank holds its tensor-parallel shard of
a parameter and of its gradient (already reduced over the data-parallel
ranks), and, under ZeRO-1, only its slice of the moments along the dim
that ``zero1_specs`` gives the data axis.  The global norm is the full
gradient's: squares of the model-sharded gradients are summed over the
model axis, those of replicated ones counted once.  Each rank updates its
slice and the slices are all-gathered over the data axis.  The arithmetic
is elementwise, so the parameters come out bit for bit as an unsharded
update of the same gradients leaves them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import parallel


class OptState(NamedTuple):
    """``step``: a 0-d int32 tensor (updates taken); ``m``, ``v``: f32
    moments by parameter name."""
    step: torch.Tensor
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        """Zero f32 moments beside each parameter, on its device."""
        dev = next(iter(params.values())).device
        zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for n, p in params.items()}
        return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                        zeros(), zeros())

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``step`` (a tensor), in f32 as the
        reference computes it: linear warmup to ``lr``, then a cosine to
        ``min_lr_frac * lr`` at ``total_steps``."""
        step = step.float()
        warm = torch.clamp(step / max(self.warmup, 1), max=1.0)
        t = torch.clamp((step - self.warmup)
                        / max(self.total_steps - self.warmup, 1), 0.0, 1.0)
        cos = self.min_lr_frac + (1 - self.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return self.lr * warm * cos

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: OptState,
               params: Dict[str, torch.Tensor]):
        """One step.  ``grads`` and ``params`` by name (a gradient may be
        None: a parameter the loss did not reach, a zero gradient).  The
        parameters and the moments are written in place (the reference
        donates them); returns (params, ``OptState(step + 1, m, v)``,
        ``{"lr", "grad_norm"}``), as the reference returns its new
        trees."""
        step = state.step + 1
        lr = self.schedule(step)
        step_f = step.float()
        sq = [torch.sum(torch.square(g.float())) for g in grads.values()
              if g is not None]
        gnorm = torch.sqrt(sum(sq) + 1e-12)
        scale = torch.clamp(self.grad_clip / gnorm, max=1.0)
        bc1 = 1 - self.b1 ** step_f
        bc2 = 1 - self.b2 ** step_f
        for name, p in params.items():
            g = grads.get(name)
            g = (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 if g is None else g.float()) * scale
            m, v = state.m[name], state.v[name]
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * torch.square(g))
            del g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + \
                self.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
        return params, OptState(step, state.m, state.v), \
            {"lr": lr, "grad_norm": gnorm}

    @torch.no_grad()
    def update_sharded(self, grads: Dict[str, torch.Tensor], state: OptState,
                       params: Dict[str, torch.Tensor],
                       shards: Dict[str, "ShardedParam"], model_axis,
                       data_axis):
        """One step on a rank of a sharded model: ``params`` and ``grads``
        are the rank's shards (gradients summed over the data-parallel
        ranks), ``state.m`` / ``.v`` the moments as ``shards`` slice them
        (the local shard's slice ``data_axis.index`` of ``data_axis.size``
        along ``zero_dim``).  Written in place; returns what ``update``
        returns."""
        step = state.step + 1
        lr = self.schedule(step)
        step_f = step.float()
        dev = state.step.device
        split = torch.zeros(2, dtype=torch.float32, device=dev)
        for name, g in grads.items():
            if g is not None:
                split[0 if shards[name].model_sharded else 1] += \
                    torch.sum(torch.square(g.float()))
        parallel.all_reduce(split[:1], model_axis)
        gnorm = torch.sqrt(split[0] + split[1] + 1e-12)
        scale = torch.clamp(self.grad_clip / gnorm, max=1.0)
        bc1 = 1 - self.b1 ** step_f
        bc2 = 1 - self.b2 ** step_f
        for name, p in params.items():
            zd, gd = shards[name].zero_dim, shards[name].gather_dim
            g = grads.get(name)
            g = (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 if g is None else g.float()) * scale
            mine = whole = p
            if gd is not None:
                g = parallel.all_gather_cat(g, model_axis, gd)
                mine = whole = parallel.all_gather_cat(p, model_axis, gd)
            if zd is not None:
                g = parallel.local_slice(g, data_axis, zd)
                mine = parallel.local_slice(whole, data_axis, zd)
            m, v = state.m[name], state.v[name]
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * torch.square(g))
            del g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + \
                self.weight_decay * mine.float()
            new = (mine.float() - lr * delta).to(p.dtype)
            if zd is not None:
                new = parallel.all_gather_cat(new, data_axis, zd)
            if gd is not None:
                new = parallel.local_slice(new, model_axis, gd)
            p.copy_(new)
        return params, OptState(step, state.m, state.v), \
            {"lr": lr, "grad_norm": gnorm}


def zero1_spec(shape: Sequence[int], spec: Tuple, data_axis: str = "data",
               min_size: int = 1) -> Tuple:
    """One moment's spec: ``data_axis`` on the first free dim of size at
    least ``min_size``, dims 1.. first (the stacked layer dim 0 last)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for idx in list(range(1, len(shape))) + [0]:
        if entries[idx] is None and shape[idx] >= min_size:
            entries[idx] = data_axis
            break
    return tuple(entries)


def zero1_specs(shapes: Dict[str, Sequence[int]], param_specs: Dict[str, Tuple],
                data_axis: str = "data", min_size: int = 1
                ) -> Dict[str, Tuple]:
    """Moment specs by name (the reference's ``zero1_specs``): the data
    axis added on the first free divisible dim, skipping the scan-stacked
    layer dim when a later dim can take it."""
    return {n: zero1_spec(shapes[n], param_specs[n], data_axis, min_size)
            for n in param_specs}


@dataclasses.dataclass(frozen=True)
class ShardedParam:
    """How one parameter is split on a rank: ``model_sharded`` (its shard
    is a slice over the model axis, so its squares are summed over it),
    ``zero_dim`` (the dim of the local shard that the ZeRO-1 moments slice
    over the data axis, None for whole moments) and ``gather_dim`` (the
    parameter's model dim where its moments are whole over the model axis:
    the shard and its gradient are then all-gathered along it for the
    update, and the rank keeps its slice of the result)."""
    model_sharded: bool
    zero_dim: Optional[int]
    gather_dim: Optional[int] = None
