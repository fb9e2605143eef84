"""AdamW with global-norm clipping and a warmup-cosine schedule (the
reference's ``repro/optim/adamw.py``, without optax there and without
``torch.optim`` here).

``torch.optim.AdamW`` is not this arithmetic: it decays the weights before
the moment step and adds eps after its own bias correction.  This one
follows the reference's order, on f32 tensors: the clip scale
``min(1, grad_clip / sqrt(sum g^2 + 1e-12))``, the moments, their bias
corrections, ``delta = mhat / (sqrt(vhat) + eps) + weight_decay * p`` and
``p - lr * delta``.  Parameters are f32 masters (the layers cast them to
the activation dtype at use); moments are f32.  The reference's
``zero1_specs`` (moments sharded over a data axis) has no counterpart on
one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

import torch


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
