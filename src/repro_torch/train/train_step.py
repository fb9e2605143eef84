"""The generic train step (the reference's ``repro/train/train_step.py``):
loss, backward through the model, microbatch accumulation, AdamW.

``TrainState`` = the model (f32 master parameters, gradients on) + the
AdamW state.  A step updates the state in place, where the reference
donates it to its jit.  With ``microbatches = k`` the batch is split along
dim 0 into k parts; losses and gradients are summed over the parts, then
divided by k, which keeps activation memory at 1/k.  The reference's
``state_specs``, ``batch_specs`` and ``jit_train_step`` (GSPMD shardings
and donation) have no counterpart on one card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW, OptState


class TrainState(NamedTuple):
    model: T.Transformer
    opt: OptState


def init_state(cfg: ModelConfig, optimizer: AdamW,
               generator: torch.Generator = None, *, seed: int = 0,
               device="cuda") -> TrainState:
    """A model drawn from ``generator`` (or a new generator on ``device``
    seeded with ``seed``), with gradients turned on, and zero moments."""
    model = T.init_params(cfg, generator, seed=seed, device=device)
    model.requires_grad_(True)
    return TrainState(model, optimizer.init(dict(model.named_parameters())))


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *,
                    microbatches: int = 1, aux_weight: float = 0.0):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with
    metrics ``loss``, ``lr`` and ``grad_norm`` (0-d tensors on the
    device; reading one synchronises).  The reference accepts
    ``aux_weight`` and adds no auxiliary loss whatever its value; here
    only 0 is accepted, so that asking for one is an error, not a no-op
    (``layers.moe_aux_loss`` is not added to the loss)."""
    if aux_weight:
        raise ValueError(f"aux_weight={aux_weight!r}: the train step adds "
                         f"no auxiliary loss (as the reference's)")

    def train_step(state: TrainState, batch):
        model = state.model
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if microbatches == 1:
            loss = T.loss_fn(model, cfg, batch)
            loss.backward()
            loss = loss.detach()
        else:
            # .backward() accumulates: the first part's gradient, then
            # += each next one, the reference's sum from zeros
            for k, x in batch.items():
                if x.shape[0] % microbatches:
                    raise ValueError(f"batch {k!r} of {x.shape[0]} rows does "
                                     f"not split into {microbatches} "
                                     f"microbatches")
            parts = {k: torch.chunk(x, microbatches) for k, x in
                     batch.items()}
            loss = 0.0
            for i in range(microbatches):
                li = T.loss_fn(model, cfg, {k: x[i] for k, x in
                                            parts.items()})
                li.backward()
                loss = loss + li.detach()
            loss = loss / microbatches
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(microbatches)
        grads = {n: p.grad for n, p in params.items()}
        _, opt, om = optimizer.update(grads, state.opt, params)
        for p in params.values():
            p.grad = None
        return TrainState(model, opt), {"loss": loss, **om}

    return train_step
