"""The generic train step (the reference's ``repro/train/train_step.py``):
loss, backward through the model, microbatch accumulation, AdamW.

``TrainState`` = the model (f32 master parameters, gradients on) + the
AdamW state.  A step updates the state in place, where the reference
donates it to its jit.  With ``microbatches = k`` the batch is split along
dim 0 into k parts; losses and gradients are summed over the parts, then
divided by k, which keeps activation memory at 1/k.

Sharded training (the reference's ``state_specs``, ``batch_specs`` and
``jit_train_step``): one process per rank of a ``DeviceMesh``
(``repro_torch.launch.mesh``).  ``state_specs`` gives each parameter the
reference's sharding (``convert.reference_paths`` -> ``_RULES`` ->
``fit_spec``, the stacked layer dims dropped) and its moments'
(``zero1_specs``); ``shard_state`` slices a whole ``TrainState`` onto the
mesh, so a sharded model's tensors are the single-device model's slices;
``sharded_train_step`` is the step: the rank's rows of the batch
(``batch_specs``: rows over ``("pod", "data")``), the tensor-parallel
forward and backward (every family: ``_check_tensor_parallel`` refuses
only a model axis that would leave a rank no attention head, or split an
MLA or SSM head), the gradients summed over the data-parallel ranks
(or ``compress=True``: the int8 error-feedback reduction), AdamW on the
ZeRO-1 slices and an all-gather of the parameters over ``data``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import parallel
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import reference_paths
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models import transformer as T
from repro_torch.models.common import (axis_dim, fit_spec, make_param_specs,
                                       mesh_sizes)
from repro_torch.optim.adamw import AdamW, OptState, ShardedParam, zero1_specs


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


# ---------------------------------------------------------------------------
# sharded training
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """One parameter on a mesh: its whole (per-layer) ``shape``, its fitted
    ``spec`` and its moments' ``moment_spec`` (one entry per dim, the
    reference's stacked layer dims dropped)."""
    shape: Tuple[int, ...]
    spec: Tuple
    moment_spec: Tuple

    @property
    def model_dim(self) -> Optional[int]:
        return axis_dim(self.spec, "model")

    @property
    def zero_dim(self) -> Optional[int]:
        return axis_dim(self.moment_spec, "data")

    @property
    def moment_model_dim(self) -> Optional[int]:
        """The moments' model dim: the parameter's, or None where
        ``fit_spec`` moved the parameter's model axis to a dim that the
        moments' data axis holds (the moments are then whole over the model
        axis: internvl2's ``lm_head``)."""
        return axis_dim(self.moment_spec, "model")


@dataclasses.dataclass
class ShardLayout:
    """A sharded model's ``mesh``, its resolved ``axes``
    (``parallel.mesh_axes``), each parameter's ``ParamLayout`` and whether
    the moments are ZeRO-1 slices."""
    mesh: object
    axes: Dict[str, parallel.Axis]
    params: Dict[str, ParamLayout]
    zero1: bool


def state_specs(model: T.Transformer, mesh, *, zero1: bool = True
                ) -> Dict[str, ParamLayout]:
    """Each parameter's layout on ``mesh`` (a ``DeviceMesh`` or ``{axis:
    size}``) for a whole model: the reference's ``fit_spec`` of its
    ``make_param_specs`` and (``zero1``) ``zero1_specs``, computed on the
    reference's stacked shapes.  A mesh axis that lands on a stacked layer
    dim, or moments whose model axis sits on another dim than the
    parameter's, raise ``NotImplementedError`` (the port keeps layers
    apart); moments whole over the model axis are taken."""
    if model.shard_layout is not None:
        raise ValueError("state_specs takes the whole model; this one is "
                         "already sharded (see model.shard_layout)")
    sizes = mesh_sizes(mesh)
    paths = reference_paths(model)
    pspecs = make_param_specs(paths)
    shapes = {n: shape for n, (_, shape) in paths.items()}
    mspecs = zero1_specs(shapes, pspecs) if zero1 else pspecs
    params = dict(model.named_parameters())
    layouts = {}
    for name, (path, full) in paths.items():
        lead = len(full) - params[name].dim()
        fp = fit_spec(pspecs[name], full, sizes)
        fm = fit_spec(mspecs[name], full, sizes)
        if any(e is not None for e in fp[:lead] + fm[:lead]):
            raise NotImplementedError(
                f"{name} ({path}): the reference shards its stacked layer "
                f"axis on this mesh ({fp}, moments {fm})")
        lay = ParamLayout(tuple(full[lead:]), fp[lead:], fm[lead:])
        if lay.moment_model_dim not in (None, lay.model_dim):
            raise NotImplementedError(
                f"{name}: the moments' model axis ({fm}) is not the "
                f"parameter's ({fp})")
        layouts[name] = lay
    return layouts


def batch_specs(batch: Dict[str, torch.Tensor]) -> Dict[str, Tuple]:
    """Each batch entry's spec: rows over ``("pod", "data")``."""
    return {k: (("pod", "data"),) + (None,) * (x.dim() - 1)
            for k, x in batch.items()}


#: the dim the model axis must split, by module type and parameter name,
#: for the tensor-parallel layers (absent: whole on every rank; "kv":
#: columns or whole; "experts": the expert dim under expert parallelism;
#: "any": wherever ``fit_spec`` put it, the layer reads each placement;
#: "rows": rows or whole)
_TP_DIMS = {
    T.Transformer: {"embed": "any", "lm_head": "any"},
    L.Attention: {"wq": 1, "wk": "kv", "wv": "kv", "wo": 0},
    L.MLA: {"wq": 1, "wk_b": 1, "wv_b": 1, "wo": 0},
    L.MLP: {"w_gate": 1, "w_up": 1, "w_down": 0},
    L.MoE: {"experts_gate": "experts", "experts_up": "experts",
            "experts_down": "experts"},
    SSM.SSM: {"in_proj": 1, "out_proj": 0},
    XL.mLSTM: {},
    XL.sLSTM: {"out_proj": "rows"},
}


def _check_tensor_parallel(model: T.Transformer, cfg: ModelConfig,
                           layouts: Dict[str, ParamLayout], tp: int) -> None:
    """Raise ``NotImplementedError``, naming the layer, unless every layer
    can run its shards as the layouts place them on a model axis of
    ``tp``: attention by whole q heads, rank i the i-th block of
    ``layers.balanced_sizes(Hq, tp)`` and the K/V heads it reads (where
    Hq does not divide the axis, the first Hq mod tp ranks run one head
    more, on their heads' columns regrouped from the shards; a rank whose
    heads straddle a K/V group reads its K/V heads once per q head), so
    only an axis longer than Hq, which would leave a rank no head, is
    refused; MLA by equal blocks of whole heads; the SSM by whole heads with
    ``in_proj``'s columns and ``out_proj``'s rows split."""
    mods = [m for _, m in model.named_modules()]
    if any(isinstance(m, L.Attention) for m in mods) and cfg.n_heads < tp:
        raise NotImplementedError(
            f"attention: {cfg.n_heads} q heads do not split over a model "
            f"axis of {tp}: a rank would run no head")
    if any(isinstance(m, L.MLA) for m in mods) and cfg.n_heads % tp:
        raise NotImplementedError(f"MLA: {cfg.n_heads} heads do not split "
                                  f"over a model axis of {tp}")
    if any(isinstance(m, SSM.SSM) for m in mods):
        nh = SSM._dims(cfg)[2]
        if nh % tp:
            raise NotImplementedError(f"SSM: {nh} heads do not split over a "
                                      f"model axis of {tp}")
    ep = (cfg.moe is not None and cfg.moe.ep
          and cfg.moe.n_experts % tp == 0)
    for mname, module in model.named_modules():
        want = next((w for k, w in _TP_DIMS.items()
                     if isinstance(module, k)), {})
        for pname, _ in module.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            got = layouts[full].model_dim
            need = want.get(pname)
            if need == "kv":
                ok = got in (None, 1)
            elif need == "rows":
                ok = got in (None, 0)
            elif need == "experts":
                ok = got == 0 if ep else True
            elif need == "any":
                ok = True
            else:
                ok = got == need
            if not ok:
                raise NotImplementedError(
                    f"{full}: the model axis on dim {got} "
                    f"({layouts[full].spec}); the sharded "
                    f"{type(module).__name__} takes it on dim {need}")


def shard_model(model: T.Transformer, mesh, *, zero1: bool = True
                ) -> T.Transformer:
    """Replace ``model``'s parameters, in place, by this rank's shards on
    ``mesh`` (the slices of the whole ones that ``state_specs`` gives the
    model axis), set the layers' ``tp`` / ``tp_dims`` when the model axis
    is larger than 1, and record the layout as ``model.shard_layout``.
    Collective (``mesh_axes``).  A configuration the sharded layers do not
    run raises before anything changes."""
    layouts = state_specs(model, mesh, zero1=zero1)
    axes = parallel.mesh_axes(mesh)
    tp = axes["model"]
    if tp.size > 1:
        _check_tensor_parallel(model, model.cfg, layouts, tp.size)
    with torch.no_grad():
        for name, p in model.named_parameters():
            d = layouts[name].model_dim
            if d is not None:
                p.data = parallel.local_slice(p.data, tp, d).clone()
    for mname, module in model.named_modules():
        if isinstance(module, XL.sLSTM):
            module.dp = axes["dp"]
        if tp.size > 1 and isinstance(module, tuple(_TP_DIMS)):
            module.tp = tp
            module.tp_dims = {
                pname: layouts[f"{mname}.{pname}" if mname
                               else pname].model_dim
                for pname, _ in module.named_parameters(recurse=False)}
    model.shard_layout = ShardLayout(mesh, axes, layouts, zero1)
    return model


def shard_tensor(full: torch.Tensor, lay: ParamLayout, axes, *,
                 moment: bool, zero1: bool) -> torch.Tensor:
    """This rank's shard of a whole parameter (``moment=False``) or moment
    tensor: its slice over the model axis, and for ZeRO-1 moments over the
    data axis (a view)."""
    out = full
    mdim = lay.moment_model_dim if moment else lay.model_dim
    if mdim is not None:
        out = parallel.local_slice(out, axes["model"], mdim)
    if moment and zero1 and lay.zero_dim is not None:
        out = parallel.local_slice(out, axes["data"], lay.zero_dim)
    return out


def shard_state(state: TrainState, mesh, *, zero1: bool = True
                ) -> TrainState:
    """Slice a whole ``TrainState`` (say, from
    ``convert.load_reference_state``) onto ``mesh``: the model in place
    (``shard_model``), the moments as copies of their slices."""
    shard_model(state.model, mesh, zero1=zero1)
    lay = state.model.shard_layout

    def cut(moments):
        return {n: shard_tensor(t, lay.params[n], lay.axes, moment=True,
                                zero1=zero1).clone()
                for n, t in moments.items()}
    return TrainState(state.model, OptState(state.opt.step, cut(state.opt.m),
                                            cut(state.opt.v)))


def init_sharded_state(cfg: ModelConfig, optimizer: AdamW, mesh, *,
                       seed: int = 0, device="cuda",
                       zero1: bool = True) -> TrainState:
    """``init_state``'s model, drawn whole on ``device`` from ``seed`` and
    sharded onto ``mesh``, with zero moments of the shards' shapes (no
    whole moment is ever made)."""
    model = T.init_params(cfg, seed=seed, device=device)
    model.requires_grad_(True)
    shard_model(model, mesh, zero1=zero1)
    lay = model.shard_layout
    zeros = lambda: {n: torch.zeros(tuple(shard_tensor(
        torch.empty(lay.params[n].shape, device="meta"), lay.params[n],
        lay.axes, moment=True, zero1=zero1).shape), device=p.device)
        for n, p in model.named_parameters()}
    return TrainState(model, OptState(
        torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros()))


def full_tensors(state: TrainState) -> List[Tuple[str, torch.Tensor]]:
    """A sharded state's whole tensors on every rank, in the checkpoint's
    order (parameters, ``m.<name>``, ``v.<name>``, ``step``): the shards
    all-gathered over the data axis (ZeRO-1 moments), then over the model
    axis.  Collective."""
    lay = state.model.shard_layout
    axes = lay.axes

    def whole(t, p: ParamLayout, moment: bool):
        if moment and lay.zero1 and p.zero_dim is not None:
            t = parallel.all_gather_cat(t, axes["data"], p.zero_dim)
        mdim = p.moment_model_dim if moment else p.model_dim
        if mdim is not None:
            t = parallel.all_gather_cat(t, axes["model"], mdim)
        return t.detach()
    named = list(state.model.named_parameters())
    return ([(n, whole(p, lay.params[n], False)) for n, p in named]
            + [(f"m.{n}", whole(state.opt.m[n], lay.params[n], True))
               for n, _ in named]
            + [(f"v.{n}", whole(state.opt.v[n], lay.params[n], True))
               for n, _ in named]
            + [("step", state.opt.step)])


def sharded_train_step(cfg: ModelConfig, optimizer: AdamW, mesh, *,
                       microbatches: int = 1, zero1: bool = True,
                       compress: bool = False):
    """The counterpart of the reference's ``jit_train_step``: returns
    ``train_step(state, batch) -> (state, metrics)`` for a state sharded on
    ``mesh`` (``shard_state`` / ``init_sharded_state`` with the same
    ``zero1``) and the rank's rows of the global batch
    (``batch_for(..., shard=(dp index, dp size))``).

    The loss is the global batch's mean: each rank's summed cross-entropy
    over the global label count, its gradient summed over the
    data-parallel ranks (``compress``: ``allreduce_compressed_group``'s
    mean times their number, with its error carried from step to step in
    the step function).  With ``microbatches = k`` each rank splits its
    rows into k parts and microbatch i is the ranks' i-th parts: the
    reference groups rows differently, which changes nothing where every
    label counts.  Metrics as ``make_train_step``'s, the same on every
    rank."""
    from repro_torch.train.compression import allreduce_compressed_group
    axes = parallel.mesh_axes(mesh)
    dp = axes["dp"]
    errors: Dict[str, torch.Tensor] = {}

    def train_step(state: TrainState, batch):
        model = state.model
        lay = model.shard_layout
        if lay is None or lay.mesh is not mesh or lay.zero1 != zero1:
            raise ValueError(f"the state is not sharded on this mesh with "
                             f"zero1={zero1} (shard_state)")
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        rows = batch["tokens"].shape[0]
        if rows % microbatches:
            raise ValueError(f"{rows} rows do not split into {microbatches} "
                             f"microbatches")
        parts = [{k: x[i * (rows // microbatches):
                       (i + 1) * (rows // microbatches)]
                  for k, x in batch.items()} for i in range(microbatches)]
        loss = torch.zeros((), dtype=torch.float32,
                           device=state.opt.step.device)
        for part in parts:
            total, count = T.nll_sum(model, cfg, part)
            n = parallel.all_reduce(count.detach().clone(), dp)
            li = total / torch.clamp(n, min=1.0)
            li.backward()
            loss = loss + li.detach()
        loss = parallel.all_reduce(loss, dp) / microbatches
        grads = {}
        for name, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[name] = g / microbatches if microbatches > 1 else g
        if compress:
            if not errors:
                errors.update({n: torch.zeros_like(g, dtype=torch.float32)
                               for n, g in grads.items()})
            mean, new = allreduce_compressed_group(grads, errors, dp)
            errors.update(new)
            grads = {n: g * dp.size for n, g in mean.items()}
        else:
            parallel.all_reduce_coalesced(list(grads.values()), dp)
        shards = {n: ShardedParam(l.model_dim is not None,
                                  l.zero_dim if zero1 else None,
                                  l.model_dim if l.moment_model_dim is None
                                  else None)
                  for n, l in lay.params.items()}
        _, opt, om = optimizer.update_sharded(
            grads, state.opt, params, shards, axes["model"], axes["data"])
        for p in params.values():
            p.grad = None
        return TrainState(model, opt), {"loss": loss, **om}

    return train_step
