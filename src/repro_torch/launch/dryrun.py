"""The production dry run (the reference's ``repro/launch/dryrun.py``): what
one rank of a production cell costs, without the production mesh.

A cell is one architecture and one shape of ``SHAPES`` on the (16, 16)
``(data, model)`` mesh or the (2, 16, 16) ``(pod, data, model)`` one.  One
process plays one rank of it (``--rank``): it holds a ``torch.distributed``
group of 256 (512) ranks on PyTorch's fake backend, whose collectives
return at once and move nothing, builds the production mesh over that
group (``launch.mesh.make_production_mesh``), and runs the cell's step
once, as the rank would, on ``meta`` tensors, which carry shapes and
dtypes and no storage:

* train: ``train_step.init_sharded_state`` then ``sharded_train_step``
  (AdamW on ZeRO-1 moments unless ``zero1=False``);
* prefill: ``transformer.forward`` on the sharded parameters;
* decode: ``shard_model(..., zero1=False)`` with the weights in the
  activation dtype, as the reference serves, then ``init_sharded_cache``
  and one ``make_serve_step`` step.

What is counted, during that one step, by the rank:

* ``cost_analysis["flops"]``: ``torch.utils.flop_counter``'s formulas
  (products, convolutions and attention ops by their shapes; the recompute
  of ``torch.utils.checkpoint`` under ``cfg.remat`` runs and is counted,
  as the reference's HLO holds it) plus ``kernel_flops``, the operations of
  the hand-written kernels that a meta tensor stands in for (the flash
  kernel's ``META_FLOPS``: q.k and p.v at the allowed elements);
* ``cost_analysis["bytes accessed"]``: the bytes of every dispatched op's
  tensor inputs and outputs, views excluded: each eager op's own traffic
  (the reference's HLO counts fusions, so this is the larger);
* ``collective_bytes_per_device``: ``parallel.LINK_BYTES`` by collective,
  the bytes a ring would put on the rank's links;
* ``collective_op_counts``: the c10d ops, as ``CommDebugMode`` counts
  them, under the reference's five names;
* ``memory_analysis``: ``argument_size_in_bytes`` (the rank's state, batch
  and cache shards), ``output_size_in_bytes`` (of which
  ``alias_size_in_bytes`` are arguments updated in place) and
  ``temp_size_in_bytes``, the peak of the live storages during the step
  less the arguments, tallied by a dispatch mode; ``peak_bytes`` is their
  sum, what the card's ``max_memory_allocated`` should read for the step;
  a decode cell adds ``cache_bytes``, the rank's cache, and
  ``reference_cache_bytes``, its slices as the reference places them.
  The two differ where the data axes do not split the rows (batch 1 at
  ``long_500k``): the reference's ``fit_spec`` spreads such a cache over
  the data axes on its heads or positions, while the port holds it in the
  layout its layer decodes, whole on each data rank
  (``transformer.shard_cache``), and moves none of it between steps.

On meta the MoE's routing cannot be read, so its group sizes are the
balanced split (``layers.balanced_sizes``; the JSON says
``"moe_routing": "balanced"``): the dropless dispatch does the same
products whatever the split, and under expert parallelism a rank's rows
are the split's, up to its capacity.  With ``device="cuda"`` the rank runs
for real on the card under the same fake group: the step once under the
counters, then once timed (``measured``: the step's ms and
``torch.cuda.max_memory_allocated``).  A fake collective writes nothing,
so such a rank's values mean nothing; its time and memory do.

Attention runs whole q heads a rank: where they do not divide the model
axis (llama3.2-3b's 24 and starcoder2-7b's 36 on 16) rank i runs the i-th
block of ``layers.balanced_sizes(Hq, 16)``, the first Hq mod 16 ranks one
head more, on the columns of its heads of ``wq``, ``wo``, ``wk`` and ``wv``
regrouped from the shards by an all-to-all (``parallel.regroup``; the
link bytes' ``all-to-all``).  A train step exchanges them in each forward
and back; a served model (prefill, decode) fetches them once, before its
first step (``fetch_blocks``): that fetch is reported apart, as
``fetch_bytes_per_device``, and the blocks it leaves are in the rank's
arguments, so a step's link bytes are the step's own.  ``"tp_heads":
[max, min]`` gives a rank's q heads for the cell; ``--rank 0`` (the
default) is a heaviest rank.  A cell the port
cannot shard (an SSM whose heads do not divide the axis, say) is
``status: "unsupported"`` with the error's text; one the reference does
not define (``cell_is_runnable``) is ``"skipped"``.  ``account_cell`` is
the reference's two-depth extrapolation, kept for speed: the eager loop
visits every layer, so a full-depth run is already exact and ``--unroll``
is accepted and changes nothing.  The reference's ``collective_bytes``
(parsing HLO text) has no counterpart: the port has no HLO, and counts at
each collective instead.

Run: ``python -m repro_torch.launch.dryrun --arch llama3_2_1b --shape
train_4k --mesh pod --account`` (one JSON under ``results/dryrun_torch``),
or ``--all`` for every cell in child processes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import weakref
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import caches, parallel
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      ShapeCfg, cell_is_runnable, get_config)
from repro_torch.launch.mesh import make_device_mesh, production_shape
from repro_torch.launch.specs import (cache_layout, cache_map,
                                     decode_input_specs, slice_shape,
                                     train_input_specs)

#: the reference's names of the collectives, by a substring of the c10d op
_COLLECTIVES = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("alltoall", "all-to-all"), ("send", "collective-permute"),
                ("recv", "collective-permute"))
REF_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute")
#: ``parallel.LINK_BYTES``'s names, as the reference's
_LINK_NAMES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
               "all_to_all": "all-to-all"}


def collective_kind(op) -> str:
    """The reference's name of a c10d op (its own name where none fits)."""
    name = str(op)
    return next((ref for key, ref in _COLLECTIVES if key in name), name)


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _tensors(tree, out=None) -> list:
    """The tensors in nested tuples, lists and dicts."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of the tensors in ``tree``."""
    seen = {}
    for t in _tensors(tree):
        seen[_storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


class Tally(TorchDispatchMode):
    """One dispatch mode that counts, for every op the step runs:

    * ``flops``: ``FlopCounterMode``'s own formulas (``flop_registry``:
      products, convolutions, attention ops) on the op's shapes; that mode
      also decomposes every other op in search of a product and tracks
      modules by gradient hooks, which keep every module's activations
      alive until it exits and make an sLSTM prefill of 32,768 tokens take
      half an hour (the CPU tests run it around this one);
    * ``collectives``: the c10d ops by the reference's names, as
      ``CommDebugMode`` counts them (its own module tracker fails on a
      module that runs more than once under checkpointing: zamba2's shared
      block);
    * ``accessed``: the bytes of the op's tensor inputs and outputs, views
      excluded and an output that is an input once;
    * ``live`` and ``peak``: the bytes of the live storages, those of
      ``arguments`` from the start and every storage an op makes until it
      is freed."""

    def __init__(self, arguments):
        from torch.utils.flop_counter import flop_registry
        super().__init__()
        self._formulas = flop_registry
        self.flops = 0
        self.collectives: Dict[str, int] = {k: 0 for k in REF_COLLECTIVES}
        self.accessed = 0
        self.live = 0
        self._held: Dict[int, int] = {}
        self._refs: Dict[int, weakref.ref] = {}
        for t in _tensors(arguments):
            self._track(t)
        self.peak = self.live

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key)
        del self._refs[key]

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        self._held[key] = st.nbytes()
        self._refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))
        self.live += self._held[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        self.peak = max(self.peak, self.live)
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            # an ``out_dtype`` (``bmm.dtype``) is no shape: older formulas
            # take it for their ``out_shape``
            self.flops += formula(
                *[a for a in args if not isinstance(a, torch.dtype)],
                **{k: v for k, v in kwargs.items()
                   if not isinstance(v, torch.dtype)}, out_val=out)
        if func.namespace == "c10d":
            kind = collective_kind(func)
            self.collectives[kind] = self.collectives.get(kind, 0) + 1
        if not func.is_view:
            ins = _tensors((args, kwargs))
            seen = {id(t) for t in ins}
            self.accessed += sum(t.numel() * t.element_size() for t in
                                 ins + [t for t in outs if id(t) not in seen])
        return out


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """This process as ``rank`` of a fake group of ``world`` ranks (the
    default process group), torn down on exit; an existing default group of
    ``world`` ranks is used as it is."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"a group of {dist.get_world_size()} ranks is "
                             f"up; the dry run needs {world}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rows(x: torch.Tensor, dp: parallel.Axis) -> torch.Tensor:
    """This rank's rows of a whole batch tensor: its block where the data
    axes divide the rows, else all of them (as ``fit_spec`` leaves it)."""
    return parallel.local_slice(x, dp, 0) if x.shape[0] % dp.size == 0 \
        else x


def _materialise(spec: torch.Tensor, device, vocab: int,
                 gen: torch.Generator) -> torch.Tensor:
    """A tensor of ``spec``'s shape and dtype on ``device``, of its own
    storage: empty on meta, else uniform token ids below ``vocab`` (ints)
    or normal draws times 0.2 (features) from ``gen`` (a CPU
    generator)."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(spec.shape), dtype=spec.dtype,
                           device="meta")
    if spec.dtype == torch.int32:
        x = torch.randint(0, vocab, tuple(spec.shape), generator=gen,
                          dtype=torch.int32)
    else:
        x = (torch.randn(tuple(spec.shape), generator=gen) * 0.2).to(
            spec.dtype)
    return x.to(device)


def param_counts(cfg: ModelConfig, model=None) -> Dict[str, int]:
    """``total`` parameters of ``cfg``'s whole model (built on meta unless
    given) and ``active`` a token, the reference's formula: the MoE layers'
    unrouted experts taken out."""
    from repro_torch.models import transformer as T
    if model is None:
        model = T.init_params(cfg, device="meta")
    total = sum(p.numel() for p in model.parameters())
    active = total
    if cfg.moe is not None:
        mo = cfg.moe
        per_expert = 3 * cfg.d_model * mo.d_ff_expert
        active = total - (cfg.n_layers - cfg.first_k_dense) * (
            mo.n_experts - mo.top_k) * per_expert
    return {"total": total, "active": active}


def reference_cache_bytes(cfg: ModelConfig, shape: ShapeCfg, mesh) -> int:
    """The bytes of this rank's slices of a decode cell's cache as the
    reference places them on ``mesh`` (``cache_specs`` under
    ``fit_spec``), made of no tensor but meta ones."""
    from repro_torch.models.transformer import _leaf, init_cache
    whole = init_cache(cfg, shape.global_batch, shape.seq_len,
                       device="meta")
    specs = cache_layout(whole, mesh)
    axes = parallel.mesh_axes(mesh)
    sizes = []
    cache_map(lambda path, t: sizes.append(t.element_size() * math.prod(
        slice_shape(tuple(t.shape), _leaf(specs, path), axes))), whole)
    return sum(sizes)


def _links() -> Dict[str, int]:
    """``parallel.LINK_BYTES`` by the reference's names of the
    collectives."""
    links: Dict[str, int] = {}
    for (name, _), n in parallel.LINK_BYTES.items():
        kind = _LINK_NAMES.get(name, name)
        links[kind] = links.get(kind, 0) + n
    return links


def fetch_blocks(model, cfg: ModelConfig) -> list:
    """A served model's one-time fetch: every attention layer's blocks of
    its q heads' (and K/V heads') columns, regrouped from the shards in
    the activation dtype (``layers.Attention.fetch_blocks``), before the
    first step; returns the blocks the layers hold."""
    from repro_torch.models.layers import Attention
    return [b for m in model.modules() if isinstance(m, Attention)
            for b in m.fetch_blocks(cfg, cfg.activation_dtype)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _build_step(cfg: ModelConfig, shape: ShapeCfg, mesh, *, zero1: bool,
                microbatches: int, device, seed: int):
    """(the step as a call of no arguments, its state, its other
    arguments): the rank's parameters (and moments), and its batch or
    cache and inputs, made on ``device``; the model is the first of the
    state."""
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW
    from repro_torch.serve.decode import make_serve_step
    from repro_torch.train import train_step as TS
    dp = parallel.mesh_axes(mesh)["dp"]
    gen = torch.Generator().manual_seed(seed)

    def local(specs):
        return {k: _materialise(_rows(v, dp), device, cfg.vocab_size, gen)
                for k, v in specs.items()}
    if shape.kind == "train":
        opt = AdamW()
        state = TS.init_sharded_state(cfg, opt, mesh, seed=seed,
                                      device=device, zero1=zero1)
        batch = local(train_input_specs(cfg, shape))
        step = TS.sharded_train_step(cfg, opt, mesh, zero1=zero1,
                                     microbatches=microbatches)
        return (lambda: step(state, batch)), \
            (state.model, state.opt), batch
    model = T.init_params(cfg, seed=seed, device=device)
    TS.shard_model(model, mesh, zero1=zero1 and shape.kind == "prefill")
    if shape.kind == "prefill":
        batch = local(train_input_specs(cfg, shape))
        return (lambda: T.forward(model, cfg, batch)), (model,), batch
    with torch.no_grad():                       # serve in activation dtype
        for p in model.parameters():
            p.data = p.data.to(cfg.activation_dtype)
    specs = decode_input_specs(cfg, shape)
    cache = T.init_sharded_cache(model, cfg, shape.global_batch,
                                 shape.seq_len, device=device)
    inputs = local({k: v for k, v in specs.items() if k != "cache"})
    if torch.device(device).type != "meta":     # a full cache: last slot
        inputs["pos"].fill_(shape.seq_len - 1)
    serve = make_serve_step(cfg)
    return (lambda: serve(model, inputs["token"], cache, inputs["pos"],
                          inputs.get("encoder_out"))), (model,), \
        (cache, inputs)


def run_cell(cfg: ModelConfig, shape: ShapeCfg, mesh_shape: Dict[str, int],
             *, zero1: bool = True, microbatches: int = 1, device="meta",
             seed: int = 0) -> dict:
    """One step of ``cfg`` at ``shape`` as this rank of a ``mesh_shape``
    mesh (``{axis: size}`` over the default group, which must hold their
    product of ranks) on ``device``, counted as the module docstring says.
    Raises ``NotImplementedError`` where the port cannot shard the cell."""
    from repro_torch.kernels.flash_mask import kernel as flash
    device = torch.device(device)
    t0 = time.perf_counter()
    caches.clear_all()          # the step builds its schedules, as cold
    mesh = make_device_mesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    fn, state, rest = _build_step(cfg, shape, mesh, zero1=zero1,
                                  microbatches=microbatches, device=device,
                                  seed=seed)
    params = list(state[0].parameters())
    fetch = None
    if shape.kind != "train":
        parallel.reset_link_bytes()
        state = state + (fetch_blocks(state[0], cfg),)
        fetch = _links()
    state = (params,) + state[1:]
    arguments = (state, rest)
    _sync(device)
    parallel.reset_link_bytes()
    flash.META_FLOPS = 0
    tally = Tally(arguments)
    with tally:
        out = fn()
    _sync(device)
    seconds = time.perf_counter() - t0
    argument = storage_bytes(arguments)
    links = _links()
    arg_keys = {_storage_key(t) for t in _tensors(arguments)}
    aliased = storage_bytes([t for t in _tensors(out)
                             if _storage_key(t) in arg_keys])
    res = {
        "n_devices": math.prod(mesh_shape.values()),
        "rank": dist.get_rank(),
        "device": str(device),
        "kind": shape.kind,
        "attn_impl": cfg.attn_impl,
        "unrolled": False,
        "status": "ok",
        "seconds_lower": round(seconds, 1),
        "seconds_compile": 0,
        "memory_analysis": {
            "argument_size_in_bytes": argument,
            "output_size_in_bytes": storage_bytes(out),
            "temp_size_in_bytes": tally.peak - argument,
            "alias_size_in_bytes": aliased,
            "peak_bytes": tally.peak,
            "state_bytes": storage_bytes(state),
        },
        "cost_analysis": {
            "flops": float(tally.flops + flash.META_FLOPS),
            "bytes accessed": float(tally.accessed),
            "kernel_flops": float(flash.META_FLOPS),
        },
        "collective_bytes_per_device": links,
        "collective_op_counts": tally.collectives,
        "params": dict(param_counts(cfg),
                       local=sum(p.numel() for p in params)),
    }
    if fetch is not None:
        res["fetch_bytes_per_device"] = fetch
    heads = tp_heads(cfg, mesh_shape.get("model", 1))
    if heads is not None:
        res["tp_heads"] = heads
    if shape.kind == "decode":
        res["memory_analysis"].update(
            cache_bytes=storage_bytes(rest[0]),
            reference_cache_bytes=reference_cache_bytes(cfg, shape, mesh))
    if cfg.moe is not None and device.type == "meta":
        res["moe_routing"] = "balanced"
    if device.type == "cuda":
        del out
        torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        t = time.perf_counter()
        fn()
        _sync(device)
        res["measured"] = {
            "step_ms": (time.perf_counter() - t) * 1e3,
            "max_memory_allocated": torch.cuda.max_memory_allocated(device)}
    return res


def tp_heads(cfg: ModelConfig, model_axis: int):
    """[most, fewest] attention q heads a rank runs on a model axis of
    ``model_axis`` (``layers.balanced_sizes``), None without attention
    heads (the xLSTM)."""
    from repro_torch.models.layers import balanced_sizes
    if cfg.family == "ssm" or not cfg.n_heads:
        return None
    sizes = balanced_sizes(cfg.n_heads, model_axis)
    return [max(sizes), min(sizes)]


def reduced_depth_cfgs(cfg):
    """Two reduced-depth configs (cfg1, cfg2, l1, l2, l_full) preserving the
    stack pattern, for layer-extrapolated cost accounting (the reference's:
    its HloCostAnalysis counts a scan body once; here a shallower run is
    only faster)."""
    fam = cfg.family
    if fam == "audio":
        # vary encoder+decoder pairs together
        c1 = cfg.replace(n_enc_layers=1, n_dec_layers=1)
        c2 = cfg.replace(n_enc_layers=2, n_dec_layers=2)
        return c1, c2, 1, 2, cfg.n_enc_layers
    if fam == "ssm" and cfg.xlstm is not None:
        r = cfg.xlstm.slstm_every
        return (cfg.replace(n_layers=r), cfg.replace(n_layers=2 * r),
                r, 2 * r, cfg.n_layers)
    if fam == "hybrid":
        e = cfg.hybrid_attn_every
        return (cfg.replace(n_layers=e), cfg.replace(n_layers=2 * e),
                e, 2 * e, cfg.n_layers)
    if cfg.moe is not None:
        kd = cfg.first_k_dense
        return (cfg.replace(n_layers=kd + 1), cfg.replace(n_layers=kd + 2),
                kd + 1, kd + 2, cfg.n_layers)
    return cfg.replace(n_layers=1), cfg.replace(n_layers=2), 1, 2, \
        cfg.n_layers


def _numbers(res: dict) -> Dict[str, float]:
    """The additive counts of a result, flattened to ``section/key``."""
    out = {}
    for sec in ("cost_analysis", "collective_bytes_per_device",
                "fetch_bytes_per_device", "collective_op_counts",
                "memory_analysis", "params"):
        for k, v in res.get(sec, {}).items():
            out[f"{sec}/{k}"] = v
    return out


def extrapolate(r1: dict, r2: dict, l1: int, l2: int, l_full: int) -> dict:
    """``r1``'s result with every count ``m`` of it replaced by
    ``m1 + (m2 - m1) * (l_full - l1) / (l2 - l1)`` (the reference's
    ``account_cell``; the memory sizes too, as each layer adds its
    parameters, moments and saved activations)."""
    m1, m2 = _numbers(r1), _numbers(r2)
    scale = (l_full - l1) / (l2 - l1)
    out = json.loads(json.dumps(r1))
    for key, a in m1.items():
        sec, k = key.split("/", 1)
        out[sec][k] = a + (m2.get(key, 0) - a) * scale
    out["accounting"] = "extrapolated"
    out["depths"] = {"l1": l1, "l2": l2, "l_full": l_full}
    out["samples"] = {"l1": m1, "l2": m2}
    return out


def account(cfg: ModelConfig, shape: ShapeCfg, mesh_shape: Dict[str, int],
            **kw) -> dict:
    """``run_cell``'s counts for ``cfg`` from its two reduced depths
    (``reduced_depth_cfgs``), extrapolated to its own."""
    c1, c2, l1, l2, l_full = reduced_depth_cfgs(cfg)
    r1 = run_cell(c1, shape, mesh_shape, **kw)
    r2 = run_cell(c2, shape, mesh_shape, **kw)
    out = extrapolate(r1, r2, l1, l2, l_full)
    out["params"].update(param_counts(cfg))
    return out


# not a memo: a config-override side channel for --patch, written once by
# main and read by lower_cell and account_cell
_PATCHED_CFG = {}  # lint: cache-ok(override channel, not a cache)


def _cell(arch: str, shape_name: str, multi_pod: bool, attn_impl, rank,
          run) -> dict:
    """The result of ``run(cfg, shape, mesh_shape)`` for a cell, under a
    fake group of the production mesh's ranks (or the one that is up),
    with the reference's head keys; ``skipped`` where the reference
    defines no such cell, ``unsupported`` where the port cannot shard
    it."""
    cfg = _PATCHED_CFG.get(arch) or get_config(arch)
    if attn_impl:
        cfg = cfg.replace(attn_impl=attn_impl)
    shape = SHAPES[shape_name]
    head = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16"}
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {**head, "status": "skipped", "reason": why}
    mesh_shape = production_shape(multi_pod=multi_pod)
    with fake_group(math.prod(mesh_shape.values()), rank):
        try:
            return {**head, **run(cfg, shape, mesh_shape)}
        except NotImplementedError as e:
            return {**head, "status": "unsupported", "reason": str(e)}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               attn_impl: str = None, zero1: bool = True,
               microbatches: int = 1, unroll: bool = False,
               device="meta", rank: int = 0) -> dict:
    """One production cell at full depth (``run_cell``) as ``rank`` of the
    (16, 16) or (2, 16, 16) mesh; ``unroll`` is the reference's flag and
    changes nothing (every layer runs)."""
    res = _cell(arch, shape_name, multi_pod, attn_impl, rank,
                lambda cfg, shape, mesh: run_cell(
                    cfg, shape, mesh, zero1=zero1,
                    microbatches=microbatches, device=device))
    if res["status"] == "ok":
        res["unrolled"] = unroll
    return res


def account_cell(arch: str, shape_name: str, multi_pod: bool,
                 attn_impl: str = None, rank: int = 0) -> dict:
    """A production cell's counts from two reduced depths (``account``), on
    meta, ``accounting: "extrapolated"``."""
    return _cell(arch, shape_name, multi_pod, attn_impl, rank,
                 lambda cfg, shape, mesh: account(cfg, shape, mesh))


def patched_config(arch: str, patch: str) -> ModelConfig:
    """``arch``'s config with ``--patch`` overrides (``k=v,...``; ``moe.``,
    ``ssm.``, ``xlstm.`` and ``mla.`` prefixes reach the sub-configs)."""
    cfg = get_config(arch)
    sub_kw = {"moe": {}, "ssm": {}, "xlstm": {}, "mla": {}}
    top_kw = {}
    for kv in patch.split(","):
        k, v = kv.split("=")
        v = {"true": True, "false": False}.get(
            v, int(v) if v.lstrip("-").isdigit() else
            (float(v) if v.replace(".", "").lstrip("-").isdigit() else v))
        pre = k.split(".", 1)
        if len(pre) == 2 and pre[0] in sub_kw:
            sub_kw[pre[0]][pre[1]] = v
        else:
            top_kw[k] = v
    for name, kw in sub_kw.items():
        if kw:
            top_kw[name] = dataclasses.replace(getattr(cfg, name), **kw)
    return cfg.replace(**top_kw)


def sweep(args) -> None:
    """Every (arch x shape) cell in a child process each, with a time
    limit; a child that fails leaves ``<name>.err`` with its output."""
    os.makedirs(args.out, exist_ok=True)
    for arch in ARCH_IDS:
        for shape in SHAPES:
            suffix = ".acct" if args.account else (
                ".unroll" if args.unroll else "")
            name = f"{arch}.{shape}.{args.mesh}{suffix}"
            path = os.path.join(args.out, name + ".json")
            if os.path.exists(path):
                print("skip (exists):", name)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", args.mesh,
                   "--out", args.out, "--rank", str(args.rank)]
            if args.unroll:
                cmd += ["--unroll", "--tag", "unroll"]
            if args.account:
                cmd += ["--account", "--tag", "acct"]
            print(">>", name, flush=True)
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=args.timeout)
                failed, text = r.returncode != 0, r.stdout + "\n" + r.stderr
            except subprocess.TimeoutExpired as e:
                failed = True
                text = f"timed out after {args.timeout} s\n{e.stdout or ''}"
            if failed:
                with open(os.path.join(args.out, name + ".err"), "w") as f:
                    f.write(text)
                print("FAILED:", name, text.splitlines()[-1:], flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--unroll", action="store_true",
                    help="the reference's exact-accounting flag: every "
                         "layer already runs, so it changes nothing")
    ap.add_argument("--account", action="store_true",
                    help="layer-extrapolated accounting (fast)")
    ap.add_argument("--patch", default="",
                    help="config overrides, e.g. "
                         "kv_replicated=true,moe.ep=false,remat=dots")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) in subprocesses")
    ap.add_argument("--tag", default="")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the production mesh to play")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="meta (no storage) or cuda (the rank for real on "
                         "the card, under the fake group)")
    ap.add_argument("--timeout", type=float, default=7200,
                    help="seconds a cell of --all may take")
    args = ap.parse_args(argv)

    if args.all:
        sweep(args)
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    if args.patch:
        _PATCHED_CFG[args.arch] = patched_config(args.arch, args.patch)
    multi = args.mesh == "multipod"
    if args.account:
        if args.device != "meta":
            ap.error("--account runs on meta")
        res = account_cell(args.arch, args.shape, multi,
                           attn_impl=args.attn_impl, rank=args.rank)
    else:
        res = lower_cell(args.arch, args.shape, multi,
                         attn_impl=args.attn_impl, zero1=not args.no_zero1,
                         microbatches=args.microbatches, unroll=args.unroll,
                         device=args.device, rank=args.rank)
    os.makedirs(args.out, exist_ok=True)
    tag = f".{args.tag}" if args.tag else ""
    name = f"{args.arch}.{args.shape}.{args.mesh}{tag}.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
