"""Carry objects of the JAX reference package over into this package.

Each function reads the reference object's attributes as numpy arrays
(``np.asarray`` of a JAX array needs no JAX import here) and builds the
port's counterpart, so both packages can compute on identical operands and
a plan elected by the reference planner can drive the port
(``masked_spgemm(plan=plan_from_reference(p))``) and a model can run the
reference's weights (``load_reference_params``).  Nothing of the
reference is imported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import BCSR, CSR, CSRDelta, PaddedCSR
from repro_torch.core.planner import Plan, PlanStats
from repro_torch.models.transformer import n_dense_layers


def csr_from_reference(obj) -> CSR:
    """A host CSR (``indptr``, ``indices``, ``data``, ``shape``)."""
    return CSR(np.asarray(obj.indptr).copy(), np.asarray(obj.indices).copy(),
               np.asarray(obj.data).copy(), tuple(obj.shape))


def delta_from_reference(obj) -> CSRDelta:
    """An edge-delta batch (``rows``, ``cols``, ``vals``, ``delete``)."""
    return CSRDelta(np.asarray(obj.rows).copy(), np.asarray(obj.cols).copy(),
                    np.asarray(obj.vals).copy(),
                    np.asarray(obj.delete).copy())


def padded_from_reference(obj, device="cuda") -> PaddedCSR:
    """A padded row format (``cols``, ``vals``, ``lens``, ``shape``)."""
    return PaddedCSR(torch.as_tensor(np.array(obj.cols), device=device),
                     torch.as_tensor(np.array(obj.vals), device=device),
                     torch.as_tensor(np.array(obj.lens), device=device),
                     tuple(obj.shape))


def bcsr_from_reference(obj, device="cuda") -> BCSR:
    """A block-CSR (host ``indptr``/``indices``, device ``blocks``)."""
    return BCSR(np.asarray(obj.indptr).copy(), np.asarray(obj.indices).copy(),
                torch.as_tensor(np.array(obj.blocks), device=device),
                tuple(obj.shape), int(obj.block_size))


def _stats(obj) -> PlanStats:
    return PlanStats(**{f.name: getattr(obj, f.name)
                        for f in dataclasses.fields(PlanStats)})


def plan_from_reference(obj):
    """A ``Plan`` (with its ``PlanStats``) or a bare ``PlanStats``."""
    if not hasattr(obj, "algorithm"):
        return _stats(obj)
    return Plan(algorithm=obj.algorithm,
                widths=tuple(int(w) for w in obj.widths),
                two_phase=bool(obj.two_phase),
                n_inspect=obj.n_inspect,
                tile_eligible=bool(obj.tile_eligible),
                tile_block=int(obj.tile_block),
                costs=tuple((str(name), float(c)) for name, c in obj.costs),
                stats=_stats(obj.stats),
                trialed=tuple(obj.trialed))


def _copy(dst: torch.Tensor, src, name: str) -> None:
    arr = np.array(src, dtype=np.float32)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: reference shape {arr.shape} does not "
                         f"match the port's {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.as_tensor(arr))


def _copy_module(module, tree, path: str, i: int, rename=None) -> None:
    """Copy layer ``i`` of each stacked leaf of ``tree`` into the parameter
    of ``module`` with its name (a dict recurses into the submodule of its
    name); a name the module has no parameter for raises."""
    rename = rename or {}
    for name, stacked in tree.items():
        where = f"{path}/{name}"
        if isinstance(stacked, dict):
            sub = getattr(module, name, None)
            if not isinstance(sub, torch.nn.Module):
                raise ValueError(f"{where}: the port has no such module")
            _copy_module(sub, stacked, where, i)
            continue
        dst = getattr(module, rename.get(name, name), None)
        if not isinstance(dst, torch.Tensor):
            raise ValueError(f"{where}: the port has no such parameter")
        _copy(dst, stacked[i], f"{where}[{i}]")


def load_reference_params(model, tree) -> None:
    """Copy a reference parameter tree (``repro.models.transformer
    .init_params``; leaves as numpy or JAX arrays) into a port
    ``Transformer`` of the same config, in place.

    ``embed``, ``final_ln_scale`` (``final_ln_bias``), ``lm_head`` and the
    VLM's ``patch_proj`` map to the model's own.  ``layers_dense`` (the
    blocks with a dense MLP, first) and ``layers_moe`` (the MoE blocks)
    hold each block parameter stacked on a leading layer axis:
    ``attn/{wq, wk, wv, wo, bq, bk, bv}`` or, with MLA, ``attn/{wq,
    wkv_a, wk_rope, wk_b, wv_b, wo}``; ``ffn/{w_gate, w_up, w_down, b_up,
    b_down}`` or, in a MoE block, ``ffn/{router, experts_gate, experts_up,
    experts_down, shared/{w_gate, w_up, w_down}}``; ``ln1_scale``,
    ``ln2_scale`` (and ``_bias``).  Stack i goes to the i-th block of its
    kind.  A key the port has no place for raises.
    """
    cfg = model.cfg
    kd = n_dense_layers(cfg)
    stacks = {"layers_dense": model.blocks[:kd],
              "layers_moe": model.blocks[kd:]}
    known = {"embed", "final_ln_scale", "final_ln_bias", "lm_head"}
    known |= {name for name, blocks in stacks.items() if len(blocks)}
    if model.patch_proj is not None:
        known.add("patch_proj")
    extra = sorted(set(tree) - known)
    if extra:
        raise ValueError(f"reference parameters the port has no place for: "
                         f"{extra}")
    _copy(model.embed, tree["embed"], "embed")
    _copy(model.final_ln.scale, tree["final_ln_scale"], "final_ln_scale")
    if model.final_ln.bias is not None:
        _copy(model.final_ln.bias, tree["final_ln_bias"], "final_ln_bias")
    if model.lm_head is not None:
        _copy(model.lm_head, tree["lm_head"], "lm_head")
    if model.patch_proj is not None:
        _copy(model.patch_proj, tree["patch_proj"], "patch_proj")
    kv = ({"wk_rep": "wk", "wv_rep": "wv"} if cfg.kv_replicated else {})
    for stack, blocks in stacks.items():
        if not len(blocks):
            continue
        layers = tree[stack]
        n = np.asarray(layers["ln1_scale"]).shape[0]
        if n != len(blocks):
            raise ValueError(f"{stack}: reference has {n} layers, the port "
                             f"{len(blocks)}")
        for i, block in enumerate(blocks):
            _copy_module(block.attn, layers["attn"], f"{stack}/attn", i, kv)
            _copy_module(block.ffn, layers["ffn"], f"{stack}/ffn", i)
            for ln, module in (("ln1", block.ln1), ("ln2", block.ln2)):
                _copy(module.scale, layers[f"{ln}_scale"][i],
                      f"{stack}/{ln}_scale[{i}]")
                if module.bias is not None:
                    _copy(module.bias, layers[f"{ln}_bias"][i],
                          f"{stack}/{ln}_bias[{i}]")
