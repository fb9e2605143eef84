"""Carry objects of the JAX reference package over into this package.

Each function reads the reference object's attributes as numpy arrays
(``np.asarray`` of a JAX array needs no JAX import here) and builds the
port's counterpart, so both packages can compute on identical operands and
a plan elected by the reference planner can drive the port
(``masked_spgemm(plan=plan_from_reference(p))``), a model can run the
reference's weights (``load_reference_params``) and training can start
from the reference's state (``load_reference_state``).  Nothing of the
reference is imported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import BCSR, CSR, CSRDelta, PaddedCSR
from repro_torch.core.planner import Plan, PlanStats
from repro_torch.models.layers import Norm
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


#: reference names of the port's parameters where they differ: replicated
#: K/V projections, and the SSM block's mixer
_RENAME = {"wk_rep": "wk", "wv_rep": "wv", "ssm": "mixer"}


def _load(module, tree, path: str, idx: tuple, seen: set,
          into: dict) -> None:
    """Copy ``tree`` into ``module``: each leaf indexed at ``idx`` (its
    stacked layer axes; () for an unstacked tree) into the parameter of
    its name, ``<norm>_scale``/``<norm>_bias`` into the norm submodule of
    that name, and a dict into the submodule of its name, recursively.  A
    name the module has no place for raises; ``seen`` collects the ids of
    the parameters written; ``into`` maps a parameter's id to the tensor
    written in its place (by default the parameter itself)."""
    for name, sub in tree.items():
        where = f"{path}/{name}" if path else name
        attr = _RENAME.get(name, name)
        if isinstance(sub, dict):
            child = getattr(module, attr, None)
            if not isinstance(child, torch.nn.Module):
                raise ValueError(f"{where}: the port has no such module")
            _load(child, sub, where, idx, seen, into)
            continue
        owner = module
        norm, _, part = name.rpartition("_")
        if isinstance(getattr(module, norm, None), Norm):
            owner, attr = getattr(module, norm), part
        dst = getattr(owner, attr, None)
        if not isinstance(dst, torch.Tensor):
            raise ValueError(f"{where}: the port has no such parameter")
        _copy(into.get(id(dst), dst), np.asarray(sub)[idx],
              where + (str(list(idx)) if idx else ""))
        seen.add(id(dst))


def _stacks(model):
    """The model's stacked reference trees: name -> (leading axes of each
    leaf, [(block, index)])."""
    cfg = model.cfg
    blocks = list(model.blocks)
    fam = cfg.family
    if fam == "ssm":
        r = cfg.xlstm.slstm_every
        n_super = len(blocks) // r
        return {"layers_mlstm": ((n_super, r - 1), [
                    (blocks[s * r + j], (s, j)) for s in range(n_super)
                    for j in range(r - 1)]),
                "layers_slstm": ((n_super,), [
                    (blocks[s * r + r - 1], (s,)) for s in range(n_super)])}
    if fam == "hybrid":
        return {"layers_ssm": ((len(blocks),), [
            (b, (i,)) for i, b in enumerate(blocks)])}
    if fam == "audio":
        enc = list(model.enc_blocks)
        return {"enc_layers": ((len(enc),), [(b, (i,))
                                             for i, b in enumerate(enc)]),
                "dec_layers": ((len(blocks),), [
                    (b, (i,)) for i, b in enumerate(blocks)])}
    kd = n_dense_layers(cfg)
    out = {}
    for name, part in (("layers_dense", blocks[:kd]),
                       ("layers_moe", blocks[kd:])):
        if part:
            out[name] = ((len(part),), [(b, (i,))
                                        for i, b in enumerate(part)])
    return out


def load_reference_params(model, tree, into=None) -> None:
    """Copy a reference parameter tree (``repro.models.transformer
    .init_params``; leaves as numpy or JAX arrays) into a port
    ``Transformer`` of the same config, in place.

    Unstacked entries map to the model's own: ``embed``,
    ``final_ln_scale`` (``_bias``), ``lm_head``, the VLM's ``patch_proj``,
    the encoder-decoder's ``frame_proj`` and ``encfinal_ln_scale``
    (``_bias``), and the hybrid's ``shared_attn`` (one weight set, no layer
    axis) into its ``shared_attn`` block.  The stacks hold each block
    parameter on leading layer axes:

    * ``layers_dense`` (the blocks with a dense MLP, first) and
      ``layers_moe`` (the MoE blocks): ``attn/{wq, wk, wv, wo, bq, bk,
      bv}`` or, with MLA, ``attn/{wq, wkv_a, wk_rope, wk_b, wv_b, wo}``;
      ``ffn/{w_gate, w_up, w_down, b_up, b_down}`` or, in a MoE block,
      ``ffn/{router, experts_gate, experts_up, experts_down,
      shared/{w_gate, w_up, w_down}}``; ``ln1_scale``, ``ln2_scale`` (and
      ``_bias``);
    * xLSTM: ``layers_mlstm`` on two axes (super-block, position in it)
      and ``layers_slstm`` on one, each the mixer's parameters beside
      ``ln1_scale``;
    * hybrid: ``layers_ssm``, ``{"ssm": {...}, "ln1_scale"}``;
    * encoder-decoder: ``enc_layers`` (``attn``, ``ffn``, ``ln1``,
      ``ln2``) and ``dec_layers`` (``attn``, ``cross``, ``ffn``, ``ln1`` to
      ``ln3``).

    A key the port has no place for raises, as do a stack whose layer
    axes differ from the model's and a tree that leaves a parameter of the
    model unwritten.  ``into`` (parameter name -> tensor of its shape)
    writes a tree of the parameters' structure, such as an optimizer
    moment, into those tensors in place of the parameters.
    """
    params = dict(model.named_parameters())
    into = {id(params[n]): t for n, t in (into or {}).items()}
    stacks = _stacks(model)
    foreign = sorted(k for k in tree if k.startswith(("layers_", "enc_",
                                                      "dec_"))
                     and k not in stacks)
    if foreign:
        raise ValueError(f"reference parameters the port has no place for: "
                         f"{foreign}")
    seen: set = set()
    _load(model, {k: v for k, v in tree.items() if k not in stacks}, "", (),
          seen, into)
    for name, (lead, targets) in stacks.items():
        layers = tree[name]
        got = np.asarray(layers["ln1_scale"]).shape[:len(lead)]
        if tuple(got) != lead:
            raise ValueError(f"{name}: reference layer axes {tuple(got)}, "
                             f"the port's {lead}")
        for block, idx in targets:
            if name in ("layers_mlstm", "layers_slstm"):
                norms = {k: v for k, v in layers.items()
                         if k.startswith("ln")}
                _load(block, norms, name, idx, seen, into)
                _load(block.mixer, {k: v for k, v in layers.items()
                                    if k not in norms}, name, idx, seen, into)
            else:
                _load(block, layers, name, idx, seen, into)
    missing = [n for n, p in model.named_parameters() if id(p) not in seen]
    if missing:
        raise ValueError(f"the reference tree has no value for: "
                         f"{missing[:8]}" + (" ..." if len(missing) > 8
                                             else ""))


def _ref_keys(module, keys: tuple, lead: tuple, kv_rep: bool, flat: bool,
              out: dict, prefix: str) -> None:
    """Add ``module``'s parameters to ``out``: port name -> (reference
    keys, leading stack axes).  The inverse of ``_load``'s map: a norm
    submodule's parameter is ``<norm>_<param>``, a replicated K/V
    projection ``wk_rep``/``wv_rep``, the hybrid's ``mixer`` is ``ssm``,
    and the xLSTM mixers (``flat``) sit beside their block's norm."""
    back = {"mixer": "ssm"}
    for name, _ in module.named_parameters(recurse=False):
        ref = name
        if kv_rep and name in ("wk", "wv") and hasattr(module, "wq"):
            ref = name + "_rep"
        out[prefix + name] = (keys + (ref,), lead)
    for cname, child in module.named_children():
        if isinstance(child, Norm):
            for pname, _ in child.named_parameters(recurse=False):
                out[f"{prefix}{cname}.{pname}"] = (
                    keys + (f"{cname}_{pname}",), lead)
        elif isinstance(child, torch.nn.ModuleList):
            continue
        elif flat and cname == "mixer":
            _ref_keys(child, keys, lead, kv_rep, False, out,
                      f"{prefix}{cname}.")
        else:
            _ref_keys(child, keys + (back.get(cname, cname),), lead,
                      kv_rep, False, out, f"{prefix}{cname}.")


def reference_paths(model) -> dict:
    """Each port parameter's place in the reference's parameter tree:
    ``{port name: (path, reference shape)}`` with the path written as
    ``jax.tree_util.keystr`` writes it (``"['layers_dense']['attn']['wq']"``)
    and the shape the reference's, its stacked layer axes in front of the
    port parameter's own.  The map is ``load_reference_params``'s."""
    cfg = model.cfg
    keyed: dict = {}
    _ref_keys(model, (), (), cfg.kv_replicated, False, keyed, "")
    index = {id(b): i for i, b in enumerate(model.blocks)}
    enc = ({id(b): i for i, b in enumerate(model.enc_blocks)}
           if model.enc_blocks is not None else {})
    for stack, (lead, targets) in _stacks(model).items():
        for block, _ in targets:
            prefix = (f"enc_blocks.{enc[id(block)]}." if stack == "enc_layers"
                      else f"blocks.{index[id(block)]}.")
            _ref_keys(block, (stack,), lead, cfg.kv_replicated,
                      stack in ("layers_mlstm", "layers_slstm"), keyed,
                      prefix)
    params = dict(model.named_parameters())
    out = {}
    for name, p in params.items():
        keys, lead = keyed[name]
        out[name] = ("".join(f"['{k}']" for k in keys),
                     tuple(lead) + tuple(p.shape))
    return out


def load_reference_state(state, ref_state) -> None:
    """Copy a reference ``TrainState`` (``params`` and ``OptState(step, m,
    v)``; leaves as numpy or JAX arrays) into a port ``TrainState`` of the
    same config, in place: the parameters as ``load_reference_params``
    maps them, the moments ``m`` and ``v`` (trees of the parameters'
    structure) through the same map into ``state.opt.m`` / ``.v``, and the
    step count."""
    load_reference_params(state.model, ref_state.params)
    load_reference_params(state.model, ref_state.opt.m, into=state.opt.m)
    load_reference_params(state.model, ref_state.opt.v, into=state.opt.v)
    with torch.no_grad():
        state.opt.step.fill_(int(np.asarray(ref_state.opt.step)))
