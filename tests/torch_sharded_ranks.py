"""Rank bodies for ``tests/test_torch_sharded_train.py`` (and, at the end,
``tests/test_torch_dryrun.py``'s real ranks): each runs in a
process spawned by ``torch.multiprocessing``, joins a gloo group on a
``FileStore`` under the test's directory, runs on the CPU with one
intra-op thread and writes what it measured as ``<name>.pt`` there (rank
0, unless every rank writes).  Nothing here imports JAX or the reference
package."""
import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch import parallel
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM, batch_for
from repro_torch.launch.elastic import plan_restart
from repro_torch.launch.mesh import make_device_mesh, make_elastic_device_mesh
from repro_torch.optim.adamw import AdamW
from repro_torch.train import train_step as TS
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import allreduce_compressed_group

#: the sharded-step check: llama3.2-1b SMOKE, 3 steps of 4 x 16 tokens
STEP_OPT = dict(lr=1e-3, warmup=1, total_steps=10)
STEP_PIPE = dict(seq_len=16, global_batch=4, seed=1)
STEPS = 3
#: the elastic restart, as the reference's tests/ft_check.py
FT_OPT = dict(lr=1e-3, warmup=2, total_steps=6, weight_decay=0.0)
FT_PIPE = dict(seq_len=16, global_batch=8, seed=11)
FT_STEPS, FT_CKPT_EVERY, FT_CRASH_AFTER = 6, 2, 4
#: the MoE check: moonshot SMOKE's first MoE block at these capacities
MOE_CAPACITIES = (1.5, 0.5)
#: the families' steps: 3 steps of 4 x 32 tokens from seed 3, the
#: tensor-parallel ones on (2, 2) (moonshot at a capacity that drops
#: nothing, so that it is the single-device MoE, and with ``ep`` off),
#: the rest on (4, 1)
FAMILY_PIPE = dict(seq_len=32, global_batch=4, seed=2)
FAMILY_STEPS = 3
TP_FAMILIES = ("stablelm_3b", "starcoder2_7b", "moonshot_v1_16b_a3b",
               "moonshot_v1_16b_a3b ep=False", "internvl2_2b")
DP_FAMILIES = ("xlstm_1_3b", "zamba2_7b", "seamless_m4t_large_v2",
               "deepseek_v2_lite_16b")
TP_WIDE = "llama3_2_1b on (1, 4)"
#: the data-parallel families again, on the model axis of (2, 2)
TP_MORE = tuple(f"{a} on (2, 2)" for a in DP_FAMILIES)


def family_config(arch: str):
    """The SMOKE config a family check names (``"<arch> ep=False"``: the
    MoE's dense dispatch on experts gathered over the model axis)."""
    cfg = get_config(arch.split()[0], smoke=True)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=2.0, ep="ep=False" not in arch))
    return cfg


def _join(rank: int, world: int, tmp: str):
    torch.set_num_threads(1)
    return parallel.init_ranks(
        "gloo", "cpu", rank=rank, world_size=world,
        store=dist.FileStore(os.path.join(tmp, f"store{world}"), world))


def _world_axis(world: int, rank: int) -> parallel.Axis:
    return parallel.Axis("world", dist.group.WORLD, world, rank, "gloo")


def _state_from(cfg, opt, saved: dict) -> TS.TrainState:
    """A whole CPU ``TrainState`` holding the tensors ``saved`` names."""
    state = TS.init_state(cfg, opt, device="cpu")
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            p.copy_(saved[n])
            state.opt.m[n].copy_(saved[f"m.{n}"])
            state.opt.v[n].copy_(saved[f"v.{n}"])
        state.opt.step.copy_(saved["step"])
    return state


def _train(cfg, opt, state, mesh, steps, pipe, norms=None, **kw):
    dp = parallel.mesh_axes(mesh)["dp"]
    step = TS.sharded_train_step(cfg, opt, mesh, **kw)
    losses = []
    for i in range(steps):
        b = batch_for(cfg, pipe, i, device="cpu", shard=(dp.index, dp.size))
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if norms is not None:
            norms.append(float(m["grad_norm"]))
    return losses, state


def _families(mesh, archs) -> dict:
    out = {}
    for arch in archs:
        cfg = family_config(arch)
        opt = AdamW(**STEP_OPT)
        state = TS.init_sharded_state(cfg, opt, mesh, seed=3, device="cpu")
        norms = []
        losses, _ = _train(cfg, opt, state, mesh, FAMILY_STEPS,
                           SyntheticLM(cfg.vocab_size, **FAMILY_PIPE), norms)
        out[arch] = (losses, norms)
    return out


def _params(state) -> dict:
    return {n: t.clone() for n, t in TS.full_tensors(state)
            if not n.startswith(("m.", "v.")) and n != "step"}


def _moe(mesh, tmp: str) -> dict:
    """The expert-parallel forward of moonshot SMOKE's first MoE block on
    each data shard's rows of x, gathered over the data axis."""
    axes = parallel.mesh_axes(mesh)
    saved = torch.load(os.path.join(tmp, "moe_in.pt"))
    out = {}
    for cf in MOE_CAPACITIES:
        base = get_config("moonshot_v1_16b_a3b", smoke=True)
        cfg = base.replace(moe=dataclasses.replace(base.moe,
                                                   capacity_factor=cf))
        from repro_torch.models import transformer as T
        model = T.init_params(cfg, device="cpu")
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(saved["params"][n])
        TS.shard_model(model, mesh)
        moe = model.blocks[cfg.first_k_dense].ffn
        x = parallel.local_slice(saved["x"], axes["dp"], 0)
        with torch.no_grad():
            y = moe(x, cfg)
        out[cf] = {"y": parallel.all_gather_cat(y, axes["dp"], 0),
                   "sizes": moe.group_sizes}
    return out


def _compressed(world: int, rank: int, tmp: str) -> dict:
    z = torch.load(os.path.join(tmp, "compress_in.pt"))
    axis = _world_axis(world, rank)
    grads = {"w": z[f"g{world}"][rank], "u": z[f"h{world}"][rank]}
    errs = {"w": z[f"e{world}"][rank], "u": z[f"e{world}"][rank][:6]}
    mean, err = allreduce_compressed_group(grads, errs, axis)
    return {"mean": mean, "err": {k: parallel.all_gather_cat(
        v[None], axis, 0) for k, v in err.items()}}


def four_ranks(rank: int, world: int, tmp: str) -> None:
    """Every check on the (2, 2) mesh: steps, ZeRO-1, microbatches, the
    compressed step, the MoE, the compressed reduction and the elastic
    run's uninterrupted and crashing halves."""
    _join(rank, world, tmp)
    mesh = make_device_mesh((2, 2), ("data", "model"))
    axes = parallel.mesh_axes(mesh)
    cfg = get_config("llama3_2_1b", smoke=True)
    opt = AdamW(**STEP_OPT)
    pipe = SyntheticLM(cfg.vocab_size, **STEP_PIPE)
    saved = torch.load(os.path.join(tmp, "llama_state.pt"))
    res = {}

    whole = _state_from(cfg, opt, saved)
    state = TS.shard_state(whole, mesh)
    lay = state.model.shard_layout
    exact = all(torch.equal(p, TS.shard_tensor(
        saved[n], lay.params[n], axes, moment=False, zero1=True))
        and torch.equal(state.opt.m[n], TS.shard_tensor(
            saved[f"m.{n}"], lay.params[n], axes, moment=True, zero1=True))
        for n, p in state.model.named_parameters())
    res["exact_slices"] = exact
    res["local_shapes"] = {n: tuple(p.shape) for n, p in
                           state.model.named_parameters()}
    res["losses"], state = _train(cfg, opt, state, mesh, STEPS, pipe)
    res["params"] = _params(state)

    state = TS.shard_state(_state_from(cfg, opt, saved), mesh, zero1=False)
    res["losses_no_zero1"], state = _train(cfg, opt, state, mesh, STEPS,
                                           pipe, zero1=False)
    res["params_no_zero1"] = _params(state)

    state = TS.shard_state(_state_from(cfg, opt, saved), mesh)
    res["losses_mb2"], state = _train(cfg, opt, state, mesh, STEPS, pipe,
                                      microbatches=2)
    state = TS.shard_state(_state_from(cfg, opt, saved), mesh)
    res["losses_compressed"], state = _train(cfg, opt, state, mesh, 2, pipe,
                                             compress=True)
    del state

    res["moe"] = _moe(mesh, tmp)
    res["families"] = _families(mesh, TP_FAMILIES + TP_MORE)
    res["families"].update(_families(
        make_device_mesh((4, 1), ("data", "model")), DP_FAMILIES))
    # four model ranks: llama's two K/V heads split mid-head, so each rank
    # gathers wk and wv and reads the head its q head needs
    res["families"][TP_WIDE] = _families(
        make_device_mesh((1, 4), ("data", "model")),
        ("llama3_2_1b",))["llama3_2_1b"]
    res["compressed"] = _compressed(world, dist.get_rank(), tmp)

    ft_opt, ft_pipe = AdamW(**FT_OPT), SyntheticLM(cfg.vocab_size, **FT_PIPE)
    state = TS.init_sharded_state(cfg, ft_opt, mesh, seed=7, device="cpu")
    res["ft_oracle"], _ = _train(cfg, ft_opt, state, mesh, FT_STEPS,
                                 ft_pipe)
    state = TS.init_sharded_state(cfg, ft_opt, mesh, seed=7, device="cpu")
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
    step = TS.sharded_train_step(cfg, ft_opt, mesh)
    dp = axes["dp"]
    res["ft_full"] = []
    for i in range(FT_CRASH_AFTER):
        state, m = step(state, batch_for(cfg, ft_pipe, i, device="cpu",
                                         shard=(dp.index, dp.size)))
        res["ft_full"].append(float(m["loss"]))
        if (i + 1) % FT_CKPT_EVERY == 0:
            mgr.save(i + 1, state, asynchronous=True)
    mgr.wait()          # the "crash": the process ends after step 4's save
    if dist.get_rank() == 0:
        torch.save(res, os.path.join(tmp, "four.pt"))
    dist.barrier()
    parallel.shutdown()


def two_ranks(rank: int, world: int, tmp: str) -> None:
    """The elastic restart on two ranks (``plan_restart(2,
    model_parallel=2)``: data 1, model 2) from the four-rank run's LATEST,
    and the compressed reduction on two ranks."""
    _join(rank, world, tmp)
    plan = plan_restart(world, model_parallel=2)
    mesh = make_elastic_device_mesh(world, model_parallel=2)
    assert tuple(mesh.mesh.shape) == (plan["dp"], plan["tp"])
    dp = parallel.mesh_axes(mesh)["dp"]
    cfg = get_config("llama3_2_1b", smoke=True)
    opt, pipe = AdamW(**FT_OPT), SyntheticLM(cfg.vocab_size, **FT_PIPE)
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
    last = mgr.latest_step()
    state = mgr.restore(last, TS.init_sharded_state(cfg, opt, mesh, seed=0,
                                                    device="cpu"))
    step = TS.sharded_train_step(cfg, opt, mesh)
    losses = []
    for i in range(last, FT_STEPS):
        state, m = step(state, batch_for(cfg, pipe, i, device="cpu",
                                         shard=(dp.index, dp.size)))
        losses.append(float(m["loss"]))
    res = {"last": last, "mesh": dict(plan["mesh_shape"]),
           "resumed": losses,
           "compressed": _compressed(world, dist.get_rank(), tmp)}
    if dist.get_rank() == 0:
        torch.save(res, os.path.join(tmp, "two.pt"))
    dist.barrier()
    parallel.shutdown()


# ---------------------------------------------------------------------------
# the production dry run against real ranks (tests/test_torch_dryrun.py)
# ---------------------------------------------------------------------------

#: the dry run's cells on (2, 2): SMOKE configs, (arch, ShapeCfg fields):
#: training for three families (moonshot's experts expert-parallel), and
#: decode steps of 4 rows and of 1 row (fewer than the data ranks, so
#: that its cache's data axes move off the rows)
DRYRUN_MESH = {"data": 2, "model": 2}
DRYRUN_CELLS = (("llama3_2_1b", ("train", 32, 4, "train")),
                ("moonshot_v1_16b_a3b", ("train", 32, 4, "train")),
                ("zamba2_7b", ("train", 32, 4, "train")),
                ("llama3_2_1b", ("decode", 64, 4, "decode")),
                ("xlstm_1_3b", ("one_row", 64, 1, "decode")))
#: the ranks the dry run plays on a fake group of 4
DRYRUN_RANKS = (0, 3)
#: decode of one row on (2, 2) against one device: these SMOKE configs,
#: ``WHOLE_ROWS_STEPS`` steps from position 0 on a cache of 32 positions
WHOLE_ROWS_ARCHS = ("llama3_2_1b", "starcoder2_7b", "xlstm_1_3b")
WHOLE_ROWS_STEPS = 4


def dryrun_cells(device) -> list:
    """``dryrun.run_cell`` of every ``DRYRUN_CELLS`` cell on ``device`` as
    this rank of the default group, under PyTorch's ``FlopCounterMode``
    beside the dry run's own count: its counts by module are the result's
    ``flops_by_module`` (``"Global"`` their total).  Its module tracker
    keeps activations alive, so the temp and peak bytes are not the
    step's."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun as D
    out = []
    for arch, shape in DRYRUN_CELLS:
        with FlopCounterMode(display=False) as flops:
            res = D.run_cell(get_config(arch, smoke=True), ShapeCfg(*shape),
                             DRYRUN_MESH, device=device)
        res["flops_by_module"] = {m: sum(c.values()) for m, c in
                                  flops.get_flop_counts().items()}
        out.append(res)
    return out


def whole_rows_decode(arch: str, mesh) -> dict:
    """One row decoded on ``mesh`` and on one device from the same weights
    and tokens: each step's logits, the rank's cache specs, and the
    one-device cache's slices beside the rank's cache after the last
    step."""
    from repro_torch.launch import specs as SP
    from repro_torch.models import transformer as T
    cfg = get_config(arch, smoke=True)
    one = T.init_params(cfg, seed=4, device="cpu")
    model = TS.shard_model(T.init_params(cfg, seed=4, device="cpu"), mesh,
                           zero1=False)
    cache_one = T.init_cache(cfg, 1, 32, device="cpu")
    cache = T.shard_cache(model, cache_one)
    gen = torch.Generator().manual_seed(9)
    out = {"logits": [], "one_logits": []}
    for i in range(WHOLE_ROWS_STEPS):
        tok = torch.randint(0, cfg.vocab_size, (1,), generator=gen)
        pos = torch.full((1,), i, dtype=torch.int32)
        want, cache_one = T.decode_step(one, cfg, tok, cache_one, pos)
        got, cache = T.decode_step(model, cfg, tok, cache, pos)
        out["logits"].append(got)
        out["one_logits"].append(want)
    specs = model.cache_layout["specs"]
    axes = model.shard_layout.axes
    out["specs"] = specs
    out["cache"] = SP.cache_map(lambda _, t: t.clone(), cache)
    out["one_cache"] = SP.cache_map(
        lambda path, t: SP.cache_slice(t, T._leaf(specs, path), axes)
        .clone(), cache_one)
    return out


def dryrun_ranks(rank: int, world: int, tmp: str) -> None:
    """A real gloo rank of (2, 2): the dry run's cells on the CPU, and the
    one-row decodes; ranks ``DRYRUN_RANKS`` write ``dryrun_real.<rank>.pt``."""
    _join(rank, world, tmp)
    mesh = make_device_mesh((2, 2), ("data", "model"))
    res = {"cells": dryrun_cells("cpu"),
           "whole_rows": {a: whole_rows_decode(a, mesh)
                          for a in WHOLE_ROWS_ARCHS}}
    if dist.get_rank() in DRYRUN_RANKS:
        torch.save(res, os.path.join(tmp, f"dryrun_real.{dist.get_rank()}.pt"))
    dist.barrier()
    parallel.shutdown()


def dryrun_fake(tmp: str) -> None:
    """The dry run's cells on meta as each of ``DRYRUN_RANKS`` of a fake
    group of 4, one after another; writes ``dryrun_fake.<rank>.pt``."""
    from repro_torch.launch import dryrun as D
    for rank in DRYRUN_RANKS:
        with D.fake_group(4, rank):
            res = {"cells": dryrun_cells("meta")}
        torch.save(res, os.path.join(tmp, f"dryrun_fake.{rank}.pt"))
