"""Rank bodies for ``tests/test_torch_uneven_heads.py``: each runs in a
process spawned by ``torch.multiprocessing``, joins a gloo group on a
``FileStore`` under the test's directory, runs on the CPU with one
intra-op thread and writes what it computed as ``uneven.<rank>.pt``
there.  Four ranks serve and train both configs on (data 1, model 4),
two ranks the starcoder2-7b one on (1, 2), from the whole weights the
test saved (``<case>.pt``); rank 0 of one of them then runs the same on
one device (``ONE_DEVICE``).  Each rank first regroups seeded whole
weights' shards into its heads' blocks and back (``regroup_cases``), and
records each stage's link bytes and all-gathered shapes (``stage``) and
the blocks its served model fetched (``served_blocks``).  Nothing here
imports JAX or the reference package.  The ranks start before the test
has written every case: each waits for its case's file."""
import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import parallel
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM, batch_for
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.train import train_step as TS
from torch_sharded_serve_ranks import wait_for

#: two configs whose q heads do not divide a model axis of 4: llama3.2-3b
#: SMOKE at 6 q / 2 K/V heads of 16 (1.5 heads of ``wq`` a shard; rank 1
#: runs heads 2 and 3, which read K/V heads 0 and 1), and starcoder2-7b
#: SMOKE (biases, window 32) at 9 q / 3 K/V heads of 16 (2.25 heads a
#: shard; rank 2 runs heads 5 and 6, which read K/V heads 1 and 2)
CASES = {"llama3_2_3b": dict(d_model=96, n_heads=6, n_kv_heads=2),
         "starcoder2_7b": dict(d_model=144, n_heads=9, n_kv_heads=3)}
#: the meshes by world size and the cases each runs: on (1, 2) the
#: starcoder2-7b config's ranks run 5 and 4 heads, each reading parts of
#: two K/V groups (heads 0..4 read K/V heads 0, 0, 0, 1, 1), so each
#: indexes its K/V heads once per q head
MESHES = {4: ((1, 4), tuple(CASES)), 2: ((1, 2), ("starcoder2_7b",))}
#: the world whose rank 0 adds a case's one-device runs
ONE_DEVICE = {"llama3_2_3b": 4, "starcoder2_7b": 2}
#: the prefill: 2 x 48 tokens (past starcoder's window of 32) on each impl
BATCH, SEQ = 2, 48
IMPLS = ("block_masked", "dense_masked", "flash_pallas")
#: the decode steps: a seeded cache of 32 positions (8 a rank: the K/V
#: heads do not divide the axis, so T does), row r at START[r] + i in step
#: i (crossing from rank 1's block of T to rank 2's)
CACHE_LEN, STARTS, DECODE_STEPS = 32, (12, 14), 4
#: the train step: one step of 4 x 32 tokens
STEP_OPT = dict(lr=1e-3, warmup=1, total_steps=10)
TRAIN_PIPE = dict(seq_len=32, global_batch=4, seed=2)


#: the attention weights whose heads' columns are regrouped: (name, the
#: dim the model axis splits, whether its columns are K/V heads')
WEIGHTS = (("wq", 1, False), ("wo", 0, False), ("wk", 1, True),
           ("wv", 1, True))


def case_config(arch: str, impl: str = None):
    cfg = get_config(arch, smoke=True).replace(**CASES[arch])
    return cfg if impl is None else cfg.replace(attn_impl=impl)


def seeded_cache(cfg, seed: int = 5):
    """A whole K/V cache of ``CACHE_LEN`` positions for ``BATCH`` rows:
    normal draws times 0.5."""
    rng = np.random.default_rng(seed)
    cache = T.init_cache(cfg, BATCH, CACHE_LEN, device="cpu")
    return {g: None if leaves is None else
            {k: torch.as_tensor(rng.standard_normal(tuple(t.shape))
                                * 0.5).to(t.dtype) for k, t in leaves.items()}
            for g, leaves in cache.items()}


def inputs(cfg, seed: int = 9) -> dict:
    rng = np.random.default_rng(seed)
    tok = lambda *s: torch.as_tensor(rng.integers(0, cfg.vocab_size, s),
                                     dtype=torch.int32)
    return {"tokens": tok(BATCH, SEQ), "decode": tok(BATCH, DECODE_STEPS),
            "pos": torch.as_tensor(STARTS, dtype=torch.int32)}


def _model(cfg, params: dict):
    model = T.init_params(cfg, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
    return model


@contextlib.contextmanager
def stage(out: dict, name: str):
    """Within the block, the bytes this rank puts on its links by
    collective and the shape of every tensor it all-gathers
    (``parallel.all_gather_cat``, which every all-gather goes through):
    ``out["stages"][name]``."""
    before, shapes = dict(parallel.LINK_BYTES), []
    saved = parallel.all_gather_cat

    def gather(t, axis, dim):
        shapes.append(tuple(t.shape))
        return saved(t, axis, dim)
    parallel.all_gather_cat = gather
    try:
        yield
    finally:
        parallel.all_gather_cat = saved
    out.setdefault("stages", {})[name] = {
        "links": {k: n - before.get(k, 0)
                  for k, n in parallel.LINK_BYTES.items()},
        "gathered": shapes}


def served_blocks(model, cfg, tokens, out: dict) -> None:
    """The blocks layer 0 fetched for serving (``Attention._fetched``),
    two more forwards (which fetch nothing), an in-place update of its
    ``wq`` (doubled), a forward (which fetches that block again) and the
    block it then holds."""
    attn, f32 = model.blocks[0].attn, torch.float32
    out["fetched"] = {n: attn._fetched[(n, f32)][2].clone()
                      for n, _, _ in WEIGHTS}
    with torch.no_grad():
        with stage(out, "again"):
            for _ in range(2):
                T.forward(model, cfg, {"tokens": tokens})
        attn.wq.mul_(2.0)
        with stage(out, "updated"):
            T.forward(model, cfg, {"tokens": tokens})
    out["refetched"] = attn._fetched[("wq", f32)][2].clone()


def run(arch: str, saved: dict, mesh=None) -> dict:
    """Prefill logits on every impl, the decode steps' logits and cache,
    and one train step's loss and parameters, on one device or on this
    rank of ``mesh`` (logits and parameters made whole; each stage's link
    bytes and all-gathered shapes, ``stage``; then ``served_blocks``)."""
    inp, out = saved["inputs"], {"prefill": {}}
    whole = lambda model, x: (x if mesh is None
                              else T.gather_logits(model, x))
    with stage(out, "prefill"):
        for impl in IMPLS:
            cfg = case_config(arch, impl)
            model = _model(cfg, saved["params"])
            if mesh is not None:
                TS.shard_model(model, mesh, zero1=False)
            with torch.no_grad():
                out["prefill"][impl] = whole(
                    model, T.forward(model, cfg, {"tokens": inp["tokens"]}))
    cfg = case_config(arch)
    cache = {g: None if leaves is None else
             {k: t.clone() for k, t in leaves.items()}
             for g, leaves in saved["cache"].items()}
    if mesh is not None:
        cache = T.shard_cache(model, cache)
        out["heads"] = model.blocks[0].attn.tp_heads(cfg)
        out["place"] = model.cache_layout["specs"]
        out["axes"] = {k: (a.size, a.index) for k, a in
                       model.shard_layout.axes.items()}
    logits = []
    with torch.no_grad(), stage(out, "decode"):
        for i in range(DECODE_STEPS):
            lg, cache = T.decode_step(model, cfg, inp["decode"][:, i], cache,
                                      inp["pos"] + i)
            logits.append(lg)
    out["decode"], out["cache"] = torch.stack(logits), cache
    out["train"] = train_step(cfg, saved["params"], mesh)
    if mesh is not None:
        served_blocks(model, cfg, inp["tokens"], out)
    return out


def train_step(cfg, params: dict, mesh=None) -> dict:
    """One step from ``params`` with zero moments: its loss, grad norm and
    the updated parameters (whole)."""
    opt = AdamW(**STEP_OPT)
    state = TS.init_state(cfg, opt, device="cpu")
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            p.copy_(params[n])
    batch = batch_for(cfg, SyntheticLM(cfg.vocab_size, **TRAIN_PIPE), 0,
                      device="cpu")
    if mesh is None:
        T.loss_fn(state.model, cfg, batch).backward()
        grads = {n: p.grad.clone()
                 for n, p in state.model.named_parameters()}
        state, m = TS.make_train_step(cfg, opt)(state, batch)
        new = {n: p.detach().clone()
               for n, p in state.model.named_parameters()}
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": new, "grads": grads}
    else:
        state = TS.shard_state(state, mesh)
        out = {}
        with stage(out, "train"):
            state, m = TS.sharded_train_step(cfg, opt, mesh)(state, batch)
        new = {n: t.clone() for n, t in TS.full_tensors(state)
               if not n.startswith(("m.", "v.")) and n != "step"}
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": new, "stage": out["stages"]["train"]}


def uneven_gather(tp) -> dict:
    """``parallel.all_gather_uneven`` of blocks of 2, 2, 1, 1, ... rows
    (rank r's filled with r + 1) and its backward through a weighted sum:
    the gathered tensor and this rank's gradient."""
    sizes = [2 if r < tp.size // 2 else 1 for r in range(tp.size)]
    x = torch.full((sizes[tp.index], 3), float(tp.index + 1),
                   requires_grad=True)
    y = parallel.all_gather_uneven(x, tp, 0, sizes)
    w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
    (y * w).sum().backward()
    return {"sizes": sizes, "gathered": y.detach(), "grad": x.grad}


def whole_weights(cfg, seed: int = 11) -> dict:
    """Whole ``wq``, ``wo``, ``wk`` and ``wv`` of ``cfg``'s shapes: normal
    draws from ``seed``."""
    rng = np.random.default_rng(seed)
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    shapes = {"wq": (d, q), "wo": (q, d), "wk": (d, kv), "wv": (d, kv)}
    return {n: torch.as_tensor(rng.standard_normal(shapes[n]),
                               dtype=torch.float32) for n, _, _ in WEIGHTS}


def consumer(shape, rank: int) -> torch.Tensor:
    """The weights of rank ``rank``'s consumer of its block: normal draws
    from seed 100 + rank."""
    return torch.as_tensor(np.random.default_rng(100 + rank).standard_normal(
        tuple(shape)), dtype=torch.float32)


def regroup_cases(tp, cases) -> dict:
    """``parallel.regroup`` of each case's whole weights' shards into this
    rank's heads' block (``head_blocks``) and its backward through
    ``(block * consumer).sum()``: the block, the shard's gradient and the
    link bytes of the two exchanges, by case and weight."""
    out = {}
    for arch in cases:
        cfg = case_config(arch)
        blocks = [L.head_blocks(cfg.n_heads, cfg.n_kv_heads, tp.size, r)
                  for r in range(tp.size)]
        for name, dim, kv in WEIGHTS:
            want = [(b[2 * kv] * cfg.hd, b[2 * kv + 1] * cfg.hd)
                    for b in blocks]
            w = whole_weights(cfg)[name]
            shard = parallel.local_slice(w, tp, dim).clone()
            shard.requires_grad_(True)
            parallel.reset_link_bytes()
            block = parallel.regroup(shard, tp, dim, want)
            forward = dict(parallel.LINK_BYTES)
            parallel.reset_link_bytes()
            (block * consumer(block.shape, tp.index)).sum().backward()
            out[arch, name] = {"block": block.detach(), "grad": shard.grad,
                               "forward": forward,
                               "backward": dict(parallel.LINK_BYTES)}
    return out


def ranks(rank: int, world: int, tmp: str) -> None:
    """``MESHES[world]``'s cases; rank 0 adds the one-device runs
    ``ONE_DEVICE`` gives this world."""
    torch.set_num_threads(1)
    parallel.init_ranks("gloo", "cpu", rank=rank, world_size=world,
                        store=dist.FileStore(os.path.join(
                            tmp, f"store{world}"), world))
    shape, cases = MESHES[world]
    mesh = make_device_mesh(shape, ("data", "model"))
    tp = parallel.mesh_axes(mesh)["model"]
    res = {"gather": uneven_gather(tp), "regroup": regroup_cases(tp, cases)}
    for arch in cases:
        saved = torch.load(wait_for(os.path.join(tmp, f"{arch}.pt")))
        parallel.reset_link_bytes()
        res[arch] = run(arch, saved, mesh)
        res[arch]["links"] = dict(parallel.LINK_BYTES)
        if rank == 0 and ONE_DEVICE[arch] == world:
            res[arch]["one"] = run(arch, saved)
    torch.save(res, os.path.join(tmp, f"uneven{world}.{rank}.pt"))
    dist.barrier()
    parallel.shutdown()
