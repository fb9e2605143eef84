"""Rank bodies for ``tests/test_torch_sharded_serve.py``: each runs in a
process spawned by ``torch.multiprocessing``, joins a gloo group on a
``FileStore`` under the test's directory, runs on the CPU with one
intra-op thread and writes what it computed as ``<name>.<rank>.pt``
there.  Every rank serves and trains every configuration from the whole
weights the test saved (``<case>.pt``): a prefill, decode steps on a
seeded cache, a greedy ``generate`` and sharded train steps.  Nothing
here imports JAX or the reference package.  The ranks start before the
test has written every case: each waits for its case's file."""
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import parallel
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data.pipeline import SyntheticLM, batch_for
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.serve.decode import generate
from repro_torch.train import train_step as TS

#: every SMOKE config, and internvl2 with a vocabulary that divides no
#: model axis (its embedding and head split by d_model instead)
CASES = ARCH_IDS + ("internvl2_2b vocab=515",)
#: seamless with a vocabulary that 4 does not divide, on (1, 4)
WIDE_CASE = "seamless_m4t_large_v2 vocab=514"
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
#: the prefill: 2 x 16 tokens (the VLM's 16 image tokens in front)
BATCH, PREFILL_SEQ = 2, 16
#: the decode steps: a seeded cache of 32 positions, row r at position
#: START[r] + i in step i (the rows cross T's midpoint at different steps)
CACHE_LEN, STARTS, DECODE_STEPS = 32, (12, 14), 8
#: generate: 4 prompt tokens, 6 new ones
PROMPT, NEW = 4, 6
#: the train steps, as tests/torch_sharded_ranks.py's families
STEP_OPT = dict(lr=1e-3, warmup=1, total_steps=10)
TRAIN_PIPE = dict(seq_len=32, global_batch=4, seed=2)
TRAIN_STEPS = 3


def case_config(case: str):
    """The port's SMOKE config a case names (``"<arch> vocab=<n>"``
    replaces the vocabulary); a MoE at a capacity that drops nothing on
    two model ranks, so that its expert-parallel dispatch is the
    single-device one."""
    arch, *opt = case.split()
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=2.0))
    for o in opt:
        k, v = o.split("=")
        cfg = cfg.replace(**{{"vocab": "vocab_size"}[k]: int(v)})
    return cfg


def mesh_cases(shape) -> tuple:
    return (WIDE_CASE,) if shape == (1, 4) else CASES


def tag(case: str, shape) -> str:
    return f"{case.replace(' ', '_')}@{shape[0]}x{shape[1]}"


def seeded_cache(cfg, seed: int = 5):
    """A whole cache of ``CACHE_LEN`` positions for ``BATCH`` rows filled
    from ``seed``: normal draws times 0.5 (the stabilisers ``m`` unscaled)
    in each tensor's dtype, except the sLSTM's normaliser ``n``, a sum of
    exponentials, drawn as 1 + |x| (near 0 its ``clamp`` makes the state
    jump with the last bit of its input)."""
    rng = np.random.default_rng(seed)
    cache = T.init_cache(cfg, BATCH, CACHE_LEN, device="cpu")

    def fill(tree, group=None):
        if tree is None:
            return None
        out = {}
        for k, t in tree.items():
            if t is None or isinstance(t, dict):
                out[k] = fill(t, k)
                continue
            x = rng.standard_normal(tuple(t.shape))
            if group == "slstm" and k == "n":
                x = 1.0 + np.abs(x)
            elif k != "m":
                x = x * 0.5
            out[k] = torch.as_tensor(x).to(t.dtype)
        return out
    return fill(cache)


def inputs(cfg, seed: int = 9) -> dict:
    """The prefill batch, the decode tokens and positions and the prompt,
    whole (the ranks take their rows)."""
    rng = np.random.default_rng(seed)
    tok = lambda *s: torch.as_tensor(rng.integers(0, cfg.vocab_size, s),
                                     dtype=torch.int32)
    out = {"tokens": tok(BATCH, PREFILL_SEQ),
           "decode": tok(BATCH, DECODE_STEPS),
           "pos": torch.as_tensor(STARTS, dtype=torch.int32),
           "prompt": tok(BATCH, PROMPT)}
    if cfg.family == "vlm":
        out["patches"] = torch.as_tensor(rng.standard_normal(
            (BATCH, cfg.img_tokens, cfg.d_frontend)) * 0.2,
            dtype=torch.float32)
    if cfg.family == "audio":
        out["frames"] = torch.as_tensor(rng.standard_normal(
            (BATCH, PREFILL_SEQ, cfg.d_frontend)) * 0.2, dtype=torch.float32)
    return out


def prefill_batch(cfg, inp: dict) -> dict:
    return {k: inp[k] for k in ("tokens", "patches", "frames") if k in inp}


def serve(model, cfg, inp: dict, cache, rows=slice(None), sharded=None):
    """Prefill logits, ``DECODE_STEPS`` decode steps on ``cache`` (updated
    in place) and a greedy ``generate``, on the rows ``rows`` of ``inp``;
    ``sharded`` (a model) makes the logits whole."""
    whole = (lambda x: x) if sharded is None else \
        (lambda x: T.gather_logits(sharded, x))
    out = {"prefill": whole(T.forward(model, cfg, {
        k: v[rows] for k, v in prefill_batch(cfg, inp).items()}))}
    enc = (model.encode(inp["frames"][rows], cfg)
           if cfg.family == "audio" else None)
    out["decode"], out["cache"] = decode(model, cfg, inp, cache, rows, enc)
    out["generate"] = generate(model, cfg, inp["prompt"][rows],
                               max_new=NEW, encoder_out=enc)
    return out


def decode(model, cfg, inp: dict, cache, rows=slice(None), enc=None):
    """``DECODE_STEPS`` decode steps of the rows ``rows`` on ``cache``
    (updated in place; the encoder-decoder's encoder output ``enc`` made
    from the frames when not given): (their logits (steps, B, V),
    cache)."""
    if cfg.family == "audio" and enc is None:
        enc = model.encode(inp["frames"][rows], cfg)
    logits = []
    for i in range(DECODE_STEPS):
        lg, cache = T.decode_step(model, cfg, inp["decode"][rows, i], cache,
                                  inp["pos"][rows] + i, encoder_out=enc)
        logits.append(lg)
    return torch.stack(logits), cache


def train_losses(cfg, params: dict, mesh=None) -> list:
    """``TRAIN_STEPS`` steps from ``params`` with zero moments: on one
    device, or sharded on ``mesh`` (ZeRO-1)."""
    opt = AdamW(**STEP_OPT)
    state = TS.init_state(cfg, opt, device="cpu")
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            p.copy_(params[n])
    pipe = SyntheticLM(cfg.vocab_size, **TRAIN_PIPE)
    if mesh is None:
        step, shard = TS.make_train_step(cfg, opt), (0, 1)
    else:
        state = TS.shard_state(state, mesh)
        step = TS.sharded_train_step(cfg, opt, mesh)
        dp = parallel.mesh_axes(mesh)["dp"]
        shard = (dp.index, dp.size)
    losses = []
    for i in range(TRAIN_STEPS):
        state, m = step(state, batch_for(cfg, pipe, i, device="cpu",
                                         shard=shard))
        losses.append(float(m["loss"]))
    return losses


def wait_for(path: str, timeout: float = 600.0) -> str:
    """``path`` once it exists (the test writes each case's file whole,
    by a rename, while the ranks already run)."""
    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(path)
        time.sleep(0.05)
    return path


def _model(cfg, params: dict):
    model = T.init_params(cfg, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
    return model


def ranks(rank: int, world: int, tmp: str) -> None:
    """Every case on each mesh of ``MESHES[world]``."""
    torch.set_num_threads(1)
    parallel.init_ranks("gloo", "cpu", rank=rank, world_size=world,
                        store=dist.FileStore(os.path.join(tmp, f"store{world}"),
                                             world))
    res = {}
    for shape in MESHES[world]:
        mesh = make_device_mesh(shape, ("data", "model"))
        axes = parallel.mesh_axes(mesh)
        dp = axes["dp"]
        rows = slice(dp.index * BATCH // dp.size,
                     (dp.index + 1) * BATCH // dp.size)
        for case in mesh_cases(shape):
            cfg = case_config(case)
            saved = torch.load(wait_for(os.path.join(
                tmp, f"{case.replace(' ', '_')}.pt")))
            model = TS.shard_model(_model(cfg, saved["params"]), mesh,
                                   zero1=False)
            cache = T.shard_cache(model, saved["cache"])
            out = serve(model, cfg, saved["inputs"], cache, rows, model)
            out["axes"] = {k: (a.size, a.index) for k, a in axes.items()}
            out["train"] = train_losses(cfg, saved["params"], mesh)
            res[tag(case, shape)] = out
    torch.save(res, os.path.join(tmp, f"serve{world}.{rank}.pt"))
    dist.barrier()
    parallel.shutdown()


#: the sharded decode on the card: one case for each layer whose decode
#: runs on shards (MLA's context-parallel latents, the SSM and the hybrid's
#: attention, the mLSTM and sLSTM, the decoder's self- and
#: cross-attention, the odd vocabulary's d_model-split head)
GPU_CASES = ("deepseek_v2_lite_16b", "zamba2_7b", "xlstm_1_3b",
             "seamless_m4t_large_v2", "internvl2_2b vocab=515")


def on(tree, dev):
    """A nested dict of tensors (None leaves kept) on ``dev``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def cuda_decode_ranks(rank: int, world: int, tmp: str) -> None:
    """``GPU_CASES``' decode steps on (1, ``world``), every rank on
    ``cuda:0`` over gloo; writes ``cuda.<rank>.pt``."""
    torch.set_num_threads(1)
    ranks_ = parallel.init_ranks(
        "gloo", "cuda", rank=rank, world_size=world, local_rank=rank,
        store=dist.FileStore(os.path.join(tmp, f"cuda-store{world}"), world))
    dev = ranks_.device
    mesh = make_device_mesh((1, world), ("data", "model"))
    res = {}
    for case in GPU_CASES:
        cfg = case_config(case)
        saved = torch.load(os.path.join(tmp, f"{case.replace(' ', '_')}.pt"))
        model = TS.shard_model(_model(cfg, saved["params"]).to(dev), mesh,
                               zero1=False)
        cache = T.shard_cache(model, on(saved["cache"], dev))
        logits, cache = decode(model, cfg, on(saved["inputs"], dev), cache)
        res[case] = {"decode": logits.cpu(), "cache": on(cache, "cpu"),
                     "model_index": parallel.mesh_axes(mesh)["model"].index}
    torch.save(res, os.path.join(tmp, f"cuda.{rank}.pt"))
    dist.barrier()
    parallel.shutdown()
