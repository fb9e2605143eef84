"""Training launcher: config -> mesh -> model and AdamW -> data -> train
step -> checkpoints (the reference's ``repro/launch/train.py``).

Usage (CPU, smoke config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \
      --smoke --steps 30 --batch 4 --seq 64 --device cpu

On the card (the published config, full width and depth):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \
      --steps 5 --batch 4 --seq 2048

Sharded, one process per rank (``--backend`` names the process group's
backend and is never chosen for you):
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch \
      llama3_2_1b --smoke --steps 30 --batch 4 --seq 64 --mesh auto \
      --backend gloo [--device cpu]

``--mesh auto`` is the reference's: ``make_elastic_mesh(world,
model_parallel=min(4, world))``, so (data, model) = (world / tp, tp);
``--mesh pod|multipod`` is the production mesh and needs a world of 256
(512) ranks.  ``--backend nccl`` takes one card per rank; ranks sharing a
card need ``--backend gloo``.  Without ``--backend`` the launcher trains
on one device, and refuses a world of more than one rank or a pod mesh.

The flags are the reference's, plus ``--device``, ``--backend`` and
``--log-every`` (print the loss every that many steps, and at the last;
default 10; rank 0 prints).

Fault tolerance: every ``--ckpt-every`` steps an atomic checkpoint is
published asynchronously, and one at the end; a restart with the same
``--ckpt-dir`` resumes from LATEST, and the stateless data pipeline
replays exactly the remaining batches.  Checkpoints hold whole arrays, so
a restart may run on fewer ranks (an elastic restart: the auto mesh is
the one ``plan_restart`` plans for the new world).
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch import parallel
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM, batch_for
from repro_torch.launch.mesh import (make_elastic_device_mesh,
                                     make_production_mesh, production_shape)
from repro_torch.optim.adamw import AdamW
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import (init_sharded_state, init_state,
                                          make_train_step,
                                          sharded_train_step)


def run(arch: str, *, smoke: bool, steps: int, batch: int, seq: int,
        ckpt_dir: str = "", ckpt_every: int = 50, lr: float = 3e-4,
        mesh_kind: str = "auto", microbatches: int = 1, log_every: int = 10,
        seed: int = 0, max_seconds: float = 0.0, device="cuda",
        backend: str = None):
    """Train ``arch`` for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device``, printing the loss every ``log_every`` steps and at the
    last.  The model is drawn from a generator on ``device`` seeded
    with ``seed``, the data from ``SyntheticLM(seed=seed)``.  With a
    ``backend`` this process is one rank of the world the environment
    names (``parallel.init_ranks``) and trains its shards on the mesh
    ``mesh_kind`` gives; every refused configuration raises before the
    process group starts.  Returns (the losses of the steps run, the final
    ``TrainState``)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if mesh_kind != "auto":
        shape = production_shape(multi_pod=mesh_kind == "multipod")
        need = 1
        for n in shape.values():
            need *= n
        if world != need:
            raise ValueError(
                f"mesh {mesh_kind!r} is the reference's {tuple(shape.values())}"
                f" pod of {need} ranks; this world has {world}")
    if backend is None:
        if world > 1:
            raise ValueError(f"launched as one of {world} ranks: pass "
                             f"--backend gloo or --backend nccl")
        return _run_one(arch, smoke=smoke, steps=steps, batch=batch,
                        seq=seq, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                        lr=lr, microbatches=microbatches,
                        log_every=log_every, seed=seed,
                        max_seconds=max_seconds, device=device)
    ranks = parallel.init_ranks(backend, device)
    try:
        if mesh_kind == "auto":
            mesh = make_elastic_device_mesh(
                ranks.world, model_parallel=min(4, ranks.world))
        else:
            mesh = make_production_mesh(multi_pod=mesh_kind == "multipod")
        return _run_sharded(arch, mesh, ranks, smoke=smoke, steps=steps,
                            batch=batch, seq=seq, ckpt_dir=ckpt_dir,
                            ckpt_every=ckpt_every, lr=lr,
                            microbatches=microbatches, log_every=log_every,
                            seed=seed, max_seconds=max_seconds)
    finally:
        parallel.shutdown()


def _run_sharded(arch: str, mesh, ranks, *, smoke, steps, batch, seq,
                 ckpt_dir, ckpt_every, lr, microbatches, log_every, seed,
                 max_seconds):
    """``run``'s loop on one rank of ``mesh``."""
    cfg = get_config(arch, smoke=smoke)
    dp = parallel.mesh_axes(mesh)["dp"]
    if batch % dp.size:
        raise ValueError(f"a batch of {batch} rows does not split over "
                         f"{dp.size} data-parallel ranks")
    opt = AdamW(lr=lr, warmup=min(20, steps // 5 + 1), total_steps=steps)
    pipe = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
    state = init_sharded_state(cfg, opt, mesh, seed=seed,
                               device=ranks.device)
    say = print if ranks.rank == 0 else (lambda *a, **k: None)
    start_step = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        last = mgr.latest_step()
        if last is not None:
            state = mgr.restore(last, state)
            start_step = last
            say(f"[train] resumed from step {last} on mesh "
                f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")
    step_fn = sharded_train_step(cfg, opt, mesh, microbatches=microbatches)
    losses = []
    t_start = time.time()
    step = start_step
    for step in range(start_step, steps):
        data = batch_for(cfg, pipe, step, device=ranks.device,
                         shard=(dp.index, dp.size))
        state, metrics = step_fn(state, data)
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t_start
            say(f"[train] step {step} loss {losses[-1]:.4f} "
                f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)", flush=True)
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, state, asynchronous=True)
        if max_seconds:
            # every rank stops at the same step: the slowest clock decides
            late = torch.tensor([float(time.time() - t_start > max_seconds)],
                                device=ranks.device)
            dist.all_reduce(late, op=dist.ReduceOp.MAX)
            if late.item():
                say(f"[train] time budget reached at step {step}")
                break
    if mgr:
        mgr.wait()
        mgr.save(min(step + 1, steps), state)
        mgr.wait()
    return losses, state


def _run_one(arch: str, *, smoke, steps, batch, seq, ckpt_dir, ckpt_every,
             lr, microbatches, log_every, seed, max_seconds, device):
    """``run`` on one device."""
    cfg = get_config(arch, smoke=smoke)
    opt = AdamW(lr=lr, warmup=min(20, steps // 5 + 1), total_steps=steps)
    pipe = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
    state = init_state(cfg, opt, seed=seed, device=device)

    start_step = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        last = mgr.latest_step()
        if last is not None:
            state = mgr.restore(last, state)
            start_step = last
            print(f"[train] resumed from step {last}")

    step_fn = make_train_step(cfg, opt, microbatches=microbatches)
    losses = []
    t_start = time.time()
    step = start_step
    for step in range(start_step, steps):
        data = batch_for(cfg, pipe, step, device=device)
        state, metrics = step_fn(state, data)
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t_start
            print(f"[train] step {step} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)", flush=True)
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, state, asynchronous=True)
        if max_seconds and time.time() - t_start > max_seconds:
            print(f"[train] time budget reached at step {step}")
            break
    if mgr:
        mgr.wait()
        mgr.save(min(step + 1, steps), state)
    return losses, state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="auto",
                    choices=["auto", "pod", "multipod"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=list(parallel.BACKENDS))
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu to train on the CPU)")
    run(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        lr=args.lr, mesh_kind=args.mesh, microbatches=args.microbatches,
        log_every=args.log_every, seed=args.seed,
        max_seconds=args.max_seconds, device=args.device,
        backend=args.backend)


if __name__ == "__main__":
    main()
