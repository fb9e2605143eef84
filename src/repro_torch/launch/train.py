"""Training launcher: config -> model and AdamW -> data -> train step ->
checkpoints (the reference's ``repro/launch/train.py`` on one device).

Usage (CPU, smoke config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \
      --smoke --steps 30 --batch 4 --seq 64 --device cpu

On the card (the published config, full width and depth):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \
      --steps 5 --batch 4 --seq 2048

The flags are the reference's, plus ``--device`` and ``--log-every``
(print the loss every that many steps, and at the last; default 10).

Fault tolerance: every ``--ckpt-every`` steps an atomic checkpoint is
published asynchronously, and one at the end; a restart with the same
``--ckpt-dir`` resumes from LATEST, and the stateless data pipeline
replays exactly the remaining batches.  ``--mesh pod|multipod`` (the
reference's TPU pods) raises: sharded training waits for a multi-GPU host.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM, batch_for
from repro_torch.optim.adamw import AdamW
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import init_state, make_train_step


def run(arch: str, *, smoke: bool, steps: int, batch: int, seq: int,
        ckpt_dir: str = "", ckpt_every: int = 50, lr: float = 3e-4,
        mesh_kind: str = "auto", microbatches: int = 1, log_every: int = 10,
        seed: int = 0, max_seconds: float = 0.0, device="cuda"):
    """Train ``arch`` for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device``, printing the loss every ``log_every`` steps and at the
    last.  The model is drawn from a generator on ``device`` seeded
    with ``seed``, the data from ``SyntheticLM(seed=seed)``.  Returns (the
    losses of the steps run, the final ``TrainState``)."""
    if mesh_kind != "auto":
        raise NotImplementedError(
            f"mesh {mesh_kind!r}: the port trains on one device; sharded "
            f"training waits for a multi-GPU host")
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
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu to train on the CPU)")
    run(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        lr=args.lr, mesh_kind=args.mesh, microbatches=args.microbatches,
        log_every=args.log_every, seed=args.seed,
        max_seconds=args.max_seconds, device=args.device)


if __name__ == "__main__":
    main()
