"""End-to-end driver: train a ~100M-param LM for a few hundred steps on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples_torch/train_lm.py          # ~100M, 200 steps
    PYTHONPATH=src python examples_torch/train_lm.py --tiny   # smoke config
    PYTHONPATH=src python examples_torch/train_lm.py --tiny --device cpu

The model is the llama3.2 family scaled to ~100M params, trained on the
deterministic synthetic stream (Zipf + induction-copy segments).  Loss
must fall well below the unigram entropy as the model learns to copy —
that drop is asserted at the end.  Checkpoints publish atomically; rerun
the same command after killing it and it resumes from LATEST (a fresh
``--ckpt-dir`` starts over).
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.launch.train import run


def main(argv=None) -> dict:
    """Run the example; returns the first and last losses it averaged."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu to run on the CPU)")

    if args.tiny:
        steps = args.steps or 30
        losses, _ = run("llama3_2_1b", smoke=True, steps=steps, batch=4,
                        seq=64, ckpt_dir=args.ckpt_dir, ckpt_every=10,
                        lr=3e-3, log_every=5, device=args.device)
    else:
        # ~100M: 12 layers x d512 x ff2048, 32k vocab (llama3.2 family)
        import repro_torch.configs.llama3_2_1b as base
        cfg100m = base.CONFIG.replace(
            name="llama-100m", n_layers=12, d_model=512, n_heads=8,
            n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
            tie_embeddings=False, dtype="float32", remat="none",
            attn_block=64)
        # register on the fly so the launcher's get_config can find it
        import sys
        import types
        mod = types.ModuleType("repro_torch.configs.llama_100m")
        mod.CONFIG = cfg100m
        mod.SMOKE = cfg100m
        sys.modules["repro_torch.configs.llama_100m"] = mod
        steps = args.steps or 200
        losses, _ = run("llama_100m", smoke=False, steps=steps, batch=4,
                        seq=128, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                        lr=1e-3, log_every=10,
                        max_seconds=float(os.environ.get(
                            "TRAIN_LM_MAX_SECONDS", 0)) or 0.0,
                        device=args.device)

    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    print(f"\nloss: {first:.3f} -> {last:.3f}")
    assert last < first - 0.5, "model failed to learn"
    print("OK: model learned the synthetic stream")
    return {"first": float(first), "last": float(last),
            "steps": len(losses)}


if __name__ == "__main__":
    main()
