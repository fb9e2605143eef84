"""Serving example: batched prefill + decode with KV/state caches, on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples_torch/serve_lm.py               # the card
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu

Loads a smoke-size model per family (GQA cache, MLA low-rank cache, SSM
state) and generates continuations for a batch of prompts — including the
induction-copy check: after training-free priming with a repeated motif,
even a random model produces *valid* cache behavior (shape/latency demo;
see examples_torch/train_lm.py for a trained model).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import transformer as T
from repro_torch.serve.decode import generate


def main(argv=None) -> dict:
    """Run the example; returns its deterministic results."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu to run on the CPU)")

    shapes = {}
    for arch in ("llama3_2_1b", "deepseek_v2_lite_16b", "zamba2_7b"):
        cfg = get_config(arch, smoke=True)
        params = T.init_params(cfg, seed=0, device=device)
        rng = np.random.default_rng(1)
        prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 12)),
                                  dtype=torch.int32, device=device)
        t0 = time.time()
        out = generate(params, cfg, prompts, max_new=8)
        sample = out[0, -10:].tolist()      # the host read ends the work
        dt = time.time() - t0
        assert tuple(out.shape) == (4, 20)
        kind = ("MLA low-rank cache" if cfg.mla else
                "SSM state" if cfg.family in ("ssm", "hybrid")
                else "GQA KV cache")
        print(f"{arch:24s} [{kind:18s}] generated {tuple(out.shape)} in "
              f"{dt:.1f}s")
        print("   sample:", sample)
        shapes[arch] = list(out.shape)
    return {"shapes": shapes}


if __name__ == "__main__":
    main()
