"""Model input stand-ins: ``concrete_batch``, a small real batch for smoke
tests and examples, the reference's arrays bit for bit as tensors on a
device.  The reference's ``train_input_specs`` and ``decode_input_specs``
(ShapeDtypeStructs for XLA lowering) have no counterpart here."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import _features, _on


def concrete_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Uniform tokens (B, S) from ``default_rng(seed)``, labels the tokens
    rolled by one, plus the VLM's ``patches`` (the text cut by
    ``img_tokens``) or the encoder-decoder's ``frames``, normal draws times
    0.2 in the activation dtype."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    out = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    act = cfg.activation_dtype
    if cfg.family == "vlm":
        s_txt = seq - cfg.img_tokens
        out = {"tokens": tok[:, :s_txt], "labels": out["labels"][:, :s_txt]}
        out["patches"] = _features(rng.standard_normal(
            (batch, cfg.img_tokens, cfg.d_frontend)), act)
    if cfg.family == "audio":
        out["frames"] = _features(rng.standard_normal(
            (batch, seq, cfg.d_frontend or cfg.d_model)), act)
    return _on(out, device)
