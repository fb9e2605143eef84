"""Deterministic, stateless, elastic data pipeline (the reference's
``repro/data/pipeline.py``: the same numpy draws, so every batch is the
reference's bit for bit).

Every batch is a pure function of (global_step): no iterator state, no
files.  Resuming from a checkpoint at step k replays exactly the batches
>= k, and a host materialises only its slice of the global batch
(``shard_at``), so a changed set of workers maps other slices of the same
stream.

The synthetic LM stream is a mixture of Zipf-distributed unigrams and
copy/induction segments, so small models show a learning signal (loss
well below the unigram entropy).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    copy_frac: float = 0.5           # fraction of induction-copy segments
    segment: int = 32

    def global_batch_at(self, step: int) -> np.ndarray:
        """(global_batch, seq_len + 1) int32, deterministic in step."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        b, s = self.global_batch, self.seq_len + 1
        # zipf unigrams (folded into the vocabulary)
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        base = (base - 1) % self.vocab_size
        # induction segments: periodic copies of a short motif
        n_seg = s // self.segment
        for i in range(b):
            if rng.random() < self.copy_frac and n_seg >= 2:
                motif = rng.integers(0, self.vocab_size, self.segment)
                base[i] = np.tile(motif, n_seg + 1)[:s]
        return base.astype(np.int32)

    def shard_at(self, step: int, shard: int, n_shards: int) -> np.ndarray:
        """Rows ``shard`` of ``n_shards`` equal slices of the global
        batch."""
        g = self.global_batch_at(step)
        per = self.global_batch // n_shards
        return g[shard * per:(shard + 1) * per]


def batch_for(cfg: ModelConfig, pipe: SyntheticLM, step: int,
              rng_seed: int = 0, device="cuda",
              shard: Optional[Tuple[int, int]] = None
              ) -> Dict[str, torch.Tensor]:
    """The model family's batch at ``step`` as tensors on ``device``:
    ``tokens`` and ``labels`` (the stream shifted by one), the VLM's
    ``patches`` (B, img_tokens, d_frontend) with the text cut to make
    room, the encoder-decoder's ``frames`` (B, S, d_frontend); the
    features are normal draws times 0.2 in the activation dtype, drawn
    from ``(rng_seed, 7, step)`` as the reference draws them.  ``shard =
    (i, n)`` keeps rows ``i`` of ``n`` equal slices of every entry (the
    tokens through ``pipe.shard_at``): a data-parallel rank's batch."""
    raw = (pipe.global_batch_at(step) if shard is None
           else pipe.shard_at(step, *shard))
    tokens, labels = raw[:, :-1], raw[:, 1:]
    rng = np.random.default_rng(np.random.SeedSequence([rng_seed, 7, step]))
    act = cfg.activation_dtype
    rows = pipe.global_batch
    out = {"tokens": tokens, "labels": labels}
    feats = {}
    if cfg.family == "vlm":
        s_txt = tokens.shape[1] - cfg.img_tokens
        out = {"tokens": tokens[:, :s_txt], "labels": labels[:, :s_txt]}
        feats["patches"] = _features(rng.standard_normal(
            (rows, cfg.img_tokens, cfg.d_frontend)), act)
    if cfg.family == "audio":
        feats["frames"] = _features(rng.standard_normal(
            (rows, tokens.shape[1], cfg.d_frontend or cfg.d_model)), act)
    for k, x in feats.items():
        if shard is not None:
            per = rows // shard[1]
            x = x[shard[0] * per:(shard[0] + 1) * per]
        out[k] = x
    return _on(out, device)


def _on(batch: dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays and tensors as tensors on ``device``."""
    return {k: (torch.as_tensor(np.ascontiguousarray(v), device=device)
                if isinstance(v, np.ndarray) else v.to(device))
            for k, v in batch.items()}


def _features(draws: np.ndarray, dtype) -> torch.Tensor:
    """``jnp.asarray(draws, dtype) * 0.2``: rounded to the activation dtype
    first, then scaled by 0.2 in that dtype (a weakly typed constant, so
    itself rounded to bf16 in a bf16 batch)."""
    return torch.as_tensor(draws).to(dtype) * torch.tensor(0.2, dtype=dtype)
