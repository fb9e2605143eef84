"""Architecture config schema + registry (a copy of the reference's
``repro/configs/base.py`` with every field, so later configs port verbatim).

The shape grid (``ShapeCfg``, ``SHAPES``, ``cell_is_runnable``) is the
reference's too.  One ``<arch>.py`` per architecture defines ``CONFIG``
(exact published numbers) and ``SMOKE`` (a reduced same-family config for
CPU tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    router_scale: bool = False       # normalize top-k weights
    ep: bool = True                  # expert-parallel shard_map path when a
                                     # mesh with a "model" axis is ambient
    capacity_factor: float = 1.5     # EP per-rank capacity vs perfect balance


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    slstm_every: int = 8             # one sLSTM block per this many layers
    head_dim: int = 0                # 0 -> d_model // n_heads
    proj_factor: float = 2.0         # mLSTM up-projection
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # attention / mask pattern (the paper's technique parameters)
    attn_impl: str = "block_masked"  # dense_masked | block_masked | flash_pallas
    attn_block: int = 128
    kv_replicated: bool = False      # replicate wk/wv + K/V activations:
                                     # kills per-layer KV all-gathers when
                                     # n_kv_heads < TP (see §Perf)
    window: int = 0                  # sliding window; 0 = full
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # family extensions
    moe: Optional[MoECfg] = None
    first_k_dense: int = 0           # leading dense-FFN layers in MoE stacks
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid_attn_every: int = 0       # zamba2: shared attn block cadence
    xlstm: Optional[XLSTMCfg] = None
    # enc-dec
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # vlm
    img_tokens: int = 0
    d_frontend: int = 0
    # numerics / scale
    dtype: str = "bfloat16"
    remat: str = "full"              # none | dots | full
    sub_quadratic: bool = False      # supports long_500k decode
    max_seq: int = 8192

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# shape grid (the reference's): every LM arch x these four shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "llama3_2_3b", "llama3_2_1b", "stablelm_3b", "starcoder2_7b",
    "xlstm_1_3b", "zamba2_7b", "moonshot_v1_16b_a3b", "deepseek_v2_lite_16b",
    "seamless_m4t_large_v2", "internvl2_2b",
)

# public --arch ids (hyphenated) -> module names
ARCH_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ARCH_ALIASES.update({
    "llama3.2-3b": "llama3_2_3b",
    "llama3.2-1b": "llama3_2_1b",
    "xlstm-1.3b": "xlstm_1_3b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
})


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod_name = ARCH_ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.CONFIG


def cell_is_runnable(cfg: ModelConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """Whether (arch x shape) is a defined cell (spec rules)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k decode requires "
                       "sub-quadratic attention (skip noted in DESIGN.md)")
    return True, ""
