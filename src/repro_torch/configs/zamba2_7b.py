"""zamba2-7b [hybrid] 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks
[arXiv:2411.15242; unverified].

81 Mamba2 layers; ONE shared attention+MLP block (a single weight set)
applied after every 6th Mamba layer — Zamba's parameter-sharing design.
SSM majority makes long_500k decode O(1)-state (runs)."""
from .base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab_size=32000,
    ssm=SSMCfg(d_state=64, head_dim=64, expand=2, chunk=128),
    hybrid_attn_every=6, norm="rmsnorm", act="swiglu",
    attn_impl="block_masked", sub_quadratic=True,
)

SMOKE = CONFIG.replace(
    name="zamba2-7b-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=512,
    ssm=SSMCfg(d_state=16, head_dim=16, expand=2, chunk=8),
    hybrid_attn_every=2, attn_block=16, dtype="float32", remat="none",
)
