"""moonshot-v1-16b-a3b [moe] 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 — kimi/moonlight
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from .base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=5632, vocab_size=163840,
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408,
               router_scale=True),
    first_k_dense=1, norm="rmsnorm", act="swiglu",
    attn_impl="block_masked", sub_quadratic=False,
)

SMOKE = CONFIG.replace(
    name="moonshot-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=512,
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32, router_scale=True),
    first_k_dense=1, attn_block=16, dtype="float32", remat="none",
)
