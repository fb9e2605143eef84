"""deepseek-v2-lite-16b [moe] 27L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6, MLA kv_lora=512, 2 shared experts
[arXiv:2405.04434; hf].

(The assignment line mentions both "64e" and "160 routed"; DeepSeek-V2-Lite
ground truth is 64 routed + 2 shared, top-6 — we follow 64e.)  First layer
uses a dense FFN (d_ff=10944) per the HF config; expert FFN d_ff=1408."""
from .base import ModelConfig, MoECfg, MLACfg

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=10944, vocab_size=102400,
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
               d_ff_shared=1408, router_scale=True),
    mla=MLACfg(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
               v_head_dim=128),
    first_k_dense=1, norm="rmsnorm", act="swiglu",
    attn_impl="block_masked", sub_quadratic=False,
)

SMOKE = CONFIG.replace(
    name="deepseek-v2-lite-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=512,
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
               d_ff_shared=32, router_scale=True),
    mla=MLACfg(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
               v_head_dim=16),
    first_k_dense=1, attn_block=16, dtype="float32", remat="none",
)
