"""llama3.2-3b [dense] 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256  [hf:meta-llama/Llama-3.2-3B; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab_size=128256,
    rope_theta=500000.0, norm="rmsnorm", act="swiglu",
    attn_impl="block_masked", sub_quadratic=False,
)

SMOKE = CONFIG.replace(
    name="llama3.2-3b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, attn_block=16,
    dtype="float32", remat="none",
)
