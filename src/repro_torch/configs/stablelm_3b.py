"""stablelm-3b [dense] 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304  [hf:stabilityai/stablelm-2-1_6b family; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=6912, vocab_size=50304,
    norm="layernorm", act="swiglu", qkv_bias=True,
    attn_impl="block_masked", sub_quadratic=False,
)

SMOKE = CONFIG.replace(
    name="stablelm-3b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=160, vocab_size=512, attn_block=16,
    dtype="float32", remat="none",
)
