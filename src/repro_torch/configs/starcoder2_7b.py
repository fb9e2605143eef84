"""starcoder2-7b [dense] 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE, 4k sliding window  [arXiv:2402.19173; hf].

The sliding window makes its attention mask a banded block-sparse mask —
the paper's technique gives the full S/W saving here, and long_500k decode
is sub-quadratic (ring-buffered cache of one window)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
    n_heads=36, n_kv_heads=4, d_ff=18432, vocab_size=49152,
    window=4096, norm="layernorm", act="gelu", qkv_bias=True,
    rope_theta=100000.0, attn_impl="block_masked", sub_quadratic=True,
)

SMOKE = CONFIG.replace(
    name="starcoder2-7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=512, window=32, attn_block=16,
    dtype="float32", remat="none",
)
