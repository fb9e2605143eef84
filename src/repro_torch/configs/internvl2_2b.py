"""internvl2-2b [vlm] 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT + InternLM2  [arXiv:2404.16821; hf].

Backbone only: the InternViT frontend is a STUB (input_specs provides
precomputed patch embeddings, 256 tokens x d_frontend=1024).  The image
prefix is bidirectional within itself -> a dense-prefix block mask, the
general structured-mask path of the paper's technique."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab_size=92553,
    img_tokens=256, d_frontend=1024, rope_theta=1000000.0,
    norm="rmsnorm", act="swiglu", attn_impl="block_masked",
    sub_quadratic=False,
)

SMOKE = CONFIG.replace(
    name="internvl2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, img_tokens=16, d_frontend=32,
    attn_block=16, dtype="float32", remat="none",
)
