"""seamless-m4t-large-v2 [audio] 24L d_model=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206 — enc-dec, multimodal  [arXiv:2308.11596; hf].

Backbone only: 24 encoder + 24 decoder layers; the speech frontend is a
STUB (input_specs provides precomputed frame embeddings, d_frontend=1024).
Encoder attention is bidirectional (mask fully dense -> plain-product fast
path); decoder self-attention is causal block-masked; cross-attention dense.
Encoder-only part has no decode; decode shapes exercise the decoder."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio", n_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192, vocab_size=256206,
    enc_dec=True, n_enc_layers=24, n_dec_layers=24, d_frontend=1024,
    norm="layernorm", act="gelu", attn_impl="block_masked",
    sub_quadratic=False,
)

SMOKE = CONFIG.replace(
    name="seamless-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, n_enc_layers=2, n_dec_layers=2,
    d_frontend=32, attn_block=16, dtype="float32", remat="none",
)
