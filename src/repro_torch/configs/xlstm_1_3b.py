"""xlstm-1.3b [ssm] 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks  [arXiv:2405.04517; unverified].

48 layers in super-blocks of (7 mLSTM + 1 sLSTM); chunkwise-parallel mLSTM
training path, O(1)-state decode (long_500k runs)."""
from .base import ModelConfig, XLSTMCfg

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
    xlstm=XLSTMCfg(slstm_every=8, head_dim=512, chunk=64),
    norm="rmsnorm", sub_quadratic=True,
)

SMOKE = CONFIG.replace(
    name="xlstm-1.3b-smoke", n_layers=4, d_model=64, n_heads=2,
    n_kv_heads=2, vocab_size=512,
    xlstm=XLSTMCfg(slstm_every=2, head_dim=32, chunk=8),
    dtype="float32", remat="none",
)
