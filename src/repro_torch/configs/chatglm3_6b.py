"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024, 2d (half-rotary) RoPE.  [arXiv:2406.12793; hf]

long_500k skipped (full attention)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    qkv_bias=True,          # chatglm: bias on QKV only
    rope="2d",
    act="swiglu",
    norm="rmsnorm",
)
