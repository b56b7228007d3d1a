"""qwen1.5-32b [dense] — 64L d_model=5120 40H (MHA kv=40) d_ff=27392
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]

long_500k skipped (full attention)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    rope="standard",
    act="swiglu",
    norm="rmsnorm",
)
