"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]

40 heads do not divide the 16-way model axis: attention falls back to
replicated heads (FFN/vocab stay TP) — this makes qwen a §Perf hillclimb
target.  long_500k skipped (full attention)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    rope="standard",
    rope_theta=1000000.0,
    act="swiglu",
    norm="rmsnorm",
)
