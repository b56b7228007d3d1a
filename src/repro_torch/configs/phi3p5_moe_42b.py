"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8)
expert d_ff=6400 vocab=32064; 16 experts top-2, no shared experts, all
layers MoE.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]

long_500k skipped (full attention)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    d_expert=6400,
    vocab=32064,
    n_experts=16,
    n_shared_experts=0,
    moe_top_k=2,
    first_dense_layers=0,
    capacity_factor=1.25,
    rope="standard",
    act="swiglu",
    norm="layernorm",       # phi3.5 uses LayerNorm
)
