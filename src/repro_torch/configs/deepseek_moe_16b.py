"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) expert
d_ff=1408 vocab=102400; 64 routed experts top-6 + 2 shared, first layer
dense (d_ff=10944).  [arXiv:2401.06066; hf]

The router is ``matmul -> topk`` — the paper's DotProdSimPattern; with
``router_offload="cam"`` it runs through the C4CAM search primitive.
long_500k skipped (full attention)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,              # routed expert hidden dim (fine-grained)
    d_expert=1408,
    dense_d_ff=10944,       # layer-0 dense FFN [hf config]
    vocab=102400,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    first_dense_layers=1,
    capacity_factor=1.25,
    rope="standard",
    act="swiglu",
    norm="rmsnorm",
)
