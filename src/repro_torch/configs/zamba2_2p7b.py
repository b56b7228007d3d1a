"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.

54L d_model=2560 32H (kv=32) shared-block d_ff=10240 vocab=32000
ssm_state=64.  [arXiv:2411.15242; hf]

Zamba2's single shared transformer block (full attention + MLP) is invoked
every 6 Mamba2 blocks with *shared* weights; the per-invocation LoRA
adapters of the released model are omitted (see DESIGN.md deviations).
Sub-quadratic sequence mixing -> runs the long_500k shape.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    shared_attn_every=6,
    rope="standard",
    act="gelu",            # zamba2 shared MLP uses gelu
    norm="rmsnorm",
)
