"""paligemma-3b [vlm] — gemma-2b decoder: 18L d_model=2048 8H (MQA kv=1)
d_ff=16384 vocab=257216 + SigLIP vision tower (STUB: ``input_specs()``
provides 256 precomputed patch embeddings; prefix-LM mask over the vision
prefix).  [arXiv:2407.07726; hf]

long_500k skipped (full attention)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,             # gemma: head_dim 256 (8*256 = 2048)
    d_ff=16384,
    vocab=257216,
    n_vision_tokens=256,
    rope="standard",
    act="gelu",             # gemma uses gelu (geglu folded to gelu MLP)
    norm="rmsnorm",
    tie_embeddings=True,    # gemma ties input/output embeddings
)
