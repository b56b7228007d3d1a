"""xlstm-125m [ssm] — 12L d_model=768 4H vocab=50304, alternating
sLSTM + mLSTM blocks.  [arXiv:2405.04517; unverified]

d_ff=0 per assignment: blocks are pure mixers (no separate FFN; the
released model's pre/post up-projections are folded away — DESIGN.md).
O(S) sequence mixing -> runs long_500k."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_every=2,
    rope="standard",        # unused (no attention); avoids abs-pos stub
    act="gelu",
    norm="layernorm",
)
