"""whisper-medium [audio] — enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H (kv=16) d_ff=4096 vocab=51865; conv frontend STUB
(``input_specs()`` provides 1500 precomputed frame embeddings).
[arXiv:2212.04356; unverified]

vocab 51865 is odd -> the vocab axis falls back to replicated under the
16-way model axis (sharding rule fallback).  Decode shapes exercise the
*decoder* with self+cross attention; long_500k skipped (full attention).
Sinusoidal positions stand in for whisper's learned decoder positions."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,            # decoder layers
    n_encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    qkv_bias=True,          # whisper uses biases
    rope="none",
    act="gelu",
    norm="layernorm",
)
