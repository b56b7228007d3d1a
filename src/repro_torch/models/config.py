"""Model configuration for the assigned architecture pool.

One :class:`ModelConfig` describes any of the supported families:

* ``dense``  — pre-norm decoder-only transformer (GQA, RoPE, SwiGLU/GELU)
* ``moe``    — dense backbone with mixture-of-experts FFN layers
* ``hybrid`` — Mamba2 blocks + periodically-invoked shared attention block
  (zamba2 style)
* ``ssm``    — alternating mLSTM/sLSTM blocks (xLSTM style)
* ``vlm``    — decoder backbone consuming [patch embeddings; tokens] with a
  prefix-LM mask (PaliGemma style; vision tower is a stub per assignment)
* ``audio``  — encoder-decoder (Whisper style; conv frontend is a stub:
  inputs are precomputed frame embeddings)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

__all__ = ["ModelConfig", "reduced"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                   # 0 -> d_model // n_heads
    # attention details
    qkv_bias: bool = False
    rope: str = "standard"            # standard | 2d | none
    rope_theta: float = 10000.0
    act: str = "swiglu"               # swiglu | gelu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0                 # expert hidden dim (fine-grained MoE)
    capacity_factor: float = 1.25
    first_dense_layers: int = 1       # deepseek: layer 0 is dense FFN
    dense_d_ff: int = 0               # FFN width of the first dense layers
    router_offload: str = "dense"     # dense | cam  (C4CAM top-k integration)
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    shared_attn_every: int = 6        # zamba2: shared block period
    # xLSTM
    slstm_every: int = 2              # alternate mLSTM/sLSTM
    # enc-dec (audio)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500           # whisper frame count after conv stub
    # vlm
    n_vision_tokens: int = 256        # paligemma patch tokens (stub)
    # numerics: params live in bf16 (the AdamW fp32 master copy carries
    # precision); compute in bf16 with fp32 softmax/norms/logits.
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # remat policy for train_step: none | full | dots
    remat: str = "full"

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_enc_dec(self) -> bool:
        return self.family == "audio"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> long_500k shape runs."""
        return self.family in ("hybrid", "ssm")

    @property
    def moe_layer(self) -> bool:
        return self.family == "moe"

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        emb = self.vocab * d
        attn = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
        if self.family == "ssm":
            # mLSTM/sLSTM projections
            blk = 4 * d * d + 2 * d * self.d_ff if self.d_ff else 6 * d * d
            return emb + self.n_layers * blk
        if self.family == "hybrid":
            d_inner = self.ssm_expand * d
            mamba = d * (2 * d_inner + 2 * self.ssm_state) + d_inner * d
            shared = attn + 3 * d * self.d_ff
            n_shared = max(1, self.n_layers // self.shared_attn_every)
            return emb + self.n_layers * mamba + shared  # shared weights reused
        ff_mult = 3 if self.act == "swiglu" else 2
        dense_ff = ff_mult * d * self.d_ff
        if self.family == "moe":
            de = self.d_expert or self.d_ff
            moe_ff = (self.n_experts + self.n_shared_experts) * ff_mult * d * de \
                + d * self.n_experts
            n_moe = self.n_layers - self.first_dense_layers
            return emb + self.n_layers * attn + n_moe * moe_ff \
                + self.first_dense_layers * dense_ff
        layers = self.n_layers + self.n_encoder_layers
        extra = attn * self.n_encoder_layers if self.is_enc_dec else 0  # cross-attn
        return emb + layers * (attn + dense_ff) + extra

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        de = self.d_expert or self.d_ff
        ff_mult = 3 if self.act == "swiglu" else 2
        total = self.param_count()
        all_experts = self.n_experts * ff_mult * d * de
        active = (self.moe_top_k + self.n_shared_experts) * ff_mult * d * de
        n_moe = self.n_layers - self.first_dense_layers
        return total - n_moe * (all_experts - self.moe_top_k * ff_mult * d * de) \
            - 0  # shared experts always active


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 64,
            n_heads: int = 4, d_ff: int = 128, vocab: int = 256,
            n_experts: Optional[int] = None) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    kv = max(1, min(cfg.n_kv_heads * n_heads // max(cfg.n_heads, 1), n_heads))
    upd = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=kv, d_ff=d_ff, vocab=vocab, d_head=0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        shared_attn_every=1 if cfg.family == "hybrid" else cfg.shared_attn_every,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_seq=16 if cfg.is_enc_dec else cfg.encoder_seq,
        n_vision_tokens=8 if cfg.family == "vlm" else cfg.n_vision_tokens,
        first_dense_layers=min(cfg.first_dense_layers, 1),
        remat="none",
    )
    if cfg.family == "moe":
        ne = n_experts if n_experts is not None else min(cfg.n_experts, 8)
        upd.update(n_experts=ne, moe_top_k=min(cfg.moe_top_k, 2),
                   n_shared_experts=min(cfg.n_shared_experts, 1),
                   d_expert=32 if cfg.d_expert else 0,
                   dense_d_ff=d_ff if cfg.dense_d_ff else 0,
                   capacity_factor=2.0)
    return replace(cfg, **upd)
