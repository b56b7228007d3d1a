"""Transformer blocks: the dense decoder block (the port of the
reference's ``models/blocks.py``, dense part).

``init_dense_block(gen, cfg)`` gives one layer's parameters;
``apply_dense_block(p, x, cfg, *, ...)`` returns ``(x, new_cache)``.
Residual structure is pre-norm.  The MoE, Mamba2, xLSTM, encoder and
cross-attention blocks come with their families (ROADMAP Queue A item
8).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .config import ModelConfig
from .layers import apply_norm, attention, ffn, init_attention, init_ffn, \
    init_norm

Params = Dict[str, Any]

__all__ = ["init_dense_block", "apply_dense_block"]


def init_dense_block(gen: torch.Generator, cfg: ModelConfig,
                     d_ff: Optional[int] = None) -> Params:
    return {"ln1": init_norm(cfg, gen.device),
            "attn": init_attention(gen, cfg),
            "ln2": init_norm(cfg, gen.device),
            "ffn": init_ffn(gen, cfg, d_ff)}


def apply_dense_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor, prefix_len: int = 0,
                      cache: Optional[Dict[str, Any]] = None
                      ) -> Tuple[torch.Tensor, Any]:
    a, new_cache = attention(p["attn"], apply_norm(p["ln1"], x, cfg), cfg,
                             positions=positions, prefix_len=prefix_len,
                             cache=cache)
    x = x + a
    x = x + ffn(p["ffn"], apply_norm(p["ln2"], x, cfg), cfg)
    return x, new_cache
