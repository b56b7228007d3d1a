"""Per-family transformer blocks (the port of the reference's
``models/blocks.py``).

``init_<kind>(gen, cfg)`` gives one layer's parameters;
``apply_<kind>(p, x, cfg, *, ...)`` returns ``(x, new_cache_or_state)``.
Residual structure is pre-norm everywhere.  Kinds: the dense decoder
block (dense and vlm families, and the first layers of the moe family),
the MoE block, the Mamba2 block and zamba2's shared attention block (a
dense block whose one set of weights every group reuses), the xLSTM
(mLSTM, sLSTM) pair, the whisper encoder block and the decoder block
with cross-attention.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import mamba2, moe as moe_mod, xlstm
from .config import ModelConfig
from .layers import apply_norm, attention, ffn, init_attention, init_ffn, \
    init_norm

Params = Dict[str, Any]

__all__ = ["init_dense_block", "apply_dense_block", "init_moe_block",
           "apply_moe_block", "init_mamba_block", "apply_mamba_block",
           "init_shared_attn_block", "apply_shared_attn_block",
           "init_xlstm_pair", "apply_xlstm_pair",
           "init_encoder_block", "apply_encoder_block", "init_xdec_block",
           "apply_xdec_block"]


# ---------------------------------------------------------------------------
# dense decoder block (dense family, moe family's first layers)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# MoE block
# ---------------------------------------------------------------------------


def init_moe_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln1": init_norm(cfg, gen.device),
            "attn": init_attention(gen, cfg),
            "ln2": init_norm(cfg, gen.device),
            "moe": moe_mod.init_moe(gen, cfg)}


def apply_moe_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor,
                    cache: Optional[Dict[str, Any]] = None
                    ) -> Tuple[torch.Tensor, Any]:
    a, new_cache = attention(p["attn"], apply_norm(p["ln1"], x, cfg), cfg,
                             positions=positions, cache=cache)
    x = x + a
    x = x + moe_mod.moe_ffn(p["moe"], apply_norm(p["ln2"], x, cfg), cfg)
    return x, new_cache


# ---------------------------------------------------------------------------
# Mamba2 block (zamba2 hybrid)
# ---------------------------------------------------------------------------


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln": init_norm(cfg, gen.device),
            "mamba": mamba2.init_mamba2(gen, cfg)}


def apply_mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      state: Optional[Params] = None
                      ) -> Tuple[torch.Tensor, Params]:
    y, new_state = mamba2.mamba2_forward(p["mamba"],
                                         apply_norm(p["ln"], x, cfg), cfg,
                                         state=state)
    return x + y, new_state


# shared attention block (zamba2): full attention + MLP, one set of
# weights for every invocation (the reference's LoRA-free simplification)
init_shared_attn_block = init_dense_block
apply_shared_attn_block = apply_dense_block


# ---------------------------------------------------------------------------
# xLSTM pair block (mLSTM + sLSTM)
# ---------------------------------------------------------------------------


def init_xlstm_pair(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln_m": init_norm(cfg, gen.device),
            "mlstm": xlstm.init_mlstm(gen, cfg),
            "ln_s": init_norm(cfg, gen.device),
            "slstm": xlstm.init_slstm(gen, cfg)}


def apply_xlstm_pair(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     state: Optional[Params] = None
                     ) -> Tuple[torch.Tensor, Params]:
    sm = None if state is None else state["mlstm"]
    ym, new_m = xlstm.mlstm_forward(p["mlstm"], apply_norm(p["ln_m"], x, cfg),
                                    cfg, state=sm)
    x = x + ym
    ss = None if state is None else state["slstm"]
    ys, new_s = xlstm.slstm_forward(p["slstm"], apply_norm(p["ln_s"], x, cfg),
                                    cfg, state=ss)
    return x + ys, {"mlstm": new_m, "slstm": new_s}


# ---------------------------------------------------------------------------
# encoder block (whisper encoder: bidirectional self-attention + FFN)
# ---------------------------------------------------------------------------


init_encoder_block = init_dense_block


def apply_encoder_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                        positions: torch.Tensor) -> Tuple[torch.Tensor, None]:
    a, _ = attention(p["attn"], apply_norm(p["ln1"], x, cfg), cfg,
                     positions=positions, causal=False)
    x = x + a
    x = x + ffn(p["ffn"], apply_norm(p["ln2"], x, cfg), cfg)
    return x, None


# ---------------------------------------------------------------------------
# decoder block with cross-attention (whisper decoder)
# ---------------------------------------------------------------------------


def init_xdec_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln1": init_norm(cfg, gen.device),
            "self": init_attention(gen, cfg),
            "ln2": init_norm(cfg, gen.device),
            "cross": init_attention(gen, cfg),
            "ln3": init_norm(cfg, gen.device),
            "ffn": init_ffn(gen, cfg)}


def apply_xdec_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     positions: torch.Tensor, enc: torch.Tensor,
                     cache: Optional[Params] = None
                     ) -> Tuple[torch.Tensor, Optional[Params]]:
    """``cache``: {"self": one layer's attention cache}; the cross keys
    and values come from ``enc`` (the model's stack reads them from its
    cache instead)."""
    a, new_self = attention(p["self"], apply_norm(p["ln1"], x, cfg), cfg,
                            positions=positions,
                            cache=None if cache is None else cache["self"])
    x = x + a
    c, _ = attention(p["cross"], apply_norm(p["ln2"], x, cfg), cfg,
                     positions=positions, kv_source=enc)
    x = x + c
    x = x + ffn(p["ffn"], apply_norm(p["ln3"], x, cfg), cfg)
    return x, None if cache is None else {"self": new_self}
