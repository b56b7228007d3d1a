"""Per-family transformer blocks (the port of the reference's
``models/blocks.py``).

``init_<kind>(gen, cfg)`` gives one layer's parameters;
``apply_<kind>(p, x, cfg, *, ...)`` returns ``(x, new_cache_or_state)``.
``<kind>_axes(cfg)`` gives the same tree of logical-axis tuples (see
:mod:`.sharding`; ``model.param_axes`` adds the leading ``"layers"``
axis of a stack).  Residual structure is pre-norm everywhere.  Kinds: the dense decoder
block (dense and vlm families, and the first layers of the moe family),
the MoE block, the Mamba2 block and zamba2's shared attention block (a
dense block whose one set of weights every group reuses), the xLSTM
(mLSTM, sLSTM) pair, the whisper encoder block and the decoder block
with cross-attention.

``rules`` (a :class:`.sharding.ShardingRules`) is optional; with it the
activations at every block boundary are redistributed to the
sequence-parallel layout (:func:`shard_act`), attention pins its layout
and the MoE FFN runs expert-parallel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import mamba2, moe as moe_mod, xlstm
from .config import ModelConfig
from .layers import apply_norm, attention, ffn, init_attention, init_ffn, \
    init_norm

Params = Dict[str, Any]

__all__ = ["NORM_AX", "shard_act", "dense_block_axes", "moe_block_axes",
           "mamba_block_axes", "shared_attn_block_axes", "xlstm_pair_axes",
           "encoder_block_axes", "xdec_block_axes", "init_dense_block", "apply_dense_block", "init_moe_block",
           "apply_moe_block", "init_mamba_block", "apply_mamba_block",
           "init_shared_attn_block", "apply_shared_attn_block",
           "init_xlstm_pair", "apply_xlstm_pair",
           "init_encoder_block", "apply_encoder_block", "init_xdec_block",
           "apply_xdec_block"]


NORM_AX = ("embed_act",)


def _norm_axes(cfg: ModelConfig) -> Params:
    a = {"scale": NORM_AX}
    if cfg.norm == "layernorm":
        a["bias"] = NORM_AX
    return a


def _attn_axes(cfg: ModelConfig) -> Params:
    a = {"wq": ("embed", "qkv_out"), "wk": ("embed", "qkv_out"),
         "wv": ("embed", "qkv_out"), "wo": ("qkv_out", "embed")}
    if cfg.qkv_bias:
        a.update(bq=("qkv_out",), bk=("qkv_out",), bv=("qkv_out",))
    return a


def _ffn_axes(cfg: ModelConfig) -> Params:
    a = {"wi": ("embed", "ffn"), "wo": ("ffn", "embed")}
    if cfg.act == "swiglu":
        a["wg"] = ("embed", "ffn")
    return a


def shard_act(x, rules, spec=("batch", "seq_act", None)):
    """A block-boundary activation in the sequence-parallel layout (the
    reference's ``shard_act``); a no-op without ``rules``."""
    if rules is None:
        return x
    from .sharding import shard_like
    return shard_like(rules, x, spec)


def _in_layer(x, rules):
    """A normed activation gathered over the sequence for the layer's
    products (the reference's in-layer ``"seq"`` axis is replicated)."""
    return shard_act(x, rules, ("batch", "seq", None))


def _out_layer(y, rules):
    """A sublayer's output whose gradient comes back in the in-layer
    layout, whatever layout the residual add picks."""
    if rules is None:
        return y
    from .sharding import grad_layout
    return grad_layout(rules, y, ("batch", "seq", None))


# ---------------------------------------------------------------------------
# dense decoder block (dense family, moe family's first layers)
# ---------------------------------------------------------------------------


def init_dense_block(gen: torch.Generator, cfg: ModelConfig,
                     d_ff: Optional[int] = None) -> Params:
    return {"ln1": init_norm(cfg, gen.device),
            "attn": init_attention(gen, cfg),
            "ln2": init_norm(cfg, gen.device),
            "ffn": init_ffn(gen, cfg, d_ff)}


def dense_block_axes(cfg: ModelConfig) -> Params:
    return {"ln1": _norm_axes(cfg), "attn": _attn_axes(cfg),
            "ln2": _norm_axes(cfg), "ffn": _ffn_axes(cfg)}


def apply_dense_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor, prefix_len: int = 0,
                      cache: Optional[Dict[str, Any]] = None, rules=None
                      ) -> Tuple[torch.Tensor, Any]:
    x = shard_act(x, rules)
    a, new_cache = attention(p["attn"],
                             _in_layer(apply_norm(p["ln1"], x, cfg), rules),
                             cfg, positions=positions, prefix_len=prefix_len,
                             cache=cache, rules=rules)
    x = x + _out_layer(a, rules)
    x = x + _out_layer(ffn(p["ffn"], _in_layer(apply_norm(p["ln2"], x, cfg),
                                               rules), cfg), rules)
    return shard_act(x, rules), new_cache


# ---------------------------------------------------------------------------
# MoE block
# ---------------------------------------------------------------------------


def init_moe_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln1": init_norm(cfg, gen.device),
            "attn": init_attention(gen, cfg),
            "ln2": init_norm(cfg, gen.device),
            "moe": moe_mod.init_moe(gen, cfg)}


def moe_block_axes(cfg: ModelConfig) -> Params:
    ma = {"router": ("embed", None),
          "wi": ("experts", "embed", None), "wg": ("experts", "embed", None),
          "wo": ("experts", None, "embed")}
    if cfg.n_shared_experts:
        ma.update(shared_wi=("embed", "ffn"), shared_wg=("embed", "ffn"),
                  shared_wo=("ffn", "embed"))
    return {"ln1": _norm_axes(cfg), "attn": _attn_axes(cfg),
            "ln2": _norm_axes(cfg), "moe": ma}


def apply_moe_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor,
                    cache: Optional[Dict[str, Any]] = None, rules=None
                    ) -> Tuple[torch.Tensor, Any]:
    x = shard_act(x, rules)
    a, new_cache = attention(p["attn"],
                             _in_layer(apply_norm(p["ln1"], x, cfg), rules),
                             cfg, positions=positions, cache=cache,
                             rules=rules)
    x = x + _out_layer(a, rules)
    x = x + _out_layer(moe_mod.moe_ffn(
        p["moe"], _in_layer(apply_norm(p["ln2"], x, cfg), rules), cfg,
        rules=rules), rules)
    return shard_act(x, rules), new_cache


# ---------------------------------------------------------------------------
# Mamba2 block (zamba2 hybrid)
# ---------------------------------------------------------------------------


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln": init_norm(cfg, gen.device),
            "mamba": mamba2.init_mamba2(gen, cfg)}


def mamba_block_axes(cfg: ModelConfig) -> Params:
    return {"ln": _norm_axes(cfg),
            "mamba": {"in_proj": ("embed", "ssm_inner"),
                      "conv_w": ("conv_k", None),
                      "A_log": (None,), "D": (None,), "dt_bias": (None,),
                      "out_proj": ("ssm_inner", "embed"),
                      "norm_scale": (None,)}}


def apply_mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      state: Optional[Params] = None, rules=None
                      ) -> Tuple[torch.Tensor, Params]:
    x = shard_act(x, rules)
    y, new_state = mamba2.mamba2_forward(p["mamba"],
                                         apply_norm(p["ln"], x, cfg), cfg,
                                         state=state, rules=rules)
    return shard_act(x + y, rules), new_state


# shared attention block (zamba2): full attention + MLP, one set of
# weights for every invocation (the reference's LoRA-free simplification)
init_shared_attn_block = init_dense_block
shared_attn_block_axes = dense_block_axes
apply_shared_attn_block = apply_dense_block


# ---------------------------------------------------------------------------
# xLSTM pair block (mLSTM + sLSTM)
# ---------------------------------------------------------------------------


def init_xlstm_pair(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln_m": init_norm(cfg, gen.device),
            "mlstm": xlstm.init_mlstm(gen, cfg),
            "ln_s": init_norm(cfg, gen.device),
            "slstm": xlstm.init_slstm(gen, cfg)}


def xlstm_pair_axes(cfg: ModelConfig) -> Params:
    return {"ln_m": _norm_axes(cfg),
            "mlstm": {"wq": ("embed", "qkv_out"), "wk": ("embed", "qkv_out"),
                      "wv": ("embed", "qkv_out"), "wif": ("embed", None),
                      "wo": ("qkv_out", "embed"),
                      "ogate": ("embed", "qkv_out")},
            "ln_s": _norm_axes(cfg),
            "slstm": {"wx": ("embed", None), "wh": ("embed", None),
                      "wo": ("embed", "embed")}}


def apply_xlstm_pair(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     state: Optional[Params] = None, rules=None
                     ) -> Tuple[torch.Tensor, Params]:
    x = shard_act(x, rules)
    sm = None if state is None else state["mlstm"]
    ym, new_m = xlstm.mlstm_forward(p["mlstm"], apply_norm(p["ln_m"], x, cfg),
                                    cfg, state=sm, rules=rules)
    x = x + ym
    ss = None if state is None else state["slstm"]
    ys, new_s = xlstm.slstm_forward(p["slstm"], apply_norm(p["ln_s"], x, cfg),
                                    cfg, state=ss, rules=rules)
    return shard_act(x + ys, rules), {"mlstm": new_m, "slstm": new_s}


# ---------------------------------------------------------------------------
# encoder block (whisper encoder: bidirectional self-attention + FFN)
# ---------------------------------------------------------------------------


init_encoder_block = init_dense_block
encoder_block_axes = dense_block_axes


def apply_encoder_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                        positions: torch.Tensor, rules=None
                        ) -> Tuple[torch.Tensor, None]:
    x = shard_act(x, rules)
    a, _ = attention(p["attn"], _in_layer(apply_norm(p["ln1"], x, cfg),
                                          rules),
                     cfg, positions=positions, causal=False, rules=rules)
    x = x + _out_layer(a, rules)
    x = x + _out_layer(ffn(p["ffn"], _in_layer(apply_norm(p["ln2"], x, cfg),
                                               rules), cfg), rules)
    return shard_act(x, rules), None


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


def xdec_block_axes(cfg: ModelConfig) -> Params:
    return {"ln1": _norm_axes(cfg), "self": _attn_axes(cfg),
            "ln2": _norm_axes(cfg), "cross": _attn_axes(cfg),
            "ln3": _norm_axes(cfg), "ffn": _ffn_axes(cfg)}


def apply_xdec_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     positions: torch.Tensor, enc: torch.Tensor,
                     cache: Optional[Params] = None, rules=None
                     ) -> Tuple[torch.Tensor, Optional[Params]]:
    """``cache``: {"self": one layer's attention cache}; the cross keys
    and values come from ``enc`` (the model's stack reads them from its
    cache instead)."""
    x = shard_act(x, rules)
    a, new_self = attention(p["self"],
                            _in_layer(apply_norm(p["ln1"], x, cfg), rules),
                            cfg, positions=positions,
                            cache=None if cache is None else cache["self"],
                            rules=rules)
    x = x + _out_layer(a, rules)
    c, _ = attention(p["cross"],
                     _in_layer(apply_norm(p["ln2"], x, cfg), rules), cfg,
                     positions=positions, kv_source=enc, rules=rules)
    x = x + _out_layer(c, rules)
    x = x + _out_layer(ffn(p["ffn"], _in_layer(apply_norm(p["ln3"], x, cfg),
                                               rules), cfg), rules)
    return shard_act(x, rules), None if cache is None else {"self": new_self}
