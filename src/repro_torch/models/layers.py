"""Shared transformer layers: norms, RoPE variants, GQA attention, FFN.

The port of the reference's ``models/layers.py``.  Parameters are plain
dicts of tensors; weight layout as in the reference: 2-D weights are
(d_in, d_out) and stacked layers get a leading layer axis.  Compute runs
in ``config.compute_dtype`` with float32 logits, softmax and norm
statistics, following every cast of the reference.

Attention goes through :func:`repro_torch.kernels.flash_attention.
flash_attention`: on a CUDA tensor every call launches kernel B7, on a
CPU tensor its plain version runs.  :func:`attn_core` keeps the
reference's name for that plain version.  Left out here: the sharding
hooks (``rules``, ``_constrain_attention_layout``) and the query-chunk
option.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels import flash_attention as fa
from .config import ModelConfig

Params = Dict[str, Any]

__all__ = ["cdtype", "pdtype", "dense_init", "init_norm", "apply_norm",
           "apply_rope", "init_attention", "attention", "attn_core",
           "init_cache", "init_ffn", "ffn", "init_embedding", "embed",
           "logits"]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# init helpers: a torch.Generator takes the place of a key; the scales are
# the reference's, the random numbers are not
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32).to(dtype)
    return w * torch.tensor(1.0 / math.sqrt(d_in), dtype=dtype,
                            device=gen.device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, device, d: Optional[int] = None) -> Params:
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=pdtype(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=pdtype(cfg), device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard, and chatglm-style 2d/partial)
# ---------------------------------------------------------------------------


def _rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    # a Python-scalar base: a 0-dim device tensor would be a blocking
    # host-to-device copy in every layer
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int."""
    if cfg.rope == "none":
        return x
    dh = x.shape[-1]
    rot = dh // 2 if cfg.rope == "2d" else dh      # chatglm rotates half dims
    freqs = _rope_freqs(rot, cfg.rope_theta, x.device)       # (rot/2,)
    ang = positions[..., None].float() * freqs               # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    if rot < dh:
        y = torch.cat([y, x[..., rot:].float()], dim=-1)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA + cache + masks)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, dh, h, kv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = pdtype(cfg)
    p = {"wq": dense_init(gen, d, h * dh, dt),
         "wk": dense_init(gen, d, kv * dh, dt),
         "wv": dense_init(gen, d, kv * dh, dt),
         "wo": dense_init(gen, h * dh, d, dt)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", kv * dh), ("bv", kv * dh)):
            p[name] = torch.zeros((width,), dtype=dt, device=gen.device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def attn_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, prefix_len: int = 0,
              kv_len: Optional[int] = None, q_start: int = 0
              ) -> torch.Tensor:
    """The plain path: q (B, S, H, dh), k/v (B, T, KV, dh) ->
    (B, S, H*dh) in q's dtype, by B7's plain version (the reference's
    chunked ``attn_core``) on any device."""
    b, s, h, dh = q.shape
    out = fa.flash_attention_reference(q, k, v, causal=causal,
                                       prefix_len=prefix_len, kv_len=kv_len,
                                       q_start=q_start)
    return out.reshape(b, s, h * dh)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, prefix_len: int = 0,
              cache: Optional[Dict[str, Any]] = None,
              kv_source: Optional[torch.Tensor] = None, causal: bool = True
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """GQA attention through kernel B7.

    * ``cache``: {"k": (B, S_max, kv, dh), "v": ..., "len": int} — one
      layer's views of the stacked cache.  The new k/v are written at
      rows ``len .. len+S`` in place (the reference's
      ``dynamic_update_slice`` returns a new array instead), and
      attention spans the cache tensor with ``kv_len = len + S`` and
      ``q_start = len``: S > 1 is a prefill, S == 1 a decode step.
      Returns the same tensors with ``len + S``; ``len`` is a host int,
      so the kernel gets ``kv_len`` without a device sync.  A write past
      the cache's ``max_len`` rows raises ``ValueError`` before any row
      is written (the reference's ``dynamic_update_slice`` would clamp
      the start and overwrite the last rows).
    * ``kv_source``: cross-attention source (B, T, D), the encoder
      states: keys and values come from it, with no RoPE and no causal
      mask (still kernel B7).
    * ``prefix_len``: bidirectional prefix (prefix-LM).
    """
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_source is None else kv_source
    q = _proj(x, p["wq"], p.get("bq")).reshape(b, s, h, dh)
    k = _proj(src, p["wk"], p.get("bk")).reshape(b, src.shape[1], kv, dh)
    v = _proj(src, p["wv"], p.get("bv")).reshape(b, src.shape[1], kv, dh)
    if kv_source is None:
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)

    new_cache = None
    kv_len = None
    q_start = 0
    if cache is not None:
        start = cache["len"]
        max_len = cache["k"].shape[1]
        if start + s > max_len:
            raise ValueError(
                f"attention: the KV cache holds len={start} rows and S={s} "
                f"new ones would pass max_len={max_len}")
        cache["k"][:, start:start + s] = k.to(cache["k"].dtype)
        cache["v"][:, start:start + s] = v.to(cache["v"].dtype)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": start + s}
        k, v = cache["k"], cache["v"]
        q_start, kv_len = start, start + s

    out = fa.flash_attention(q, k, v, causal=causal and kv_source is None,
                             prefix_len=prefix_len, kv_len=kv_len,
                             q_start=q_start)
    return _proj(out.reshape(b, s, h * dh), p["wo"]), new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, kv, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, kv, dh), dtype=dtype,
                             device=device),
            "len": 0}


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def init_ffn(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = pdtype(cfg)
    if cfg.act == "swiglu":
        return {"wi": dense_init(gen, d, f, dt),
                "wg": dense_init(gen, d, f, dt),
                "wo": dense_init(gen, f, d, dt)}
    return {"wi": dense_init(gen, d, f, dt), "wo": dense_init(gen, f, d, dt)}


def ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "wg" in p:
        h = torch.nn.functional.silu(x @ p["wi"].to(x.dtype)) * \
            (x @ p["wg"].to(x.dtype))
    else:
        h = torch.nn.functional.gelu(x @ p["wi"].to(x.dtype),
                                     approximate="tanh")
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = pdtype(cfg)
    tok = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                      device=gen.device, dtype=torch.float32).to(dt)
    p = {"tok": tok * 0.02}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab, dt)
    return p


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["tok"][tokens].to(cdtype(cfg))


def logits(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p.get("unembed")
    if w is None:
        w = p["tok"].T
    return (x @ w.to(x.dtype)).float()
