"""Model assembly (the port of the reference's ``models/model.py``).

The dense family (decoder-only, identical pre-norm blocks) runs here;
``init_params``, ``init_decode_cache`` and the three entry points raise
``NotImplementedError`` for the others (moe, hybrid, ssm, vlm, audio),
which come with ROADMAP Queue A item 12.  Layer stacks keep the
reference's stacked ``(n_layers, ...)`` tensors, so a layer is a view
and ``convert.lm_params_from_reference`` is a tree map; the reference's
``lax.scan`` over layers is a Python loop.

Three public entry points:

* ``forward(params, cfg, batch)``              -> logits (teacher forcing)
* ``prefill(params, cfg, batch, cache)``       -> (last logits, cache)
* ``decode_step(params, cfg, tokens, cache)``  -> (logits, cache)

A cache is ``{"k": (n_layers, B, S_max, KV, dh), "v": ..., "len": int}``
in bfloat16 (the reference's cache dtype, whatever the compute dtype).
``prefill`` and ``decode_step`` write the new rows into its tensors in
place and return them with the new ``len``, a host int, so that no step
reads the device to learn the cache length.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core.engine.base import resolve_device
from . import blocks
from .config import ModelConfig
from .layers import apply_norm, embed, init_embedding, init_norm, \
    logits as unembed_logits

Params = Dict[str, Any]

__all__ = ["init_params", "init_decode_cache", "forward", "prefill",
           "decode_step"]


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue A item 12); the port runs the dense family")
    if cfg.rope == "none":
        raise NotImplementedError(
            f"{cfg.name}: absolute (sinusoidal) positions come with the "
            f"audio family (ROADMAP Queue A item 12)")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack_init(init_fn: Callable[[], Params], n: int) -> Params:
    """``n`` calls of a one-layer init, written into stacked (n, ...)
    tensors allocated once (the reference vmaps the init over n keys)."""
    first = init_fn()

    def alloc(t):
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        out[0] = t
        return out

    stacked = _tree_map(alloc, first)
    for i in range(1, n):
        _copy_layer(stacked, init_fn(), i)
    return stacked


def _copy_layer(stacked: Params, layer: Params, i: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_layer(stacked[k], v, i)
        else:
            stacked[k][i] = v


def _layer(stack: Params, i: int) -> Params:
    return _tree_map(lambda t: t[i], stack)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default: the current CUDA device; raises without CUDA)."""
    _require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p: Params = {"embed": init_embedding(gen, cfg),
                 "final_norm": init_norm(cfg, dev)}
    p["blocks"] = _stack_init(lambda: blocks.init_dense_block(gen, cfg),
                              cfg.n_layers)
    return p


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------


def _attn_cache(cfg: ModelConfig, n_layers: int, b: int, m: int, device,
                dtype: torch.dtype = torch.bfloat16) -> Params:
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    shape = (n_layers, b, m, kv, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": 0}


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None) -> Params:
    _require_dense(cfg)
    return _attn_cache(cfg, cfg.n_layers, batch, max_len,
                       resolve_device(device))


# ---------------------------------------------------------------------------
# the block stack
# ---------------------------------------------------------------------------


def _run_dense_stack(stack: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     positions: torch.Tensor, prefix_len: int = 0,
                     cache: Optional[Params] = None
                     ) -> Tuple[torch.Tensor, Optional[Params]]:
    """The blocks in order, each with its layer of the cache."""
    ln = 0 if cache is None else cache["len"]
    for i in range(stack["ln1"]["scale"].shape[0]):
        cache_l = None if cache is None else \
            {"k": cache["k"][i], "v": cache["v"][i], "len": ln}
        x, _ = blocks.apply_dense_block(_layer(stack, i), x, cfg,
                                        positions=positions,
                                        prefix_len=prefix_len, cache=cache_l)
    if cache is None:
        return x, None
    return x, {"k": cache["k"], "v": cache["v"], "len": ln + x.shape[1]}


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _positions(start: int, b: int, s: int, device) -> torch.Tensor:
    return torch.arange(start, start + s, device=device).expand(b, s)


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence float32 logits (teacher forcing);
    ``batch["tokens"]``: (B, S)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions(0, b, s, tokens.device)
    x = embed(params["embed"], tokens, cfg)
    x, _ = _run_dense_stack(params["blocks"], x, cfg, positions=positions)
    x = apply_norm(params["final_norm"], x, cfg)
    return unembed_logits(params["embed"], x, cfg)


def prefill(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], cache: Params
            ) -> Tuple[torch.Tensor, Params]:
    """Prefill an empty cache with ``batch["tokens"]`` (B, S); returns
    the last position's logits (B, 1, V) and the cache."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions(0, b, s, tokens.device)
    x = embed(params["embed"], tokens, cfg)
    x, cache = _run_dense_stack(params["blocks"], x, cfg,
                                positions=positions, cache=cache)
    x = apply_norm(params["final_norm"], x[:, -1:], cfg)
    return unembed_logits(params["embed"], x, cfg), cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) -> logits (B, 1, V), cache."""
    _require_dense(cfg)
    b, s = tokens.shape
    positions = _positions(cache["len"], b, s, tokens.device)
    x = embed(params["embed"], tokens, cfg)
    x, cache = _run_dense_stack(params["blocks"], x, cfg,
                                positions=positions, cache=cache)
    x = apply_norm(params["final_norm"], x, cfg)
    return unembed_logits(params["embed"], x, cfg), cache
