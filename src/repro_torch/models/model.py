"""Model assembly (the port of the reference's ``models/model.py``).

Families (``cfg.family``):

* ``dense``  — decoder-only: identical pre-norm blocks.
* ``moe``    — ``first_dense_layers`` dense blocks, then MoE blocks (the
  router on kernel B2 with ``router_offload="cam"``; expert-parallel
  under ``rules``).
* ``hybrid`` — zamba2: groups of ``shared_attn_every`` Mamba2 blocks,
  each group preceded by the ONE shared attention block (its weights
  reused by every group; the per-invocation LoRA is omitted, as in the
  reference).  ``ceil(n_layers / per) * per`` Mamba2 blocks, as the
  reference builds them.
* ``ssm``    — xLSTM: (mLSTM, sLSTM) pair blocks; no attention.
* ``vlm``    — PaliGemma: [vision patch embeddings; text] through dense
  blocks with a prefix-LM mask over the ``n_vision_tokens`` vision rows;
  the vision tower is a stub (the inputs are precomputed embeddings).
* ``audio``  — whisper: an encoder over precomputed frame embeddings,
  then a decoder with self- and cross-attention.

Another family raises ``ValueError``, as the reference's ``init_params``
does.  Layer stacks keep the reference's stacked ``(n_layers, ...)``
tensors, so a layer is a view and ``convert.lm_params_from_reference``
is a tree map; the reference's ``lax.scan`` over layers is a Python
loop.

Three public entry points:

* ``forward(params, cfg, batch[, train, return_hidden])`` -> logits
  (teacher forcing), or the post-final-norm hidden state; with
  ``train=True`` each layer body is checkpointed as ``cfg.remat`` asks
  (the reference's ``_maybe_remat``: ``"full"`` recomputes the whole body
  in the backward, ``"dots"`` keeps the matrix products' outputs)
* ``prefill(params, cfg, batch, cache)``       -> (last logits, cache)
* ``decode_step(params, cfg, tokens, cache)``  -> (logits, cache)

Each takes ``rules`` (a :class:`.sharding.ShardingRules`): with DTensor
parameters, batch and cache (placed by ``param_axes`` / ``cache_axes``
and the rules) it runs sharded, block-boundary activations in the
sequence-parallel layout and the sequence gathered inside each layer
and before the unembedding, and returns DTensors.

``batch`` holds ``"tokens"`` (B, S), for vlm ``"vision"`` (B,
n_vision_tokens, d_model) and for audio ``"frames"`` (B, encoder_seq,
d_model).  An attention cache is ``{"k": (n_layers, B, S_max, KV, dh),
"v": ..., "len": int}`` in bfloat16 (the reference's cache dtype,
whatever the compute dtype); vlm's has ``max_len + n_vision_tokens``
rows and its ``len`` counts the vision rows; audio's is ``{"self":
that, "cross": {"k": (n_layers, B, encoder_seq, KV, dh), "v": ...}}``,
whose cross keys and values ``prefill`` computes once, in the compute
dtype, as the reference does; hybrid's is ``{"attn": one layer per
group, "mamba": {"ssm": (groups, per, B, heads, dh, d_state) float32,
"conv": (groups, per, B, K - 1, d_inner + 2 d_state) bfloat16}}``,
whose conv states come back in the compute dtype, as the reference's
do; ssm's holds the float32 recurrent states of each pair.  ``prefill``
and ``decode_step`` write the new rows (or states) into the cache
tensors in place and return them with the new ``len``, a host int, so
that no step reads the device to learn the cache length.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from ..core.engine.base import resolve_device
from ..kernels import flash_attention as fa
from . import blocks, mamba2, xlstm
from .blocks import shard_act
from .config import ModelConfig
from .layers import _flat_heads, _heads, _proj, _sharded_attention, \
    apply_norm, attention, cdtype, embed, ffn, init_embedding, init_norm, \
    check_rows, logits as unembed_logits
from .sharding import is_dtensor, set_block

Params = Dict[str, Any]

__all__ = ["init_params", "param_axes", "init_decode_cache", "cache_axes",
           "forward", "prefill", "decode_step"]


_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")


def _family(cfg: ModelConfig) -> str:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    return cfg.family


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
    del first
    for i in range(1, n):
        _copy_layer(stacked, init_fn(), i)
    return stacked


def _copy_layer(stacked: Params, layer: Params, i: int) -> None:
    """``stacked[...][i] = layer[...]`` leaf by leaf, in place (a DTensor
    stack block by block)."""
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_layer(stacked[k], v, i)
        else:
            set_block(stacked[k], i, v)


def _layer(stack: Params, i: int) -> Params:
    return _tree_map(lambda t: t[i], stack)


def _layers(stack: Params) -> List[Params]:
    """Every layer of a stack, by one ``unbind`` of each leaf: its
    gradient is one ``stack`` of the layers' gradients, where a view per
    layer would add a stack-sized gradient per layer."""
    if isinstance(stack, dict):
        parts = {k: _layers(v) for k, v in stack.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(stack))


#: the matrix products whose outputs ``remat="dots"`` keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn: Callable, cfg: ModelConfig, train: bool,
                 rules=None) -> Callable:
    """``fn`` itself, or under ``train`` its call checkpointed as
    ``cfg.remat`` says: ``"full"`` keeps only its inputs for the
    backward, ``"dots"`` its matrix products' outputs too.  Under
    ``rules`` the recomputation in the backward runs sharded too."""
    if not train or cfg.remat not in ("full", "dots"):
        return fn
    if rules is not None:
        inner = fn

        def fn(*a):
            with _sharded(rules):
                return inner(*a)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: ckpt.create_selective_checkpoint_contexts(
            _save_dots)
    return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False, **kw)


def _depth(stack: Params) -> int:
    """Layers in a stack (the leading axis of any leaf)."""
    leaf = stack
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def _pairs(cfg: ModelConfig) -> int:
    """(mLSTM, sLSTM) pair blocks of an ssm model."""
    return max(1, cfg.n_layers // 2)


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    """A hybrid model's (groups, Mamba2 blocks a group)."""
    per = max(1, cfg.shared_attn_every)
    return -(-cfg.n_layers // per), per


def _prefix(cfg: ModelConfig) -> int:
    """The bidirectional prefix: vlm's vision rows."""
    return cfg.n_vision_tokens if cfg.family == "vlm" else 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default: the current CUDA device; raises without CUDA): the
    reference's tree, shapes and dtypes, not its numbers."""
    fam = _family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p: Params = {"embed": init_embedding(gen, cfg),
                 "final_norm": init_norm(cfg, dev)}
    if fam in ("dense", "vlm"):
        p["blocks"] = _stack_init(lambda: blocks.init_dense_block(gen, cfg),
                                  cfg.n_layers)
    elif fam == "moe":
        nd = cfg.first_dense_layers
        if nd:
            dff = cfg.dense_d_ff or cfg.d_ff
            p["dense_blocks"] = _stack_init(
                lambda: blocks.init_dense_block(gen, cfg, dff), nd)
        p["moe_blocks"] = _stack_init(lambda: blocks.init_moe_block(gen, cfg),
                                      cfg.n_layers - nd)
    elif fam == "hybrid":
        ng, per = _groups(cfg)
        p["mamba_blocks"] = _stack_init(
            lambda: blocks.init_mamba_block(gen, cfg), ng * per)
        p["shared_attn"] = blocks.init_shared_attn_block(gen, cfg)
    elif fam == "ssm":
        p["blocks"] = _stack_init(lambda: blocks.init_xlstm_pair(gen, cfg),
                                  _pairs(cfg))
    else:                                                   # audio
        p["enc_blocks"] = _stack_init(
            lambda: blocks.init_encoder_block(gen, cfg), cfg.n_encoder_layers)
        p["enc_norm"] = init_norm(cfg, dev)
        p["blocks"] = _stack_init(lambda: blocks.init_xdec_block(gen, cfg),
                                  cfg.n_layers)
    return p


def _with_layers(axes_tree):
    if isinstance(axes_tree, dict):
        return {k: _with_layers(v) for k, v in axes_tree.items()}
    return ("layers",) + tuple(axes_tree)


def param_axes(cfg: ModelConfig) -> Params:
    """The parameters' tree of logical-axis tuples (the reference's,
    leaf for leaf)."""
    emb = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        emb["unembed"] = ("embed", "vocab")
    a: Params = {"embed": emb, "final_norm": blocks._norm_axes(cfg)}
    fam = _family(cfg)
    if fam in ("dense", "vlm"):
        a["blocks"] = _with_layers(blocks.dense_block_axes(cfg))
    elif fam == "moe":
        if cfg.first_dense_layers:
            a["dense_blocks"] = _with_layers(blocks.dense_block_axes(cfg))
        a["moe_blocks"] = _with_layers(blocks.moe_block_axes(cfg))
    elif fam == "hybrid":
        a["mamba_blocks"] = _with_layers(blocks.mamba_block_axes(cfg))
        a["shared_attn"] = blocks.shared_attn_block_axes(cfg)
    elif fam == "ssm":
        a["blocks"] = _with_layers(blocks.xlstm_pair_axes(cfg))
    else:                                                   # audio
        a["enc_blocks"] = _with_layers(blocks.encoder_block_axes(cfg))
        a["enc_norm"] = blocks._norm_axes(cfg)
        a["blocks"] = _with_layers(blocks.xdec_block_axes(cfg))
    return a


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------


def _attn_cache(cfg: ModelConfig, n_layers: int, b: int, m: int, device,
                dtype: torch.dtype = torch.bfloat16) -> Params:
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    shape = (n_layers, b, m, kv, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None) -> Params:
    fam = _family(cfg)
    dev = resolve_device(device)
    if fam in ("dense", "moe", "vlm"):
        return _attn_cache(cfg, cfg.n_layers, batch,
                           max_len + _prefix(cfg), dev)
    if fam == "hybrid":
        ng, per = _groups(cfg)
        return {"attn": _attn_cache(cfg, ng, batch, max_len, dev),
                "mamba": _tree_map(
                    lambda t: t.expand((ng, per) + t.shape).contiguous(),
                    mamba2.init_mamba_state(cfg, batch, device=dev))}
    if fam == "ssm":
        lp = _pairs(cfg)
        return {kind: _tree_map(
            lambda t: t.expand((lp,) + t.shape).contiguous(),
            xlstm.init_xlstm_state(cfg, batch, kind, device=dev))
            for kind in ("mlstm", "slstm")}
    cross = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads,
             cfg.head_dim)                                  # audio
    return {"self": _attn_cache(cfg, cfg.n_layers, batch, max_len, dev),
            "cross": {"k": torch.zeros(cross, dtype=torch.bfloat16,
                                       device=dev),
                      "v": torch.zeros(cross, dtype=torch.bfloat16,
                                       device=dev)}}


def reset_decode_cache(cache: Params, cfg: ModelConfig) -> Params:
    """``cache`` as :func:`init_decode_cache` made it, in place: ``len`` 0
    (a device ``len`` set on the device) and every recurrent state its
    initial value.  The attention rows are left as they are: no kernel
    and no plain version reads a row at or past ``len``, so a slot's
    cache serves request after request (``launch.serve.Server``)."""
    fam = _family(cfg)
    holder = _len_holder(cache, cfg)
    with torch.no_grad():
        if holder is not None and isinstance(holder["len"], torch.Tensor):
            holder["len"].zero_()
        elif holder is not None:
            holder["len"] = 0
        if fam == "hybrid":                # init_mamba_state's zeros
            for t in cache["mamba"].values():
                t.zero_()
        elif fam == "ssm":
            h = cache["slstm"]["h"]
            for kind, part in cache.items():
                fresh = xlstm.init_xlstm_state(cfg, h.shape[1], kind,
                                               device=h.device)
                for key, t in part.items():
                    t.copy_(fresh[key].expand_as(t))
    return cache


_ATTN_CACHE_AX = ("layers", "cache_batch", "cache_seq", "cache_kv",
                  "cache_dim")


def cache_axes(cfg: ModelConfig) -> Params:
    """The decode cache's tree of logical-axis tuples (the reference's;
    ``len`` is a 0-dim int32 with axes ``()``)."""
    ac = {"k": _ATTN_CACHE_AX, "v": _ATTN_CACHE_AX, "len": ()}
    fam = _family(cfg)
    if fam in ("dense", "moe", "vlm"):
        return dict(ac)
    if fam == "hybrid":
        return {"attn": dict(ac),
                "mamba": {"ssm": (None, None, "cache_batch", "heads", None,
                                  None),
                          "conv": (None, None, "cache_batch", None,
                                   "ssm_inner")}}
    if fam == "ssm":
        return {"mlstm": {"C": (None, "cache_batch", "heads", None, None),
                          "n": (None, "cache_batch", "heads", None),
                          "m": (None, "cache_batch", None)},
                "slstm": {k: (None, "cache_batch", "embed_act")
                          for k in ("h", "c", "n", "m")}}
    return {"self": dict(ac),
            "cross": {"k": _ATTN_CACHE_AX, "v": _ATTN_CACHE_AX}}


# ---------------------------------------------------------------------------
# the block stacks, one function per family; the cache threaded through
# ---------------------------------------------------------------------------


_STEP_KEYS = ("len", "rows", "end")


def _with_rows(cache: Params, cfg: ModelConfig, s: int) -> Params:
    """``cache`` whose attention part (the one holding ``len``) carries,
    for a device ``len``, the step's write rows ``len + arange(s)`` and
    its new length ``len + s``: made once a step, every layer's attention
    reads them (a host ``len`` needs neither)."""
    holder = _len_holder(cache, cfg)
    if holder is None or not isinstance(holder["len"], torch.Tensor) or \
            "rows" in holder:
        return cache
    ln = holder["len"]
    holder = dict(holder, rows=ln + torch.arange(s, device=ln.device),
                  end=ln + s)
    if cfg.family == "audio":
        return dict(cache, self=holder)
    if cfg.family == "hybrid":
        return dict(cache, attn=holder)
    return holder


def _view(holder: Params, k: torch.Tensor, v: torch.Tensor) -> Params:
    """A layer's (or a stack's) part of an attention cache: ``k`` and
    ``v`` with the holder's ``len`` and step rows."""
    return {"k": k, "v": v, **{key: holder[key] for key in _STEP_KEYS
                               if key in holder}}


def _advanced(holder: Params, s: int) -> Params:
    """The attention cache after a step of ``s`` rows: the whole ``k`` and
    ``v`` with ``len + s``."""
    end = holder["end"] if "end" in holder else holder["len"] + s
    return {"k": holder["k"], "v": holder["v"], "len": end}


def _run_dense_stack(stack: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     positions: torch.Tensor, prefix_len: int = 0,
                     cache: Optional[Params] = None, train: bool = False,
                     rules=None) -> Tuple[torch.Tensor, Optional[Params]]:
    """The blocks in order, each with its layer of the cache; a layer
    with a ``"moe"`` entry is an MoE block."""
    def body(xc, p_l, cache_l):
        if "moe" in p_l:
            return blocks.apply_moe_block(p_l, xc, cfg, positions=positions,
                                          cache=cache_l, rules=rules)[0]
        return blocks.apply_dense_block(p_l, xc, cfg, positions=positions,
                                        prefix_len=prefix_len,
                                        cache=cache_l, rules=rules)[0]

    run = _maybe_remat(body, cfg, train and cache is None, rules)
    for i, p_l in enumerate(_layers(stack)):
        cache_l = None if cache is None else \
            _view(cache, cache["k"][i], cache["v"][i])
        x = run(x, p_l, cache_l)
    if cache is None:
        return x, None
    return x, _advanced(cache, x.shape[1])


def _attn_stacks(params: Params, cfg: ModelConfig) -> List[Params]:
    """The attention families' stacks in order: dense, or moe's dense
    blocks then its MoE blocks (one cache over all of them)."""
    if cfg.family == "moe":
        return [params[k] for k in ("dense_blocks", "moe_blocks")
                if k in params]
    return [params["blocks"]]


def _run_attn_stacks(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     positions: torch.Tensor, cache: Optional[Params] = None,
                     train: bool = False, rules=None
                     ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Each stack over its layers' views of the one cache (the
    reference splits the cache at ``first_dense_layers`` and
    concatenates it again); vlm's rows see its vision prefix whole."""
    first = 0
    for stack in _attn_stacks(params, cfg):
        n = _depth(stack)
        part = None if cache is None else _view(
            cache, cache["k"][first:first + n], cache["v"][first:first + n])
        x, _ = _run_dense_stack(stack, x, cfg, positions=positions,
                                prefix_len=_prefix(cfg), cache=part,
                                train=train, rules=rules)
        first += n
    if cache is None:
        return x, None
    return x, _advanced(cache, x.shape[1])


def _run_hybrid(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, cache: Optional[Params] = None,
                train: bool = False, rules=None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Each group: the shared attention block over the group's layer of
    the attention cache, then its ``per`` Mamba2 blocks, each state
    written into its place in the cache.  The reference's states come
    back in the compute dtype: a conv cache in another dtype (bfloat16
    from ``init_decode_cache`` under float32 compute) is replaced by its
    copy in the compute dtype first."""
    ng, per = _groups(cfg)
    layers, shared = _layers(params["mamba_blocks"]), params["shared_attn"]
    if cache is None:
        def group(xc, mamba):
            xc, _ = blocks.apply_shared_attn_block(shared, xc, cfg,
                                                   positions=positions,
                                                   rules=rules)
            for blk in mamba:
                xc, _ = blocks.apply_mamba_block(blk, xc, cfg, rules=rules)
            return xc

        run = _maybe_remat(group, cfg, train, rules)
        for g in range(ng):
            x = run(x, layers[g * per:(g + 1) * per])
        return x, None
    attn = cache["attn"]
    states = cache["mamba"]
    if states["conv"].dtype != x.dtype:
        states = {"ssm": states["ssm"], "conv": states["conv"].to(x.dtype)}
    for g in range(ng):
        attn_l = _view(attn, attn["k"][g], attn["v"][g])
        x, _ = blocks.apply_shared_attn_block(shared, x, cfg,
                                              positions=positions,
                                              cache=attn_l, rules=rules)
        for j in range(per):
            st = {k: t[g, j] for k, t in states.items()}
            x, new = blocks.apply_mamba_block(layers[g * per + j], x, cfg,
                                              state=st, rules=rules)
            for k, t in new.items():
                set_block(states[k], (g, j), t)
    return x, {"attn": _advanced(attn, x.shape[1]), "mamba": states}


def _run_ssm(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
             cache: Optional[Params] = None, train: bool = False,
             rules=None) -> Tuple[torch.Tensor, Optional[Params]]:
    """The (mLSTM, sLSTM) pairs; each pair's new state is written into
    its layer of the cache."""
    if cache is None:
        run = _maybe_remat(
            lambda xc, p_l: blocks.apply_xlstm_pair(p_l, xc, cfg,
                                                    rules=rules)[0], cfg,
            train, rules)
        for p_l in _layers(params["blocks"]):
            x = run(x, p_l)
        return x, None
    for i, p_l in enumerate(_layers(params["blocks"])):
        x, new_state = blocks.apply_xlstm_pair(p_l, x, cfg,
                                               state=_layer(cache, i),
                                               rules=rules)
        _copy_layer(cache, new_state, i)
    return x, cache


def _run_encoder(params: Params, frames: torch.Tensor, cfg: ModelConfig,
                 train: bool = False, rules=None) -> torch.Tensor:
    b, t, _ = frames.shape
    pos = _positions(0, b, t, frames.device)
    dt = cdtype(cfg)
    x = frames.to(dt) + _sinusoidal(pos, cfg.d_model).to(dt)
    run = _maybe_remat(
        lambda xc, p_l: blocks.apply_encoder_block(p_l, xc, cfg,
                                                   positions=pos,
                                                   rules=rules)[0],
        cfg, train, rules)
    for p_l in _layers(params["enc_blocks"]):
        x = run(x, p_l)
    # every decoder layer's cross keys and values read the whole sequence
    return shard_act(apply_norm(params["enc_norm"], x, cfg), rules,
                     ("batch", "seq", None))


def _cross_kv(p_attn: Params, enc: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, _ = enc.shape
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    k = _heads(_proj(enc, p_attn["wk"], p_attn.get("bk")), (b, t, kv, dh))
    v = _heads(_proj(enc, p_attn["wv"], p_attn.get("bv")), (b, t, kv, dh))
    return k, v


def _cross_attend(p_attn: Params, xn: torch.Tensor, cfg: ModelConfig,
                  ck: torch.Tensor, cv: torch.Tensor, rules=None
                  ) -> torch.Tensor:
    """Cross-attention of the decoder rows ``xn`` over the encoder's keys
    and values: kernel B7 with no causal mask (under ``rules``, on each
    rank's block)."""
    b, s, _ = xn.shape
    h, dh = cfg.n_heads, cfg.head_dim
    q = _heads(_proj(xn, p_attn["wq"], p_attn.get("bq")), (b, s, h, dh))
    if rules is not None and is_dtensor(q):
        out = _flat_heads(_sharded_attention(
            q, ck.to(xn.dtype), cv.to(xn.dtype), rules, causal=False,
            prefix_len=0, kv_len=None, q_start=0), rules)
        return _proj(out, p_attn["wo"])
    else:
        out = fa.flash_attention(q, ck.to(xn.dtype), cv.to(xn.dtype),
                                 causal=False)
    return _proj(out.reshape(b, s, h * dh), p_attn["wo"])


def _cross_cache(params: Params, enc: torch.Tensor, cfg: ModelConfig
                 ) -> Params:
    """Every decoder layer's cross keys and values of ``enc``, stacked,
    in the compute dtype (the reference's prefill replaces the cache's
    bfloat16 zeros with them)."""
    stack = params["blocks"]
    n = _depth(stack)
    if is_dtensor(enc):
        kvs = [_cross_kv(_layer(stack["cross"], i), enc, cfg)
               for i in range(n)]
        return {"k": torch.stack([k for k, _ in kvs]),
                "v": torch.stack([v for _, v in kvs])}
    b, t, _ = enc.shape
    shape = (n, b, t, cfg.n_kv_heads, cfg.head_dim)
    ck = torch.empty(shape, dtype=enc.dtype, device=enc.device)
    cv = torch.empty_like(ck)
    for i in range(n):
        ck[i], cv[i] = _cross_kv(_layer(stack["cross"], i), enc, cfg)
    return {"k": ck, "v": cv}


def _run_xdec(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, enc: Optional[torch.Tensor] = None,
              cache: Optional[Params] = None, train: bool = False,
              rules=None) -> Tuple[torch.Tensor, Optional[Params]]:
    """The decoder stack; the cross keys and values come from ``enc``
    (``forward`` computes them per layer) or from the cache."""
    def body(xc, blk, i):
        self_cache = None if cache is None else _view(
            cache["self"], cache["self"]["k"][i], cache["self"]["v"][i])
        xc = shard_act(xc, rules)
        a, _ = attention(blk["self"],
                         blocks._in_layer(apply_norm(blk["ln1"], xc, cfg),
                                          rules),
                         cfg, positions=positions, cache=self_cache,
                         rules=rules)
        xc = xc + blocks._out_layer(a, rules)
        if cache is None:
            ck, cv = _cross_kv(blk["cross"], enc, cfg)
        else:
            ck, cv = cache["cross"]["k"][i], cache["cross"]["v"][i]
        xc = xc + blocks._out_layer(_cross_attend(blk["cross"], blocks._in_layer(
            apply_norm(blk["ln2"], xc, cfg), rules), cfg, ck, cv, rules), rules)
        xc = xc + blocks._out_layer(ffn(blk["ffn"], blocks._in_layer(
            apply_norm(blk["ln3"], xc, cfg), rules), cfg), rules)
        return shard_act(xc, rules)

    run = _maybe_remat(body, cfg, train and cache is None, rules)
    for i, blk in enumerate(_layers(params["blocks"])):
        x = run(x, blk, i)
    if cache is None:
        return x, None
    return x, {"self": _advanced(cache["self"], x.shape[1]),
               "cross": cache["cross"]}


def _run_family(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor,
                frames: Optional[torch.Tensor] = None,
                cache: Optional[Params] = None, train: bool = False,
                rules=None) -> Tuple[torch.Tensor, Optional[Params]]:
    """The family's stack over the embedded tokens.  ``frames`` (audio)
    run through the encoder: with a cache (a prefill) its cross keys and
    values go into the cache; without ``frames`` a decode step reads
    them from it."""
    fam = cfg.family
    x = shard_act(x, rules, ("batch", "seq_act", None) if cache is None
                  or x.shape[1] > 1 else ("batch", None, None))
    if cache is not None:
        cache = _with_rows(cache, cfg, x.shape[1])
    if fam in ("dense", "moe", "vlm"):
        return _run_attn_stacks(params, x, cfg, positions=positions,
                                cache=cache, train=train, rules=rules)
    if fam == "hybrid":
        return _run_hybrid(params, x, cfg, positions=positions, cache=cache,
                           train=train, rules=rules)
    if fam == "ssm":
        return _run_ssm(params, x, cfg, cache=cache, train=train,
                        rules=rules)
    enc = None if frames is None else _run_encoder(params, frames, cfg,
                                                   train, rules)
    if cache is not None and enc is not None:
        cache = {"self": cache["self"],
                 "cross": _cross_cache(params, enc, cfg)}
    return _run_xdec(params, x, cfg, positions=positions, enc=enc,
                     cache=cache, train=train, rules=rules)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _positions(start, b: int, s: int, device) -> torch.Tensor:
    """Rows ``start .. start + s`` for each of ``b`` rows; ``start`` an int
    or a 0-dim device tensor (read on the device)."""
    if isinstance(start, torch.Tensor):
        return (start + torch.arange(s, device=device)).expand(b, s)
    return torch.arange(start, start + s, device=device).expand(b, s)


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) int -> (B, S, d) float32 sinusoidal position embedding."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """Token embeddings, plus absolute (sinusoidal) positions for the
    audio decoder and for an attention model configured without RoPE
    (ssm and hybrid are position-free)."""
    x = embed(params["embed"], tokens, cfg)
    if cfg.family == "audio" or (cfg.rope == "none"
                                 and cfg.family in ("dense", "moe", "vlm")):
        x = x + _sinusoidal(positions, cfg.d_model).to(x.dtype)
    return x


def _len_holder(cache: Params, cfg: ModelConfig) -> Optional[Params]:
    """The attention cache that holds ``len`` (None for ssm)."""
    if cfg.family == "audio":
        return cache["self"]
    if cfg.family == "hybrid":
        return cache["attn"]
    return cache if "len" in cache else None


def _cache_len(cache: Params, cfg: ModelConfig):
    """The rows a cache holds (0 for ssm, whose decode ignores position;
    vlm's count its vision rows): an int or a 0-dim int32 tensor."""
    holder = _len_holder(cache, cfg)
    return 0 if holder is None else holder["len"]


def check_room(cache: Params, cfg: ModelConfig, rows: int, rules=None
               ) -> Params:
    """Raise ``ValueError`` before any row is written when ``rows`` new
    rows would pass the cache's capacity.  A device ``len`` is read on the
    host for it (one sync a step), except inside a CUDA graph capture,
    where the caller checks its own host count (``launch.serve.Server``),
    and on fake tensors.  Under ``rules`` the cache comes back with its
    ``len`` as a host int: the sharded path runs on host lengths."""
    holder = _len_holder(cache, cfg)
    if holder is None:
        return cache
    ln = holder["len"]
    if isinstance(ln, torch.Tensor):
        from ..kernels.lm_ops import is_fake
        if is_fake(ln) or (ln.device.type == "cuda"
                           and torch.cuda.is_current_stream_capturing()):
            return cache
        ln = int(ln)
        if rules is not None:
            holder = dict(holder, len=ln)
            if cfg.family == "audio":
                cache = dict(cache, self=holder)
            elif cfg.family == "hybrid":
                cache = dict(cache, attn=holder)
            else:
                cache = holder
    check_rows(ln, rows, holder["k"].shape[-3])
    return cache


def _embed_inputs(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, positions) of a full sequence: vlm's ``batch["vision"]``, cast
    to the compute dtype, in front of the embedded text, positions
    ``0 .. prefix + S``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    prefix = _prefix(cfg)
    positions = _positions(0, b, prefix + s, tokens.device)
    x = _embed_tokens(params, tokens, cfg, positions[:, prefix:])
    if prefix:
        x = torch.cat([batch["vision"].to(x.dtype), x], dim=1)
    return x, positions


_SHARDED_DEPTH = [0]


@contextlib.contextmanager
def _sharded(rules):
    """DTensor operations under ``rules`` treat plain tensors made inside
    the model (positions, masks, and what autograd saved of them) as
    replicated.  Nests: only the outermost entry switches DTensor's
    (process-wide) implicit replication on and off."""
    if rules is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    if _SHARDED_DEPTH[0]:
        _SHARDED_DEPTH[0] += 1
        try:
            yield
        finally:
            _SHARDED_DEPTH[0] -= 1
        return
    _SHARDED_DEPTH[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _SHARDED_DEPTH[0] -= 1


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], train: bool = False,
            return_hidden: bool = False, rules=None) -> torch.Tensor:
    """Full-sequence float32 logits (teacher forcing);
    ``batch["tokens"]``: (B, S) (and ``batch["vision"]`` for vlm,
    ``batch["frames"]`` for audio); vlm's cover the text positions only.
    ``train=True`` checkpoints each layer body as ``cfg.remat`` asks (the
    reference's default is ``train=True``; the port's callers that serve
    or check logits take the default ``False``, where remat changes
    nothing but memory).  ``return_hidden=True`` returns the
    post-final-norm hidden state (B, S, d_model) instead.  ``rules``
    (DTensor parameters and batch): the sharded forward, a DTensor out."""
    _family(cfg)
    with _sharded(rules):
        x, positions = _embed_inputs(params, batch, cfg)
        x, _ = _run_family(params, x, cfg, positions=positions,
                           frames=batch.get("frames"), train=train,
                           rules=rules)
        # the sequence gathered for the slice and the unembedding
        x = shard_act(x, rules, ("batch", "seq", None))
        x = apply_norm(params["final_norm"], x[:, _prefix(cfg):], cfg)
        if return_hidden:
            return x
        return unembed_logits(params["embed"], x, cfg)


def prefill(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], cache: Params, rules=None
            ) -> Tuple[torch.Tensor, Params]:
    """Prefill an empty cache with ``batch["tokens"]`` (B, S) (after
    vlm's ``batch["vision"]``; and the encoder over ``batch["frames"]``
    for audio); returns the last position's logits (B, 1, V) and the
    cache."""
    _family(cfg)
    cache = check_room(cache, cfg, _prefix(cfg) + batch["tokens"].shape[1],
                       rules)
    with _sharded(rules):
        x, positions = _embed_inputs(params, batch, cfg)
        x, cache = _run_family(params, x, cfg, positions=positions,
                               frames=batch.get("frames"), cache=cache,
                               rules=rules)
        x = shard_act(x, rules, ("batch", "seq", None))
        x = apply_norm(params["final_norm"], x[:, -1:], cfg)
        return unembed_logits(params["embed"], x, cfg), cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, rules=None) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) -> logits (B, 1, V), cache."""
    _family(cfg)
    b, s = tokens.shape
    cache = check_room(cache, cfg, s, rules)
    with _sharded(rules):
        positions = _positions(_cache_len(cache, cfg), b, s, tokens.device)
        x = _embed_tokens(params, tokens, cfg, positions)
        x, cache = _run_family(params, x, cfg, positions=positions,
                               cache=cache, rules=rules)
        x = shard_act(x, rules, ("batch", "seq", None))
        x = apply_norm(params["final_norm"], x, cfg)
        return unembed_logits(params["embed"], x, cfg), cache
