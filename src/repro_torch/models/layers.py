"""Shared transformer layers: norms, RoPE variants, GQA attention, FFN.

The port of the reference's ``models/layers.py``.  Parameters are plain
dicts of tensors; weight layout as in the reference: 2-D weights are
(d_in, d_out) and stacked layers get a leading layer axis.  Compute runs
in ``config.compute_dtype`` with float32 logits, softmax and norm
statistics, following every cast of the reference.

Attention goes through :func:`repro_torch.kernels.flash_attention.
flash_attention`: on a CUDA tensor every call launches kernel B7, on a
CPU tensor its plain version runs.  :func:`attn_core` keeps the
reference's name for that plain version.  Left out here: the query-chunk
option.

With ``rules`` (a :class:`.sharding.ShardingRules`) and DTensor
activations, :func:`attention` pins the attention layout
(:func:`_constrain_attention_layout`) and runs B7 (and B7b through
autograd) on each rank's local block under ``local_map``:

* query heads divisible by the ``model`` axis: tensor-parallel, each
  rank attends with its heads (and the kv heads they read);
* otherwise KV-parallel: each rank attends over its slice of the key
  length and returns ``(out, lse)``; the slices combine over ``model``
  as split-KV does (:class:`_KvSliceAttention`);
* otherwise every model rank attends over everything.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels import flash_attention as fa
from .config import ModelConfig
from .sharding import grad_layout, is_dtensor, shard_like

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


def _heads(y, shape):
    """A (B, S, n * dh) projection viewed as (B, S, n, dh).  A DTensor
    whose last dim is sharded over more parts than ``n`` splits evenly
    is gathered on it first (DTensor views only whole heads)."""
    if is_dtensor(y):
        from torch.distributed.tensor import Replicate, Shard
        last = y.dim() - 1
        mesh = y.device_mesh
        parts = 1
        for i, pl in enumerate(y.placements):
            if isinstance(pl, Shard) and pl.dim == last:
                parts *= mesh.size(i)
        if shape[2] % parts:
            y = y.redistribute(mesh, [
                Replicate() if isinstance(pl, Shard) and pl.dim == last
                else pl for pl in y.placements])
    return y.reshape(shape)


def _flat_heads(out, rules):
    """(B, S, H, dh) -> (B, S, H*dh) for a DTensor; when ``model`` does
    not divide the heads, the flat gradient comes back gathered on its
    last dim (DTensor views only whole heads)."""
    b, s, h, dh = out.shape
    flat = out.reshape(b, s, h * dh)
    if h % max(rules.model_size(), 1):
        flat = grad_layout(rules, flat, ("batch", "seq", None))
    return flat


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
              kv_source: Optional[torch.Tensor] = None, causal: bool = True,
              rules=None
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """GQA attention through kernel B7.

    * ``cache``: {"k": (B, S_max, kv, dh), "v": ..., "len": int or 0-dim
      int32 tensor} — one layer's views of the stacked cache (with a
      device ``len``, optionally ``"rows"``, ``len + arange(S)``, and
      ``"end"``, ``len + S``: the model makes them once a step).  The new
      k/v are written at rows ``len .. len+S`` in place (the reference's
      ``dynamic_update_slice`` returns a new array instead), and
      attention spans the cache tensor with ``kv_len = len + S`` and
      ``q_start = len``: S > 1 is a prefill, S == 1 a decode step.
      Returns the same tensors with ``len + S``.  A host int ``len``
      reaches the kernel as ints; a device ``len`` (the decode cache's,
      as the reference's traced ``len``) is read by the write's index
      and by B7 on the device, so a captured step replays at any length.
      A write past the cache's ``max_len`` rows raises ``ValueError``
      before any row is written (the reference's
      ``dynamic_update_slice`` would clamp the start and overwrite the
      last rows): here for a host ``len``, once a step at the model's
      entry points for a device one (``model.check_room``).
    * ``kv_source``: cross-attention source (B, T, D), the encoder
      states: keys and values come from it, with no RoPE and no causal
      mask (still kernel B7).
    * ``prefix_len``: bidirectional prefix (prefix-LM).
    * ``rules``: see the module docstring (DTensor operands).
    """
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_source is None else kv_source
    q = _heads(_proj(x, p["wq"], p.get("bq")), (b, s, h, dh))
    k = _heads(_proj(src, p["wk"], p.get("bk")), (b, src.shape[1], kv, dh))
    v = _heads(_proj(src, p["wv"], p.get("bv")), (b, src.shape[1], kv, dh))
    if kv_source is None:
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)

    new_cache = None
    kv_len = None
    q_start = 0
    dev_start = None
    if cache is not None:
        start = cache["len"]
        if isinstance(start, torch.Tensor):
            # the step's write rows and new length, made once a step by
            # the model (model._with_rows) or here for a lone layer
            rows = cache["rows"] if "rows" in cache else \
                start + torch.arange(s, device=start.device)
            _cache_write_rows(cache["k"], rows, k)
            _cache_write_rows(cache["v"], rows, v)
            dev_start, kv_len = start, s
        else:
            check_rows(start, s, cache["k"].shape[1])
            _cache_write(cache["k"], start, k)
            _cache_write(cache["v"], start, v)
            q_start, kv_len = start, start + s
        new_cache = {"k": cache["k"], "v": cache["v"],
                     "len": cache["end"] if "end" in cache else start + s}
        k, v = cache["k"], cache["v"]

    causal = causal and kv_source is None
    if rules is not None and is_dtensor(q):
        out = _flat_heads(_sharded_attention(
            q, k, v, rules, causal=causal, prefix_len=prefix_len,
            kv_len=kv_len, q_start=q_start), rules)
        return _proj(out, p["wo"]), new_cache
    else:
        out = fa.flash_attention(q, k, v, causal=causal,
                                 prefix_len=prefix_len, kv_len=kv_len,
                                 q_start=q_start, start=dev_start)
    return _proj(out.reshape(b, s, h * dh), p["wo"]), new_cache


def check_rows(start: int, s: int, max_len: int) -> None:
    """Raise ``ValueError`` when ``s`` rows written at ``start`` would pass
    a cache of ``max_len`` rows."""
    if start + s > max_len:
        raise ValueError(
            f"attention: the KV cache holds len={start} rows and S={s} "
            f"new ones would pass max_len={max_len}")


def _cache_write_rows(cache_t, rows: torch.Tensor, new) -> None:
    """Write ``new`` (B, S, KV, dh) at the rows ``rows`` (an int64 device
    index) of one layer's cache tensor, in place."""
    with torch.no_grad():
        cache_t.index_copy_(1, rows, new.to(cache_t.dtype))


def _cache_write(cache_t, start: int, new) -> None:
    """Write ``new`` (B, S, KV, dh) at rows ``start .. start+S`` of one
    layer's cache tensor, in place; a DTensor cache is written block by
    block after ``new`` takes the cache's placements."""
    s = new.shape[1]
    with torch.no_grad():
        if is_dtensor(cache_t):
            new = new.redistribute(cache_t.device_mesh, cache_t.placements)
            cache_t, new = cache_t.to_local(), new.to_local()
        cache_t[:, start:start + s] = new.to(cache_t.dtype)


# ---------------------------------------------------------------------------
# the sharded attention layout (``rules=``)
# ---------------------------------------------------------------------------


def _constrain_attention_layout(q, k, v, rules, kv_split: bool = True):
    """(route, q, k, v): the attention layout pinned as the reference
    pins it.  ``"heads"``: q on its heads over ``model`` and k / v on
    their kv heads (replicated when those do not divide; then every
    rank's query heads must fall in whole kv groups or one group);
    ``"kv"``: q replicated over ``model``, k / v on their length;
    ``"full"``: all three replicated over ``model``."""
    n = max(rules.model_size(), 1)
    h, kvh, t = q.shape[2], k.shape[2], k.shape[1]
    hl, g = h // n, h // kvh
    if rules.resolve("heads", h) is not None and (
            rules.resolve("kv_heads", kvh) is not None or g % hl == 0):
        return ("heads", shard_like(rules, q, ("batch", None, "heads", None)),
                shard_like(rules, k, ("batch", None, "kv_heads", None)),
                shard_like(rules, v, ("batch", None, "kv_heads", None)))
    rep = ("batch", None, None, None)
    if kv_split and t % n == 0:
        kv_ax = ("batch", "seq_act", None, None)
        return ("kv", shard_like(rules, q, rep), shard_like(rules, k, kv_ax),
                shard_like(rules, v, kv_ax))
    return ("full", shard_like(rules, q, rep), shard_like(rules, k, rep),
            shard_like(rules, v, rep))


def _grad_pl(x, mi: int, partial: bool):
    from torch.distributed.tensor import Partial
    pl = list(x.placements)
    if partial:
        pl[mi] = Partial()
    return tuple(pl)


def _sharded_attention(q, k, v, rules, *, causal: bool, prefix_len: int,
                       kv_len: Optional[int], q_start: int):
    """Attention of DTensor q / k / v under ``rules``: each rank's block
    through B7 (and B7b) under ``local_map``; returns (B, S, H, dh)."""
    from torch.distributed.tensor.experimental import local_map
    # a bidirectional prefix keeps every slice's keys visible to every
    # row: no KV split then
    route, q, k, v = _constrain_attention_layout(
        q, k, v, rules, kv_split=not (causal and prefix_len))
    mesh = q.device_mesh
    mi = list(rules.shape).index(rules.model_axis)
    n, rank = rules.model_size(), rules.model_rank()
    masks = dict(causal=causal, prefix_len=prefix_len, kv_len=kv_len,
                 q_start=q_start)
    if route == "heads":
        kv_whole = rules.resolve("kv_heads", k.shape[2]) is None and n > 1
        g = q.shape[2] // k.shape[2]

        def body(ql, kl, vl):
            if kv_whole:         # the kv head(s) of this rank's query heads
                lo = rank * ql.shape[2] // g
                kl = kl[:, :, lo:lo + max(ql.shape[2] // g, 1)]
                vl = vl[:, :, lo:lo + max(ql.shape[2] // g, 1)]
            return fa.flash_attention(ql, kl, vl, **masks)
        grads = (q.placements, _grad_pl(k, mi, kv_whole),
                 _grad_pl(v, mi, kv_whole))
    elif route == "kv":
        group = mesh.get_group(rules.model_axis)

        def body(ql, kl, vl):
            return _KvSliceAttention.apply(ql, kl, vl, group, rank, n,
                                           causal, prefix_len, kv_len,
                                           q_start)
        grads = (_grad_pl(q, mi, True), k.placements, v.placements)
    else:
        def body(ql, kl, vl):
            return fa.flash_attention(ql, kl, vl, **masks)
        grads = (q.placements, k.placements, v.placements)
    return local_map(body, out_placements=list(q.placements),
                     in_placements=(q.placements, k.placements,
                                    v.placements),
                     in_grad_placements=grads, device_mesh=mesh)(q, k, v)


def _attn_lse(q, k, v, causal, prefix_len, kv_len, q_start):
    """(out, lse) of B7 (its plain version on a real CPU tensor)."""
    from ..kernels.lm_ops import flash_fwd
    return flash_fwd(q, k, v, causal, prefix_len,
                     -1 if kv_len is None else kv_len, q_start, True)


def _attn_bwd(q, k, v, out, lse, d_out, causal, prefix_len, kv_len,
              q_start):
    from ..kernels.lm_ops import flash_bwd
    return flash_bwd(q, k, v, out, lse, d_out, causal, prefix_len,
                     -1 if kv_len is None else kv_len, q_start)


class _KvSliceAttention(torch.autograd.Function):
    """One model rank's share of KV-parallel attention: this rank's key
    slice ``[rank * T_l, (rank + 1) * T_l)`` of the global keys, its
    ``(out_r, lse_r)`` from B7, combined over the model group as split-KV
    combines them (``out = sum_r w_r out_r``, ``w_r = exp(lse_r - LSE)``).

    The rows that see no key of the slice (causal rows before it, or a
    slice past ``kv_len``) are left out of the kernel call and weigh 0.
    The backward is B7b on the slice with ``d_out_r = w_r d_out`` and the
    *combined* output in place of ``out_r``: its ``D = rowsum(d_out_r *
    out)`` is then exactly the full softmax's, so dq (summed over the
    group by the caller's ``Partial`` gradient), dk and dv are the full
    attention's."""

    @staticmethod
    def forward(ctx, q, k, v, group, rank, n, causal, prefix_len, kv_len,
                q_start):
        from torch.distributed import _functional_collectives as funcol
        b, s, h, dh = q.shape
        tl = k.shape[1]
        off = rank * tl
        kl = tl if kv_len is None else min(max(kv_len - off, 0), tl)
        # rows before the slice see it only through the prefix
        r0 = min(max(off - q_start, 0), s) if causal else 0
        out_r = q.new_zeros((b, s, h, dh), dtype=torch.float32)
        lse_r = q.new_full((b, h, s), float("-inf"), dtype=torch.float32)
        call = None
        if kl > 0 and r0 < s:
            call = dict(causal=causal, prefix_len=0,
                        kv_len=None if kv_len is None else kl,
                        q_start=q_start + r0 - off if causal else 0)
            o, l_ = _attn_lse(q[:, r0:].contiguous(), k, v, **call)
            out_r[:, r0:] = o.float()
            lse_r[..., r0:] = l_
        m = funcol.all_reduce(lse_r, "max", group)
        w = torch.exp(lse_r - m)
        w = torch.where(torch.isfinite(lse_r), w, 0.0)
        tot = funcol.all_reduce(w, "sum", group)
        w = w / tot
        out = funcol.all_reduce(out_r * w.permute(0, 2, 1)[..., None],
                                "sum", group).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse_r, w)
        ctx.call, ctx.r0 = call, r0
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse_r, w = ctx.saved_tensors
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), \
            torch.zeros_like(v)
        if ctx.call is not None:
            r0 = ctx.r0
            d_r = (d_out.float() * w.permute(0, 2, 1)[..., None]).to(
                q.dtype)[:, r0:].contiguous()
            dq_r, dk, dv = _attn_bwd(q[:, r0:].contiguous(), k, v,
                                     out[:, r0:].contiguous(),
                                     lse_r[..., r0:].contiguous(), d_r,
                                     **ctx.call)
            dq[:, r0:] = dq_r
        return dq, dk, dv, None, None, None, None, None, None, None


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, kv, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, kv, dh), dtype=dtype,
                             device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


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
    if is_dtensor(p["tok"]):
        return _embed_sharded(p["tok"], tokens).to(cdtype(cfg))
    return p["tok"][tokens].to(cdtype(cfg))


def _embed_sharded(tok, tokens):
    """The lookup of DTensor ``tokens`` (sharded over their rows) in a
    DTensor table: the table gathered whole, each rank's rows looked up
    under ``local_map``; the table's gradient is a partial sum over the
    batch axes (each rank's rows' scatter-add)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = tokens.device_mesh
    rows = tuple(Shard(0) if isinstance(pl, Shard) and pl.dim == 0
                 else Replicate() for pl in tokens.placements)
    tokens = tokens.redistribute(mesh, rows)
    rep = (Replicate(),) * mesh.ndim
    table = tok.redistribute(mesh, rep)
    grad = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                 for pl in rows)
    return local_map(lambda t, ids: t[ids], out_placements=list(rows),
                     in_placements=(rep, rows), in_grad_placements=(grad,
                                                                    rows),
                     device_mesh=mesh)(table, tokens)


def logits(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p.get("unembed")
    if w is None:
        w = p["tok"].T
    return (x @ w.to(x.dtype)).float()
