"""Hopper kernel for the attention forward (B7): online-softmax GQA
attention with causal, prefix-LM and cache-length masks.

:func:`flash_attention` launches the CUDA kernel
(``csrc/flash_attention.cu``, built by :mod:`.build`); it replaces the
reference's ``flash_attention_pallas`` and carries every attention call
of the port's LM (prefill, decode and the no-cache ``forward``).  Beside
it, :func:`flash_attention_reference` is its plain PyTorch version: the
math of the reference's ``models/layers.attn_core`` / ``_attn_block``,
chunked over queries as ``_pick_q_chunk`` does.

Contract, in the reference's layout: ``q`` (B, S, H, dh); ``k`` / ``v``
(B, T, KV, dh) with ``H % KV == 0`` (query head ``h`` reads kv head
``h // (H // KV)``) -> (B, S, H, dh) in ``q``'s dtype.  Scores are
``q . k`` with float32 accumulation (``k`` taken in ``q``'s dtype)
times ``1/sqrt(dh)``; query row ``s`` sits at global position
``q_start + s``; column ``t`` is visible when ``t < kv_len`` and, if
``causal``, when ``t <= q_start + s`` or ``t < prefix_len``; a hidden
score is the finite ``-1e30``.  Softmax in float32, probabilities cast
to ``v``'s dtype for the PV product, accumulated in float32.  ``q`` is
float32 or bfloat16; ``k`` and ``v`` share one dtype, bfloat16 or (with
a float32 ``q``) float32 — the reference's float32 model keeps a
bfloat16 cache.  The kernel reads ``k`` and ``v`` through their strides
(a layer's view of the stacked cache) and never reads a row at or past
``kv_len``.

The wrapper runs the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  :func:`flash_route` picks the
kernel from the shape: bf16 calls with more than
:data:`FLASH_SPLITKV_ROWS` query rows per kv head (``S * H / KV``) run
the prefill kernel (``wgmma`` on a TMA ring), the others the split-KV
decode kernel and its combine; float32 queries run the FMA kernel.  Each
call adds one to :data:`.cam_search.LAUNCHES` (``"flash_attention"``),
whatever the route.

:func:`flash_attention_recurrence` is the Pallas kernel's own recurrence
in eager float32 (the unnormalised probabilities rounded to ``v``'s
dtype before the PV product), over kv tiles of ``block_k`` rows and,
with ``splits``, split as the decode kernel splits the kv walk: the
checks hold each route to it at the route's tile width and splits.
"""

from __future__ import annotations

import array
import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import build
from .cam_search import _bind, _count, _raise_if_failed

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_recurrence", "flash_route", "FlashRoute",
           "FLASH_HEAD_DIMS", "FLASH_BLOCK_K", "FLASH_SPLITKV_ROWS",
           "FLASH_SPLIT_BLOCKS"]

#: head dims the kernel is instantiated for
FLASH_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: kv rows per tile of each route: the recurrence's ``block_k``; a
#: ``(route, dh)`` key overrides the route's width at that head dim (the
#: ``wgmma`` route's 64-row tiles at dh 256)
FLASH_BLOCK_K = {"wgmma": 128, "splitkv": 64, "fma": 64, ("wgmma", 256): 64}
#: bf16 calls with at most this many query rows per kv head (S * H / KV,
#: the rows the split-KV kernel folds into its tiles) take the split-KV route
FLASH_SPLITKV_ROWS = 64
#: blocks the split-KV route aims to launch: two per SM of an H100 SXM
#: (at dh 128 one m16 row tile and its 3-stage ring take 112 KB)
FLASH_SPLIT_BLOCKS = 264
#: head dims at which fewer split-KV blocks fit an SM, and the blocks the
#: route then aims for: one per SM at dh 256 (one row tile and its 2-stage
#: ring take 143 KB)
_SPLIT_BLOCKS_AT = {256: 132}
_ROUTE_IDS = {"fma": 0, "wgmma": 1, "splitkv": 2}
_NEG_INF = -1e30
#: (q dtype, kv dtype) pairs the kernel takes
_DTYPES = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
           (torch.float32, torch.bfloat16)}


def _pick_q_chunk(s: int, t: int) -> int:
    """Query-chunk heuristic bounding the live score block ~(qc x T)
    (the reference's ``layers._pick_q_chunk``)."""
    if s * t <= 1 << 21 or s <= 256:
        return s
    if t >= 8192:
        return 256
    return 512


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           prefix_len: int, kv_len: Optional[int], q_start: int) -> None:
    for what, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"flash_attention: {what} must be a 4-D tensor")
    dev = q.device
    for what, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {what} is on {t.device}, "
                             f"q on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {dev}")
    b, _, h, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} disagree")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {k.shape[2]} kv heads")
    if k.dtype != v.dtype or (q.dtype, k.dtype) not in _DTYPES:
        raise ValueError(f"flash_attention: dtypes q {q.dtype}, k {k.dtype},"
                         f" v {v.dtype} are not supported")
    t = k.shape[1]
    if kv_len is not None and not 1 <= kv_len <= t:
        raise ValueError(f"flash_attention: kv_len {kv_len} is outside "
                         f"1..{t}")
    if prefix_len < 0 or q_start < 0:
        raise ValueError("flash_attention: prefix_len and q_start must be "
                         ">= 0")


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              prefix_len: int = 0,
                              kv_len: Optional[int] = None,
                              q_start: int = 0) -> torch.Tensor:
    """Plain version of :func:`flash_attention`: the reference's
    ``attn_core`` in eager PyTorch (full softmax per query chunk)."""
    _check(q, k, v, prefix_len, kv_len, q_start)
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))
    qg = q.reshape(b, s, kvh, g, dh).float()
    kf = k.to(q.dtype).float()
    vf = v.float()
    ki = torch.arange(t, device=q.device)[None, :]
    out = torch.empty((b, s, kvh, g, dh), dtype=torch.float32,
                      device=q.device)
    qc = _pick_q_chunk(s, t)
    for start in range(0, s, qc):
        blk = qg[:, start:start + qc]
        n = blk.shape[1]
        scores = torch.einsum("bqkgd,btkd->bkgqt", blk, kf) * scale
        allow = torch.ones((n, t), dtype=torch.bool, device=q.device)
        if causal:
            qi = q_start + start + torch.arange(n, device=q.device)[:, None]
            allow = ki <= qi
            if prefix_len:
                allow = allow | (ki < prefix_len)
        if kv_len is not None:
            allow = allow & (ki < kv_len)
        scores = torch.where(allow, scores, _NEG_INF)
        attn = torch.softmax(scores, dim=-1).to(v.dtype).float()
        out[:, start:start + n] = torch.einsum("bkgqt,btkd->bqkgd", attn, vf)
    return out.reshape(b, s, h, dh).to(q.dtype)


class FlashRoute(NamedTuple):
    """The kernel a call runs: ``name`` (``"wgmma"``, ``"splitkv"`` or
    ``"fma"``), its kv tile width, and the number of kv splits
    (``None`` unless ``"splitkv"``)."""
    name: str
    block_k: int
    splits: Optional[int]


def _block_k(name: str, dh: int) -> int:
    return FLASH_BLOCK_K.get((name, dh), FLASH_BLOCK_K[name])


def _col_end(s: int, kv_len: int, causal: bool, prefix_len: int,
             q_start: int) -> int:
    """One past the last kv column any of the ``s`` rows can see: the
    kernels walk tiles up to it and no further."""
    return min(kv_len, max(q_start + s, prefix_len)) if causal else kv_len


def flash_route(q_shape, k_shape, q_dtype: torch.dtype, *,
                causal: bool = True, prefix_len: int = 0,
                kv_len: Optional[int] = None,
                q_start: int = 0) -> FlashRoute:
    """The route :func:`flash_attention` takes on a CUDA device for these
    shapes and masks (a pure function of them).  float32 queries: the
    FMA kernel.  bf16: the split-KV kernel when ``S * H / KV`` is at most
    :data:`FLASH_SPLITKV_ROWS`, else the ``wgmma`` kernel.  ``block_k`` is
    the route's kv tile width at this head dim (:data:`FLASH_BLOCK_K`).
    The split count spreads the visible kv tiles over about
    :data:`FLASH_SPLIT_BLOCKS` blocks (132 at dh 256, where one block
    fills an SM), at least one tile a split."""
    return _route(q_shape, k_shape, q_dtype, causal, prefix_len,
                  k_shape[1] if kv_len is None else kv_len, q_start)[0]


def _route(q_shape, k_shape, q_dtype, causal, prefix_len, kv_len, q_start):
    """:func:`flash_route` and the split's length in tiles (0 unless
    split-KV)."""
    b, s, h, dh = q_shape
    kvh = k_shape[2]
    if q_dtype != torch.bfloat16:
        return FlashRoute("fma", _block_k("fma", dh), None), 0
    if s * (h // kvh) > FLASH_SPLITKV_ROWS:
        return FlashRoute("wgmma", _block_k("wgmma", dh), None), 0
    bk = _block_k("splitkv", dh)
    n_tiles = -(-_col_end(s, kv_len, causal, prefix_len, q_start) // bk)
    blocks = _SPLIT_BLOCKS_AT.get(dh, FLASH_SPLIT_BLOCKS)
    want = max(1, min(n_tiles, blocks // max(1, b * kvh)))
    per = -(-n_tiles // want)
    return FlashRoute("splitkv", bk, -(-n_tiles // per)), per


def flash_attention_recurrence(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               prefix_len: int = 0,
                               kv_len: Optional[int] = None,
                               q_start: int = 0, block_k: int = 64,
                               splits: Optional[int] = None
                               ) -> torch.Tensor:
    """The Pallas kernel's online softmax, in eager float32, over kv tiles
    of ``block_k`` rows from column 0 up to the last visible one: the
    unnormalised probabilities are rounded to ``v``'s dtype before the PV
    product (what B7 computes, up to the order of its float32 sums).  A
    bf16 score is the float32 rounding of its exact dot product (summed
    in float64), the value every float32 accumulation order approximates;
    a float32 score is summed in float32.

    With ``splits``, the tiles are cut as the split-KV kernel cuts them
    (``ceil(tiles / splits)`` a split); each split runs the recurrence
    from ``m = -1e30`` and the splits are combined in float32 as its
    combine kernel does: ``m* = max m_i``, ``l = sum l_i e^(m_i - m*)``,
    ``acc`` likewise, ``out = acc / max(l, 1e-30)``.  Hidden scores enter
    as ``-inf`` (their probability is 0 whatever the running max; the
    Pallas kernel's ``-1e30`` gives the same wherever a row has seen a
    column)."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    end = _col_end(s, t if kv_len is None else kv_len, causal, prefix_len,
                   q_start)
    n_tiles = -(-end // block_k)
    per = n_tiles if splits is None else -(-n_tiles // splits)
    scale = float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))
    # bf16 products are exact in float32: sum them exactly (float64) and
    # round once, the value any float32 accumulation order approximates;
    # float32 queries sum in float32, as the FMA kernel does
    acc_t = torch.float64 if q.dtype == torch.bfloat16 else torch.float32
    qf = q.to(acc_t).reshape(b, s, kvh, h // kvh, dh)
    qi = q_start + torch.arange(s, device=q.device)[:, None]
    parts = []
    for first in range(0, (1 if splits is None else splits) * per, per):
        m = torch.full((b, kvh, h // kvh, s, 1), _NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, h // kvh, s, dh), device=q.device)
        for tile in range(first, min(first + per, n_tiles)):
            t0, t1 = tile * block_k, min(tile * block_k + block_k, end)
            kt = k[:, t0:t1].to(q.dtype).to(acc_t)
            ki = torch.arange(t0, t1, device=q.device)[None, :]
            sc = torch.einsum("bqkgd,btkd->bkgqt", qf, kt).float() * scale
            if causal:
                sc = torch.where((ki <= qi) | (ki < prefix_len), sc,
                                 -math.inf)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha, p = torch.exp(m - m_new), torch.exp(sc - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(v.dtype).float(),
                v[:, t0:t1].float())
            m = m_new
        parts.append((m, l, acc))
    if splits is None:
        _, l, acc = parts[0]
    else:
        mx = parts[0][0]
        for m, _, _ in parts[1:]:
            mx = torch.maximum(mx, m)
        l, acc = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
        for m, li, ai in parts:
            w = torch.exp(m - mx)
            l = l + li * w
            acc = acc + ai * w
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


#: q, k, v, out, scratch, the int64 parameter array, the stream
_ARGTYPES = [ctypes.c_void_p] * 7


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, prefix_len: int = 0,
                    kv_len: Optional[int] = None,
                    q_start: int = 0) -> torch.Tensor:
    """(B, S, H, dh) attention of ``q`` over ``k`` / ``v`` (B, T, KV, dh);
    see the module docstring for the contract.

    CPU tensors run :func:`flash_attention_reference`; CUDA tensors
    launch the kernel of :func:`flash_route`.  The kernels take a head
    dim in :data:`FLASH_HEAD_DIMS`, a unit last stride, and 16-byte
    aligned rows (base pointers and every other stride); the wrapper
    raises otherwise.
    """
    _check(q, k, v, prefix_len, kv_len, q_start)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         prefix_len=prefix_len,
                                         kv_len=kv_len, q_start=q_start)
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if dh not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} is not one of "
                         f"{FLASH_HEAD_DIMS}")
    for what, x in (("q", q), ("k", k), ("v", v)):
        st = x.stride()
        # strides are multiples of 16 bytes iff their bitwise or is
        if st[3] != 1 or x.data_ptr() % 16 or \
                (st[0] | st[1] | st[2]) * x.element_size() % 16:
            raise ValueError(f"flash_attention: {what} needs a unit last "
                             f"stride and 16-byte aligned rows, got strides "
                             f"{st}")
    if h > 65535 or b > 65535:
        raise ValueError(f"flash_attention: {b} x {h} (batch x heads) "
                         f"exceeds the launch grid")
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    if s == 0 or b == 0:
        return out
    kv_len = t if kv_len is None else kv_len
    route, split_tiles = _route(q.shape, k.shape, q.dtype, causal,
                                prefix_len, kv_len, q_start)
    part = None
    if route.splits is not None:
        # each split's m, l and unnormalised acc for its folded rows
        part = torch.empty(b * kvh * route.splits * s * (h // kvh)
                           * (dh + 2), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention")
    launch = _bind(lib, "c4cam_flash_attention", _ARGTYPES)
    # the scalars travel as one int64 array (one ctypes argument, not 23)
    params = array.array("q", (
        b, s, h, kvh, dh, q.dtype == torch.bfloat16,
        k.dtype == torch.bfloat16, causal, prefix_len, kv_len, q_start,
        _ROUTE_IDS[route.name], split_tiles, route.splits or 0,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), params.buffer_info()[0])
    dev = q.device.index
    if dev == torch.cuda.current_device():
        err = launch(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = launch(*args, torch._C._cuda_getCurrentRawStream(dev))
    _raise_if_failed(lib, "flash_attention", err)
    _count("flash_attention")
    return out
