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

``start`` (a 0-dim int32 tensor on ``q``'s device, or None) is the rows a
decode cache held before this call, read on the device: query row ``s``
then sits at ``start + q_start + s`` and the columns below ``start +
kv_len`` are visible.  A call captured in a CUDA graph reads it at every
replay, where a host ``kv_len`` would stay what it was at capture.  The
split-KV grid is then :func:`device_start_splits` splits, the most any
live length's cut can give, and the kernel cuts the visible tiles as
:func:`flash_route` would cut them at the live length (the splits past
them weigh 0); the prefill route's tensor maps
then cover all ``T`` rows, and the rows past ``kv_len`` that its last
tile fetches (masked, probability 0) must be finite, as a decode cache's
zeros and earlier rows are.

The wrapper runs the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  The kernels are built for the
head dims of :data:`FLASH_HEAD_DIMS`; another head dim up to 256 is
zero-padded to the next one (zero columns leave every score and the
kept output columns unchanged; the scale stays ``1/sqrt`` of the
caller's dim) and the output sliced back, and an operand with a
non-unit last stride or rows off 16 bytes is first copied to a dense
one.  :func:`flash_route` picks the kernel from the shape: bf16 calls with more than
:data:`FLASH_SPLITKV_ROWS` query rows per kv head (``S * H / KV``) run
the prefill kernel (``wgmma`` on a TMA ring), the others the split-KV
decode kernel and its combine; float32 queries run the FMA kernel.  Each
call adds one to :data:`.cam_search.LAUNCHES` (``"flash_attention"``),
whatever the route.

Gradients: on the card, a call that autograd records (grad mode on and
an operand that requires grad) goes through :class:`FlashAttentionFn`,
whose forward also writes each row's float32 log-sum-exp and whose
backward is :func:`flash_attention_backward`, the hand-written kernels
of ``csrc/flash_attention_bwd.cu`` (``"flash_attention_bwd"`` in the
launch counts; deterministic, no atomics).  On the CPU the plain
version runs under autograd.  :func:`flash_attention_backward_reference`
is the backward's plain version: the same formulas step by step in
float32.

:func:`flash_attention_recurrence` is the Pallas kernel's own recurrence
in eager float32 (the unnormalised probabilities rounded to ``v``'s
dtype before the PV product), over kv tiles of ``block_k`` rows and,
with ``splits``, split as the decode kernel splits the kv walk: the
checks hold each route to it at the route's tile width and splits.
"""

from __future__ import annotations

import array
import ctypes
import functools
import math
import struct
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import build
from .cam_search import _bind, _count, _raise_if_failed

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_backward", "flash_attention_backward_reference",
           "FlashAttentionFn", "flash_attention_recurrence", "flash_route",
           "FlashRoute", "flash_bwd_route", "FlashBwdRoute",
           "FLASH_HEAD_DIMS", "FLASH_BLOCK_K", "FLASH_SPLITKV_ROWS",
           "FLASH_SPLIT_BLOCKS", "flash_bwd_slices", "device_start_splits"]

#: head dims the kernels are instantiated for; the wrapper pads any other
#: head dim up to the last of them to the next one
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
_BWD_ROUTE_IDS = {"fma": 0, "wgmma": 2}
#: the backward's kv and query tile rows (a dK / dV block's kv tile, a
#: (Q, dO) stage)
_BWD_ROWS = 64
#: SMs of an H100 SXM, :func:`flash_bwd_slices`'s default: one dh-256
#: dK / dV block fills an SM (226 KB of shared memory); the wrapper passes
#: its card's own count (:func:`_sm_count`)
_BWD_SMS = 132
#: the most slices :func:`flash_bwd_slices` cuts a pair's stages into
_BWD_MAX_SLICES = 32
#: query rows a block of the backward's ``"wgmma"`` dQ kernel owns: the
#: (lse, D) scratch is padded to a multiple of it
_BWD_ROWS_PAD = 128
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
           prefix_len: int, kv_len: Optional[int], q_start: int,
           start: Optional[torch.Tensor] = None) -> None:
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
    if start is not None and (
            not isinstance(start, torch.Tensor) or start.dim() != 0
            or start.dtype != torch.int32 or start.device != dev
            or kv_len is None):
        raise ValueError("flash_attention: start must be a 0-dim int32 "
                         "tensor on q's device, with kv_len given")


def _scale(dh: int) -> float:
    """``1/sqrt(dh)`` rounded to float32, the scale of every score."""
    return struct.unpack("<f", struct.pack("<f", 1.0 / math.sqrt(dh)))[0]


def _allow(n: int, t: int, start: int, causal: bool, prefix_len: int,
           kv_len: Optional[int], q_start: int, device) -> torch.Tensor:
    """(n, t) visibility of the columns to query rows ``start .. start+n``."""
    ki = torch.arange(t, device=device)[None, :]
    allow = torch.ones((n, t), dtype=torch.bool, device=device)
    if causal:
        qi = q_start + start + torch.arange(n, device=device)[:, None]
        allow = ki <= qi
        if prefix_len:
            allow = allow | (ki < prefix_len)
    if kv_len is not None:
        allow = allow & (ki < kv_len)
    return allow


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              prefix_len: int = 0,
                              kv_len: Optional[int] = None,
                              q_start: int = 0, return_lse: bool = False,
                              start: Optional[torch.Tensor] = None):
    """Plain version of :func:`flash_attention`: the reference's
    ``attn_core`` in eager PyTorch (full softmax per query chunk).  With
    ``return_lse``, also each row's float32 log-sum-exp of the scaled
    scores, (B, H, S), as the kernels write it for the backward.  A
    device ``start`` enters the masks as a tensor (no host read)."""
    _check(q, k, v, prefix_len, kv_len, q_start, start)
    if start is not None:
        q_start, kv_len = start + q_start, start + kv_len
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = _scale(dh)
    qg = q.reshape(b, s, kvh, g, dh).float()
    kf = k.to(q.dtype).float()
    vf = v.float()
    out = torch.empty((b, s, kvh, g, dh), dtype=torch.float32,
                      device=q.device)
    lse = torch.empty((b, kvh, g, s), dtype=torch.float32, device=q.device)
    qc = _pick_q_chunk(s, t)
    for start in range(0, s, qc):
        blk = qg[:, start:start + qc]
        n = blk.shape[1]
        scores = torch.einsum("bqkgd,btkd->bkgqt", blk, kf) * scale
        scores = torch.where(_allow(n, t, start, causal, prefix_len, kv_len,
                                    q_start, q.device), scores, _NEG_INF)
        if return_lse:
            lse[..., start:start + n] = torch.logsumexp(scores.detach(), -1)
        attn = torch.softmax(scores, dim=-1).to(v.dtype).float()
        out[:, start:start + n] = torch.einsum("bkgqt,btkd->bqkgd", attn, vf)
    out = out.reshape(b, s, h, dh).to(q.dtype)
    return (out, lse.reshape(b, h, s)) if return_lse else out


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, d_out: torch.Tensor, *, causal: bool = True,
        prefix_len: int = 0, kv_len: Optional[int] = None,
        q_start: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_attention_backward`: from the
    forward's output and row log-sum-exp ``lse`` (B, H, S), in float32
    and query chunk by chunk, ``P = exp(S * scale - lse)`` (0 where
    hidden), ``dV = P^T dO``, ``dS = P (dO V^T - D)`` with ``D =
    rowsum(dO * O)``, ``dQ = scale dS K``, ``dK = scale dS^T Q``; the
    group's query heads summed into their kv head.  Returns (dq, dk, dv)
    in the dtypes of q, k and v."""
    _check(q, k, v, prefix_len, kv_len, q_start)
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = _scale(dh)
    qg = q.reshape(b, s, kvh, g, dh).float()
    dog = d_out.reshape(b, s, kvh, g, dh).float()
    kf = k.to(q.dtype).float()
    vf = v.float()
    big_d = (dog * out.reshape(b, s, kvh, g, dh).float()).sum(-1)
    lse_g = lse.reshape(b, kvh, g, s)
    dq = torch.empty((b, s, kvh, g, dh), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((b, t, kvh, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    qc = _pick_q_chunk(s, t)
    for start in range(0, s, qc):
        blk, dob = qg[:, start:start + qc], dog[:, start:start + qc]
        n = blk.shape[1]
        scores = torch.einsum("bqkgd,btkd->bkgqt", blk, kf) * scale
        p = torch.exp(scores - lse_g[..., start:start + n, None])
        p = torch.where(_allow(n, t, start, causal, prefix_len, kv_len,
                               q_start, q.device), p, 0.0)
        dv += torch.einsum("bkgqt,bqkgd->btkd", p, dob)
        dp = torch.einsum("bqkgd,btkd->bkgqt", dob, vf)
        ds = p * (dp - big_d[:, start:start + n].permute(0, 2, 3, 1)[..., None])
        dq[:, start:start + n] = torch.einsum("bkgqt,btkd->bqkgd", ds,
                                              kf) * scale
        dk += torch.einsum("bkgqt,bqkgd->btkd", ds, blk) * scale
    return (dq.reshape(b, s, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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
    """:func:`flash_route` and the splits a (batch row, kv head) pair aims
    for (0 unless split-KV): the kernel cuts the visible tiles into
    splits of ``ceil(tiles / min(tiles, aim))`` tiles."""
    b, s, h, dh = q_shape
    dh = _padded_dim(dh)
    kvh = k_shape[2]
    if q_dtype != torch.bfloat16:
        return FlashRoute("fma", _block_k("fma", dh), None), 0
    if s * (h // kvh) > FLASH_SPLITKV_ROWS:
        return FlashRoute("wgmma", _block_k("wgmma", dh), None), 0
    bk = _block_k("splitkv", dh)
    n_tiles = -(-_col_end(s, kv_len, causal, prefix_len, q_start) // bk)
    blocks = _SPLIT_BLOCKS_AT.get(dh, FLASH_SPLIT_BLOCKS)
    aim = max(1, blocks // max(1, b * kvh))
    return FlashRoute("splitkv", bk, _split_count(n_tiles, aim)), aim


def _split_count(n_tiles: int, aim: int) -> int:
    """The splits the split-KV kernel cuts ``n_tiles`` visible tiles into
    when it aims for ``aim``: ``ceil(n / per)`` of ``per = ceil(n /
    min(n, aim))`` tiles (the kernel's own arithmetic)."""
    per = -(-n_tiles // max(1, min(n_tiles, aim)))
    return -(-n_tiles // per)


def device_start_splits(q_shape, k_shape, q_dtype: torch.dtype, *,
                        causal: bool = True, prefix_len: int = 0
                        ) -> Optional[int]:
    """The split-KV grid's splits for a call with a device ``start`` over a
    view of ``k_shape[1]`` rows (None off the split-KV route):
    ``min(capacity tiles, aim)``.  The live length is not known on the
    host, and the kernel's cut of ``n`` tiles, ``ceil(n / ceil(n /
    min(n, aim)))``, is not monotone in ``n`` (at ``aim`` 8, 33 tiles
    give 7 splits and 8 tiles 8), so the grid holds the most any
    ``n`` up to the capacity can give: ``ceil(n / ceil(n / m)) <= m``
    for ``m = min(n, aim)``."""
    t = k_shape[1]
    return _start_grid(*_route(q_shape, k_shape, q_dtype, causal,
                               prefix_len, t, max(t - q_shape[1], 0)), t)


def _start_grid(route: FlashRoute, aim: int, t: int) -> Optional[int]:
    """:func:`device_start_splits` from the route at a view of ``t`` rows
    and its aim."""
    return None if route.splits is None else min(-(-t // route.block_k), aim)


class FlashBwdRoute(NamedTuple):
    """The kernels :func:`flash_attention_backward` launches: ``name``
    (``"wgmma"``: bf16 on Hopper's tensor cores, fed by TMA; ``"fma"``:
    float32 on the CUDA cores), and whether the dK / dV kernel's block
    owns kv tiles ``j`` and ``n - 1 - j`` (``paired``: causal walks of
    equal length)."""
    name: str
    paired: bool


def flash_bwd_route(q_shape, k_shape, dtype: torch.dtype, *,
                    causal: bool = True, prefix_len: int = 0,
                    kv_len: Optional[int] = None,
                    q_start: int = 0) -> FlashBwdRoute:
    """The route :func:`flash_attention_backward` takes on a CUDA device
    (a pure function of the shapes, dtype and masks).  float32: the FMA
    kernels.  bf16: the ``wgmma`` kernels at every head dim (causal calls
    pair kv tile ``j`` with ``n - 1 - j``, so every dK / dV block walks
    about the same number of q tiles).  Up to a padded dh of 128 a dK /
    dV block holds a kv tile's float32 dK and dV in each consumer
    warpgroup; at 256 the two warpgroups split dh, and the tile pairs'
    stages are cut into :func:`flash_bwd_slices` slices whose partial
    sums a second pass adds."""
    del k_shape, prefix_len, kv_len, q_start     # the route reads none
    if dtype != torch.bfloat16:
        return FlashBwdRoute("fma", False)
    return FlashBwdRoute("wgmma", bool(causal))


def _bwd_first_row(t0: int, s: int, causal: bool, prefix_len: int,
                   kv_len: int, q_start: int) -> int:
    """The first row of the first q tile that sees a column of the kv
    tile at ``t0``; ``s`` when none does (a copy of ``wb::first_q_row``
    in ``csrc/flash_attention_bwd.cu``, which must stay in step)."""
    if t0 >= kv_len:
        return s
    first = max(0, t0 - q_start) if causal and t0 >= prefix_len else 0
    return s if first >= s else first - first % _BWD_ROWS


def _bwd_unit_stages(s: int, t: int, group: int, causal: bool,
                     prefix_len: int, kv_len: int, q_start: int) -> list:
    """The (query head, q tile) stages of each dK / dV unit at dh 256: a
    kv tile pair ``(x, n - 1 - x)`` when causal (the route pairs causal
    calls), else one tile (``total`` of ``wh::walk_of`` in
    ``csrc/flash_attention_bwd.cu``, which must stay in step)."""
    n = -(-t // _BWD_ROWS)
    nq = [-(-(s - _bwd_first_row(j * _BWD_ROWS, s, causal, prefix_len,
                                 kv_len, q_start)) // _BWD_ROWS)
          for j in range(n)]
    if not causal:
        return [group * c for c in nq]
    return [group * (nq[x] + (nq[n - 1 - x] if n - 1 - x != x else 0))
            for x in range(-(-n // 2))]


def _bwd_cut(stages: int, slices: int) -> list:
    """The stages each of ``slices`` contiguous slices of a unit's
    ``stages`` takes, in slice order (a copy of ``wh::walk_of``'s cut
    ``[a, b)`` in ``csrc/flash_attention_bwd.cu``, which must stay in
    step): equal, one more or less."""
    return [(i + 1) * stages // slices - i * stages // slices
            for i in range(slices)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_bwd_slices(q_shape, k_shape, *, causal: bool = True,
                     prefix_len: int = 0, kv_len: Optional[int] = None,
                     q_start: int = 0, sms: int = _BWD_SMS) -> int:
    """The number of slices the bf16 dh-256 dK / dV kernel cuts each
    unit's stages into on a card of ``sms`` SMs (a pure function of the
    shapes, masks and ``sms``; 1 at other head dims, whose kernel does
    not slice).  A unit is a kv tile pair of one kv head and batch row
    (one tile unless causal); its stages, the (query head, q tile) pairs
    that see it, are cut into contiguous slices of equal length
    (:func:`_bwd_cut`), one block each.  Of 1 to :data:`_BWD_MAX_SLICES`
    (and no more than a unit's stages), the count with the least
    modelled time: whole waves of ``sms`` blocks (one a SM) times the
    longest slice's stages plus 2 for a block's K / V load and its
    partial sums' stores, plus the partial sums' trip through memory (a
    kv tile's written and read again: about 1 / 24 of a stage of the
    whole card), the fewest slices among equals.  The slices fix the
    order of dK's and dV's float32 sums, so runs are bit-identical on
    one card, and on cards of one SM count."""
    b, s, h, dh = q_shape
    t, kvh = k_shape[1], k_shape[2]
    return _bwd_slices(int(b), int(s), int(t), int(h), int(kvh), int(dh),
                       bool(causal), int(prefix_len),
                       int(t if kv_len is None else kv_len), int(q_start),
                       int(sms))


@functools.lru_cache(maxsize=1024)
def _bwd_slices(b: int, s: int, t: int, h: int, kvh: int, dh: int,
                causal: bool, prefix_len: int, kv_len: int,
                q_start: int, sms: int) -> int:
    """:func:`flash_bwd_slices` on plain ints, cached: the rule walks
    every kv tile, tens of microseconds of host time a call."""
    if _padded_dim(dh) != 256:
        return 1
    units = _bwd_unit_stages(s, t, h // kvh, causal, prefix_len, kv_len,
                             q_start)
    n_units, most = len(units) * kvh * b, max(units)

    def cost(n: int) -> float:
        waves = -(-n_units * n // sms)
        return waves * (max(_bwd_cut(most, n)) + 2) + n_units * (n + 1) / 24

    return min(range(1, max(1, min(most, _BWD_MAX_SLICES)) + 1),
               key=lambda n: (cost(n), n))


def flash_attention_recurrence(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               prefix_len: int = 0,
                               kv_len: Optional[int] = None,
                               q_start: int = 0, block_k: int = 64,
                               splits: Optional[int] = None,
                               bounds: Optional[Sequence[int]] = None
                               ) -> torch.Tensor:
    """The Pallas kernel's online softmax, in eager float32, over kv tiles
    of ``block_k`` rows from column 0 up to the last visible one: the
    unnormalised probabilities are rounded to ``v``'s dtype before the PV
    product (what B7 computes, up to the order of its float32 sums).  A
    bf16 score is the float32 rounding of its exact dot product (summed
    in float64), the value every float32 accumulation order approximates;
    a float32 score is summed in float32.

    With ``splits``, the tiles are cut as the split-KV kernel cuts them
    (``ceil(tiles / min(tiles, splits))`` a split: ``splits`` may be
    :func:`flash_route`'s count or the splits the kernel aims for, the cut
    is the same); with ``bounds``, the splits start at those columns (the
    first 0) and each is cut into tiles from its own start: the key
    slices of KV-parallel attention.  Each split runs the recurrence
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
    if bounds is None:
        per = n_tiles if splits is None else \
            -(-n_tiles // max(1, min(n_tiles, splits)))
        n_split = -(-n_tiles // per) if splits is not None else 1
        bounds = [i * per * block_k for i in range(max(n_split, 1))]
    elif list(bounds)[:1] != [0] or sorted(bounds) != list(bounds):
        raise ValueError(f"flash_attention_recurrence: bounds {bounds} must "
                         f"rise from 0")
    edges = list(bounds) + [max(end, bounds[-1])]
    scale = float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))
    # bf16 products are exact in float32: sum them exactly (float64) and
    # round once, the value any float32 accumulation order approximates;
    # float32 queries sum in float32, as the FMA kernel does
    acc_t = torch.float64 if q.dtype == torch.bfloat16 else torch.float32
    qf = q.to(acc_t).reshape(b, s, kvh, h // kvh, dh)
    qi = q_start + torch.arange(s, device=q.device)[:, None]
    parts = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = torch.full((b, kvh, h // kvh, s, 1), _NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, h // kvh, s, dh), device=q.device)
        for t0 in range(lo, min(hi, end), block_k):
            t1 = min(t0 + block_k, hi, end)
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
    if len(parts) == 1:
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


#: q, k, v, out, scratch, lse, the device start, the int64 parameter
#: array, the stream
_ARGTYPES = [ctypes.c_void_p] * 9
#: q, k, v, out, d_out, lse, the (lse, D) scratch, dq, dk, dv, the
#: parameter array, the stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 12


def _padded_dim(dh: int) -> int:
    """The instantiated head dim the kernels run ``dh`` at: the smallest
    of :data:`FLASH_HEAD_DIMS` at least ``dh``."""
    for d in FLASH_HEAD_DIMS:
        if d >= dh:
            return d
    raise ValueError(f"flash_attention: head dim {dh} exceeds the largest "
                     f"the kernels take, {FLASH_HEAD_DIMS[-1]}")


def _aligned(x: torch.Tensor) -> bool:
    """A unit last stride and 16-byte aligned rows: the base pointer and
    every other stride (strides are multiples of 16 bytes iff their
    bitwise or is)."""
    st = x.stride()
    return st[3] == 1 and x.data_ptr() % 16 == 0 and \
        (st[0] | st[1] | st[2]) * x.element_size() % 16 == 0


def _kernel_operand(x: torch.Tensor, dp: int, dense: bool) -> torch.Tensor:
    """``x`` as a kernel takes it: zero-padded to head dim ``dp`` (a new
    dense tensor), else copied to a dense one when ``dense`` is asked
    and ``x`` is not, or when its rows are off 16 bytes."""
    if x.shape[3] != dp:
        return torch.nn.functional.pad(x, (0, dp - x.shape[3]))
    if (dense and not x.is_contiguous()) or not _aligned(x):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _launch(lib, fn, argtypes, args, dev) -> int:
    launch = _bind(lib, fn, argtypes)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if dev == torch.cuda.current_device():
        return launch(*args, stream)
    with torch.cuda.device(dev):
        return launch(*args, stream)


def _forward_cuda(q, k, v, causal, prefix_len, kv_len, q_start,
                  want_lse: bool, start: Optional[torch.Tensor] = None):
    """B7 on the card: (out, lse or None); with a device ``start`` the
    kernels add it to ``q_start`` and ``kv_len``."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if h > 65535 or b > 65535:
        raise ValueError(f"flash_attention: {b} x {h} (batch x heads) "
                         f"exceeds the launch grid")
    kv_len = t if kv_len is None else kv_len
    dp = _padded_dim(dh)
    if dp != dh and start is None:   # no kernel reads a row past kv_len
        k, v = k[:, :kv_len], v[:, :kv_len]
    # the rows the prefill route's tensor maps cover: up to kv_len, or the
    # whole view when kv_len is read on the device (the rows past it in
    # the tile that straddles it are then fetched, masked, and must be
    # finite: a decode cache's zeros or earlier rows)
    extent = kv_len if start is None else k.shape[1]
    kq, kk, kv_ = (_kernel_operand(x, dp, False) for x in (q, k, v))
    out = torch.empty((b, s, h, dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if want_lse else None
    if s == 0 or b == 0:
        return out[..., :dh], lse
    route, aim = _route(q.shape, k.shape, q.dtype, causal, prefix_len,
                        *((kv_len, q_start) if start is None
                          else (extent, max(extent - s, 0))))
    # a device start: the grid for any live length the view can hold
    n_splits = route.splits if start is None else \
        _start_grid(route, aim, extent)
    part = None
    if n_splits is not None:
        # each split's m, l and unnormalised acc for its folded rows
        part = torch.empty(b * kvh * n_splits * s * (h // kvh)
                           * (dp + 2), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention")
    # the scalars travel as one int64 array (one ctypes argument, not 24)
    params = array.array("q", (
        b, s, h, kvh, dp, q.dtype == torch.bfloat16,
        k.dtype == torch.bfloat16, causal, prefix_len, kv_len, q_start,
        _ROUTE_IDS[route.name], aim, n_splits or 0,
        *kq.stride()[:3], *kk.stride()[:3], *kv_.stride()[:3],
        struct.unpack("<I", struct.pack("<f", _scale(dh)))[0], extent))
    args = (kq.data_ptr(), kk.data_ptr(), kv_.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if start is None else start.data_ptr(),
            params.buffer_info()[0])
    err = _launch(lib, "c4cam_flash_attention", _ARGTYPES, args,
                  q.device.index)
    _raise_if_failed(lib, "flash_attention", err)
    _count("flash_attention")
    return (out if dp == dh else out[..., :dh]), lse


class FlashAttentionFn(torch.autograd.Function):
    """B7 with its gradient on the card: the forward kernel, which also
    writes each row's log-sum-exp, and B7b (on fake tensors through their
    custom ops, :mod:`.lm_ops`).  :func:`flash_attention` applies it to
    CUDA operands whenever autograd records the call."""

    @staticmethod
    def forward(ctx, q, k, v, causal, prefix_len, kv_len, q_start):
        from .lm_ops import flash_fwd
        kv = -1 if kv_len is None else kv_len
        out, lse = flash_fwd(q, k, v, causal, prefix_len, kv, q_start, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, prefix_len, kv, q_start)
        return out

    @staticmethod
    def backward(ctx, d_out):
        from .lm_ops import flash_bwd
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, d_out, *ctx.masks)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, prefix_len: int = 0,
                    kv_len: Optional[int] = None,
                    q_start: int = 0,
                    start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, H, dh) attention of ``q`` over ``k`` / ``v`` (B, T, KV, dh);
    see the module docstring for the contract (and for ``start``, the
    device length a captured decode step reads: inference only).

    CPU tensors run :func:`flash_attention_reference`; CUDA tensors
    launch the kernel of :func:`flash_route` (through
    :class:`FlashAttentionFn` when autograd records the call); fake
    tensors trace through the custom ops of :mod:`.lm_ops`.  A head dim
    outside :data:`FLASH_HEAD_DIMS` (at most 256) is zero-padded, and an
    operand with a non-unit last stride or rows off 16 bytes copied,
    before the launch.
    """
    from .lm_ops import flash_fwd, is_fake
    _check(q, k, v, prefix_len, kv_len, q_start, start)
    if q.device.type == "cpu" and not is_fake(q):
        return flash_attention_reference(q, k, v, causal=causal,
                                         prefix_len=prefix_len,
                                         kv_len=kv_len, q_start=q_start,
                                         start=start)
    if start is not None:
        if is_fake(q) or (torch.is_grad_enabled() and (
                q.requires_grad or k.requires_grad or v.requires_grad)):
            raise ValueError("flash_attention: a device start serves "
                             "inference on real tensors only")
        out, _ = _forward_cuda(q, k, v, causal, prefix_len, kv_len, q_start,
                               False, start)
        return out
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, prefix_len, kv_len,
                                      q_start)
    return flash_fwd(q, k, v, causal, prefix_len,
                     -1 if kv_len is None else kv_len, q_start, False)[0]


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, d_out: torch.Tensor, *,
                             causal: bool = True, prefix_len: int = 0,
                             kv_len: Optional[int] = None, q_start: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Gradients (dq, dk, dv) of :func:`flash_attention` at ``q, k, v``
    given its output ``out``, its rows' float32 log-sum-exp ``lse``
    (B, H, S) and the output's gradient ``d_out``; each in its operand's
    dtype.

    CPU tensors run :func:`flash_attention_backward_reference`; CUDA
    tensors launch the kernels of ``csrc/flash_attention_bwd.cu`` on the
    route of :func:`flash_bwd_route` (one count of
    ``"flash_attention_bwd"``) or raise.  They take one dtype:
    a float32 ``q`` over a bfloat16 cache runs with ``k`` and ``v``
    widened to float32 (exact), the forward's own precision for the
    scores.  Other head dims are padded as the forward pads them.
    """
    _check(q, k, v, prefix_len, kv_len, q_start)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, out, lse, d_out, causal=causal, prefix_len=prefix_len,
            kv_len=kv_len, q_start=q_start)
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if out.shape != q.shape or d_out.shape != q.shape or \
            tuple(lse.shape) != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_backward: out {tuple(out.shape)}"
                         f", d_out {tuple(d_out.shape)} and lse "
                         f"{tuple(lse.shape)} {lse.dtype} do not match q "
                         f"{tuple(q.shape)}")
    if h > 65535 or b > 65535:
        raise ValueError(f"flash_attention_backward: {b} x {h} (batch x "
                         f"heads) exceeds the launch grid")
    dt = q.dtype
    dp = _padded_dim(dh)
    kq, kk, kv_, ko, kg = (_kernel_operand(x.to(dt), dp, True)
                           for x in (q, k, v, out, d_out))
    lse = lse.contiguous()
    dq = torch.empty((b, s, h, dp), dtype=dt, device=q.device)
    dk = torch.empty((b, t, kvh, dp), dtype=dt, device=q.device)
    dv = torch.empty_like(dk)
    if s and b and t:
        route = flash_bwd_route(q.shape, k.shape, dt, causal=causal)
        sliced = route.name == "wgmma" and dp == 256
        slices = flash_bwd_slices(
            q.shape, k.shape, causal=causal, prefix_len=prefix_len,
            kv_len=kv_len, q_start=q_start,
            sms=_sm_count(q.device.index)) if sliced else 1
        # the wgmma route's (lse log2 e, D) pairs over rows padded to
        # _BWD_ROWS_PAD (the fma route's D in the first b * h * s
        # floats), then at dh 256 the slices' partial dK and dV
        s_pad = -(-s // _BWD_ROWS_PAD) * _BWD_ROWS_PAD
        part = 2 * slices * b * t * kvh * dp if sliced else 0
        scratch = torch.empty(2 * b * h * s_pad + part, dtype=torch.float32,
                              device=q.device)
        lib = build.load("flash_attention_bwd")
        params = array.array("q", (
            b, s, t, h, kvh, dp, dt == torch.bfloat16, causal, prefix_len,
            t if kv_len is None else kv_len, q_start,
            struct.unpack("<I", struct.pack("<f", _scale(dh)))[0],
            _BWD_ROUTE_IDS[route.name], route.paired, slices))
        args = tuple(x.data_ptr() for x in (kq, kk, kv_, ko, kg, lse,
                                            scratch, dq, dk, dv)) \
            + (params.buffer_info()[0],)
        err = _launch(lib, "c4cam_flash_attention_bwd", _BWD_ARGTYPES, args,
                      q.device.index)
        _raise_if_failed(lib, "flash_attention_bwd", err)
        _count("flash_attention_bwd")
    if dp != dh:
        dq, dk, dv = dq[..., :dh], dk[..., :dh], dv[..., :dh]
    return dq, dk.to(k.dtype), dv.to(v.dtype)


# the custom ops FlashAttentionFn and flash_attention call (registered here,
# after every name lm_ops reads is defined)
from . import lm_ops  # noqa: E402,F401
