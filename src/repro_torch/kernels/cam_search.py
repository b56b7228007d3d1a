"""Hopper kernels for CAM search: fused distance + block top-k.

A CAM subarray is a broadcast-compare-reduce engine.  Every supported
metric decomposes into a product plus rank-1 row/column corrections,

    hamming(q, p) = rowsum(q) + colsum(p) - 2 q.p      (q, p in {0,1})
    eucl^2(q, p)  = rowsum(q^2) + colsum(p^2) - 2 q.p
    dot(q, p)     =                              q.p

and binary/ternary cells additionally pack 32 to a lane, where the
distance is ``popcount(q ^ p [& care])``.  Two CUDA kernels (sources in
``csrc/``, built by :mod:`.build`) compute a block of distances and
write each window's block-local top-k — the subarray's winner-take-all
periphery — as (value, global row index) candidates:

* :func:`fused_topk` — float cells, the decomposition above; replaces
  the reference's ``fused_topk_pallas``; two routes by window
  (:func:`float_route`): 3xTF32 tensor-core products on B4's pipeline for
  128-row windows, float32 FMA for wider ones;
* :func:`fused_topk_packed` — packed lanes, binary or ternary; replaces
  ``fused_topk_packed_pallas``; two routes by shape
  (:func:`packed_route`): int8 tensor-core products over unpacked lanes
  when the grid fills the card, a warp per (query, window) otherwise;
* :func:`distance` — the full (M, N) float32 distance matrix of the same
  decomposition, no top-k (the public ``ops.cam_distances``); replaces
  ``distance_pallas``; 3xTF32 tensor-core products on the same pipeline.
* :func:`topk_select` — the (M, k) best entries of each row of an (M, N)
  float32 matrix by (value, lowest column), sorted, for any ``k``: the
  block top-k of ``fused_topk_pallas`` / ``fused_topk_packed_pallas``
  where no window fits in shared memory (``k > MAX_K``); a sampled bound,
  one filtering read of the matrix shared out over the card
  (:func:`select_grid`) and a radix select (``csrc/topk_select.cu``);
* :func:`packed_distance` — the (M, N) float32 matrix of
  ``popcount(q ^ p [& care])``: int8 ``wgmma`` products over lanes
  unpacked in shared memory, on the route :func:`packed_distance_route`
  picks (``csrc/packed_distance.cu``);
* :func:`topk_by_distance` / :func:`topk_by_packed_distance` — the search
  route for ``k > MAX_K`` (:func:`float_route` / :func:`packed_route`
  return ``"matrix"``): :func:`distance`'s kernel, or
  :func:`packed_distance`'s on the packed lanes, writes the (M, N) matrix
  and :func:`topk_select` takes the top-k from it.

:func:`tf32_split_product` is the 3xTF32 product in plain float32 (the
plain versions' ``tf32x3`` switch); :func:`tf32x3_kernel_eucl` replays
the tensor cores' own accumulation (:func:`tc_accumulate`) bit for bit.

The candidate ordering is the reference's ``_extract_block_topk``:
within a window, largest key first (key = value for ``largest``, else
``-value``), lowest global index on equal keys; rows at or beyond
``n_valid`` never win (key ``-3e38``, value ``∓3e38``).  Each kernel
picks its own blocking: a window is ``window_rows(k)`` gallery rows (a
multiple of 128, at least k), so the output is ``(M, n_windows * k)``.

Beside each kernel is its plain PyTorch version with the same output
(``*_reference``).  A wrapper runs the plain version for CPU tensors
only; for CUDA tensors it launches the kernel or raises.  Each launch
adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import build
from .ref import packed_distances, row_product

__all__ = ["METRIC_COEFFS", "BLOCK_K", "MAX_K", "LAUNCHES", "window_rows",
           "packed_route", "float_route", "reset_launch_counts",
           "tf32_round", "tf32_split_product", "tc_accumulate",
           "tf32x3_kernel_dot", "tf32x3_kernel_eucl", "fused_topk",
           "fused_topk_reference", "topk_by_distance",
           "topk_by_distance_reference", "topk_by_packed_distance",
           "topk_by_packed_distance_reference", "order_key",
           "topk_select", "topk_select_reference", "select_grid",
           "select_stretches", "PACKED_ROWS", "PackedDistanceRoute",
           "packed_distance_route", "packed_distance",
           "packed_distance_reference",
           "fused_topk_packed", "fused_topk_packed_reference", "distance",
           "distance_reference"]

#: metric -> (alpha, beta, gamma, q_term, p_term)
METRIC_COEFFS = {
    "hamming": (-2.0, 1.0, 1.0, "x", "x"),
    "eucl": (-2.0, 1.0, 1.0, "x2", "x2"),
    "dot": (1.0, 0.0, 0.0, "none", "none"),
}
_METRIC_CODE = {"hamming": 0, "eucl": 1, "dot": 2}

#: inner-dimension step of both kernels: operands' last axis (floats or
#: lanes) must be a positive multiple of it (zero padding is neutral)
BLOCK_K = 8
#: gallery rows per compute tile; a window is a multiple of it
_TILE_N = 128
#: the largest window whose (128 x window) float32 key block fits the
#: 227 KB of shared memory beside the operand tiles
_MAX_WINDOW = 384
#: largest k the kernels support (a window holds at least k rows)
MAX_K = _MAX_WINDOW
#: the packed distance kernel's row block: its patterns' rows are a
#: multiple of it (a packed matrix-route plan pads its gallery to it)
PACKED_ROWS = _TILE_N
#: topk_select.cu: the largest k sorted in shared memory (above it the
#: wrapper allocates the sort's scratch), the bytes of shared memory a
#: block takes besides that sort buffer, and the most a block may take
#: for two blocks to share an SM (228 KB, 1 KB reserved each)
_SELECT_SORT_CAP = 8192
_SELECT_SMEM = 91_136
_SM_SMEM_TWO_BLOCKS = 115_712
#: topk_select.cu's stretch unit (columns) and the candidates a row's
#: list holds
_SELECT_GROUP = 16
_SELECT_GATHER_CAP = 6144
#: packed_distance.cu: the widest lanes of a resident 128-query tile, the
#: most query rows of the swapped route, the bytes its unpacked queries may
#: take, and its block's shared memory besides them (binary, ternary)
_PD_RESIDENT_LANES = 32
_PD_SWAP_ROWS = 64
_PD_SWAP_Q_BYTES = 131_072
_PD_SWAP_SMEM = (1024 + 32_768 + 16_384 + 512, 1024 + 32_768 + 32_768 + 512)
_PD_ROUTES = {"resident": 0, "streamed": 1, "swapped": 2}

_NEG_BIG = -3.0e38
_POS_BIG = 3.0e38

#: launches per kernel since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"fused_topk": 0, "fused_topk_packed": 0,
                            "fused_topk_packed_ternary": 0,
                            "acam_match": 0, "range_match": 0,
                            "hdc_encode": 0, "hdc_encode_wide": 0,
                            "distance": 0, "distance_topk": 0,
                            "topk_select": 0, "packed_distance": 0,
                            "flash_attention": 0, "flash_attention_bwd": 0,
                            "ssd_scan": 0, "slstm_scan": 0}
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def window_rows(k: int) -> int:
    """Gallery rows per top-k window for ``k``: ``128 * ceil(k / 128)``."""
    if not 1 <= k <= MAX_K:
        raise ValueError(
            f"k={k} is outside the CAM search kernels' range 1..{MAX_K} "
            f"(a window of at least k rows must fit in shared memory)")
    return _TILE_N * -(-k // _TILE_N)


_SM_COUNT: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def packed_route(m: int, n: int, k: int, sms: int) -> str:
    """The route of a packed search on a card with ``sms`` streaming
    multiprocessors: ``"matrix"`` (:func:`topk_by_packed_distance`) when
    ``k`` exceeds :data:`MAX_K`; otherwise
    :func:`fused_topk_packed`'s ``"mma"`` (int8 tensor cores, 128 queries
    x one 128-row window a block) when the window is 128 rows and that
    grid has a block for every SM, else ``"rows"`` (a warp per (query,
    window), which only computes rows below ``n_valid``)."""
    if k > MAX_K:
        return "matrix"
    window = window_rows(k)
    if window == _TILE_N and -(-m // 128) * (n // window) >= sms:
        return "mma"
    return "rows"


def select_grid(m: int, k: int, n_valid: int, sms: int) -> int:
    """Blocks of a :func:`topk_select` launch for ``m`` rows on a card with
    ``sms`` streaming multiprocessors: every block slot (two blocks an SM
    while the sort buffer of ``k`` pairs leaves room for two, else one),
    and never more than the ``m * ceil(n_valid / 16)`` 16-column groups
    the rows' live columns make, so no block's stretch is empty."""
    smem = _SELECT_SMEM + (16 * k if k <= _SELECT_SORT_CAP else 0)
    slots = sms * (2 if smem <= _SM_SMEM_TWO_BLOCKS else 1)
    return max(1, min(slots, m * -(-n_valid // _SELECT_GROUP)))


def select_stretches(m: int, n_valid: int, grid: int) -> List[int]:
    """The live columns each of ``grid`` blocks of :func:`topk_select`
    reads: the ``m`` rows' live columns, cut into 16-column groups row
    by row, shared out in contiguous stretches of equal length, one
    group more or less (``topk_select.cu``'s division; a row's last
    group may be shorter)."""
    gpr = -(-n_valid // _SELECT_GROUP)
    total = m * gpr
    out = []
    for b in range(grid):
        g0, g1 = total * b // grid, total * (b + 1) // grid
        cols = 0
        while g0 < g1:
            row = g0 // gpr
            end = min(g1, (row + 1) * gpr)
            cols += min((end - row * gpr) * _SELECT_GROUP, n_valid) - \
                (g0 - row * gpr) * _SELECT_GROUP
            g0 = end
        out.append(cols)
    return out


class PackedDistanceRoute(NamedTuple):
    """:func:`packed_distance`'s route: ``name`` (``"swapped"``,
    ``"resident"`` or ``"streamed"``), the query rows a tile holds
    (``rows``) and the persistent grid (``grid``)."""
    name: str
    rows: int
    grid: int


def packed_distance_route(m: int, n: int, lanes: int, sms: int,
                          ternary: bool = False) -> PackedDistanceRoute:
    """The route of :func:`packed_distance` for ``m`` queries, ``n``
    pattern rows of ``lanes`` lanes (with a ``ternary`` care mask or not)
    on a card with ``sms`` streaming multiprocessors
    (``csrc/packed_distance.cu``): ``"swapped"`` for at most 64 queries
    whose unpacked lanes fit 128 KB (the gallery rows take ``wgmma``'s
    64-row side, the queries its N of 8, 16, 32 or 64 columns; 64-row
    gallery tiles, two one-warpgroup blocks an SM where their shared
    memory allows); else 128-query x 128-row tiles on one block an SM,
    ``"resident"`` (the query tile unpacked once a run) up to 32 lanes and
    ``"streamed"`` past them.  The grid never exceeds the tiles."""
    if m <= _PD_SWAP_ROWS:
        rows = next(r for r in (8, 16, 32, 64) if m <= r)
        q_bytes = rows * 32 * lanes
        if q_bytes <= _PD_SWAP_Q_BYTES:
            per_sm = 2 if _PD_SWAP_SMEM[ternary] + q_bytes <= \
                _SM_SMEM_TWO_BLOCKS else 1
            return PackedDistanceRoute("swapped", rows,
                                       max(1, min(per_sm * sms, n // 64)))
    tiles = -(-m // 128) * (n // _TILE_N)
    return PackedDistanceRoute(
        "resident" if lanes <= _PD_RESIDENT_LANES else "streamed", 128,
        max(1, min(sms, tiles)))


def float_route(k: int) -> str:
    """The route of a float search: ``"matrix"`` (:func:`topk_by_distance`)
    when ``k`` exceeds :data:`MAX_K`; otherwise :func:`fused_topk`'s
    ``"wgmma"`` (3xTF32 tensor cores, 128 queries x one window a block,
    the top-k selected from registers) when the window is 128 rows (k <=
    128), else ``"fma"`` (float32 FMA on the CUDA cores, the window's keys
    in shared memory)."""
    if k > MAX_K:
        return "matrix"
    return "wgmma" if window_rows(k) == _TILE_N else "fma"


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, the low 13 bits cleared: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    # add half a TF32 unit to the magnitude's bits, then truncate
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split_product(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``q @ p.T`` as the tensor-core kernels take it (3xTF32; B2's
    "wgmma" route and B4): each operand splits into ``hi = tf32(x)`` and
    ``lo = tf32(x - hi)``, and the product is ``lo_q hi_p + hi_q lo_p +
    hi_q hi_p``, each term a float32 matrix product (callers on a GPU keep
    TF32 off).  On {0, 1} and +-1 cells ``lo`` is 0 and the result equals
    ``q @ p.T``."""
    qh, ph = tf32_round(q), tf32_round(p)
    ql, pl = tf32_round(q - qh), tf32_round(p - ph)
    return (ql @ ph.T + qh @ pl.T) + qh @ ph.T


def tc_accumulate(acc: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """One ``wgmma`` TF32 k-step into a float32 accumulator as the tensor
    cores add it: ``acc`` (n,) plus the exact products of the TF32 rows
    ``a`` and ``b`` (n, 8), all aligned to the largest exponent among the
    accumulator's and the products' *nominal* ones (the sum of the
    operands' exponents, before a significand product of 2 or more is
    normalised), each truncated to 25 bits below it, summed, and the sum
    truncated (toward zero) to float32."""
    prod = a.double() * b.double()

    def exponent(x):                               # floor(log2 |x|)
        _, e = torch.frexp(x)
        return torch.where(x == 0, -1000, e - 1)

    nominal = torch.where(prod == 0, -1000,
                          exponent(a.double()) + exponent(b.double()))
    top = torch.maximum(nominal.amax(1), exponent(acc.double()))
    allv = torch.cat([acc.double()[:, None], prod], 1)
    quantum = torch.ldexp(torch.ones_like(allv[:, 0]), top - 25)[:, None]
    total = (torch.trunc(allv / quantum) * quantum).sum(1)
    f = total.float()
    over = f.double().abs() > total.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def tf32x3_kernel_dot(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The product ``q[i] . p[i]`` of row pairs as the 3xTF32 kernels
    accumulate it, bit for bit: the split (:func:`tf32_round`), then each
    k-step's eight products per term (lo.hi, hi.lo, hi.hi) added to the
    float32 accumulator as the tensor cores add them
    (:func:`tc_accumulate`).  B2's "wgmma" route returns it as the dot
    metric's value (no norms)."""
    qh, ph = tf32_round(q), tf32_round(p)
    ql, pl = tf32_round(q - qh), tf32_round(p - ph)
    acc = torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)
    for k0 in range(0, q.shape[1], 8):
        for a, b in ((ql, ph), (qh, pl), (qh, ph)):
            acc = tc_accumulate(acc, a[:, k0:k0 + 8], b[:, k0:k0 + 8])
    return acc


def tf32x3_kernel_eucl(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The squared eucl distance of row pairs ``(q[i], p[i])`` as the
    3xTF32 kernels (B2's "wgmma" route, B4, B6: ``tf32_wgmma.cuh``) compute
    it, bit for bit: the split (:func:`tf32_round`), each k-step's eight
    products per term added to the float32 accumulator as the tensor cores
    add them (:func:`tc_accumulate`; lo.hi, hi.lo, hi.hi), the norms as the
    kernels' threads sum them (fused multiply-adds), then
    ``(qn - 2 acc) + pn``."""
    f32 = torch.float32
    n, d = q.shape
    acc = tf32x3_kernel_dot(q, p)

    def fma_sum(x, order):                 # pn += x * x, in `order`
        acc_ = torch.zeros(n, dtype=f32, device=q.device)
        for k in order:
            v = x[:, k].double()
            acc_ = (acc_.double() + v * v).to(f32)
        return acc_

    stages = range(0, d, 32)
    # q: thread t of a quad holds columns 8 kk + t, 8 kk + t + 4
    qp_ = [fma_sum(q, [s0 + 8 * kk + t + 4 * h for s0 in stages
                       for kk in range(4) for h in range(2)
                       if s0 + 8 * kk + t + 4 * h < d]) for t in range(4)]
    qn = (qp_[0] + qp_[1]) + (qp_[2] + qp_[3])
    # p: two threads a row, floats 16 h .. 16 h + 15 of each stage
    pp_ = [fma_sum(p, [s0 + 16 * h + c for s0 in stages for c in range(16)
                       if s0 + 16 * h + c < d]) for h in range(2)]
    pn = pp_[0] + pp_[1]
    return ((qn.double() - 2.0 * acc.double()).to(f32) + pn).to(f32)


def _block_topk(dist: torch.Tensor, *, k: int, largest: bool,
                n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-window top-k of an (M, N) distance block (N a window multiple)
    with the kernels' ordering; returns (M, n_windows * k) candidates."""
    m, n = dist.shape
    window = window_rows(k)
    nw = n // window
    gidx = torch.arange(n, device=dist.device)
    lose = _NEG_BIG if largest else _POS_BIG
    dist = torch.where(gidx < n_valid, dist, lose).view(m, nw, window)
    key = dist if largest else -dist
    # + 0.0 maps -0.0 to +0.0: the sort then ties them, like IEEE compares
    _, order = torch.sort(key + 0.0, dim=-1, descending=True, stable=True)
    sel = order[..., :k]
    vals = torch.gather(dist, -1, sel)
    idx = sel + (torch.arange(nw, device=dist.device) * window)[None, :, None]
    return vals.reshape(m, nw * k), idx.to(torch.int32).reshape(m, nw * k)


def _term(x: torch.Tensor, kind: str) -> torch.Tensor:
    return x if kind == "x" else x * x


def fused_topk_reference(q: torch.Tensor, p: torch.Tensor, *, metric: str,
                         k: int, largest: bool, n_valid: int,
                         tf32x3: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_topk`: the same decomposition with a
    float32 matrix product (callers on a GPU keep TF32 off), then the
    same window top-k.  ``tf32x3`` takes the product as the "wgmma"
    route's tensor cores do (:func:`tf32_split_product`)."""
    _check("fused_topk", q, p, None, torch.float32, k, n_valid)
    alpha, beta, gamma, qk, pk = METRIC_COEFFS[metric]
    dist = alpha * (tf32_split_product(q, p) if tf32x3
                    else row_product(q, p))
    if beta:
        dist = dist + beta * _term(q, qk).sum(1, keepdim=True)
    if gamma:
        dist = dist + gamma * _term(p, pk).sum(1)[None, :]
    return _block_topk(dist, k=k, largest=largest, n_valid=n_valid)


#: elements of one (queries, rows, lanes) XOR block in the packed plain
#: version; chunking over queries keeps it near 256 MB at any gallery size
_PACKED_CHUNK_ELEMS = 1 << 26


def _packed_dist(q: torch.Tensor, p: torch.Tensor,
                 care: Optional[torch.Tensor]) -> torch.Tensor:
    """(M, N) float32 ``popcount(q ^ p [& care])``: the oracle's
    :func:`~.ref.packed_distances`, chunked over queries."""
    m, lanes_ = q.shape
    n = p.shape[0]
    dist = torch.empty((m, n), dtype=torch.float32, device=q.device)
    step = max(1, _PACKED_CHUNK_ELEMS // max(1, n * lanes_))
    for s in range(0, m, step):
        dist[s:s + step] = packed_distances(q[s:s + step], p, care)
    return dist


def fused_topk_packed_reference(q: torch.Tensor, p: torch.Tensor,
                                care: Optional[torch.Tensor] = None, *,
                                k: int, largest: bool, n_valid: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_topk_packed`: SWAR popcount of
    ``(q ^ p) [& care]`` summed over lanes, chunked over queries, then
    the same window top-k."""
    _check("fused_topk_packed", q, p, care, torch.int32, k, n_valid)
    return _block_topk(_packed_dist(q, p, care), k=k, largest=largest,
                       n_valid=n_valid)


def packed_distance_reference(q: torch.Tensor, p: torch.Tensor,
                              care: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version of :func:`packed_distance`: the oracle's
    ``popcount(q ^ p [& care])`` (:func:`~.ref.packed_distances`) over
    every pattern row, chunked over queries."""
    _check_packed_distance(q, p, care)
    return _packed_dist(q, p, care)


def distance_reference(q: torch.Tensor, p: torch.Tensor, *, metric: str,
                       tf32x3: bool = False) -> torch.Tensor:
    """Plain version of :func:`distance`: the decomposition with a
    float32 matrix product (callers on a GPU keep TF32 off).  ``tf32x3``
    takes the product as the kernel's tensor cores do
    (:func:`tf32_split_product`)."""
    _check_distance(q, p, metric)
    alpha, beta, gamma, qk, pk = METRIC_COEFFS[metric]
    dist = alpha * (tf32_split_product(q, p) if tf32x3
                    else row_product(q, p))
    if beta:
        dist = dist + beta * _term(q, qk).sum(1, keepdim=True)
    if gamma:
        dist = dist + gamma * _term(p, pk).sum(1)[None, :]
    return dist


def order_key(skey: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """One int64 per candidate ordered as (skey, gid): the float's
    order-preserving bits in the high word, the row id (< 2**31) in the
    low one.  ``+ 0.0`` folds -0.0 into +0.0, as a sort does; NaN never
    occurs (distances are finite or +-inf)."""
    bits = (skey + 0.0).contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (ordered.to(torch.int64) << 32) | gid.to(torch.int64)


def topk_select_reference(dist: torch.Tensor, *, k: int, largest: bool,
                          n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`topk_select`: the (M, k) best of an (M, N)
    distance matrix by (value, lowest column), from one int64 key per
    entry (:func:`order_key`), so ``torch.topk`` meets no tie; columns
    at or beyond ``n_valid`` lose."""
    _check_select(dist, k, n_valid)
    gid = torch.arange(dist.shape[1], device=dist.device, dtype=torch.int32)
    skey = -dist if largest else dist
    skey = torch.where(gid[None, :] < n_valid, skey, float("inf"))
    _, pos = torch.topk(order_key(skey, gid[None, :]), k, dim=-1,
                        largest=False, sorted=True)
    return torch.gather(dist, -1, pos), pos.to(torch.int32)


def topk_by_distance_reference(q: torch.Tensor, p: torch.Tensor, *,
                               metric: str, k: int, largest: bool,
                               n_valid: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`topk_by_distance`:
    :func:`distance_reference`, then :func:`topk_select_reference`."""
    _check_distance(q, p, metric)
    _check_n_valid("topk_by_distance", p.shape[0], n_valid)
    return topk_select_reference(distance_reference(q, p, metric=metric),
                                 k=k, largest=largest, n_valid=n_valid)


def topk_by_packed_distance_reference(q: torch.Tensor, p: torch.Tensor,
                                      care: Optional[torch.Tensor] = None, *,
                                      k: int, largest: bool, n_valid: int
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`topk_by_packed_distance`:
    :func:`packed_distance_reference`, then
    :func:`topk_select_reference`."""
    _check_n_valid("topk_by_packed_distance", p.shape[0], n_valid)
    return topk_select_reference(packed_distance_reference(q, p, care),
                                 k=k, largest=largest, n_valid=n_valid)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, q: torch.Tensor, p: torch.Tensor,
           care: Optional[torch.Tensor], dtype: torch.dtype, k: int,
           n_valid: int) -> None:
    ops = {"queries": q, "patterns": p}
    if care is not None:
        ops["care"] = care
    for what, t in ops.items():
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError(f"{name}: {what} must be a 2-D tensor")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {what} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, queries on "
                             f"{q.device}")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    window = window_rows(k)
    inner = q.shape[1]
    if p.shape[1] != inner or (care is not None and care.shape != p.shape):
        raise ValueError(f"{name}: operand widths differ: queries "
                         f"{tuple(q.shape)}, patterns {tuple(p.shape)}")
    if inner == 0 or inner % BLOCK_K:
        raise ValueError(f"{name}: inner dimension {inner} must be a "
                         f"positive multiple of {BLOCK_K} (pad_to_blocks)")
    if p.shape[0] == 0 or p.shape[0] % window:
        raise ValueError(f"{name}: {p.shape[0]} pattern rows must be a "
                         f"positive multiple of the k={k} window ({window})")
    if not 1 <= n_valid <= p.shape[0]:
        raise ValueError(f"{name}: n_valid={n_valid} outside "
                         f"1..{p.shape[0]}")
    if -(-q.shape[0] // 128) > 65535:
        raise ValueError(f"{name}: {q.shape[0]} query rows exceed the "
                         f"launch grid; split the batch")


def _args(n_ptrs: int, n_ints: int) -> list:
    """ctypes argument types of an entry point taking ``n_ptrs`` pointers,
    ``n_ints`` ints and the stream (pointers and the stream as c_void_p:
    a plain int would be cut to 32 bits)."""
    return [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + \
        [ctypes.c_void_p]


def _bind(lib: ctypes.CDLL, fn: str, argtypes: list):
    """The C entry point ``fn`` with its argument types set."""
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        lib.c4cam_error_string.argtypes = [ctypes.c_int]
        lib.c4cam_error_string.restype = ctypes.c_char_p
    return f


def _outputs(q: torch.Tensor, p: torch.Tensor, k: int):
    cols = (p.shape[0] // window_rows(k)) * k
    return (torch.empty((q.shape[0], cols), dtype=torch.float32,
                        device=q.device),
            torch.empty((q.shape[0], cols), dtype=torch.int32,
                        device=q.device))


def _raise_if_failed(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err:
        msg = lib.c4cam_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")


def fused_topk(q: torch.Tensor, p: torch.Tensor, *, metric: str, k: int,
               largest: bool, n_valid: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-local top-k of the float decomposition: (M, n_windows*k)
    candidate values/indices.

    ``q`` (M, D) and ``p`` (N, D) float32, contiguous, D a multiple of
    :data:`BLOCK_K`, N a multiple of ``window_rows(k)``; rows of ``p`` at
    or beyond ``n_valid`` are padding and never win.  CPU tensors run
    :func:`fused_topk_reference`; CUDA tensors launch the kernel on the
    route :func:`float_route` picks.
    """
    if metric not in METRIC_COEFFS:
        raise ValueError(f"fused_topk: unsupported metric {metric!r}")
    _check("fused_topk", q, p, None, torch.float32, k, n_valid)
    if q.device.type == "cpu":
        return fused_topk_reference(q, p, metric=metric, k=k,
                                    largest=largest, n_valid=n_valid)
    out_v, out_i = _outputs(q, p, k)
    if q.shape[0] == 0:
        return out_v, out_i
    lib = build.load("fused_topk")
    launch = _bind(lib, "c4cam_fused_topk_f32", _args(4, 9))
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), p.data_ptr(), out_v.data_ptr(),
                     out_i.data_ptr(), q.shape[0], p.shape[0], q.shape[1],
                     k, window_rows(k), n_valid, int(largest),
                     _METRIC_CODE[metric], int(float_route(k) == "wgmma"),
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_failed(lib, "fused_topk", err)
    _count("fused_topk")
    return out_v, out_i


def fused_topk_packed(q: torch.Tensor, p: torch.Tensor,
                      care: Optional[torch.Tensor] = None, *, k: int,
                      largest: bool, n_valid: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed binary/ternary variant of :func:`fused_topk`.

    Operands are int32 lane arrays (``packing.pack_bits``): ``q`` (M, L),
    ``p`` (N, L), optional per-pattern TCAM ``care`` mask (N, L); the
    distance is ``popcount(q ^ p [& care])`` — integer arithmetic end to
    end, bit-identical to the reference.  Shape rules as
    :func:`fused_topk`; the kernel's route is :func:`packed_route`.
    """
    _check("fused_topk_packed", q, p, care, torch.int32, k, n_valid)
    if q.device.type == "cpu":
        return fused_topk_packed_reference(q, p, care, k=k, largest=largest,
                                           n_valid=n_valid)
    out_v, out_i = _outputs(q, p, k)
    if q.shape[0] == 0:
        return out_v, out_i
    lib = build.load("fused_topk_packed")
    launch = _bind(lib, "c4cam_fused_topk_packed", _args(5, 8))
    route = packed_route(q.shape[0], p.shape[0], k, _sm_count(q.device))
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), p.data_ptr(),
                     None if care is None else care.data_ptr(),
                     out_v.data_ptr(), out_i.data_ptr(), q.shape[0],
                     p.shape[0], q.shape[1], k, window_rows(k), n_valid,
                     int(largest), int(route == "mma"),
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_failed(lib, "fused_topk_packed", err)
    _count("fused_topk_packed" if care is None
           else "fused_topk_packed_ternary")
    return out_v, out_i


def _check_distance(q: torch.Tensor, p: torch.Tensor, metric: str) -> None:
    if metric not in METRIC_COEFFS:
        raise ValueError(f"distance: unsupported metric {metric!r}")
    for what, t in (("queries", q), ("patterns", p)):
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError(f"distance: {what} must be a 2-D tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"distance: {what} must be torch.float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"distance: {what} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"distance: {what} is on {t.device}, queries "
                             f"on {q.device}")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"distance: {what} must be 16-byte aligned")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"distance: unsupported device {q.device}")
    inner = q.shape[1]
    if p.shape[1] != inner:
        raise ValueError(f"distance: operand widths differ: queries "
                         f"{tuple(q.shape)}, patterns {tuple(p.shape)}")
    if inner == 0 or inner % BLOCK_K:
        raise ValueError(f"distance: inner dimension {inner} must be a "
                         f"positive multiple of {BLOCK_K} (pad_to_blocks)")


def distance(q: torch.Tensor, p: torch.Tensor, *, metric: str
             ) -> torch.Tensor:
    """(M, N) float32 distance matrix of the decomposition for ``metric``
    (hamming on {0, 1} cells, squared eucl, dot), no top-k.

    ``q`` (M, D), ``p`` (N, D) float32, contiguous, D a multiple of
    :data:`BLOCK_K` (zero padding is neutral); any M and N.  CPU tensors
    run :func:`distance_reference`; CUDA tensors launch the kernel.
    """
    _check_distance(q, p, metric)
    if q.device.type == "cpu":
        return distance_reference(q, p, metric=metric)
    return _launch_distance(q, p, metric, "distance")


def topk_by_distance(q: torch.Tensor, p: torch.Tensor, *, metric: str,
                     k: int, largest: bool, n_valid: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, k) best rows by (value, lowest row id), for any ``k`` up to
    ``n_valid``: the float search route where ``k`` exceeds
    :data:`MAX_K`.

    The distance kernel writes the (M, N) matrix of ``metric``'s
    decomposition (operands as :func:`distance` takes them; counted as
    ``"distance_topk"``) and :func:`topk_select` takes the top ``k``,
    sorted; rows at or beyond ``n_valid`` lose.  On {0, 1} and +-1 cells
    every entry is an exact integer, so hamming and dot results are
    bit-identical to the reference.  CPU tensors run
    :func:`topk_by_distance_reference`.
    """
    _check_distance(q, p, metric)
    _check_n_valid("topk_by_distance", p.shape[0], n_valid)
    if q.device.type == "cpu":
        return topk_by_distance_reference(q, p, metric=metric, k=k,
                                          largest=largest, n_valid=n_valid)
    dist = _launch_distance(q, p, metric, "distance_topk")
    return topk_select(dist, k=k, largest=largest, n_valid=n_valid)


def topk_by_packed_distance(q: torch.Tensor, p: torch.Tensor,
                            care: Optional[torch.Tensor] = None, *, k: int,
                            largest: bool, n_valid: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed search route where ``k`` exceeds :data:`MAX_K`: two
    launches, :func:`packed_distance` (K1p, int8 ``wgmma``) writing the
    (M, N) matrix of ``popcount(q ^ p [& care])`` from the packed lanes,
    then :func:`topk_select` (K1s) taking the top ``k`` by (value, lowest
    row id), sorted; rows at or beyond ``n_valid`` lose.  Integers end to
    end: bit-identical to the reference.  Operands as
    :func:`packed_distance` takes them; CPU tensors run
    :func:`topk_by_packed_distance_reference`."""
    _check_packed_distance(q, p, care)
    _check_n_valid("topk_by_packed_distance", p.shape[0], n_valid)
    if q.device.type == "cpu":
        return topk_by_packed_distance_reference(
            q, p, care, k=k, largest=largest, n_valid=n_valid)
    return topk_select(packed_distance(q, p, care), k=k, largest=largest,
                       n_valid=n_valid)


def _check_n_valid(name: str, n: int, n_valid: int) -> None:
    if not 1 <= n_valid <= n:
        raise ValueError(f"{name}: n_valid={n_valid} outside 1..{n}")


def _check_select(dist: torch.Tensor, k: int, n_valid: int) -> None:
    if not isinstance(dist, torch.Tensor) or dist.dim() != 2 or \
            dist.dtype != torch.float32:
        raise ValueError("topk_select: the matrix must be a 2-D float32 "
                         "tensor")
    if not dist.is_contiguous():
        raise ValueError("topk_select: the matrix must be contiguous")
    if dist.device.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_select: unsupported device {dist.device}")
    _check_n_valid("topk_select", dist.shape[1], n_valid)
    if not 1 <= k <= n_valid:
        raise ValueError(f"topk_select: k={k} outside 1..{n_valid}")


def topk_select(dist: torch.Tensor, *, k: int, largest: bool,
                n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (M, k) best entries of each row of the (M, N) float32 matrix
    ``dist``, sorted by (key, lowest column) with key ``-dist`` for
    ``largest`` and ``dist`` otherwise (-0.0 ties +0.0); columns at or
    beyond ``n_valid`` lose; any ``1 <= k <= n_valid``.  Returns the
    entries' own values (float32) and columns (int32).

    CPU tensors run :func:`topk_select_reference`; CUDA tensors launch
    ``csrc/topk_select.cu`` once on :func:`select_grid` blocks, each
    reading an equal stretch of the live columns (:func:`select_stretches`)
    past a sampled bound into per-row candidate lists; the last block to
    read a row selects its k from them (or, when they overflow or fall
    short, by a radix select over the row) and sorts them.
    """
    _check_select(dist, k, n_valid)
    if dist.device.type == "cpu":
        return topk_select_reference(dist, k=k, largest=largest,
                                     n_valid=n_valid)
    m, n = dist.shape
    out_v = torch.empty((m, k), dtype=torch.float32, device=dist.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=dist.device)
    if m == 0:
        return out_v, out_i
    stream = _raw_stream(dist.device)
    cand, counters = _select_scratch(dist.device, stream, m)
    # above the shared-memory sort: two (key, column) pairs of 8 bytes per
    # selected entry and row
    scratch = torch.empty((m, 4 * k), dtype=torch.int32, device=dist.device) \
        if k > _SELECT_SORT_CAP else None
    lib = build.load("topk_select")
    launch = _bind(lib, "c4cam_topk_select", _args(6, 6))
    with _on_device(dist.device):
        err = launch(dist.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                     cand.data_ptr(), counters.data_ptr(),
                     None if scratch is None else scratch.data_ptr(), m, n,
                     k, n_valid, int(largest),
                     select_grid(m, k, n_valid, _sm_count(dist.device)), stream)
    _raise_if_failed(lib, "topk_select", err)
    _count("topk_select")
    return out_v, out_i


#: per (device, stream): each row's candidate list and its slot and
#: arrival counters for :func:`topk_select`, grown to the most rows seen;
#: the kernel leaves the counters zero, so they are zeroed once
_SELECT_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_SCRATCH_LOCK = threading.Lock()


def _select_scratch(device: torch.device, stream: int, m: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    with _SCRATCH_LOCK:
        have = _SELECT_SCRATCH.get(key)
        if have is None or have[0].shape[0] < m:
            # allocated on the current stream, the one the launch runs on
            have = (torch.empty((m, 2 * _SELECT_GATHER_CAP), dtype=torch.int32,
                                device=device),
                    torch.zeros(2 * m, dtype=torch.int32, device=device))
            _SELECT_SCRATCH[key] = have
        return have


def _raw_stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a pointer-sized int (the
    raw query where PyTorch has it: a ``Stream`` object costs microseconds
    a call)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index if device.index is not None
                   else torch.cuda.current_device())
    return torch.cuda.current_stream(device).cuda_stream


def _on_device(device: torch.device):
    """``torch.cuda.device(device)`` where it is not the current device
    already (a launch goes to the current device's context)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _check_packed_distance(q: torch.Tensor, p: torch.Tensor,
                           care: Optional[torch.Tensor]) -> None:
    name = "packed_distance"
    ops = {"queries": q, "patterns": p}
    if care is not None:
        ops["care"] = care
    for what, t in ops.items():
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError(f"{name}: {what} must be a 2-D tensor")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {what} must be torch.int32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, queries on "
                             f"{q.device}")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    lanes_ = q.shape[1]
    if p.shape[1] != lanes_ or (care is not None and care.shape != p.shape):
        raise ValueError(f"{name}: operand widths differ: queries "
                         f"{tuple(q.shape)}, patterns {tuple(p.shape)}")
    if lanes_ == 0 or lanes_ % BLOCK_K:
        raise ValueError(f"{name}: {lanes_} lanes must be a positive "
                         f"multiple of {BLOCK_K} (pad_to_blocks)")
    if p.shape[0] == 0 or p.shape[0] % PACKED_ROWS:
        raise ValueError(f"{name}: {p.shape[0]} pattern rows must be a "
                         f"positive multiple of {PACKED_ROWS}")


def packed_distance(q: torch.Tensor, p: torch.Tensor,
                    care: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, N) float32 ``popcount(q ^ p [& care])`` of packed int32 lanes
    (``packing.pack_bits``): ``q`` (M, L), ``p`` and the optional TCAM
    ``care`` mask (N, L), L a multiple of :data:`BLOCK_K`, N a multiple
    of :data:`PACKED_ROWS` (zero padding is neutral for the lanes; padding
    rows get their own distances).  Exact integers, bit-identical to the
    reference.  CPU tensors run :func:`packed_distance_reference`; CUDA
    tensors launch ``csrc/packed_distance.cu`` (int8 ``wgmma`` on lanes
    unpacked in shared memory) on the route and persistent grid that
    :func:`packed_distance_route` picks."""
    _check_packed_distance(q, p, care)
    if q.device.type == "cpu":
        return packed_distance_reference(q, p, care)
    out = torch.empty((q.shape[0], p.shape[0]), dtype=torch.float32,
                      device=q.device)
    if q.shape[0] == 0:
        return out
    route = packed_distance_route(q.shape[0], p.shape[0], q.shape[1],
                                  _sm_count(q.device), care is not None)
    lib = build.load("packed_distance")
    launch = _bind(lib, "c4cam_packed_distance", _args(4, 5))
    with _on_device(q.device):
        err = launch(q.data_ptr(), p.data_ptr(),
                     None if care is None else care.data_ptr(),
                     out.data_ptr(), q.shape[0], p.shape[0], q.shape[1],
                     _PD_ROUTES[route.name], route.grid, _raw_stream(q.device))
    _raise_if_failed(lib, "packed_distance", err)
    _count("packed_distance")
    return out


def _launch_distance(q: torch.Tensor, p: torch.Tensor, metric: str,
                     count_as: str) -> torch.Tensor:
    out = torch.empty((q.shape[0], p.shape[0]), dtype=torch.float32,
                      device=q.device)
    if q.shape[0] == 0 or p.shape[0] == 0:
        return out
    lib = build.load("distance")
    launch = _bind(lib, "c4cam_distance", _args(3, 4))
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), p.data_ptr(), out.data_ptr(), q.shape[0],
                     p.shape[0], q.shape[1], _METRIC_CODE[metric],
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_failed(lib, "distance", err)
    _count(count_as)
    return out
