"""Hopper kernels for analog-CAM range search: interval and threshold match.

An analog CAM cell stores an interval ``[lo, hi]`` and matches while the
input lies inside it; a row's match line stays high iff every cell
matches.  That primitive executes a root-to-leaf decision-tree branch in
one search, and with a distance threshold it is the paper's TH sensing
mode.  Two CUDA kernels (sources in ``csrc/``, built by :mod:`.build`)
write a ``torch.bool`` (M, N) match matrix:

* :func:`acam_match` — interval match: ``lo <= q <= hi`` in every
  dimension (``q < lo or q > hi`` is a violation; a row matches with
  none); replaces the reference's ``acam_match_pallas``.  The kernel
  tests no compare: it ORs the sign bits of ``q - lo`` and ``hi - q`` on
  canonical operands; :func:`acam_match_signbits` is that arithmetic in
  torch;
* :func:`range_match` — the float distance decomposition of
  :mod:`.cam_search`, mapped to the logical domain (identity, or the
  bipolar ``dim - 2h``) and compared against a threshold (``v <= tau``,
  or ``v >= tau`` with ``below=False``); replaces ``range_match_pallas``.
  Its product runs on the tensor cores as 3xTF32; :func:`tf32_split_product`
  is the same arithmetic in plain float32, which explains where the kernel
  and the float32 plain version fall on either side of ``tau``.

Rows at or beyond ``n_valid`` never match.  Zero padding of the inner
dimension is safe for both: a padded dim carries ``q = lo = hi = 0`` (no
violation) or ``q = p = 0`` (no distance).  The kernels take any number
of query and gallery rows; the inner dimension must be a multiple of
:data:`ACAM_BLOCK_D` (interval) or :data:`~.cam_search.BLOCK_K`
(threshold).

Beside each kernel is its plain PyTorch version (``*_reference``).  A
wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises.  Each launch adds one to
:data:`.cam_search.LAUNCHES` (``"acam_match"``, ``"range_match"``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .cam_search import (BLOCK_K, METRIC_COEFFS, _METRIC_CODE,
                         _PACKED_CHUNK_ELEMS, _args, _bind, _count,
                         _raise_if_failed, _term, tf32_round,
                         tf32_split_product)
from .ref import row_product

__all__ = ["ACAM_BLOCK_D", "acam_match", "acam_match_reference",
           "acam_match_signbits",
           "range_match", "range_match_reference", "tf32_round",
           "tf32_split_product"]

#: dims per shared-memory stage of the interval kernel: the inner
#: dimension of its operands must be a positive multiple of it
ACAM_BLOCK_D = 16
_TO_LOGICAL = ("identity", "bipolar")


def _check(name: str, ops: dict, block: int, n_valid: int) -> None:
    q = ops["queries"]
    rows = None
    for what, t in ops.items():
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError(f"{name}: {what} must be a 2-D tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be torch.float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, queries on "
                             f"{q.device}")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
        if t.shape[1] != q.shape[1]:
            raise ValueError(f"{name}: operand widths differ: queries "
                             f"{tuple(q.shape)}, {what} {tuple(t.shape)}")
        if what != "queries":
            if rows is not None and t.shape != rows:
                raise ValueError(f"{name}: lo and hi shapes differ")
            rows = t.shape
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    inner, n = q.shape[1], rows[0]
    if inner == 0 or inner % block:
        raise ValueError(f"{name}: inner dimension {inner} must be a "
                         f"positive multiple of {block} (pad_to_blocks)")
    if n == 0 or not 1 <= n_valid <= n:
        raise ValueError(f"{name}: n_valid={n_valid} outside 1..{n}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _interval_match(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    n_valid: int, violates) -> torch.Tensor:
    """``not any(violates(q, lo, hi))`` per (query, row) over the dims,
    chunked over queries so the (queries, rows, dims) block stays near
    64 M elements at any gallery size; rows at or past ``n_valid`` False."""
    m, dim = q.shape
    n = lo.shape[0]
    out = torch.empty((m, n), dtype=torch.bool, device=q.device)
    step = max(1, _PACKED_CHUNK_ELEMS // max(1, n * dim))
    for s in range(0, m, step):
        out[s:s + step] = ~violates(q[s:s + step, None, :], lo[None],
                                    hi[None]).any(-1)
    out[:, n_valid:] = False
    return out


def acam_match_reference(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                         *, n_valid: int) -> torch.Tensor:
    """Plain version of :func:`acam_match`: ``not any(q < lo or q > hi)``
    per (query, row)."""
    _check("acam_match", {"queries": q, "lo": lo, "hi": hi}, ACAM_BLOCK_D,
           n_valid)
    return _interval_match(q, lo, hi, n_valid,
                           lambda x, a, b: (x < a) | (x > b))


def _card_bits(x: torch.Tensor) -> torch.Tensor:
    """The int32 bits of float32 ``x`` as the card's FADD leaves them:
    ``x + 0`` (-0 becomes +0) and any NaN the positive 0x7FFFFFFF (a CPU
    keeps a NaN's sign and payload)."""
    return torch.where(torch.isnan(x), 0x7FFFFFFF,
                       (x + 0.0).view(torch.int32))


def acam_match_signbits(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                        *, n_valid: int) -> torch.Tensor:
    """:func:`acam_match` in the kernel's arithmetic: operands made
    canonical (``_card_bits``), then a pair matches iff no dimension sets
    the sign bit of ``bits(q - lo) | bits(hi - q)``, the differences'
    NaNs canonical too.  Equal to :func:`acam_match_reference` on every
    input, signed zeros, NaNs, infinities and subnormals included."""
    _check("acam_match", {"queries": q, "lo": lo, "hi": hi}, ACAM_BLOCK_D,
           n_valid)
    qc, loc, hic = (_card_bits(x).view(torch.float32) for x in (q, lo, hi))
    return _interval_match(
        qc, loc, hic, n_valid,
        lambda x, a, b: (_card_bits(x - a) | _card_bits(b - x)) < 0)


def range_match_reference(q: torch.Tensor, p: torch.Tensor, *, metric: str,
                          threshold: float, below: bool, to_logical: str,
                          dim: int, n_valid: int,
                          tf32x3: bool = False) -> torch.Tensor:
    """Plain version of :func:`range_match`: the decomposition with a
    float32 matrix product (callers on a GPU keep TF32 off), the logical
    map, and the compare.  ``tf32x3`` takes the product as the kernel's
    tensor cores do (:func:`tf32_split_product`)."""
    _check_range_args(metric, to_logical)
    _check("range_match", {"queries": q, "patterns": p}, BLOCK_K, n_valid)
    alpha, beta, gamma, qk, pk = METRIC_COEFFS[metric]
    dist = alpha * (tf32_split_product(q, p) if tf32x3
                    else row_product(q, p))
    if beta:
        dist = dist + beta * _term(q, qk).sum(1, keepdim=True)
    if gamma:
        dist = dist + gamma * _term(p, pk).sum(1)[None, :]
    v = dist if to_logical == "identity" else float(dim) - 2.0 * dist
    hit = (v <= threshold) if below else (v >= threshold)
    hit[:, n_valid:] = False
    return hit


def _check_range_args(metric: str, to_logical: str) -> None:
    if metric not in METRIC_COEFFS:
        raise ValueError(f"range_match: unsupported metric {metric!r}")
    if to_logical not in _TO_LOGICAL:
        raise ValueError(f"range_match: to_logical must be one of "
                         f"{_TO_LOGICAL}, got {to_logical!r}")


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def acam_match(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, *,
               n_valid: int) -> torch.Tensor:
    """(M, N) ``torch.bool`` interval match: row ``j`` matches query ``i``
    iff ``lo[j, d] <= q[i, d] <= hi[j, d]`` for every ``d`` and
    ``j < n_valid``.

    ``q`` (M, D), ``lo`` / ``hi`` (N, D) float32, contiguous, D a
    multiple of :data:`ACAM_BLOCK_D`.  CPU tensors run
    :func:`acam_match_reference`; CUDA tensors launch the kernel.
    """
    _check("acam_match", {"queries": q, "lo": lo, "hi": hi}, ACAM_BLOCK_D,
           n_valid)
    if q.device.type == "cpu":
        return acam_match_reference(q, lo, hi, n_valid=n_valid)
    out = torch.empty((q.shape[0], lo.shape[0]), dtype=torch.bool,
                      device=q.device)
    if q.shape[0] == 0:
        return out
    lib = build.load("acam_match")
    launch = _bind(lib, "c4cam_acam_match", _args(4, 4))
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                     out.data_ptr(), q.shape[0], lo.shape[0], q.shape[1],
                     n_valid, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_failed(lib, "acam_match", err)
    _count("acam_match")
    return out


def range_match(q: torch.Tensor, p: torch.Tensor, *, metric: str,
                threshold: float, below: bool, to_logical: str, dim: int,
                n_valid: int) -> torch.Tensor:
    """(M, N) ``torch.bool`` threshold match of the physical ``metric``
    (hamming / eucl / dot), mapped by ``to_logical`` (``"identity"`` or
    ``"bipolar"``: ``dim - 2h``) and compared with ``threshold`` in
    float32 (``<=`` when ``below``, else ``>=``).

    ``q`` (M, D), ``p`` (N, D) float32, contiguous, D a multiple of
    :data:`~.cam_search.BLOCK_K`.  CPU tensors run
    :func:`range_match_reference`; CUDA tensors launch the kernel.
    """
    _check_range_args(metric, to_logical)
    _check("range_match", {"queries": q, "patterns": p}, BLOCK_K, n_valid)
    if q.device.type == "cpu":
        return range_match_reference(q, p, metric=metric,
                                     threshold=threshold, below=below,
                                     to_logical=to_logical, dim=dim,
                                     n_valid=n_valid)
    out = torch.empty((q.shape[0], p.shape[0]), dtype=torch.bool,
                      device=q.device)
    if q.shape[0] == 0:
        return out
    lib = build.load("range_match")
    launch = _bind(lib, "c4cam_range_match",        # tau is a C float
                   [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + _args(0, 4))
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), p.data_ptr(), out.data_ptr(), q.shape[0],
                     p.shape[0], q.shape[1], n_valid, float(threshold),
                     int(below), int(to_logical == "bipolar"), int(dim),
                     _METRIC_CODE[metric],
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_failed(lib, "range_match", err)
    _count("range_match")
    return out
