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
  the reference's ``fused_topk_pallas``;
* :func:`fused_topk_packed` — packed lanes, binary or ternary; replaces
  ``fused_topk_packed_pallas``.

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

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from . import build
from .packing import popcount32

__all__ = ["METRIC_COEFFS", "BLOCK_K", "MAX_K", "LAUNCHES", "window_rows",
           "reset_launch_counts", "fused_topk", "fused_topk_reference",
           "fused_topk_packed", "fused_topk_packed_reference"]

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

_NEG_BIG = -3.0e38
_POS_BIG = 3.0e38

#: launches per kernel since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"fused_topk": 0, "fused_topk_packed": 0,
                            "fused_topk_packed_ternary": 0}
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


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


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
                         k: int, largest: bool, n_valid: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_topk`: the same decomposition with a
    float32 matrix product (callers on a GPU keep TF32 off), then the
    same window top-k."""
    _check("fused_topk", q, p, None, torch.float32, k, n_valid)
    alpha, beta, gamma, qk, pk = METRIC_COEFFS[metric]
    dist = alpha * (q @ p.T)
    if beta:
        dist = dist + beta * _term(q, qk).sum(1, keepdim=True)
    if gamma:
        dist = dist + gamma * _term(p, pk).sum(1)[None, :]
    return _block_topk(dist, k=k, largest=largest, n_valid=n_valid)


#: elements of one (queries, rows, lanes) XOR block in the packed plain
#: version; chunking over queries keeps it near 256 MB at any gallery size
_PACKED_CHUNK_ELEMS = 1 << 26


def fused_topk_packed_reference(q: torch.Tensor, p: torch.Tensor,
                                care: Optional[torch.Tensor] = None, *,
                                k: int, largest: bool, n_valid: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_topk_packed`: SWAR popcount of
    ``(q ^ p) [& care]`` summed over lanes, chunked over queries, then
    the same window top-k."""
    _check("fused_topk_packed", q, p, care, torch.int32, k, n_valid)
    m, lanes_ = q.shape
    n = p.shape[0]
    dist = torch.empty((m, n), dtype=torch.float32, device=q.device)
    step = max(1, _PACKED_CHUNK_ELEMS // max(1, n * lanes_))
    for s in range(0, m, step):
        x = q[s:s + step, None, :] ^ p[None, :, :]
        if care is not None:
            x = x & care[None, :, :]
        dist[s:s + step] = popcount32(x).sum(-1).to(torch.float32)
    return _block_topk(dist, k=k, largest=largest, n_valid=n_valid)


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


def _bind(lib: ctypes.CDLL, fn: str, n_ptrs: int, n_ints: int):
    """The C entry point with its argument types set (pointers and the
    stream as c_void_p: a plain int would be cut to 32 bits)."""
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                      + [ctypes.c_void_p])
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
    :func:`fused_topk_reference`; CUDA tensors launch the kernel.
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
    launch = _bind(lib, "c4cam_fused_topk_f32", 4, 8)
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), p.data_ptr(), out_v.data_ptr(),
                     out_i.data_ptr(), q.shape[0], p.shape[0], q.shape[1],
                     k, window_rows(k), n_valid, int(largest),
                     _METRIC_CODE[metric],
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
    :func:`fused_topk`.
    """
    _check("fused_topk_packed", q, p, care, torch.int32, k, n_valid)
    if q.device.type == "cpu":
        return fused_topk_packed_reference(q, p, care, k=k, largest=largest,
                                           n_valid=n_valid)
    out_v, out_i = _outputs(q, p, k)
    if q.shape[0] == 0:
        return out_v, out_i
    lib = build.load("fused_topk_packed")
    launch = _bind(lib, "c4cam_fused_topk_packed", 5, 7)
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), p.data_ptr(),
                     None if care is None else care.data_ptr(),
                     out_v.data_ptr(), out_i.data_ptr(), q.shape[0],
                     p.shape[0], q.shape[1], k, window_rows(k), n_valid,
                     int(largest),
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_failed(lib, "fused_topk_packed", err)
    _count("fused_topk_packed" if care is None
           else "fused_topk_packed_ternary")
    return out_v, out_i
