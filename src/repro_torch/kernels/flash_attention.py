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
tensors it launches the kernel or raises.  Each launch adds one to
:data:`.cam_search.LAUNCHES` (``"flash_attention"``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build
from .cam_search import _bind, _count, _raise_if_failed

__all__ = ["flash_attention", "flash_attention_reference", "FLASH_HEAD_DIMS"]

#: head dims the kernel is instantiated for
FLASH_HEAD_DIMS = (16, 32, 64, 128)
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
        if t.device != q.device:
            raise ValueError(f"flash_attention: {what} is on {t.device}, "
                             f"q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
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


#: four pointers, eleven ints, nine int64 strides, the stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
             + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, prefix_len: int = 0,
                    kv_len: Optional[int] = None,
                    q_start: int = 0) -> torch.Tensor:
    """(B, S, H, dh) attention of ``q`` over ``k`` / ``v`` (B, T, KV, dh);
    see the module docstring for the contract.

    CPU tensors run :func:`flash_attention_reference`; CUDA tensors
    launch the kernel.  The kernel takes a head dim in
    :data:`FLASH_HEAD_DIMS`, a unit last stride, and 16-byte aligned
    rows (base pointers and every other stride); it raises otherwise.
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
        size = x.element_size()
        if x.stride(3) != 1 or x.data_ptr() % 16 or \
                any(x.stride(i) * size % 16 for i in range(3)):
            raise ValueError(f"flash_attention: {what} needs a unit last "
                             f"stride and 16-byte aligned rows, got strides "
                             f"{x.stride()}")
    if h > 65535 or b > 65535:
        raise ValueError(f"flash_attention: {b} x {h} (batch x heads) "
                         f"exceeds the launch grid")
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    if s == 0 or b == 0:
        return out
    lib = build.load("flash_attention")
    launch = _bind(lib, "c4cam_flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, s, h, kvh, dh,
                     int(q.dtype == torch.bfloat16),
                     int(k.dtype == torch.bfloat16), int(causal),
                     prefix_len, t if kv_len is None else kv_len, q_start,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_failed(lib, "flash_attention", err)
    _count("flash_attention")
    return out
