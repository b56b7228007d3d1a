"""Hopper kernel for the Mamba2 chunked SSD scan (M1).

:func:`ssd_scan` launches the CUDA kernels of ``csrc/ssd_scan.cu``
(built by :mod:`.build`): the chunked scan of ``models/mamba2.py``'s
prefill, with the ``D`` skip and the cast to the input's dtype folded in.
It replaces no TPU kernel: the reference computes the scan as einsums
under ``lax.scan`` (``src/repro/models/mamba2.py:115`` ``chunk_body``,
scanned at ``:151``), and its eager counterpart here, :func:`chunk_scan`,
launches about 25 kernels a chunk and block: 2,048 chunks x 54 blocks at
524,288 tokens.  :func:`ssd_scan_reference` (padding, :func:`chunk_scan`,
the skip, the cast) is M1's plain version, the reference's own code.

Contract, in the reference's layout: ``xh`` (b, S, nh, dh) and ``B_`` /
``C_`` (b, S, ds), all float32 or all bfloat16, each with a unit last
stride (a view of the block's convolution output); ``dt`` (b, S, nh),
``A`` (nh,), ``D`` (nh,) and the carried state ``h`` (b, nh, dh, ds)
float32 -> (``y`` (b, S, nh * dh) in ``xh``'s dtype, the final state
float32).  The kernels take ``dh`` and ``ds`` up to
:data:`SSD_MAX_DIM` and a chunk up to :data:`SSD_MAX_CHUNK`; rows past S
read as the zeros the plain version pads with.  Every product runs on the
tensor cores (TF32 ``wgmma``) with each float32 operand split into a TF32
hi and lo half (3xTF32, the lo.lo term dropped); a bf16 operand is exact
in TF32 and is not split.  The sums run in other orders than the plain
version's, within the tolerances ``chip_smoke.py`` states.

:func:`ssd_route` names the route: the kernel for CUDA tensors that are
not fake when autograd records nothing (grad mode off, or no operand
that requires grad); the plain version on the CPU, on fake tensors (the
dry run) and for a step that autograd records (training differentiates
the eager code, as the reference differentiates ``lax.scan``: no backward
kernel exists).  On the kernel route a call the kernels do not take
raises; nothing gives way to the plain version.  Each call adds one to
:data:`.cam_search.LAUNCHES` (``"ssd_scan"``); it launches three kernels.
"""

from __future__ import annotations

import array
import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import build
from .cam_search import _count, _raise_if_failed
from .flash_attention import _launch
from .lm_ops import is_fake

__all__ = ["ssd_scan", "ssd_scan_reference", "chunk_scan", "ssd_route",
           "records_grad", "SSD_MAX_DIM", "SSD_MAX_CHUNK"]

#: the largest head dim and state dim the kernels take (their 64 x 64 tiles)
SSD_MAX_DIM = 64
#: the longest chunk the kernels take
SSD_MAX_CHUNK = 256
#: x, B, C, dt, A, D, h0, y, h_out, the state scratch, the chunk totals,
#: the parameter array, the stream
_ARGTYPES = [ctypes.c_void_p] * 13
_DTYPES = (torch.float32, torch.bfloat16)


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an operation on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ssd_route(*tensors: torch.Tensor) -> str:
    """``"kernel"`` for CUDA tensors, not fake, that autograd does not
    record; ``"plain"`` otherwise (the CPU, the dry run's fake tensors,
    a training step)."""
    t = tensors[0]
    if is_fake(t) or t.device.type != "cuda" or records_grad(*tensors):
        return "plain"
    return "kernel"


def chunk_scan(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
               dt: torch.Tensor, A: torch.Tensor, h: torch.Tensor,
               chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan over S (padded to whole chunks by the
    caller): xh (b, S, nh, dh), B_ / C_ (b, S, ds), dt (b, S, nh)
    float32, A (nh,), h (b, nh, dh, ds) the carried state.  Returns
    (y (b, S, nh, dh) float32, the final state)."""
    b, s, nh, dh = xh.shape
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                 device=xh.device))
    ys = []
    for c0 in range(0, s, chunk):
        xck = xh[:, c0:c0 + chunk].float()
        bck = B_[:, c0:c0 + chunk].float()
        cck = C_[:, c0:c0 + chunk].float()
        dtk = dt[:, c0:c0 + chunk]
        la = dtk * A[None, None, :]                      # log a_t (b,c,nh)
        cum = torch.cumsum(la, dim=1)                    # L_t
        # intra-chunk: S_ij = exp(L_i - L_j) dt_j (C_i . B_j) x_j, j <= i
        ci, cj = cum[:, :, None, :], cum[:, None, :, :]
        decay = torch.exp(torch.clamp(ci - cj, -60.0, 0.0)) \
            * tril[None, :, :, None]
        cb = torch.einsum("bis,bjs->bij", cck, bck)
        w = decay * cb[:, :, :, None] * dtk[:, None, :, :]  # (b,i,j,nh)
        y_intra = torch.einsum("bijh,bjhd->bihd", w, xck)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("bis,bhds,bih->bihd", cck, h, torch.exp(cum))
        # h' = exp(L_chunk) h + sum_j exp(L_c - L_j) dt_j x_j B_j
        tot = cum[:, -1:, :]
        decay_j = torch.exp(torch.clamp(tot - cum, min=-60.0))
        contrib = torch.einsum("bjh,bjhd,bjs->bhds", decay_j * dtk, xck, bck)
        h = torch.exp(tot[:, 0, :, None, None]) * h + contrib
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def ssd_scan_reference(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                       dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                       h: torch.Tensor, chunk: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M1's plain version, the reference's prefill scan: S padded to whole
    chunks with zeros, :func:`chunk_scan`, then ``y + D x`` cast to
    ``xh``'s dtype.  Returns (y (b, S, nh * dh), the final state)."""
    b, s, nh, dh = xh.shape
    pad = (-s) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, h = chunk_scan(xh, B_, C_, dt, A, h, chunk)
    y = y[:, :s] + D[None, None, :, None] * xh[:, :s].float()
    return y.reshape(b, s, nh * dh).to(xh.dtype), h


def ssd_scan(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             h: torch.Tensor, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (b, S, nh * dh) in ``xh``'s dtype, the final state) of the
    chunked scan from state ``h``, on :func:`ssd_route`'s route; see the
    module docstring for the contract."""
    if ssd_route(xh, B_, C_, dt, A, D, h) == "plain":
        return ssd_scan_reference(xh, B_, C_, dt, A, D, h, chunk)
    return _ssd_scan_cuda(xh, B_, C_, dt, A, D, h, chunk)


def _unit_last(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _ssd_scan_cuda(xh, B_, C_, dt, A, D, h, chunk):
    b, s, nh, dh = xh.shape
    ds = B_.shape[-1]
    if xh.dtype not in _DTYPES or B_.dtype != xh.dtype or \
            C_.dtype != xh.dtype:
        raise ValueError(f"ssd_scan: xh, B_ and C_ must share a dtype of "
                         f"{_DTYPES}, got {xh.dtype}, {B_.dtype}, "
                         f"{C_.dtype}")
    if B_.shape != (b, s, ds) or C_.shape != (b, s, ds) or \
            dt.shape != (b, s, nh) or A.shape != (nh,) or \
            D.shape != (nh,) or h.shape != (b, nh, dh, ds):
        raise ValueError(f"ssd_scan: shapes xh {tuple(xh.shape)}, B_ "
                         f"{tuple(B_.shape)}, C_ {tuple(C_.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)}, h {tuple(h.shape)} disagree")
    if dh > SSD_MAX_DIM or ds > SSD_MAX_DIM or \
            not 1 <= chunk <= SSD_MAX_CHUNK:
        raise ValueError(f"ssd_scan: the kernels take dh and ds up to "
                         f"{SSD_MAX_DIM} and a chunk up to {SSD_MAX_CHUNK}, "
                         f"got dh {dh}, ds {ds}, chunk {chunk}")
    dev = xh.device
    if any(t.device != dev for t in (B_, C_, dt, A, D, h)):
        raise ValueError("ssd_scan: every operand must be on one device")
    xh, B_, C_ = _unit_last(xh), _unit_last(B_), _unit_last(C_)
    dt = _unit_last(dt.float())
    A, D, h = (t.float().contiguous() for t in (A, D, h))
    y = torch.empty((b, s, nh * dh), dtype=xh.dtype, device=dev)
    h_out = torch.empty_like(h)
    if s == 0 or b == 0:
        return y, h_out.copy_(h)
    n_chunks = -(-s // chunk)
    states = torch.empty((b, n_chunks, nh, SSD_MAX_DIM, SSD_MAX_DIM),
                         dtype=torch.float32, device=dev)
    tot = torch.empty((b, n_chunks, nh), dtype=torch.float32, device=dev)
    params = array.array("q", (
        b, s, nh, dh, ds, chunk, *xh.stride()[:3], *B_.stride()[:2],
        *C_.stride()[:2], *dt.stride()[:2], xh.dtype == torch.bfloat16))
    lib = build.load("ssd_scan")
    args = (xh.data_ptr(), B_.data_ptr(), C_.data_ptr(), dt.data_ptr(),
            A.data_ptr(), D.data_ptr(), h.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), states.data_ptr(), tot.data_ptr(),
            params.buffer_info()[0])
    err = _launch(lib, "c4cam_ssd_scan", _ARGTYPES, args, dev.index)
    _raise_if_failed(lib, "ssd_scan", err)
    _count("ssd_scan")
    return y, h_out
