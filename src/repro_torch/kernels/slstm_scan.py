"""Hopper kernel for the sLSTM recurrence (X1).

:func:`slstm_scan` launches the CUDA kernel of ``csrc/slstm_scan.cu``
(built by :mod:`.build`): the whole recurrence of ``models/xlstm.py``'s
sLSTM over all S positions in one launch.  It replaces no TPU kernel: the
reference runs it as its ``step`` (``src/repro/models/xlstm.py:197``)
under ``lax.scan`` (``:213``), and its eager counterpart here,
:func:`slstm_scan_reference` (X1's plain version, the reference's
``step`` in a Python loop), launches about 15 kernels a position.

Contract: ``pre`` (B, S, 4D) float32, the input projection's
pre-activations (z, i, f, o blocks of D columns); ``wh`` (D, 4D) float32,
the recurrent weight; the state ``h``, ``c``, ``n``, ``m`` (each (B, D)
float32) -> (``hs`` (B, S, D) float32, every position's h, and the final
``(h, c, n, m)``).  Per position ``g = pre_t + h @ wh`` (a float32 FMA
product), ``logf = logsigmoid(f)``, ``m_t = max(logf + m, i)``,
``c = exp(logf + m - m_t) c + exp(i - m_t) tanh(z)``,
``n = exp(logf + m - m_t) n + exp(i - m_t)``,
``h = sigmoid(o) c / max(|n|, 1)``.  The kernel takes D up to
:data:`SLSTM_MAX_D`; a batch past :data:`SLSTM_MAX_BATCH` rows runs as
one launch per slice of that many rows.

The launch is cooperative: a grid of ``ceil(D / 8)`` blocks of eight
warps, a warp a hidden unit with its four columns of ``wh`` in registers,
all resident at once, walks the positions in order; each new h leaves as
one 64-bit (value, step tag) word that the other blocks poll for (a
flagged hand-off, no grid barrier).  It runs inside a CUDA graph capture
(the Server captures prefill): the words are zeroed by a fill the graph
records, so no tag of an earlier launch or replay matches.

:func:`slstm_route` names the route, as :func:`.ssd_scan.ssd_route` does:
the kernel for CUDA tensors that are not fake when autograd records
nothing; the plain version on the CPU, on fake tensors and for a step
that autograd records (training differentiates the eager loop; no
backward kernel exists).  On the kernel route a call the kernel does not
take raises.  Each launch adds one to :data:`.cam_search.LAUNCHES`
(``"slstm_scan"``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from .cam_search import _count, _raise_if_failed
from .flash_attention import _launch
from .ssd_scan import ssd_route

__all__ = ["slstm_scan", "slstm_scan_reference", "slstm_route",
           "barrier_step_ms", "handoff_step_ms", "SLSTM_MAX_D",
           "SLSTM_MAX_BATCH"]

#: the widest hidden state the kernel takes (a lane holds 4 x 32 values of
#: the recurrent weight in registers)
SLSTM_MAX_D = 1024
#: batch rows a launch takes (the pre-activations a lane prefetches)
SLSTM_MAX_BATCH = 64
#: pre, wh, h0, c0, n0, m0, hs, h, c, n, m, the hand-off words, the
#: snapshot, its position, batch, seq, D, the stream
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_void_p]
#: a probe's counter or words, steps, batch, D, the stream
_PROBE_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def slstm_route(*tensors: torch.Tensor) -> str:
    """``"kernel"`` for CUDA tensors, not fake, that autograd does not
    record; ``"plain"`` otherwise (the CPU, the dry run's fake tensors,
    a training step)."""
    return ssd_route(*tensors)


def slstm_scan_reference(pre: torch.Tensor, wh: torch.Tensor,
                         h: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                         m: torch.Tensor, snapshot_at: Optional[int] = None):
    """X1's plain version: the recurrence as a loop over positions.
    Returns (hs (B, S, D) float32, the final (h, c, n, m)), and with
    ``snapshot_at`` the (h, c, n, m) entering that position too."""
    _check_snapshot(snapshot_at, pre.shape[1])
    hs, snap = [], None
    for i in range(pre.shape[1]):
        g = pre[:, i] + h @ wh
        z, ig, fg, og = torch.chunk(g, 4, dim=-1)
        logf = F.logsigmoid(fg)
        m_t = torch.maximum(logf + m, ig)
        isc = torch.exp(ig - m_t)
        fsc = torch.exp(logf + m - m_t)
        c = fsc * c + isc * torch.tanh(z)
        n = fsc * n + isc
        h = torch.sigmoid(og) * c / torch.clamp(n.abs(), min=1.0)
        m = m_t
        hs.append(h)
        if i + 1 == snapshot_at:
            snap = (h, c, n, m)
    out = (torch.stack(hs, dim=1), (h, c, n, m))
    return out if snapshot_at is None else out + (snap,)


def _check_snapshot(at: Optional[int], s: int) -> None:
    if at is not None and not 1 <= at <= s:
        raise ValueError(f"slstm_scan: snapshot_at {at} outside 1..{s}")


def slstm_scan(pre: torch.Tensor, wh: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
               snapshot_at: Optional[int] = None):
    """(hs (B, S, D) float32, the final (h, c, n, m)) on
    :func:`slstm_route`'s route; see the module docstring.  With
    ``snapshot_at`` (1 .. S) also the state entering that position, as the
    recurrence carried it (the kernel writes it during its own launch)."""
    if slstm_route(pre, wh, h, c, n, m) == "plain":
        return slstm_scan_reference(pre, wh, h, c, n, m, snapshot_at)
    return _slstm_scan_cuda(pre, wh, h, c, n, m, snapshot_at)


def _slstm_scan_cuda(pre, wh, h, c, n, m, snapshot_at=None):
    b, s, d4 = pre.shape
    d = d4 // 4
    state = (h, c, n, m)
    if d4 != 4 * d or wh.shape != (d, d4) or \
            any(t.shape != (b, d) for t in state):
        raise ValueError(f"slstm_scan: shapes pre {tuple(pre.shape)}, wh "
                         f"{tuple(wh.shape)}, state "
                         f"{[tuple(t.shape) for t in state]} disagree")
    if any(t.dtype != torch.float32 for t in (pre, wh) + state):
        raise ValueError("slstm_scan: the kernel takes float32 operands")
    if d > SLSTM_MAX_D:
        raise ValueError(f"slstm_scan: the kernel takes D up to "
                         f"{SLSTM_MAX_D}, got {d}")
    dev = pre.device
    if any(t.device != dev for t in (wh,) + state):
        raise ValueError("slstm_scan: every operand must be on one device")
    _check_snapshot(snapshot_at, s)
    pre, wh = pre.contiguous(), wh.contiguous()
    state = tuple(t.contiguous() for t in state)
    hs = torch.empty((b, s, d), dtype=torch.float32, device=dev)
    out = tuple(torch.empty_like(t) for t in state)
    snap = None if snapshot_at is None else \
        torch.empty((4, b, d), dtype=torch.float32, device=dev)
    if s == 0 or b == 0:
        return hs, tuple(o.copy_(t) for o, t in zip(out, state))
    lib = build.load("slstm_scan")
    for b0 in range(0, b, SLSTM_MAX_BATCH):
        rows = slice(b0, min(b, b0 + SLSTM_MAX_BATCH))
        nb = rows.stop - b0
        words = torch.zeros((2, nb, d), dtype=torch.int64, device=dev)
        part = None if snap is None else \
            torch.empty((4, nb, d), dtype=torch.float32, device=dev)
        args = (pre[rows].data_ptr(), wh.data_ptr(),
                *(t[rows].data_ptr() for t in state), hs[rows].data_ptr(),
                *(t[rows].data_ptr() for t in out), words.data_ptr(),
                None if part is None else part.data_ptr(),
                snapshot_at or 0, nb, s, d)
        err = _launch(lib, "c4cam_slstm_scan", _ARGTYPES, args, dev.index)
        _raise_if_failed(lib, "slstm_scan", err)
        _count("slstm_scan")
        if part is not None:
            snap[:, rows].copy_(part)
    return (hs, out) if snap is None else (hs, out, tuple(snap))


def _probe_step_ms(fn, scratch, what, batch, d, steps, device) -> float:
    dev = torch.device(device)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    lib = build.load("slstm_scan")
    times = []
    for _ in range(2):
        buf = torch.zeros(scratch, dtype=torch.int64, device=dev)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        err = _launch(lib, fn, _PROBE_ARGTYPES,
                      (buf.data_ptr(), steps, batch, d), index)
        e1.record()
        _raise_if_failed(lib, what, err)
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return times[-1] / steps


def barrier_step_ms(batch: int, d: int, steps: int, device) -> float:
    """The device ms of one grid-wide barrier (the earlier design's: a release
    increment and acquire polling of one counter) over X1's grid at
    (``batch``, ``d``): a probe kernel that runs only the barrier,
    ``steps`` times, timed with CUDA events (after one warm-up launch).
    S of these were the serial bound of the barrier design; it is not a
    launch of X1 and counts none."""
    return _probe_step_ms("c4cam_slstm_barrier", (1,), "slstm_scan barrier",
                          batch, d, steps, device)


def handoff_step_ms(batch: int, d: int, steps: int, device) -> float:
    """The device ms of one flagged hand-off of X1's design at (``batch``,
    ``d``): a probe kernel over the scan's grid in which each unit
    publishes its h words and every block polls all of them, ``steps``
    times, timed as :func:`barrier_step_ms`.  S of these are the scan's
    serial bound; it is not a launch of X1 and counts none."""
    return _probe_step_ms("c4cam_slstm_handoff", (2, batch, d),
                          "slstm_scan hand-off", batch, d, steps, device)
