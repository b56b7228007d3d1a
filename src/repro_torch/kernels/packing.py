"""Bit-packing for the binary/ternary CAM fast path.

CAM arrays match *cells*, not floats: BCAM rows are bit vectors, TCAM
rows are bit vectors with per-cell "don't care" wildcards.  This module
packs logical cells into 32-cell **lanes** (LSB-first: cell ``j`` of a
lane group lands in bit ``j`` of lane ``j // 32``) so a Hamming search
becomes ``popcount(q ^ p)`` and a TCAM wildcard search becomes
``popcount((q ^ p) & care)`` — pure integer ops, bit-identical to the
unpacked mismatch count.

Lanes are stored as **int32**: torch's uint32 support is partial, and
the bit pattern is what matters.  A lane with bit 31 set is a negative
int32, and ``>>`` on int32 is an arithmetic shift that copies bit 31
into the vacated high bits — so every right shift below is followed by
a mask before its result is used.  The reference's uint32 lanes compare
equal through ``numpy.ndarray.view(np.int32)``.

Tail handling: a dimension that is not a multiple of 32 leaves the top
bits of the last lane zero in *both* operands (and zero in the care
mask), so padded bits never contribute to a match count.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["LANE_BITS", "lanes", "pack_bits", "pack_bipolar", "unpack_bits",
           "popcount32", "popcount32_lut"]

#: cells per packed lane
LANE_BITS = 32

#: byte -> popcount table for the LUT variant
_POP8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                      axis=1).sum(1).astype(np.int32)


def lanes(dim: int) -> int:
    """32-bit lanes needed for ``dim`` cells: ``ceil(dim / 32)``."""
    return -(-int(dim) // LANE_BITS)


def _as_tensor(x) -> torch.Tensor:
    """Tensor view of ``x``; numpy uint32 lanes are reinterpreted as int32."""
    if isinstance(x, np.ndarray) and x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.as_tensor(x)


def pack_bits(bits) -> torch.Tensor:
    """Pack cells along the last axis into int32 lanes (LSB-first).

    Any dtype is accepted; a cell is set iff the element is non-zero
    (bipolar data wants :func:`pack_bipolar`, which thresholds at
    ``> 0`` instead).  ``(..., dim)`` -> ``(..., lanes(dim))``; tail
    bits of the last lane are zero.
    """
    b = _as_tensor(bits)
    if b.dtype != torch.bool:
        b = b != 0
    dim = b.shape[-1]
    nl = lanes(dim)
    pad = nl * LANE_BITS - dim
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    u = b.reshape(b.shape[:-1] + (nl, LANE_BITS)).to(torch.int64)
    shifts = torch.arange(LANE_BITS, dtype=torch.int64, device=b.device)
    v = (u << shifts).sum(-1)                     # exact lane value < 2**32
    # two's-complement wrap into int32 without relying on narrowing casts
    v = torch.where(v >= 2 ** 31, v - 2 ** 32, v)
    return v.to(torch.int32)


def pack_bipolar(x) -> torch.Tensor:
    """Sign-pack bipolar data: cell set iff the element is positive.

    Matches the engine's float encoding for ``dot``/``cos`` — both
    binarise via ``x > 0`` — so the packed and unpacked paths see the
    same cells for *any* real-valued input.
    """
    return pack_bits(_as_tensor(x) > 0)


def unpack_bits(packed, dim: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``(..., lanes)`` -> ``(..., dim)``
    as uint8 in {0, 1} (tail lanes sliced off)."""
    u = _as_tensor(packed).to(torch.int32)
    shifts = torch.arange(LANE_BITS, dtype=torch.int32, device=u.device)
    bits = (u[..., :, None] >> shifts) & 1      # mask drops sign extension
    bits = bits.reshape(u.shape[:-1] + (u.shape[-1] * LANE_BITS,))
    return bits[..., :dim].to(torch.uint8)


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of values in [0, 2**16): every intermediate stays
    non-negative and below 2**16, so int32 arithmetic never overflows."""
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount32(x) -> torch.Tensor:
    """Per-element population count of 32-bit lanes (SWAR, branch-free).

    The 32-bit word is split into two 16-bit halves, each masked right
    after its shift (int32 ``>>`` sign-extends a lane with bit 31 set),
    and counted by the shift-add reduction.  Returns int32.
    """
    x = _as_tensor(x).to(torch.int32)
    return _popcount16(x & 0xFFFF) + _popcount16((x >> 16) & 0xFFFF)


def popcount32_lut(x) -> torch.Tensor:
    """Lookup-table popcount (four byte-table gathers per lane).

    Kept alongside the SWAR variant; both must agree bit-for-bit
    (pinned by tests).  Returns int32.
    """
    x = _as_tensor(x).to(torch.int32)
    t = torch.as_tensor(_POP8, device=x.device)
    return (t[(x & 0xFF).long()] + t[((x >> 8) & 0xFF).long()]
            + t[((x >> 16) & 0xFF).long()] + t[((x >> 24) & 0xFF).long()])
