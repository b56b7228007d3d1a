"""Hopper kernel for HDC hypervector encoding (record-based, bipolar).

Each feature position ``f`` owns a *key* hypervector ``keys[f]`` and each
quantised level ``l`` a *level* hypervector ``levels[l]``; a sample is
the majority bundle over its features of their bind::

    enc[m, h] = sign( sum_f keys[f, h] * levels[q[m, f], h] )   tie -> +1

Cells in {-1, 0, +1} are bits: :func:`hdc_planes` packs keys and levels
once into 32-dim words of two bit planes, *sign* (bit set for -1) and
*care* (bit set for a nonzero cell), with one all-zero level row after
the last.  :func:`hdc_encode_planes` launches the CUDA kernel
(``csrc/hdc_encode.cu``, built by :mod:`.build`) on those planes: bind is
``(sign_k ^ sign_l) & care``, bundle a bit-sliced count through
carry-save adders, and the sign ``2 * neg_count <= care_count``.  It
replaces the reference's ``hdc_encode_pallas``, whose one-hot matmuls
exist only because the TPU's matrix unit cannot gather.
:func:`hdc_encode` takes the cells themselves and packs them on every
call.

Beside the kernel, :func:`hdc_encode_reference` is its plain PyTorch
version: the one-hot matmul decomposition ``sum_l (q == l) @ keys *
levels[l]``, chunked over queries so no (M, F, H) tensor is built; and
:func:`hdc_encode_bitsliced` runs the kernel's own arithmetic (the same
planes, the same carry-save tree, the same compare) in torch.

The kernel takes any row count, feature count and level count: rows
beyond one grid dimension run on the next, F >= 2**16 counts in 32 bit
planes, and level planes that do not fit in a block's shared memory are
read from global memory (:func:`hdc_route` names the route; every route
counts the same integers).

Contract: ``level_idx`` (M, F) int32; ``keys`` (F, H) and ``levels``
(L, H) with every value in {-1, 0, +1} (float32 or int8), where the sums
are small integers and every version is exact, hence bit-identical.  An
id outside ``[0, L)`` contributes nothing, as in the reference kernel's
one-hot.  A wrapper runs the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  Each launch adds one to
:data:`.cam_search.LAUNCHES`: ``"hdc_encode"`` on the shared-memory route
of up to 16 count planes, ``"hdc_encode_wide"`` on the others.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import build
from .cam_search import _args, _bind, _count, _raise_if_failed
from .packing import LANE_BITS, lanes, pack_bits

__all__ = ["HdcPlanes", "hdc_planes", "hdc_encode", "hdc_encode_planes",
           "hdc_encode_reference", "hdc_encode_bitsliced",
           "hdc_sums_reference", "count_planes", "hdc_route",
           "HDC_SMEM_LIMIT"]

#: the most shared memory a block can use on an H100 (227 KB)
HDC_SMEM_LIMIT = 232448
#: query rows per block of the kernel
_BLOCK_ROWS = 32
#: shared memory of one block besides the level planes: two stages of key
#: planes (64 features x 32 words x (sign, care)), the ids of a stage as
#: copied and as level-row offsets (32 queries x 64 features, int32), and a
#: count per query
_HDC_STAGE_BYTES = 2 * 64 * 32 * 8 + 2 * _BLOCK_ROWS * 64 * 4 + _BLOCK_ROWS * 4
#: features per carry-save tree of the kernel
_GROUP = 16
#: elements of one (queries, dims) accumulator chunk of the plain version
_REFERENCE_CHUNK_ELEMS = 1 << 26


@dataclass(frozen=True)
class HdcPlanes:
    """Keys and levels as the encode kernel reads them.

    ``keys`` (F, H) and ``levels`` (L, H) are the cells as given (the
    plain version's operands); ``key_planes`` (F, W, 2) and
    ``level_planes`` (L + 1, W, 2) are int32 (sign, care) words, ``W =
    ceil(H / 32)``, bit ``i`` of word ``w`` the cell of dim ``32 w + i``
    (bits past H clear), level row L all zero; ``has_zero`` says whether
    any cell is 0, which picks the kernel's route."""

    keys: torch.Tensor
    levels: torch.Tensor
    key_planes: torch.Tensor
    level_planes: torch.Tensor
    has_zero: bool

    @property
    def dim(self) -> int:
        return self.keys.shape[1]

    @property
    def n_levels(self) -> int:
        return self.levels.shape[0]


def count_planes(n_features: int) -> int:
    """Bit planes of the kernel's counts for ``n_features`` features (a
    count reaches ``n_features``): 8, 10, 12, 16, or 32 from 2**16
    features on (any int32 feature count)."""
    for planes in (8, 10, 12, 16, 32):
        if n_features < 1 << planes:
            return planes
    raise ValueError(f"hdc_encode: {n_features} features exceed int32")


def hdc_route(n_features: int, n_levels: int) -> str:
    """The kernel's route for ``n_features`` features and ``n_levels``
    levels: ``"bitsliced"`` (counts in up to 16 bit planes, the level
    planes in shared memory), or ``"wide"`` (32 count planes,
    ``n_features >= 2**16``), ``"global"`` (the level planes read from
    global memory: they do not fit in shared memory) or ``"wide+global"``.
    """
    wide = count_planes(n_features) > 16
    glob = _smem_bytes(n_levels) > HDC_SMEM_LIMIT
    if wide and glob:
        return "wide+global"
    return "wide" if wide else "global" if glob else "bitsliced"


def _sign_care(cells: torch.Tensor) -> torch.Tensor:
    """(rows, H) cells -> (rows, W, 2) int32 (sign, care) words."""
    return torch.stack([pack_bits(cells < 0), pack_bits(cells != 0)],
                       dim=-1).contiguous()


def hdc_planes(keys: torch.Tensor, levels: torch.Tensor) -> HdcPlanes:
    """Pack ``keys`` (F, H) and ``levels`` (L, H), cells in {-1, 0, +1},
    into the kernel's bit planes on their device.  Reads back one flag
    (whether any cell is 0), so it waits for the device once."""
    _check_cells(keys, levels)
    kp = _sign_care(keys)
    lp = _sign_care(levels)
    lp = torch.cat([lp, torch.zeros_like(lp[:1])])
    has_zero = bool((keys == 0).any() | (levels == 0).any())
    return HdcPlanes(keys, levels, kp, lp, has_zero)


def hdc_sums_reference(level_idx: torch.Tensor, keys: torch.Tensor,
                       levels: torch.Tensor) -> torch.Tensor:
    """The (M, H) float32 bundle sums before the sign, by the one-hot
    matmul decomposition (exact integers), chunked over queries so the
    accumulator stays near 256 MB at any width."""
    _check(level_idx, keys, levels)
    m = level_idx.shape[0]
    h = keys.shape[1]
    k = keys.to(torch.float32)
    lv = levels.to(torch.float32)
    out = torch.empty((m, h), dtype=torch.float32, device=keys.device)
    step = max(1, _REFERENCE_CHUNK_ELEMS // max(1, h))
    for s in range(0, m, step):
        q = level_idx[s:s + step]
        acc = out[s:s + step].zero_()
        for level in range(lv.shape[0]):
            onehot = (q == level).to(torch.float32)
            acc += (onehot @ k) * lv[level][None, :]
    return out


def hdc_encode_reference(level_idx: torch.Tensor, keys: torch.Tensor,
                         levels: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`hdc_encode`: the sign of
    :func:`hdc_sums_reference`, tie -> +1."""
    s = hdc_sums_reference(level_idx, keys, levels)
    return torch.where(s >= 0, 1.0, -1.0)


def _add16(planes: list, x: list) -> None:
    """The kernel's ``add16``: 16 words into the bit-sliced counts, a
    carry-save tree of full adders into planes 0..3 and half adders
    above."""
    def fa(b, u, v):
        p = planes[b]
        carry = (p & u) | (p & v) | (u & v)
        planes[b] = p ^ u ^ v
        return carry

    c1 = [fa(0, x[2 * i], x[2 * i + 1]) for i in range(8)]
    c2 = [fa(1, c1[2 * i], c1[2 * i + 1]) for i in range(4)]
    c3 = [fa(2, c2[2 * i], c2[2 * i + 1]) for i in range(2)]
    carry = fa(3, c3[0], c3[1])
    for b in range(4, len(planes)):
        planes[b], carry = planes[b] ^ carry, planes[b] & carry


def hdc_encode_bitsliced(level_idx: torch.Tensor,
                         planes: HdcPlanes) -> torch.Tensor:
    """The kernel's arithmetic in torch, on any device: ids outside
    ``[0, L)`` read the zero level row; per 16 features the words ``neg =
    (sign_k ^ sign_l) & care`` (and, with zero cells, ``care = care_k &
    care_l``) go through the carry-save tree of :func:`_add16`; the sign
    is ``2 * neg <= care`` bit by bit (no zero cell: ``neg <= (in-range
    ids) // 2``).  Equal to :func:`hdc_encode_reference` bit for bit."""
    _check_planes(level_idx, planes)
    m, f = level_idx.shape
    n_levels = planes.n_levels
    kp, lp = planes.key_planes, planes.level_planes
    width = kp.shape[1]
    inside = (level_idx >= 0) & (level_idx < n_levels)
    ids = torch.where(inside, level_idx, n_levels).long()
    n_planes = count_planes(f)
    zero = torch.zeros((m, width), dtype=torch.int32, device=kp.device)
    neg = [zero] * n_planes
    care = [zero] * n_planes
    for g0 in range(0, f, _GROUP):
        xs, ys = [], []
        for j in range(g0, g0 + _GROUP):
            if j >= f:                       # a padded feature adds 0
                xs.append(zero)
                ys.append(zero)
                continue
            lv = lp[ids[:, j]]                             # (M, W, 2)
            c = kp[j, :, 1][None] & lv[..., 1] if planes.has_zero \
                else lv[..., 1]
            xs.append((kp[j, :, 0][None] ^ lv[..., 0]) & c)
            ys.append(c)
        _add16(neg, xs)
        if planes.has_zero:
            _add16(care, ys)
    lt = torch.zeros_like(zero)
    eq = ~lt
    if planes.has_zero:                  # 2 neg <= care, top bit first
        for b in range(n_planes, -1, -1):
            a = neg[b - 1] if b > 0 else zero
            c = care[b] if b < n_planes else zero
            lt = lt | (eq & ~a & c)
            eq = eq & ~(a ^ c)
    else:                                # neg <= in-range ids // 2
        t = (inside.sum(1, dtype=torch.int32) >> 1)[:, None]
        for b in range(n_planes - 1, -1, -1):
            tb = -((t >> b) & 1)                           # 0 or all ones
            lt = lt | (eq & ~neg[b] & tb)
            eq = eq & ~(neg[b] ^ tb)
    pos = lt | eq
    shifts = torch.arange(LANE_BITS, dtype=torch.int32, device=kp.device)
    bits = ((pos[..., None] >> shifts) & 1).reshape(m, width * LANE_BITS)
    return torch.where(bits[:, :planes.dim] != 0, 1.0, -1.0)


def _check_cells(keys: torch.Tensor, levels: torch.Tensor) -> None:
    for what, t in (("keys", keys), ("levels", levels)):
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError(f"hdc_encode: {what} must be a 2-D tensor")
        if t.dtype not in (torch.float32, torch.int8):
            raise ValueError(f"hdc_encode: {what} must be float32 or int8, "
                             f"got {t.dtype}")
    if levels.device != keys.device:
        raise ValueError(f"hdc_encode: levels is on {levels.device}, keys "
                         f"on {keys.device}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hdc_encode: unsupported device {keys.device}")
    if levels.shape[1] != keys.shape[1]:
        raise ValueError(f"hdc_encode: keys {tuple(keys.shape)} and levels "
                         f"{tuple(levels.shape)} differ in width")
    if levels.shape[0] == 0 or keys.shape[1] == 0:
        raise ValueError("hdc_encode: need at least one level and one dim")


def _check_ids(level_idx: torch.Tensor, keys: torch.Tensor) -> None:
    if not isinstance(level_idx, torch.Tensor) or level_idx.dim() != 2:
        raise ValueError("hdc_encode: level_idx must be a 2-D tensor")
    if level_idx.dtype != torch.int32:
        raise ValueError(f"hdc_encode: level_idx must be torch.int32, got "
                         f"{level_idx.dtype}")
    if keys.device != level_idx.device:
        raise ValueError(f"hdc_encode: keys is on {keys.device}, level_idx "
                         f"on {level_idx.device}")
    if keys.shape[0] != level_idx.shape[1]:
        raise ValueError(f"hdc_encode: {level_idx.shape[1]} features but "
                         f"{keys.shape[0]} key rows")


def _check(level_idx: torch.Tensor, keys: torch.Tensor,
           levels: torch.Tensor) -> None:
    _check_cells(keys, levels)
    _check_ids(level_idx, keys)


def _check_planes(level_idx: torch.Tensor, planes: HdcPlanes) -> None:
    _check_ids(level_idx, planes.keys)
    f, h = planes.keys.shape
    w = lanes(h)
    if planes.key_planes.shape != (f, w, 2) or \
            planes.level_planes.shape != (planes.n_levels + 1, w, 2):
        raise ValueError(f"hdc_encode: planes {tuple(planes.key_planes.shape)}"
                         f" / {tuple(planes.level_planes.shape)} do not "
                         f"match keys {tuple(planes.keys.shape)} and "
                         f"{planes.n_levels} levels (see hdc_planes)")


def _smem_bytes(n_levels: int) -> int:
    """Shared memory of one block: the staged ids and key planes, and the
    level planes of its 32 words plus the zero row, as (sign, care) pairs
    and as sign words alone."""
    return _HDC_STAGE_BYTES + (n_levels + 1) * 32 * 12


def hdc_encode_planes(level_idx: torch.Tensor,
                      planes: HdcPlanes) -> torch.Tensor:
    """(M, H) float32 bipolar encodings of ``level_idx`` (M, F) int32 with
    the keys and levels packed by :func:`hdc_planes`.

    CPU tensors run :func:`hdc_encode_reference` on the planes' cells;
    CUDA tensors launch the kernel, on its no-zero-cell route unless
    ``planes.has_zero``, on the route :func:`hdc_route` names.
    """
    _check_planes(level_idx, planes)
    if level_idx.device.type == "cpu":
        return hdc_encode_reference(level_idx, planes.keys, planes.levels)
    n_levels = planes.n_levels
    m, f = level_idx.shape
    h = planes.dim
    route = hdc_route(f, n_levels)
    q = level_idx.contiguous()
    out = torch.empty((m, h), dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    lib = build.load("hdc_encode")
    launch = _bind(lib, "c4cam_hdc_encode", _args(4, 7))
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), planes.key_planes.data_ptr(),
                     planes.level_planes.data_ptr(), out.data_ptr(), m, f, h,
                     lanes(h), n_levels, int(planes.has_zero),
                     int(route.endswith("global")),
                     torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_failed(lib, "hdc_encode", err)
    _count("hdc_encode" if route == "bitsliced" else "hdc_encode_wide")
    return out


def hdc_encode(level_idx: torch.Tensor, keys: torch.Tensor,
               levels: torch.Tensor) -> torch.Tensor:
    """(M, H) float32 bipolar encodings of ``level_idx`` (M, F) int32
    with ``keys`` (F, H) and ``levels`` (L, H), values in {-1, 0, +1}.

    CPU tensors run :func:`hdc_encode_reference`; CUDA tensors pack the
    planes (:func:`hdc_planes`, which waits for the device once) and
    launch the kernel.  The wrapper does not read the cells back to check
    the alphabet.
    """
    _check(level_idx, keys, levels)
    if level_idx.device.type == "cpu":
        return hdc_encode_reference(level_idx, keys, levels)
    return hdc_encode_planes(level_idx, hdc_planes(keys, levels))
