"""Public wrappers around the CAM-search kernels.

Semantics match :mod:`repro_torch.kernels.ref` bit-for-bit (integer
metrics) / to float tolerance (analog).  :func:`cam_topk` and
:func:`cam_topk_packed` pad their inputs to the kernels' blocks on every
call; the search-plan engine instead pads the gallery once behind its
plan cache (:func:`pad_to_blocks`) and streams query chunks through the
``*_prepadded`` entry points.

Each ``*_prepadded`` call is one kernel launch followed by the final
candidate merge: a stable sort of the (M, n_windows * k) candidates on
their key.  Windows are in ascending row order and candidates within a
window in (key desc, index asc) order, so the stable sort resolves ties
to the lower global row index, matching the reference.

Where ``k`` exceeds the kernels' :data:`~.cam_search.MAX_K` no window
fits: :func:`~.cam_search.topk_by_distance` (the distance kernel, then
the selection kernel by (value, lowest row id)) takes its place, and for
packed lanes :func:`~.cam_search.topk_by_packed_distance` (the packed
distance kernel on the lanes, then the same selection).

The range entry points (:func:`acam_match`, :func:`cam_range_match`)
are one launch each: the kernel writes the boolean match matrix itself.
So are :func:`cam_distances` (the full float32 distance matrix; its
:func:`cam_exact` and :func:`cam_range` compare it as the reference
does) and :func:`hdc_encode` (HDC hypervector encoding).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import acam as kacam
from . import hdc_encode as khdc
from . import ref as kref
from .cam_search import (BLOCK_K, MAX_K, PACKED_ROWS, distance, fused_topk,
                         fused_topk_packed, topk_by_distance,
                         topk_by_packed_distance, window_rows)

__all__ = ["pad_to_blocks", "cam_topk_prepadded",
           "cam_topk_packed_prepadded", "cam_topk", "cam_topk_packed",
           "acam_match_prepadded", "acam_match",
           "cam_range_match_prepadded", "cam_range_match", "hdc_bind",
           "hdc_bundle", "hdc_permute", "hdc_encode", "cam_distances",
           "cam_exact", "cam_range"]


def pad_to_blocks(x: torch.Tensor, mult0: int, mult1: int) -> torch.Tensor:
    """Zero-pad a 2-D operand up to block multiples (rows, cols)."""
    p0 = (-x.shape[0]) % mult0
    p1 = (-x.shape[1]) % mult1
    if p0 or p1:
        x = torch.nn.functional.pad(x, (0, p1, 0, p0))
    return x.contiguous()


def _merge(vals: torch.Tensor, idx: torch.Tensor, k: int,
           largest: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    sel = kref.stable_topk(vals if largest else -vals, k)
    return torch.gather(vals, -1, sel), torch.gather(idx, -1, sel)


def cam_topk_prepadded(qp: torch.Tensor, pp: torch.Tensor, *, metric: str,
                       k: int, largest: bool, n_valid: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel launch + candidate merge for block-aligned float operands.

    ``k`` must already be clamped to ``n_valid``.  Returns (M, k).
    """
    vals, idx = fused_topk(qp, pp, metric=metric, k=k, largest=largest,
                           n_valid=n_valid)
    return _merge(vals, idx, k, largest)


def cam_topk_packed_prepadded(qp: torch.Tensor, pp: torch.Tensor,
                              cp: Optional[torch.Tensor] = None, *, k: int,
                              largest: bool, n_valid: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-lane analogue of :func:`cam_topk_prepadded` (``cp``: the
    optional packed per-pattern TCAM care mask)."""
    vals, idx = fused_topk_packed(qp, pp, cp, k=k, largest=largest,
                                  n_valid=n_valid)
    return _merge(vals, idx, k, largest)


def cam_topk(queries: torch.Tensor, patterns: torch.Tensor, *, metric: str,
             k: int, largest: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused CAM best-match search through :func:`fused_topk` (through
    :func:`~.cam_search.topk_by_distance` when ``min(k, N) > MAX_K``); ``k >
    N`` pads with the losing sentinels (``∓inf``, index ``2**30``)."""
    n = patterns.shape[0]
    k_eff = min(k, n)
    qp = pad_to_blocks(queries.to(torch.float32), 1, BLOCK_K)
    if k_eff > MAX_K:
        vals, idx = topk_by_distance(
            qp, pad_to_blocks(patterns.to(torch.float32), 1, BLOCK_K),
            metric=metric, k=k_eff, largest=largest, n_valid=n)
        return kref.pad_candidates(vals, idx, k, largest)
    pp = pad_to_blocks(patterns.to(torch.float32), window_rows(k_eff),
                       BLOCK_K)
    vals, idx = cam_topk_prepadded(qp, pp, metric=metric, k=k_eff,
                                   largest=largest, n_valid=n)
    return kref.pad_candidates(vals, idx, k, largest)


def cam_topk_packed(qbits: torch.Tensor, pbits: torch.Tensor,
                    care: Optional[torch.Tensor] = None, *, k: int,
                    largest: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused best-match search over bit-packed binary/ternary lanes
    (``packing.pack_bits``); bit-identical to ``cam_topk(metric=
    "hamming")`` on the unpacked cells.  Past :data:`MAX_K` the lanes go
    to :func:`~.cam_search.topk_by_packed_distance`."""
    n = pbits.shape[0]
    k_eff = min(k, n)
    matrix = k_eff > MAX_K
    rows = PACKED_ROWS if matrix else window_rows(k_eff)
    qp = pad_to_blocks(qbits, 1, BLOCK_K)
    pp = pad_to_blocks(pbits, rows, BLOCK_K)
    cp = None if care is None else pad_to_blocks(care, rows, BLOCK_K)
    search = topk_by_packed_distance if matrix else cam_topk_packed_prepadded
    vals, idx = search(qp, pp, cp, k=k_eff, largest=largest, n_valid=n)
    return kref.pad_candidates(vals, idx, k, largest)


# ---------------------------------------------------------------------------
# aCAM range search (interval + fused threshold match)
# ---------------------------------------------------------------------------


def acam_match_prepadded(qp: torch.Tensor, lop: torch.Tensor,
                         hip: torch.Tensor, *, n_valid: int) -> torch.Tensor:
    """Interval-match launch for operands whose inner dimension is padded
    to :data:`~.acam.ACAM_BLOCK_D` (zero padding: ``q = lo = hi = 0``
    never violates).  Returns the (M, N) ``torch.bool`` matrix."""
    return kacam.acam_match(qp, lop, hip, n_valid=n_valid)


def acam_match(queries: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """(M, N) boolean aCAM interval match through the interval kernel;
    semantics pinned by :func:`ref.acam_match` (bit for bit)."""
    d = kacam.ACAM_BLOCK_D
    return acam_match_prepadded(
        pad_to_blocks(queries.to(torch.float32), 1, d),
        pad_to_blocks(lo.to(torch.float32), 1, d),
        pad_to_blocks(hi.to(torch.float32), 1, d), n_valid=lo.shape[0])


def cam_range_match_prepadded(qp: torch.Tensor, pp: torch.Tensor, *,
                              metric: str, threshold: float, below: bool,
                              to_logical: str, dim: int,
                              n_valid: int) -> torch.Tensor:
    """Fused threshold-match launch for operands whose inner dimension is
    padded to :data:`~.cam_search.BLOCK_K`; (M, N) ``torch.bool``."""
    return kacam.range_match(qp, pp, metric=metric, threshold=threshold,
                             below=below, to_logical=to_logical, dim=dim,
                             n_valid=n_valid)


def cam_range_match(queries: torch.Tensor, patterns: torch.Tensor, *,
                    metric: str, threshold: float,
                    below: bool = True) -> torch.Tensor:
    """(M, N) boolean threshold match with the threshold fused in the
    kernel (only the match matrix leaves it); the physical-metric
    contract of :func:`ref.cam_range` on hamming / dot / eucl."""
    return cam_range_match_prepadded(
        pad_to_blocks(queries.to(torch.float32), 1, BLOCK_K),
        pad_to_blocks(patterns.to(torch.float32), 1, BLOCK_K),
        metric=metric, threshold=threshold, below=below,
        to_logical="identity", dim=queries.shape[-1],
        n_valid=patterns.shape[0])


# ---------------------------------------------------------------------------
# HDC hypervector encoding
# ---------------------------------------------------------------------------

#: bind / bundle / permute are plain tensor code in every path (the encode
#: kernel inlines bind + bundle); one import surface for the HDC algebra
hdc_bind = kref.hdc_bind
hdc_bundle = kref.hdc_bundle
hdc_permute = kref.hdc_permute


def hdc_encode(level_idx: torch.Tensor, keys: torch.Tensor,
               levels: torch.Tensor) -> torch.Tensor:
    """(M, H) bipolar encodings through the encode kernel; bit-identical
    to :func:`ref.hdc_encode` for ids in ``[0, L)`` (integer sums, sign
    tie -> +1).  The kernel masks ragged queries, features and dims
    itself, so nothing is padded here."""
    return khdc.hdc_encode(level_idx.to(torch.int32), keys, levels)


# ---------------------------------------------------------------------------
# distance matrix, exact and threshold match
# ---------------------------------------------------------------------------


def cam_distances(queries: torch.Tensor, patterns: torch.Tensor, *,
                  metric: str) -> torch.Tensor:
    """(M, N) float32 distance matrix through the distance kernel: the
    decomposition of ``metric`` (hamming on {0, 1} cells, squared eucl,
    dot), inner dimension zero-padded to :data:`~.cam_search.BLOCK_K`."""
    return distance(pad_to_blocks(queries.to(torch.float32), 1, BLOCK_K),
                    pad_to_blocks(patterns.to(torch.float32), 1, BLOCK_K),
                    metric=metric)


def cam_exact(queries: torch.Tensor, patterns: torch.Tensor, *,
              metric: str = "hamming") -> torch.Tensor:
    """(M, N) boolean exact match: ``cam_distances(...) == 0``."""
    return cam_distances(queries, patterns, metric=metric) == 0


def cam_range(queries: torch.Tensor, patterns: torch.Tensor,
              threshold: float, *, metric: str = "hamming") -> torch.Tensor:
    """(M, N) boolean threshold match: ``cam_distances(...) <= threshold``
    (inclusive, compared in float32)."""
    return cam_distances(queries, patterns, metric=metric) <= threshold
