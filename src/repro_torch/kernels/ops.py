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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref as kref
from .cam_search import BLOCK_K, fused_topk, fused_topk_packed, window_rows

__all__ = ["pad_to_blocks", "cam_topk_prepadded",
           "cam_topk_packed_prepadded", "cam_topk", "cam_topk_packed"]


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
    """Fused CAM best-match search through :func:`fused_topk`; ``k > N``
    pads with the losing sentinels (``∓inf``, index ``2**30``)."""
    n = patterns.shape[0]
    k_eff = min(k, n)
    qp = pad_to_blocks(queries.to(torch.float32), 1, BLOCK_K)
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
    "hamming")`` on the unpacked cells."""
    n = pbits.shape[0]
    k_eff = min(k, n)
    window = window_rows(k_eff)
    qp = pad_to_blocks(qbits, 1, BLOCK_K)
    pp = pad_to_blocks(pbits, window, BLOCK_K)
    cp = None if care is None else pad_to_blocks(care, window, BLOCK_K)
    vals, idx = cam_topk_packed_prepadded(qp, pp, cp, k=k_eff,
                                          largest=largest, n_valid=n)
    return kref.pad_candidates(vals, idx, k, largest)
