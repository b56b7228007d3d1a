"""Plain PyTorch oracles for the CAM search kernels.

These define the *semantics* that the CUDA kernels
(:mod:`repro_torch.kernels.cam_search`) and the engine's executables must
match bit-for-bit (integer metrics) or to float tolerance (analog
metrics) — the same contract as the reference package's
``repro.kernels.ref``.

Conventions
-----------
queries  : (M, D)  — one query per row
patterns : (N, D)  — the stored CAM content ("database")
returns  : (values, indices), each (M, K); values float32, indices int32

Ties
----
``jax.lax.top_k`` is stable (equal keys keep ascending-index order);
``torch.topk`` promises no tie order.  Every selection here is a stable
descending ``torch.sort`` on the key, so ties resolve to the lower
index exactly like the reference.  Keys get ``+ 0.0`` first, which turns
``-0.0`` into ``+0.0``: a radix sort on the device tells the two zeros
apart, IEEE comparison (and the CUDA kernels) does not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .packing import popcount32

__all__ = ["distances", "packed_distances", "ternary_distances",
           "tile_distance", "tiled_distances", "cam_topk",
           "cam_topk_ternary", "cam_topk_tiled", "merge_topk",
           "pad_candidates", "stable_topk"]

#: index of a losing (padding) candidate slot
PAD_INDEX = 2 ** 30


def distances(queries: torch.Tensor, patterns: torch.Tensor,
              metric: str) -> torch.Tensor:
    """(M, N) distance/similarity matrix."""
    q = queries.to(torch.float32)
    p = patterns.to(torch.float32)
    if metric == "hamming":
        # mismatch count; inputs {0,1}
        return (q[:, None, :] != p[None, :, :]).sum(-1).to(torch.float32)
    if metric == "dot":
        return q @ p.T
    if metric == "eucl":
        # squared L2 via expansion (matches tiled partial-sum accumulation)
        qq = (q * q).sum(-1, keepdim=True)
        pp = (p * p).sum(-1)
        return qq + pp[None, :] - 2.0 * (q @ p.T)
    if metric == "cos":
        qn = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                             min=1e-12)
        pn = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True),
                             min=1e-12)
        return qn @ pn.T
    raise ValueError(f"unknown metric {metric!r}")


def packed_distances(qbits: torch.Tensor, pbits: torch.Tensor,
                     care: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, N) Hamming distances on bit-packed int32 lanes.

    ``hamming = popcount(q ^ p)``; with a packed per-pattern ``care``
    mask the TCAM wildcard search is ``popcount((q ^ p) & care)``.
    Returned as float32 (counts are < 2**24, so the conversion is exact).
    """
    x = qbits[:, None, :] ^ pbits[None, :, :]
    if care is not None:
        x = x & care[None, :, :]
    return popcount32(x).sum(-1).to(torch.float32)


def ternary_distances(queries: torch.Tensor, patterns: torch.Tensor,
                      care: torch.Tensor) -> torch.Tensor:
    """(M, N) TCAM wildcard Hamming distance on *unpacked* cells."""
    mism = queries[:, None, :] != patterns[None, :, :]
    return (mism & (care[None, :, :] != 0)).sum(-1).to(torch.float32)


def stable_topk(key: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the ``k`` largest keys along the last axis, ties to
    the lower position (the order ``jax.lax.top_k`` guarantees)."""
    _, order = torch.sort(key + 0.0, dim=-1, descending=True, stable=True)
    return order[..., :k]


def _topk_with_ties(scores: torch.Tensor, k: int, largest: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic top-k: ties broken toward the lower index."""
    idx = stable_topk(scores if largest else -scores, k)
    return torch.gather(scores, -1, idx), idx.to(torch.int32)


def cam_topk(queries: torch.Tensor, patterns: torch.Tensor, *, metric: str,
             k: int, largest: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-match search: top-k rows of ``patterns`` per query."""
    return _topk_with_ties(distances(queries, patterns, metric), k, largest)


def cam_topk_ternary(queries: torch.Tensor, patterns: torch.Tensor,
                     care: torch.Tensor, *, k: int, largest: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TCAM wildcard best-match: top-k by care-masked Hamming distance."""
    return _topk_with_ties(ternary_distances(queries, patterns, care), k,
                           largest)


def tile_distance(q_t: torch.Tensor, p_t: torch.Tensor,
                  metric: str) -> torch.Tensor:
    """One column tile's (M, rows) partial distance block — the single
    definition of the per-tile arithmetic every tiled path shares."""
    if metric == "hamming":
        return (q_t[:, None, :] != p_t[None, :, :]).sum(-1).to(torch.float32)
    if metric == "dot":
        return q_t @ p_t.T
    if metric == "eucl":
        qq = (q_t * q_t).sum(-1, keepdim=True)
        ppv = (p_t * p_t).sum(-1)
        return qq + ppv[None, :] - 2.0 * (q_t @ p_t.T)
    raise ValueError(f"tiled path does not support metric {metric!r}")


def _pad2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, cols, 0, rows))


def tiled_distances(queries: torch.Tensor, patterns: torch.Tensor, *,
                    metric: str, tile_rows: int,
                    dims_per_tile: int) -> torch.Tensor:
    """(M, N) distance matrix with *tiled* partial-sum accumulation
    (left-to-right over column tiles, like :func:`cam_topk_tiled`)."""
    dim = queries.shape[1]
    n = patterns.shape[0]
    gr = -(-n // tile_rows)
    gc = -(-dim // dims_per_tile)
    qp = _pad2(queries.to(torch.float32), 0, gc * dims_per_tile - dim)
    pp = _pad2(patterns.to(torch.float32), gr * tile_rows - n,
               gc * dims_per_tile - dim)
    rows = []
    for r in range(gr):
        p_rows = pp[r * tile_rows:(r + 1) * tile_rows]
        dist = None
        for c in range(gc):
            sl = slice(c * dims_per_tile, (c + 1) * dims_per_tile)
            part = tile_distance(qp[:, sl], p_rows[:, sl], metric)
            dist = part if dist is None else dist + part   # horizontal merge
        rows.append(dist)
    return torch.cat(rows, dim=-1)[:, :n]


def pad_candidates(vals: torch.Tensor, idx: torch.Tensor, k: int,
                   largest: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad an (..., k') candidate list up to k with losing sentinels
    (``∓inf`` values, index ``2**30``)."""
    short = k - vals.shape[-1]
    if short <= 0:
        return vals, idx
    lose = -float("inf") if largest else float("inf")
    return (torch.nn.functional.pad(vals, (0, short), value=lose),
            torch.nn.functional.pad(idx, (0, short), value=PAD_INDEX))


def merge_topk(values_a: torch.Tensor, idx_a: torch.Tensor,
               values_b: torch.Tensor, idx_b: torch.Tensor, *, k: int,
               largest: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vertical merge of two (M, k) candidate lists (cam.merge_partial).

    Stable selection over the lists concatenated in ascending global row
    order gives lower-global-index tie-breaking, matching cam_topk.
    """
    vals = torch.cat([values_a, values_b], dim=-1)
    idxs = torch.cat([idx_a, idx_b], dim=-1)
    sel = stable_topk(vals if largest else -vals, k)
    return torch.gather(vals, -1, sel), torch.gather(idxs, -1, sel)


def cam_topk_tiled(queries: torch.Tensor, patterns: torch.Tensor, *,
                   metric: str, k: int, largest: bool, tile_rows: int,
                   dims_per_tile: int, care: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference for the *tiled* (partitioned) execution path.

    Horizontal accumulation of per-column-tile partial distances,
    per-row-tile top-k, then vertical tournament merge with global index
    offsets.  ``care`` (hamming only): per-pattern TCAM wildcard mask.
    """
    m, dim = queries.shape
    n = patterns.shape[0]
    gr = -(-n // tile_rows)
    gc = -(-dim // dims_per_tile)
    pad_n = gr * tile_rows - n
    pad_d = gc * dims_per_tile - dim
    qp = _pad2(queries.to(torch.float32), 0, pad_d)
    pp = _pad2(patterns.to(torch.float32), pad_n, pad_d)
    cp = None
    if care is not None:
        if metric != "hamming":
            raise ValueError("care masks require metric='hamming'")
        cp = _pad2((torch.as_tensor(care) != 0).to(torch.float32), pad_n,
                   pad_d)

    acc_v = acc_i = None
    for r in range(gr):
        rows = slice(r * tile_rows, (r + 1) * tile_rows)
        dist = None
        for c in range(gc):
            sl = slice(c * dims_per_tile, (c + 1) * dims_per_tile)
            q_t, p_t = qp[:, sl], pp[rows, sl]
            if cp is not None:
                part = ((q_t[:, None, :] != p_t[None, :, :])
                        & (cp[rows, sl][None, :, :] != 0)).sum(-1).to(
                            torch.float32)
            else:
                part = tile_distance(q_t, p_t, metric)
            dist = part if dist is None else dist + part   # horizontal merge
        if r == gr - 1 and pad_n:          # padded rows never win
            dist = dist.clone()
            dist[:, tile_rows - pad_n:] = (-float("inf") if largest
                                           else float("inf"))
        v, i = _topk_with_ties(dist, min(k, tile_rows), largest)
        v, i = pad_candidates(v, i + r * tile_rows, k, largest)
        if acc_v is None:
            acc_v, acc_i = v, i
        else:
            acc_v, acc_i = merge_topk(acc_v, acc_i, v, i, k=k,
                                      largest=largest)
    return acc_v, acc_i
