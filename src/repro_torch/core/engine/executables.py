"""Backend executables: the ``(prepare, chunk_fn)`` pairs a plan drives.

* ``prepare(*stored)`` encodes / packs / lays out the stored operands
  (hoisted behind the plan's pattern memo);
* ``chunk_fn(q_chunk, prepared)`` executes one query micro-batch and
  returns its top-k ``(values, indices)`` in the logical metric domain.

Two backends:

* ``"torch"`` — the eager counterpart of the reference's ``"jnp"``
  backend: the same tile layout and the same row-tile tournament
  (column-tile partial sums, per-tile stable top-k, stable merges), plus
  the dense one-tile path for tiny plans.
* ``"cuda"`` — the counterpart of ``"pallas"``: the gallery is encoded
  or packed and padded once to the kernels' blocks, and each chunk is
  one launch of :func:`~repro_torch.kernels.cam_search.fused_topk` or
  :func:`~repro_torch.kernels.cam_search.fused_topk_packed` followed by
  the stable candidate merge.

Numerical contract: bit-identical results for the integer metrics
(hamming / dot / cos through bipolar packing / ternary), float tolerance
for eucl — as pinned by :mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Tuple

import torch

from ...kernels import ops as kops
from ...kernels import packing as kpack
from ...kernels import ref as kref
from ...kernels.cam_search import BLOCK_K, window_rows
from .spec import SimilaritySpec, _bits, _encode, _metric_values

#: elements of one row-tile group's largest intermediate in the torch
#: backend's tournament (the (batch, rows, cells) compare or XOR block)
_GROUP_ELEMS = 1 << 24


def _col_dist_fn(spec: SimilaritySpec, packed: bool) -> Callable:
    """Per-column-tile partial distance over a group of row tiles:
    ``f(qc (B, X), leaves (g, tr, X)) -> (B, g, tr)`` float32.

    Packed leaves are int32 lanes fed to XOR+popcount, unpacked leaves
    float cells fed to the oracle arithmetic; both produce the *same
    integers* for the integer metrics (exact in float32).
    """
    phys_metric, _, _ = _metric_values(spec.metric, spec.largest)
    ternary = spec.care_arg is not None

    def f(qc, pr):
        g, tr = pr[0].shape[:2]
        flat = [x.reshape(g * tr, x.shape[-1]) for x in pr]
        if packed:
            d = kref.packed_distances(qc, flat[0],
                                      flat[1] if ternary else None)
        elif ternary:
            d = kref.ternary_distances(qc, flat[0], flat[1])
        else:
            d = kref.distances(qc, flat[0], phys_metric)
        return d.reshape(qc.shape[0], g, tr)

    return f


def _tile_tournament(spec: SimilaritySpec, col_dist: Callable):
    """The reference's row-tile tournament, eager.

    ``scan(qt, pt, roffs)`` accumulates each row tile's distance over the
    column tiles (left to right, as the reference's scan does), masks
    ragged rows, takes each tile's stable top-k with global indices, pads
    short lists with the losing sentinels, and merges tiles in ascending
    row order.  Row tiles are processed in groups to bound memory; the
    group's tile lists join the running top-k in one stable selection,
    which selects exactly what the reference's tile-by-tile stable
    ``merge_topk`` fold selects (same keys, same ascending-row tie order).
    """
    k = spec.k
    _, _, phys_largest = _metric_values(spec.metric, spec.largest)
    tr = spec.tile_rows
    n = spec.n
    kk = min(k, tr)
    lose = -float("inf") if phys_largest else float("inf")
    n_phys = spec.grid_rows * tr

    def scan(qt, pt, roffs):
        batch = qt.shape[1]
        gc = qt.shape[0]
        cells = max(x.shape[-1] for x in pt)
        g = max(1, _GROUP_ELEMS // (batch * tr * cells))
        rows = torch.arange(tr, device=qt.device, dtype=torch.int32)
        acc_v = acc_i = None
        for t0 in range(0, pt[0].shape[0], g):
            tiles = tuple(x[t0:t0 + g] for x in pt)      # (g, gc, tr, X)
            roff = roffs[t0:t0 + g]
            dist = torch.zeros((batch, tiles[0].shape[0], tr),
                               dtype=torch.float32, device=qt.device)
            for c in range(gc):                          # horizontal merge
                dist = dist + col_dist(qt[c], tuple(x[:, c] for x in tiles))
            gidx = roff[:, None] + rows                  # (g, tr)
            dist = torch.where(gidx[None] < n, dist, lose)   # ragged rows
            sel = kref.stable_topk(dist if phys_largest else -dist, kk)
            v = torch.gather(dist, -1, sel)
            i = sel.to(torch.int32) + roff[None, :, None]
            i = torch.where(i < n_phys, i, kref.PAD_INDEX)
            v, i = kref.pad_candidates(v, i, k, phys_largest)
            v = v.reshape(batch, -1)
            i = i.reshape(batch, -1)
            if acc_v is not None:                        # vertical merge
                v = torch.cat([acc_v, v], dim=-1)
                i = torch.cat([acc_i, i], dim=-1)
            sel = kref.stable_topk(v if phys_largest else -v, k)
            acc_v, acc_i = torch.gather(v, -1, sel), torch.gather(i, -1, sel)
        return acc_v, acc_i

    return scan


def _pad_last2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, cols, 0, rows))


def _layout_queries(q: torch.Tensor, spec: SimilaritySpec,
                    packed: bool = False) -> torch.Tensor:
    """Encode + pad + split a query chunk into per-column-tile slabs,
    ``(gc, B, dpt)`` floats or ``(gc, B, lanes(dpt))`` packed lanes (each
    column tile packs into its own lanes, tail bits zero)."""
    gc, dpt, dim = spec.grid_cols, spec.dims_per_tile, spec.dim
    batch = q.shape[0]
    if packed:
        qb = _pad_last2(_bits(q, spec.metric), 0, gc * dpt - dim)
        return kpack.pack_bits(qb.reshape(batch, gc, dpt)).permute(1, 0, 2)
    qe = _pad_last2(_encode(q, spec.metric).to(torch.float32), 0,
                    gc * dpt - dim)
    return qe.reshape(batch, gc, dpt).permute(1, 0, 2)


def _lay_patterns(p: torch.Tensor, care, spec: SimilaritySpec,
                  gr_total: int, packed: bool) -> Tuple[torch.Tensor, ...]:
    """Gallery (+ care mask) laid out as per-subarray tiles: the leaves
    ``(patterns,)`` or ``(patterns, care)``, each
    ``(gr_total, gc, tile_rows, dpt-or-lanes)``."""
    tr, dpt, gc = spec.tile_rows, spec.dims_per_tile, spec.grid_cols
    rows, cols = gr_total * tr - spec.n, gc * dpt - spec.dim

    def lay(x):
        return x.reshape(gr_total, tr, gc, dpt).permute(0, 2, 1, 3)

    if packed:
        leaves = [kpack.pack_bits(lay(_pad_last2(_bits(p, spec.metric),
                                                 rows, cols)))]
        if care is not None:
            leaves.append(kpack.pack_bits(lay(_pad_last2(care != 0, rows,
                                                         cols))))
        return tuple(leaves)
    pe = _encode(p, spec.metric).to(torch.float32)
    leaves = [lay(_pad_last2(pe, rows, cols)).contiguous()]
    if care is not None:
        ce = (care != 0).to(torch.float32)
        leaves.append(lay(_pad_last2(ce, rows, cols)).contiguous())
    return tuple(leaves)


# ---------------------------------------------------------------------------
# "torch" backend
# ---------------------------------------------------------------------------


def _build_scan_executable(spec: SimilaritySpec, batch: int,
                           packed: bool = False):
    """(prepare, chunk_fn) for the ``"torch"`` (reference-tiled) backend.

    ``chunk_fn`` mirrors ``kernels.ref.cam_topk_tiled`` — same partial-
    sum order, same stable per-tile top-k and tournament merges.  With
    ``packed=True`` the same tournament runs over int32 lane tiles
    (XOR+popcount partial counts) — identical integers.
    """
    _, to_logical, _ = _metric_values(spec.metric, spec.largest)
    gr, dim = spec.grid_rows, spec.dim
    scan = _tile_tournament(spec, _col_dist_fn(spec, packed))

    def prepare(p, care=None):
        return _lay_patterns(p, care, spec, gr, packed)

    def chunk_fn(q, pt):
        qt = _layout_queries(q, spec, packed)
        roffs = torch.arange(gr, device=q.device,
                             dtype=torch.int32) * spec.tile_rows
        v, i = scan(qt, pt, roffs)
        return to_logical(v, float(dim)), i

    return prepare, chunk_fn


def _dense_spec(spec: SimilaritySpec) -> SimilaritySpec:
    """The one-tile equivalent of a single-column-tile spec: the whole
    (physically padded) gallery as one ``(grid_rows * tile_rows, dim)``
    tile.  Dense and tiled execution are bit-identical for such specs."""
    if spec.grid_cols != 1:
        raise ValueError("dense fast path requires grid_cols == 1")
    return replace(spec, tile_rows=spec.grid_rows * spec.tile_rows,
                   grid_rows=1, dims_per_tile=spec.dim)


def _build_tiny_executable(spec: SimilaritySpec, batch: int,
                           packed: bool = False):
    """Dense one-tile executable for tiny similarity plans."""
    return _build_scan_executable(_dense_spec(spec), batch, packed=packed)


# ---------------------------------------------------------------------------
# "cuda" backend
# ---------------------------------------------------------------------------


def _cuda_operands(spec: SimilaritySpec, packed: bool, q: torch.Tensor,
                   prepared: Tuple[torch.Tensor, ...]):
    """``(args, kwargs)`` of the kernel launch for one query chunk:
    :func:`~repro_torch.kernels.cam_search.fused_topk_packed` when
    ``packed``, else :func:`~repro_torch.kernels.cam_search.fused_topk`
    (and of the ``ops.*_prepadded`` merge around it)."""
    phys_metric, _, phys_largest = _metric_values(spec.metric, spec.largest)
    kw = dict(k=min(spec.k, spec.n), largest=phys_largest, n_valid=spec.n)
    if packed:
        qp = kops.pad_to_blocks(kpack.pack_bits(_bits(q, spec.metric)), 1,
                                BLOCK_K)
        care = prepared[1] if len(prepared) > 1 else None
        return (qp, prepared[0], care), kw
    qp = kops.pad_to_blocks(_encode(q, spec.metric).to(torch.float32), 1,
                            BLOCK_K)
    return (qp, prepared[0]), dict(kw, metric=phys_metric)


def _build_cuda_executable(spec: SimilaritySpec, batch: int,
                           packed: bool = False):
    """(prepare, chunk_fn) driving the hand-written CUDA kernels.

    Encoding (or packing) and block padding of the gallery run once per
    stored tensor, behind the plan's pattern memo; each chunk is one
    kernel launch plus the stable candidate merge.  Raises ``ValueError``
    when ``min(k, n)`` exceeds the kernels' ``MAX_K``.
    """
    metric, k = spec.metric, spec.k
    _, to_logical, phys_largest = _metric_values(metric, spec.largest)
    window = window_rows(min(k, spec.n))

    def prepare(p, care=None):
        if packed:
            pp = kops.pad_to_blocks(kpack.pack_bits(_bits(p, metric)),
                                    window, BLOCK_K)
            if care is None:
                return (pp,)
            return (pp, kops.pad_to_blocks(kpack.pack_bits(care != 0),
                                           window, BLOCK_K))
        pe = _encode(p, metric).to(torch.float32)
        return (kops.pad_to_blocks(pe, window, BLOCK_K),)

    def chunk_fn(q, pp):
        args, kw = _cuda_operands(spec, packed, q, pp)
        merge = (kops.cam_topk_packed_prepadded if packed
                 else kops.cam_topk_prepadded)
        v, i = merge(*args, **kw)
        v, i = kref.pad_candidates(v, i, k, phys_largest)
        return to_logical(v, float(spec.dim)), i

    return prepare, chunk_fn
