"""Backend executables: the ``(prepare, chunk_fn, row_update)`` triples a
plan drives.

* ``prepare(*stored)`` encodes / packs / lays out the stored operands
  (hoisted behind the plan's pattern memo);
* ``chunk_fn(q_chunk, prepared)`` executes one query micro-batch and
  returns its top-k ``(values, indices)`` in the logical metric domain
  (a boolean match block for range plans);
* ``row_update(prepared, new_srcs, idx, donate)`` re-lays only the rows
  (``"cuda"``) or row tiles (``"torch"``) a gallery mutation touches
  (see ``PlanBase.update_rows``): in place when ``donate``, else into
  fresh leaves.

Two backends:

* ``"torch"`` — the eager counterpart of the reference's ``"jnp"``
  backend: the same tile layout and the same row-tile tournament
  (column-tile partial sums, per-tile stable top-k, stable merges), plus
  the dense one-tile path for tiny plans.
* ``"cuda"`` — the counterpart of ``"pallas"``: the gallery is encoded
  or packed and padded once to the kernels' blocks, and each chunk is
  one launch of :func:`~repro_torch.kernels.cam_search.fused_topk` or
  :func:`~repro_torch.kernels.cam_search.fused_topk_packed` followed by
  the stable candidate merge; past ``MAX_K`` (the matrix route) one
  launch of the distance or packed distance kernel, then the selection
  kernel (:func:`~repro_torch.kernels.cam_search.topk_by_distance`,
  :func:`~repro_torch.kernels.cam_search.topk_by_packed_distance`).

Sharded plans (``"torch"`` only) split the gallery's row tiles over a
mesh of devices (:func:`~repro_torch.launch.mesh.make_data_mesh`): shard
``d`` holds tiles ``[d tps, (d+1) tps)`` on ``mesh[d]`` and runs the same
tile tournament (or range scan) over them; the candidate lists merge on
the plan's device at finalize (:func:`merge_shard_candidates`), the
match blocks concatenate in shard order.

Range plans (:class:`~.spec.RangeSpec`) have both backends too: the
``"torch"`` row-tile scan (every stored row keeps its own match line, no
tournament) and the ``"cuda"`` path, one launch of
:func:`~repro_torch.kernels.acam.acam_match` (interval) or
:func:`~repro_torch.kernels.acam.range_match` (threshold) per chunk.

Numerical contract: bit-identical results for the integer metrics
(hamming / dot / cos through bipolar packing / ternary / interval),
float tolerance for eucl — as pinned by :mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, List, Tuple

import numpy as np
import torch

from ...kernels import ops as kops
from ...kernels import packing as kpack
from ...kernels import ref as kref
from ...kernels.acam import ACAM_BLOCK_D
from ...kernels.cam_search import (BLOCK_K, MAX_K, PACKED_ROWS,
                                   topk_by_distance, topk_by_packed_distance,
                                   window_rows)
from .spec import RangeSpec, SimilaritySpec, _bits, _encode, _metric_values

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


def _tile_rows_block(arr: torch.Tensor, tiles: torch.Tensor, tr: int,
                     n: int) -> torch.Tensor:
    """The ``(len(tiles) * tr, dim)`` row block covering whole row tiles
    of a stored operand, with slots at or beyond row ``n`` zeroed —
    exactly what a full prepare lays out for those tiles (it zero-pads
    ragged rows after encoding, and every cell encoding maps 0 to 0)."""
    row_ids = (tiles[:, None] * tr + torch.arange(
        tr, device=tiles.device)).reshape(-1)
    block = arr.index_select(0, row_ids.clamp(max=n - 1).to(arr.device))
    return block.masked_fill((row_ids >= n).to(arr.device)[:, None], 0)


def _scatter_leaves(prepared, fresh, at: torch.Tensor, donate: bool):
    """Write ``fresh[i]`` into ``prepared[i]`` at the leading-axis
    positions ``at``: in place when ``donate``, else into copies (the old
    leaves keep serving the old gallery's memo entry)."""
    out = []
    for leaf, f in zip(prepared, fresh):
        dst = leaf if donate else leaf.clone()
        dst.index_copy_(0, at.to(leaf.device), f.to(leaf.device, leaf.dtype))
        out.append(dst)
    return tuple(out)


def _tile_row_update(spec, packed: bool, tps=None) -> Callable:
    """Row-update closure of the tile-layout (``"torch"``) executables,
    similarity and range: runs the same encode/pack/layout a full prepare
    runs, on the touched row tiles only, and scatters them into the
    leaves.  ``srcs`` are the post-mutation stored operands,
    ``(gallery,)`` / ``(gallery, care)`` / ``(lo, hi)``.  A tiny plan's
    dense spec has one tile: the whole gallery.  ``tps`` (sharded plans:
    row tiles per shard) lands each rewritten tile on its owning shard."""
    def update(prepared, srcs, idx, donate=False):
        tiles = np.unique(np.asarray(idx, np.int64) // spec.tile_rows)
        t_dev = torch.as_tensor(tiles, device=srcs[0].device)
        nt = tiles.shape[0]
        tspec = replace(spec, n=nt * spec.tile_rows)
        blocks = [_tile_rows_block(s, t_dev, spec.tile_rows, spec.n)
                  for s in srcs]
        if isinstance(spec, SimilaritySpec):
            fresh = _lay_patterns(blocks[0],
                                  blocks[1] if len(blocks) > 1 else None,
                                  tspec, nt, packed)
        else:
            fresh = _lay_range_patterns(blocks, tspec, nt, packed)
        if tps is not None:
            return _scatter_shards(prepared, fresh, tiles, tps, donate)
        return _scatter_leaves(prepared, fresh, t_dev, donate)

    return update


def _row_scatter_update(spec, packed: bool, interval: bool = False
                        ) -> Callable:
    """Row-update closure of the ``"cuda"`` executables, whose prepared
    layout is the block-padded 2-D operand itself: encode (or pack) the
    touched rows only, zero-pad their columns to the leaf's width as
    prepare does, and scatter them; window-padding rows stay zero."""
    def update(prepared, srcs, idx, donate=False):
        j = torch.as_tensor(np.asarray(idx, np.int64))
        fresh = []
        for leaf, s in zip(prepared, srcs):
            rows = s.index_select(0, j.to(s.device))
            if packed:
                enc = kpack.pack_bits(_bits(rows, spec.metric))
            elif interval:
                enc = rows.to(torch.float32)
            else:
                enc = _encode(rows, spec.metric).to(torch.float32)
            fresh.append(_pad_last2(enc, 0, leaf.shape[1] - enc.shape[1]))
        return _scatter_leaves(prepared, fresh, j, donate)

    return update


# ---------------------------------------------------------------------------
# "torch" backend
# ---------------------------------------------------------------------------


def _build_scan_executable(spec: SimilaritySpec, batch: int,
                           packed: bool = False):
    """(prepare, chunk_fn, row_update) for the ``"torch"``
    (reference-tiled) backend.

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

    return prepare, chunk_fn, _tile_row_update(spec, packed)


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
# sharded "torch" executables
# ---------------------------------------------------------------------------


def _place_shards(leaves: Tuple[torch.Tensor, ...], mesh: List[torch.device],
                  tps: int) -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """Split leaves with ``len(mesh) * tps`` row tiles into per-shard leaf
    tuples, shard ``d`` (tiles ``[d tps, (d+1) tps)``) on ``mesh[d]``.
    On the leaves' own device a shard is a view: no copy."""
    return tuple(tuple(x[d * tps:(d + 1) * tps].to(dev) for x in leaves)
                 for d, dev in enumerate(mesh))


def _scatter_shards(prepared, fresh: Tuple[torch.Tensor, ...],
                    tiles: np.ndarray, tps: int, donate: bool):
    """Write re-laid row tiles ``fresh`` (global tile ids ``tiles``) into
    their owning shards' leaves: in place when ``donate``, else into
    copies of every shard (so no two memo entries share a leaf)."""
    out = []
    for d, leaves in enumerate(prepared):
        sel = np.flatnonzero(tiles // tps == d)
        if sel.size == 0 and donate:
            out.append(leaves)
            continue
        loc = torch.as_tensor(tiles[sel] - d * tps, dtype=torch.int64)
        part = tuple(f.index_select(0, torch.as_tensor(sel, device=f.device))
                     for f in fresh)
        out.append(_scatter_leaves(leaves, part, loc, donate))
    return tuple(out)


def _build_sharded_executable(spec: SimilaritySpec, batch: int,
                              mesh: List[torch.device], device: torch.device,
                              packed: bool = False):
    """(prepare, chunk_fn, row_update) sharding the gallery's row tiles
    over ``mesh``.

    Shard ``d`` holds row tiles ``[d tps, (d+1) tps)`` of the padded
    gallery (``tps = ceil(grid_rows / shards)``) on ``mesh[d]`` and runs
    the single-device tile tournament over them with their global row
    offsets.  ``chunk_fn`` returns the per-shard candidate lists
    ``(shards, batch, k)`` on ``device`` (logical values: the conversion
    is monotone, so the merge may run on them with the logical polarity);
    :func:`merge_shard_candidates` merges them at finalize.  Padding tiles
    from the uneven split lie beyond ``grid_rows * tile_rows``: the
    tournament gives them the losing sentinels (value ``∓inf``, index
    ``2**30``), so the sharded plan's output equals the unsharded one's
    even when ``n < k`` leaves losing slots visible.
    """
    _, to_logical, _ = _metric_values(spec.metric, spec.largest)
    tr, gr, dim = spec.tile_rows, spec.grid_rows, spec.dim
    shards = len(mesh)
    tps = -(-gr // shards)                  # row tiles per shard
    scan = _tile_tournament(spec, _col_dist_fn(spec, packed))

    def prepare(p, care=None):
        return _place_shards(_lay_patterns(p, care, spec, shards * tps,
                                           packed), mesh, tps)

    def chunk_fn(q, shards_pt):
        qt = _layout_queries(q, spec, packed)
        vs, is_ = [], []
        for d, pt in enumerate(shards_pt):
            dev = mesh[d]
            roffs = (d * tps + torch.arange(tps, device=dev,
                                            dtype=torch.int32)) * tr
            v, i = scan(qt.to(dev, non_blocking=True), pt, roffs)
            vs.append(to_logical(v, float(dim)).to(device))
            is_.append(i.to(device))
        return torch.stack(vs), torch.stack(is_)          # (S, B, k)

    return prepare, chunk_fn, _tile_row_update(spec, packed, tps)


def merge_shard_candidates(values: torch.Tensor, indices: torch.Tensor, *,
                           k: int, largest: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-shard top-k of ``(shards, batch, k)`` candidate lists ->
    ``(batch, k)``, on their device.

    Identical to folding :func:`~repro_torch.kernels.ref.merge_topk` over
    the shards in ascending order: concatenation in shard order is
    ascending global-row order, and a stable selection on the (negated,
    for ``largest``) values breaks ties toward the lower global index.
    No arithmetic happens here, so integer-metric results stay
    bit-identical to the single-device plan.
    """
    s, b, kk = values.shape
    vv = values.permute(1, 0, 2).reshape(b, s * kk)
    ii = indices.permute(1, 0, 2).reshape(b, s * kk)
    sel = kref.stable_topk(vv if largest else -vv, k)
    return torch.gather(vv, -1, sel), torch.gather(ii, -1, sel)


# ---------------------------------------------------------------------------
# "cuda" backend
# ---------------------------------------------------------------------------


def _cuda_operands(spec: SimilaritySpec, packed: bool, q: torch.Tensor,
                   prepared: Tuple[torch.Tensor, ...]):
    """``(args, kwargs)`` of the kernel launch for one query chunk:
    :func:`~repro_torch.kernels.cam_search.fused_topk_packed` when
    ``packed``, else :func:`~repro_torch.kernels.cam_search.fused_topk`
    (and of the ``ops.*_prepadded`` merge around it); on the matrix route
    the same operands go to ``topk_by_packed_distance`` /
    ``topk_by_distance``."""
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
    """(prepare, chunk_fn, row_update) driving the hand-written CUDA
    kernels.

    Encoding (or packing) and block padding of the gallery run once per
    stored tensor, behind the plan's pattern memo; each chunk is one
    kernel launch plus the stable candidate merge.  When ``min(k, n)``
    exceeds the kernels' ``MAX_K`` (no window fits) the shape picks the
    matrix route instead, never a failure: the same operands (float
    cells, or packed lanes in rows padded to ``PACKED_ROWS``), and each
    chunk is one launch of the distance kernel (or the packed distance
    kernel) and one of the selection kernel.  The row update re-encodes
    (or re-packs) the touched rows and scatters them.
    """
    metric, k = spec.metric, spec.k
    _, to_logical, phys_largest = _metric_values(metric, spec.largest)
    matrix = min(k, spec.n) > MAX_K
    if matrix:
        rows = PACKED_ROWS if packed else 1
        search = topk_by_packed_distance if packed else topk_by_distance
    else:
        rows = window_rows(min(k, spec.n))
        search = (kops.cam_topk_packed_prepadded if packed
                  else kops.cam_topk_prepadded)

    def prepare(p, care=None):
        if packed:
            pp = kops.pad_to_blocks(kpack.pack_bits(_bits(p, metric)),
                                    rows, BLOCK_K)
            if care is None:
                return (pp,)
            return (pp, kops.pad_to_blocks(kpack.pack_bits(care != 0),
                                           rows, BLOCK_K))
        pe = _encode(p, metric).to(torch.float32)
        return (kops.pad_to_blocks(pe, rows, BLOCK_K),)

    def chunk_fn(q, pp):
        args, kw = _cuda_operands(spec, packed, q, pp)
        v, i = search(*args, **kw)
        v, i = kref.pad_candidates(v, i, k, phys_largest)
        return to_logical(v, float(spec.dim)), i

    return prepare, chunk_fn, _row_scatter_update(spec, packed)


# ---------------------------------------------------------------------------
# Range-search executables (boolean match: TH threshold / aCAM interval)
# ---------------------------------------------------------------------------


def _range_col_fn(spec: RangeSpec, packed: bool) -> Callable:
    """Per-column-tile partial value of a range program over a group of
    row tiles: ``f(qc (B, X), leaves (g, tr, X)) -> (B, g, tr)`` float32.

    Threshold mode accumulates the physical distances of the search path
    (packed popcounts included); interval mode accumulates aCAM
    violation counts.  Both are additive over column tiles.
    """
    if spec.mode == "interval":
        def dist(qc, flat):
            return kref.acam_violations(qc, flat[0], flat[1])
    elif packed:
        def dist(qc, flat):
            return kref.packed_distances(qc, flat[0])
    else:
        phys_metric, _, _ = _metric_values(spec.metric, True)

        def dist(qc, flat):
            return kref.distances(qc, flat[0], phys_metric)

    def f(qc, pr):
        g, tr = pr[0].shape[:2]
        flat = [x.reshape(g * tr, x.shape[-1]) for x in pr]
        return dist(qc, flat).reshape(qc.shape[0], g, tr)

    return f


def _range_compare(spec: RangeSpec) -> Callable:
    """Value block -> boolean match block, in the logical metric domain."""
    if spec.mode == "interval":
        return lambda d: d == 0
    _, to_logical, _ = _metric_values(spec.metric, True)
    tau, below, dim = spec.threshold, spec.below, float(spec.dim)
    if below:
        return lambda d: to_logical(d, dim) <= tau
    return lambda d: to_logical(d, dim) >= tau


def _range_tile_scan(spec: RangeSpec, col_fn: Callable) -> Callable:
    """Row-tile scan of a range program: ``scan(qt, pt)`` accumulates each
    row tile's physical value over the column tiles (left to right, as
    the reference's scan does), compares it, and returns the
    ``(batch, n_tiles * tile_rows)`` match block.  No tournament: every
    stored row keeps its own match line.

    Row tiles run in groups to bound the Python loop; a group's values
    are integers except for eucl, whose groups are single row tiles so
    that every float operation has the shapes of
    :func:`~repro_torch.kernels.ref.tiled_distances` (the interpreter's
    oracle) and the two stay bit-identical.
    """
    tr = spec.tile_rows
    compare = _range_compare(spec)
    single = spec.mode == "threshold" and \
        _metric_values(spec.metric, True)[0] == "eucl"

    def scan(qt, pt):
        batch, gc = qt.shape[1], qt.shape[0]
        cells = max(x.shape[-1] for x in pt)
        g = 1 if single else max(1, _GROUP_ELEMS // (batch * tr * cells))
        hits = []
        for t0 in range(0, pt[0].shape[0], g):
            tiles = tuple(x[t0:t0 + g] for x in pt)      # (g, gc, tr, X)
            dist = None
            for c in range(gc):                          # horizontal merge
                part = col_fn(qt[c], tuple(x[:, c] for x in tiles))
                dist = part if dist is None else dist + part
            hits.append(compare(dist).reshape(batch, -1))
        return torch.cat(hits, dim=-1)

    return scan


def _lay_range_patterns(pats, spec: RangeSpec, gr_total: int,
                        packed: bool) -> Tuple[torch.Tensor, ...]:
    """Stored operands laid out as per-subarray tiles: ``(patterns,)``
    or ``(lo, hi)``, each ``(gr_total, gc, tr, X)``.  Zero padding is
    interval-safe: padded dims carry ``q = lo = hi = 0`` (never a
    violation) and padded rows land beyond ``spec.n``, where finalize
    slices them off."""
    leaves = []
    for p in pats:
        leaves.extend(_lay_patterns(p, None, spec, gr_total, packed))
    return tuple(leaves)


def _build_range_scan_executable(spec: RangeSpec, batch: int,
                                 packed: bool = False):
    """(prepare, chunk_fn, row_update) for the ``"torch"`` range path:
    ``chunk_fn`` returns the ``(batch, grid_rows * tile_rows)`` boolean
    match block."""
    gr = spec.grid_rows
    scan = _range_tile_scan(spec, _range_col_fn(spec, packed))

    def prepare(*pats):
        return _lay_range_patterns(pats, spec, gr, packed)

    def chunk_fn(q, pt):
        return scan(_layout_queries(q, spec, packed), pt)

    return prepare, chunk_fn, _tile_row_update(spec, packed)


def _build_tiny_range_executable(spec: RangeSpec, batch: int,
                                 packed: bool = False):
    """Dense one-tile executable for tiny range plans (the forest
    small-program case) — the range twin of
    :func:`_build_tiny_executable`."""
    return _build_range_scan_executable(_dense_spec(spec), batch,
                                        packed=packed)


def _build_range_sharded_executable(spec: RangeSpec, batch: int,
                                    mesh: List[torch.device],
                                    device: torch.device,
                                    packed: bool = False):
    """(prepare, chunk_fn, row_update) sharding a range plan's stored
    rows over ``mesh``: the row split of :func:`_build_sharded_executable`,
    with per-shard boolean match blocks ``(shards, batch, tps *
    tile_rows)`` that concatenate in shard order (ascending global row
    order) at finalize; range search has no cross-shard tournament."""
    gr, tr = spec.grid_rows, spec.tile_rows
    shards = len(mesh)
    tps = -(-gr // shards)
    scan = _range_tile_scan(spec, _range_col_fn(spec, packed))

    def prepare(*pats):
        return _place_shards(_lay_range_patterns(pats, spec, shards * tps,
                                                 packed), mesh, tps)

    def chunk_fn(q, shards_pt):
        qt = _layout_queries(q, spec, packed)
        hits = [scan(qt.to(dev, non_blocking=True), pt).to(device)
                for dev, pt in zip(mesh, shards_pt)]
        return torch.stack(hits)                  # (S, B, tps * tr)

    return prepare, chunk_fn, _tile_row_update(spec, packed, tps)


def _build_range_cuda_executable(spec: RangeSpec, batch: int):
    """(prepare, chunk_fn, row_update) driving the interval and threshold
    kernels.

    The stored operands are encoded and zero-padded once, in the inner
    dimension only, to the kernel's block (behind the pattern memo); the
    kernels take any row count and mask rows at or past ``n``.  Each
    chunk is one launch returning its ``(batch, n)`` ``torch.bool``
    match block: the threshold (or the ``violations == 0`` test) happens
    in the kernel.  Float cells only — a packed range plan is the
    ``"torch"`` backend's.
    """
    n, dim = spec.n, spec.dim
    if spec.mode == "interval":
        def prepare(lo, hi):
            return tuple(kops.pad_to_blocks(x.to(torch.float32), 1,
                                            ACAM_BLOCK_D) for x in (lo, hi))

        def chunk_fn(q, pp):
            qp = kops.pad_to_blocks(q.to(torch.float32), 1, ACAM_BLOCK_D)
            return kops.acam_match_prepadded(qp, pp[0], pp[1], n_valid=n)

        return prepare, chunk_fn, _row_scatter_update(spec, False,
                                                      interval=True)

    metric = spec.metric
    phys_metric, _, _ = _metric_values(metric, True)
    to_logical = "bipolar" if metric in ("dot", "cos") else "identity"

    def prepare(p):
        pe = _encode(p, metric).to(torch.float32)
        return (kops.pad_to_blocks(pe, 1, BLOCK_K),)

    def chunk_fn(q, pp):
        qp = kops.pad_to_blocks(_encode(q, metric).to(torch.float32), 1,
                                BLOCK_K)
        return kops.cam_range_match_prepadded(
            qp, pp[0], metric=phys_metric, threshold=spec.threshold,
            below=spec.below, to_logical=to_logical, dim=dim, n_valid=n)

    return prepare, chunk_fn, _row_scatter_update(spec, False)
