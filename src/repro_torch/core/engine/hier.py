"""Hierarchical two-stage CAM search: :class:`HierarchicalPlan`.

The CAM analogue of an IVF index, built on the plan-graph layer
(:mod:`.composite`).  ``prepare`` clusters the gallery rows with a
seeded k-means and lays each cluster out on its own group of row tiles;
at dispatch time a *coarse* :class:`~.plans.SearchPlan` over the
cluster centroids selects the ``nprobe`` most promising clusters per
query, and the *fine* probe searches only those clusters' tiles —
activating ``~nprobe / clusters`` of the crossbar array instead of all
of it (the paper's energy argument for hierarchical search: match-line
precharge is the dominant per-query cost, and it scales with the number
of searched subarrays).

Both stages run eager torch on the plan's device (the ``"torch"``
backend, the twin of the reference's ``"jnp"``); no hand-written kernel
is on this path.

Correctness contract
--------------------

The fine stage selects candidates by the composite order **(physical
value, global row id)** — one int64 key per candidate, the value's
order-preserving bits above the row id, so the selection has no ties
to break — which is exactly the order the flat tile tournament
resolves ties in (stable per-tile top-k + ascending-row merges).  Row
placement inside the cluster tiles is therefore irrelevant to the
result: any probe schedule that covers the true top-k rows returns
bit-identical output to the flat plan (integer metrics; eucl keeps the
float-tolerance contract).  Consequences:

* ``nprobe == clusters`` probes everything → bit-identical to the flat
  plan, packed or not.  (One dead-slot caveat: when fewer than k rows
  exist/are probed, the losing slots carry the ``2**30`` sentinel index
  here, while the flat tournament may report ragged in-extent
  positions — same losing values, geometry-dependent filler indices.
  Winning slots always match exactly.)
* ``update_rows`` may place a moved row in *any* free slot of its new
  cluster — results match a full re-layout with the same centroids
  bit-for-bit, so the incremental path needs no compensation logic.
* Centroids are **fixed** across ``update_rows`` (k-means runs once per
  prepared gallery).  A mutated row is reassigned to its nearest stored
  centroid; if its new cluster's tiles are full, the whole layout is
  rebuilt (same centroids, fresh uniform tiles-per-cluster).

k-means sums rows per cluster with one-hot products in a fixed row
order (never atomics, whose order changes from run to run), so two
prepares of one gallery give bit-identical centroids on the card.  For
the packable metrics the cells are {0, 1}: the sums are exact integers,
and centroids and assignments equal the reference's bit for bit.

Sharding splits the *fine tile axis* over a mesh of devices
(:func:`~repro_torch.launch.mesh.make_data_mesh`): each shard holds
``1/shards`` of the cluster tiles and probes only the candidate tiles it
owns (foreign candidates mask to sentinels).  The shards' candidate lists
merge on the plan's device by the same composite order
(:func:`_merge_hier_shards`: probing order is not ascending-row order,
unlike the flat shard merge).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ...kernels.cam_search import order_key as _order_key
from ...kernels.packing import lanes, popcount32
from ...obs.trace import trace_span, tracer
from ..envcfg import env_int
from ...launch.mesh import make_data_mesh
from .base import _index_array, _pick_batch, resolve_device
from .cache import (_check_shard_backend, _lookup_or_insert,
                    _normalize_shards, get_plan)
from .composite import CompositePlan, HierarchicalSpec
from .executables import (_lay_patterns, _layout_queries, _place_shards,
                          _scatter_leaves, _scatter_shards)
from .plans import SearchPlan, _finalize_topk
from .spec import (SimilaritySpec, _PACKABLE_METRICS, _bits, _metric_values,
                   _resolve_pack, extract_plan_spec, module_for_spec)

__all__ = ["HierarchicalPlan", "get_hierarchical_plan"]

#: sentinel global row id for empty tile slots / losing candidates —
#: the value the flat executables' ``pad_candidates`` emits, so a
#: hierarchical result is indistinguishable from a flat one
_SENT = 2 ** 30

#: rows per one-hot block of the k-means cluster sums (bounds the
#: ``(rows, clusters)`` one-hot at about 64 MB of float32)
_ONEHOT_ELEMS = 1 << 24


# ---------------------------------------------------------------------------
# Clustering: seeded k-means + assignment (matmuls on the plan's device)
# ---------------------------------------------------------------------------


def _enc_f32(x: torch.Tensor, metric: str) -> torch.Tensor:
    """Rows in the clustering space: cell bits (as {0,1} float32) for
    the packable metrics — their physical search is Hamming on bits —
    raw float32 values for eucl."""
    if metric in _PACKABLE_METRICS:
        return _bits(x, metric).to(torch.float32)
    return x.to(torch.float32)


def _argmin_assign(rows: torch.Tensor, cent: torch.Tensor,
                   metric: str) -> torch.Tensor:
    """Nearest stored centroid per row (int64), ties to the lower
    centroid id.

    Distances via matmul: Hamming between bit vectors is
    ``b @ (1-c)^T + (1-b) @ c^T`` — exact integers in float32 — and eucl
    uses the same expansion as the kernels.  The products are float32 at
    full precision (PyTorch's default: no TF32).  ``argmin`` picks the
    first minimum, which makes assignment deterministic.
    """
    if metric in _PACKABLE_METRICS:
        d = rows @ (1.0 - cent).T + (1.0 - rows) @ cent.T
    else:
        qq = (rows * rows).sum(-1, keepdim=True)
        cc = (cent * cent).sum(-1)
        d = qq + cc[None, :] - 2.0 * (rows @ cent.T)
    return torch.argmin(d, dim=1)


def _assign_rows(rows_raw: torch.Tensor, cent_src: torch.Tensor,
                 metric: str) -> np.ndarray:
    """Assignment of raw-domain rows against the stored raw-domain
    centroids (``update_rows`` reassignment), as host int32."""
    a = _argmin_assign(_enc_f32(rows_raw, metric),
                       _enc_f32(cent_src, metric), metric)
    return a.cpu().numpy().astype(np.int32)


def _cluster_sums(enc: torch.Tensor, a: torch.Tensor,
                  clusters: int) -> torch.Tensor:
    """``(clusters, dim)`` per-cluster row sums in a fixed order: one-hot
    products over blocks of rows, accumulated block by block.  (A
    scatter-add would sum with atomics, in an order that changes from
    run to run on the card, and move eucl centroids by ulps.)"""
    n = enc.shape[0]
    ids = torch.arange(clusters, device=enc.device)
    block = max(1, _ONEHOT_ELEMS // max(clusters, 1))
    sums = torch.zeros((clusters, enc.shape[1]), dtype=torch.float32,
                       device=enc.device)
    for s in range(0, n, block):
        onehot = (a[s:s + block, None] == ids).to(torch.float32)
        sums += onehot.T @ enc[s:s + block]
    return sums


def _kmeans(g: torch.Tensor, spec_h: HierarchicalSpec
            ) -> Tuple[torch.Tensor, np.ndarray]:
    """Seeded Lloyd k-means over the encoded gallery.

    Returns ``(centroids, assign)`` — centroids in the *raw input
    domain* on ``g``'s device (binarised {0,1} cells for the packable
    metrics, float means for eucl) so they can be stored directly as
    the coarse plan's gallery, and the final per-row cluster assignment
    (host int32).  Deterministic: seeded init (distinct rows, numpy's
    ``default_rng(seed).choice`` as the reference draws them),
    first-minimum ties, mean-threshold binarisation; empty clusters keep
    their previous centroid.
    """
    fine = spec_h.fine
    n, clusters = fine.n, spec_h.clusters
    metric = fine.metric
    enc = _enc_f32(g, metric)
    rng = np.random.default_rng(spec_h.seed)
    pick = rng.choice(n, size=clusters, replace=False)
    cent = enc[torch.as_tensor(pick, device=enc.device)]
    binary = metric in _PACKABLE_METRICS
    for _ in range(spec_h.kmeans_iters):
        a = _argmin_assign(enc, cent, metric)
        sums = _cluster_sums(enc, a, clusters)
        cnt = torch.bincount(a, minlength=clusters).to(torch.float32)
        mean = sums / torch.clamp(cnt, min=1.0)[:, None]
        newc = (mean > 0.5).to(torch.float32) if binary else mean
        cent = torch.where((cnt > 0.0)[:, None], newc, cent)
    a = _argmin_assign(enc, cent, metric)
    return cent, a.cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# Layout: cluster assignment -> per-cluster tile groups (host numpy)
# ---------------------------------------------------------------------------


def _layout_from_assign(assign: np.ndarray, clusters: int, tr: int,
                        n: int) -> Tuple[np.ndarray, np.ndarray, int,
                                         np.ndarray]:
    """Uniform tiles-per-cluster slot layout from an assignment.

    Every cluster gets ``tpc = ceil(max_cluster_size / tile_rows)``
    tiles (uniform so a probe step's candidate tile id is just
    ``cluster * tpc + j``).  Rows land in their cluster's slots in
    ascending global-id order; empty slots carry the ``_SENT`` row id.
    Returns ``(row_ids (T, tr), slot_of (n,), tpc, cnt (clusters,))``
    where ``cnt[c]`` is the *occupied tile prefix* of cluster ``c`` —
    k-means clusters are imbalanced, so most clusters fill far fewer
    than ``tpc`` tiles and the probe skips the all-sentinel remainder
    (see :func:`_probe_budget`).
    """
    counts = np.bincount(assign, minlength=clusters)
    tpc = max(1, int(-(-int(counts.max()) // tr))) if n else 1
    cap = tpc * tr
    flat = np.full(clusters * cap, _SENT, np.int32)
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    pos = np.arange(n, dtype=np.int64) - starts[assign[order]]
    slot = assign[order].astype(np.int64) * cap + pos
    flat[slot] = order.astype(np.int32)
    slot_of = np.empty(n, np.int64)
    slot_of[order] = slot
    cnt = (-(-counts // tr)).astype(np.int32)       # rows fill a prefix
    return flat.reshape(clusters * tpc, tr), slot_of, tpc, cnt


def _probe_budget(cnt: np.ndarray, nprobe: int, tpc: int) -> int:
    """Per-query probe-step budget: the worst case any query can need is
    the ``nprobe`` largest occupied-tile prefixes — dependent on the
    *gallery* (known at prepare time), never on the queries.  Rounded up
    to a multiple of 16 steps (the reference's bucketing, kept so the two
    packages count the same steps), capped at the padded ``nprobe * tpc``
    it replaces."""
    top = np.sort(cnt)[::-1][:nprobe]
    nb = int(top.sum())
    nb = -(-max(nb, 1) // 16) * 16
    return max(1, min(nprobe * tpc, nb))


def _gather_rows(g: torch.Tensor, row_ids: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Gallery rows by slot; empty slots (``_SENT``) become zero rows,
    which every cell encoding preserves."""
    flat = row_ids.reshape(-1).to(device=g.device, dtype=torch.int64)
    rows = g.index_select(0, flat.clamp(max=n - 1))
    return rows.masked_fill((flat >= _SENT)[:, None], 0)


def _leaves_from_rows(g: torch.Tensor, row_ids: torch.Tensor,
                      fine: SimilaritySpec, packed: bool) -> Tuple:
    """Fine tile leaves from the slot layout: the standard pattern layout
    of the gallery permuted by slot."""
    t, tr = row_ids.shape
    lspec = replace(fine, n=t * tr, grid_rows=t)
    return _lay_patterns(_gather_rows(g, row_ids, fine.n), None, lspec, t,
                         packed)


@dataclass
class HierState:
    """A prepared hierarchical gallery (one pattern-memo entry).

    Device state: the centroid gallery + its coarse-prepared leaves, the
    fine tile leaves, the slot->row-id map and the occupied-tile
    prefixes.  Host state: the assignment / slot bookkeeping
    ``update_rows`` rewrites (master copies — the incremental path copies
    before mutating so an older memo entry never sees a newer layout) and
    the ints that size the probe.
    """

    centroid_src: torch.Tensor         # (clusters, dim) raw-domain
    coarse_prepared: Any               # coarse plan's prepared leaves
    #: ``((T, gc, tr, X),)``; sharded: one such tuple per shard, ``tps``
    #: tiles each, on the shard's device
    leaves: Tuple[Any, ...]
    #: ``(T, tr)`` int32; sharded: one ``(tps, tr)`` tensor per shard
    row_ids: Any
    assign: np.ndarray                 # (n,) int32
    slot_of: np.ndarray                # (n,) int64 flat slot index
    row_ids_h: np.ndarray              # (T, tr) int32, host master
    tpc: int                           # tiles per cluster
    cnt: torch.Tensor                  # (clusters,) int64 occupied prefix
    cnt_h: np.ndarray                  # host master of ``cnt``
    budget: int                        # probe steps per query


def _shard_rids(row_h: np.ndarray, mesh, tps: int) -> Tuple[torch.Tensor, ...]:
    """The slot -> row-id map split into ``len(mesh)`` shards of ``tps``
    tiles (padding tiles all ``_SENT``), shard ``d`` on ``mesh[d]``."""
    t, tr = row_h.shape
    rid = np.full((len(mesh) * tps, tr), _SENT, np.int32)
    rid[:t] = row_h
    return tuple(torch.as_tensor(rid[d * tps:(d + 1) * tps], device=dev)
                 for d, dev in enumerate(mesh))


def _shard_state(leaves: Tuple[torch.Tensor, ...], row_h: np.ndarray, mesh):
    """Fine leaves and row ids of a full layout, split over ``mesh``:
    ``tps = ceil(T / shards)`` tiles a shard, the padding tiles zero
    leaves with ``_SENT`` row ids."""
    t = row_h.shape[0]
    tps = -(-t // len(mesh))
    pad_t = len(mesh) * tps - t
    if pad_t:
        leaves = tuple(torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 1) + (0, pad_t)) for x in leaves)
    return _place_shards(leaves, mesh, tps), _shard_rids(row_h, mesh, tps)


def _hier_state(spec_h: HierarchicalSpec, packed: bool, g: torch.Tensor,
                cent_src: torch.Tensor, cpp, assign: np.ndarray,
                mesh=None) -> HierState:
    """The state a full layout builds for ``assign`` with the given
    centroids (and their coarse-prepared leaves): what ``prepare`` builds
    after k-means, and an overflow re-layout builds with the stored
    centroids.  ``mesh``: a sharded plan's devices (the leaves and row
    ids split over them)."""
    fine = spec_h.fine
    row_h, slot_of, tpc, cnt_h = _layout_from_assign(
        assign, spec_h.clusters, fine.tile_rows, fine.n)
    rid = torch.as_tensor(row_h, device=g.device)
    leaves = _leaves_from_rows(g, rid, fine, packed)
    if mesh is not None:
        leaves, rid = _shard_state(leaves, row_h, mesh)
    return HierState(
        centroid_src=cent_src, coarse_prepared=cpp,
        leaves=leaves, row_ids=rid,
        assign=assign, slot_of=slot_of, row_ids_h=row_h, tpc=tpc,
        cnt=torch.as_tensor(cnt_h, dtype=torch.int64, device=g.device),
        cnt_h=cnt_h, budget=_probe_budget(cnt_h, spec_h.nprobe, tpc))


# ---------------------------------------------------------------------------
# The fine probe (eager torch)
# ---------------------------------------------------------------------------


def _batched_tile_dist(fine: SimilaritySpec, packed: bool):
    """Per-query-tile distance: ``f(qt (B, gc, X), pt (B, G, gc, tr, X))
    -> (B, G, tr)`` where *each query has its own tiles*.  The flat
    per-tile arithmetic — mismatch counts / packed popcounts are exact
    integers, eucl uses the identical expansion per column tile — so the
    probed values equal the flat tournament's values (eucl: to the float
    tolerance; the column tiles' partial sums are added in one reduction
    here, left to right in the flat scan).  All column tiles go in one
    expression: a Python loop over them would cost a launch per column
    tile per probe group (128 column tiles at the KNN geometry)."""
    phys_metric, _, _ = _metric_values(fine.metric, fine.largest)
    if packed:
        def fp(qt, pt):
            x = popcount32(qt[:, None, :, None, :] ^ pt)
            return x.sum(-1).sum(2).to(torch.float32)
        return fp
    if phys_metric == "hamming":
        return lambda qt, pt: (qt[:, None, :, None, :] != pt).sum(-1) \
            .sum(2).to(torch.float32)

    def fe(qt, pt):
        # products as elementwise multiply-and-sum: as a batched matmul
        # each (query, column tile) pair would be its own tiny GEMV
        qb = qt[:, None, :, None, :]
        qq = (qb * qb).sum(-1)                            # (B, 1, gc, 1)
        pp = (pt * pt).sum(-1)                            # (B, G, gc, tr)
        dot = (pt * qb).sum(-1)
        return (qq + pp - 2.0 * dot).sum(2)
    return fe


#: per-group gather budget (elements): probe steps are grouped so one
#: selection covers many candidate tiles — one tile per selection is
#: launch-bound — while the gathered group buffer stays bounded (~64 MB
#: at 4 B/element)
_GROUP_BUDGET = 1 << 24


def _select(k: int, ks, kg, kd):
    """The k smallest candidates by (skey, gid), in that order.  Live row
    ids are distinct per query (a query probes each tile at most once),
    so the keys of live candidates are distinct and ``torch.topk`` has
    no tie to order; equal keys are identical sentinel triples."""
    _, pos = torch.topk(_order_key(ks, kg), k, dim=-1, largest=False,
                        sorted=True)
    return ks.gather(-1, pos), kg.gather(-1, pos), kd.gather(-1, pos)


def _step_to_tile(ss: torch.Tensor, pre: torch.Tensor, nprobe: int):
    """Map probe steps ``ss`` (G,) to each query's (probe rank, tile
    offset, live) ``(B, G)``.

    ``pre`` (B, nprobe+1) is the per-query inclusive prefix sum of the
    probed clusters' occupied-tile counts: step ``s`` belongs to the
    probe rank whose prefix window contains it, at offset ``s`` minus
    the window start.  Steps past ``pre[:, -1]`` are dead padding (the
    budget covers the worst-case query; most need fewer).
    """
    s = ss[None, :]
    p = (s[..., None] >= pre[:, None, 1:]).sum(-1)
    p = torch.clamp(p, max=nprobe - 1)
    j = s - torch.gather(pre, 1, p)
    live = s < pre[:, -1:]
    return p, j, live


def _probe_prefix(ci: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Per-query prefix sums of the probed clusters' occupied-tile
    counts: ``(B, nprobe+1)`` int64, leading zero column."""
    pc = cnt[ci]
    return torch.nn.functional.pad(torch.cumsum(pc, dim=1), (1, 0))


def _probe_steps(spec_h: HierarchicalSpec, packed: bool):
    """The candidate-tile loop shared by the single-device and sharded
    probes: ``run(qt, gather, bsz, budget, dev)`` folds ``budget`` probe
    steps, where ``gather(ss) -> (tiles (B, G, gc, tr, X), row_ids (B, G,
    tr))`` fetches steps ``ss``' candidate tiles (``_SENT`` ids for dead
    or foreign steps).

    Steps run in groups: each gathers ``G`` candidate tiles per query and
    folds their ``G * tile_rows`` candidates, with the running top-k,
    through one composite-order selection truncated to k.  ``G`` is the
    largest group whose gathered slab fits ``_GROUP_BUDGET`` elements
    (the selection is associative, so the grouping never changes the
    result).  Returns the physical ``(values, row ids)``.
    """
    fine = spec_h.fine
    _, _, phys_largest = _metric_values(fine.metric, fine.largest)
    tr, k, gc = fine.tile_rows, fine.k, fine.grid_cols
    lose = -float("inf") if phys_largest else float("inf")
    tile_dist = _batched_tile_dist(fine, packed)
    #: slab width (elements) of one gathered tile row, all column tiles
    wpr = gc * (lanes(fine.dims_per_tile) if packed else fine.dims_per_tile)

    def run(qt, gather, bsz, budget, dev):
        ks = torch.full((bsz, k), float("inf"), device=dev)
        kg = torch.full((bsz, k), _SENT, dtype=torch.int32, device=dev)
        kd = torch.full((bsz, k), lose, device=dev)
        group = max(1, min(budget, _GROUP_BUDGET // max(1, bsz * tr * wpr)))
        for s0 in range(0, budget, group):
            ss = torch.arange(s0, min(s0 + group, budget), device=dev)
            tiles, rg = gather(ss)                       # rg (B, G, tr)
            dist = tile_dist(qt, tiles)                   # (B, G, tr)
            dist, rg = dist.reshape(bsz, -1), rg.reshape(bsz, -1)
            valid = rg < _SENT
            sk = torch.where(valid, -dist if phys_largest else dist,
                             float("inf"))
            dd = torch.where(valid, dist, lose)
            ks, kg, kd = _select(k, torch.cat([ks, sk], dim=-1),
                                 torch.cat([kg, rg], dim=-1),
                                 torch.cat([kd, dd], dim=-1))
        return kd, kg

    return run


def _hier_probe(spec_h: HierarchicalSpec, packed: bool):
    """The fine probe: ``probe(q, ci, leaf, rid, cnt, tpc, budget)`` ->
    logical ``(values, indices)``.

    Each step probes one *occupied* tile of one probed cluster per
    query: the prefix map (:func:`_step_to_tile`) packs the ragged
    per-cluster tile lists into a dense schedule of ``budget`` steps,
    folded by :func:`_probe_steps`.
    """
    fine = spec_h.fine
    nprobe = spec_h.nprobe
    _, to_logical, _ = _metric_values(fine.metric, fine.largest)
    run = _probe_steps(spec_h, packed)

    def probe(q, ci, leaf, rid, cnt, tpc, budget):
        qt = _layout_queries(q, fine, packed).transpose(0, 1)  # (B, gc, X)
        ci = ci.to(torch.int64)
        pre = _probe_prefix(ci, cnt)

        def gather(ss):
            p, j, live = _step_to_tile(ss, pre, nprobe)
            c = torch.gather(ci, 1, p)
            tile = torch.clamp(c * tpc + j, 0, leaf.shape[0] - 1)
            return leaf[tile], torch.where(live[..., None], rid[tile], _SENT)

        kd, kg = run(qt, gather, q.shape[0], budget, q.device)
        return to_logical(kd, float(fine.dim)), kg

    return probe


def _hier_probe_sharded(spec_h: HierarchicalSpec, packed: bool, mesh,
                        device: torch.device):
    """The sharded fine probe: ``probe(q, ci, leaves, rids, cnt, tpc,
    budget)`` with one leaf and one row-id tensor per shard.  Each shard
    walks the whole step schedule on its device but gathers only the
    candidate tiles it owns (foreign ones mask to sentinels) and emits its
    own (B, k) list; the lists come back stacked ``(shards, B, k)`` on
    ``device`` for :func:`_merge_hier_shards`."""
    fine = spec_h.fine
    nprobe = spec_h.nprobe
    _, to_logical, _ = _metric_values(fine.metric, fine.largest)
    run = _probe_steps(spec_h, packed)

    def probe(q, ci, leaves, rids, cnt, tpc, budget):
        qt = _layout_queries(q, fine, packed).transpose(0, 1)
        vs, is_ = [], []
        for d, (leaf, rid) in enumerate(zip(leaves, rids)):
            dev, tps = mesh[d], leaf.shape[0]
            ci_d = ci.to(dev, torch.int64)
            pre = _probe_prefix(ci_d, cnt.to(dev))

            def gather(ss, d=d, leaf=leaf, rid=rid, ci_d=ci_d, pre=pre,
                       tps=tps):
                p, j, live = _step_to_tile(ss, pre, nprobe)
                loc = torch.gather(ci_d, 1, p) * tpc + j - d * tps
                own = live & (loc >= 0) & (loc < tps)
                loc = torch.clamp(loc, 0, tps - 1)
                return leaf[loc], torch.where(own[..., None], rid[loc], _SENT)

            kd, kg = run(qt.to(dev, non_blocking=True), gather, q.shape[0],
                         budget, dev)
            vs.append(to_logical(kd, float(fine.dim)).to(device))
            is_.append(kg.to(device))
        return torch.stack(vs), torch.stack(is_)

    return probe


def _merge_hier_shards(values: torch.Tensor, indices: torch.Tensor, *,
                       k: int, largest: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-shard merge of hierarchical candidates ``(shards, B, k)``.

    Unlike :func:`~.executables.merge_shard_candidates` (where shard
    order *is* ascending global-row order, so a stable value selection
    suffices), hierarchical shards hold permuted rows: the tie-break must
    be the explicit global row id.  One selection on the composite key
    (value key, row id) reproduces the flat tournament's order exactly;
    no arithmetic happens, so integer-metric results stay bit-identical.
    """
    s, b, kk = values.shape
    vv = values.permute(1, 0, 2).reshape(b, s * kk)
    ii = indices.permute(1, 0, 2).reshape(b, s * kk)
    _, pos = torch.topk(_order_key(-vv if largest else vv, ii), k, dim=-1,
                        largest=False, sorted=True)
    return torch.gather(vv, -1, pos), torch.gather(ii, -1, pos)


def _sync_if_traced(x: torch.Tensor) -> None:
    """Under tracing, wait for the stage's device work so a span holds
    the stage's time, not its launch latency (the stages depend on each
    other anyway, so the wait costs overlap only across chunks)."""
    if tracer.enabled and x.is_cuda:
        torch.cuda.synchronize(x.device)


# ---------------------------------------------------------------------------
# Executable builder: (prepare, chunk_fn, row_update)
# ---------------------------------------------------------------------------


def _build_hier_executable(spec_h: HierarchicalSpec, coarse: SearchPlan,
                           packed: bool, mesh=None, device=None):
    """The hierarchical (prepare, chunk_fn, row_update) triple.

    ``prepare`` runs k-means on the gallery's device and the slot layout
    on the host (once per gallery, behind the pattern memo).
    ``chunk_fn`` runs the coarse plan's chunk function, then the fine
    probe, with no host synchronisation between the stages.
    ``row_update`` is the reassigning incremental relay described on
    :class:`HierState`.  ``mesh``: a sharded plan's devices (the fine
    tiles split over them, :func:`_hier_probe_sharded`).
    """
    fine = spec_h.fine
    tr = fine.tile_rows
    probe = _hier_probe(spec_h, packed) if mesh is None else \
        _hier_probe_sharded(spec_h, packed, mesh, device)

    def prepare(g):
        cent_src, assign = _kmeans(g, spec_h)
        cpp = coarse._prepared_patterns(cent_src)
        return _hier_state(spec_h, packed, g, cent_src, cpp, assign, mesh)

    def chunk_fn(q, hs):
        with trace_span("hier.coarse"):
            _, ci = coarse._chunk_fn(q, hs.coarse_prepared)
            _sync_if_traced(ci)
        with trace_span("hier.probe",
                        args=None if not tracer.enabled else
                        {"budget": hs.budget, "tpc": hs.tpc}):
            fine_leaf = hs.leaves[0] if mesh is None else \
                [lv[0] for lv in hs.leaves]
            out = probe(q, ci, fine_leaf, hs.row_ids, hs.cnt, hs.tpc,
                        hs.budget)
            _sync_if_traced(out[0])
            return out

    # -- incremental row update -------------------------------------------

    def relay(leaves, row_h, g, tiles, donate):
        """Re-lay the touched tiles from the (mutated) gallery through
        the *new* slot map (host ``row_h``) and write them into the
        prepared leaves (a sharded plan's: into each tile's owning
        shard) — the same encode/pack/layout a full prepare runs, on
        ``len(tiles)`` tiles."""
        nt = tiles.shape[0]
        lspec = replace(fine, n=nt * tr, grid_rows=nt)
        rid_t = torch.as_tensor(row_h[tiles], device=g.device)
        fresh = _lay_patterns(_gather_rows(g, rid_t, fine.n), None,
                              lspec, nt, packed)
        if mesh is not None:
            tps = leaves[0][0].shape[0]
            return _scatter_shards(leaves, fresh, tiles, tps, donate)
        return _scatter_leaves(leaves, fresh,
                               torch.as_tensor(tiles, device=g.device), donate)

    def row_update(hs, new_srcs, idx, donate=False):
        g_new = new_srcs[0]
        idxa = np.asarray(idx, np.int64)
        a_new = _assign_rows(
            g_new.index_select(0, torch.as_tensor(idxa, device=g_new.device)),
            hs.centroid_src, fine.metric)
        assign = hs.assign.copy()
        slot_of = hs.slot_of.copy()
        row_h = hs.row_ids_h.copy()
        flat = row_h.reshape(-1)
        cap = hs.tpc * tr
        touched = set((slot_of[idxa] // tr).tolist())
        moved_clusters = set()
        overflow = False
        for r, c_new in zip(idxa.tolist(), a_new.tolist()):
            c_old = int(assign[r])
            if c_new == c_old:
                continue                      # content change, same cluster
            s_old = int(slot_of[r])
            flat[s_old] = _SENT               # vacate the old slot
            seg = flat[c_new * cap:(c_new + 1) * cap]
            free = np.flatnonzero(seg == _SENT)
            if free.size == 0:
                overflow = True
                break
            s_new = c_new * cap + int(free[0])
            flat[s_new] = r
            slot_of[r] = s_new
            assign[r] = c_new
            touched.add(s_old // tr)
            touched.add(s_new // tr)
            moved_clusters.add(c_old)
            moved_clusters.add(c_new)
        if overflow:
            # the moved row's cluster is full: rebuild the whole layout
            # with the SAME centroids and a fresh uniform tpc.  Slot
            # placement is result-irrelevant (composite-order selection),
            # so this stays bit-identical to the incremental path.
            fresh_assign = hs.assign.copy()
            fresh_assign[idxa] = a_new
            return _hier_state(spec_h, packed, g_new, hs.centroid_src,
                               hs.coarse_prepared, fresh_assign, mesh)
        if mesh is not None:
            rid = _shard_rids(row_h, mesh, hs.row_ids[0].shape[0])
        else:
            rid_new = torch.as_tensor(row_h, device=g_new.device)
            rid = hs.row_ids.copy_(rid_new) if donate else rid_new
        tiles = np.asarray(sorted(touched), np.int64)
        leaves = relay(tuple(hs.leaves), row_h, g_new, tiles, donate)
        # occupancy maintenance: a moved row can extend its new
        # cluster's occupied prefix or (with holes filled later) let an
        # old one shrink — recompute the prefix for touched clusters
        # from the highest occupied slot, so probing [0, cnt) always
        # covers every live row
        cnt_h, cnt, budget = hs.cnt_h, hs.cnt, hs.budget
        if moved_clusters:
            cnt_h = cnt_h.copy()
            for c in moved_clusters:
                occ = np.flatnonzero(flat[c * cap:(c + 1) * cap] != _SENT)
                cnt_h[c] = 0 if occ.size == 0 else int(occ[-1]) // tr + 1
            cnt = torch.as_tensor(cnt_h, dtype=torch.int64,
                                  device=g_new.device)
            budget = _probe_budget(cnt_h, spec_h.nprobe, hs.tpc)
        return HierState(centroid_src=hs.centroid_src,
                         coarse_prepared=hs.coarse_prepared,
                         leaves=leaves, row_ids=rid, assign=assign,
                         slot_of=slot_of, row_ids_h=row_h, tpc=hs.tpc,
                         cnt=cnt, cnt_h=cnt_h, budget=budget)

    return prepare, chunk_fn, row_update


# ---------------------------------------------------------------------------
# The plan and its cached factory
# ---------------------------------------------------------------------------


@dataclass
class HierarchicalPlan(CompositePlan):
    """Two-stage coarse→fine search plan (see the module docstring).

    ``stages[0]`` is the coarse centroid :class:`~.plans.SearchPlan`.
    The public surface matches :class:`~.plans.SearchPlan` — same
    ``execute`` / ``dispatch`` / ``finalize`` / ``update_rows``
    signatures, same ``(values, indices)`` results on the plan's device —
    so the serving and hardening layers treat it as just another plan.
    """

    family: str = field(default="hierarchical", repr=False)

    @property
    def coarse(self) -> SearchPlan:
        return self.stages[0]

    def _stored_sources(self, inputs) -> Tuple:
        return (inputs[self.spec.pattern_arg],)

    def finalize(self, pending):
        """Search-shaped finalize with the hierarchical shard merge
        (composite-key selection instead of the shard-order value sort)."""
        with trace_span("plan.finalize"):
            return _finalize_topk(self, pending, merge=_merge_hier_shards)

    def update_rows(self, gallery, indices, new_rows, care=None, *,
                    donate: bool = False):
        """Row-granular gallery mutation with cluster reassignment.

        Same contract as :meth:`~.plans.SearchPlan.update_rows` (returns
        the mutated gallery; incremental memo rewrite when the old layout
        is memoised; ``donate=True`` writes the gallery and the prepared
        leaves in place), plus the hierarchical semantics documented on
        the module: each touched row is re-assigned to its nearest
        *stored* centroid, moving between cluster tile groups when
        needed — bit-identical to a full re-layout with the same
        centroids.
        """
        if care is not None:
            raise ValueError("hierarchical plans have no care operand")
        idx = _index_array(indices)
        self._validate_update(idx, new_rows)
        return self._mutate_stored((gallery,), (new_rows,), idx, donate)[0]


def _default_clusters(fine: SimilaritySpec) -> int:
    """``~sqrt(n)`` centroids (the classic IVF balance point), never
    more than the number of row tiles (a cluster below one tile of rows
    wastes probe steps) and never more than n."""
    est = max(2, int(round(math.sqrt(fine.n))))
    est = min(est, max(1, fine.n // fine.tile_rows))
    return max(1, min(est, fine.n))


def _coarse_spec(spec_h: HierarchicalSpec) -> SimilaritySpec:
    """The coarse stage's spec: top-``nprobe`` centroids under the fine
    metric *and polarity* (a largest=True fine search wants the
    farthest clusters), same column geometry as the fine spec."""
    fine = spec_h.fine
    c = spec_h.clusters
    tr = min(fine.tile_rows, c)
    return SimilaritySpec(
        metric=fine.metric, k=spec_h.nprobe, largest=fine.largest,
        tile_rows=tr, dims_per_tile=fine.dims_per_tile,
        grid_rows=-(-c // tr), grid_cols=fine.grid_cols,
        m=fine.m, n=c, dim=fine.dim, query_arg=0, pattern_arg=1,
        out_v_shape=(fine.m, spec_h.nprobe),
        out_i_shape=(fine.m, spec_h.nprobe))


def get_hierarchical_plan(program, *, clusters: Optional[int] = None,
                          nprobe: Optional[int] = None,
                          backend: str = "torch",
                          batch: Optional[int] = None,
                          shards: Optional[int] = None,
                          pack: Optional[bool] = None,
                          kmeans_iters: int = 8,
                          seed: int = 0,
                          device=None) -> Optional[HierarchicalPlan]:
    """Hierarchical plan for a similarity program, from the shared cache.

    ``program`` is a partitioned similarity :class:`~..ir.Module`, its
    :class:`~.spec.SimilaritySpec`, or an existing
    :class:`HierarchicalSpec` (whose clustering fields serve as the
    defaults).  Returns ``None`` for modules that are not pure
    similarity programs, mirroring ``get_plan``.

    ``clusters`` defaults to ``~sqrt(n)`` (capped at the row-tile
    count); ``nprobe`` defaults to ``REPRO_HIER_NPROBE`` when set, else
    ``clusters // 8``.  Both clamp into valid range (``nprobe <=
    clusters <= n``).  The coarse centroid plan is itself a cached
    :class:`~.plans.SearchPlan` on the same device; the hierarchical
    plan is one entry in the same process-wide cache, keyed by its
    frozen :class:`~.composite.HierarchicalSpec` (clustering parameters
    included) and the device.  ``device``: as for ``get_plan`` (``None``
    is the current CUDA device and raises without CUDA).

    ``shards > 1`` splits the fine tiles over
    :func:`~repro_torch.launch.mesh.make_data_mesh`'s devices, clamped
    as :func:`~.cache.get_plan` clamps (the clamped count joins the key).

    Restrictions: the ``"torch"`` backend only (the probing stage is a
    gather-heavy scan with no fused kernel yet) and no ternary programs.
    """
    if isinstance(program, HierarchicalSpec):
        fine = program.fine
        clusters = program.clusters if clusters is None else clusters
        nprobe = program.nprobe if nprobe is None else nprobe
        kmeans_iters = program.kmeans_iters
        seed = program.seed
    elif isinstance(program, SimilaritySpec):
        fine = program
    else:
        try:
            fine = extract_plan_spec(program)
        except Exception:       # malformed/exotic IR: no engine plan
            fine = None
        if fine is None:
            return None
    if backend != "torch":
        raise ValueError(
            f"hierarchical plans require the 'torch' backend (the probing "
            f"stage is a gather-heavy scan with no fused kernel yet), got "
            f"{backend!r}")
    if fine.care_arg is not None:
        raise ValueError("hierarchical search does not support ternary "
                         "(care-masked) programs")
    _check_shard_backend(shards, backend)
    if clusters is None:
        clusters = _default_clusters(fine)
    clusters = max(1, min(int(clusters), fine.n))
    if nprobe is None:
        nprobe = env_int("REPRO_HIER_NPROBE", 0, min_value=0) or \
            max(1, clusters // 8)
    nprobe = max(1, min(int(nprobe), clusters))
    spec_h = HierarchicalSpec(fine=fine, clusters=clusters, nprobe=nprobe,
                              kmeans_iters=int(kmeans_iters), seed=int(seed))
    packed = _resolve_pack(fine, pack)
    dev = resolve_device(device)
    s = _normalize_shards(shards, dev)
    b = batch or _pick_batch(fine.m)
    key = (spec_h, backend, b, s, packed, str(dev))

    def build():
        coarse = get_plan(module_for_spec(_coarse_spec(spec_h)),
                          backend="torch", batch=b, pack=packed, device=dev)
        prepare, chunk_fn, row_update = _build_hier_executable(
            spec_h, coarse, packed,
            make_data_mesh(s, dev) if s > 1 else None, dev)
        return HierarchicalPlan(
            spec=spec_h, backend=backend, batch=b, device=dev, shards=s,
            packed=packed, _prepare=prepare, _chunk_fn=chunk_fn,
            _row_update=row_update, stages=(coarse,))

    return _lookup_or_insert(key, build)
