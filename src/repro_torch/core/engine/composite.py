"""The plan-graph layer: plans composed from other plans.

The leaf families execute one program shape each.  A *composite* plan
wires several plans into a graph — one stage's outputs become the next
stage's inputs — while remaining a first-class plan itself: same frozen
spec key in the shared plan cache, same micro-batched dispatch /
finalize lifecycle, same pattern-memo, fault and ``update_rows``
machinery inherited from :class:`~.base.PlanBase`.

Two things live here:

* :class:`HierarchicalSpec` — the frozen spec of a two-stage
  coarse→fine search (the CAM analogue of an IVF index): a coarse
  :class:`~.plans.SearchPlan` over cluster centroids selects the
  ``nprobe`` most promising clusters per query, and a fine probing
  stage searches only those clusters' row tiles.  The spec *wraps* the
  fine :class:`~.spec.SimilaritySpec` — its flat equivalent — so cache
  keys can never collide with a flat similarity (different type) and
  :func:`~.spec.module_for_spec` can synthesise the exact search the
  composite approximates (``flat_spec``).

* :class:`CompositePlan` — the dataclass base for plans built from
  other plans: a ``stages`` tuple of member plans plus aggregated
  telemetry.  The concrete two-stage search is
  :class:`~.hier.HierarchicalPlan`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ...obs.trace import trace_span
from .base import PlanBase
from .plans import _finalize_topk
from .spec import SimilaritySpec

__all__ = ["CompositePlan", "HierarchicalSpec"]


@dataclass(frozen=True)
class HierarchicalSpec:
    """Structural summary of a two-stage hierarchical similarity search.

    ``fine`` is the flat :class:`~.spec.SimilaritySpec` this search
    approximates — same metric, k, polarity, tile geometry and operand
    wiring; the composite merely restricts *which* row tiles are
    searched per query.  The clustering parameters are part of the
    frozen spec (and therefore of the plan-cache key): two hierarchical
    plans with different ``clusters`` / ``nprobe`` / ``seed`` are
    different executables with different result contracts.

    With ``nprobe == clusters`` every tile is probed and the result is
    bit-identical to the flat plan's (the probing stage selects by the
    same (physical value, global row id) order the flat tournament
    resolves ties by); smaller ``nprobe`` trades recall for probing
    ~``nprobe / clusters`` of the gallery.
    """

    fine: SimilaritySpec
    clusters: int
    nprobe: int
    #: Lloyd iterations of the seeded k-means that places the centroids
    kmeans_iters: int = 8
    seed: int = 0

    # -- delegation: a HierarchicalSpec answers every structural question
    # its flat equivalent answers, so PlanBase machinery (dispatch
    # wiring, update validation, fault models) works unchanged ---------

    @property
    def flat_spec(self) -> SimilaritySpec:
        """The exact flat search this composite approximates (read by
        ``module_for_spec`` and the serving fallback chain)."""
        return self.fine

    @property
    def metric(self) -> str:
        return self.fine.metric

    @property
    def k(self) -> int:
        return self.fine.k

    @property
    def largest(self) -> bool:
        return self.fine.largest

    @property
    def tile_rows(self) -> int:
        return self.fine.tile_rows

    @property
    def dims_per_tile(self) -> int:
        return self.fine.dims_per_tile

    @property
    def grid_rows(self) -> int:
        return self.fine.grid_rows

    @property
    def grid_cols(self) -> int:
        return self.fine.grid_cols

    @property
    def m(self) -> int:
        return self.fine.m

    @property
    def n(self) -> int:
        return self.fine.n

    @property
    def dim(self) -> int:
        return self.fine.dim

    @property
    def query_arg(self) -> int:
        return self.fine.query_arg

    @property
    def pattern_arg(self) -> int:
        return self.fine.pattern_arg

    @property
    def care_arg(self) -> Optional[int]:
        return self.fine.care_arg

    @property
    def in_dtypes(self) -> Tuple[str, ...]:
        return self.fine.in_dtypes

    @property
    def out_v_shape(self) -> Tuple[int, ...]:
        return self.fine.out_v_shape

    @property
    def out_i_shape(self) -> Tuple[int, ...]:
        return self.fine.out_i_shape


@dataclass
class CompositePlan(PlanBase):
    """Base of plans whose executable is built from other plans.

    ``stages`` holds the member plans in execution order (for the
    hierarchical family: the coarse centroid :class:`~.plans.SearchPlan`).
    Member plans are ordinary cached plans with their own telemetry and
    pattern memos; the composite's ``_chunk_fn`` calls their chunk
    functions directly, so one dispatch drives the whole graph with no
    host round trip between stages.  Chunks are search-shaped
    ``(values, indices)``, finalized like a :class:`~.plans.SearchPlan`'s.

    The composite is itself one entry in the shared plan cache (its
    frozen spec is the key): ``get_hierarchical_plan`` returns the same
    object for the same (spec, backend, batch, shards, packed, device),
    exactly like ``get_plan``.
    """

    stages: Tuple[PlanBase, ...] = ()
    family: str = field(default="composite", repr=False)

    def finalize(self, pending):
        with trace_span("plan.finalize"):
            return _finalize_topk(self, pending)

    def graph_stats(self) -> Dict[str, object]:
        """Aggregated telemetry: the composite's own counters plus each
        member stage's, keyed ``stage<idx>:<family>``.  Stage counters
        reflect the member plan's *own* dispatches (a stage driven
        through the composite's ``_chunk_fn`` executes without bumping
        the member's counters — the work is accounted to the
        composite)."""
        with self._stats_lock:
            out: Dict[str, object] = {
                "family": self.family,
                "executions": self.executions,
                "chunks_run": self.chunks_run,
                "row_updates": self.row_updates,
            }
        for idx, st in enumerate(self.stages):
            with st._stats_lock:
                out[f"stage{idx}:{st.family}"] = {
                    "executions": st.executions,
                    "chunks_run": st.chunks_run,
                }
        return out
