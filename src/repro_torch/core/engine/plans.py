"""The leaf plan families: :class:`SearchPlan` (top-k) and
:class:`RangePlan` (boolean range match).

Thin subclasses of :class:`~.base.PlanBase` that define which module
arguments are stored operands, the shape of a chunk record, how chunks
finalize into the module's output (a sharded plan merges its shards'
candidates, or concatenates their match blocks, first), and the public
``update_rows`` signature (the incremental-update relay is inherited).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from ...obs.trace import trace_span
from .base import PendingSearch, PlanBase, _index_array, _size
from .executables import merge_shard_candidates

__all__ = ["SearchPlan", "RangePlan"]


def _finalize_topk(plan: PlanBase, pending: "PendingSearch",
                   merge=merge_shard_candidates):
    """Top-k chunks ``(values, indices)`` -> the module's outputs: the
    cross-shard ``merge`` of a sharded plan's ``(shards, batch, k)``
    chunks, chunk concatenation and output shaping (shared with the
    composite plans, whose chunks are search-shaped too)."""
    spec = plan.spec
    chunks = pending.chunks
    if plan.shards > 1:
        chunks = [merge(v, i, k=spec.k, largest=spec.largest)
                  for v, i in chunks]
    vs = [v for v, _ in chunks]
    is_ = [i for _, i in chunks]
    if not vs:      # zero queries: well-shaped empty result
        vs = [torch.zeros((0, spec.k), dtype=torch.float32,
                          device=plan.device)]
        is_ = [torch.zeros((0, spec.k), dtype=torch.int32,
                           device=plan.device)]
    v = vs[0] if len(vs) == 1 else torch.cat(vs, dim=0)
    i = is_[0] if len(is_) == 1 else torch.cat(is_, dim=0)

    m, lead, k = pending.m, pending.lead, spec.k
    if m * k == _size(spec.out_v_shape):
        return v.reshape(spec.out_v_shape), i.reshape(spec.out_i_shape)
    # runtime M differs from the traced shape: mirror _as_2d
    return v.reshape(lead + (k,)), i.reshape(lead + (k,))


@dataclass
class SearchPlan(PlanBase):
    """A compiled, reusable executable for one similarity-program shape.

    Chunks hold ``(values, indices)`` (per shard, ``(shards, batch, k)``,
    for a sharded plan); finalize merges shards, concatenates chunks and
    shapes them for the compiled module: float32 values and int32 indices
    on the plan's device.
    """

    family: str = field(default="search", repr=False)

    def _stored_sources(self, inputs) -> Tuple:
        spec = self.spec
        if spec.care_arg is None:
            return (inputs[spec.pattern_arg],)
        return (inputs[spec.pattern_arg], inputs[spec.care_arg])

    def finalize(self, pending: "PendingSearch"):
        """Materialise a dispatched search: cross-shard merge (sharded
        plans), chunk concatenation, output shaping."""
        with trace_span("plan.finalize"):
            return _finalize_topk(self, pending)

    def update_rows(self, gallery, indices, new_rows, care=None, *,
                    donate: bool = False):
        """Row-granular gallery mutation with incremental re-preparation.

        Returns the updated gallery (a tensor) whose prepared layout was
        derived from ``gallery``'s memoised layout by re-laying only the
        rows (``"cuda"``) or row tiles (``"torch"``) that ``indices``
        touch; results are bit-identical to a full prepare of the mutated
        gallery.

        ``donate=False`` returns a new tensor and writes fresh prepared
        leaves: ``gallery`` and its memo entry stay as they were, so a
        caller still holding the old gallery gets its old results.
        ``donate=True`` writes the rows into ``gallery`` in place
        (``index_copy_``), rewrites its prepared leaves in place, and
        returns ``gallery``.

        ``care`` must be the plan's care mask for ternary programs (the
        memo keys on the (gallery, care) pair; the mask itself does not
        change).  If ``gallery``'s layout is not memoised (a numpy
        gallery, never dispatched, or evicted) or ``REPRO_ENGINE_UPDATE``
        is off, the mutation still happens, ``row_update_fallbacks``
        counts it, and the next dispatch prepares in full.
        """
        spec = self.spec
        if (care is None) != (spec.care_arg is None):
            raise ValueError("care mask must be passed iff the plan's "
                             "program is ternary")
        idx = _index_array(indices)
        self._validate_update(idx, new_rows)
        olds = (gallery,) if care is None else (gallery, care)
        # only the gallery rows mutate; a ternary care mask passes through
        return self._mutate_stored(olds, (new_rows,), idx, donate)[0]


@dataclass
class RangePlan(PlanBase):
    """A compiled, reusable executable for one range-search program.

    Same plan-cache citizenship, micro-batching, pattern memoisation and
    packing as :class:`SearchPlan`; the result is one ``(M, N)``
    ``torch.bool`` match matrix on the plan's device.  ``spec`` is a
    :class:`~.spec.RangeSpec`; chunks hold the match blocks.
    """

    family: str = field(default="range", repr=False)

    def _stored_sources(self, inputs) -> Tuple:
        return tuple(inputs[i] for i in self.spec.pattern_args)

    def finalize(self, pending: "PendingSearch"):
        """Materialise a dispatched range search into the boolean match
        matrix: concatenate per-shard blocks (shard order is ascending
        global row order: no tournament), drop the padded gallery rows,
        shape for the module."""
        with trace_span("plan.finalize"):
            return self._finalize(pending)

    def _finalize(self, pending: "PendingSearch"):
        spec = self.spec
        outs = []
        for hit in pending.chunks:
            if self.shards > 1:                       # (S, B, cols)
                hit = hit.permute(1, 0, 2).reshape(hit.shape[1], -1)
            outs.append(hit[:, :spec.n])
        if not outs:    # zero queries: well-shaped empty result
            outs = [torch.zeros((0, spec.n), dtype=torch.bool,
                                device=self.device)]
        match = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        m, lead = pending.m, pending.lead
        if m * spec.n == _size(spec.out_shape):
            return match.reshape(spec.out_shape)
        return match.reshape(lead + (spec.n,))

    def update_rows(self, stored, indices, new_rows, care=None, *,
                    donate: bool = False):
        """Row-granular mutation of a range plan's stored operands.

        ``stored`` is the current stored content — the pattern tensor for
        threshold mode, the ``(lo, hi)`` pair for interval mode — and
        ``new_rows`` matches that structure with ``(len(indices), dim)``
        row blocks.  Returns the updated operand(s) in the same structure,
        memo-seeded incrementally exactly like
        :meth:`SearchPlan.update_rows` (including the ``donate``
        contract).
        """
        if care is not None:
            raise ValueError("range plans have no care operand")
        spec = self.spec
        multi = len(spec.pattern_args) == 2
        olds = tuple(stored) if multi else (stored,)
        news = tuple(new_rows) if multi else (new_rows,)
        if len(olds) != len(spec.pattern_args) or len(news) != len(olds):
            raise ValueError(
                f"expected {len(spec.pattern_args)} stored operand(s) "
                f"and matching new-row block(s)")
        idx = _index_array(indices)
        self._validate_update(idx, *news)
        upd = self._mutate_stored(olds, news, idx, donate)
        return upd if multi else upd[0]
