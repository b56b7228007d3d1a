"""The leaf plan families: :class:`SearchPlan` (top-k) and
:class:`RangePlan` (boolean range match).

Thin subclasses of :class:`~.base.PlanBase` that define which module
arguments are stored operands, the shape of a chunk record, and how
chunks finalize into the module's output.  Sharded plans (and their
cross-shard merge) and gallery mutation come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from ...obs.trace import trace_span
from .base import PendingSearch, PlanBase, _size

__all__ = ["SearchPlan", "RangePlan"]


@dataclass
class SearchPlan(PlanBase):
    """A compiled, reusable executable for one similarity-program shape.

    Chunks hold ``(values, indices, valid_rows)``; finalize slices ragged
    tails and shapes ``(values, indices)`` for the compiled module:
    float32 values and int32 indices on the plan's device.
    """

    family: str = field(default="search", repr=False)

    def _stored_sources(self, inputs) -> Tuple:
        spec = self.spec
        if spec.care_arg is None:
            return (inputs[spec.pattern_arg],)
        return (inputs[spec.pattern_arg], inputs[spec.care_arg])

    def _chunk_entry(self, out, valid: int):
        v, i = out
        return (v, i, valid)

    def finalize(self, pending: "PendingSearch"):
        """Materialise a dispatched search: ragged-tail slicing, chunk
        concatenation, output shaping."""
        with trace_span("plan.finalize"):
            return self._finalize(pending)

    def _finalize(self, pending: "PendingSearch"):
        spec = self.spec
        vs = [v[:valid] for v, _, valid in pending.chunks]
        is_ = [i[:valid] for _, i, valid in pending.chunks]
        if not vs:      # zero queries: well-shaped empty result
            vs = [torch.zeros((0, spec.k), dtype=torch.float32,
                              device=self.device)]
            is_ = [torch.zeros((0, spec.k), dtype=torch.int32,
                               device=self.device)]
        v = vs[0] if len(vs) == 1 else torch.cat(vs, dim=0)
        i = is_[0] if len(is_) == 1 else torch.cat(is_, dim=0)

        m, lead, k = pending.m, pending.lead, spec.k
        if m * k == _size(spec.out_v_shape):
            return v.reshape(spec.out_v_shape), i.reshape(spec.out_i_shape)
        # runtime M differs from the traced shape: mirror _as_2d
        return v.reshape(lead + (k,)), i.reshape(lead + (k,))


@dataclass
class RangePlan(PlanBase):
    """A compiled, reusable executable for one range-search program.

    Same plan-cache citizenship, micro-batching, pattern memoisation and
    packing as :class:`SearchPlan`; the result is one ``(M, N)``
    ``torch.bool`` match matrix on the plan's device.  ``spec`` is a
    :class:`~.spec.RangeSpec`; chunks hold ``(match, valid_rows)``.
    """

    family: str = field(default="range", repr=False)

    def _stored_sources(self, inputs) -> Tuple:
        return tuple(inputs[i] for i in self.spec.pattern_args)

    def _chunk_entry(self, out, valid: int):
        return (out, valid)

    def finalize(self, pending: "PendingSearch"):
        """Materialise a dispatched range search into the boolean match
        matrix: drop padded rows and chunks, shape for the module."""
        with trace_span("plan.finalize"):
            return self._finalize(pending)

    def _finalize(self, pending: "PendingSearch"):
        spec = self.spec
        outs = [hit[:valid, :spec.n] for hit, valid in pending.chunks]
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
        """Row-granular mutation of the stored operands: not ported yet."""
        raise NotImplementedError(
            "RangePlan.update_rows (gallery mutation) is not ported to "
            "repro_torch yet; prepare a new gallery instead")
