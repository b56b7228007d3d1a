"""The leaf plan family of this slice: :class:`SearchPlan` (top-k).

A thin subclass of :class:`~.base.PlanBase` that defines which module
arguments are stored operands, the shape of a chunk record, and how
chunks finalize into the module's output.  Sharded plans (and their
cross-shard merge) come with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from ...obs.trace import trace_span
from .base import PendingSearch, PlanBase, _size

__all__ = ["SearchPlan"]


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
