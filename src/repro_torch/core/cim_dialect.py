"""The extended ``cim`` abstraction (paper §III-D1).

The programming model (from CINM [16]) is three functions:

* ``cim.acquire  -> !cim.device``  — allocate an accelerator, returns handle
* ``cim.execute (handle) { region } -> results`` — ops to run on the device
* ``cim.release (handle)``

C4CAM extends ``cim`` with the analyses/ops needed for CAM devices:

* compute ops mirroring torch (``cim.matmul`` etc.) inside execute regions,
* the fused ``cim.similarity`` op produced by Algorithm 1,
* partitioning ops: ``cim.search_tile`` (per-subarray distance block),
  ``cim.topk_tile`` and ``cim.merge_partial`` (horizontal = accumulate
  partial distances across column tiles, vertical = tournament-merge
  candidate lists across row tiles) — Fig. 5d.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .arch import Metric
from .ir import Block, Builder, IRError, Module, Operation, Region, TensorType, Value

__all__ = [
    "DEVICE_TYPE", "make_acquire", "make_execute", "make_release",
    "make_yield", "make_similarity", "make_range_search", "execute_blocks",
    "CIM_COMPUTE_OPS",
]

#: pseudo-type for device handles (shape (), dtype tag)
DEVICE_TYPE = TensorType((), "!cim.device")

#: torch op -> cim op name (ops the accelerator abstraction understands)
CIM_COMPUTE_OPS: Dict[str, str] = {
    "torch.transpose": "cim.transpose",
    "torch.matmul": "cim.matmul",
    "torch.mm": "cim.matmul",
    "torch.sub": "cim.sub",
    "torch.add": "cim.add",
    "torch.mul": "cim.mul",
    "torch.div": "cim.div",
    "torch.norm": "cim.norm",
    "torch.topk": "cim.topk",
    "torch.neg": "cim.neg",
    "torch.abs": "cim.abs",
    "torch.unsqueeze": "cim.unsqueeze",
    "torch.squeeze": "cim.squeeze",
}

#: pure shape-metadata ops — transparent to Algorithm 1's opSize gate
SHAPE_OPS = {"cim.unsqueeze", "cim.squeeze"}


def make_acquire(builder: Builder) -> Operation:
    return builder.create("cim.acquire", [], [DEVICE_TYPE])


def make_release(builder: Builder, handle: Value) -> Operation:
    return builder.create("cim.release", [handle])


def make_yield(block: Block, values: Sequence[Value]) -> Operation:
    op = Operation("cim.yield", values)
    block.append(op)
    return op


def make_execute(builder: Builder, handle: Value, operands: Sequence[Value],
                 result_types: Sequence[TensorType]) -> Operation:
    """Creates ``cim.execute`` with an empty single-block region.

    The region's ops reference outer SSA values directly (MLIR
    ``isolated_from_above = false`` semantics).
    """
    region = Region([Block()])
    return builder.create("cim.execute", [handle, *operands], result_types,
                          regions=[region])


def make_similarity(block: Block, queries: Value, patterns: Value, *,
                    metric: str, k: int, largest: bool,
                    care: Optional[Value] = None,
                    extra_attrs: Optional[Dict[str, Any]] = None) -> Operation:
    """``cim.similarity``: fused distance + top-k (paper Fig. 5c).

    queries ``(M, D)``, patterns ``(N, D)`` -> values/indices ``(M, k)``.

    ``care`` (TCAM ternary search, hamming only): a per-pattern
    ``(N, D)`` wildcard mask as a third operand — non-zero cells are
    compared, zero cells are "don't care" and never mismatch.  This is
    the TCAM cell's third state surfaced at the ``cim`` level; the
    search-plan engine lowers it to a bit-packed
    ``popcount((q ^ p) & care)`` match.
    """
    m = queries.type.shape[0] if queries.type.rank == 2 else 1
    attrs = {"metric": Metric.validate(metric), "k": k, "largest": largest}
    if care is not None:
        if metric != "hamming":
            raise IRError("care masks (ternary TCAM search) require "
                          f"metric='hamming', got {metric!r}")
        attrs["ternary"] = True
    if extra_attrs:
        attrs.update(extra_attrs)
    operands = [queries, patterns] if care is None else \
        [queries, patterns, care]
    op = Operation("cim.similarity", operands,
                   [TensorType((m, k), queries.type.dtype),
                    TensorType((m, k), "i32")], attrs)
    block.append(op)
    return op


def make_range_search(block: Block, queries: Value, *,
                      patterns: Optional[Value] = None,
                      lo: Optional[Value] = None, hi: Optional[Value] = None,
                      metric: Optional[str] = None,
                      threshold: Optional[float] = None, below: bool = True,
                      extra_attrs: Optional[Dict[str, Any]] = None
                      ) -> Operation:
    """``cim.range_search``: boolean match search (paper §II ``TH`` mode).

    Two forms, both returning one ``(M, N)`` ``i1`` match matrix:

    * **threshold** — ``patterns`` + ``metric`` + ``threshold``: row
      ``j`` matches query ``i`` iff its distance/similarity is at/below
      the threshold (``below=True``, the TH discharge contract of
      :func:`repro.kernels.ref.cam_range` in the reference package) or at/above it
      (``below=False`` — "at least this similar" for dot/cos).
    * **interval** (analog CAM) — ``lo`` + ``hi``, each ``(N, D)``: row
      ``j`` matches iff ``lo[j, d] <= q[i, d] <= hi[j, d]`` for every
      dimension; a wildcard dimension stores the full-range interval.
      This is the aCAM cell contract
      (:func:`repro.kernels.ref.acam_match` in the reference package) that maps decision-forest
      branches onto CAM rows.
    """
    m = queries.type.shape[0] if queries.type.rank == 2 else 1
    attrs: Dict[str, Any] = {}
    if lo is not None or hi is not None:
        if lo is None or hi is None or patterns is not None or \
                metric is not None or threshold is not None:
            raise IRError("interval range search takes exactly lo + hi "
                          "(no patterns/metric/threshold)")
        if lo.type.shape != hi.type.shape:
            raise IRError(f"lo/hi shape mismatch: {lo.type.shape} vs "
                          f"{hi.type.shape}")
        n = lo.type.shape[-2]
        attrs.update(mode="interval")
        operands = [queries, lo, hi]
    else:
        if patterns is None or metric is None or threshold is None:
            raise IRError("threshold range search needs patterns + metric "
                          "+ threshold")
        n = patterns.type.shape[-2]
        attrs.update(mode="threshold", metric=Metric.validate(metric),
                     threshold=float(threshold), below=bool(below))
        operands = [queries, patterns]
    if extra_attrs:
        attrs.update(extra_attrs)
    op = Operation("cim.range_search", operands,
                   [TensorType((m, n), "i1")], attrs)
    block.append(op)
    return op


def execute_blocks(module: Module) -> List[Operation]:
    """All ``cim.execute`` ops in program order."""
    return [op for op in module.body.operations if op.name == "cim.execute"]
