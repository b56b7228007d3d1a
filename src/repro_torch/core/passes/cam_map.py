"""``cam-map``: hierarchy mapping (paper §III-D2, Fig. 6) + MappingPlan.

Transforms the flat cam IR into the nested ``scf.parallel`` loop structure
over (banks, mats, arrays, subarrays), allocating devices and partial-result
buffers at each loop level and inserting the merge calls.  If the data
exceeds the system capacity an additional sequential *round* loop over bank
re-fills is introduced (paper: "an additional loop is introduced").

Alongside the IR this pass derives a :class:`MappingPlan` — the closed-form
summary (tile grid, stacking factor, physical subarray count, cycle counts
per optimization mode) that the cost model (`repro_torch.camsim`) and the
vectorized functional executor consume.  IR and plan come from the same
analysis, so they cannot drift apart.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, asdict
from typing import Any, Dict, List, Optional

from ..arch import AccessMode, ArchSpec
from ..ir import Builder, Module, Operation, Pass, Region, Block, TensorType


@dataclass
class MappingPlan:
    """Everything the cost model needs to know about one mapped search kernel."""

    arch: ArchSpec
    # workload
    m_queries: int
    n_rows: int
    dim: int
    value_bits: int
    metric: str
    k: int
    largest: bool
    # tiling (from compulsory partitioning)
    grid_rows: int
    grid_cols: int
    dims_per_tile: int
    cells_per_value: int
    # mapping
    #: sensing mode — "best" (top-k / WTA periphery) or "range" (every
    #: row's match line is read out: aCAM interval search and the TH
    #: threshold mode).  Informs the camsim sensing-cost selection.
    search_type: str = "best"
    stack: int = 1                   # selective-search batches per subarray
    logical_tiles: int = 0
    physical_subarrays: int = 0
    banks_used: int = 0
    rounds: int = 1                  # sequential bank re-fills if capacity-bound
    search_cycles: int = 0           # total sequential search cycles (per round)
    active_subarrays_per_cycle: float = 0.0
    rows_active_per_search: int = 0
    writes: int = 0                  # subarray write operations
    searches: int = 0                # total subarray-search events (energy)
    merges_horizontal: int = 0
    merges_vertical: int = 0

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["arch"] = {k: v for k, v in asdict(self.arch).items()}
        return d


def derive_plan(arch: ArchSpec, part: Dict[str, Any]) -> MappingPlan:
    """Closed-form mapping derivation from a partition_info record."""
    m = int(part["m"]); n = int(part["n"]); dim = int(part["dim"])
    grid_rows, grid_cols = int(part["grid_rows"]), int(part["grid_cols"])
    logical = grid_rows * grid_cols
    rows_used = min(n, arch.rows)          # data rows per row-batch
    stack = 1
    if arch.selective_search and arch.supports_selective:
        stack = max(1, arch.rows // max(1, rows_used))
        stack = min(stack, logical)        # cannot stack more tiles than exist
    physical = math.ceil(logical / stack)
    per_bank = arch.subarrays_per_bank
    banks_needed = max(1, math.ceil(physical / per_bank))
    if arch.banks and banks_needed > arch.banks:
        rounds = math.ceil(banks_needed / arch.banks)
        banks_used = arch.banks
    else:
        rounds = 1
        banks_used = banks_needed

    # --- cycle accounting (latency model input) -------------------------
    # All queries are searched sequentially; within one query:
    #   * levels with parallel access contribute factor 1,
    #   * sequential levels contribute their occupied count,
    #   * cam-power (max_active_subarrays=1) serializes the subarrays of an
    #     array; latency is set by the most-occupied array,
    #   * selective search serializes the stacked batches.
    arrays_used = max(1, math.ceil(physical / arch.subarrays_per_array))
    subs_in_fullest_array = min(arch.subarrays_per_array,
                                physical if arrays_used == 1
                                else math.ceil(physical / arrays_used))
    sub_factor = 1
    if arch.max_active_subarrays == 1 or arch.access["subarray"] == AccessMode.SEQUENTIAL:
        sub_factor = subs_in_fullest_array
    elif arch.max_active_subarrays > 1:
        sub_factor = math.ceil(subs_in_fullest_array / arch.max_active_subarrays)
    lvl_factor = 1
    mats_used = max(1, math.ceil(arrays_used / arch.arrays_per_mat))
    if arch.access["array"] == AccessMode.SEQUENTIAL:
        lvl_factor *= min(arch.arrays_per_mat, arrays_used)
    if arch.access["mat"] == AccessMode.SEQUENTIAL:
        lvl_factor *= min(arch.mats_per_bank, mats_used)
    if arch.access["bank"] == AccessMode.SEQUENTIAL:
        lvl_factor *= banks_used

    search_cycles = m * stack * sub_factor * lvl_factor
    searches = m * logical                       # energy events: every logical tile
    active = searches / max(1, search_cycles)

    return MappingPlan(
        arch=arch, m_queries=m, n_rows=n, dim=dim,
        value_bits=int(part["value_bits"]), metric=part["metric"],
        k=int(part["k"]), largest=bool(part["largest"]),
        search_type=str(part.get("search_type", "best")),
        grid_rows=grid_rows, grid_cols=grid_cols,
        dims_per_tile=int(part["dims_per_tile"]),
        cells_per_value=int(part["cells_per_value"]),
        stack=stack, logical_tiles=logical, physical_subarrays=physical,
        banks_used=banks_used, rounds=rounds, search_cycles=search_cycles,
        active_subarrays_per_cycle=active,
        rows_active_per_search=rows_used,
        writes=physical * rounds,
        searches=searches,
        merges_horizontal=m * grid_rows * max(0, grid_cols - 1),
        merges_vertical=m * max(0, grid_rows - 1),
    )


class CamMap(Pass):
    name = "cam-map"

    def run(self, module: Module, ctx: Dict[str, Any]) -> Module:
        arch: ArchSpec = ctx["arch"]
        plans: List[MappingPlan] = [derive_plan(arch, part)
                                    for part in ctx.get("partition_info", [])]
        ctx["plans"] = plans
        if plans:
            module.attributes["mapping_plans"] = [p.to_dict() for p in plans]

        # Rewrite the flat alloc + tiled/unrolled search section into the
        # Fig.-6 loop-nest form.  We wrap each contiguous cam section into
        # scf.parallel ops with symbolic bounds; per-tile ops stay in the
        # innermost body (one representative body — the loop carries the
        # iteration semantics, as in MLIR, rather than unrolling).
        if not plans:
            return module
        plan = plans[0]
        new = Module(module.name, [a.type for a in module.arguments])
        vmap: Dict[Any, Any] = {}
        for old_a, new_a in zip(module.arguments, new.arguments):
            new_a.name = old_a.name
            vmap[old_a] = new_a
        b = Builder(new.body)

        cam_ops = [op for op in module.ops()
                   if op.dialect in ("cam",) or op.name.startswith("cim.")]
        other = [op for op in module.ops() if op not in cam_ops]

        def loop(level: str, bound: int, mode: str, body_fn) -> Operation:
            blk = Block()
            body_fn(Builder(blk))
            return b.create(
                "scf.parallel" if mode == AccessMode.PARALLEL else "scf.for",
                [], [], {"level": level, "lb": 0, "ub": bound, "step": 1,
                         "mode": mode},
                regions=[Region([blk])])

        a = plan.arch
        sub_mode = (AccessMode.SEQUENTIAL if a.max_active_subarrays == 1
                    else a.access["subarray"])

        def subarray_body(bb: Builder):
            s = bb.create("cam.alloc_subarray", [], [TensorType((), "!cam.subarray_id")])
            attrs = {"metric": plan.metric, "k": plan.k, "largest": plan.largest,
                     "value_bits": plan.value_bits, "stack": plan.stack,
                     "rows_active": plan.rows_active_per_search}
            def batch_body(bbb: Builder):
                bbb.create("cam.write_value", [s.result], [], attrs)
                bbb.create("cam.search", [s.result], [],
                           {"type": plan.search_type,
                            "selective": plan.stack > 1, **attrs})
                rd = bbb.create("cam.read_value", [s.result],
                                [TensorType((plan.m_queries, a.rows), "f32")],
                                {"mode": "raw", **attrs})
                bbb.create("cam.merge_partial_values_horizontal",
                           [rd.result], [rd.result.type], {"dir": "horizontal"})
            if plan.stack > 1:
                bb.create("scf.for", [], [],
                          {"level": "selective_batch", "lb": 0, "ub": plan.stack,
                           "step": 1, "mode": AccessMode.SEQUENTIAL},
                          regions=[Region([self._subblock(batch_body)])])
            else:
                batch_body(bb)

        def array_body(bb: Builder):
            bb.create("cam.alloc_array", [], [TensorType((), "!cam.array_id")])
            inner = self._subblock(subarray_body)
            bb.create("scf.parallel" if sub_mode == AccessMode.PARALLEL else "scf.for",
                      [], [], {"level": "subarray", "lb": 0,
                               "ub": min(a.subarrays_per_array, plan.physical_subarrays),
                               "step": 1, "mode": sub_mode},
                      regions=[Region([inner])])
            bb.create("cam.reduce_topk", [], [], {"k": plan.k, "largest": plan.largest})
            bb.create("cam.merge_partial_values_indices_vertical", [], [],
                      {"dir": "vertical"})

        def mat_body(bb: Builder):
            bb.create("cam.alloc_mat", [], [TensorType((), "!cam.mat_id")])
            bb.create("scf.parallel" if a.access["array"] == AccessMode.PARALLEL else "scf.for",
                      [], [], {"level": "array", "lb": 0, "ub": a.arrays_per_mat,
                               "step": 1, "mode": a.access["array"]},
                      regions=[Region([self._subblock(array_body)])])

        def bank_body(bb: Builder):
            bb.create("cam.alloc_bank", [], [TensorType((), "!cam.bank_id")],
                      {"rows": a.rows, "cols": a.cols})
            bb.create("scf.parallel" if a.access["mat"] == AccessMode.PARALLEL else "scf.for",
                      [], [], {"level": "mat", "lb": 0, "ub": a.mats_per_bank,
                               "step": 1, "mode": a.access["mat"]},
                      regions=[Region([self._subblock(mat_body)])])

        def round_body(bb: Builder):
            inner = self._subblock(bank_body)
            bb.create("scf.parallel" if a.access["bank"] == AccessMode.PARALLEL else "scf.for",
                      [], [], {"level": "bank", "lb": 0, "ub": plan.banks_used,
                               "step": 1, "mode": a.access["bank"]},
                      regions=[Region([inner])])

        if plan.rounds > 1:
            loop("round", plan.rounds, AccessMode.SEQUENTIAL, round_body)
        else:
            round_body(b)

        # host-side ops and return are carried over
        for op in other:
            if op.name == "func.return":
                continue
            new.body.append(op.clone(vmap))
        rets = []
        for v in module.return_values():
            rets.append(vmap.get(v, v))
        # results of the mapped program come from device buffers; represent
        # with a cam.gather_results op typed like the original returns
        gr = b.create("cam.gather_results", [],
                      [v.type for v in rets], {"source": "device_buffers"})
        b.ret(list(gr.results))
        new.attributes.update(module.attributes)
        return new

    @staticmethod
    def _subblock(fn) -> Block:
        blk = Block()
        fn(Builder(blk))
        return blk
