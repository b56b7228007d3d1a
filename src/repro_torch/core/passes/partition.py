"""Compulsory partitioning (paper §III-D1, Fig. 5d).

Kernels usually exceed the capacity of a single subarray (the smallest block
of the CAM system), so fused ``cim.similarity`` ops are tiled to subarray
granularity.  The transformation "can be likened to tiling in compiler
terminology, with hardware-specific considerations":

* pattern rows are split into ``grid_rows`` row-batches of at most R rows,
* pattern columns (after cell-encoding: ``value_bits / bits_per_cell`` cells
  per element) are split into ``grid_cols`` column tiles of at most C cells,
* partial distances across column tiles are accumulated with
  ``cim.merge_partial {dir = horizontal}``,
* per-row-batch top-k candidate lists are tournament-merged with
  ``cim.merge_partial {dir = vertical}`` (``cim.merge_partial`` "considers
  both the type of operation ... and the direction", §III-D1).

For small grids (<= ``unroll_limit`` tiles) the pass emits the fully
explicit per-tile IR of Fig. 5d; for large grids it emits one
``cim.tiled_similarity`` op carrying the grid as attributes — identical
semantics, loop-structured lowering (the cam-map pass generates the loops
either way, like MLIR's scf tiling would).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

from ..arch import ArchSpec
from ..cim_dialect import make_yield
from ..ir import Module, Operation, Pass, TensorType, Value


def tile_grid(arch: ArchSpec, n_rows: int, dim: int, value_bits: int):
    """(grid_rows, grid_cols, cols_per_value, dims_per_tile) for a pattern set."""
    cells_per_value = max(1, math.ceil(value_bits / arch.bits_per_cell))
    dims_per_tile = max(1, arch.cols // cells_per_value)
    grid_cols = math.ceil(dim / dims_per_tile)
    grid_rows = math.ceil(n_rows / arch.rows)
    return grid_rows, grid_cols, cells_per_value, dims_per_tile


class CompulsoryPartition(Pass):
    name = "cim-partition"

    def __init__(self, unroll_limit: int = 64):
        self.unroll_limit = unroll_limit

    def run(self, module: Module, ctx: Dict[str, Any]) -> Module:
        arch: ArchSpec = ctx["arch"]
        for exe in module.ops():
            if exe.name != "cim.execute":
                continue
            body = exe.body_ops()
            sims = [op for op in body if op.name == "cim.similarity"]
            ranges = [op for op in body if op.name == "cim.range_search"]
            if not sims and not ranges:
                continue
            blk = exe.region().block()
            for sim in sims:
                self._partition_one(blk, sim, arch, ctx)
            for rs in ranges:
                self._partition_range(blk, rs, arch, ctx)
        return module

    # ------------------------------------------------------------------
    def _partition_one(self, blk, sim: Operation, arch: ArchSpec,
                       ctx: Dict[str, Any]) -> None:
        queries, patterns = sim.operands[0], sim.operands[1]
        ternary = len(sim.operands) == 3     # TCAM wildcard care mask
        n_rows, dim = patterns.type.shape[-2], patterns.type.shape[-1]
        m = 1
        for d in queries.type.shape[:-1]:
            m *= d
        value_bits = int(sim.attributes.get("value_bits", 8))
        grid_rows, grid_cols, cpv, dpt = tile_grid(arch, n_rows, dim, value_bits)
        k = int(sim.attributes["k"])
        largest = bool(sim.attributes["largest"])
        metric = sim.attributes["metric"]
        common = {"metric": metric, "k": k, "largest": largest,
                  "value_bits": value_bits, "grid_rows": grid_rows,
                  "grid_cols": grid_cols, "tile_rows": arch.rows,
                  "tile_cols": arch.cols, "dims_per_tile": dpt,
                  "cells_per_value": cpv, "m": m, "n": n_rows, "dim": dim}
        ctx.setdefault("partition_info", []).append(dict(common))

        if ternary:
            # the care mask rides every tile; emit the loop-structured op
            # (the engine packs it per column tile, the interpreter masks
            # its mismatch counts — Fig.-5d unrolling would triple the
            # per-tile operand wiring for no semantic gain)
            common["ternary"] = True
            new_ops = [Operation("cim.tiled_similarity", list(sim.operands),
                                 [r.type for r in sim.results], dict(common))]
        elif grid_rows * grid_cols <= self.unroll_limit:
            new_ops = self._emit_unrolled(sim, queries, patterns, common)
        else:
            new_ops = [Operation("cim.tiled_similarity", [queries, patterns],
                                 [r.type for r in sim.results], dict(common))]
        # splice: replace sim with new_ops, rewiring result uses via yield
        idx = blk.operations.index(sim)
        blk.operations[idx:idx + 1] = new_ops
        for op in new_ops:
            op.parent = blk
        final = new_ops[-1]
        mapping = dict(zip(sim.results, final.results))
        for op in blk.operations:
            op.operands = [mapping.get(v, v) for v in op.operands]

    # ------------------------------------------------------------------
    def _partition_range(self, blk, rs: Operation, arch: ArchSpec,
                         ctx: Dict[str, Any]) -> None:
        """Tile a ``cim.range_search`` to subarray granularity.

        Range search has no cross-tile candidate tournament: column
        tiles still accumulate partial distances / violation counts
        (``merge_partial horizontal``), but row tiles *concatenate*
        their boolean match slices — every stored row reports its own
        match line, so the loop-structured ``cim.tiled_range_search``
        form is emitted for every grid size (unrolling would only
        replicate the concatenation wiring).
        """
        queries = rs.operands[0]
        stored = rs.operands[1]          # patterns, or the lo bound
        n_rows, dim = stored.type.shape[-2], stored.type.shape[-1]
        m = 1
        for d in queries.type.shape[:-1]:
            m *= d
        mode = rs.attributes.get("mode", "threshold")
        value_bits = int(rs.attributes.get("value_bits", 8))
        grid_rows, grid_cols, cpv, dpt = tile_grid(arch, n_rows, dim,
                                                   value_bits)
        common = dict(rs.attributes)
        common.update({"value_bits": value_bits, "grid_rows": grid_rows,
                       "grid_cols": grid_cols, "tile_rows": arch.rows,
                       "tile_cols": arch.cols, "dims_per_tile": dpt,
                       "cells_per_value": cpv, "m": m, "n": n_rows,
                       "dim": dim})
        info = dict(common)
        # MappingPlan/cost-model fields the similarity records carry;
        # a range search senses every row's match line (no top-k)
        info.setdefault("metric", "interval" if mode == "interval"
                        else rs.attributes["metric"])
        info.update({"k": 0, "largest": False, "search_type": "range"})
        ctx.setdefault("partition_info", []).append(info)
        tiled = Operation("cim.tiled_range_search", list(rs.operands),
                          [r.type for r in rs.results], common)
        idx = blk.operations.index(rs)
        blk.operations[idx:idx + 1] = [tiled]
        tiled.parent = blk
        mapping = dict(zip(rs.results, tiled.results))
        for op in blk.operations:
            op.operands = [mapping.get(v, v) for v in op.operands]

    # ------------------------------------------------------------------
    def _emit_unrolled(self, sim: Operation, queries: Value, patterns: Value,
                       a: Dict[str, Any]) -> List[Operation]:
        """Explicit Fig.-5d style tile ops for small grids."""
        ops: List[Operation] = []
        m, k = a["m"], a["k"]
        dist_t = TensorType((m, a["tile_rows"]), "f32")
        vt = sim.results[0].type
        it = sim.results[1].type
        # dot/cos similarity physically runs as Hamming distance on the CAM
        # (bipolar encoding); the on-device top-k therefore has flipped
        # polarity, and reshape_result converts values back to the logical
        # metric domain (dot = D - 2*hamming).
        phys_largest = (not a["largest"]) if a["metric"] in ("dot", "cos") \
            else a["largest"]
        merged_rows: List[Operation] = []
        for r in range(a["grid_rows"]):
            acc: Value = None
            for c in range(a["grid_cols"]):
                st = Operation("cim.search_tile", [queries, patterns], [dist_t],
                               {"row_tile": r, "col_tile": c,
                                "metric": a["metric"],
                                "phys_largest": phys_largest,
                                "dims_per_tile": a["dims_per_tile"],
                                "tile_rows": a["tile_rows"]})
                ops.append(st)
                if acc is None:
                    acc = st.result
                else:
                    mp = Operation("cim.merge_partial", [acc, st.result],
                                   [dist_t], {"dir": "horizontal"})
                    ops.append(mp)
                    acc = mp.result
            tk = Operation("cim.topk_tile", [acc], [TensorType((m, k), vt.dtype),
                                                    TensorType((m, k), "i32")],
                           {"k": k, "largest": phys_largest, "row_tile": r,
                            "tile_rows": a["tile_rows"]})
            ops.append(tk)
            merged_rows.append(tk)
        acc_v, acc_i = merged_rows[0].results
        for r, tk in enumerate(merged_rows[1:], start=1):
            mp = Operation("cim.merge_partial",
                           [acc_v, acc_i, tk.results[0], tk.results[1]],
                           [TensorType((m, k), vt.dtype), TensorType((m, k), "i32")],
                           {"dir": "vertical", "row_offset": r * a["tile_rows"],
                            "largest": phys_largest})
            ops.append(mp)
            acc_v, acc_i = mp.results
        fin = Operation("cim.reshape_result", [acc_v, acc_i], [vt, it],
                        {"m": m, "k": k, "metric": a["metric"],
                         "dim": a["dim"]})
        ops.append(fin)
        return ops
