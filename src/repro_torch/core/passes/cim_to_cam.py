"""``cim-to-cam`` conversion (paper §III-D2).

Sequences of ``cim.acquire / cim.execute / cim.release`` on one device
handle are substituted with the allocation of a *simple system* (one bank,
one mat, one array, one subarray), and ``cim.execute`` is lowered into the
three CAM calls: ``cam.write_value``, ``cam.search`` and ``cam.read_value``.

The pass takes the target CAM device type (TCAM / MCAM / ACAM) as a
parameter, which determines the search type and metric used:

* ``dot``/``cos`` similarity on binary data -> Hamming best-match (for
  bipolar hypervectors, ``argmax q.p == argmin hamming(q, p)``),
* ``eucl`` -> analog range/best search on ACAM/MCAM, Hamming approximation
  with thermometer-coded multi-bit cells on TCAM,
* ``k == 1`` uses the winner-take-all ``best`` sensing mode, ``k > 1`` keeps
  counting/ADC sensing (``best`` with k), threshold attrs use ``range``.

Tensor bufferization is notional here: buffers are attributes on the ops
(host/device transfer is accounted by the cost model, and the functional
executor materializes them as arrays).
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..arch import ArchSpec, CamType, Metric, SearchType
from ..ir import Builder, Module, Operation, Pass, Region, Block, TensorType, Value

CAM_ID = lambda kind: TensorType((), f"!cam.{kind}_id")  # noqa: E731


def device_search_config(cam_type: str, metric: str, value_bits: int) -> Dict[str, Any]:
    """Map (device type, cim metric) -> physical search type + metric."""
    if metric in ("dot", "cos"):
        # binary/bipolar data: dot-similarity == Hamming distance search
        return {"metric": Metric.HAMMING, "encoding": "bipolar"}
    if metric == "eucl":
        if cam_type in (CamType.ACAM, CamType.MCAM):
            return {"metric": Metric.EUCLIDEAN, "encoding": "analog"}
        return {"metric": Metric.EUCLIDEAN, "encoding": "thermometer"}
    if metric == "hamming":
        return {"metric": Metric.HAMMING, "encoding": "binary"}
    raise ValueError(f"unsupported metric {metric}")


class CimToCam(Pass):
    name = "cim-to-cam"

    def __init__(self, cam_type: str = CamType.TCAM):
        self.cam_type = cam_type

    def run(self, module: Module, ctx: Dict[str, Any]) -> Module:
        arch: ArchSpec = ctx["arch"]
        new = Module(module.name, [a.type for a in module.arguments])
        vmap: Dict[Value, Value] = {}
        for old_a, new_a in zip(module.arguments, new.arguments):
            new_a.name = old_a.name
            vmap[old_a] = new_a
        b = Builder(new.body)
        i = 0
        ops = module.ops()
        while i < len(ops):
            op = ops[i]
            if op.name == "cim.acquire" and i + 2 < len(ops) \
                    and ops[i + 1].name == "cim.execute" \
                    and ops[i + 2].name == "cim.release":
                self._lower_execute(b, ops[i + 1], vmap, arch, ctx)
                i += 3
                continue
            if op.name == "func.return":
                b.ret([vmap.get(v, v) for v in op.operands])
                i += 1
                continue
            new.body.append(op.clone(vmap))
            i += 1
        return new

    # ------------------------------------------------------------------
    def _lower_execute(self, b: Builder, exe: Operation,
                       vmap: Dict[Value, Value], arch: ArchSpec,
                       ctx: Dict[str, Any]) -> None:
        # allocate the simple system: one bank -> mat -> array -> subarray
        bank = b.create("cam.alloc_bank", [], [CAM_ID("bank")],
                        {"rows": arch.rows, "cols": arch.cols})
        mat = b.create("cam.alloc_mat", [bank.result], [CAM_ID("mat")])
        arr = b.create("cam.alloc_array", [mat.result], [CAM_ID("array")])
        sub = b.create("cam.alloc_subarray", [arr.result], [CAM_ID("subarray")])
        handles = {"bank": bank.result, "mat": mat.result,
                   "array": arr.result, "subarray": sub.result}

        inner_map: Dict[Value, Value] = dict(vmap)
        for op in exe.body_ops():
            if op.name == "cim.yield":
                for outer_r, y in zip(exe.results, op.operands):
                    vmap[outer_r] = inner_map.get(y, y)
                continue
            self._lower_op(b, op, inner_map, handles, arch, ctx)

    def _lower_op(self, b: Builder, op: Operation, inner_map: Dict[Value, Value],
                  handles: Dict[str, Value], arch: ArchSpec,
                  ctx: Dict[str, Any]) -> None:
        def opnd(i: int) -> Value:
            return inner_map.get(op.operands[i], op.operands[i])

        sub = handles["subarray"]
        if op.name in ("cim.range_search", "cim.tiled_range_search"):
            mode = op.attributes.get("mode", "threshold")
            if mode == "interval":
                # interval cells only exist on analog CAMs: each cell
                # stores [lo, hi] as two conductances (Li et al.); a
                # digital TCAM/BCAM has no encoding for them
                if self.cam_type != CamType.ACAM:
                    raise ValueError(
                        f"interval range search requires cam_type="
                        f"'{CamType.ACAM}' (analog interval cells), got "
                        f"{self.cam_type!r}")
                cfg = {"metric": "interval", "encoding": "analog"}
            else:
                value_bits = int(op.attributes.get("value_bits", 8))
                cfg = device_search_config(self.cam_type,
                                           op.attributes["metric"],
                                           value_bits)
            attrs = dict(op.attributes)
            attrs.update(cfg)
            attrs["cam_type"] = self.cam_type
            # interval rows program two bounds per cell; threshold rows
            # store patterns like a best-match search
            b.create("cam.write_value", [sub, *map(opnd, range(1, len(op.operands)))],
                     [], attrs)
            b.create("cam.search", [sub, opnd(0)], [],
                     {"type": SearchType.RANGE, **attrs})
            r = b.create("cam.read_value", [sub],
                         [res.type for res in op.results],
                         {"mode": "match_lines", **attrs})
            for old_r, new_r in zip(op.results, r.results):
                inner_map[old_r] = new_r
            ctx.setdefault("cam_search_configs", []).append(
                {"search_type": SearchType.RANGE, **cfg,
                 "cam_type": self.cam_type})
            return
        if op.name in ("cim.search_tile", "cim.tiled_similarity"):
            value_bits = int(op.attributes.get("value_bits", 8))
            cfg = device_search_config(self.cam_type,
                                       op.attributes["metric"], value_bits)
            search_type = SearchType.BEST if op.attributes.get("k", 0) else SearchType.RANGE
            if op.attributes.get("k", 0) == 1:
                op.attributes["sensing"] = "wta"     # winner-take-all circuit
            attrs = dict(op.attributes)
            attrs.update(cfg)
            attrs["cam_type"] = self.cam_type
            w = b.create("cam.write_value", [sub, opnd(1)], [], attrs)
            s = b.create("cam.search", [sub, opnd(0)], [],
                         {"type": search_type, **attrs})
            mode = "raw" if op.name == "cim.search_tile" else "merged"
            r = b.create("cam.read_value", [sub],
                         [res.type for res in op.results],
                         {"mode": mode, **attrs})
            for old_r, new_r in zip(op.results, r.results):
                inner_map[old_r] = new_r
            ctx.setdefault("cam_search_configs", []).append(
                {"search_type": search_type, **cfg, "cam_type": self.cam_type})
            return
        if op.name == "cim.merge_partial":
            direction = op.attributes["dir"]
            kind = "values" if len(op.operands) == 2 else "values_indices"
            cam_name = f"cam.merge_partial_{kind}_{direction}"
            m = b.create(cam_name, [inner_map.get(v, v) for v in op.operands],
                         [r.type for r in op.results], dict(op.attributes))
            for old_r, new_r in zip(op.results, m.results):
                inner_map[old_r] = new_r
            return
        if op.name in ("cim.topk_tile", "cim.reshape_result"):
            nm = {"cim.topk_tile": "cam.reduce_topk",
                  "cim.reshape_result": "cam.reshape_result"}[op.name]
            m = b.create(nm, [inner_map.get(v, v) for v in op.operands],
                         [r.type for r in op.results], dict(op.attributes))
            for old_r, new_r in zip(op.results, m.results):
                inner_map[old_r] = new_r
            return
        # non-similarity cim compute (host-assisted): keep as cim.* op — the
        # executor runs these on the host (standard MLIR pipeline path).
        cloned = op.clone(inner_map)
        b.block.append(cloned)
        for old_r, new_r in zip(op.results, cloned.results):
            inner_map[old_r] = new_r
