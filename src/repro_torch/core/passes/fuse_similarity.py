"""Execute-block fusion + Algorithm 1 (SimilarityMatching) from the paper.

``FuseExecuteBlocks`` merges maximal dataflow-connected runs of
``cim.acquire / cim.execute / cim.release`` triples into a single execute
block (the paper's ``cim-fuse-ops`` analysis: blocks whose ops cannot be
lowered individually are fused so patterns can be recovered).

``SimilarityMatching`` then inspects each execute block's op list exactly as
Algorithm 1 does: a fast size gate (4 ops for dot-product / Euclidean
patterns, 6-8 for cosine — sizes include the ``cim.yield`` terminator and
binary-div expansion) followed by DFG matching, rewriting matched bodies to
one fused ``cim.similarity`` op.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..cim_dialect import make_yield
from ..ir import Builder, Module, Operation, Pass, Region, Block, TensorType, Value


def _producer_in(block_ops: List[Operation], v: Value) -> Optional[Operation]:
    for op in block_ops:
        if v in op.results:
            return op
    return None


class FuseExecuteBlocks(Pass):
    name = "cim-fuse-ops"

    def run(self, module: Module, ctx: Dict[str, Any]) -> Module:
        ops = module.ops()
        new = Module(module.name, [a.type for a in module.arguments])
        vmap: Dict[Value, Value] = {}
        for old_a, new_a in zip(module.arguments, new.arguments):
            new_a.name = old_a.name
            vmap[old_a] = new_a
        b = Builder(new.body)

        # group program-order runs of (acquire, execute, release)
        runs: List[List[Operation]] = []
        i = 0
        current: List[Operation] = []
        tail: List[Operation] = []
        while i < len(ops):
            op = ops[i]
            if (op.name == "cim.acquire" and i + 2 < len(ops)
                    and ops[i + 1].name == "cim.execute"
                    and ops[i + 2].name == "cim.release"):
                current.append(ops[i + 1])
                i += 3
                continue
            if current:
                runs.append(current)
                current = []
            tail.append(op)
            i += 1
        if current:
            runs.append(current)

        if len(runs) != 1 or tail and any(t.name != "func.return" for t in tail):
            # conservative: only fuse the single-run straight-line case the
            # paper targets; otherwise emit the input unchanged.
            return module

        executes = runs[0]
        # inline all execute bodies into one region
        inner_map: Dict[Value, Value] = dict(vmap)
        body = Block()
        yielded: List[Value] = []
        for exe in executes:
            region_ops = exe.body_ops()
            ys: List[Value] = []
            for rop in region_ops:
                if rop.name == "cim.yield":
                    ys = [inner_map.get(v, v) for v in rop.operands]
                    continue
                cloned = rop.clone(inner_map)
                body.append(cloned)
            # outer results of this execute alias its yielded values
            for outer_r, y in zip(exe.results, ys):
                inner_map[outer_r] = y
            yielded = ys

        handle_op = Operation("cim.acquire", [], [executes[0].operands[0].type])
        new.body.append(handle_op)
        # operands of the fused execute = outer values used inside
        defined = {id(v) for op in body.operations for v in op.results}
        free: List[Value] = []
        for op in body.operations:
            for v in op.operands:
                if id(v) not in defined and v not in free:
                    free.append(v)
        make_yield(body, yielded)
        result_types = [v.type for v in yielded]
        exe = Operation("cim.execute", [handle_op.result, *free], result_types,
                        regions=[Region([body])])
        new.body.append(exe)
        new.body.append(Operation("cim.release", [handle_op.result]))
        # map original return values
        ret_vals = []
        for v in module.return_values():
            mapped = inner_map.get(v, vmap.get(v, v))
            if mapped in yielded:
                ret_vals.append(exe.results[yielded.index(mapped)])
            else:
                ret_vals.append(mapped)
        b.ret(ret_vals)
        return new


# ---------------------------------------------------------------------------
# Algorithm 1: SimilarityMatching
# ---------------------------------------------------------------------------


def _match_similarity(body_ops: List[Operation]) -> Optional[Dict[str, Any]]:
    """Implements Algorithm 1's ``similarDFG`` via structural backward match.

    Returns a dict with keys: queries, patterns, k, largest, metric,
    result_types — or None if no pattern matches.
    """
    from ..cim_dialect import SHAPE_OPS
    yield_op = body_ops[-1]
    if yield_op.name != "cim.yield":
        return None
    compute = body_ops[:-1]
    # Algorithm 1's opSize gate counts compute ops; unsqueeze/squeeze are
    # shape metadata and transparent to the DFG match
    n_ops = 1 + sum(1 for op in compute if op.name not in SHAPE_OPS)
    topks = [op for op in compute if op.name == "cim.topk"]
    if len(topks) != 1:
        return None
    topk = topks[0]
    # fused block must only expose the topk results
    produced = {id(r) for op in compute for r in op.results}
    for y in yield_op.operands:
        if id(y) in produced and y not in topk.results:
            return None

    src = _producer_in(compute, topk.operands[0])
    if src is None:
        return None
    k = int(topk.attributes["k"])
    largest = bool(topk.attributes.get("largest", True))
    rts = [r.type for r in topk.results]

    # -- DotProdSimPattern: transpose -> matmul -> topk  (opSize gate == 4)
    if src.name == "cim.matmul" and n_ops == 4:
        tr = _producer_in(compute, src.operands[1])
        if tr is not None and tr.name == "cim.transpose":
            return dict(queries=src.operands[0], patterns=tr.operands[0],
                        k=k, largest=largest, metric="dot", result_types=rts,
                        pattern="DotProdSimPattern")
    # -- EuclNormPattern: sub -> norm -> topk  (opSize gate == 4)
    if src.name == "cim.norm" and n_ops == 4:
        sub = _producer_in(compute, src.operands[0])
        if sub is not None and sub.name == "cim.sub":
            def peel_shape_ops(v: Value) -> Value:
                p = _producer_in(compute, v)
                while p is not None and p.name in ("cim.unsqueeze",
                                                   "cim.squeeze"):
                    v = p.operands[0]
                    p = _producer_in(compute, v)
                return v
            a, bb = (peel_shape_ops(o) for o in sub.operands)
            # queries = the broadcast (M, 1, D)/unsqueezed side; patterns =
            # the (N, D) stored side
            qry, pat = (a, bb) if a.type.rank <= bb.type.rank else (bb, a)
            if a.type.rank == bb.type.rank:
                # un-broadcast case: left operand is the query by convention
                qry, pat = a, bb
            return dict(queries=qry, patterns=pat, k=k, largest=largest,
                        metric="eucl", result_types=rts,
                        pattern="EuclNormPattern")
    # -- CosSimPattern: norm, norm, transpose, matmul, div(s) -> topk.
    # The paper's gate is opSize == 6 with a ternary div; our frontend
    # expands it to two binary divs + a transpose of the norm, so the
    # equivalent gate is 6..9 (documented deviation).
    if src.name == "cim.div" and 6 <= n_ops <= 9:
        # peel one or two div levels (binary-div expansion of the paper's
        # ternary div(v4, v2, v1))
        node = src
        divisors: List[Value] = []
        for _ in range(2):
            divisors.append(node.operands[1])
            nxt = _producer_in(compute, node.operands[0])
            if nxt is None:
                return None
            if nxt.name != "cim.div":
                break
            node = nxt
        mm = nxt
        if mm.name != "cim.matmul":
            return None
        tr = _producer_in(compute, mm.operands[1])
        if tr is None or tr.name != "cim.transpose":
            return None
        norms = [op for op in compute if op.name == "cim.norm"]
        if len(norms) < 1:
            return None
        return dict(queries=mm.operands[0], patterns=tr.operands[0],
                    k=k, largest=largest, metric="cos", result_types=rts,
                    pattern="CosSimPattern")
    return None


class SimilarityMatching(Pass):
    """Rewrites matched execute-block bodies to ``cim.similarity``."""

    name = "cim-similarity-match"

    def run(self, module: Module, ctx: Dict[str, Any]) -> Module:
        for exe in module.ops():
            if exe.name != "cim.execute":
                continue
            body_ops = exe.body_ops()
            m = _match_similarity(body_ops)
            if m is None:
                continue
            blk = exe.region().block()
            old_yield = body_ops[-1]
            topk_results = []
            for op in body_ops[:-1]:
                if op.name == "cim.topk":
                    topk_results = op.results
            blk.operations = []
            # how many bits of CAM storage one element needs: binary /
            # bipolar data (HDC) is 1 bit; analog-quantized features default
            # to 8 bits.  Overridable per compilation (paper's binary vs
            # multi-bit implementations).
            value_bits = ctx.get("value_bits") or {
                "f32": 8, "f64": 8, "bf16": 8, "f16": 8,
                "i8": 8, "ui8": 1, "i1": 1}.get(m["queries"].type.dtype, 8)
            sim = Operation("cim.similarity", [m["queries"], m["patterns"]],
                            m["result_types"],
                            {"metric": m["metric"], "k": m["k"],
                             "largest": m["largest"],
                             "pattern": m["pattern"],
                             "value_bits": value_bits})
            blk.append(sim)
            make_yield(blk, sim.results)
            # rewire: execute results keep identity; nothing outside changes
            ctx.setdefault("matched_patterns", []).append(m["pattern"])
        return module
