"""``torch-to-cim`` conversion (paper §III-D, Fig. 5a).

The fundamental assumption of the conversion (quoting the paper) is that
*each supported operation can be executed on a separate (non-)CIM device*:
every torch op that the cim abstraction supports is wrapped into its own
``cim.acquire`` / ``cim.execute`` / ``cim.release`` triple.  Unsupported ops
(none in our vocabulary, but kept general) stay in the host dialect.
"""

from __future__ import annotations

from typing import Any, Dict

from ..cim_dialect import CIM_COMPUTE_OPS, make_acquire, make_execute, make_release, make_yield
from ..ir import Builder, Module, Operation, Pass


class TorchToCim(Pass):
    name = "torch-to-cim"

    def run(self, module: Module, ctx: Dict[str, Any]) -> Module:
        new = Module(module.name, [a.type for a in module.arguments])
        vmap = {}
        for old_a, new_a in zip(module.arguments, new.arguments):
            new_a.name = old_a.name
            vmap[old_a] = new_a
        b = Builder(new.body)
        for op in module.body.operations:
            if op.name == "func.return":
                b.ret([vmap[v] for v in op.operands])
                continue
            if op.name not in CIM_COMPUTE_OPS:
                # host fallback: keep the op as-is (standard MLIR pipeline)
                cloned = op.clone(vmap)
                new.body.append(cloned)
                continue
            handle = make_acquire(b).result
            exe = make_execute(b, handle, [vmap[v] for v in op.operands],
                               [r.type for r in op.results])
            inner = Operation(CIM_COMPUTE_OPS[op.name],
                              [vmap[v] for v in op.operands],
                              [r.type for r in op.results],
                              dict(op.attributes))
            exe.region().block().append(inner)
            make_yield(exe.region().block(), inner.results)
            for old_r, new_r in zip(op.results, exe.results):
                vmap[old_r] = new_r
            make_release(b, handle)
        return new
