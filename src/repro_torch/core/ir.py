"""Lightweight MLIR-like IR infrastructure for the C4CAM reproduction.

This intentionally mirrors the small subset of MLIR that C4CAM relies on:

* SSA ``Value``s carrying tensor types,
* ``Operation``s grouped into dialects via a ``"dialect.opname"`` naming
  convention, with attributes and (optionally) nested regions,
* ``Block``/``Region``/``Module`` containers,
* a ``PassManager`` running rewrite passes, each of which records the IR
  snapshot so the progressive-lowering pipeline can be inspected (this is
  what the paper's Fig. 4/5/6 show at each abstraction level).

MLIR itself is *not* a dependency; the textual form produced by
:meth:`Module.dump` is MLIR-flavoured for readability only.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "TensorType",
    "Value",
    "Operation",
    "Block",
    "Region",
    "Module",
    "Builder",
    "Pass",
    "PassManager",
    "IRError",
    "verify",
]


class IRError(RuntimeError):
    """Raised on malformed IR or failed verification."""


# ---------------------------------------------------------------------------
# Types and values
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TensorType:
    """A ranked tensor type, ``tensor<4x8xf32>`` style.

    ``shape`` entries of ``-1`` denote dynamic dims (unused in the paper's
    flow but kept for generality).
    """

    shape: Tuple[int, ...]
    dtype: str = "f32"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        dims = "x".join(str(d) if d >= 0 else "?" for d in self.shape)
        return f"tensor<{dims}x{self.dtype}>" if self.shape else f"tensor<{self.dtype}>"

    @property
    def rank(self) -> int:
        return len(self.shape)

    def num_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= max(d, 0)
        return n


_value_ids = itertools.count()


class Value:
    """An SSA value produced by an operation (or a block argument)."""

    __slots__ = ("type", "producer", "index", "name", "id")

    def __init__(self, type: TensorType, producer: Optional["Operation"] = None,
                 index: int = 0, name: Optional[str] = None):
        self.type = type
        self.producer = producer
        self.index = index
        self.id = next(_value_ids)
        self.name = name or f"%{self.id}"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.name}: {self.type}"


# ---------------------------------------------------------------------------
# Operations / blocks / regions
# ---------------------------------------------------------------------------


class Operation:
    """A generic operation: ``results = dialect.name(operands) {attrs}``."""

    def __init__(
        self,
        name: str,
        operands: Sequence[Value] = (),
        result_types: Sequence[TensorType] = (),
        attributes: Optional[Dict[str, Any]] = None,
        regions: Optional[List["Region"]] = None,
    ):
        if "." not in name:
            raise IRError(f"operation name must be 'dialect.op', got {name!r}")
        self.name = name
        self.operands: List[Value] = list(operands)
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.regions: List[Region] = regions or []
        self.results: List[Value] = [
            Value(t, producer=self, index=i) for i, t in enumerate(result_types)
        ]
        self.parent: Optional[Block] = None

    # -- convenience -------------------------------------------------------
    @property
    def dialect(self) -> str:
        return self.name.split(".", 1)[0]

    @property
    def opname(self) -> str:
        return self.name.split(".", 1)[1]

    @property
    def result(self) -> Value:
        if len(self.results) != 1:
            raise IRError(f"{self.name} has {len(self.results)} results, expected 1")
        return self.results[0]

    def region(self, i: int = 0) -> "Region":
        return self.regions[i]

    def body_ops(self) -> List["Operation"]:
        """Ops of the first block of the first region (execute-style ops)."""
        if not self.regions or not self.regions[0].blocks:
            return []
        return list(self.regions[0].blocks[0].operations)

    def erase(self) -> None:
        if self.parent is not None:
            self.parent.operations.remove(self)
            self.parent = None

    def replace_all_uses_with(self, mapping: Dict[Value, Value], root: "Operation") -> None:
        """Within ``root`` (recursively), remap operands per ``mapping``."""
        for op in root.walk():
            op.operands = [mapping.get(v, v) for v in op.operands]

    def walk(self) -> Iterator["Operation"]:
        yield self
        for region in self.regions:
            for block in region.blocks:
                for op in list(block.operations):
                    yield from op.walk()

    def clone(self, value_map: Optional[Dict[Value, Value]] = None) -> "Operation":
        value_map = value_map if value_map is not None else {}
        new = Operation(
            self.name,
            [value_map.get(v, v) for v in self.operands],
            [r.type for r in self.results],
            dict(self.attributes),
        )
        for old_r, new_r in zip(self.results, new.results):
            value_map[old_r] = new_r
        for region in self.regions:
            new.regions.append(region.clone(value_map))
        return new

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return _print_op(self, indent=0)


class Block:
    def __init__(self, arg_types: Sequence[TensorType] = ()):  # noqa: D401
        self.arguments: List[Value] = [Value(t) for t in arg_types]
        self.operations: List[Operation] = []

    def append(self, op: Operation) -> Operation:
        op.parent = self
        self.operations.append(op)
        return op

    def insert_before(self, anchor: Operation, op: Operation) -> Operation:
        idx = self.operations.index(anchor)
        op.parent = self
        self.operations.insert(idx, op)
        return op

    def clone(self, value_map: Dict[Value, Value]) -> "Block":
        new = Block()
        new.arguments = []
        for arg in self.arguments:
            na = Value(arg.type, name=arg.name)
            value_map[arg] = na
            new.arguments.append(na)
        for op in self.operations:
            new.append(op.clone(value_map))
        return new


class Region:
    def __init__(self, blocks: Optional[List[Block]] = None):
        self.blocks: List[Block] = blocks or []

    def block(self, i: int = 0) -> Block:
        return self.blocks[i]

    def clone(self, value_map: Dict[Value, Value]) -> "Region":
        return Region([b.clone(value_map) for b in self.blocks])


class Module:
    """Top-level container: a single function-like body (the traced kernel)."""

    def __init__(self, name: str, arg_types: Sequence[TensorType],
                 arg_names: Optional[Sequence[str]] = None):
        self.name = name
        self.body = Block(arg_types)
        if arg_names:
            for v, n in zip(self.body.arguments, arg_names):
                v.name = f"%{n}"
        self.attributes: Dict[str, Any] = {}

    @property
    def arguments(self) -> List[Value]:
        return self.body.arguments

    def ops(self) -> List[Operation]:
        return list(self.body.operations)

    def walk(self) -> Iterator[Operation]:
        for op in list(self.body.operations):
            yield from op.walk()

    def return_values(self) -> List[Value]:
        for op in reversed(self.body.operations):
            if op.name == "func.return":
                return list(op.operands)
        raise IRError("module has no func.return")

    def dump(self) -> str:
        lines = [f"func.func @{self.name}("
                 + ", ".join(f"{a.name}: {a.type}" for a in self.arguments) + ") {"]
        for op in self.body.operations:
            lines.append(_print_op(op, indent=1))
        lines.append("}")
        return "\n".join(lines)

    def clone(self) -> "Module":
        new = Module(self.name, [a.type for a in self.arguments])
        vmap: Dict[Value, Value] = {}
        for old_a, new_a in zip(self.arguments, new.arguments):
            new_a.name = old_a.name
            vmap[old_a] = new_a
        for op in self.body.operations:
            new.body.append(op.clone(vmap))
        return new


# ---------------------------------------------------------------------------
# Printing
# ---------------------------------------------------------------------------


def _fmt_attr(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"'
    return str(v)


def _print_op(op: Operation, indent: int) -> str:
    pad = "  " * indent
    res = ", ".join(r.name for r in op.results)
    eq = f"{res} = " if res else ""
    args = ", ".join(o.name for o in op.operands)
    attrs = ""
    if op.attributes:
        attrs = " {" + ", ".join(f"{k} = {_fmt_attr(v)}" for k, v in sorted(op.attributes.items())) + "}"
    types = ""
    if op.operands or op.results:
        in_t = ", ".join(str(o.type) for o in op.operands)
        out_t = ", ".join(str(r.type) for r in op.results)
        types = f" : ({in_t}) -> ({out_t})"
    head = f"{pad}{eq}{op.name}({args}){attrs}{types}"
    if not op.regions:
        return head
    lines = [head + " {"]
    for region in op.regions:
        for bi, block in enumerate(region.blocks):
            if block.arguments:
                lines.append("  " * (indent + 1) + "^bb(" +
                             ", ".join(f"{a.name}: {a.type}" for a in block.arguments) + "):")
            for inner in block.operations:
                lines.append(_print_op(inner, indent + 1))
    lines.append(pad + "}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


class Builder:
    """Appends operations to a block (module body or region block)."""

    def __init__(self, block: Block):
        self.block = block

    def create(self, name: str, operands: Sequence[Value] = (),
               result_types: Sequence[TensorType] = (),
               attributes: Optional[Dict[str, Any]] = None,
               regions: Optional[List[Region]] = None) -> Operation:
        op = Operation(name, operands, result_types, attributes, regions)
        self.block.append(op)
        return op

    def ret(self, values: Sequence[Value]) -> Operation:
        return self.create("func.return", values)


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------


def verify(module: Module) -> None:
    """Checks SSA dominance within straight-line blocks and operand validity."""

    def check_block(block: Block, visible: set) -> None:
        visible = set(visible)
        visible.update(id(a) for a in block.arguments)
        for op in block.operations:
            for operand in op.operands:
                if id(operand) not in visible:
                    raise IRError(
                        f"operand {operand.name} of {op.name} does not dominate its use")
            for region in op.regions:
                for inner in region.blocks:
                    check_block(inner, visible)
            visible.update(id(r) for r in op.results)

    check_block(module.body, set())
    if not any(op.name == "func.return" for op in module.body.operations):
        raise IRError("module missing func.return")


# ---------------------------------------------------------------------------
# Pass infrastructure
# ---------------------------------------------------------------------------


class Pass:
    """Base class. Subclasses set ``name`` and implement :meth:`run`."""

    name: str = "<abstract>"

    def run(self, module: Module, ctx: Dict[str, Any]) -> Module:  # pragma: no cover
        raise NotImplementedError


@dataclass
class PassManager:
    passes: List[Pass] = field(default_factory=list)
    verify_each: bool = True
    keep_snapshots: bool = True
    snapshots: List[Tuple[str, str]] = field(default_factory=list)

    def add(self, p: Pass) -> "PassManager":
        self.passes.append(p)
        return self

    def run(self, module: Module, ctx: Optional[Dict[str, Any]] = None) -> Module:
        ctx = ctx if ctx is not None else {}
        self.snapshots = [("input", module.dump())] if self.keep_snapshots else []
        for p in self.passes:
            module = p.run(module, ctx)
            if self.verify_each:
                verify(module)
            if self.keep_snapshots:
                self.snapshots.append((p.name, module.dump()))
        return module
