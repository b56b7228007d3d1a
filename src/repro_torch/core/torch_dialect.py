"""The ``torch`` dialect and the TorchScript-like tracing frontend.

The paper's entry point is Torch IR produced by the torch-mlir converter,
extended with the ``norm``/``topk`` primitives that stock torch-mlir lacks
(paper §III-C).  We reproduce the same surface: a tiny ``Tensor`` proxy that
records ATen-style ops while tracing a Python callable, yielding a
:class:`repro_torch.core.ir.Module` whose ops live in the ``torch`` dialect.

Supported ops (the vocabulary Algorithm 1 needs, plus elementwise glue):

``torch.transpose``, ``torch.matmul``/``mm``, ``torch.sub``, ``torch.add``,
``torch.mul``, ``torch.div``, ``torch.norm`` (vector p-norm along a dim),
``torch.topk``, ``torch.neg``, ``torch.abs``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ir import Builder, IRError, Module, Operation, TensorType, Value, verify

__all__ = ["TracedTensor", "trace", "TORCH_OPS"]

TORCH_OPS = {
    "torch.transpose", "torch.matmul", "torch.mm", "torch.sub", "torch.add",
    "torch.mul", "torch.div", "torch.norm", "torch.topk", "torch.neg",
    "torch.abs", "torch.unsqueeze", "torch.squeeze",
}


def _broadcast_shape(a: Tuple[int, ...], b: Tuple[int, ...]) -> Tuple[int, ...]:
    out: List[int] = []
    for da, db in zip(((1,) * (len(b) - len(a)) + a) if len(a) < len(b) else a,
                      ((1,) * (len(a) - len(b)) + b) if len(b) < len(a) else b):
        if da != db and 1 not in (da, db):
            raise IRError(f"cannot broadcast {a} with {b}")
        out.append(max(da, db))
    return tuple(out)


class TracedTensor:
    """Proxy standing in for ``torch.Tensor`` during tracing."""

    def __init__(self, value: Value, tracer: "_Tracer"):
        self.value = value
        self.tracer = tracer

    # -- shape helpers -----------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return self.value.type.shape

    @property
    def dtype(self) -> str:
        return self.value.type.dtype

    def _emit(self, name: str, operands: Sequence["TracedTensor"],
              out_shapes: Sequence[Tuple[int, ...]],
              attrs: Optional[Dict[str, Any]] = None,
              dtypes: Optional[Sequence[str]] = None):
        dts = dtypes or [self.dtype] * len(out_shapes)
        op = self.tracer.builder.create(
            name, [t.value for t in operands],
            [TensorType(s, d) for s, d in zip(out_shapes, dts)], attrs or {})
        outs = [TracedTensor(r, self.tracer) for r in op.results]
        return outs[0] if len(outs) == 1 else tuple(outs)

    # -- ATen-style ops ------------------------------------------------------
    def transpose(self, dim0: int = -2, dim1: int = -1) -> "TracedTensor":
        shape = list(self.shape)
        d0, d1 = dim0 % len(shape), dim1 % len(shape)
        shape[d0], shape[d1] = shape[d1], shape[d0]
        return self._emit("torch.transpose", [self], [tuple(shape)],
                          {"dim0": dim0, "dim1": dim1})

    def matmul(self, other: "TracedTensor") -> "TracedTensor":
        a, b = self.shape, other.shape
        if a[-1] != b[-2]:
            raise IRError(f"matmul mismatch {a} @ {b}")
        batch = _broadcast_shape(a[:-2], b[:-2]) if len(a) > 2 or len(b) > 2 else ()
        return self._emit("torch.matmul", [self, other], [batch + (a[-2], b[-1])])

    mm = matmul
    __matmul__ = matmul

    def _binary(self, name: str, other: "TracedTensor") -> "TracedTensor":
        return self._emit(name, [self, other],
                          [_broadcast_shape(self.shape, other.shape)])

    def sub(self, other: "TracedTensor") -> "TracedTensor":
        return self._binary("torch.sub", other)

    def add(self, other: "TracedTensor") -> "TracedTensor":
        return self._binary("torch.add", other)

    def mul(self, other: "TracedTensor") -> "TracedTensor":
        return self._binary("torch.mul", other)

    def div(self, other: "TracedTensor") -> "TracedTensor":
        return self._binary("torch.div", other)

    __sub__ = sub
    __add__ = add
    __mul__ = mul
    __truediv__ = div

    def unsqueeze(self, dim: int) -> "TracedTensor":
        d = dim % (len(self.shape) + 1)
        shape = self.shape[:d] + (1,) + self.shape[d:]
        return self._emit("torch.unsqueeze", [self], [shape], {"dim": d})

    def squeeze(self, dim: int) -> "TracedTensor":
        d = dim % len(self.shape)
        if self.shape[d] != 1:
            raise IRError(f"squeeze of non-1 dim {d} of {self.shape}")
        shape = self.shape[:d] + self.shape[d + 1:]
        return self._emit("torch.squeeze", [self], [shape], {"dim": d})

    def neg(self) -> "TracedTensor":
        return self._emit("torch.neg", [self], [self.shape])

    def abs(self) -> "TracedTensor":
        return self._emit("torch.abs", [self], [self.shape])

    def norm(self, p: int = 2, dim: int = -1, keepdim: bool = False) -> "TracedTensor":
        d = dim % len(self.shape)
        shape = tuple(s for i, s in enumerate(self.shape) if i != d) \
            if not keepdim else tuple(1 if i == d else s for i, s in enumerate(self.shape))
        return self._emit("torch.norm", [self], [shape],
                          {"p": p, "dim": dim, "keepdim": keepdim})

    def topk(self, k: int, dim: int = -1, largest: bool = True,
             sorted: bool = True) -> Tuple["TracedTensor", "TracedTensor"]:
        d = dim % len(self.shape)
        shape = tuple(k if i == d else s for i, s in enumerate(self.shape))
        return self._emit("torch.topk", [self], [shape, shape],
                          {"k": k, "dim": dim, "largest": largest, "sorted": sorted},
                          dtypes=[self.dtype, "i32"])


class _Tracer:
    def __init__(self, module: Module):
        self.module = module
        self.builder = Builder(module.body)


def trace(fn: Callable[..., Any], example_inputs: Sequence[Any],
          name: Optional[str] = None, dtype: str = "f32") -> Module:
    """Trace ``fn`` (taking/returning TracedTensors) into a torch-dialect Module.

    ``example_inputs`` may be numpy arrays, torch tensors, ShapeDtypeStruct-
    likes (anything with ``.shape``), or plain shape tuples.  Only shapes and
    dtypes are read, so a tensor on any device traces without a transfer.
    """

    def shape_of(x: Any) -> Tuple[int, ...]:
        if isinstance(x, tuple) and all(isinstance(d, int) for d in x):
            return x
        return tuple(int(d) for d in x.shape)

    def dtype_of(x: Any) -> str:
        dt = getattr(x, "dtype", None)
        if dt is None:
            return dtype
        # torch.float32 -> "float32"; numpy dtypes and strings by name
        name = str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
            else np.dtype(dt).name
        return {"float32": "f32", "float64": "f64", "int32": "i32",
                "int64": "i64", "int8": "i8", "uint8": "ui8",
                "bool": "i1", "float16": "f16", "bfloat16": "bf16"}.get(name, "f32")

    arg_types = [TensorType(shape_of(x), dtype_of(x)) for x in example_inputs]
    module = Module(name or getattr(fn, "__name__", "traced"), arg_types,
                    arg_names=[f"arg{i}" for i in range(len(arg_types))])
    tracer = _Tracer(module)
    inputs = [TracedTensor(v, tracer) for v in module.arguments]
    out = fn(*inputs)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    flat: List[Value] = []
    for o in outs:
        if not isinstance(o, TracedTensor):
            raise IRError(f"traced function returned non-tensor {o!r}")
        flat.append(o.value)
    tracer.builder.ret(flat)
    verify(module)
    return module
