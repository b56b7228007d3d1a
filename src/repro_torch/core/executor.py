"""Functional execution of C4CAM IR on PyTorch: the IR interpreter.

Two execution paths, both bit-identical in results:

* **interpreted** — :func:`execute_module` walks the partitioned ``cim``
  IR op by op (including the explicit Fig.-5d tile ops).  It pins the IR
  semantics, and it is the general path for programs the engine cannot
  express (host ops mixed in, several searches).
* **vectorized** — :func:`build_search_fn` / :func:`build_range_fn` turn
  one fused ``cim.similarity`` / ``cim.range_search`` into a function of
  tensors over :mod:`repro_torch.kernels` (the tiled reference path, or
  the CUDA kernels with ``backend="cuda"``).

Encoding: CAMs store cells, not floats.  For ``dot``/``cos`` on bipolar
data the search runs as Hamming distance (``dot = D - 2*h``); values are
reported back in the *metric domain*.  ``eucl`` on ACAM/MCAM is
analog-exact.

Backends: ``"torch"`` (the reference's ``"jnp"``: the tiled oracles of
:mod:`~repro_torch.kernels.ref`) and ``"cuda"`` (the reference's
``"pallas"``: :func:`~repro_torch.kernels.ops.cam_topk`, which launches
the kernel on CUDA tensors and runs its plain version on CPU tensors).
``device=None`` means the GPU and raises where CUDA is absent.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import ref as kref
from .engine import _as_2d, _encode, _metric_values, resolve_device
from .engine.cache import BACKENDS
from .ir import IRError, Module, Operation

__all__ = ["execute_module", "build_search_fn", "build_range_fn"]


# ---------------------------------------------------------------------------
# Host-op dispatch (the "standard MLIR pipeline" path)
# ---------------------------------------------------------------------------


def _host_eval(op: Operation, env: Dict[int, Any]) -> Sequence[Any]:
    def a(i: int):
        return env[id(op.operands[i])]

    n = op.opname
    if n == "transpose":
        x = a(0)
        d0 = op.attributes.get("dim0", -2) % x.dim()
        d1 = op.attributes.get("dim1", -1) % x.dim()
        return (x.transpose(d0, d1),)
    if n in ("matmul", "mm"):
        return (a(0) @ a(1),)
    if n == "sub":
        return (a(0) - a(1),)
    if n == "add":
        return (a(0) + a(1),)
    if n == "mul":
        return (a(0) * a(1),)
    if n == "div":
        return (a(0) / a(1),)
    if n == "neg":
        return (-a(0),)
    if n == "abs":
        return (a(0).abs(),)
    if n == "norm":
        p = op.attributes.get("p", 2)
        dim = op.attributes.get("dim", -1)
        keep = op.attributes.get("keepdim", False)
        x = a(0)
        if p == 2:
            r = torch.sqrt((x * x).sum(dim=dim, keepdim=keep))
        elif p == 1:
            r = x.abs().sum(dim=dim, keepdim=keep)
        else:
            r = (x.abs() ** p).sum(dim=dim, keepdim=keep) ** (1.0 / p)
        return (r,)
    if n == "unsqueeze":
        return (a(0).unsqueeze(op.attributes["dim"]),)
    if n == "squeeze":
        return (a(0).squeeze(op.attributes["dim"]),)
    if n == "topk":
        k = int(op.attributes["k"])
        largest = bool(op.attributes.get("largest", True))
        x = a(0)
        idx = kref.stable_topk(x if largest else -x, k)
        return (torch.gather(x, -1, idx), idx.to(torch.int32))
    raise IRError(f"host executor: unsupported op {op.name}")


# ---------------------------------------------------------------------------
# Vectorized CAM searches
# ---------------------------------------------------------------------------


def build_search_fn(metric: str, k: int, largest: bool, *, tile_rows: int,
                    dims_per_tile: int, backend: str = "torch"
                    ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Vectorized (query, patterns[, care]) -> (values, indices) search.

    ``care`` (hamming only) is the per-pattern TCAM wildcard mask; the
    masked search always runs through the tiled reference — the unpacked
    semantic oracle the engine's packed ternary path must match.
    """
    phys_metric, to_logical, phys_largest = _metric_values(metric, largest)

    def fn(queries: torch.Tensor, patterns: torch.Tensor,
           care: Optional[torch.Tensor] = None):
        q2, lead = _as_2d(queries)
        qe = _encode(q2, metric)
        pe = _encode(patterns, metric)
        dim = q2.shape[-1]
        if care is None and backend == "cuda":
            from ..kernels import ops as kops
            v, i = kops.cam_topk(qe, pe, metric=phys_metric, k=k,
                                 largest=phys_largest)
        else:
            v, i = kref.cam_topk_tiled(qe, pe, metric=phys_metric, k=k,
                                       largest=phys_largest,
                                       tile_rows=tile_rows,
                                       dims_per_tile=dims_per_tile,
                                       care=care)
        v = to_logical(v, float(dim))
        out_shape = lead + (k,)
        return v.reshape(out_shape), i.reshape(out_shape)

    return fn


def build_range_fn(mode: str, *, metric: Optional[str] = None,
                   threshold: float = 0.0, below: bool = True,
                   tile_rows: int = 0, dims_per_tile: int = 0
                   ) -> Callable[..., torch.Tensor]:
    """Vectorized boolean range-match oracle (``cim.range_search``).

    * ``mode="interval"`` — ``fn(q, lo, hi)``: the aCAM contract of
      :func:`kref.acam_match` (pure comparisons and integer counts, so
      the result is tiling-invariant).
    * ``mode="threshold"`` — ``fn(q, p)``: encode to the physical cell
      domain, accumulate *tiled* partial distances in the engine scan's
      order (:func:`kref.tiled_distances`), map to the logical metric
      domain, compare against the threshold — bit-identical to the
      ``"torch"`` range plan on every metric, eucl included.
    """
    if mode == "interval":
        def fn(queries, lo, hi):
            q2, lead = _as_2d(queries)
            match = kref.acam_match(q2, lo, hi)
            return match.reshape(lead + (match.shape[-1],))
        return fn

    phys_metric, to_logical, _ = _metric_values(metric, True)

    def fn(queries, patterns):
        q2, lead = _as_2d(queries)
        qe = _encode(q2, metric)
        pe = _encode(patterns, metric)
        dim = q2.shape[-1]
        tr = tile_rows or pe.shape[0]
        dpt = dims_per_tile or dim
        d = kref.tiled_distances(qe, pe, metric=phys_metric, tile_rows=tr,
                                 dims_per_tile=dpt)
        v = to_logical(d, float(dim))
        match = (v <= threshold) if below else (v >= threshold)
        return match.reshape(lead + (match.shape[-1],))

    return fn


# ---------------------------------------------------------------------------
# IR interpreter
# ---------------------------------------------------------------------------


def execute_module(module: Module, *inputs, backend: str = "torch",
                   device=None) -> Tuple[Any, ...]:
    """Interpret a torch/cim-level module with PyTorch semantics.

    Inputs (tensors or numpy arrays) move to ``device`` (``None``: the
    GPU); the results are tensors there.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    dev = resolve_device(device)
    env: Dict[int, Any] = {}
    for arg, val in zip(module.arguments, inputs):
        env[id(arg)] = torch.as_tensor(val, device=dev)

    def run_block(ops: List[Operation]) -> None:
        for op in ops:
            if op.name == "func.return":
                continue
            results = eval_op(op)
            for r, v in zip(op.results, results):
                env[id(r)] = v

    def eval_op(op: Operation) -> Sequence[Any]:
        nm = op.name
        if nm == "cim.acquire":
            return (object(),)
        if nm == "cim.release":
            return ()
        if nm == "cim.execute":
            yielded: List[Any] = []
            for inner in op.body_ops():
                if inner.name == "cim.yield":
                    yielded = [env[id(v)] for v in inner.operands]
                    continue
                rs = eval_op(inner)
                for r, v in zip(inner.results, rs):
                    env[id(r)] = v
            return tuple(yielded)
        if nm == "cim.similarity" or nm == "cim.tiled_similarity":
            metric = op.attributes["metric"]
            k = int(op.attributes["k"])
            largest = bool(op.attributes["largest"])
            tr = int(op.attributes.get("tile_rows", 0)) or None
            dpt = int(op.attributes.get("dims_per_tile", 0)) or None
            q = env[id(op.operands[0])]
            p = env[id(op.operands[1])]
            care = env[id(op.operands[2])] if len(op.operands) == 3 else None
            if tr is None:   # unpartitioned: whole-array search
                tr, dpt = p.shape[-2], p.shape[-1]
            fn = build_search_fn(metric, k, largest, tile_rows=tr,
                                 dims_per_tile=dpt, backend=backend)
            v, i = fn(q, p, care)
            # match declared result shapes (e.g. (k,) for 1-D queries)
            return (v.reshape(op.results[0].type.shape),
                    i.reshape(op.results[1].type.shape))
        if nm == "cim.range_search" or nm == "cim.tiled_range_search":
            mode = op.attributes.get("mode", "threshold")
            fn = build_range_fn(
                mode, metric=op.attributes.get("metric"),
                threshold=float(op.attributes.get("threshold", 0.0)),
                below=bool(op.attributes.get("below", True)),
                tile_rows=int(op.attributes.get("tile_rows", 0)),
                dims_per_tile=int(op.attributes.get("dims_per_tile", 0)))
            match = fn(*(env[id(v)] for v in op.operands))
            out_shape = op.results[0].type.shape
            want = 1
            for d in out_shape:
                want *= d
            if match.numel() == want:   # runtime M may differ from the trace
                match = match.reshape(out_shape)
            return (match,)
        if nm == "cim.search_tile":
            q = env[id(op.operands[0])]
            p = env[id(op.operands[1])]
            metric = op.attributes["metric"]
            phys_largest = bool(op.attributes.get("phys_largest", False))
            phys_metric, _, _ = _metric_values(metric, True)
            q2, _ = _as_2d(q)
            qe, pe = _encode(q2, metric), _encode(p, metric)
            r = int(op.attributes["row_tile"])
            c = int(op.attributes["col_tile"])
            tr = int(op.attributes["tile_rows"])
            dpt = int(op.attributes["dims_per_tile"])
            rows = pe[r * tr: (r + 1) * tr, c * dpt: (c + 1) * dpt]
            qs = qe[:, c * dpt: (c + 1) * dpt]
            d = kref.distances(qs, rows, phys_metric)
            # pad missing rows with the losing value so they never win
            if d.shape[1] < tr:
                lose = -float("inf") if phys_largest else float("inf")
                d = torch.nn.functional.pad(d, (0, tr - d.shape[1]),
                                            value=lose)
            return (d,)
        if nm == "cim.merge_partial":
            if op.attributes["dir"] == "horizontal":
                # +-inf padding absorbs finite partial sums
                return (env[id(op.operands[0])] + env[id(op.operands[1])],)
            largest = bool(op.attributes.get("largest", False))
            va, ia, vb, ib = (env[id(v)] for v in op.operands)
            return kref.merge_topk(va, ia, vb, ib, k=va.shape[-1],
                                   largest=largest)
        if nm == "cim.topk_tile":
            d = env[id(op.operands[0])]
            k = int(op.attributes["k"])
            largest = bool(op.attributes["largest"])
            roff = int(op.attributes["row_tile"]) * int(
                op.attributes["tile_rows"])
            kk = min(k, d.shape[-1])
            idx = kref.stable_topk(d if largest else -d, kk)
            vals = torch.gather(d, -1, idx)
            return kref.pad_candidates(vals, idx.to(torch.int32) + roff, k,
                                       largest)
        if nm == "cim.reshape_result":
            v = env[id(op.operands[0])]
            i = env[id(op.operands[1])]
            if op.attributes.get("metric") in ("dot", "cos"):
                # convert physical Hamming counts back to the logical metric
                v = float(op.attributes["dim"]) - 2.0 * v
            return (v.reshape(op.results[0].type.shape),
                    i.reshape(op.results[1].type.shape))
        if op.dialect in ("torch", "cim"):
            return _host_eval(op, env)
        raise IRError(f"executor: unsupported op {op.name}")

    run_block(module.body.operations)
    return tuple(env[id(v)] for v in module.return_values())
