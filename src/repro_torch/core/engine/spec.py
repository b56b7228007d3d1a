"""Plan specs and the structural IR analysis that produces them.

A *spec* is the frozen, hashable structural summary of a partitioned
``cim`` program — metric, k, tile geometry, operand wiring and output
shapes.  Two modules with equal specs compile to interchangeable
executables; the spec (plus backend / micro-batch / packing / device)
*is* the plan-cache key.  Two families: top-k search
(:class:`SimilaritySpec`) and boolean range match (:class:`RangeSpec`,
threshold or aCAM interval); the composite
:class:`~.composite.HierarchicalSpec` wraps a similarity spec.

Also here: the metric/encoding helpers mapping the physical CAM domain
(hamming counts) to the logical metric domain.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..envcfg import env_flag
from ..ir import Module


# ---------------------------------------------------------------------------
# Metric / encoding helpers (physical CAM domain <-> logical metric domain)
# ---------------------------------------------------------------------------


def _metric_values(metric: str, largest: bool):
    """How the physical CAM search relates to the logical metric.

    ``dot``/``cos`` run as bipolar hamming with flipped polarity:
    ``dot = dim - 2 h`` is strictly decreasing in ``h``, so the physical
    order (smallest ``h`` first, lowest index on ties) is exactly the
    logical order, ties included.
    """
    if metric in ("dot", "cos"):
        return "hamming", (lambda h, dim: dim - 2.0 * h), (not largest)
    if metric == "eucl":
        return "eucl", (lambda d, dim: d), largest
    if metric == "hamming":
        return "hamming", (lambda h, dim: h), largest
    raise ValueError(metric)


def _encode(x: torch.Tensor, metric: str) -> torch.Tensor:
    if metric in ("dot", "cos"):
        return (x > 0).to(torch.float32)
    return x


def _bits(x: torch.Tensor, metric: str) -> torch.Tensor:
    """Cell bits for the packed path (bool tensor, unpacked).

    ``dot``/``cos`` binarise exactly like :func:`_encode` (``x > 0``);
    ``hamming`` cells are {0, 1} by the kernel contract and the bit is
    ``x != 0`` — packed hamming plans enforce the contract
    (:func:`_check_binary_cells`).
    """
    return (x > 0) if metric in ("dot", "cos") else (x != 0)


def _check_binary_cells(x, what: str) -> None:
    """Packed-hamming contract guard: values must be {0, 1} / booleans.

    The unpacked path computes a true elementwise mismatch count for
    *any* alphabet; the packed path only sees bits.  Reject other data
    rather than let it collapse silently.  On a CUDA tensor the check
    reads the answer back, so dispatch calls it only for host queries.
    """
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bool:
            return
        ok = bool(((x == 0) | (x == 1)).all())
    else:
        a = np.asarray(x)
        if a.dtype == np.bool_:
            return
        ok = bool(((a == 0) | (a == 1)).all())
    if not ok:
        raise ValueError(
            f"packed hamming search requires binary {{0, 1}} {what} "
            f"(got values outside the CAM cell contract); pass "
            f"pack=False to run the float path on non-binary data")


#: metrics with a bit-packed physical search (binary cells, integer counts)
_PACKABLE_METRICS = ("hamming", "dot", "cos")


def _resolve_pack(spec, pack: Optional[bool]) -> bool:
    """Effective packing choice for a plan.

    ``None`` (auto) packs every packable metric unless
    ``REPRO_ENGINE_PACK`` is ``off``/``0``; an explicit ``pack=True`` on
    an analog metric is a hard error.
    """
    packable = spec.metric in _PACKABLE_METRICS
    if pack is None:
        return packable and env_flag("REPRO_ENGINE_PACK", True)
    if pack and not packable:
        raise ValueError(
            f"packed execution requires a binary/bipolar metric "
            f"(hamming/dot/cos), got {spec.metric!r}")
    return bool(pack)


# ---------------------------------------------------------------------------
# Plan specs: everything a compiled search needs, hashable for the cache
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimilaritySpec:
    """Structural summary of a partitioned similarity program."""

    metric: str
    k: int
    largest: bool              # logical polarity (metric domain)
    tile_rows: int             # R: pattern rows per subarray
    dims_per_tile: int         # logical values per column tile
    grid_rows: int
    grid_cols: int
    m: int                     # traced query count (batch hint only)
    n: int                     # pattern rows
    dim: int                   # logical feature dimension
    query_arg: int             # positions in module.arguments
    pattern_arg: int
    out_v_shape: Tuple[int, ...]
    out_i_shape: Tuple[int, ...]
    #: TCAM ternary search: module-argument position of the per-pattern
    #: care mask ((N, D), non-zero = compared cell, 0 = wildcard)
    care_arg: Optional[int] = None
    #: IR dtypes of the (query, pattern[, care]) operands
    in_dtypes: Tuple[str, ...] = ("f32", "f32")


@dataclass(frozen=True)
class RangeSpec:
    """Structural summary of a partitioned range-search program.

    The second plan family: boolean match search (paper TH mode /
    analog-CAM interval match) instead of top-k.  Being a distinct
    frozen type, its cache keys never collide with a similarity plan's.
    """

    #: "threshold" (distance vs tau) or "interval" (aCAM lo/hi cells)
    mode: str
    #: logical metric for threshold mode; the sentinel "interval" for
    #: interval mode (not packable, encoding is a passthrough)
    metric: str
    threshold: float           # static: part of the plan key
    below: bool                # True: match iff value <= tau; False: >=
    tile_rows: int
    dims_per_tile: int
    grid_rows: int
    grid_cols: int
    m: int                     # traced query count (batch hint only)
    n: int                     # stored rows
    dim: int
    query_arg: int
    #: module-argument positions of the stored operands — (patterns,)
    #: for threshold mode, (lo, hi) for interval mode
    pattern_args: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    in_dtypes: Tuple[str, ...] = ("f32", "f32")

    def __post_init__(self):
        # the spec is the plan-cache key and the digest's source: + 0.0
        # folds -0.0 into +0.0 (equal in Python, different repr), and a
        # NaN threshold (unequal to itself, matches nothing) is refused
        t = float(self.threshold)
        if t != t:
            raise ValueError(
                "RangeSpec threshold must not be NaN (a NaN threshold "
                "matches no row and poisons the plan-cache key)")
        object.__setattr__(self, "threshold", t + 0.0)


# ---------------------------------------------------------------------------
# Stable spec digests
# ---------------------------------------------------------------------------


def _fingerprint_value(o):
    """Canonical JSON-able form of one spec field value (floats tagged and
    rendered after ``+ 0.0``; NaN raises)."""
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        out = {"__family__": type(o).__name__}
        for f in dataclasses.fields(o):
            out[f.name] = _fingerprint_value(getattr(o, f.name))
        return out
    if isinstance(o, bool) or o is None or isinstance(o, (int, str)):
        return o
    if isinstance(o, float):
        v = float(o) + 0.0
        if v != v:
            raise ValueError("cannot fingerprint a NaN spec field")
        return {"__float__": repr(v)}
    if isinstance(o, (tuple, list)):
        return [_fingerprint_value(x) for x in o]
    raise TypeError(
        f"unfingerprintable spec field of type {type(o).__name__}")


def spec_fingerprint(spec) -> str:
    """Deterministic, family-tagged canonical JSON for a plan spec —
    identical to the reference's for an equal spec."""
    return json.dumps(_fingerprint_value(spec), sort_keys=True,
                      separators=(",", ":"))


def spec_digest(spec) -> str:
    """sha256 hex of :func:`spec_fingerprint`."""
    return hashlib.sha256(spec_fingerprint(spec).encode()).hexdigest()


def workload_digest(spec) -> str:
    """Digest of the spec with its tile geometry normalised away (the
    reference's, hex for hex).

    The autotuner searches over tile geometry, so the plan store keys
    tuned configs by what the workload is (metric, k or threshold,
    operand shapes, dtypes, care wiring), not by how one module happened
    to tile it.
    """
    geomless = dataclasses.replace(spec, tile_rows=0, dims_per_tile=0,
                                   grid_rows=0, grid_cols=0)
    return spec_digest(geomless)


_SIM_OPS = {"cim.similarity", "cim.tiled_similarity"}
_RANGE_OPS = {"cim.range_search", "cim.tiled_range_search"}
_TILE_OPS = {"cim.search_tile", "cim.merge_partial", "cim.topk_tile",
             "cim.reshape_result"}


def extract_plan_spec(module: Module) -> Optional[SimilaritySpec]:
    """Return the spec if ``module`` is a pure similarity program.

    Accepted shape: ``cim.acquire`` / one ``cim.execute`` whose region is a
    single fused (or partitioned) similarity / ``cim.release`` /
    ``func.return`` of the execute's two results.  Anything else returns
    ``None``.
    """
    args = module.arguments
    arg_pos = {id(a): i for i, a in enumerate(args)}
    execute = None
    ret = None
    for op in module.body.operations:
        if op.name in ("cim.acquire", "cim.release"):
            continue
        if op.name == "cim.execute":
            if execute is not None:
                return None
            execute = op
            continue
        if op.name == "func.return":
            ret = op
            continue
        return None
    if execute is None or ret is None or len(execute.results) != 2:
        return None
    if [id(v) for v in ret.operands] != [id(r) for r in execute.results]:
        return None

    body = execute.body_ops()
    names = {op.name for op in body} - {"cim.yield"}
    if names and names <= _SIM_OPS and len(body) == 2:
        sim = body[0]
        yld = body[1]
        if yld.name != "cim.yield" or \
                [id(v) for v in yld.operands] != [id(r) for r in sim.results]:
            return None
        if len(sim.operands) not in (2, 3):
            return None
        q, p = sim.operands[0], sim.operands[1]
        care = sim.operands[2] if len(sim.operands) == 3 else None
        if any(id(v) not in arg_pos for v in sim.operands):
            return None
        a = sim.attributes
        if care is not None and a["metric"] != "hamming":
            return None     # TCAM wildcards only exist for hamming search
        n, dim = p.type.shape[-2], p.type.shape[-1]
        tr = int(a.get("tile_rows", 0)) or n
        dpt = int(a.get("dims_per_tile", 0)) or dim
        gr = int(a.get("grid_rows", 0)) or -(-n // tr)
        gc = int(a.get("grid_cols", 0)) or -(-dim // dpt)
        m = 1
        for d in q.type.shape[:-1]:
            m *= d
        return SimilaritySpec(
            metric=a["metric"], k=int(a["k"]), largest=bool(a["largest"]),
            tile_rows=tr, dims_per_tile=dpt, grid_rows=gr, grid_cols=gc,
            m=m, n=n, dim=dim,
            query_arg=arg_pos[id(q)], pattern_arg=arg_pos[id(p)],
            out_v_shape=tuple(sim.results[0].type.shape),
            out_i_shape=tuple(sim.results[1].type.shape),
            care_arg=None if care is None else arg_pos[id(care)],
            in_dtypes=tuple(v.type.dtype for v in sim.operands))

    if names and names <= _TILE_OPS:
        return _spec_from_unrolled(body, arg_pos)
    return None


def _spec_from_unrolled(body, arg_pos) -> Optional[SimilaritySpec]:
    """Reconstruct the spec from explicit Fig.-5d tile ops."""
    searches = [op for op in body if op.name == "cim.search_tile"]
    topks = [op for op in body if op.name == "cim.topk_tile"]
    reshapes = [op for op in body if op.name == "cim.reshape_result"]
    yields = [op for op in body if op.name == "cim.yield"]
    if not searches or not topks or len(reshapes) != 1 or len(yields) != 1:
        return None
    fin, yld = reshapes[0], yields[0]
    if [id(v) for v in yld.operands] != [id(r) for r in fin.results]:
        return None
    first = searches[0]
    q, p = first.operands
    if id(q) not in arg_pos or id(p) not in arg_pos:
        return None
    for st in searches:
        if [id(v) for v in st.operands] != [id(q), id(p)]:
            return None
    sa = first.attributes
    metric = sa["metric"]
    phys_largest = bool(sa.get("phys_largest", False))
    largest = (not phys_largest) if metric in ("dot", "cos") else phys_largest
    gr = 1 + max(int(op.attributes["row_tile"]) for op in searches)
    gc = 1 + max(int(op.attributes["col_tile"]) for op in searches)
    if len(searches) != gr * gc or len(topks) != gr:
        return None
    n, dim = p.type.shape[-2], p.type.shape[-1]
    fa = fin.attributes
    return SimilaritySpec(
        metric=metric, k=int(fa["k"]), largest=largest,
        tile_rows=int(sa["tile_rows"]), dims_per_tile=int(sa["dims_per_tile"]),
        grid_rows=gr, grid_cols=gc, m=int(fa["m"]), n=n, dim=dim,
        query_arg=arg_pos[id(q)], pattern_arg=arg_pos[id(p)],
        out_v_shape=tuple(fin.results[0].type.shape),
        out_i_shape=tuple(fin.results[1].type.shape),
        in_dtypes=(q.type.dtype, p.type.dtype))


def extract_range_spec(module: Module) -> Optional[RangeSpec]:
    """Return the spec if ``module`` is a pure range-search program.

    Accepted shape mirrors :func:`extract_plan_spec` with a single
    ``cim.range_search`` / ``cim.tiled_range_search`` (one ``i1``
    result) in the execute body, operands fed straight from module
    arguments.  Anything else returns ``None``.
    """
    args = module.arguments
    arg_pos = {id(a): i for i, a in enumerate(args)}
    execute = None
    ret = None
    for op in module.body.operations:
        if op.name in ("cim.acquire", "cim.release"):
            continue
        if op.name == "cim.execute":
            if execute is not None:
                return None
            execute = op
            continue
        if op.name == "func.return":
            ret = op
            continue
        return None
    if execute is None or ret is None or len(execute.results) != 1:
        return None
    if [id(v) for v in ret.operands] != [id(r) for r in execute.results]:
        return None

    body = execute.body_ops()
    if len(body) != 2:
        return None
    rs, yld = body
    if rs.name not in _RANGE_OPS or yld.name != "cim.yield":
        return None
    if [id(v) for v in yld.operands] != [id(r) for r in rs.results]:
        return None
    if any(id(v) not in arg_pos for v in rs.operands):
        return None
    a = rs.attributes
    mode = a.get("mode", "threshold")
    if mode == "interval":
        if len(rs.operands) != 3:
            return None
        metric = "interval"
    else:
        if len(rs.operands) != 2 or "metric" not in a:
            return None
        metric = a["metric"]
    q = rs.operands[0]
    stored = rs.operands[1]
    n, dim = stored.type.shape[-2], stored.type.shape[-1]
    tr = int(a.get("tile_rows", 0)) or n
    dpt = int(a.get("dims_per_tile", 0)) or dim
    gr = int(a.get("grid_rows", 0)) or -(-n // tr)
    gc = int(a.get("grid_cols", 0)) or -(-dim // dpt)
    m = 1
    for d in q.type.shape[:-1]:
        m *= d
    return RangeSpec(
        mode=mode, metric=metric,
        threshold=float(a.get("threshold", 0.0)),
        below=bool(a.get("below", True)),
        tile_rows=tr, dims_per_tile=dpt, grid_rows=gr, grid_cols=gc,
        m=m, n=n, dim=dim,
        query_arg=arg_pos[id(q)],
        pattern_args=tuple(arg_pos[id(v)] for v in rs.operands[1:]),
        out_shape=tuple(rs.results[0].type.shape),
        in_dtypes=tuple(v.type.dtype for v in rs.operands))


def module_for_spec(spec, m: Optional[int] = None) -> Module:
    """Synthesise a ``cim`` module whose extracted spec matches ``spec``.

    Round-trips a plan spec back to IR: a single fused similarity /
    range-search op with the spec's tile geometry injected as op
    attributes (``extract_plan_spec`` / ``extract_range_spec`` read
    ``tile_rows`` / ``dims_per_tile`` off the fused op, so the
    partition pass need not run).  Module arguments are in canonical
    order — query, stored operand(s)[, care] — which is also the
    argument order of every partitioned module in this repo.

    This is what lets the hardening layer compile a *physical* plan
    (replicated/spare rows — a different ``n``) for an existing logical
    spec, and the serving layer rebuild an interpreter-executable module
    for its degraded fallback chain, without keeping the original module
    object around.

    A composite spec (anything exposing a ``flat_spec`` attribute, e.g.
    ``HierarchicalSpec``) synthesises the module of its *flat
    equivalent* — the exact search the composite approximates — which is
    what the serving fallback chain and the hardening layer execute when
    the composite plan itself is unavailable.
    """
    spec = getattr(spec, "flat_spec", spec)
    from ..cim_dialect import (make_acquire, make_execute, make_range_search,
                               make_release, make_similarity, make_yield)
    from ..ir import Builder, TensorType

    m = spec.m if m is None else int(m)
    n, dim = spec.n, spec.dim
    geom = {"tile_rows": spec.tile_rows, "dims_per_tile": spec.dims_per_tile}
    is_range = isinstance(spec, RangeSpec)
    interval = is_range and spec.mode == "interval"
    n_stored = 3 if (interval or getattr(spec, "care_arg", None) is not None) \
        else 2
    arg_types = [TensorType((m, dim))] + \
        [TensorType((n, dim)) for _ in range(n_stored - 1)]
    mod = Module("spec_synth", arg_types)
    b = Builder(mod.body)
    dev = make_acquire(b)
    if is_range:
        out_types = [TensorType((m, n), "i1")]
    else:
        out_types = [TensorType((m, spec.k)), TensorType((m, spec.k), "i32")]
    exe = make_execute(b, dev.result, list(mod.arguments), out_types)
    blk = exe.region().block()
    if interval:
        q_a, lo_a, hi_a = mod.arguments
        op = make_range_search(blk, q_a, lo=lo_a, hi=hi_a, extra_attrs=geom)
    elif is_range:
        q_a, p_a = mod.arguments
        op = make_range_search(blk, q_a, patterns=p_a, metric=spec.metric,
                               threshold=spec.threshold, below=spec.below,
                               extra_attrs=geom)
    else:
        q_a, p_a = mod.arguments[0], mod.arguments[1]
        care_a = mod.arguments[2] if n_stored == 3 else None
        op = make_similarity(blk, q_a, p_a, metric=spec.metric, k=spec.k,
                             largest=spec.largest, care=care_a,
                             extra_attrs=geom)
    make_yield(blk, op.results)
    make_release(b, dev.result)
    b.ret(exe.results)
    return mod
