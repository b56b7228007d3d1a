"""The process-wide plan cache and its public entry point, ``get_plan``.

Keys are ``(spec, backend, batch, shards, packed, unroll, device)`` —
the reference's key plus the device the plan's prepared operands live
on.  ``shards`` and ``unroll`` are always 1: sharded plans are not
ported, and eager PyTorch has no scan to unroll.  The spec is a frozen
dataclass — :class:`~.spec.SimilaritySpec`, :class:`~.spec.RangeSpec`
or :class:`~.composite.HierarchicalSpec` — so keys of different
families never collide.  Recompiling the same program, or a different
program with identical structure (what a DSE sweep over optimization
targets produces), returns the *same* plan object.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from ...obs.trace import trace_span, tracer
from ..envcfg import env_int
from ..ir import Module
from .base import PlanBase, _pick_batch, resolve_device
from .executables import (_build_cuda_executable,
                          _build_range_cuda_executable,
                          _build_range_scan_executable, _build_scan_executable,
                          _build_tiny_executable,
                          _build_tiny_range_executable)
from .plans import RangePlan, SearchPlan
from .spec import RangeSpec, _resolve_pack, extract_plan_spec, \
    extract_range_spec

#: the port's backends: eager reference-tiled, and the CUDA kernels
BACKENDS = ("torch", "cuda")

_PLAN_CACHE: "OrderedDict[Tuple, PlanBase]" = OrderedDict()
#: LRU bound — a DSE sweep over many distinct geometries must not pin
#: every plan (and its memoised galleries) forever
_MAX_PLANS = 64
_CACHE_LOCK = threading.Lock()
#: pattern_* entries retain the pattern-memo counters of plans evicted
#: from the LRU, keeping plan_cache_stats() monotonic across evictions
_STATS = {"hits": 0, "misses": 0,
          "pattern_hits": 0, "pattern_misses": 0, "pattern_evictions": 0}


def _retire_plan(plan: PlanBase) -> None:
    """Fold an evicted plan's pattern counters (net of what earlier
    retirements folded) into the retained stats.  Caller holds
    ``_CACHE_LOCK``; lock order ``_CACHE_LOCK`` -> ``_pattern_lock``."""
    with plan._pattern_lock:
        _STATS["pattern_hits"] += plan.pattern_hits - plan._retired_hits
        _STATS["pattern_misses"] += plan.pattern_misses - plan._retired_misses
        _STATS["pattern_evictions"] += \
            plan.pattern_evictions - plan._retired_evictions
        plan._retired_hits = plan.pattern_hits
        plan._retired_misses = plan.pattern_misses
        plan._retired_evictions = plan.pattern_evictions


def _cache_lookup(key: Tuple) -> Optional[PlanBase]:
    with _CACHE_LOCK:
        plan = _PLAN_CACHE.get(key)
        if plan is not None:
            _STATS["hits"] += 1
            _PLAN_CACHE.move_to_end(key)
            return plan
        _STATS["misses"] += 1
    return None


def _cache_insert(key: Tuple, plan: PlanBase) -> PlanBase:
    with _CACHE_LOCK:
        # lost-race double insert is harmless but keep one canonical plan
        plan = _PLAN_CACHE.setdefault(key, plan)
        _PLAN_CACHE.move_to_end(key)
        while len(_PLAN_CACHE) > _MAX_PLANS:
            _, evicted = _PLAN_CACHE.popitem(last=False)
            _retire_plan(evicted)
    return plan


def _lookup_or_insert(key: Tuple, build: Callable[[], PlanBase]) -> PlanBase:
    """Shared cache participation for plan factories outside this module
    (the hierarchical family): counted lookup, build on a miss, canonical
    insert with the same LRU and race semantics as ``get_plan``."""
    plan = _cache_lookup(key)
    if plan is not None:
        return plan
    with trace_span("plan.compile",
                    args=None if not tracer.enabled else
                    {"key": repr(key[1:])}):
        built = build()
    return _cache_insert(key, built)


def _tiny_plan(spec, backend: str, shards: int) -> bool:
    """Small-program fast path eligibility: a single column tile, the
    ``"torch"`` backend, no sharding, and at most
    ``REPRO_ENGINE_TINY_CELLS`` physical cells (``0`` disables it)."""
    if backend != "torch" or shards != 1 or spec.grid_cols != 1:
        return False
    cells = spec.grid_rows * spec.tile_rows * spec.dim
    return cells <= env_int("REPRO_ENGINE_TINY_CELLS", 32768, min_value=0)


def get_plan(module: Module, *, backend: str = "cuda",
             batch: Optional[int] = None,
             shards: Optional[int] = None,
             pack: Optional[bool] = None,
             device=None) -> Optional[PlanBase]:
    """Plan for a partitioned module, from the cache when possible.

    ``backend``: ``"cuda"`` (the hand-written kernels; on CPU tensors
    their plain versions) or ``"torch"`` (eager reference-tiled).
    ``pack``: ``None`` auto-packs binary/bipolar metrics, ``False``
    forces the float path, ``True`` on an analog metric raises.
    ``device``: where the prepared gallery lives and results are
    returned; ``None`` means the current CUDA device, and raises when
    CUDA is absent (pass ``device="cpu"`` to run on the CPU).

    Range programs (:class:`~.spec.RangeSpec`) get a
    :class:`~.plans.RangePlan`.  The ``"cuda"`` range kernels take float
    cells, so ``pack=None`` there runs the float path and ``pack=True``
    raises; the ``"torch"`` backend packs binary/bipolar range programs
    as it does searches.

    Returns ``None`` when the module is neither a pure similarity nor a
    pure range program.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if shards is not None and shards > 1:
        raise NotImplementedError(
            "sharded plans are not ported to repro_torch yet")
    try:
        spec = extract_plan_spec(module)
        if spec is None:
            spec = extract_range_spec(module)
    except Exception:       # malformed/exotic IR: no engine plan
        spec = None
    if spec is None:
        return None
    is_range = isinstance(spec, RangeSpec)
    packed = _resolve_pack(spec, pack)
    if is_range and backend == "cuda" and packed:
        # the range kernels take float cells; the packed popcount range
        # path lives in the "torch" executable
        if pack:
            raise ValueError(
                "packed range search requires the 'torch' backend")
        packed = False
    if getattr(spec, "care_arg", None) is not None and not packed \
            and backend == "cuda":
        raise ValueError(
            "ternary (care-masked) search on the cuda backend requires "
            "packed execution; pass pack=True (and unset "
            "REPRO_ENGINE_PACK=off if the kill switch disabled auto-pack)")
    dev = resolve_device(device)
    b = batch or _pick_batch(spec.m)
    key = (spec, backend, b, 1, packed, 1, str(dev))
    plan = _cache_lookup(key)
    if plan is not None:
        return plan
    tiny = _tiny_plan(spec, backend, 1)
    with trace_span("plan.compile",
                    args=None if not tracer.enabled else
                    {"family": "range" if is_range else "search",
                     "backend": backend, "batch": b, "shards": 1,
                     "packed": packed, "device": str(dev)}):
        if is_range:
            if backend == "cuda":
                prepare, chunk_fn, row_update = \
                    _build_range_cuda_executable(spec, b)
            elif tiny:
                prepare, chunk_fn, row_update = \
                    _build_tiny_range_executable(spec, b, packed)
            else:
                prepare, chunk_fn, row_update = \
                    _build_range_scan_executable(spec, b, packed)
        elif backend == "cuda":
            prepare, chunk_fn, row_update = _build_cuda_executable(spec, b,
                                                                   packed)
        elif tiny:
            prepare, chunk_fn, row_update = _build_tiny_executable(spec, b,
                                                                   packed)
        else:
            prepare, chunk_fn, row_update = _build_scan_executable(spec, b,
                                                                   packed)
        cls = RangePlan if is_range else SearchPlan
        plan = cls(spec=spec, backend=backend, batch=b, device=dev,
                   packed=packed, tiny=tiny,
                   _prepare=prepare, _chunk_fn=chunk_fn,
                   _row_update=row_update)
    return _cache_insert(key, plan)


def plan_cache_stats() -> Dict[str, int]:
    """Process-wide cache counters: plan cache hits / misses / live
    plans, plus the pattern-memo counters summed over live plans and the
    retained totals of evicted ones."""
    with _CACHE_LOCK:
        out = {"hits": _STATS["hits"], "misses": _STATS["misses"],
               "plans": len(_PLAN_CACHE)}
        ph = _STATS["pattern_hits"]
        pm = _STATS["pattern_misses"]
        pe = _STATS["pattern_evictions"]
        for p in _PLAN_CACHE.values():
            with p._pattern_lock:
                ph += p.pattern_hits - p._retired_hits
                pm += p.pattern_misses - p._retired_misses
                pe += p.pattern_evictions - p._retired_evictions
    out.update(pattern_hits=ph, pattern_misses=pm, pattern_evictions=pe)
    return out


def clear_plan_cache() -> None:
    with _CACHE_LOCK:
        _PLAN_CACHE.clear()
        for k in _STATS:
            _STATS[k] = 0
