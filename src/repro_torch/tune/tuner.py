"""Search-based plan autotuner: measure candidates, keep the best.

The engine picks tile geometry, micro-batch, packing and shard count by
fixed heuristics (the arch's subarray shape, power-of-two batch
rounding, auto-pack).  This module searches that space empirically,
using the plan machinery itself as the measurement harness: candidate
generation -> measure -> keep the best.

:func:`tune_plan` runs greedy coordinate descent over the knob axes:
each axis is swept holding the others at the current best, and a
candidate only replaces the incumbent when it is both *faster*, by more
than the spread of its own timed executes, and *verified* against the
baseline plan's output (bit-exact for the integer metrics, tolerance
for the float ones — a tuned plan that returns different answers is not
a tuned plan).  The sweep's winner is then timed again against the
baseline, the two interleaved so that neither pays for coming first,
and kept only if it still wins by more than the spread: ``base_s``,
``best_s`` and ``speedup`` are that rematch's, never the order of
measurement.  Every trial is an
ordinary ``get_plan`` build + warm + timed executes, traced as
``tune.trial`` spans, and bounded by ``REPRO_TUNE_TRIALS`` /
``REPRO_TUNE_BUDGET_S``.  A candidate the backend refuses, at build or
at execution, is recorded in the history as an error and never answers
in the baseline's place.

The backends are the port's: ``"cuda"`` (the hand-written kernels; the
default, as ``get_plan``'s) and ``"torch"`` (eager, reference-tiled).
There is no scan to unroll, so ``unroll`` stays 1 and is not an axis
(records still carry ``"unroll": 1``, the reference's keys).  The
``"cuda"`` kernels read the gallery as one block whatever its tile
geometry, so ``"cuda"`` sweeps only ``batch`` and ``pack`` and its
records carry the heuristic ``tile_rows`` / ``dims_per_tile``.

With a persistent store configured (``REPRO_PLAN_STORE``), the winning
config is saved; a later :func:`tune_plan` for the same workload returns
from the store with **zero trials**, and :func:`warm_start_plan` gives
the serving layer the same skip at server construction.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.engine import (PlanBase, RangePlan, RangeSpec, SearchPlan,
                           extract_plan_spec, extract_range_spec, get_plan,
                           module_for_spec)
from ..core.engine.base import _host
from ..core.engine.spec import _PACKABLE_METRICS
from ..core.envcfg import env_float, env_int
from ..launch.mesh import device_count
from ..obs.trace import instant, trace_span, tracer
from .store import active_store

__all__ = ["TuneResult", "tune_plan", "plan_for_config", "warm_start_plan",
           "tune_stats", "reset_tune_stats"]

_LOCK = threading.Lock()
_STATS = {"tunes": 0, "trials": 0, "store_hits": 0, "rejected": 0}


def tune_stats() -> Dict[str, int]:
    """Process-wide tuner counters: completed tunes, measured trials,
    store short-circuits, and correctness-rejected candidates."""
    with _LOCK:
        return dict(_STATS)


def reset_tune_stats() -> None:
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(key: str, n: int = 1) -> None:
    with _LOCK:
        _STATS[key] += n


@dataclass
class TuneResult:
    """Outcome of one :func:`tune_plan` call."""

    plan: PlanBase
    config: Dict[str, Any]
    trials: int
    from_store: bool
    base_s: float = 0.0
    best_s: float = 0.0
    history: List[Dict[str, Any]] = field(default_factory=list, repr=False)

    @property
    def speedup(self) -> float:
        return self.base_s / self.best_s if self.best_s > 0 else 1.0


def _tuned_spec(spec, tile_rows: int, dims_per_tile: int):
    """The spec re-tiled at a candidate geometry (grids re-derived)."""
    tr = max(1, min(int(tile_rows), spec.n))
    dpt = max(1, min(int(dims_per_tile), spec.dim))
    return replace(spec, tile_rows=tr, dims_per_tile=dpt,
                   grid_rows=-(-spec.n // tr), grid_cols=-(-spec.dim // dpt))


def plan_for_config(spec, cfg: Dict[str, Any],
                    device=None) -> Optional[PlanBase]:
    """Build (or cache-hit) the plan a config record describes, on
    ``device`` (``get_plan``'s meaning: ``None`` is the current CUDA
    device)."""
    tuned = _tuned_spec(spec, cfg["tile_rows"], cfg["dims_per_tile"])
    shards = int(cfg.get("shards") or 1)
    return get_plan(module_for_spec(tuned), backend=cfg["backend"],
                    batch=int(cfg["batch"]),
                    shards=None if shards <= 1 else shards,
                    pack=cfg.get("pack"), device=device)


def _config_of(plan: PlanBase, backend: str) -> Dict[str, Any]:
    return {"backend": backend, "tile_rows": plan.spec.tile_rows,
            "dims_per_tile": plan.spec.dims_per_tile,
            "batch": plan.batch, "pack": plan.packed,
            "unroll": 1, "shards": plan.shards}


def _ordered_inputs(spec, inputs: Tuple[Any, ...]) -> Tuple[Any, ...]:
    """Re-wire caller inputs (original module argument order) into the
    canonical order of ``module_for_spec`` modules: query first, stored
    operands after — so one input tuple drives both the baseline plan
    and every re-tiled candidate."""
    if isinstance(spec, RangeSpec):
        pos = (spec.query_arg,) + tuple(spec.pattern_args)
    else:
        pos = (spec.query_arg, spec.pattern_arg)
        if spec.care_arg is not None:
            pos += (spec.care_arg,)
    return tuple(inputs[p] for p in pos)


def _canonical_spec(spec):
    """The spec as ``module_for_spec`` round-trips it (canonical
    argument wiring) — every candidate, including the baseline, is
    built through this so measurements compare geometry, not wiring."""
    mod = module_for_spec(spec)
    out = extract_plan_spec(mod)
    if out is None:
        out = extract_range_spec(mod)
    return out


def _verify(spec, base_out, out) -> bool:
    """Candidate output matches the baseline plan's output.

    Integer-count metrics (hamming / dot / interval violations, packed
    or not) are bit-exact by the engine's numerical contract, and the
    stable merges make top-k indices deterministic across tile geometry.
    Float accumulations (eucl, cos values) may reorder across
    ``dims_per_tile`` (the ``"torch"`` backend's column-tile sums), so
    values are compared at tolerance and near-tie index flips are not
    grounds for rejection.
    """
    exact = spec.metric in ("hamming", "dot", "interval")
    if isinstance(spec, RangeSpec):
        a, b = _host(base_out), _host(out)
        return bool((a == b).all()) if exact else \
            float((a != b).mean()) < 1e-3
    bv, bi = (_host(x) for x in base_out)
    cv, ci = (_host(x) for x in out)
    if exact:
        return bool((bv == cv).all() and (bi == ci).all())
    return bool(np.allclose(bv, cv, rtol=1e-4, atol=1e-4))


def _sync(plan: PlanBase) -> None:
    if plan.device.type == "cuda":
        torch.cuda.synchronize(plan.device)


def _rep_times(plan: PlanBase, inputs: Tuple[Any, ...],
               reps: int) -> List[float]:
    """Host wall times of ``reps`` synchronised executes."""
    times = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        plan.execute(*inputs)
        _sync(plan)
        times.append(time.perf_counter() - t0)
    return times


def _median_spread(times: List[float]) -> Tuple[float, float]:
    return float(np.median(times)), float(max(times) - min(times))


def _measure(plan: PlanBase, inputs: Tuple[Any, ...], reps: int):
    """(median, spread) of ``reps`` synchronised executes' host wall
    times, after one warm-up execute that absorbs the prepare and the
    first launch, and the warm-up's output."""
    out = plan.execute(*inputs)
    _sync(plan)
    return _median_spread(_rep_times(plan, inputs, reps)) + (out,)


def _rematch(base: PlanBase, best: PlanBase, inputs: Tuple[Any, ...],
             reps: int) -> Tuple[float, float, float]:
    """The baseline and the sweep's winner timed again, one execute each
    per round, the order alternating (baseline first in even rounds), so
    that neither pays for being timed first: (baseline median, winner
    median, the larger spread of the two)."""
    times: Dict[bool, List[float]] = {False: [], True: []}
    for r in range(max(1, reps)):
        for is_best in ((False, True) if r % 2 == 0 else (True, False)):
            times[is_best] += _rep_times(best if is_best else base,
                                         inputs, 1)
    base_s, base_spread = _median_spread(times[False])
    best_s, best_spread = _median_spread(times[True])
    return base_s, best_s, max(base_spread, best_spread)


def _axis_values(spec, backend: str, m: int,
                 device: torch.device) -> List[Tuple[str, List[Any]]]:
    """The coordinate-descent axes, clamped to the workload.  The tile
    geometry is an axis of ``"torch"`` only: the ``"cuda"`` executables
    lay the gallery out as one block whatever ``tile_rows`` and
    ``dims_per_tile`` say, so each of those candidates would repeat the
    incumbent's work (and prepare its own copy of the gallery)."""
    n, dim = spec.n, spec.dim
    batches = sorted({min(b, max(8, 2 * m)) for b in (16, 32, 64, 128, 256)})
    axes: List[Tuple[str, List[Any]]] = []
    if backend == "torch":
        axes += [
            ("tile_rows",
             sorted({min(t, n) for t in (16, 32, 64, 128, 256, 512)})),
            ("dims_per_tile",
             sorted({min(d, dim) for d in (32, 64, 128, 256)})),
        ]
    axes.append(("batch", batches))
    if spec.metric in _PACKABLE_METRICS and \
            getattr(spec, "mode", "threshold") != "interval":
        axes.append(("pack", [True, False]))
    count = device_count(device.type)
    if backend == "torch" and count > 1:
        axes.append(("shards", [1, count]))
    return axes


def tune_plan(module, *inputs, backend: str = "cuda",
              trials: Optional[int] = None, reps: Optional[int] = None,
              budget_s: Optional[float] = None,
              store=None, device=None) -> TuneResult:
    """Tune the plan for ``module`` on representative ``inputs``.

    ``inputs`` are the module's concrete arguments (query block +
    stored operands, in the module's own argument order); the query
    block's row count is the workload's ``m`` and what the tuned
    micro-batch is sized against.  They are moved to the plan's device
    once, so every timed execute hits the pattern memo.  Bounds:
    ``trials`` measured candidates (``REPRO_TUNE_TRIALS``), ``reps``
    timed executes per candidate (``REPRO_TUNE_REPS``), ``budget_s``
    wall-clock (``REPRO_TUNE_BUDGET_S``, 0 = unbounded).  ``device`` is
    ``get_plan``'s: ``None`` means the current CUDA device.

    With a store (argument, else ``REPRO_PLAN_STORE``): a stored config
    for this workload short-circuits the whole search (``trials == 0``,
    ``from_store=True``); otherwise the winner's config is written back.
    """
    spec = extract_plan_spec(module)
    if spec is None:
        spec = extract_range_spec(module)
    if spec is None:
        raise ValueError("tune_plan needs a pure similarity/range module "
                         "(the interpreter path has no plan to tune)")
    trials = env_int("REPRO_TUNE_TRIALS", 24, min_value=1) \
        if trials is None else int(trials)
    reps = env_int("REPRO_TUNE_REPS", 3, min_value=1) \
        if reps is None else int(reps)
    budget_s = env_float("REPRO_TUNE_BUDGET_S", 0.0, min_value=0.0) \
        if budget_s is None else float(budget_s)
    store = active_store() if store is None else store
    ordered = _ordered_inputs(spec, inputs)
    spec = _canonical_spec(spec)

    if store is not None:
        cfg = store.load_config(spec, backend)
        if cfg is not None:
            plan = plan_for_config(spec, cfg, device=device)
            if plan is not None:
                _bump("store_hits")
                if tracer.enabled:
                    instant("tune.store_hit", pid="engine",
                            args={"backend": backend})
                plan.warm(*ordered[1:])
                return TuneResult(plan=plan, config=cfg, trials=0,
                                  from_store=True,
                                  base_s=float(cfg.get("base_s", 0.0)),
                                  best_s=float(cfg.get("best_s", 0.0)))

    t_start = time.perf_counter()
    m = int(np.prod(tuple(ordered[0].shape)[:-1]))

    def out_of_budget() -> bool:
        return budget_s > 0 and time.perf_counter() - t_start > budget_s

    base_plan = get_plan(module_for_spec(spec), backend=backend,
                         device=device)
    dev = base_plan.device
    ordered = (torch.as_tensor(ordered[0], device=dev),) + \
        base_plan.warm(*ordered[1:])
    with trace_span("tune.baseline", pid="engine",
                    args=None if not tracer.enabled else
                    {"backend": backend, "n": spec.n, "dim": spec.dim}):
        base_s, _, base_out = _measure(base_plan, ordered, reps)

    best = _config_of(base_plan, backend)
    best_plan, best_s = base_plan, base_s
    history = [dict(best, wall_s=base_s, baseline=True)]
    used = 0
    for axis, values in _axis_values(spec, backend, m, dev):
        for v in values:
            if used >= trials or out_of_budget():
                break
            if best.get(axis) == v:
                continue
            cfg = dict(best)
            cfg[axis] = v
            try:
                plan = plan_for_config(spec, cfg, device=dev)
            except ValueError as e:
                # a knob the backend refuses (pack=False on a ternary
                # "cuda" plan, pack=True on a "cuda" range plan)
                history.append(dict(cfg, wall_s=None, error=True,
                                    reason=str(e)))
                continue
            if plan is None or plan is best_plan:
                continue
            used += 1
            _bump("trials")
            with trace_span("tune.trial", pid="engine",
                            args=None if not tracer.enabled else
                            {"axis": axis, "value": repr(v)}):
                try:
                    cand_s, spread, out = _measure(plan, ordered, reps)
                except Exception as e:  # noqa: BLE001 — never a winner
                    history.append(dict(cfg, wall_s=None, error=True,
                                        reason=repr(e)))
                    continue
            ok = _verify(spec, base_out, out)
            if not ok:
                _bump("rejected")
            history.append(dict(cfg, wall_s=cand_s, verified=ok))
            if ok and cand_s + spread < best_s:
                best, best_plan, best_s = _config_of(plan, backend), \
                    plan, cand_s

    if best_plan is not base_plan:
        with trace_span("tune.rematch", pid="engine"):
            base_s, best_s, spread = _rematch(base_plan, best_plan, ordered,
                                              reps)
        if not best_s + spread < base_s:
            best = _config_of(base_plan, backend)
            best_plan, best_s = base_plan, base_s
    _bump("tunes")
    best = dict(best, base_s=base_s, best_s=best_s, trials=used,
                speedup=base_s / best_s if best_s > 0 else 1.0)
    if tracer.enabled:
        instant("tune.winner", pid="engine",
                args={k: best[k] for k in ("tile_rows", "batch", "unroll",
                                           "speedup")})
    if store is not None:
        store.save_config(spec, backend, best)
        store.persist_executables(best_plan)
    return TuneResult(plan=best_plan, config=best, trials=used,
                      from_store=False, base_s=base_s, best_s=best_s,
                      history=history)


def warm_start_plan(plan: PlanBase) -> PlanBase:
    """The serving cold-start hook: swap a heuristically-built leaf plan
    for its stored tuned equivalent, when one exists, on the plan's own
    device.

    No store configured, no config recorded, a composite plan, or an
    explicitly sharded plan (the caller chose a topology) → the plan
    comes back unchanged.
    """
    if not isinstance(plan, (SearchPlan, RangePlan)) or plan.shards > 1:
        return plan
    store = active_store()
    if store is None:
        return plan
    cfg = store.load_config(plan.spec, plan.backend)
    if cfg is None:
        return plan
    tuned = plan_for_config(plan.spec, cfg, device=plan.device)
    return plan if tuned is None else tuned
