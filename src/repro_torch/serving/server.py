"""Continuous-batching CAM search server.

The LM serving loop (:mod:`repro_torch.launch.serve`) batches
*sequences* at decode-step granularity; this module applies the same
idea to CAM similarity search, the paper's actual workload.  Many worker
threads (RPC handlers, classifier shards, HDC encoders) submit small KNN
/ HDC query blocks concurrently; a single batcher thread coalesces
whatever is pending into **plan-sized micro-batches** and drives ONE
cached :class:`~repro_torch.core.engine.SearchPlan` on one device, so
the kernels, the memoised prepared gallery and the device are shared by
every request in the process.

Request lifecycle::

    client thread              batcher thread             completion thread
    -------------              --------------             -----------------
    search(q) ─► queue ───────► drain pending (≤ batch    plan.finalize(...)
      blocks on event           rows, ≤ max_wait linger)  and the copy to the
                                stack rows                host (waits for the
                                plan.dispatch(...) ─────► device), scatter
      results ◄─────────────────────────────────────────  rows to requests,
                                (loops immediately: next  set events, record
                                batch dispatches while the latency
                                device runs the previous)

The batcher never waits for device results: ``plan.dispatch`` enqueues
the micro-batch's kernels on the server's CUDA stream and returns a
``PendingSearch``.  A bounded completion queue hands it to the
completion thread, whose finalize and host copy wait for the device
before scattering rows back to their requests and waking the clients —
host-side batching overlaps device compute, and the bound provides
backpressure when clients outrun the device.  Results handed to
requests are host numpy arrays, as the reference package's are.

Coalescing is row-granular: a request carrying 3 query rows and one
carrying 61 share a 64-row micro-batch; an oversized request simply
spans chunks inside the plan (which micro-batches internally).
Results are identical to calling the plan directly — batching changes
scheduling, never arithmetic.  Query blocks may be numpy arrays or
tensors (a tensor on the plan's device is used where it lies).

Ternary (TCAM wildcard) programs are first-class served workloads:
construct the server with ``care_mask=...`` and every batch carries the
per-pattern wildcard mask alongside the gallery (both memoised behind
the plan's pattern cache).

One stream
----------
Every device operation of the server — the batcher's dispatch, the
completion thread's finalize and copy, and ``update_gallery`` from
whatever thread calls it — runs on one CUDA stream, the one current
where the server was built.  ``update_gallery(donate=True)`` writes the
gallery and its prepared layout in place; stream order is what keeps a
batch dispatched before the update computing on the old gallery.

Live gallery mutation
---------------------
:meth:`CamSearchServer.update_gallery` rewrites stored rows **between
micro-batches** while the server keeps serving: a writer-priority
reader/writer lock covers the batcher's dispatch (reader) and the
update (writer), so every dispatched batch sees exactly one gallery
version — a request's rows are never computed against a half-applied
update — and a pending writer blocks *new* batches rather than starving
behind a steady request stream.  The row rewrite itself is the engine's
incremental :meth:`~repro_torch.core.engine.SearchPlan.update_rows`
path, which is what makes online HDC retraining — misclassified queries
re-bundled into class vectors, then re-served — cheap against live
traffic (see :mod:`repro_torch.hdc`).  :meth:`CamSearchServer.
adopt_gallery` swaps in an externally updated gallery wholesale.

Resilience (deadlines, retries, circuit breaker, degraded mode)
---------------------------------------------------------------
The failure-domain machinery lives in :mod:`repro_torch.serving.
resilience`: per-request deadlines (``REPRO_SERVE_DEADLINE_MS``),
bounded retry with exponential backoff, a circuit breaker over the
primary backend, and — for a plan on the CPU only — a degraded fallback
chain (``"cuda"`` → ``"torch"`` → ``"torch"`` unpacked → IR interpreter)
that serves the same gallery at every level.  A plan on the card has no
fallback: a batch its kernels fail is failed and counted, never answered
by a plain version.  ``health()`` surfaces breaker state, fault-cell
counters and deadline-miss rates; ``snapshot()`` keeps the
throughput/latency counters — both read a **consistent** view of the
stats (see :class:`~repro_torch.serving.telemetry.ServerStats`).

This module is the package's assembly point: the batching loop lives in
:mod:`repro_torch.serving.batcher`, the failure machinery in
:mod:`repro_torch.serving.resilience`, counters/requests in
:mod:`repro_torch.serving.telemetry`.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.compiler import CompiledCamProgram
from ..core.engine import PlanBase, RangePlan
from ..core.envcfg import env_float
from ..obs import trace as _trace
from .batcher import _BatcherMixin
from .resilience import BREAKER_COOLDOWN_S, BREAKER_THRESHOLD, \
    _CircuitBreaker, _ResilienceMixin, _WriterPriorityLock
from .telemetry import SearchRequest, SearchResult, ServerStats

__all__ = ["SearchRequest", "SearchResult", "CamSearchServer"]

#: process-global request/batch id streams shared by every server so
#: ids stay unique inside the shared trace recorder (see _init_state)
_RIDS = itertools.count()
_BATCH_IDS = itertools.count()


def _resolve_plan(program: Any) -> PlanBase:
    """Accept a :class:`CompiledCamProgram` (with an engine plan) or a
    bare plan; reject anything else synchronously."""
    if isinstance(program, CompiledCamProgram):
        plan = program.engine_plan
        if plan is None:
            raise ValueError(
                "program has no engine plan (not a pure similarity "
                "program); the search server needs a SearchPlan")
    elif isinstance(program, PlanBase):
        plan = program
    else:
        raise TypeError(f"expected CompiledCamProgram or an engine "
                        f"plan, got {type(program).__name__}")
    return plan


def _validate_queries(plan: PlanBase, queries):
    """Normalise a query block to ``(rows, dim)`` (numpy, or a tensor
    when given one), rejecting malformed blocks synchronously — one bad
    request must never poison the innocent requests it would have been
    coalesced with."""
    q = queries if isinstance(queries, torch.Tensor) else \
        np.asarray(queries)
    if q.ndim == 1:
        q = q[None, :]
    if q.ndim != 2:
        raise ValueError(f"queries must be (rows, dim), got {q.shape}")
    if q.shape[0] == 0:
        raise ValueError("empty query block")
    dim = plan.spec.dim
    if q.shape[1] != dim:
        raise ValueError(
            f"query feature dimension {q.shape[1]} != plan dim {dim}")
    return q


def _coerce_stored(plan: PlanBase, is_range: bool, gallery: Any):
    """Validate + convert the stored operands to the server's gallery
    attribute: a tensor on the plan's device for best-match plans, a
    tuple of them for range plans (``(lo, hi)`` in interval mode).  A
    tensor already there is kept as it is (its pattern-memo entry
    with it)."""
    def dev(g):
        return torch.as_tensor(g, device=plan.device)

    if is_range:
        n_pats = len(plan.spec.pattern_args)
        if n_pats == 2:           # interval mode: gallery is (lo, hi)
            if not (isinstance(gallery, (tuple, list))
                    and len(gallery) == 2):
                raise ValueError(
                    "interval range plan needs gallery=(lo, hi)")
            stored = tuple(dev(g) for g in gallery)
        else:
            stored = (dev(gallery),)
        for g in stored:
            if tuple(g.shape) != (plan.spec.n, plan.spec.dim):
                raise ValueError(
                    f"stored operand shape {tuple(g.shape)} != plan "
                    f"geometry ({plan.spec.n}, {plan.spec.dim})")
        return stored
    return dev(gallery)


class CamSearchServer(_BatcherMixin, _ResilienceMixin):
    """Row-granular continuous batching over one shared ``SearchPlan``.

    Parameters
    ----------
    program:
        A :class:`CompiledCamProgram` whose ``engine_plan`` is set (any
        pure similarity *or* range program), or a bare
        :class:`SearchPlan` / :class:`RangePlan`.  Range plans make the
        server a match server: each request's result carries the
        boolean ``matches`` rows instead of values/indices — this is
        the decision-forest serving path (one interval row per tree
        branch).
    gallery:
        The stored patterns — or, for an *interval* range plan, the
        ``(lo, hi)`` pair of per-row bound arrays.  Converted to tensors
        on the plan's device once, so the plan's pattern memo is hit by
        every batch.
    care_mask:
        Per-pattern TCAM wildcard mask ``(n, dim)`` — required when the
        plan's program is ternary (a care-mask operand in its spec),
        rejected otherwise.  Non-zero cells are compared, zero cells
        never mismatch; one-shot-learning galleries store the bits the
        class exemplars agree on and wildcard the rest.
    max_wait_ms:
        Linger: how long the batcher waits for more rows after the
        first pending request before launching a partial batch.
    max_batch:
        Rows per coalesced batch; defaults to the plan's micro-batch
        size (anything larger would be re-chunked inside the plan
        anyway).
    max_inflight:
        Bound on dispatched-but-unsynced batches (the completion
        queue); backpressure against clients outrunning the device.
    fault_model:
        Optional :class:`repro_torch.faults.FaultModel` injected into every
        dispatch (all fallback levels included) — the served gallery
        executes with the model's device faults while clients see the
        plan's normal output contract.
    deadline_ms:
        Default per-request deadline (0/None = none;
        ``REPRO_SERVE_DEADLINE_MS`` sets the process default).
        ``submit(..., deadline_ms=...)`` overrides per request.
    fault_injector:
        Test/chaos hook: called as ``fault_injector(level_name)``
        immediately before every dispatch attempt; raising simulates a
        backend failure at that level and exercises the retry /
        breaker / degraded machinery.

    A failed dispatch is retried :data:`~repro_torch.serving.resilience.
    MAX_RETRIES` times per level with exponential backoff.  After
    :data:`~repro_torch.serving.resilience.BREAKER_THRESHOLD`
    consecutive primary failures the breaker opens: a plan on the CPU
    then sends batches straight to its degraded chain until a probe
    after the cooldown succeeds; a plan on the card, which has no chain,
    keeps dispatching to its kernels and the open breaker only reports.
    """

    def __init__(self, program: Any, gallery: np.ndarray, *,
                 care_mask: Optional[np.ndarray] = None,
                 max_wait_ms: float = 2.0, max_batch: Optional[int] = None,
                 max_inflight: int = 4,
                 fault_model: Any = None,
                 deadline_ms: Optional[float] = None,
                 fault_injector: Any = None):
        plan = _resolve_plan(program)
        self.plan = plan
        # the one stream every device operation of the server runs on
        self._stream = torch.cuda.current_stream(plan.device) \
            if plan.device.type == "cuda" else None
        self.is_range = isinstance(plan, RangePlan)
        if self.is_range:
            if care_mask is not None:
                raise ValueError("care_mask only applies to ternary "
                                 "best-match plans, not range plans")
            self.gallery = _coerce_stored(plan, True, gallery)
            self.care = None
        else:
            self.gallery = _coerce_stored(plan, False, gallery)
            if plan.spec.care_arg is not None:
                if care_mask is None:
                    raise ValueError("ternary plan (TCAM wildcard search) "
                                     "needs a care_mask")
                if tuple(np.shape(care_mask)) != (plan.spec.n,
                                                  plan.spec.dim):
                    raise ValueError(
                        f"care_mask shape {tuple(np.shape(care_mask))} != "
                        f"gallery geometry ({plan.spec.n}, {plan.spec.dim})")
                # a device tensor for the same reason as the gallery:
                # the plan's pattern memo keys on the (gallery, care)
                # pair, and as_tensor keeps a tensor already there
                self.care = torch.as_tensor(care_mask, device=plan.device)
            elif care_mask is not None:
                raise ValueError("care_mask given but the plan's program "
                                 "has no care operand (not a ternary "
                                 "search)")
            else:
                self.care = None
        self.max_wait = max_wait_ms / 1e3
        self.max_batch = int(max_batch or plan.batch)
        if fault_model is not None and not hasattr(fault_model, "is_null"):
            raise TypeError(
                "fault_model must be a repro_torch.faults.FaultModel")
        self._faults = None if fault_model is None or fault_model.is_null \
            else fault_model
        self._deadline_s = (env_float("REPRO_SERVE_DEADLINE_MS", 0.0,
                                      min_value=0.0)
                            if deadline_ms is None else float(deadline_ms)
                            ) / 1e3
        self._breaker = _CircuitBreaker(BREAKER_THRESHOLD,
                                        BREAKER_COOLDOWN_S)
        self._fault_injector = fault_injector
        self._fallbacks: Optional[List[Tuple[str, Any]]] = None
        self._init_state(max_inflight)

    def _init_state(self, max_inflight: int) -> None:
        self._queue: "queue.Queue[Optional[SearchRequest]]" = queue.Queue()
        self._completions: "queue.Queue[Optional[Tuple[Any, ...]]]" = \
            queue.Queue(maxsize=max(1, int(max_inflight)))
        # process-global id streams: many servers write into ONE trace
        # recorder, so request/batch ids must be unique across servers
        self._rid = _RIDS
        self._batch_ids = _BATCH_IDS
        self._thread: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self._running = False
        self._accepting = False
        self._lock = threading.Lock()
        # gallery consistency: batch dispatch reads, update_gallery writes
        self._gallery_lock = _WriterPriorityLock()
        self._completer_alive = False
        self._stats = ServerStats(
            "requests", "queries", "batches", "batched_rows", "errors",
            "gallery_updates", "rows_updated", "deadline_misses",
            "backend_errors", "retries", "degraded_batches",
            "breaker_skips")

    def _on_stream(self):
        """Context of the server's one CUDA stream (nothing on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    @property
    def stats(self) -> Dict[str, int]:
        """Consistent copy of the raw counters (one lock acquisition);
        ``snapshot()`` adds derived rates and plan telemetry."""
        return self._stats.view()[0]

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "CamSearchServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._running = True
        self._accepting = True
        self._thread = threading.Thread(target=self._loop,
                                        name="cam-search-batcher", daemon=True)
        self._completer = threading.Thread(target=self._completion_loop,
                                           name="cam-search-completer",
                                           daemon=True)
        self._completer.start()
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        # close the front door under the lock BEFORE the shutdown
        # sentinel: any submit that won its lock race has its request in
        # the queue ahead of the sentinel, so the batcher still serves
        # it; later submits raise instead of enqueueing into a dead queue
        with self._lock:
            self._accepting = False
        self._running = False
        self._queue.put(None)               # wake the batcher
        self._thread.join()
        self._thread = None
        # batcher done: flush the completer.  The sentinel put must not
        # hang when the completion queue is full and the completer is
        # already dead (e.g. it crashed mid-run) — poll instead of block.
        while True:
            try:
                self._completions.put(None, timeout=0.05)
                break
            except queue.Full:
                if not self._completer_alive:
                    break
        self._completer.join()
        self._completer = None
        # a crashed completer strands undelivered batches in the queue;
        # fail them so no waiter blocks forever on a stopped server
        self._drain_completions()

    def _drain_completions(self) -> None:
        while True:
            try:
                item = self._completions.get_nowait()
            except queue.Empty:
                return
            if item is None:
                continue
            for r in item[0]:
                self._fail(r, RuntimeError(
                    "server stopped before completion"))

    def __enter__(self) -> "CamSearchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API --------------------------------------------------------

    def submit(self, queries, *,
               deadline_ms: Optional[float] = None) -> SearchRequest:
        """Enqueue a query block (numpy or a tensor); returns a waitable
        request handle.

        Malformed blocks are rejected here, synchronously.
        ``deadline_ms`` overrides the server's default per-request
        deadline (0 = none for this request).
        """
        q = _validate_queries(self.plan, queries)
        rid = next(self._rid)
        now = time.perf_counter()
        budget = self._deadline_s if deadline_ms is None \
            else float(deadline_ms) / 1e3
        req = SearchRequest(rid=rid, queries=q,
                            deadline=now + budget if budget > 0 else None,
                            result=SearchResult(rid=rid, submitted_at=now))
        req._tspan = _trace.trace_begin(
            "request", "serving", {"rid": rid, "rows": int(q.shape[0])})
        with self._lock:
            if not self._accepting:
                raise RuntimeError("server not started")
            self._queue.put(req)
        return req

    def search(self, queries,
               timeout: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking search: submit + wait, raising the batch's error if
        execution failed.  Thread-safe; this is the worker-thread API.
        Best-match plans only — range plans use :meth:`match`."""
        if self.is_range:
            raise TypeError("range plan: use match() (boolean matches, "
                            "not values/indices)")
        res = self.submit(queries).wait(timeout)
        if res.error is not None:
            raise res.error
        return res.values, res.indices

    def match(self, queries,
              timeout: Optional[float] = None) -> np.ndarray:
        """Blocking range search: the ``(rows, n)`` boolean match matrix
        for this request's query rows (range plans only) — each row of
        a forest gallery flags the tree branches the sample satisfies."""
        if not self.is_range:
            raise TypeError("best-match plan: use search()")
        res = self.submit(queries).wait(timeout)
        if res.error is not None:
            raise res.error
        return res.matches

    def update_gallery(self, indices, new_rows, *,
                       donate: bool = False) -> None:
        """Rewrite stored gallery rows between micro-batches, live.

        ``indices``: row ids to replace; ``new_rows``: ``(len(indices),
        dim)`` replacement rows — for *interval* range plans a
        ``(lo_rows, hi_rows)`` pair.  Applied under the writer side of
        the gallery lock: in-flight batches finish against the old
        gallery, every batch dispatched afterwards sees the new one
        (never a mix), and a pending update blocks new batches instead
        of starving behind steady traffic.  The rewrite itself is the
        plan's incremental :meth:`~repro_torch.core.engine.SearchPlan.
        update_rows` — only the touched rows are re-prepared, so
        online-learning loops can call this at high rate.  It runs on
        the server's stream, whatever thread calls it.

        Thread-safe; raises (synchronously, nothing half-applied) on
        malformed indices/rows.  Ternary servers keep their care mask
        fixed — wildcards describe the program, not the data.

        ``donate=True`` forwards the engine's in-place contract (the
        rows and the prepared layout written in place, no full-gallery
        copy): pass it only when no code outside the server still reads
        the current gallery tensor (e.g. the array handed to the
        constructor was numpy, so the server owns its copy).  Batches
        dispatched before the update still compute on the old rows: their
        kernels precede the writes on the server's stream.
        """
        if self.is_range and len(self.plan.spec.pattern_args) == 2:
            if not (isinstance(new_rows, (tuple, list))
                    and len(new_rows) == 2):
                raise ValueError(
                    "interval range plan needs new_rows=(lo_rows, hi_rows)")
        self._gallery_lock.acquire_write()
        try:
            with self._on_stream():
                self._update_rows(indices, new_rows, donate)
            n_rows = int(np.atleast_1d(np.asarray(indices)).size)
            self._stats.bump(gallery_updates=1, rows_updated=n_rows)
        finally:
            self._gallery_lock.release_write()

    def _update_rows(self, indices, new_rows, donate: bool) -> None:
        if self.is_range:
            multi = len(self.plan.spec.pattern_args) == 2
            stored = self.gallery if multi else self.gallery[0]
            updated = self.plan.update_rows(stored, indices, new_rows,
                                            donate=donate)
            self.gallery = tuple(updated) if multi else (updated,)
        else:
            self.gallery = self.plan.update_rows(
                self.gallery, indices, new_rows, care=self.care,
                donate=donate)

    def adopt_gallery(self, gallery, *, rows_updated: int = 0) -> None:
        """Swap in an externally-updated gallery wholesale.

        The replicated-serving write path: one incremental
        :meth:`~repro_torch.core.engine.SearchPlan.update_rows` against
        a gallery tensor several servers share, then every server adopts
        the same resulting tensor — the plan's pattern memo (seeded once
        by ``update_rows``) serves them all.

        Validated like the constructor's ``gallery`` argument and
        applied under the writer side of the gallery lock (in-flight
        batches finish on the old version; every later batch sees the
        new one).  The care mask is fixed.  ``rows_updated`` is
        telemetry only.
        """
        with self._on_stream():
            stored = _coerce_stored(self.plan, self.is_range, gallery)
        self._gallery_lock.acquire_write()
        try:
            self.gallery = stored
            self._stats.bump(gallery_updates=1,
                             rows_updated=int(rows_updated))
        finally:
            self._gallery_lock.release_write()

    # -- telemetry ---------------------------------------------------------

    def dump_trace(self, path: str) -> str:
        """Write the process-wide execution trace as Chrome-tracing
        JSON (Perfetto-loadable).  The recorder is process-global —
        engine spans land in the same file — so this is a convenience
        mirror of :func:`repro_torch.obs.dump`; tracing must be enabled
        (``REPRO_TRACE=...`` or :func:`repro_torch.obs.enable`)."""
        return _trace.dump(path)

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time stats: throughput-ready counters plus latency
        percentiles (over a bounded recent window) and the mean batch
        fill (rows per launched batch), and the batcher's host time per
        dispatch (``dispatch_p50_ms`` / ``dispatch_p95_ms``).  The
        counters are one consistent view — every related group was
        updated atomically and the whole copy is taken in one lock
        acquisition."""
        out, lat, qw, sv = self._stats.view_windows()
        out["avg_batch_fill"] = (out["batched_rows"] / out["batches"]
                                 if out["batches"] else 0.0)
        out.update(ServerStats.percentiles(lat))
        # end-to-end latency attribution: queue-wait (submit -> batch
        # dispatch) vs service (dispatch -> delivery)
        out.update(ServerStats.percentiles(qw, prefix="queue_wait_"))
        out.update(ServerStats.percentiles(sv, prefix="service_"))
        out.update(ServerStats.percentiles(self._stats.dispatch_window(),
                                           prefix="dispatch_"))
        spec = self.plan.spec
        plan_counters = self.plan.counters()
        out["plan"] = {"batch": self.plan.batch, "shards": self.plan.shards,
                       "backend": self.plan.backend,
                       "device": str(self.plan.device),
                       "packed": self.plan.packed,
                       "family": self.plan.family,
                       "ternary": getattr(spec, "care_arg", None) is not None,
                       "metric": spec.metric,
                       "executions": plan_counters["executions"],
                       "chunks_run": plan_counters["chunks_run"],
                       "row_updates": plan_counters["row_updates"],
                       "row_update_fallbacks":
                           plan_counters["row_update_fallbacks"]}
        if self.is_range:
            out["plan"]["mode"] = spec.mode
        else:
            out["plan"]["k"] = spec.k
        return out

    def health(self) -> Dict[str, Any]:
        """Liveness/degradation endpoint: breaker state, fault-model
        telemetry, deadline-miss rate, and the degraded chain (empty for
        a plan on the card; ``None`` before the first batch).

        ``status`` is ``"ok"`` while the primary backend serves,
        ``"degraded"`` once the breaker is open or any batch has been
        served by a fallback level.
        """
        st, _, qw, sv = self._stats.view_windows()
        with self._lock:
            fallbacks = self._fallbacks
        br = self._breaker.snapshot()
        misses = st["deadline_misses"]
        degraded = br["state"] != "closed" or st["degraded_batches"] > 0
        out: Dict[str, Any] = {
            "status": "degraded" if degraded else "ok",
            "running": self._running,
            "breaker": br,
            "deadline_miss_rate":
                misses / max(1, misses + st["requests"]),
            "deadline_misses": misses,
            "backend_errors": st["backend_errors"],
            "retries": st["retries"],
            "degraded_batches": st["degraded_batches"],
            "breaker_skips": st["breaker_skips"],
            "fallback_levels":
                None if fallbacks is None else [n for n, _ in fallbacks],
            "latency": {**ServerStats.percentiles(qw, prefix="queue_wait_"),
                        **ServerStats.percentiles(sv, prefix="service_")},
        }
        if self._faults is not None:
            spec = self.plan.spec
            out["fault_model"] = {
                "seed": self._faults.seed,
                "p_stuck": self._faults.p_stuck,
                "p_flip": self._faults.p_flip,
                "sigma": self._faults.sigma,
                "drift": self._faults.drift, "t": self._faults.t,
                "epoch": self._faults.epoch,
                "cells": self._faults.cell_fault_counts(
                    (spec.n, spec.dim)),
            }
        return out
