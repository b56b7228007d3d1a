"""Serving batcher: coalescing loop + async completion pipeline.

:class:`_BatcherMixin` owns the two server threads — the batcher
(drain pending requests into plan-sized micro-batches, dispatch) and
the completer (finalize the device results, copy them to the host,
scatter rows back to requests) — plus the failure paths that settle a
request.  Mixed into :class:`~repro_torch.serving.CamSearchServer`;
expects the host class to provide ``plan``, ``gallery``, ``care``,
``is_range``, ``max_batch``, ``max_wait``, ``_queue``, ``_completions``,
``_gallery_lock``, ``_stats``, ``_breaker``, ``_completer_alive``,
``_running``, ``_on_stream`` and the resilience mixin's
``_dispatch_resilient`` / ``_rescue``.

Both threads run their device work inside ``_on_stream()``, the server's
one CUDA stream: a batch's kernels are enqueued before any later
``update_gallery`` writes, in stream order, so an in-place update never
reaches a batch already dispatched.
"""

from __future__ import annotations

import queue
import time
from typing import Any, List, Sequence, Tuple

import numpy as np

import torch

from ..obs.trace import trace_begin, trace_span, tracer
from .resilience import _to_host
from .telemetry import SearchRequest

__all__ = ["_BatcherMixin"]


class _BatcherMixin:
    """Batching/completion thread bodies for the search server."""

    def _drain(self, first: SearchRequest) -> List[SearchRequest]:
        """Coalesce pending requests after ``first`` into one batch:
        up to ``max_batch`` rows, lingering at most ``max_wait``."""
        fill = trace_begin("batch.fill", "serving")
        batch = [first]
        rows = first.queries.shape[0]
        deadline = time.perf_counter() + self.max_wait
        while rows < self.max_batch:
            remaining = deadline - time.perf_counter()
            try:
                req = self._queue.get(
                    timeout=max(remaining, 0) if remaining > 0 else None,
                    block=remaining > 0)
            except queue.Empty:
                break
            if req is None:                 # shutdown sentinel
                self._queue.put(None)       # leave it for the main loop
                break
            batch.append(req)
            rows += req.queries.shape[0]
        if fill is not None:
            fill.end({"rows": int(rows), "requests": len(batch)})
        return batch

    def _loop(self) -> None:
        while True:
            req = self._queue.get()
            if req is None:
                if self._running:
                    continue                # stray sentinel from a drain
                break
            batch = self._drain(req)
            with self._on_stream():
                self._execute_batch(batch)
        # drain anything left after shutdown so no client blocks forever
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                self._fail(req, RuntimeError("server stopped"))

    def _inputs_for(self, spec, rows: np.ndarray) -> List[Any]:
        """Module-argument list for one executor's spec (fallback levels
        may order arguments differently from the primary plan)."""
        if self.is_range:
            n_args = max(spec.query_arg, *spec.pattern_args) + 1
            inputs: List[Any] = [None] * n_args
            inputs[spec.query_arg] = rows
            for pos, g in zip(spec.pattern_args, self.gallery):
                inputs[pos] = g
        else:
            n_args = max(spec.query_arg, spec.pattern_arg,
                         -1 if spec.care_arg is None
                         else spec.care_arg) + 1
            inputs = [None] * n_args
            inputs[spec.query_arg] = rows
            inputs[spec.pattern_arg] = self.gallery
            if spec.care_arg is not None:
                inputs[spec.care_arg] = self.care
        return inputs

    def _batch_rows(self, batch: Sequence[SearchRequest]):
        """The batch's query rows stacked in request order: numpy when
        every request carried host rows, else one tensor on the plan's
        device."""
        qs = [r.queries for r in batch]
        if not any(isinstance(q, torch.Tensor) for q in qs):
            return np.concatenate(qs, axis=0)
        dev = self.plan.device
        return torch.cat([torch.as_tensor(q, device=dev) for q in qs], dim=0)

    def _execute_batch(self, batch: Sequence[SearchRequest]) -> None:
        """Dispatch one coalesced batch; the pending device result goes
        to the completion thread, so the batcher is free to coalesce and
        dispatch the next batch while the device still runs this one."""
        # expire dead-on-arrival requests first: a missed deadline costs
        # a TimeoutError, never the rest of the batch's slot
        now = time.perf_counter()
        live = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                self._fail_timeout(r)
            else:
                live.append(r)
        if not live:
            return
        batch = live
        bid = next(self._batch_ids)
        # reader side of the gallery lock: the whole read-gallery +
        # dispatch sequence sees exactly one gallery version, and a
        # waiting update_gallery writer gets in before the *next* batch
        self._gallery_lock.acquire_read()
        try:
            with trace_span("batch.dispatch", "serving",
                            args=None if not tracer.enabled else
                            {"batch": bid, "requests": len(batch)}):
                t0 = time.perf_counter()
                rows = self._batch_rows(batch)
                executor, pending = self._dispatch_resilient(rows)
                dispatch_s = time.perf_counter() - t0
            err = None
        except Exception as e:              # noqa: BLE001 — fanned out
            err = e
        finally:
            self._gallery_lock.release_read()
        if err is not None:
            # failed OUTSIDE the lock: _fail settles the request, which
            # fires done-callbacks synchronously — a gateway callback
            # takes its replica-set routing lock, whose write side
            # (fan_out) may in turn be waiting on OUR gallery write
            # lock.  Settling under the read lock closes that cycle
            # into a deadlock.
            for r in batch:
                self._fail(r, err)
            return
        now = time.perf_counter()
        for r in batch:
            r.result.dispatched_at = now
            if r._tspan is not None:
                # closes the queue-wait window: submit -> this dispatch
                r._tspan.lap("request.queue_wait", {"batch": bid})
        self._stats.bump(_dispatch_s=dispatch_s, batches=1,
                         batched_rows=rows.shape[0])
        self._put_completion((batch, executor, pending, rows, bid))

    def _put_completion(self, item: Tuple[Any, ...]) -> None:
        """Backpressured hand-off that cannot hang shutdown: the put
        polls so a dead completion thread fails the batch instead of
        blocking the batcher (and therefore ``stop()``) forever."""
        while True:
            try:
                self._completions.put(item, timeout=0.05)
                return
            except queue.Full:
                if not self._completer_alive:
                    for r in item[0]:
                        self._fail(r, RuntimeError(
                            "completion thread is not running"))
                    return

    def _completion_loop(self) -> None:
        self._completer_alive = True
        try:
            while True:
                item = self._completions.get()
                if item is None:
                    break
                with self._on_stream():
                    self._complete_one(item)
        finally:
            self._completer_alive = False

    def _complete_one(self, item: Tuple[Any, ...]) -> None:
        batch, executor, pending, rows_arr, bid = item
        rows = rows_arr.shape[0]
        try:
            with trace_span("batch.finalize", "serving",
                            args=None if not tracer.enabled else
                            {"batch": bid, "rows": rows}):
                # the host copy is inside the try: a failing kernel
                # launch surfaces there, and the rescue must see it
                out = _to_host(executor.finalize(pending))
        except Exception as e:              # noqa: BLE001 — rescued
            if executor is self.plan:
                self._breaker.record_failure()
            self._stats.bump(backend_errors=1)
            out = self._rescue(batch, rows_arr, executor)
            if out is None:
                for r in batch:
                    self._fail(r, e)
                return
        if self.is_range:
            matches = out.reshape(rows, -1)
            values = indices = None
        else:
            values, indices = out
            # finalize shapes outputs for the *compiled module* (which
            # may have been traced with 1-D or stacked queries); the
            # scatter below is strictly row-major
            values = values.reshape(rows, -1)
            indices = indices.reshape(rows, -1)
        now = time.perf_counter()
        off = 0
        for r in batch:
            m = r.queries.shape[0]
            if r.deadline is not None and now > r.deadline:
                # result arrived, but past the budget: a miss, not a
                # late delivery the client already gave up on
                off += m
                self._fail_timeout(r)
                continue
            if self.is_range:
                r.result.matches = matches[off:off + m]
            else:
                r.result.values = values[off:off + m]
                r.result.indices = indices[off:off + m]
            r.result.completed_at = now
            off += m
            # one bump per delivered request: a snapshot can never see
            # the request counted without its rows and latency sample
            self._stats.bump(_latency_s=r.result.latency_s,
                             _queue_s=r.result.queue_wait_s,
                             _service_s=r.result.service_s,
                             requests=1, queries=m)
            if r._tspan is not None:
                # dispatch -> delivery window, then the whole request
                r._tspan.lap("request.service", {"batch": bid})
                r._tspan.end()
            r._settle()

    def _fail(self, req: SearchRequest, err: BaseException) -> None:
        req.result.error = err
        req.result.completed_at = time.perf_counter()
        self._stats.bump(errors=1)
        if req._tspan is not None:
            req._tspan.end({"error": type(err).__name__})
        req._settle()

    def _fail_timeout(self, req: SearchRequest) -> None:
        req.result.error = TimeoutError(
            f"request {req.rid} missed its deadline")
        req.result.completed_at = time.perf_counter()
        self._stats.bump(deadline_misses=1)
        if req._tspan is not None:
            req._tspan.end({"error": "TimeoutError"})
        req._settle()
