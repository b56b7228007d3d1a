"""Serving resilience: breaker, fallback chain, locks, degraded dispatch.

The failure-domain machinery :class:`~repro_torch.serving.CamSearchServer`
mixes in:

* :class:`_CircuitBreaker` — closed → open → half-open over the
  primary backend.
* :class:`_InterpreterExecutor` — the last-resort fallback level.
* :class:`_WriterPriorityLock` — reader/writer lock where waiting
  writers block new readers (batch dispatch reads, gallery updates
  write).
* :class:`_ResilienceMixin` — the degraded dispatch walk: retry with
  exponential backoff per level, breaker gating of the primary, and
  the synchronous finalize-failure rescue.

Only a plan on the CPU has a degraded chain: the exact flat search
(below a hierarchical primary), the ``"torch"`` backend (below a
``"cuda"`` primary, whose wrappers run their plain versions there), then
the ``"torch"`` backend unpacked (for packed primaries), then the IR
interpreter.  A plan on the card has no level below it: a
dispatch that fails its retries, or a result that cannot be read, fails
the batch, is counted in ``backend_errors`` and shows in ``health()``,
so no plain version ever answers for a failing kernel.  Every degraded
batch on the CPU is counted too (``degraded_batches``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["_CircuitBreaker", "_InterpreterExecutor",
           "_WriterPriorityLock", "_ResilienceMixin", "MAX_RETRIES",
           "RETRY_BACKOFF_S", "BREAKER_THRESHOLD", "BREAKER_COOLDOWN_S"]

#: extra dispatch attempts per level for a transient failure
MAX_RETRIES = 2
#: backoff before the first retry, doubled for each later one
RETRY_BACKOFF_S = 0.002
#: consecutive primary failures that open the breaker
BREAKER_THRESHOLD = 3
#: how long an open breaker keeps batches off the primary (CPU plans)
BREAKER_COOLDOWN_S = 0.1


def _to_host(out):
    """A finalized result as host numpy (a tensor, or a tuple of them).

    The device-to-host copy is where a failing kernel launch surfaces, so
    callers make it inside the ``try`` that guards ``finalize``.
    """
    if isinstance(out, tuple):
        return tuple(_to_host(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


class _CircuitBreaker:
    """Closed → open → half-open circuit breaker over the primary backend.

    ``threshold`` consecutive primary failures trip the breaker
    **open**; while open, batches go straight to the degraded chain.
    After ``cooldown`` seconds the next batch runs as a **half-open**
    probe against the primary: success closes the breaker, failure
    re-opens it (and restarts the cooldown).
    """

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown_s)
        self.state = "closed"
        self.consecutive = 0
        self.trips = 0
        self.probes = 0
        self.recoveries = 0
        self._opened_at = 0.0
        self._lock = threading.Lock()

    def allow_primary(self) -> bool:
        with self._lock:
            if self.state == "closed":
                return True
            if time.perf_counter() - self._opened_at >= self.cooldown:
                self.state = "half-open"
                self.probes += 1
                return True
            return False

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive += 1
            if self.state == "half-open" or \
                    self.consecutive >= self.threshold:
                if self.state != "open":
                    self.trips += 1
                self.state = "open"
                self._opened_at = time.perf_counter()

    def record_success(self) -> None:
        with self._lock:
            self.consecutive = 0
            if self.state != "closed":
                self.state = "closed"
                self.recoveries += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self.state, "threshold": self.threshold,
                    "consecutive_failures": self.consecutive,
                    "trips": self.trips, "probes": self.probes,
                    "recoveries": self.recoveries,
                    "cooldown_ms": 1e3 * self.cooldown}


class _InterpreterExecutor:
    """Last-resort fallback level: the IR interpreter.

    Synthesises a fused module for the plan's spec
    (:func:`~repro_torch.core.engine.module_for_spec`) and executes it
    with :func:`~repro_torch.core.executor.execute_module` (eager torch,
    no kernel) on the plan's device, chunked to the traced query count.
    Slow, but it depends on no compiled level at all — when every
    compiled level is failing, correctness-over-latency is the only
    remaining contract.  Fault models corrupt the stored operands here
    exactly like the compiled levels, so the degraded results match.
    """

    backend = "interpreter"

    def __init__(self, spec, device):
        from ..core.engine import RangeSpec, module_for_spec
        self.spec = spec
        self.device = device
        self.is_range = isinstance(spec, RangeSpec)
        self._module = module_for_spec(spec)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(torch.float32)

    def dispatch(self, *inputs, faults=None):
        from ..core.engine.base import _host
        from ..core.executor import execute_module
        spec = self.spec
        rows = self._tensor(inputs[spec.query_arg])
        if self.is_range:
            stored = tuple(inputs[i] for i in spec.pattern_args)
        else:
            stored = (inputs[spec.pattern_arg],)
            if spec.care_arg is not None:
                stored += (inputs[spec.care_arg],)
        if faults is not None and not faults.is_null:
            stored = faults.corrupt_stored(
                tuple(_host(s).astype(np.float32) for s in stored), spec)
        stored = tuple(self._tensor(s) for s in stored)
        m = spec.m
        outs = []
        with torch.no_grad():
            for s in range(0, rows.shape[0], m):
                chunk = rows[s:s + m]
                valid = chunk.shape[0]
                if valid < m:    # pad the ragged tail to the traced shape
                    chunk = torch.cat([chunk, chunk.new_zeros(
                        (m - valid, chunk.shape[1]))])
                res = execute_module(self._module, chunk, *stored,
                                     device=self.device)
                outs.append((res, valid))
        return outs

    def finalize(self, pending):
        if self.is_range:
            return torch.cat([r[0][:v] for r, v in pending], dim=0)
        return (torch.cat([r[0][:v] for r, v in pending], dim=0),
                torch.cat([r[1][:v] for r, v in pending], dim=0))


class _WriterPriorityLock:
    """A reader/writer lock where waiting writers block new readers.

    The batcher takes the read side around every batch dispatch (many
    batches may overlap the completion pipeline, but dispatch itself is
    the only point that reads the gallery); ``update_gallery`` takes
    the write side.  Writer priority matters under load: a steady
    request stream keeps the read side continuously busy, and a plain
    RW lock would starve the update forever.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writers_waiting = 0
        self._writing = False

    def acquire_read(self) -> None:
        with self._cond:
            while self._writing or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if not self._readers:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writing or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writing = True

    def release_write(self) -> None:
        with self._cond:
            self._writing = False
            self._cond.notify_all()


class _ResilienceMixin:
    """Degraded dispatch for :class:`~repro.serving.CamSearchServer`.

    Expects the host class to provide ``plan``, ``_stats``
    (:class:`~.telemetry.ServerStats`), ``_breaker``, ``_faults``,
    ``_fault_injector``, ``_fallbacks``, ``_lock``, ``_gallery_lock``
    and ``_inputs_for``.
    """

    def _build_fallbacks(self) -> List[Tuple[str, Any]]:
        """Degraded chain below the primary plan, most- to least-capable:
        the exact flat search ``"torch-flat"`` (for a composite primary)
        → ``"torch"`` (for a ``"cuda"`` primary) → ``"torch"`` unpacked
        (for packed primaries) → IR interpreter, on the CPU only; a plan
        on the card gets none.  Every level is an ordinary plan-cache
        citizen compiled for the same spec/batch.  The reference's
        single-device level (under a sharded primary) waits for sharding
        (ROADMAP Queue A item 5)."""
        if self.plan.device.type != "cpu":
            return []
        from ..core.engine import CompositePlan, get_plan, module_for_spec
        spec = self.plan.spec
        mod = module_for_spec(spec)
        chain: List[Tuple[str, Any]] = []

        def add(name: str, **kw) -> None:
            try:
                p = get_plan(mod, batch=self.plan.batch,
                             device=self.plan.device, **kw)
            except Exception:       # level not buildable here: skip it
                return
            if p is not None and p is not self.plan and \
                    all(p is not e for _, e in chain):
                chain.append((name, p))

        if isinstance(self.plan, CompositePlan):
            # composite primaries degrade to the *exact* flat search
            # first — module_for_spec resolved the flat equivalent above
            add("torch-flat", backend="torch", pack=self.plan.packed)
        if self.plan.backend == "cuda":
            add("torch", backend="torch", pack=self.plan.packed)
        if self.plan.packed:
            add("torch-unpacked", backend="torch", pack=False)
        chain.append(("interpreter",
                      _InterpreterExecutor(spec, self.plan.device)))
        return chain

    def _levels(self) -> List[Tuple[str, Any]]:
        with self._lock:
            if self._fallbacks is None:
                self._fallbacks = self._build_fallbacks()
            fallbacks = self._fallbacks
        return [("primary", self.plan)] + fallbacks

    def _dispatch_resilient(self, rows: np.ndarray) -> Tuple[Any, Any]:
        """Dispatch with retry, breaker, and degraded fallback.

        Walks the level chain (skipping the primary while the breaker
        is open and a level below it exists), giving each level
        :data:`MAX_RETRIES` extra attempts with exponential backoff.
        Returns ``(executor, pending)`` from the first level that accepts
        the dispatch; raises the last error only when *every* level
        failed (on the card the primary is the only one: the breaker
        then reports failures and never diverts).
        """
        levels = self._levels()
        start = 0
        if len(levels) > 1 and not self._breaker.allow_primary():
            start = 1
            self._stats.bump(breaker_skips=1)
        last: Optional[Exception] = None
        for li in range(start, len(levels)):
            name, ex = levels[li]
            primary = li == 0
            for attempt in range(MAX_RETRIES + 1):
                try:
                    if self._fault_injector is not None:
                        self._fault_injector(name)
                    pending = ex.dispatch(*self._inputs_for(ex.spec, rows),
                                          faults=self._faults)
                except Exception as e:          # noqa: BLE001 — retried
                    last = e
                    if primary:
                        self._breaker.record_failure()
                    if attempt < MAX_RETRIES:
                        # one bump: a reader never sees the error
                        # without its retry (or vice versa)
                        self._stats.bump(backend_errors=1, retries=1)
                        time.sleep(RETRY_BACKOFF_S * (2 ** attempt))
                    else:
                        self._stats.bump(backend_errors=1)
                    continue
                if primary:
                    self._breaker.record_success()
                else:
                    self._stats.bump(degraded_batches=1)
                return ex, pending
        raise last if last is not None else RuntimeError("no dispatch level")

    def _rescue(self, batch, rows: np.ndarray, failed: Any):
        """Synchronous finalize-failure recovery in the completion
        thread: re-run the batch through the levels below the one that
        failed (under the gallery read lock, so the retry still sees
        one gallery version).  Returns host results, or ``None`` when
        every level below failed too, or there is none (a plan on the
        card)."""
        levels = self._levels()
        idx = next((i for i, (_, ex) in enumerate(levels)
                    if ex is failed), -1)
        self._gallery_lock.acquire_read()
        try:
            for name, ex in levels[idx + 1:]:
                try:
                    if self._fault_injector is not None:
                        self._fault_injector(name)
                    pending = ex.dispatch(
                        *self._inputs_for(ex.spec, rows),
                        faults=self._faults)
                    out = _to_host(ex.finalize(pending))
                except Exception:           # noqa: BLE001 — next level
                    self._stats.bump(backend_errors=1)
                    continue
                self._stats.bump(degraded_batches=1)
                return out
        finally:
            self._gallery_lock.release_read()
        return None
