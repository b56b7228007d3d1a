"""Serving telemetry: consistent stats and request/result containers.

``ServerStats`` is the one place serving counters live.  Everything a
counter group mutates together is applied in **one** lock acquisition
(:meth:`ServerStats.bump`), and every read (:meth:`ServerStats.view`)
copies the whole group under the same lock — so ``snapshot()`` /
``health()`` can never observe half of a related update (e.g. a
completed request whose latency sample has not landed yet, or a
backend error whose retry counter is still behind).  The historical
failure mode was exactly that: each ``stats[k] += 1`` took its own
lock acquisition, so concurrent readers saw mid-mutation states.

``SearchRequest`` doubles as a one-shot future: ``wait()`` blocks,
``add_done_callback`` runs a function the moment the request settles
(already-settled requests run it immediately in the caller's thread).
The reference's multi-tenant gateway rides the callbacks to fail
requests over to another replica without parking a thread per in-flight
request.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ServerStats", "SearchResult", "SearchRequest"]


class ServerStats:
    """A named group of counters with atomic multi-key updates.

    ``bump(a=1, b=rows)`` applies every delta (and an optional latency
    sample) in one critical section; ``view()`` returns a copy of all
    counters plus the bounded latency window taken in one critical
    section.  Unknown counter names raise — a typo must not mint a new
    counter silently.
    """

    def __init__(self, *names: str, window: int = 4096):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {n: 0 for n in names}
        # bounded: a long-lived server must not grow per-request state
        self._latencies: "deque[float]" = deque(maxlen=window)
        # end-to-end latency split: time parked before dispatch vs time
        # being served (dispatch -> delivery) — one blended number can't
        # distinguish an overloaded batcher from a slow kernel
        self._queue_waits: "deque[float]" = deque(maxlen=window)
        self._services: "deque[float]" = deque(maxlen=window)
        # host seconds the batcher spent dispatching each batch: a hidden
        # wait for the device there serialises the serving pipeline
        self._dispatches: "deque[float]" = deque(maxlen=window)

    def bump(self, _latency_s: Optional[float] = None,
             _queue_s: Optional[float] = None,
             _service_s: Optional[float] = None,
             _dispatch_s: Optional[float] = None, **deltas: int) -> None:
        with self._lock:
            for k, v in deltas.items():
                if k not in self._counts:
                    raise KeyError(f"unknown stats counter {k!r}")
                self._counts[k] += v
            if _latency_s is not None:
                self._latencies.append(_latency_s)
            if _queue_s is not None:
                self._queue_waits.append(_queue_s)
            if _service_s is not None:
                self._services.append(_service_s)
            if _dispatch_s is not None:
                self._dispatches.append(_dispatch_s)

    def view(self) -> Tuple[Dict[str, int], List[float]]:
        """One consistent copy: every counter and the latency window,
        read in a single critical section."""
        with self._lock:
            return dict(self._counts), list(self._latencies)

    def view_windows(self) -> Tuple[Dict[str, int], List[float],
                                    List[float], List[float]]:
        """Like :meth:`view` plus the queue-wait and service windows,
        all copied in the same critical section."""
        with self._lock:
            return (dict(self._counts), list(self._latencies),
                    list(self._queue_waits), list(self._services))

    def dispatch_window(self) -> List[float]:
        """The recent window of per-batch dispatch host seconds."""
        with self._lock:
            return list(self._dispatches)

    @staticmethod
    def percentiles(latencies: List[float],
                    prefix: str = "") -> Dict[str, float]:
        """``{"p50_ms", "p95_ms", "p99_ms"}`` (optionally prefixed) over
        a latency-seconds window (empty window -> empty dict)."""
        if not latencies:
            return {}
        lat = sorted(latencies)

        def at(q: float) -> float:
            return 1e3 * lat[min(len(lat) - 1, int(len(lat) * q))]

        return {f"{prefix}p50_ms": 1e3 * lat[len(lat) // 2],
                f"{prefix}p95_ms": at(0.95), f"{prefix}p99_ms": at(0.99)}


@dataclass
class SearchResult:
    """Per-request outcome: top-k values/indices (best-match plans) or
    the boolean match rows (range plans), row-aligned with the
    submitted queries, plus queueing/batching latency telemetry."""

    rid: int
    values: Optional[np.ndarray] = None
    indices: Optional[np.ndarray] = None
    #: range-plan requests: (rows, n) boolean match matrix
    matches: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    submitted_at: float = 0.0
    #: when the batcher dispatched this request's batch to the device
    #: (0.0 for requests that failed before dispatch)
    dispatched_at: float = 0.0
    completed_at: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.completed_at - self.submitted_at

    @property
    def queue_wait_s(self) -> float:
        """Submit -> dispatch: time parked in the queue / batch fill
        (the whole latency when the request never dispatched)."""
        if not self.dispatched_at:
            return self.latency_s
        return self.dispatched_at - self.submitted_at

    @property
    def service_s(self) -> float:
        """Dispatch -> delivery: device execution + finalize + scatter
        (0.0 when the request never dispatched)."""
        if not self.dispatched_at:
            return 0.0
        return self.completed_at - self.dispatched_at


@dataclass
class SearchRequest:
    """One in-flight query block (``queries``: ``(rows, dim)``).

    ``deadline`` (absolute ``time.perf_counter()`` seconds, or ``None``)
    is the server-side budget: an expired request is failed with a
    ``TimeoutError`` instead of dispatched (or instead of delivered, if
    the result arrives late) — its batch never waits for it.
    """

    rid: int
    queries: np.ndarray
    result: SearchResult
    deadline: Optional[float] = None
    #: cross-thread trace handle (``repro_torch.obs.trace_begin``); ``None``
    #: when tracing is disabled
    _tspan: Any = None
    _done: threading.Event = field(default_factory=threading.Event)
    _cb_lock: threading.Lock = field(default_factory=threading.Lock)
    _callbacks: List[Callable[["SearchRequest"], Any]] = \
        field(default_factory=list)

    def wait(self, timeout: Optional[float] = None) -> SearchResult:
        if not self._done.wait(timeout):
            raise TimeoutError(f"search request {self.rid} timed out")
        return self.result

    def add_done_callback(
            self, fn: Callable[["SearchRequest"], Any]) -> None:
        """Run ``fn(request)`` once the request settles (result or
        error).  Registered after settling, it runs immediately in the
        caller's thread; otherwise in the thread that settles the
        request.  Callback exceptions are swallowed — a broken observer
        must not kill the completion pipeline."""
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:                       # noqa: BLE001 — observer
            pass

    def _settle(self) -> None:
        """Mark done and drain callbacks (exactly once per callback;
        callbacks run outside the registration lock)."""
        with self._cb_lock:
            self._done.set()
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            try:
                fn(self)
            except Exception:                   # noqa: BLE001 — observer
                pass
