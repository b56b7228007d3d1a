"""Per-tenant admission control: rate limits, priorities, bounded queues.

A multi-tenant gateway cannot let one hot tenant wedge the batcher for
everyone: a victim tenant's p95 latency must stay near its solo
profile while a neighbour floods.  The admission primitives here are
deliberately tiny and lock-cheap (pure Python, the reference's own):

* :class:`_TokenBucket` — rows-per-second rate limiting with a burst
  allowance.  ``rate <= 0`` disables the bucket (unlimited).
* :class:`_PendingQueue` — a bounded priority queue that **sheds the
  lowest-priority, newest work first** when full, instead of blocking
  the submitter or growing without bound.  FIFO within a priority.
* :class:`AdmissionConfig` — the per-tenant knob bundle, defaulted
  from ``REPRO_TENANT_*`` via the strict env parsers.

Rejections are :class:`AdmissionError` (the client did too much — a
retryable 429) vs :class:`TenantUnavailable` (the tenant's replicas or
circuit breaker are down — a 503).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..core.envcfg import env_float, env_int

__all__ = ["AdmissionError", "TenantUnavailable", "AdmissionConfig",
           "_TokenBucket", "_PendingQueue"]


class AdmissionError(RuntimeError):
    """Request rejected by admission control (rate limit, full queue,
    or shed by higher-priority work) — the client should back off and
    retry; the tenant itself is healthy."""


class TenantUnavailable(RuntimeError):
    """No serving replica could take the request, or the tenant's
    circuit breaker is open — the tenant is (temporarily) down."""


class _TokenBucket:
    """Rows-per-second token bucket; ``rate <= 0`` means unlimited.

    ``try_acquire(n)`` is non-blocking: admission control rejects
    instead of queueing the client thread (the pending queue is where
    accepted-but-not-yet-forwarded work waits).
    """

    def __init__(self, rate: float, burst: int):
        self.rate = float(rate)
        self.burst = max(1, int(burst))
        self._tokens = float(self.burst)
        self._last = time.perf_counter()
        self._lock = threading.Lock()

    def try_acquire(self, n: int = 1) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            now = time.perf_counter()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


class _PendingQueue:
    """Bounded priority queue with lowest-priority-first shedding.

    ``push`` returns the shed victim when the queue is full: the
    lowest-priority pending entry (newest within that priority), or
    the incoming item itself if nothing pending ranks below it.  The
    caller settles the victim with an :class:`AdmissionError` — the
    queue never silently drops work and never blocks.  Not
    thread-safe; the owner holds its tenant lock around every call.
    """

    def __init__(self, limit: int):
        self.limit = max(1, int(limit))
        self._heap: List[Any] = []       # (-priority, seq, item)
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, priority: int, item: Any) -> Optional[Any]:
        if len(self._heap) >= self.limit:
            # victim: lowest priority, then newest arrival
            victim = max(self._heap, key=lambda e: (e[0], e[1]))
            if priority <= -victim[0]:
                return item             # incoming ranks at/below the floor
            self._heap.remove(victim)
            heapq.heapify(self._heap)
            heapq.heappush(self._heap, (-priority, next(self._seq), item))
            return victim[2]
        heapq.heappush(self._heap, (-priority, next(self._seq), item))
        return None

    def pop(self) -> Optional[Any]:
        """Highest priority first, FIFO within a priority."""
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def drain(self) -> List[Any]:
        items = [e[2] for e in sorted(self._heap)]
        self._heap.clear()
        return items


@dataclass(frozen=True)
class AdmissionConfig:
    """Per-tenant admission knobs (resolved once at registration)."""

    #: token-bucket refill in query rows/second; 0 = unlimited
    rate: float
    #: token-bucket burst allowance, rows
    burst: int
    #: bound on queued-but-not-forwarded requests
    queue_limit: int
    #: bound on requests forwarded to replicas and not yet settled
    max_outstanding: int
    #: consecutive all-replica failures that open the tenant breaker
    #: (0 disables)
    breaker_threshold: int
    breaker_cooldown_s: float
    #: default per-request deadline, seconds (0 = none)
    deadline_s: float

    @classmethod
    def from_env(cls, *, rate: Optional[float] = None,
                 burst: Optional[int] = None,
                 queue_limit: Optional[int] = None,
                 max_outstanding: Optional[int] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_cooldown_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None) -> "AdmissionConfig":
        """Explicit arguments win; unset ones fall back to the strict
        ``REPRO_TENANT_*`` environment defaults (garbage raises)."""
        return cls(
            rate=env_float("REPRO_TENANT_RATE", 0.0, min_value=0.0)
            if rate is None else float(rate),
            burst=env_int("REPRO_TENANT_BURST", 64, min_value=1)
            if burst is None else int(burst),
            queue_limit=env_int("REPRO_TENANT_QUEUE", 256, min_value=1)
            if queue_limit is None else int(queue_limit),
            max_outstanding=env_int("REPRO_TENANT_OUTSTANDING", 8,
                                    min_value=1)
            if max_outstanding is None else int(max_outstanding),
            breaker_threshold=env_int("REPRO_TENANT_BREAKER_K", 8,
                                      min_value=0)
            if breaker_threshold is None else int(breaker_threshold),
            breaker_cooldown_s=(env_float("REPRO_TENANT_BREAKER_COOLDOWN_MS",
                                          100.0, min_value=0.0)
                                if breaker_cooldown_ms is None
                                else float(breaker_cooldown_ms)) / 1e3,
            deadline_s=(env_float("REPRO_TENANT_DEADLINE_MS", 0.0,
                                  min_value=0.0)
                        if deadline_ms is None else float(deadline_ms)) / 1e3,
        )

    def view(self) -> Dict[str, Any]:
        return {"rate": self.rate, "burst": self.burst,
                "queue_limit": self.queue_limit,
                "max_outstanding": self.max_outstanding,
                "breaker_threshold": self.breaker_threshold,
                "breaker_cooldown_ms": 1e3 * self.breaker_cooldown_s,
                "deadline_ms": 1e3 * self.deadline_s}
