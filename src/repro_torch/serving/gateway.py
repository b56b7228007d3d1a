"""Multi-tenant serving gateway: registry, admission, replica failover.

:class:`CamServingGateway` fronts any number of named **tenants**, each
serving its own gallery from a :class:`~repro_torch.serving.replica.
ReplicaSet` of :class:`~repro_torch.serving.CamSearchServer` replicas:

* **Registry / plan sharing** — tenants are registered by name with a
  compiled program (or plan) and gallery.  Plans come from the
  process-wide plan cache, so tenants with identical specs share ONE
  compiled plan; ``share_with=`` goes further and shares a whole
  replica set (same gallery, same servers) between tenant names that
  differ only in admission policy.
* **Admission control** — per-tenant token-bucket rate limits (query
  rows/second), request priorities, and a bounded pending queue that
  sheds the lowest-priority newest work first
  (:mod:`repro_torch.serving.tenant`).  A hot tenant exhausts *its
  own* budget and queue; the victim tenant's latency stays near its solo
  profile.
* **Replica failover** — requests route to the least-loaded serving
  replica; a replica failure settles nothing: the request transparently
  retries on the next replica (``GatewayResult.failovers`` counts the
  hops).  Failover is callback-driven — no thread is parked per
  in-flight request.  On the card a replica server has no degraded
  chain, so a failed replica fails its batch and the request fails over
  the same way.
* **Health integration** — replicas drain after ``unhealthy_k``
  consecutive failures or a failed digest/fault check, heal via the
  scrub/rebuild machinery (:meth:`~repro_torch.serving.replica.
  ReplicaSet._heal_one`), and readmit — driven by the gateway's
  maintenance thread (``REPRO_SERVE_MAINT_MS`` /
  ``REPRO_SERVE_CHECK_MS``).
* **Read-your-writes** — :meth:`CamServingGateway.update_gallery` fans
  one incremental re-prepare out to every serving replica under the
  set's writer-priority lock before returning; any request submitted
  after that sees the new rows regardless of routing.

Results are host numpy arrays, as the servers' are.  The reference's
``register_tenant(tuned=)`` (the plan-store warm start) is not here: it
comes with the port's tuning layer.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.envcfg import env_float
from ..obs.trace import instant, trace_begin, tracer
from .replica import Replica, ReplicaSet
from .resilience import _CircuitBreaker
from .server import _validate_queries
from .telemetry import ServerStats
from .tenant import (AdmissionConfig, AdmissionError, TenantUnavailable,
                     _PendingQueue, _TokenBucket)

__all__ = ["CamServingGateway", "GatewayRequest", "GatewayResult",
           "AdmissionError", "TenantUnavailable"]


@dataclass
class GatewayResult:
    """Terminal outcome of one gateway request."""

    tenant: str
    rid: int
    values: Optional[np.ndarray] = None
    indices: Optional[np.ndarray] = None
    matches: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    #: device group that served the request (None on failure)
    replica: Optional[str] = None
    #: replica hops after the first dispatch attempt
    failovers: int = 0
    submitted_at: float = 0.0
    completed_at: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.completed_at - self.submitted_at


@dataclass
class GatewayRequest:
    """Waitable handle for a submitted gateway request.

    Settles exactly once — with arrays on success, or with the
    terminal error (admission shed, deadline, tenant unavailable,
    gateway stopped) on ``result.error``.
    """

    rid: int
    tenant: str
    queries: np.ndarray
    priority: int
    result: GatewayResult
    deadline: Optional[float] = None
    attempts: int = 0
    #: replica incarnations already tried (failover skips them)
    tried: set = field(default_factory=set)
    #: cross-thread trace handle (``repro_torch.obs.trace_begin``); ``None``
    #: when tracing is disabled
    _tspan: Any = None
    _done: threading.Event = field(default_factory=threading.Event)

    def wait(self, timeout: Optional[float] = None) -> GatewayResult:
        """Block until settled; raises :class:`TimeoutError` only when
        *this wait* times out (a missed request deadline settles the
        result with the error instead)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"gateway request {self.rid} not completed "
                f"within {timeout}s")
        return self.result

    def done(self) -> bool:
        return self._done.is_set()

    def _settle(self, *, error: Optional[BaseException] = None,
                values=None, indices=None, matches=None,
                replica: Optional[str] = None) -> None:
        self.result.error = error
        self.result.values = values
        self.result.indices = indices
        self.result.matches = matches
        self.result.replica = replica
        self.result.completed_at = time.perf_counter()
        if self._tspan is not None:
            self._tspan.end(
                {"error": type(error).__name__} if error is not None
                else {"replica": replica,
                      "failovers": self.result.failovers})
        self._done.set()


class _Tenant:
    """Registry entry: replica set + admission state + counters."""

    def __init__(self, name: str, rset: ReplicaSet, cfg: AdmissionConfig):
        self.name = name
        self.rset = rset
        self.cfg = cfg
        self.bucket = _TokenBucket(cfg.rate, cfg.burst)
        self.pending = _PendingQueue(cfg.queue_limit)
        self.lock = threading.Lock()
        self.outstanding = 0
        self.breaker = _CircuitBreaker(cfg.breaker_threshold,
                                       cfg.breaker_cooldown_s)
        self.stats = ServerStats(
            "submitted", "completed", "failed", "queries",
            "rejected_rate", "rejected_queue", "rejected_breaker",
            "shed", "failovers", "deadline_misses",
            "gallery_updates", "rows_updated",
            window=1024)


class CamServingGateway:
    """Multi-tenant front door over replicated CAM search servers.

    Parameters
    ----------
    maint_ms:
        Maintenance sweep period, milliseconds: each sweep heals
        drained-and-idle replicas across every replica set; 0 disables
        the background thread (``check_tenant`` still heals on demand).
        Default ``REPRO_SERVE_MAINT_MS``.
    check_ms:
        How often a maintenance sweep additionally runs the
        digest-divergence + fault-readback check (expensive: hashes
        every replica's gallery); 0 = on demand only.  Default
        ``REPRO_SERVE_CHECK_MS``.
    """

    def __init__(self, *, maint_ms: Optional[float] = None,
                 check_ms: Optional[float] = None):
        self._maint_s = (env_float("REPRO_SERVE_MAINT_MS", 20.0,
                                   min_value=0.0)
                         if maint_ms is None else float(maint_ms)) / 1e3
        self._check_s = (env_float("REPRO_SERVE_CHECK_MS", 0.0,
                                   min_value=0.0)
                         if check_ms is None else float(check_ms)) / 1e3
        self._tenants: Dict[str, _Tenant] = {}
        self._lock = threading.Lock()
        self._rid = itertools.count()
        self._accepting = True
        self._stop_evt = threading.Event()
        self._maint_thread: Optional[threading.Thread] = None
        if self._maint_s > 0:
            self._maint_thread = threading.Thread(
                target=self._maint_loop, name="cam-gateway-maint",
                daemon=True)
            self._maint_thread.start()

    # -- registry ----------------------------------------------------------

    def register_tenant(self, name: str, program: Any = None,
                        gallery: Any = None, *,
                        care_mask: Any = None,
                        replicas: Optional[int] = None,
                        share_with: Optional[str] = None,
                        fault_models: Optional[Sequence[Any]] = None,
                        fault_injectors: Optional[Sequence[Any]] = None,
                        device_groups: Optional[Sequence[str]] = None,
                        rate: Optional[float] = None,
                        burst: Optional[int] = None,
                        queue_limit: Optional[int] = None,
                        max_outstanding: Optional[int] = None,
                        breaker_threshold: Optional[int] = None,
                        breaker_cooldown_ms: Optional[float] = None,
                        deadline_ms: Optional[float] = None,
                        unhealthy_k: Optional[int] = None,
                        max_fault_rows: Optional[int] = None,
                        rebuild_fault_model: Optional[Callable] = None,
                        server_kwargs: Optional[Dict[str, Any]] = None
                        ) -> "CamServingGateway":
        """Register a named tenant.

        ``share_with=`` reuses another tenant's replica set — same
        gallery, same replica servers, *different* admission policy
        (rate, priority budget, breaker).  That is the cheap way to
        give one dataset two service classes.  Otherwise ``program`` +
        ``gallery`` build a fresh :class:`ReplicaSet`; tenants whose
        specs coincide still share the compiled plan through the
        process-wide plan cache.

        Admission knobs left ``None`` fall back to the strict
        ``REPRO_TENANT_*`` environment defaults (garbage in the
        environment raises here, at registration).
        """
        cfg = AdmissionConfig.from_env(
            rate=rate, burst=burst, queue_limit=queue_limit,
            max_outstanding=max_outstanding,
            breaker_threshold=breaker_threshold,
            breaker_cooldown_ms=breaker_cooldown_ms,
            deadline_ms=deadline_ms)
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            if share_with is not None:
                if program is not None or gallery is not None:
                    raise ValueError(
                        "share_with reuses the peer tenant's replica "
                        "set; do not pass program/gallery")
                peer = self._tenants.get(share_with)
                if peer is None:
                    raise KeyError(f"unknown tenant {share_with!r}")
                rset = peer.rset
                rset.refs += 1
            else:
                if program is None or gallery is None:
                    raise ValueError(
                        "register_tenant needs program+gallery "
                        "(or share_with=)")
                from .server import _resolve_plan
                rset = ReplicaSet(
                    _resolve_plan(program), gallery,
                    care_mask=care_mask,
                    replicas=replicas, fault_models=fault_models,
                    fault_injectors=fault_injectors,
                    device_groups=device_groups, unhealthy_k=unhealthy_k,
                    max_fault_rows=max_fault_rows,
                    rebuild_fault_model=rebuild_fault_model,
                    server_kwargs=server_kwargs)
            self._tenants[name] = _Tenant(name, rset, cfg)
        return self

    def _tenant(self, name: str) -> _Tenant:
        with self._lock:
            t = self._tenants.get(name)
        if t is None:
            raise KeyError(f"unknown tenant {name!r}")
        return t

    @property
    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    # -- client API --------------------------------------------------------

    def submit(self, tenant: str, queries, *,
               priority: int = 0,
               deadline_ms: Optional[float] = None) -> GatewayRequest:
        """Admit + route one query block for ``tenant``.

        Synchronous rejections raise — :class:`AdmissionError` for
        rate-limit / full-queue (back off and retry),
        :class:`TenantUnavailable` when the tenant breaker is open.
        Accepted requests return a waitable handle; a queued request
        later shed by higher-priority work settles with an
        :class:`AdmissionError` on its result instead of raising.
        Higher ``priority`` wins queue order and sheds last.
        """
        t = self._tenant(tenant)
        if not self._accepting:
            raise RuntimeError("gateway stopped")
        q = _validate_queries(t.rset.plan, queries)
        t.stats.bump(submitted=1)
        if not t.breaker.allow_primary():
            t.stats.bump(rejected_breaker=1)
            instant("gw.reject", "gateway",
                    {"reason": "breaker", "tenant": tenant})
            raise TenantUnavailable(
                f"tenant {tenant!r} circuit breaker open")
        if not t.bucket.try_acquire(q.shape[0]):
            t.stats.bump(rejected_rate=1)
            instant("gw.reject", "gateway",
                    {"reason": "rate", "tenant": tenant})
            raise AdmissionError(
                f"tenant {tenant!r} over rate limit "
                f"({t.cfg.rate:g} rows/s)")
        now = time.perf_counter()
        budget = t.cfg.deadline_s if deadline_ms is None \
            else float(deadline_ms) / 1e3
        greq = GatewayRequest(
            rid=next(self._rid), tenant=tenant, queries=q,
            priority=int(priority),
            deadline=now + budget if budget > 0 else None,
            result=GatewayResult(tenant=tenant, rid=0, submitted_at=now))
        greq.result.rid = greq.rid
        greq._tspan = trace_begin(
            "request", "gateway",
            {"rid": greq.rid, "tenant": tenant, "rows": int(q.shape[0])})
        victim = None
        forward = False
        with t.lock:
            if t.outstanding < t.cfg.max_outstanding \
                    and len(t.pending) == 0:
                t.outstanding += 1
                forward = True
            else:
                victim = t.pending.push(greq.priority, greq)
        if forward:
            self._pump(t, greq)
            return greq
        if victim is greq:
            t.stats.bump(rejected_queue=1)
            instant("gw.reject", "gateway",
                    {"reason": "queue", "tenant": tenant})
            if greq._tspan is not None:
                greq._tspan.end({"error": "AdmissionError"})
            raise AdmissionError(
                f"tenant {tenant!r} pending queue full "
                f"({t.cfg.queue_limit})")
        if victim is not None:
            t.stats.bump(shed=1)
            instant("gw.reject", "gateway",
                    {"reason": "shed", "tenant": tenant,
                     "rid": victim.rid})
            victim._settle(error=AdmissionError(
                f"shed by higher-priority work (queue limit "
                f"{t.cfg.queue_limit})"))
            t.stats.bump(failed=1)
        return greq

    def search(self, tenant: str, queries, *,
               priority: int = 0, deadline_ms: Optional[float] = None,
               timeout: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking best-match search via the gateway."""
        res = self.submit(tenant, queries, priority=priority,
                          deadline_ms=deadline_ms).wait(timeout)
        if res.error is not None:
            raise res.error
        return res.values, res.indices

    def match(self, tenant: str, queries, *,
              priority: int = 0, deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None) -> np.ndarray:
        """Blocking range match via the gateway."""
        res = self.submit(tenant, queries, priority=priority,
                          deadline_ms=deadline_ms).wait(timeout)
        if res.error is not None:
            raise res.error
        return res.matches

    def update_gallery(self, tenant: str, indices, new_rows) -> int:
        """Rewrite stored rows across every replica of ``tenant``.

        One incremental :meth:`~repro_torch.core.engine.SearchPlan.
        update_rows` runs against the shared fleet tensors and every
        serving replica adopts the result before this returns —
        writer-priority against routing, so the tenant reads its own
        writes on every subsequent request.  Returns the row count.
        """
        t = self._tenant(tenant)
        count = t.rset.fan_out(indices, new_rows)
        t.stats.bump(gallery_updates=1, rows_updated=count)
        return count

    # -- routing / failover ------------------------------------------------

    def _pump(self, t: _Tenant, g: Optional[GatewayRequest] = None) -> None:
        """Drive one outstanding slot: forward ``g`` (or the next
        pending request) until something is dispatched or the queue is
        dry.  Iterative — settling a dead request and moving to the
        next must not recurse to queue depth."""
        while True:
            if g is None:
                with t.lock:
                    g = t.pending.pop()
                    if g is None:
                        t.outstanding -= 1
                        return
            if self._forward_once(t, g):
                return
            g = None

    def _forward_once(self, t: _Tenant, g: GatewayRequest) -> bool:
        """Try to dispatch ``g`` onto some serving replica.

        True: dispatched — the outstanding slot rides along and is
        released by the completion callback.  False: ``g`` settled
        terminally; the caller forwards the next pending request.
        """
        if not self._accepting:
            t.stats.bump(failed=1)
            g._settle(error=RuntimeError("gateway stopped"))
            return False
        now = time.perf_counter()
        if g.deadline is not None and now >= g.deadline:
            t.stats.bump(deadline_misses=1, failed=1)
            g._settle(error=TimeoutError(
                f"request {g.rid} missed its deadline before dispatch"))
            return False
        while True:
            rep = t.rset.route(g.tried)
            if rep is None:
                t.breaker.record_failure()
                t.stats.bump(failed=1)
                g._settle(error=TenantUnavailable(
                    f"tenant {g.tenant!r}: no serving replica left "
                    f"(tried {len(g.tried)})"))
                return False
            remaining_ms = None
            if g.deadline is not None:
                remaining_ms = max(1.0, 1e3 * (g.deadline - now))
            try:
                sreq = rep.server.submit(g.queries,
                                         deadline_ms=remaining_ms)
            except Exception:                   # noqa: BLE001 — failover
                rep.note_failure(t.rset.unhealthy_k)
                g.tried.add(rep.key)
                continue
            rep.inc_outstanding()
            g.attempts += 1
            if tracer.enabled:
                # cross-pid link: this gateway request's spans continue
                # as server request ``server_rid`` on the serving track
                instant("gw.route", "gateway",
                        {"rid": g.rid, "server_rid": sreq.rid,
                         "replica": rep.device_group,
                         "tenant": g.tenant, "attempt": g.attempts})
                if g._tspan is not None:
                    # closes the admission window: submit -> dispatch
                    g._tspan.lap("gw.admission",
                                 {"replica": rep.device_group})
            sreq.add_done_callback(
                lambda r, _t=t, _g=g, _rep=rep: self._on_done(_t, _g,
                                                              _rep, r))
            return True

    def _on_done(self, t: _Tenant, g: GatewayRequest, rep: Replica,
                 sreq) -> None:
        """Replica completion callback: settle, fail over, or time out
        — then hand the outstanding slot to the next pending request.
        Runs on the replica server's completer thread; must not
        block."""
        rep.dec_outstanding()
        res = sreq.result
        if res.error is None:
            rep.note_success()
            t.breaker.record_success()
            g._settle(values=res.values, indices=res.indices,
                      matches=res.matches, replica=rep.device_group)
            t.stats.bump(_latency_s=g.result.latency_s, completed=1,
                         queries=int(g.queries.shape[0]))
            self._pump(t)
            return
        if isinstance(res.error, TimeoutError):
            # the request's own deadline died, not the replica
            t.stats.bump(deadline_misses=1, failed=1)
            g._settle(error=res.error)
            self._pump(t)
            return
        rep.note_failure(t.rset.unhealthy_k)
        g.tried.add(rep.key)
        g.result.failovers += 1
        t.stats.bump(failovers=1)
        instant("gw.failover", "gateway",
                {"rid": g.rid, "tenant": g.tenant,
                 "replica": rep.device_group,
                 "error": type(res.error).__name__})
        self._pump(t, g)                        # retry elsewhere, same slot

    # -- maintenance / chaos -----------------------------------------------

    def _maint_loop(self) -> None:
        last_check = time.perf_counter()
        while not self._stop_evt.wait(self._maint_s):
            now = time.perf_counter()
            check = self._check_s > 0 and now - last_check >= self._check_s
            if check:
                last_check = now
            for rset in self._replica_sets():
                try:
                    rset.maintain(check=check)
                except Exception:               # noqa: BLE001 — keep sweeping
                    pass

    def _replica_sets(self) -> List[ReplicaSet]:
        with self._lock:
            seen: Dict[int, ReplicaSet] = {}
            for t in self._tenants.values():
                seen.setdefault(id(t.rset), t.rset)
            return list(seen.values())

    def check_tenant(self, name: str) -> Dict[str, Any]:
        """Synchronous digest/fault check + heal sweep for one tenant's
        replica set (what the maintenance thread does periodically)."""
        return self._tenant(name).rset.maintain(check=True)

    def kill_replica(self, tenant: str, idx: int, *,
                     hard: bool = False) -> None:
        """Chaos hook: take one of ``tenant``'s replica device groups
        down.  Soft kill fails every new dispatch on the replica; hard
        kill also stops its server so in-flight requests fail over
        immediately."""
        t = self._tenant(tenant)
        t.rset.replicas[idx].kill(hard=hard)

    # -- telemetry ---------------------------------------------------------

    def dump_trace(self, path: str) -> str:
        """Write the process-wide Chrome-tracing export (gateway,
        serving and engine tracks all land in the same file) to
        ``path``.  Convenience mirror of :func:`repro_torch.obs.dump`;
        tracing must be enabled."""
        from ..obs.trace import dump
        return dump(path)

    def health(self) -> Dict[str, Any]:
        """Aggregated fleet health: per-tenant admission/breaker stats
        and per-replica lifecycle state.  ``status`` degrades when any
        tenant breaker is open or any replica is not serving."""
        out: Dict[str, Any] = {"status": "ok",
                               "accepting": self._accepting,
                               "tenants": {}}
        with self._lock:
            tenants = dict(self._tenants)
        for name, t in tenants.items():
            counts, lat = t.stats.view()
            br = t.breaker.snapshot()
            with t.lock:
                pending = len(t.pending)
                outstanding = t.outstanding
            entry = {"admission": t.cfg.view(), "breaker": br,
                     "pending": pending, "outstanding": outstanding,
                     "stats": counts,
                     "latency": ServerStats.percentiles(lat),
                     "replicas": t.rset.view()}
            if br["state"] != "closed" or \
                    entry["replicas"]["serving"] < len(t.rset.replicas):
                out["status"] = "degraded"
            out["tenants"][name] = entry
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Alias for :meth:`health` plus per-replica server snapshots
        (throughput counters, batch fill, plan telemetry)."""
        out = self.health()
        for name, entry in out["tenants"].items():
            t = self._tenant(name)
            entry["servers"] = []
            for r in t.rset.replicas:
                try:
                    entry["servers"].append(r.server.snapshot())
                except Exception:               # noqa: BLE001 — dead replica
                    entry["servers"].append(None)
        return out

    # -- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        """Stop accepting, stop maintenance, stop every replica server,
        then settle whatever is still queued.  Every outstanding
        request handle resolves — in-flight ones through the servers'
        own stop path (callbacks fire with the terminal error), queued
        ones here."""
        self._accepting = False
        self._stop_evt.set()
        if self._maint_thread is not None:
            self._maint_thread.join()
            self._maint_thread = None
        for rset in self._replica_sets():
            rset.stop()
        with self._lock:
            tenants = list(self._tenants.values())
        for t in tenants:
            while True:
                with t.lock:
                    g = t.pending.pop()
                if g is None:
                    break
                t.stats.bump(failed=1)
                g._settle(error=RuntimeError("gateway stopped"))

    def __enter__(self) -> "CamServingGateway":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
