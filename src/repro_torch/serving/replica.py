"""Gallery replicas: load balancing, update fan-out, health, healing.

A :class:`ReplicaSet` serves one tenant's gallery from ``R`` replica
:class:`~repro_torch.serving.CamSearchServer` instances, each standing
in for a CAM **device group** with its own fault exposure (its own
:class:`~repro_torch.faults.FaultModel` / chaos injector).  The design
follows the hardening layer up one level: where
:class:`~repro_torch.faults.HardenedPlan` replicates *rows inside one
device*, a replica set replicates *whole galleries across device
groups* — and reuses the same digest machinery
(:func:`~repro_torch.faults.row_checksums` /
:func:`~repro_torch.faults.detect_faulty_rows`) to decide when a copy
has degraded.

**Replica prepare reuse.**  Every replica server is constructed around
the *same* stored tensors on the plan's device (primed once via
:meth:`~repro_torch.core.engine.PlanBase.warm`), so the shared plan's
pattern memo holds ONE prepared layout for the whole set: on the card,
one copy of the gallery and its prepared layout serves every replica.
``update_gallery`` fan-out computes one incremental
:meth:`~repro_torch.core.engine.SearchPlan.update_rows` against the
shared tensors and every serving replica adopts the result
(:meth:`~repro_torch.serving.CamSearchServer.adopt_gallery`) under the
write side of a writer-priority lock — routing pauses, so a request
submitted after the update returns can only land on a replica that
already serves the new version (read-your-writes per tenant).  The
canonical host copy and its row checksums stay numpy, as in the
reference.

**Streams.**  Each replica server has its own batcher and completer
thread, and every one of them launches on the stream that was current
on the plan's device when the set was built (the device's default
stream unless the caller chose another); the fan-out's update runs on
it too.  A completer reads a batch's results with a host copy on that
stream, which waits for the batch's kernels, so no result is read
before its work is done.

**Health / heal lifecycle** (``serving → draining → rebuilding →
serving``): consecutive request failures (``unhealthy_k``) or a failed
digest/fault check drain a replica — routing stops sending it new
work, in-flight requests finish or fail over.  Once idle it is healed:
a *scrub* (the fault model's write epoch bumps, redrawing transient
faults — the :meth:`~repro_torch.faults.HardenedPlan.heal` rewrite story at
device-group granularity) when that clears the fault check, else a
*rebuild* onto a fresh device group (new generation, replacement fault
model) from peer content — the shared stored arrays its healthy peers
serve.  Either way the replica re-enters routing with its canonical
content resynced and its failure counters reset.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..core.engine import RangePlan
from ..core.engine.base import _host
from ..core.envcfg import env_int
from ..faults import detect_faulty_rows, row_checksums
from ..obs.trace import trace_begin
from .resilience import _WriterPriorityLock
from .server import CamSearchServer

__all__ = ["Replica", "ReplicaSet"]


class Replica:
    """One device group's copy of a tenant gallery.

    Owns the serving :class:`CamSearchServer`, the group's fault
    exposure (``fault_model`` + optional user chaos injector), the
    health state machine and its counters.  Thread-safe where it
    matters: ``outstanding`` and the state transitions are guarded by
    a per-replica lock (routing reads them under the set's read lock,
    completions mutate them from server completer threads).
    """

    def __init__(self, idx: int, device_group: str,
                 fault_model: Any = None,
                 fault_injector: Optional[Callable[[str], None]] = None):
        self.idx = int(idx)
        self.device_group = device_group
        self.generation = 0
        self.fault_model = fault_model
        self._user_injector = fault_injector
        self._killed = False
        self.state = "serving"
        self.server: Optional[CamSearchServer] = None
        self.needs_resync = False
        self._lock = threading.Lock()
        self.outstanding = 0
        self.failures = 0
        self.consecutive_failures = 0
        self.successes = 0
        self.heals = 0
        self.rebuilds = 0
        self.drains = 0
        self.rows_resynced = 0

    @property
    def key(self) -> Tuple[int, int]:
        """Routing identity: a rebuilt replica (new generation) is a
        new failover target even for a request that already tried the
        old incarnation."""
        return (self.idx, self.generation)

    def _injector_hook(self, level: str) -> None:
        """Installed as the server's ``fault_injector``: a killed
        device group fails every dispatch level; otherwise the user's
        chaos injector (if any) decides."""
        if self._killed:
            raise RuntimeError(
                f"replica {self.idx} device group {self.device_group!r} "
                f"is down")
        if self._user_injector is not None:
            self._user_injector(level)

    def kill(self, *, hard: bool = False) -> None:
        """Simulate losing the device group: every subsequent dispatch
        on this replica fails (``hard`` also stops the server, so
        in-flight requests fail immediately instead of at dispatch).
        The replica drains after ``unhealthy_k`` consecutive failures
        and is rebuilt onto a fresh group by the next heal."""
        self._killed = True
        if hard and self.server is not None:
            try:
                self.server.stop()
            except Exception:                   # noqa: BLE001 — chaos
                pass

    def inc_outstanding(self) -> None:
        with self._lock:
            self.outstanding += 1

    def dec_outstanding(self) -> None:
        with self._lock:
            self.outstanding -= 1

    def note_success(self) -> None:
        with self._lock:
            self.successes += 1
            self.consecutive_failures = 0

    def note_failure(self, unhealthy_k: int) -> bool:
        """Record a request-level failure; returns True when this
        failure newly drained the replica."""
        with self._lock:
            self.failures += 1
            self.consecutive_failures += 1
            if unhealthy_k > 0 and \
                    self.consecutive_failures >= unhealthy_k and \
                    self.state == "serving":
                self.state = "draining"
                self.drains += 1
                return True
            return False

    def view(self) -> Dict[str, Any]:
        with self._lock:
            return {"idx": self.idx, "device_group": self.device_group,
                    "generation": self.generation, "state": self.state,
                    "killed": self._killed,
                    "outstanding": self.outstanding,
                    "failures": self.failures,
                    "consecutive_failures": self.consecutive_failures,
                    "successes": self.successes, "heals": self.heals,
                    "rebuilds": self.rebuilds, "drains": self.drains,
                    "rows_resynced": self.rows_resynced,
                    "fault_model": None if self.fault_model is None
                    else repr(self.fault_model)}


class ReplicaSet:
    """``R`` replicas of one gallery behind one shared plan.

    Parameters
    ----------
    plan:
        The shared engine plan (one plan-cache citizen serves every
        replica and every tenant with this spec).
    gallery / care_mask:
        Logical stored content, exactly as
        :class:`~repro_torch.serving.CamSearchServer` takes it.
    replicas:
        Replica count (``REPRO_SERVE_REPLICAS`` default).
    fault_models / fault_injectors / device_groups:
        Optional per-replica fault exposure and naming (lists indexed
        by replica; shorter lists pad with ``None`` / generated names).
    unhealthy_k:
        Consecutive request failures that drain a replica
        (``REPRO_SERVE_UNHEALTHY_K``).
    max_fault_rows:
        Digest-check budget: a serving replica whose simulated device
        readback shows more than this many faulty rows is drained for
        healing (``REPRO_SERVE_MAX_FAULT_ROWS``).
    rebuild_fault_model:
        ``f(replica, generation) -> FaultModel | None`` for rebuilt
        replicas; default rebuilds land on a pristine device group
        (no fault model).
    server_kwargs:
        Extra :class:`CamSearchServer` constructor knobs applied to
        every replica (``max_wait_ms``, ``max_batch``, ...).
    """

    def __init__(self, plan, gallery, *, care_mask=None,
                 replicas: Optional[int] = None,
                 fault_models: Optional[Sequence[Any]] = None,
                 fault_injectors: Optional[Sequence[Any]] = None,
                 device_groups: Optional[Sequence[str]] = None,
                 unhealthy_k: Optional[int] = None,
                 max_fault_rows: Optional[int] = None,
                 rebuild_fault_model: Optional[Callable] = None,
                 server_kwargs: Optional[Dict[str, Any]] = None):
        self.plan = plan
        self.is_range = isinstance(plan, RangePlan)
        self.multi = self.is_range and len(plan.spec.pattern_args) == 2
        n_rep = env_int("REPRO_SERVE_REPLICAS", 1, min_value=1) \
            if replicas is None else int(replicas)
        if n_rep < 1:
            raise ValueError(f"replicas must be >= 1, got {n_rep}")
        self.unhealthy_k = env_int("REPRO_SERVE_UNHEALTHY_K", 3,
                                   min_value=1) \
            if unhealthy_k is None else int(unhealthy_k)
        self.max_fault_rows = env_int("REPRO_SERVE_MAX_FAULT_ROWS", 0,
                                      min_value=0) \
            if max_fault_rows is None else int(max_fault_rows)
        self._rebuild_model = rebuild_fault_model
        self._server_kwargs = dict(server_kwargs or {})
        self._rw = _WriterPriorityLock()
        self._maint_lock = threading.Lock()
        self.version = 0
        self.refs = 1                    # tenants sharing this set

        self._stream = torch.cuda.current_stream(plan.device) \
            if plan.device.type == "cuda" else None
        # one warm() primes the shared plan's pattern memo; the
        # returned tensors are THE fleet content every replica
        # serves (replica prepare reuse)
        if self.is_range:
            stored_in = tuple(gallery) if self.multi else (gallery,)
            if self.multi and len(stored_in) != 2:
                raise ValueError("interval range plan needs "
                                 "gallery=(lo, hi)")
            shared = plan.warm(*stored_in)
            self._care = None
        elif care_mask is not None:
            shared = plan.warm(gallery, care_mask)
            self._care = shared[1]
            shared = shared[:1]
        else:
            shared = plan.warm(gallery)
            self._care = None
        self._shared: Tuple[Any, ...] = shared
        # canonical host copy + per-row digest of the fleet content —
        # what replicas are compared against (and resynced from); a
        # copy (astype copies), since fan_out scatters rows into it
        self._canonical = tuple(_host(s).astype(np.float32)
                                for s in self._shared)
        self._crc = row_checksums(self._canonical)

        models = list(fault_models or [])
        injectors = list(fault_injectors or [])
        groups = list(device_groups or [])
        self.replicas: List[Replica] = []
        for i in range(n_rep):
            r = Replica(
                i,
                groups[i] if i < len(groups) else f"devgroup-{i}",
                fault_model=models[i] if i < len(models) else None,
                fault_injector=injectors[i] if i < len(injectors) else None)
            r.server = self._make_server(r)
            r.server.start()
            self.replicas.append(r)

    # -- construction helpers ----------------------------------------------

    def _server_gallery(self):
        """The shared stored content in the server constructor's
        ``gallery`` convention."""
        if self.is_range:
            return self._shared if self.multi else self._shared[0]
        return self._shared[0]

    def _make_server(self, r: Replica, gallery=None) -> CamSearchServer:
        """A replica server on the set's stream (the server keeps the
        stream current at its construction)."""
        with self._on_stream():
            return CamSearchServer(
                self.plan,
                self._server_gallery() if gallery is None else gallery,
                care_mask=self._care, fault_model=r.fault_model,
                fault_injector=r._injector_hook, **self._server_kwargs)

    # -- routing -----------------------------------------------------------

    def route(self, exclude=()) -> Optional[Replica]:
        """Pick the least-loaded serving replica (read side of the
        update lock: routing pauses while an update fans out, which is
        what makes read-your-writes hold)."""
        self._rw.acquire_read()
        try:
            best = None
            for r in self.replicas:
                if r.state != "serving" or r.key in exclude:
                    continue
                if best is None or r.outstanding < best.outstanding:
                    best = r
            return best
        finally:
            self._rw.release_read()

    # -- update fan-out ----------------------------------------------------

    def _on_stream(self):
        """Context of the set's stream (nothing on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def fan_out(self, indices, new_rows) -> int:
        """Apply one ``update_rows`` to the shared content and fan the
        result out to every serving replica.

        Writer side of the update lock: no request is routed while the
        fleet content is mid-fan-out, so a client that saw
        ``update_gallery`` return can never read a pre-update replica
        (read-your-writes).  The incremental re-prepare runs ONCE, on
        the set's stream — replicas adopt the same resulting tensors.
        Draining /
        rebuilding replicas are skipped; the heal path resyncs them
        from canonical content before readmission.
        """
        if self.multi and not (isinstance(new_rows, (tuple, list))
                               and len(new_rows) == 2):
            raise ValueError(
                "interval range plan needs new_rows=(lo_rows, hi_rows)")
        self._rw.acquire_write()
        try:
            idx = np.atleast_1d(np.asarray(indices, np.int64))
            with self._on_stream():
                if self.is_range:
                    stored = self._shared if self.multi \
                        else self._shared[0]
                    upd = self.plan.update_rows(stored, idx, new_rows)
                    self._shared = tuple(upd) if self.multi else (upd,)
                else:
                    self._shared = (self.plan.update_rows(
                        self._shared[0], idx, new_rows, care=self._care),)
            news = tuple(new_rows) if self.multi else (new_rows,)
            for canon, blk in zip(self._canonical, news):
                canon[idx] = _host(blk).astype(np.float32)
            self._crc[idx] = row_checksums(
                tuple(c[idx] for c in self._canonical))
            self.version += 1
            gal = self._server_gallery()
            for r in self.replicas:
                if r.state != "serving":
                    r.needs_resync = True
                    continue
                try:
                    r.server.adopt_gallery(gal, rows_updated=int(idx.size))
                except Exception:               # noqa: BLE001 — resync later
                    r.needs_resync = True
            return int(idx.size)
        finally:
            self._rw.release_write()

    # -- health: digests, fault readback, heal -----------------------------

    def _serves_shared(self, r: Replica) -> bool:
        """Whether the replica's server holds the fleet's shared stored
        tensors themselves (every replica does on the card, where
        ``fan_out`` hands them all the same objects)."""
        g = r.server.gallery
        comps = tuple(g) if isinstance(g, tuple) else (g,)
        return len(comps) == len(self._shared) and all(
            a is b for a, b in zip(comps, self._shared))

    def _divergence(self, r: Replica) -> np.ndarray:
        """Rows where the replica's served content differs from the
        canonical fleet content (its row checksums): missed fan-out,
        corruption."""
        g = r.server.gallery
        comps = tuple(g) if isinstance(g, tuple) else (g,)
        rows = row_checksums(tuple(_host(c).astype(np.float32)
                                   for c in comps))
        return rows != self._crc

    def _fault_rows(self, model) -> int:
        """Faulty-row count from a simulated device readback of the
        canonical content under ``model`` — the same digest check
        :meth:`~repro_torch.faults.HardenedPlan.heal` runs per physical row,
        at replica granularity."""
        if model is None or model.is_null:
            return 0
        full = self._canonical if self._care is None \
            else self._canonical + (_host(self._care).astype(np.float32),)
        readback = model.corrupt_stored(full, self.plan.spec)
        # tolerance from the *fresh-write* guard (t=0): the model's own
        # guard grows with drift*t, which would hide exactly the aging
        # a scrub exists to clear
        bad = detect_faulty_rows(readback, full,
                                 model.rewritten().suggest_guard(z=4.0))
        return int(bad.sum())

    def check(self) -> List[Dict[str, Any]]:
        """Digest/fault sweep over the serving replicas.

        Content divergence (missed updates) is repaired in place by
        re-adopting the canonical shared arrays; a replica whose fault
        readback exceeds ``max_fault_rows`` is drained for healing.
        Returns one report entry per replica checked.
        """
        report = []
        self._rw.acquire_write()
        try:
            for r in self.replicas:
                if r.state != "serving":
                    continue
                entry: Dict[str, Any] = {"replica": r.idx,
                                         "device_group": r.device_group}
                div = 0 if self._serves_shared(r) \
                    else int(self._divergence(r).sum())
                if div:
                    r.server.adopt_gallery(self._server_gallery(),
                                           rows_updated=div)
                    r.rows_resynced += div
                    r.needs_resync = False
                entry["rows_resynced"] = div
                fr = self._fault_rows(r.fault_model)
                entry["fault_rows"] = fr
                if fr > self.max_fault_rows:
                    with r._lock:
                        if r.state == "serving":
                            r.state = "draining"
                            r.drains += 1
                    entry["drained"] = True
                report.append(entry)
        finally:
            self._rw.release_write()
        return report

    def heal_drained(self) -> List[Dict[str, Any]]:
        """Heal every drained replica that has gone idle."""
        out = []
        for r in self.replicas:
            if r.state == "draining" and r.outstanding == 0:
                rep = self._heal_one(r)
                if rep is not None:
                    out.append(rep)
        return out

    def _heal_one(self, r: Replica) -> Optional[Dict[str, Any]]:
        """Scrub-or-rebuild one idle drained replica, then readmit it.

        Three phases so no lock is held across a server stop/start
        (stopping a server joins its completer thread, which may be
        mid-failover and about to take the routing read lock — holding
        the write lock there would deadlock):

        1. under the write lock: mark ``rebuilding`` (routing skips
           it), snapshot the shared content + version, measure content
           divergence, and pick the heal mode — **scrub** when bumping
           the fault model's write epoch (``rewritten()``) clears the
           fault check (transient faults redraw, stuck cells persist),
           else **rebuild** onto a fresh generation/device group with a
           replacement model.  A replica that still serves the shared
           tensors themselves has diverged by 0 rows; only one that
           holds other tensors (a missed fan-out) is hashed;
        2. unlocked: stop the old server, build + start the new one
           from the snapshot (peer content — the same tensors the
           healthy replicas serve);
        3. under the write lock: catch up any fan-out that landed
           mid-heal, swap the server in, reset counters, readmit.
        """
        self._rw.acquire_write()
        try:
            with r._lock:
                if r.state != "draining" or r.outstanding != 0:
                    return None
                r.state = "rebuilding"
            hspan = trace_begin("heal", "gateway",
                                {"replica": r.idx,
                                 "device": r.device_group})
            version0 = self.version
            gal0 = self._server_gallery()
            try:
                diverged = 0 if self._serves_shared(r) \
                    else int(self._divergence(r).sum())
            except Exception:                   # noqa: BLE001 — dead copy
                diverged = int(self._canonical[0].shape[0])
            mode = "resync"
            new_model = r.fault_model
            if r._killed:
                mode = "rebuild"
            elif self._fault_rows(r.fault_model) > self.max_fault_rows:
                scrub = r.fault_model.rewritten()
                if self._fault_rows(scrub) <= self.max_fault_rows:
                    mode = "scrub"
                    new_model = scrub
                else:
                    mode = "rebuild"
            if mode == "rebuild":
                r.generation += 1
                new_model = None if self._rebuild_model is None \
                    else self._rebuild_model(r, r.generation)
        finally:
            self._rw.release_write()
        if hspan is not None:
            hspan.lap("heal.diagnose", {"mode": mode,
                                        "diverged": diverged})

        old = r.server
        try:
            old.stop()
        except Exception:                       # noqa: BLE001 — chaos
            pass
        r.fault_model = new_model
        r._killed = False
        if mode == "rebuild":
            r.device_group = f"{r.device_group.split('+g')[0]}" \
                             f"+g{r.generation}"
        fresh = self._make_server(r, gal0)
        fresh.start()
        if hspan is not None:
            hspan.lap("heal.rebuild")

        self._rw.acquire_write()
        try:
            if self.version != version0:        # fan-out landed mid-heal
                fresh.adopt_gallery(self._server_gallery())
                diverged = max(diverged, 1)
            r.server = fresh
            with r._lock:
                r.heals += 1
                if mode == "rebuild":
                    r.rebuilds += 1
                r.rows_resynced += diverged
                r.consecutive_failures = 0
                r.needs_resync = False
                r.state = "serving"
        finally:
            self._rw.release_write()
        if hspan is not None:
            hspan.lap("heal.readmit")
            hspan.end({"mode": mode, "rows_resynced": diverged,
                       "generation": r.generation})
        return {"replica": r.idx, "mode": mode, "rows_resynced": diverged,
                "generation": r.generation,
                "device_group": r.device_group}

    def maintain(self, *, check: bool = False) -> Dict[str, Any]:
        """One maintenance sweep: optional digest/fault check, then
        heal whatever is drained and idle.  Serialised — the periodic
        maintenance thread and explicit ``check_tenant`` calls never
        run surgery concurrently."""
        with self._maint_lock:
            report: Dict[str, Any] = {"checked": [], "healed": []}
            if check:
                report["checked"] = self.check()
            report["healed"] = self.heal_drained()
            return report

    # -- lifecycle / telemetry ---------------------------------------------

    def stop(self) -> None:
        for r in self.replicas:
            try:
                r.server.stop()
            except Exception:                   # noqa: BLE001 — best effort
                pass

    def view(self) -> Dict[str, Any]:
        return {"replicas": [r.view() for r in self.replicas],
                "version": self.version, "refs": self.refs,
                "unhealthy_k": self.unhealthy_k,
                "max_fault_rows": self.max_fault_rows,
                "serving": sum(1 for r in self.replicas
                               if r.state == "serving")}
