"""Bounded, thread-safe span recorder with Chrome-tracing export.

One process-wide :class:`TraceRecorder` collects timing spans from the
engine (plan compile/prepare/dispatch/finalize), the serving batcher
(batch fill/dispatch/finalize, per-request queue-wait vs service
windows) and the gateway (admission, routing, failover, healing).  The
export is the Chrome Trace Event JSON format, loadable in Perfetto or
``chrome://tracing``: duration events (``ph: B``/``E``) for same-thread
nesting, complete events (``ph: X``) for cross-thread request windows,
instants (``ph: i``) for point occurrences, and ``M`` metadata rows
naming processes and threads.

Design constraints, in order:

* **Disabled must cost ~nothing.**  Every call site sits on a serving
  or engine hot path; when tracing is off, :func:`trace_span` returns
  one preallocated singleton and :func:`trace_begin` returns ``None``
  without allocating.  Event ``args`` are therefore a plain optional
  ``dict`` parameter, never ``**kwargs`` (which would build a dict per
  call even when disabled).
* **Bounded.**  Events land in a ``deque(maxlen=...)`` ring
  (``REPRO_TRACE_EVENTS``, default 65536): a long-running server keeps
  the most recent window and never grows without bound.  CPython's
  ``deque.append`` is atomic, so the hot path takes no lock.
* **Always exportable.**  ``to_chrome()`` repairs what a ring buffer
  and crashing threads can leave behind: an ``E`` whose ``B`` was
  evicted is dropped, a ``B`` that never saw its ``E`` is closed at
  the trace horizon.  Every ``B`` in the export has a matching ``E``.

Enabling: set ``REPRO_TRACE=/path/to/trace.json`` before import (the
trace is dumped at interpreter exit), or call :func:`enable` /
:func:`configure_from_env` explicitly.  ``CamSearchServer.dump_trace``
and ``CamServingGateway.dump_trace`` write the same process-wide
buffer on demand.
"""

from __future__ import annotations

import atexit
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..core.envcfg import env_choice, env_int, env_path

__all__ = [
    "TraceRecorder", "tracer", "enable", "stop", "configure_from_env",
    "trace_span", "trace_begin", "instant", "to_chrome", "dump",
    "span_stats",
]

#: stable pid assignment per component so cross-component traces line
#: up identically run to run
_PIDS = {"engine": 1, "serving": 2, "gateway": 3}


def _clock_ns() -> int:
    return time.perf_counter_ns()


class TraceRecorder:
    """Bounded ring of raw trace events.

    ``enabled`` is a plain attribute read (no property, no lock) — the
    disabled fast path is one attribute load and a branch.
    """

    def __init__(self, capacity: int = 65536, clock: str = "perf"):
        self.enabled = False
        self.capacity = int(capacity)
        self.clock = clock
        self._clock_ns = (time.monotonic_ns if clock == "mono"
                          else time.perf_counter_ns)
        self._events: deque = deque(maxlen=self.capacity)
        self._thread_names: Dict[int, str] = {}
        self._names_lock = threading.Lock()
        self._atexit_path: Optional[str] = None

    # -- hot path -------------------------------------------------------
    def now(self) -> int:
        return self._clock_ns()

    def emit(self, ph: str, name: str, pid: str, ts: int,
             dur: Optional[int] = None,
             args: Optional[Dict[str, Any]] = None,
             tid: Optional[int] = None) -> None:
        """Append one raw event.  Lock-free: ``deque.append`` with a
        ``maxlen`` is atomic under the GIL, and eviction of the oldest
        event is exactly the bounded-ring semantics we want."""
        if tid is None:
            t = threading.get_ident()
            if t not in self._thread_names:
                with self._names_lock:
                    self._thread_names.setdefault(
                        t, threading.current_thread().name)
        else:
            t = tid      # explicit origin tid: its name was learned
                         # when the origin thread opened the handle
        self._events.append((ph, name, pid, t, ts, dur, args))

    # -- control --------------------------------------------------------
    def start(self) -> None:
        self.enabled = True

    def stop(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self._events.clear()

    def __len__(self) -> int:
        return len(self._events)

    # -- export ---------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """Render the ring as a Chrome Trace Event JSON object.

        The raw ring may hold an ``E`` whose ``B`` was evicted (drop
        it) or a ``B`` still open when the snapshot was taken (close it
        at the horizon): the output satisfies "every B has an E" and
        per-thread monotonic nesting, which is what Perfetto requires
        to build flame graphs instead of dropping tracks.
        """
        raw = sorted(self._events, key=lambda e: e[4])
        if raw:
            t0 = raw[0][4]
            horizon = max(e[4] + (e[5] or 0) for e in raw)
        else:
            t0 = horizon = 0
        out: List[Dict[str, Any]] = []
        pids_seen: Dict[str, int] = {}
        tids_seen: Dict[int, str] = {}
        open_b: Dict[tuple, List[Dict[str, Any]]] = {}
        for ph, name, pid_label, tid, ts, dur, args in raw:
            pid = _PIDS.get(pid_label)
            if pid is None:
                pid = _PIDS[pid_label] = len(_PIDS) + 1
            pids_seen[pid_label] = pid
            tids_seen.setdefault(tid, self._thread_names.get(tid, ""))
            ev: Dict[str, Any] = {
                "name": name, "ph": ph, "pid": pid, "tid": tid,
                "ts": (ts - t0) / 1e3,      # ns -> µs
            }
            if args:
                ev["args"] = args
            if ph == "B":
                open_b.setdefault((pid, tid), []).append(ev)
            elif ph == "E":
                stack = open_b.get((pid, tid))
                if not stack:
                    continue                # B evicted from the ring
                stack.pop()
            elif ph == "X":
                ev["dur"] = (dur or 0) / 1e3
            elif ph == "i":
                ev["s"] = "t"               # thread-scoped instant
            out.append(ev)
        # close spans whose E never landed (thread died / ring snapshot
        # taken mid-span): synthesize the E at the trace horizon
        end_us = (horizon - t0) / 1e3
        for (pid, tid), stack in open_b.items():
            while stack:
                b = stack.pop()
                out.append({"name": b["name"], "ph": "E", "pid": pid,
                            "tid": tid, "ts": end_us})
        meta: List[Dict[str, Any]] = []
        for label, pid in sorted(pids_seen.items(), key=lambda kv: kv[1]):
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": label}})
        for tid, tname in tids_seen.items():
            for pid in pids_seen.values():
                meta.append({"name": "thread_name", "ph": "M",
                             "pid": pid, "tid": tid,
                             "args": {"name": tname or f"thread-{tid}"}})
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


#: process-wide recorder all call sites share
tracer = TraceRecorder()

#: singleton returned by trace_span when tracing is disabled — the
#: entire disabled path is: one attribute read, return this object
class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Same-thread duration span (``B`` on enter, ``E`` on exit)."""

    __slots__ = ("name", "pid", "args")

    def __init__(self, name: str, pid: str,
                 args: Optional[Dict[str, Any]]):
        self.name = name
        self.pid = pid
        self.args = args

    def __enter__(self):
        tracer.emit("B", self.name, self.pid, tracer.now(),
                    args=self.args)
        return self

    def __exit__(self, *exc):
        tracer.emit("E", self.name, self.pid, tracer.now())
        return False


def trace_span(name: str, pid: str = "engine",
               args: Optional[Dict[str, Any]] = None):
    """Context manager for a same-thread span.  Near-free when tracing
    is disabled: returns a shared no-op singleton without allocating."""
    if not tracer.enabled:
        return _NULL_SPAN
    return _Span(name, pid, args)


class _Handle:
    """Explicit begin/lap/end handle for cross-thread request flows.

    The lifetime is rendered as ``X`` (complete) events pinned to the
    *origin* thread, so one request stays a single track even though
    its phases execute on the submitter, batcher and completer threads.
    ``lap`` emits the window since the previous lap; ``end`` emits the
    whole lifetime.
    """

    __slots__ = ("name", "pid", "tid", "t0", "t_last", "args")

    def __init__(self, name: str, pid: str,
                 args: Optional[Dict[str, Any]]):
        self.name = name
        self.pid = pid
        self.tid = threading.get_ident()
        if self.tid not in tracer._thread_names:
            with tracer._names_lock:
                tracer._thread_names.setdefault(
                    self.tid, threading.current_thread().name)
        self.t0 = self.t_last = tracer.now()
        self.args = args

    def lap(self, name: str,
            args: Optional[Dict[str, Any]] = None) -> None:
        now = tracer.now()
        tracer.emit("X", name, self.pid, self.t_last,
                    dur=now - self.t_last, args=args, tid=self.tid)
        self.t_last = now

    def end(self, args: Optional[Dict[str, Any]] = None) -> None:
        now = tracer.now()
        merged = self.args
        if args:
            merged = {**(self.args or {}), **args}
        tracer.emit("X", self.name, self.pid, self.t0,
                    dur=now - self.t0, args=merged, tid=self.tid)


def trace_begin(name: str, pid: str = "serving",
                args: Optional[Dict[str, Any]] = None):
    """Open a cross-thread handle, or ``None`` when disabled (callers
    guard laps with ``if handle is not None``)."""
    if not tracer.enabled:
        return None
    return _Handle(name, pid, args)


def instant(name: str, pid: str = "serving",
            args: Optional[Dict[str, Any]] = None) -> None:
    """Point event (``ph: i``); no-op when disabled."""
    if not tracer.enabled:
        return
    tracer.emit("i", name, pid, tracer.now(), args=args)


def enable(capacity: Optional[int] = None,
           clock: Optional[str] = None) -> TraceRecorder:
    """(Re)configure and start the process-wide recorder."""
    if capacity is not None and capacity != tracer.capacity:
        tracer.capacity = int(capacity)
        tracer._events = deque(tracer._events, maxlen=tracer.capacity)
    if clock is not None and clock != tracer.clock:
        tracer.clock = clock
        tracer._clock_ns = (time.monotonic_ns if clock == "mono"
                            else time.perf_counter_ns)
    tracer.start()
    return tracer


def stop() -> None:
    tracer.stop()


def to_chrome() -> Dict[str, Any]:
    return tracer.to_chrome()


def dump(path: str) -> str:
    return tracer.dump(path)


def span_stats() -> Dict[str, Dict[str, float]]:
    """Aggregate the ring into per-span-name timing statistics.

    Pairs ``B``/``E`` duration events per (pid, tid) stack and takes
    ``X`` durations directly; returns ``{name: {count, total_ms,
    mean_ms, max_ms}}``.  This is the measured side of the roofline
    report (``benchmarks/report_roofline.py``) and the per-stage
    breakdown in ``bench_hier``.
    """
    raw = sorted(tracer._events, key=lambda e: e[4])
    open_b: Dict[tuple, List[tuple]] = {}
    agg: Dict[str, List[int]] = {}
    for ph, name, pid, tid, ts, dur, _args in raw:
        if ph == "B":
            open_b.setdefault((pid, tid), []).append((name, ts))
        elif ph == "E":
            stack = open_b.get((pid, tid))
            if stack:
                bname, bts = stack.pop()
                agg.setdefault(bname, []).append(ts - bts)
        elif ph == "X" and dur:
            agg.setdefault(name, []).append(dur)
    return {name: {"count": float(len(ds)),
                   "total_ms": sum(ds) / 1e6,
                   "mean_ms": sum(ds) / len(ds) / 1e6,
                   "max_ms": max(ds) / 1e6}
            for name, ds in sorted(agg.items())}


def _dump_atexit() -> None:
    if tracer._atexit_path and len(tracer):
        try:
            tracer.dump(tracer._atexit_path)
        except OSError:
            pass


def configure_from_env() -> Optional[str]:
    """Apply ``REPRO_TRACE`` / ``REPRO_TRACE_EVENTS`` /
    ``REPRO_TRACE_CLOCK``.  Returns the dump path when tracing was
    enabled by the environment, else ``None``.  Called once at import;
    tests call it again after monkeypatching the environment."""
    capacity = env_int("REPRO_TRACE_EVENTS", 65536, min_value=1)
    clock = env_choice("REPRO_TRACE_CLOCK", "perf", ("perf", "mono"))
    path = env_path("REPRO_TRACE")
    if path is None:
        # knobs still apply if tracing is later enabled explicitly
        if capacity != tracer.capacity or clock != tracer.clock:
            enable(capacity, clock)
            tracer.stop()
        tracer._atexit_path = None
        return None
    enable(capacity, clock)
    tracer._atexit_path = path
    return path


configure_from_env()
atexit.register(_dump_atexit)
