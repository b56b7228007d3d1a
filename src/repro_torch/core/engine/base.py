"""``PlanBase``: the machinery shared by every plan family.

A *plan* is a compiled, cached, reusable executable for one program
shape.  Its lifecycle: ``prepare`` (encode/pack/lay out the stored
operands, memoised per source tensor) → ``dispatch`` (micro-batched
chunk execution) → ``finalize`` (chunk concatenation / output shaping) →
``update_rows`` (row-granular incremental re-layout).

:class:`PlanBase` owns that lifecycle: the spec, backend, micro-batch,
packing, device, telemetry counters, the pattern-memo LRU and its
locks, the dispatch skeleton, the fault hooks (:func:`_normalize_faults`
and host-side corruption before the prepare) and the ``update_rows``
relay (:meth:`PlanBase._mutate_stored`,
:meth:`PlanBase._seed_updated_memo`).  Leaf families override only how
stored operands are wired from the module arguments and how chunks
finalize.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ...obs.trace import trace_span, tracer
from ..envcfg import env_flag, env_int
from .spec import _check_binary_cells

__all__ = ["PlanBase", "PendingSearch"]


def _pick_batch(m: int) -> int:
    """Micro-batch size: next power of two, clamped to the chunk cap
    (``REPRO_ENGINE_MAX_CHUNK``, default 1024; the clamp applies after
    rounding up, so a cap of 1000 bounds the batch at 1000)."""
    cap = env_int("REPRO_ENGINE_MAX_CHUNK", 1024, min_value=1)
    b = 8
    while b < min(max(m, 1), cap):
        b *= 2
    return min(b, cap)


def _update_enabled() -> bool:
    """``REPRO_ENGINE_UPDATE`` kill switch for the incremental update
    path: ``off``/``0`` makes ``update_rows`` still apply the mutation
    but skip the memo rewrite, so the next dispatch prepares in full."""
    return env_flag("REPRO_ENGINE_UPDATE", True)


def _normalize_faults(faults):
    """Validate/normalise a dispatch-time fault model.

    The engine duck-types the model (``is_null`` /
    ``corrupt_stored(srcs, spec)``, hashable) so ``repro_torch.core``
    never imports ``repro_torch.faults``.  Null models normalise to
    ``None``: ``FaultModel(p_stuck=0)`` takes exactly the clean code path
    (same memo key, same prepared layout, bit-identical results).  The
    model is not part of the plan-cache key: faults corrupt the stored
    sources host-side before the prepare, and the executables never see
    them.
    """
    if faults is None:
        return None
    if not hasattr(faults, "is_null") or not hasattr(faults, "corrupt_stored"):
        raise TypeError(
            f"faults must be a repro_torch.faults.FaultModel-like object, "
            f"got {type(faults).__name__}")
    return None if faults.is_null else faults


def _host(x) -> np.ndarray:
    """A stored operand as a host numpy array (the fault model's domain)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def resolve_device(device=None) -> torch.device:
    """The device a plan runs on: ``None`` means the current CUDA device.

    Asking for CUDA where none is available raises — the port never
    falls back to the CPU on its own; pass ``device="cpu"`` for that.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: repro_torch runs on the GPU unless "
                "the caller passes device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _as_2d(q: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    if q.dim() == 1:
        return q[None, :], ()
    if q.dim() == 2:
        return q, (q.shape[0],)
    lead = tuple(q.shape[:-1])
    return q.reshape((-1, q.shape[-1])), lead


def _size(shape: Tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


@dataclass
class PendingSearch:
    """A dispatched search: the chunk function's result for each
    micro-batch, possibly still computing on the device (kernels launch
    asynchronously on the current stream).
    :meth:`PlanBase.finalize` turns it into the final result."""

    plan: "PlanBase"
    m: int
    lead: Tuple[int, ...]
    chunks: list


def _src_ident(x: torch.Tensor) -> Tuple:
    """Memo identity of one stored-operand source tensor.

    Tensors are mutable, so the identity carries the storage address and
    the version counter every in-place op bumps: an edited gallery gets
    a new identity and is prepared again.
    """
    return (id(x), x.data_ptr(), tuple(x.shape), str(x.dtype),
            str(x.device), x._version)


def _memo_key(srcs: Tuple[Any, ...], faults) -> Tuple:
    """Pattern-memo key: each source's identity, then the fault model
    (``None`` for the clean layout)."""
    return tuple(_src_ident(s) for s in srcs) + (faults,)


def _memo_insert(plan, srcs: Tuple[Any, ...], prepared, faults=None) -> None:
    """Insert a prepared layout into the plan's pattern memo (LRU).

    The entry keeps strong references to its sources so their ids cannot
    be recycled while it lives; the entries of the same tensors' older
    versions (an in-place edit), clean or faulted, are dropped.
    ``faults`` joins the key: a faulted layout never shadows the clean
    one (or another model's).
    """
    key = _memo_key(srcs, faults)
    stale = tuple(i[:-1] for i in key[:-1])
    with plan._pattern_lock:
        for old in [k for k in plan._pattern_cache
                    if tuple(i[:-1] for i in k[:-1]) == stale
                    and k[:-1] != key[:-1]]:
            del plan._pattern_cache[old]
        plan._pattern_cache.pop(key, None)
        plan._pattern_cache[key] = (srcs, prepared)
        while len(plan._pattern_cache) > plan._pattern_cache_slots():
            plan._pattern_cache.popitem(last=False)
            plan.pattern_evictions += 1


def _memoised_prepare(plan, srcs: Tuple[Any, ...], run: Callable[[], Any],
                      check: Callable[[], None], faults=None):
    """Per-plan pattern-prep memoisation.

    Only tensors are memoised: a numpy array can be mutated in place
    without trace, so it is prepared again on every call (and counted as
    a miss).  ``check`` runs only when actually preparing.  ``faults``
    (a normalised fault model or ``None``) is part of the key: repeated
    dispatches with one model hit one corrupted layout while the clean
    entry stays untouched.
    """
    if not all(isinstance(s, torch.Tensor) for s in srcs):
        with plan._pattern_lock:
            plan.pattern_misses += 1
        check()
        return run()
    key = _memo_key(srcs, faults)
    with plan._pattern_lock:
        hit = plan._pattern_cache.get(key)
        if hit is not None:
            plan.pattern_hits += 1
            plan._pattern_cache.move_to_end(key)
            return hit[-1]
    with trace_span("plan.prepare",
                    args=None if not tracer.enabled else
                    {"plan": type(plan).__name__, "n": plan.spec.n}):
        check()
        prepared = run()
    with plan._pattern_lock:
        plan.pattern_misses += 1
    _memo_insert(plan, srcs, prepared, faults)
    return prepared


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _index_array(indices) -> np.ndarray:
    """Row indices of an update as a host int64 array (at least 1-D)."""
    if isinstance(indices, torch.Tensor):
        indices = indices.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(indices, np.int64))


@dataclass
class PlanBase:
    """Shared base of every compiled plan."""

    spec: Any
    backend: str
    batch: int
    _prepare: Callable = field(repr=False)
    _chunk_fn: Callable = field(repr=False)
    #: ``row_update(prepared, new_srcs, idx, donate)`` of the executable:
    #: re-lays only the rows (or row tiles) an ``update_rows`` touches
    _row_update: Optional[Callable] = field(default=None, repr=False)
    #: where the prepared operands live and the results are returned
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    shards: int = 1
    #: bit-packed execution (int32 lanes, XOR+popcount physical search)
    packed: bool = False
    #: dense one-tile executable (small single-column-tile programs)
    tiny: bool = False
    executions: int = 0
    chunks_run: int = 0
    pattern_hits: int = 0
    pattern_misses: int = 0
    pattern_evictions: int = 0
    row_updates: int = 0
    rows_updated: int = 0
    row_update_fallbacks: int = 0
    # pattern-counter values already folded into the process-wide
    # retained stats when the plan cache evicted this plan
    _retired_hits: int = field(default=0, repr=False)
    _retired_misses: int = field(default=0, repr=False)
    _retired_evictions: int = field(default=0, repr=False)
    _pattern_cache: "OrderedDict[Tuple, Tuple[Any, ...]]" = \
        field(default_factory=OrderedDict, repr=False)
    # plans are shared process-wide, so the memo needs its own lock
    _pattern_lock: threading.Lock = field(default_factory=threading.Lock,
                                          repr=False)
    _stats_lock: threading.Lock = field(default_factory=threading.Lock,
                                        repr=False)
    family: str = field(default="search", repr=False)

    @staticmethod
    def _pattern_cache_slots() -> int:
        """LRU bound on memoised prepared galleries (per plan),
        ``REPRO_ENGINE_PATTERN_SLOTS`` (default 4)."""
        return env_int("REPRO_ENGINE_PATTERN_SLOTS", 4, min_value=1)

    # -- family-specific wiring (leaf overrides) ---------------------------

    def _stored_sources(self, inputs) -> Tuple[Any, ...]:
        raise NotImplementedError

    def finalize(self, pending: "PendingSearch"):
        raise NotImplementedError

    # -- prepare -----------------------------------------------------------

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _queries_to_device(self, q) -> torch.Tensor:
        """Queries on the plan's device.  Host rows bound for a CUDA
        device go through pinned memory without a wait: a synchronous
        copy would hold the caller (a serving batcher) until the device
        had finished every earlier launch on the stream."""
        if self.device.type != "cuda" or not isinstance(q, np.ndarray):
            return self._to_device(q)
        host = torch.from_numpy(np.ascontiguousarray(q)).pin_memory()
        return host.to(self.device, non_blocking=True)

    def _prepared_patterns(self, *srcs, faults=None):
        """Encode + lay out the stored operands, memoised per source
        tensor (see :func:`_memoised_prepare`).

        ``faults`` (already normalised) corrupts the stored sources on
        the host, in numpy, *before* the prepare: the realised cells are
        the reference package's own, and the executables never see the
        model.
        """
        def check():
            # packing collapses non-binary alphabets silently: guard the
            # gallery whenever it is actually prepared
            if self.packed and self.spec.metric == "hamming":
                _check_binary_cells(srcs[0], "patterns")

        def run():
            if faults is not None:
                use = faults.corrupt_stored(tuple(_host(s) for s in srcs),
                                            self.spec)
                return self._prepare(*(self._to_device(u) for u in use))
            return self._prepare(*(self._to_device(s) for s in srcs))

        return _memoised_prepare(self, tuple(srcs), run, check, faults)

    def warm(self, *stored, faults=None) -> Tuple[torch.Tensor, ...]:
        """Prime the pattern memo for ``stored`` without dispatching.

        Converts the stored operands to tensors on the plan's device
        (numpy inputs would bypass the memo), prepares them once, and
        returns the converted source tuple: callers that keep serving
        from exactly these tensors hit the memo on every later dispatch.
        """
        faults = _normalize_faults(faults)
        srcs = tuple(self._to_device(s) for s in stored)
        with torch.no_grad():
            self._prepared_patterns(*srcs, faults=faults)
        return srcs

    def counters(self) -> dict:
        """Consistent copy of the plan's telemetry counters: execution
        counters under the stats lock, pattern-memo counters under the
        memo lock."""
        with self._stats_lock:
            out = {"executions": self.executions,
                   "chunks_run": self.chunks_run,
                   "row_updates": self.row_updates,
                   "rows_updated": self.rows_updated,
                   "row_update_fallbacks": self.row_update_fallbacks}
        with self._pattern_lock:
            out.update(pattern_hits=self.pattern_hits,
                       pattern_misses=self.pattern_misses,
                       pattern_evictions=self.pattern_evictions)
        return out

    # -- dispatch / execute ------------------------------------------------

    def dispatch(self, *inputs, faults=None) -> "PendingSearch":
        """Enqueue the plan's chunks without waiting for device results.

        Thread-safe: the memo and the counters have their own locks.
        Every launch goes to the calling thread's current CUDA stream.

        ``faults`` injects a device-fault model (see
        :mod:`repro_torch.faults`): the stored operands are corrupted on
        the host before the prepare, the queries and executables stay
        clean.  A null model is normalised away, so
        ``faults=FaultModel(p_stuck=0)`` is bit-identical to
        ``faults=None``.
        """
        faults = _normalize_faults(faults)
        with self._stats_lock:
            self.executions += 1
        spec = self.spec
        q_src = inputs[spec.query_arg]
        srcs = self._stored_sources(inputs)
        # host queries are checked for free; a CUDA tensor is not, since
        # the check would wait for the device in the middle of dispatch
        if self.packed and spec.metric == "hamming" and not (
                isinstance(q_src, torch.Tensor) and q_src.is_cuda):
            _check_binary_cells(q_src, "queries")
        q2, lead = _as_2d(self._queries_to_device(q_src))
        m = q2.shape[0]
        with torch.no_grad(), trace_span(
                "plan.dispatch",
                args=None if not tracer.enabled else
                {"plan": type(self).__name__, "family": self.family,
                 "m": m, "batch": self.batch}):
            pp = self._prepared_patterns(*srcs, faults=faults)

            chunks = []
            for s in range(0, m, self.batch):
                # the ragged tail runs at its own row count: rows are
                # independent and nothing here is compiled per shape
                chunks.append(self._chunk_fn(q2[s:s + self.batch], pp))
                with self._stats_lock:
                    self.chunks_run += 1
            return PendingSearch(plan=self, m=m, lead=lead, chunks=chunks)

    def execute(self, *inputs, faults=None):
        """Run the plan on exactly the compiled module's arguments; the
        results are tensors on the plan's device.  ``faults`` is
        forwarded to :meth:`dispatch`."""
        return self.finalize(self.dispatch(*inputs, faults=faults))

    # -- gallery mutation (update_rows relay machinery) --------------------

    def _validate_update(self, idx: np.ndarray, *new_rows) -> None:
        spec = self.spec
        if idx.ndim != 1:
            raise ValueError(f"indices must be 1-D, got shape {idx.shape}")
        if idx.size == 0:
            return
        if idx.min() < 0 or idx.max() >= spec.n:
            raise ValueError(
                f"row indices out of range for an n={spec.n} gallery")
        if np.unique(idx).size != idx.size:
            # a scatter with duplicate indices has no defined winner
            raise ValueError("duplicate row indices in update_rows")
        for nr in new_rows:
            if _shape(nr) != (idx.size, spec.dim):
                raise ValueError(
                    f"new rows shape {_shape(nr)} != "
                    f"({idx.size}, {spec.dim})")

    def _seed_updated_memo(self, old_srcs: Tuple[Any, ...], old_key,
                           new_srcs: Tuple[torch.Tensor, ...],
                           idx: np.ndarray, donate: bool) -> None:
        """Derive the mutated sources' prepared layout from the old one.

        Incremental only when the old layout is memoised (tensor sources
        that were prepared and not evicted) and the update path is
        enabled; otherwise a counted fallback, and the next dispatch
        prepares the new sources in full.  ``old_key`` is the old
        sources' memo key, taken before the mutation (an in-place update
        moves the version counter it holds).

        ``donate``: the old entry is popped and its prepared leaves are
        rewritten in place; otherwise the row update writes fresh leaves
        and the old entry, still serving the old gallery, is untouched.

        Only the clean (``faults=None``) entry is rewritten: fault draws
        are position-keyed, so a faulted layout is prepared again in full
        on the next faulted dispatch.
        """
        with self._stats_lock:
            self.row_updates += 1
            self.rows_updated += int(idx.size)
        if self._row_update is None or not _update_enabled() or \
                not all(isinstance(s, torch.Tensor) for s in old_srcs):
            with self._stats_lock:
                self.row_update_fallbacks += 1
            return
        with self._pattern_lock:
            if donate:       # the old layout must not outlive its buffers
                hit = self._pattern_cache.pop(old_key, None)
            else:
                hit = self._pattern_cache.get(old_key)
        if hit is None:
            with self._stats_lock:
                self.row_update_fallbacks += 1
            return
        prepared = self._row_update(hit[-1], new_srcs, idx, donate)
        _memo_insert(self, new_srcs, prepared)

    def _mutate_stored(self, olds: Tuple[Any, ...], news: Tuple[Any, ...],
                       idx: np.ndarray, donate: bool
                       ) -> Tuple[torch.Tensor, ...]:
        """Scatter the ``news`` row blocks into the leading stored
        operands and seed the mutated sources' memo entry.  Operands
        beyond ``len(news)`` (a ternary plan's care mask) pass through
        unchanged but stay part of the memo key.

        ``donate=False`` returns new tensors (clone, then ``index_copy_``);
        ``donate=True`` writes into the callers' tensors in place and
        returns them.  A numpy operand becomes a tensor on the plan's
        device (and the update counts as a fallback).
        """
        srcs = tuple(o if isinstance(o, torch.Tensor) else self._to_device(o)
                     for o in olds)
        if idx.size == 0:
            return srcs
        if self.packed and self.spec.metric == "hamming":
            _check_binary_cells(news[0], "updated rows")
        with torch.no_grad(), trace_span(
                "plan.update_rows",
                args=None if not tracer.enabled else
                {"plan": type(self).__name__, "rows": int(idx.size),
                 "donate": donate}):
            old_key = _memo_key(srcs, None)
            upd = []
            for g, nr in zip(srcs, news):
                j = torch.as_tensor(idx, device=g.device)
                rows = torch.as_tensor(nr, device=g.device).to(g.dtype)
                dst = g if donate else g.clone()
                upd.append(dst.index_copy_(0, j, rows))
            upd = tuple(upd) + srcs[len(news):]
            self._seed_updated_memo(olds, old_key, upd, idx, donate)
            return upd
