"""``PlanBase``: the machinery shared by every plan family.

A *plan* is a compiled, cached, reusable executable for one program
shape.  Its lifecycle: ``prepare`` (encode/pack/lay out the stored
operands, memoised per source tensor) → ``dispatch`` (micro-batched
chunk execution) → ``finalize`` (ragged slicing / output shaping).

:class:`PlanBase` owns that lifecycle: the spec, backend, micro-batch,
packing, device, telemetry counters, the pattern-memo LRU and its
locks, and the dispatch skeleton.  Leaf families override only how
stored operands are wired from the module arguments, how a chunk result
is recorded, and how chunks finalize.  Gallery mutation
(``update_rows``) and fault injection come with later slices.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Tuple

import torch

from ...obs.trace import trace_span, tracer
from ..envcfg import env_int
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
    """A dispatched search: per-micro-batch chunk results
    ``(values, indices, valid_rows)``, possibly still computing on the
    device (kernels launch asynchronously on the current stream).
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


def _memoised_prepare(plan, srcs: Tuple[Any, ...], run: Callable[[], Any],
                      check: Callable[[], None]):
    """Per-plan pattern-prep memoisation.

    Only tensors are memoised: a numpy array can be mutated in place
    without trace, so it is prepared again on every call (and counted as
    a miss).  An entry keeps strong references to its sources so their
    ids cannot be recycled while it lives; inserting the prepared layout
    of an edited tensor drops the entries of its older versions.
    ``check`` runs only when actually preparing.
    """
    if not all(isinstance(s, torch.Tensor) for s in srcs):
        with plan._pattern_lock:
            plan.pattern_misses += 1
        check()
        return run()
    key = tuple(_src_ident(s) for s in srcs)
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
    stale = tuple(k[:-1] for k in key)
    with plan._pattern_lock:
        plan.pattern_misses += 1
        for old in [k for k in plan._pattern_cache
                    if tuple(s[:-1] for s in k) == stale]:
            del plan._pattern_cache[old]
        plan._pattern_cache[key] = (srcs, prepared)
        while len(plan._pattern_cache) > plan._pattern_cache_slots():
            plan._pattern_cache.popitem(last=False)
            plan.pattern_evictions += 1
    return prepared


@dataclass
class PlanBase:
    """Shared base of every compiled plan."""

    spec: Any
    backend: str
    batch: int
    _prepare: Callable = field(repr=False)
    _chunk_fn: Callable = field(repr=False)
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

    def _chunk_entry(self, out, valid: int):
        raise NotImplementedError

    def finalize(self, pending: "PendingSearch"):
        raise NotImplementedError

    # -- prepare -----------------------------------------------------------

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _prepared_patterns(self, *srcs):
        """Encode + lay out the stored operands, memoised per source
        tensor (see :func:`_memoised_prepare`)."""
        def check():
            # packing collapses non-binary alphabets silently: guard the
            # gallery whenever it is actually prepared
            if self.packed and self.spec.metric == "hamming":
                _check_binary_cells(srcs[0], "patterns")

        def run():
            return self._prepare(*(self._to_device(s) for s in srcs))

        return _memoised_prepare(self, tuple(srcs), run, check)

    # -- dispatch / execute ------------------------------------------------

    def dispatch(self, *inputs, faults=None) -> "PendingSearch":
        """Enqueue the plan's chunks without waiting for device results.

        Thread-safe: the memo and the counters have their own locks.
        ``faults`` must be ``None``: fault injection comes with a later
        slice of the port.
        """
        if faults is not None:
            raise NotImplementedError(
                "fault injection (repro.faults) is not ported to "
                "repro_torch yet; pass faults=None")
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
        q2, lead = _as_2d(self._to_device(q_src))
        m = q2.shape[0]
        with torch.no_grad(), trace_span(
                "plan.dispatch",
                args=None if not tracer.enabled else
                {"plan": type(self).__name__, "family": self.family,
                 "m": m, "batch": self.batch}):
            pp = self._prepared_patterns(*srcs)

            b = self.batch
            if self.tiny and m <= b:
                # the whole gallery is one dense tile and the queries fit
                # one micro-batch: no chunk loop, padding or slicing
                out = self._chunk_fn(q2, pp)
                with self._stats_lock:
                    self.chunks_run += 1
                return PendingSearch(plan=self, m=m, lead=lead,
                                     chunks=[self._chunk_entry(out, m)])
            chunks = []
            for s in range(0, m, b):
                chunk = q2[s:s + b]
                valid = chunk.shape[0]
                if valid < b:      # the ragged tail runs at the full batch
                    chunk = torch.nn.functional.pad(chunk,
                                                    (0, 0, 0, b - valid))
                out = self._chunk_fn(chunk, pp)
                with self._stats_lock:
                    self.chunks_run += 1
                chunks.append(self._chunk_entry(out, valid))
            return PendingSearch(plan=self, m=m, lead=lead, chunks=chunks)

    def execute(self, *inputs, faults=None):
        """Run the plan on exactly the compiled module's arguments; the
        results are tensors on the plan's device."""
        return self.finalize(self.dispatch(*inputs, faults=faults))
