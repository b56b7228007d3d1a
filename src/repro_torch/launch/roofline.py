"""Roofline terms of one step at the H100's peaks (the port of the
reference's ``launch/roofline.py``).

The reference parses a compiled, partitioned HLO module.  The port has
no compiler to ask: :func:`analyze_step` runs the step once under a
``TorchDispatchMode`` that tallies each operation a device runs, and is
meant for a step traced on fake tensors (``FakeTensorMode``: shapes
only, nothing allocated; the dry run's per-device shapes under a fake
process group).  It counts, per device:

* matrix-product FLOPs (``mm``, ``bmm``, ``addmm``, ``baddbmm``:
  ``2 * M * N * K``),
* the LM's kernels by formula, from their custom ops
  (``kernels/lm_ops.py``): B7 ``4 * B * H * dh`` per visible (query,
  key) pair, B7b two and a half times that, B2 as the router ``2 * T *
  E * D``,
* HBM traffic: the bytes in and out of every operation that moves data
  (views move none),
* collective bytes of the ``_c10d_functional`` collectives DTensor and
  the model issue, at ring costs: all-reduce ``2(n-1)/n * B``,
  all-gather / reduce-scatter / all-to-all ``(n-1)/n * B``.

Under DTensor, the tally sees each rank's local operations and the
collectives of every redistribution (a DTensor operation defers to
DTensor's own dispatch, whose local work then reaches the tally); the
global-shape operations DTensor runs on fake tensors to propagate
shapes are left out.

The three terms are *seconds per step on one card*:

    compute    = FLOPs / PEAK_FLOPS
    memory     = HBM bytes / HBM_BW
    collective = node-local collective bytes / LINK_BW
                 + collective bytes of groups that span nodes / NIC_BW

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W
(card: ``H100 80GB HBM3, 700.00 W``): 989 TFLOP/s bf16 on the tensor
cores, 3.35 TB/s HBM3, and 450 GB/s each way on NVLink 4 (900 GB/s both
ways).  NVLink joins the ``NODE_GPUS`` = 8 cards of one node (NVIDIA's
DGX H100 data sheet); between nodes each card has one ConnectX-7 NIC at
400 Gb/s, 50 GB/s each way.  Ranks are placed on nodes in order (rank
``r`` on node ``r // NODE_GPUS``), so on the 16 x 16 and 2 x 16 x 16
meshes every axis spans nodes: a group whose ranks share one node is
charged at NVLink's rate, any other at the NIC's, as a flat ring.  The
seconds are analytic, not measured.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["RooflineReport", "analyze_step", "repeated", "PEAK_FLOPS", "HBM_BW",
           "LINK_BW", "NIC_BW", "NODE_GPUS", "HBM_BYTES", "CARD",
           "model_flops",
           "bottleneck_advice", "attention_pairs"]

#: the card the peaks are for (``nvidia-smi --query-gpu=name,power.limit``)
CARD = "H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s (data sheet)
HBM_BW = 3.35e12             # B/s (data sheet)
LINK_BW = 450e9              # NVLink 4, one direction (data sheet: 900 both)
NODE_GPUS = 8                # cards on one node's NVLink (DGX H100 data sheet)
NIC_BW = 50e9                # one ConnectX-7 a card, 400 Gb/s one direction
HBM_BYTES = 80e9             # device memory (data sheet)


@dataclass
class RooflineReport:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0          # ring-model bytes per device
    # the part of collective_bytes in groups that span nodes (at NIC_BW)
    collective_bytes_internode: float = 0.0
    collective_counts: Dict[str, int] = field(default_factory=dict)
    collective_bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    dot_count: int = 0
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    kernel_flops: Dict[str, float] = field(default_factory=dict)
    op_counts: Dict[str, int] = field(default_factory=dict)
    # the most bytes of the tensors the call made that were live at once
    # (per device: storages of the local blocks; the call's arguments
    # are not counted)
    temp_peak_bytes: int = 0

    # -- derived -----------------------------------------------------------
    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        inter = self.collective_bytes_internode
        return (self.collective_bytes - inter) / LINK_BW + inter / NIC_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 t_bound=self.t_bound)
        return d


# ---------------------------------------------------------------------------
# the tally
# ---------------------------------------------------------------------------

#: the product of the active :func:`repeated` factors
_REPEAT: List[int] = [1]


@contextlib.contextmanager
def repeated(n: int):
    """Operations tallied inside count ``n`` times: a trace runs one of
    ``n`` identical iterations (a microbatch of a fake-tensor step) and
    stands for all of them, as a scan's body counts times its trip
    count."""
    _REPEAT.append(_REPEAT[-1] * int(n))
    try:
        yield
    finally:
        _REPEAT.pop()


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def attention_pairs(s: int, t: int, causal: bool, prefix_len: int,
                    kv_len: int, q_start: int) -> int:
    """Visible (query, key) pairs of one head of B7: each of ``s`` rows
    sees keys ``j < kv_len`` (``kv_len < 0``: all ``t``) with ``j <=
    q_start + i`` or ``j < prefix_len`` when causal, all of them
    otherwise."""
    t = t if kv_len < 0 else kv_len
    if not causal:
        return s * t
    rows = np.arange(q_start + 1, q_start + s + 1, dtype=np.int64)
    return int(np.minimum(t, np.maximum(rows, prefix_len)).sum())


_VIEWS = {"view", "_unsafe_view", "reshape", "t", "transpose", "permute",
          "expand", "slice", "select", "unsqueeze", "squeeze", "as_strided",
          "detach", "alias", "unbind", "split", "split_with_sizes", "chunk",
          "narrow", "view_as_real", "view_as_complex", "_reshape_alias",
          "lift_fresh", "empty", "empty_strided", "empty_like",
          "new_empty", "new_empty_strided", "_local_scalar_dense", "sym_size",
          "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
          "wait_tensor"}
_DOTS = {"mm", "bmm", "addmm", "baddbmm"}
_RING = {"all_reduce": 2.0, "all_reduce_": 2.0,
         "all_gather_into_tensor": 1.0, "reduce_scatter_tensor": 1.0,
         "all_to_all_single": 1.0, "all_gather_into_tensor_coalesced": 1.0,
         "reduce_scatter_tensor_coalesced": 1.0,
         "all_reduce_coalesced": 2.0}


def _group(args, n_devices: int) -> Tuple[int, bool]:
    """(size, whether it spans nodes) of a collective's group; a group
    the tally cannot resolve is ``n_devices`` ranks from rank 0."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, str):
            try:
                ranks = dist.get_process_group_ranks(
                    _resolve_process_group(a))
            except Exception:          # noqa: BLE001  not a group name
                continue
            return len(ranks), len({r // NODE_GPUS for r in ranks}) > 1
    n = max(1, n_devices)
    return n, n > NODE_GPUS


def _storage(t):
    """(key, bytes) of ``t``'s storage (a DTensor's local block's); None
    for a tensor without one."""
    t = getattr(t, "_local_tensor", t)
    try:
        st = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None
    return st._cdata, st.nbytes()


class _Live:
    """The bytes of the storages a call makes, live at once: each storage
    counts from the first tensor on it that an operation returns until
    the last such tensor is freed (a view or an in-place result holds
    it too).  Storages of the call's arguments are not counted."""

    def __init__(self, args):
        self.known = {st[0] for st in map(_storage, _tensors(args))
                      if st is not None}
        self.refs: Dict[int, List[int]] = {}
        self.live = self.peak = 0

    def hold(self, out) -> None:
        for t in _tensors(out):
            st = _storage(t)
            if st is None or st[0] in self.known:
                continue
            key, nbytes = st
            ref = self.refs.get(key)
            if ref is None:
                ref = self.refs[key] = [nbytes, 0]
                self.live += nbytes
                self.peak = max(self.peak, self.live)
            ref[1] += 1
            weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        ref = self.refs.get(key)
        if ref is not None:
            ref[1] -= 1
            if ref[1] == 0:
                self.live -= ref[0]
                del self.refs[key]


class _Tally(TorchDispatchMode):
    def __init__(self, rep: RooflineReport, n_devices: int,
                 live: Optional[_Live] = None):
        super().__init__()
        self.rep = rep
        self.n = n_devices
        self.shadow = 0             # inside DTensor's shape propagation
        self.live = live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # DTensor's dispatch, then us
        out = func(*args, **kwargs)
        if self.shadow:
            return out
        if self.live is not None:
            self.live.hold(out)
        ns = func.namespace
        name = func.__name__.split(".")[0]
        if ns == "prim" or name in _VIEWS:
            return out
        rep = self.rep
        w = _REPEAT[-1]
        key = f"{ns}.{name}"
        rep.op_counts[key] = rep.op_counts.get(key, 0) + w
        ins = _tensors(list(args) + list(kwargs.values()))
        outs = _tensors(out)
        moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if ns == "_c10d_functional" and name in _RING:
            n, internode = _group(args, self.n)
            payload = max(sum(_nbytes(t) for t in ins),
                          sum(_nbytes(t) for t in outs))
            comm = w * _RING[name] * (n - 1) / max(n, 1) * payload
            if internode:
                rep.collective_bytes_internode += comm
            kind = name.rstrip("_").replace("_into_tensor", "").replace(
                "_tensor", "").replace("_coalesced", "").replace("_single",
                                                                 "")
            rep.collective_counts[kind] = rep.collective_counts.get(
                kind, 0) + w
            rep.collective_bytes_by_kind[kind] = \
                rep.collective_bytes_by_kind.get(kind, 0.0) + comm
            rep.collective_bytes += comm
            rep.hbm_bytes += w * moved
            return out
        flops = 0.0
        if ns == "aten" and name in _DOTS:
            flops = w * _dot_flops(name, args)
            rep.dot_count += w
        elif ns == "repro_torch":
            flops = w * _kernel_flops(name, args)
            rep.kernel_calls[name] = rep.kernel_calls.get(name, 0) + w
            rep.kernel_flops[name] = rep.kernel_flops.get(name, 0.0) + flops
        rep.flops += flops
        rep.hbm_bytes += w * moved
        return out


def _dot_flops(name: str, args) -> float:
    if name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    if name in ("mm", "addmm"):
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _kernel_flops(name: str, args) -> float:
    if name == "router_topk":
        q, pats = args[0], args[1]
        return 2.0 * q.shape[0] * pats.shape[0] * q.shape[1]
    q, k = args[0], args[1]
    b, s, h, dh = q.shape
    if name == "flash_attention":
        causal, prefix_len, kv_len, q_start = args[3:7]
    else:                                              # flash_attention_bwd
        causal, prefix_len, kv_len, q_start = args[6:10]
    pairs = attention_pairs(s, k.shape[1], causal, prefix_len, kv_len,
                            q_start)
    fwd = 4.0 * b * h * dh * pairs
    return fwd if name == "flash_attention" else 2.5 * fwd


class _Reentrant:
    """A context manager usable again and again (the propagation lock is
    entered once per propagated operation)."""

    def __init__(self, factory):
        self.factory = factory
        self.stack = []

    def __enter__(self):
        cm = self.factory()
        self.stack.append(cm)
        return cm.__enter__()

    def __exit__(self, *exc):
        return self.stack.pop().__exit__(*exc)


def analyze_step(fn: Callable, *args, n_devices: int = 1,
                 **kwargs) -> Tuple[Any, RooflineReport]:
    """``(fn(*args, **kwargs), report)``: the per-device roofline tally of
    one call (see the module docstring).  ``n_devices`` is the group size
    charged to a collective whose group the tally cannot resolve."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    rep = RooflineReport()
    live = _Live((args, kwargs))
    tally = _Tally(rep, n_devices, live)
    old = ShardingPropagator._fake_mode_lock

    @contextlib.contextmanager
    def marked():
        tally.shadow += 1
        try:
            with old:
                yield
        finally:
            tally.shadow -= 1

    ShardingPropagator._fake_mode_lock = _Reentrant(marked)
    try:
        with tally:
            out = fn(*args, **kwargs)
    finally:
        ShardingPropagator._fake_mode_lock = old
    rep.temp_peak_bytes = live.peak
    return out, rep


# ---------------------------------------------------------------------------
# advice and the analytic model FLOPs (the "useful compute" yardstick)
# ---------------------------------------------------------------------------


def bottleneck_advice(bottleneck: str, kind: str, family: str) -> str:
    """One sentence per cell: what would move the dominant term down."""
    if bottleneck == "collective":
        if kind == "train":
            return ("fewer gradient-accumulation microbatches (each one "
                    "gathers the FSDP weights again) and bf16 "
                    "reduce-scatters of the gradients; overlap the weight "
                    "all-gathers with the previous layer's compute")
        if kind == "prefill":
            return ("keep attention tensor-parallel over local heads (B7 "
                    "per rank under local_map) so no score-sized tensor "
                    "crosses NVLink; KV-length splitting only for head "
                    "counts the model axis does not divide")
        return ("decode collectives are weight-gather dominated: keep "
                "weights stationary (contract over the sharded axis, "
                "reduce the small outputs) instead of gathering them")
    if bottleneck == "memory":
        if kind == "decode":
            return ("bandwidth-bound on weights and KV cache: B7's "
                    "split-KV decode route over an fp8 / int8 cache, a "
                    "larger in-flight batch per card, or speculative "
                    "decoding to amortise weight reads")
        if kind == "prefill":
            return ("attention through B7's wgmma route keeps the (q, T) "
                    "score tiles in shared memory; fuse the norm and "
                    "projection epilogues so activations cross HBM once")
        return ("activation traffic: B7b's fused backward instead of "
                "recomputed scores, fewer remat passes (the 'dots' "
                "policy), and bf16 activations end to end")
    return ("compute-bound, the healthy case: raise the per-card batch or "
            "sequence to amortise the work off the tensor cores; check "
            "the useful-FLOPs ratio for remat waste")


def model_flops(cfg, shape) -> float:
    """6*N*D (train) / 2*N*D (inference) with N = active params.

    For decode, D = tokens processed in the step (= global_batch)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # one token per sequence
