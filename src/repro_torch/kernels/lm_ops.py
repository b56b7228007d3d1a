"""The LM's kernels as ``torch.library`` custom ops: B7 (the attention
forward), B7b (its backward) and B2 as the MoE router's top-k.

Each op's implementation launches the kernel the LM's wrapper launches
(and counts the same launch); its fake implementation gives the
outputs' shapes and dtypes and runs nothing, so that a step traces under
``FakeTensorMode`` (the dry run, :mod:`repro_torch.launch.dryrun`) and a
roofline tally (:func:`repro_torch.launch.roofline.analyze_step`) sees
one op per kernel call, whose work it counts by formula.

The LM reaches each kernel through one dispatch, :func:`flash_fwd`,
:func:`flash_bwd` or :func:`router`: a fake tensor goes through the op,
a CUDA tensor straight to the kernel's wrapper (the op's dispatch adds
host time to every call, which the host-bound decode step cannot hide;
PERF.md §6), a CPU tensor to the kernel's plain version.  The CAM
engine calls B2 directly.  ``kv_len < 0`` stands for ``None``; with
``want_lse=False`` the forward's second output is an empty float32
tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor
from torch.library import custom_op

from . import flash_attention as fa

__all__ = ["flash_attention_op", "flash_attention_bwd_op", "router_topk_op",
           "is_fake", "flash_fwd", "flash_bwd", "router"]


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (shapes only, no storage)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _kv(kv_len: int):
    return None if kv_len < 0 else kv_len


def _fwd(q, k, v, causal, prefix_len, kv_len, q_start, want_lse):
    out, lse = fa._forward_cuda(q, k, v, causal, prefix_len, _kv(kv_len),
                                q_start, want_lse=want_lse)
    if not want_lse:
        lse = q.new_empty((0,), dtype=torch.float32)
    return out, lse


def _bwd(q, k, v, out, lse, d_out, causal, prefix_len, kv_len, q_start):
    return fa.flash_attention_backward(
        q, k, v, out, lse, d_out, causal=causal, prefix_len=prefix_len,
        kv_len=_kv(kv_len), q_start=q_start)


def _router(q, patterns, k):
    from . import ops as kops
    vals, idx = kops.cam_topk(q, patterns, metric="dot", k=k, largest=True)
    return vals.float(), idx.long()


@custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                       prefix_len: int, kv_len: int, q_start: int,
                       want_lse: bool) -> Tuple[Tensor, Tensor]:
    """B7: (out (B, S, H, dh), lse (B, H, S) float32 or empty)."""
    out, lse = _fwd(q, k, v, causal, prefix_len, kv_len, q_start, want_lse)
    return out.contiguous(), lse


@flash_attention_op.register_fake
def _(q, k, v, causal, prefix_len, kv_len, q_start, want_lse):
    b, s, h, _ = q.shape
    lse = q.new_empty((b, h, s) if want_lse else (0,), dtype=torch.float32)
    return torch.empty_like(q, memory_format=torch.contiguous_format), lse


@custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                           lse: Tensor, d_out: Tensor, causal: bool,
                           prefix_len: int, kv_len: int, q_start: int
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """B7b: (dq, dk, dv) in the dtypes of q, k and v."""
    dq, dk, dv = _bwd(q, k, v, out, lse, d_out, causal, prefix_len, kv_len,
                      q_start)
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


@flash_attention_bwd_op.register_fake
def _(q, k, v, out, lse, d_out, causal, prefix_len, kv_len, q_start):
    c = torch.contiguous_format
    return (torch.empty_like(q, memory_format=c),
            torch.empty_like(k, memory_format=c),
            torch.empty_like(v, memory_format=c))


@custom_op("repro_torch::router_topk", mutates_args=())
def router_topk_op(q: Tensor, patterns: Tensor, k: int
                   ) -> Tuple[Tensor, Tensor]:
    """B2 as the router: the ``k`` largest dot products of each float32
    row of ``q`` (T, D) over the rows of ``patterns`` (E, D), best
    first, ties to the lower index: (T, k) float32 values and int64
    indices.  The plain version is the reference's tiled CAM search."""
    vals, idx = _router(q, patterns, k)
    return vals.contiguous(), idx.contiguous()


@router_topk_op.register_fake
def _(q, patterns, k):
    t = q.shape[0]
    return (q.new_empty((t, k), dtype=torch.float32),
            q.new_empty((t, k), dtype=torch.int64))


# -- the LM's call sites --------------------------------------------------


def flash_fwd(q, k, v, causal: bool, prefix_len: int, kv_len: int,
              q_start: int, want_lse: bool):
    """B7's (out, lse): the op on a fake tensor, the kernel on a CUDA
    one (``lse`` None unless wanted), the plain version on a CPU one."""
    if is_fake(q):
        return flash_attention_op(q, k, v, causal, prefix_len, kv_len,
                                  q_start, want_lse)
    if q.device.type == "cpu":
        out, lse = fa.flash_attention_reference(
            q, k, v, causal=causal, prefix_len=prefix_len,
            kv_len=_kv(kv_len), q_start=q_start, return_lse=True)
        return out, lse if want_lse else lse.new_empty((0,))
    return fa._forward_cuda(q, k, v, causal, prefix_len, _kv(kv_len),
                            q_start, want_lse=want_lse)


def flash_bwd(q, k, v, out, lse, d_out, causal: bool, prefix_len: int,
              kv_len: int, q_start: int):
    """B7b's (dq, dk, dv): the op on a fake tensor, the wrapper (the
    kernel, or the plain version on the CPU) else."""
    if is_fake(q):
        return flash_attention_bwd_op(q, k, v, out, lse, d_out, causal,
                                      prefix_len, kv_len, q_start)
    return _bwd(q, k, v, out, lse, d_out, causal, prefix_len, kv_len,
                q_start)


def router(q, patterns, k: int):
    """B2 as the router: (T, k) float32 values and int64 indices; the op
    on a fake tensor, the kernel on a CUDA one, the plain version (the
    reference's tiled CAM search) on a CPU one."""
    if is_fake(q):
        return router_topk_op(q, patterns, k)
    if q.device.type == "cpu":
        from . import ref as kref
        e, d = patterns.shape
        vals, idx = kref.cam_topk_tiled(
            q, patterns, metric="dot", k=k, largest=True,
            tile_rows=min(32, e), dims_per_tile=min(128, d))
        return vals.float(), idx.long()
    return _router(q, patterns, k)
