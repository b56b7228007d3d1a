"""Error-feedback gradient compression (the port of the reference's
``distributed/compression.py``).

Both compressors follow the EF-SGD recipe (Karimireddy et al. 2019):

    c_t   = C(g_t + e_t)          # compress gradient + carried error
    e_t+1 = (g_t + e_t) - c_t     # residual stays local, re-injected later

which keeps the long-run gradient unbiased although every step's message
is lossy.  State is one float32 residual per parameter leaf.  The
transform is applied to the gradient tree before ``adamw_update``
(``models.steps.make_train_step(compressor=)``).

A sharded gradient (a DTensor leaf) is compressed as the reference
compresses its global array: the leaf is taken whole (``full_tensor``),
so int8 has one scale per whole tensor and top-k one threshold over the
whole flattened tensor, and the compressed leaf goes back into the
gradient's placements (each rank keeps its own block; no more
communication).  The residual stays whole on every rank: replicated, as
the reference's ``P()`` state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from ..tree import tree_map

__all__ = ["CompressionState", "NoCompression", "ErrorFeedbackInt8",
           "ErrorFeedbackTopK"]


class CompressionState(NamedTuple):
    error: Any            # residual tree (float32)


def init_state(params: Any) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _whole(g: torch.Tensor):
    """``(g taken whole, put)``: ``put(t)`` places a whole tensor as ``g``
    is placed (a DTensor gradient; a partial sum's placement becomes
    replicated), else returns it."""
    from ..models.sharding import is_dtensor
    if not is_dtensor(g):
        return g, lambda t: t
    from torch.distributed.tensor import Replicate, distribute_tensor
    places = [Replicate() if pl.is_partial() else pl for pl in g.placements]
    return g.full_tensor(), lambda t: distribute_tensor(
        t, g.device_mesh, places, src_data_rank=None)


def _apply(fn, grads, error) -> Tuple[Any, Any]:
    """``fn(g, e) -> (compressed, residual)`` at each leaf of a gradient
    tree (dicts and lists): the tree of each.  A DTensor leaf reaches
    ``fn`` whole, and its compressed leaf goes back into its
    placements."""
    if isinstance(grads, dict):
        parts = {k: _apply(fn, v, error[k]) for k, v in grads.items()}
        return ({k: c for k, (c, _) in parts.items()},
                {k: r for k, (_, r) in parts.items()})
    if isinstance(grads, (list, tuple)):
        parts = [_apply(fn, v, e) for v, e in zip(grads, error)]
        return ([c for c, _ in parts], [r for _, r in parts])
    whole, put = _whole(grads)
    comp, residual = fn(whole, error)
    return put(comp), residual


@dataclass(frozen=True)
class NoCompression:
    ratio: float = 1.0

    def init(self, params):
        return CompressionState(error=None)

    def __call__(self, grads, state: CompressionState
                 ) -> Tuple[Any, CompressionState]:
        return grads, state


@dataclass(frozen=True)
class ErrorFeedbackInt8:
    """Per-tensor symmetric int8 quantization with error feedback."""

    ratio: float = 0.25          # bytes vs float32 (int8 / float32)

    def init(self, params):
        return init_state(params)

    def _q(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return q, scale

    def __call__(self, grads, state: CompressionState
                 ) -> Tuple[Any, CompressionState]:
        def leaf(g, e):
            x = g.float() + e
            q, scale = self._q(x)
            c = q.float() * scale
            return c, x - c
        comp, err = _apply(leaf, grads, state.error)
        return comp, CompressionState(error=err)


@dataclass(frozen=True)
class ErrorFeedbackTopK:
    """Magnitude top-k sparsification (density = kept fraction)."""

    density: float = 0.1

    @property
    def ratio(self) -> float:
        return 2.0 * self.density    # value + index per kept entry

    def init(self, params):
        return init_state(params)

    def __call__(self, grads, state: CompressionState
                 ) -> Tuple[Any, CompressionState]:
        def leaf(g, e):
            x = g.float() + e
            flat = x.reshape(-1)
            k = max(1, int(flat.numel() * self.density))
            thresh = torch.topk(flat.abs(), k).values[-1]
            kept = torch.where(x.abs() >= thresh, x, 0.0)
            return kept, x - kept
        comp, err = _apply(leaf, grads, state.error)
        return comp, CompressionState(error=err)
