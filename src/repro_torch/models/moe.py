"""Mixture-of-experts FFN with capacity-based dispatch (the port of the
reference's ``models/moe.py``, single-device part).

The router is a ``matmul -> topk`` dataflow, the paper's
DotProdSimPattern.  With ``router_offload="cam"`` its top-k runs as a
CAM best-match search over the router's columns stored as patterns: on
a CUDA tensor kernel B2 (``kernels/ops.py::cam_topk``, dot metric,
``largest=True``), on a CPU tensor its plain tiled twin
(``kernels/ref.py::cam_topk_tiled``) exactly as the reference calls it.
``"dense"`` is a float32 matrix product and a stable top-k.  Both break
ties toward the lower expert index; their scores agree up to float32
summation order (B2 sums in 3xTF32).

Dispatch writes each kept (token, slot) row into ``(E, C, D)`` buffers
with one non-accumulating ``index_put_``; dropped rows go to one spare
row that is never read, so no float sum depends on an order.  The three
expert products are batched matrix products.  Left out here: the
reference's expert-parallel ``shard_map`` branch of ``moe_ffn`` (its
``rules=``), which comes with ``models/sharding.py`` (ROADMAP Queue A
item 8e).

Deepseek-moe (64 routed experts, top-6, 2 shared) and phi3.5-moe (16
routed, top-2) run through it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels import ref as kref
from .config import ModelConfig
from .layers import dense_init, pdtype

Params = Dict[str, Any]

__all__ = ["init_moe", "router_topk", "moe_ffn", "aux_load_balance_loss"]


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """One layer's router, routed experts and shared experts.  The routed
    experts' weights are float32 whatever ``param_dtype`` is, as the
    reference's init leaves them (its bf16 draw times a numpy float64
    scale promotes to float32); each call casts them to the compute
    dtype."""
    d = cfg.d_model
    de = cfg.d_expert or cfg.d_ff
    e = cfg.n_experts
    dt = pdtype(cfg)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=torch.float32).to(dt).float()

    p = {"router": dense_init(gen, d, e, dt),
         "wi": draw(e, d, de) * (1.0 / math.sqrt(d)),
         "wg": draw(e, d, de) * (1.0 / math.sqrt(d)),
         "wo": draw(e, de, d) / math.sqrt(de)}
    if cfg.n_shared_experts:
        ds = de * cfg.n_shared_experts
        p["shared_wi"] = dense_init(gen, d, ds, dt)
        p["shared_wg"] = dense_init(gen, d, ds, dt)
        p["shared_wo"] = dense_init(gen, ds, d, dt)
    return p


def router_topk(xt: torch.Tensor, router_w: torch.Tensor, k: int,
                offload: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` experts of (T, D) tokens under the (D, E) router:
    (T, k) float32 scores and int64 expert indices, best first, ties to
    the lower index.  ``offload="cam"`` searches the router's columns as
    CAM patterns (B2 on the card, raising if it cannot launch);
    ``"dense"`` is the plain float32 product and a stable sort."""
    if offload == "cam":
        e, d = router_w.shape[1], router_w.shape[0]
        q, pats = xt.float(), router_w.T.float()
        if xt.device.type == "cuda":
            vals, idx = kops.cam_topk(q, pats, metric="dot", k=k,
                                      largest=True)
        else:
            vals, idx = kref.cam_topk_tiled(
                q, pats, metric="dot", k=k, largest=True,
                tile_rows=min(32, e), dims_per_tile=min(128, d))
        return vals, idx.long()
    if offload != "dense":
        raise ValueError(f"router_topk: unknown offload {offload!r}")
    scores = xt.float() @ router_w.float()
    idx = kref.stable_topk(scores, k)
    return torch.gather(scores, -1, idx), idx


def _moe_routed(router_w: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                wo: torch.Tensor, xt: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """The routed experts of (T, D) tokens: softmax gates at the chosen
    experts, renormalised; each expert takes its first ``capacity``
    (token, slot) rows in token order and drops the rest."""
    t, d = xt.shape
    e = wi.shape[0]
    k = cfg.moe_top_k

    scores = xt.float() @ router_w.float()
    gate_all = torch.softmax(scores, dim=-1)
    # the choice carries no gradient (the reference's stop_gradient)
    _, expert_idx = router_topk(xt.detach(), router_w.detach(), k,
                                cfg.router_offload)
    gates = torch.gather(gate_all, -1, expert_idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    capacity = max(int(math.ceil(t * k / e * cfg.capacity_factor)), 8)

    # queue position of each (token, slot) within its expert
    eidx = expert_idx.reshape(-1)
    pos = torch.cumsum(F.one_hot(eidx, e), dim=0)
    pos = torch.gather(pos, 1, eidx[:, None])[:, 0] - 1
    keep = pos < capacity
    slot = eidx * capacity + torch.clamp(pos, max=capacity - 1)

    # dispatch: kept rows to their slots, dropped rows to the spare row;
    # each token's k copies by expand, whose gradient is a sum over k in
    # a fixed order (repeat_interleave's would be an index_add)
    buf = xt.new_zeros((e * capacity + 1, d))
    buf.index_put_((torch.where(keep, slot, e * capacity),),
                   xt[:, None].expand(t, k, d).reshape(t * k, d))
    buf = buf[:-1].view(e, capacity, d)

    dt = xt.dtype
    h = F.silu(torch.bmm(buf, wi.to(dt))) * torch.bmm(buf, wg.to(dt))
    out = torch.bmm(h, wo.to(dt)).view(e * capacity, d)

    # combine: gather back and weight (dropped slots weigh 0)
    w = (gates.reshape(-1) * keep.float()).to(dt)
    return (out[slot] * w[:, None]).view(t, k, d).sum(dim=1)


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): the routed experts plus the shared
    ones (always on)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    yt = _moe_routed(p["router"], p["wi"], p["wg"], p["wo"], xt, cfg)
    if cfg.n_shared_experts:
        hs = F.silu(xt @ p["shared_wi"].to(x.dtype)) \
            * (xt @ p["shared_wg"].to(x.dtype))
        yt = yt + hs @ p["shared_wo"].to(x.dtype)
    return yt.view(b, s, d)


def aux_load_balance_loss(scores: torch.Tensor, expert_idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    gate = torch.softmax(scores.float(), dim=-1)
    me = gate.mean(0)
    flat = expert_idx.reshape(-1).long()
    ce = torch.bincount(flat, minlength=n_experts) / flat.numel()
    return n_experts * torch.sum(me * ce)
