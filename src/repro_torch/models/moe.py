"""Mixture-of-experts FFN with capacity-based dispatch (the port of the
reference's ``models/moe.py``).

The router is a ``matmul -> topk`` dataflow, the paper's
DotProdSimPattern.  With ``router_offload="cam"`` its top-k runs as a
CAM best-match search over the router's columns stored as patterns: on
a CUDA tensor kernel B2 (``kernels/ops.py::cam_topk``, dot metric,
``largest=True``), on a CPU tensor its plain tiled twin
(``kernels/ref.py::cam_topk_tiled``) exactly as the reference calls it.
``"dense"`` is a float32 matrix product and a stable top-k.  Both break
ties toward the lower expert index; their scores agree up to float32
summation order (B2 sums in 3xTF32).  The LM reaches B2 through
``kernels/lm_ops.py::router`` (its custom op on fake tensors).

Dispatch writes each kept (token, slot) row into ``(E, C, D)`` buffers
with one non-accumulating ``index_put_``; dropped rows go to one spare
row that is never read, so no float sum depends on an order.  The three
expert products are batched matrix products.

With ``rules`` and DTensor activations, ``moe_ffn`` runs under
``local_map``.  Over a ``model`` axis of more than one rank that divides
the expert count it runs expert-parallel (the reference's ``shard_map``
branch): tokens stay replicated over ``model``,
each model rank routes them with the replicated router (B2 on every
rank on the card) and runs its ``E / n`` experts, and the partial
results combine by a reduce-scatter onto the sequence-parallel layout
when ``n`` divides the sequence, else an all-reduce.  Capacity is
counted over the rank's local tokens, as the reference's is.  Otherwise
every rank routes all the tokens with every expert (capacity over all
of them, as the reference's unsharded path counts it).

Deepseek-moe (64 routed experts, top-6, 2 shared) and phi3.5-moe (16
routed, top-2) run through it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ref as kref
from ..kernels import lm_ops
from .sharding import is_dtensor
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
        return lm_ops.router(xt.float().contiguous(),
                             router_w.T.float().contiguous(), k)
    if offload != "dense":
        raise ValueError(f"router_topk: unknown offload {offload!r}")
    scores = xt.float() @ router_w.float()
    idx = kref.stable_topk(scores, k)
    return torch.gather(scores, -1, idx), idx


def _moe_routed(router_w: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                wo: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig, *,
                e_global: int = 0, e_offset: int = 0) -> torch.Tensor:
    """The routed experts of (T, D) tokens over a local expert slice
    ``[e_offset, e_offset + E_loc)`` of ``e_global`` experts (all of
    them by default): softmax gates at the chosen experts, renormalised;
    each expert takes its first ``capacity`` (token, slot) rows in token
    order and drops the rest.  The router spans every expert; rows
    routed to another slice weigh 0 here (the caller sums the slices)."""
    t, d = xt.shape
    e = wi.shape[0]
    e_global = e_global or e
    k = cfg.moe_top_k

    scores = xt.float() @ router_w.float()
    gate_all = torch.softmax(scores, dim=-1)
    # the choice carries no gradient (the reference's stop_gradient)
    _, expert_idx = router_topk(xt.detach(), router_w.detach(), k,
                                cfg.router_offload)
    gates = torch.gather(gate_all, -1, expert_idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    capacity = max(int(math.ceil(t * k / e_global * cfg.capacity_factor)),
                   8)

    # queue position of each (token, slot) within its global expert
    eidx = expert_idx.reshape(-1)
    pos = torch.cumsum(F.one_hot(eidx, e_global), dim=0)
    pos = torch.gather(pos, 1, eidx[:, None])[:, 0] - 1
    if e == e_global:
        keep = pos < capacity
        loc = eidx
    else:
        inside = (eidx >= e_offset) & (eidx < e_offset + e)
        keep = (pos < capacity) & inside
        loc = torch.where(inside, eidx - e_offset, 0)
    slot = loc * capacity + torch.clamp(pos, max=capacity - 1)

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

    # combine: gather back and weight (dropped and remote slots weigh 0)
    w = (gates.reshape(-1) * keep.float()).to(dt)
    return (out[slot] * w[:, None]).view(t, k, d).sum(dim=1)


def _expert_parallel(rules) -> bool:
    n = 0 if rules is None else rules.model_size()
    return rules is not None and rules.model_axis is not None and n > 1


def _moe_ep(p: Params, x, cfg: ModelConfig, rules):
    """The routed experts expert-parallel over ``rules``' ``model`` axis
    (x a DTensor): each model rank runs its ``E / n`` experts on its data
    shard's tokens; the partial sums reduce-scatter onto ``Shard(seq)``
    when ``n`` divides S, else all-reduce."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from .sharding import shard_like
    b, s, d = x.shape
    e = cfg.n_experts
    n = rules.model_size()
    e_loc = e // n
    mesh = x.device_mesh
    names = list(rules.shape)
    mi = names.index(rules.model_axis)
    x = shard_like(rules, x, ("batch", None, None))
    router = p["router"].redistribute(mesh, [Replicate()] * len(names))

    def expert_pl(grad: bool):
        pl = [Partial() if grad else Replicate()] * len(names)
        pl[mi] = Shard(0)
        return tuple(pl)

    ws = [p[n_].redistribute(mesh, expert_pl(False))
          for n_ in ("wi", "wg", "wo")]
    rank = rules.model_rank()

    def body(xl, rw, wi, wg, wo):
        bl = xl.shape[0]
        y = _moe_routed(rw, wi, wg, wo, xl.reshape(bl * s, d), cfg,
                        e_global=e, e_offset=rank * e_loc)
        return y.view(bl, s, d)

    partial = list(x.placements)
    partial[mi] = Partial()
    xg = list(x.placements)
    xg[mi] = Partial()
    y = local_map(
        body, out_placements=list(partial),
        in_placements=(x.placements, router.placements) + tuple(
            w.placements for w in ws),
        in_grad_placements=(tuple(xg), tuple([Partial()] * len(names)))
        + (expert_pl(True),) * 3,
        device_mesh=mesh)(x, router, *ws)
    if s % n == 0:
        return shard_like(rules, y, ("batch", "seq_act", None))
    return shard_like(rules, y, ("batch", None, None))


def _moe_whole(p: Params, x, cfg: ModelConfig):
    """The routed experts of a DTensor ``x`` without expert parallelism
    (a ``model`` axis of 1, or one that does not divide the experts):
    every rank routes all the tokens with all the experts under
    ``local_map`` (capacity over all tokens, as the reference's GSPMD
    path counts it); the result is replicated."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    b, s, d = x.shape
    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    args = [x.redistribute(mesh, rep)] + [
        p[k].redistribute(mesh, rep) for k in ("router", "wi", "wg", "wo")]

    def body(xl, rw, wi, wg, wo):
        return _moe_routed(rw, wi, wg, wo, xl.reshape(b * s, d),
                           cfg).view(b, s, d)

    return local_map(body, out_placements=list(rep),
                     in_placements=(rep,) * 5, in_grad_placements=(rep,) * 5,
                     device_mesh=mesh)(*args)


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
            rules=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): the routed experts plus the shared
    ones (always on).  With ``rules`` whose ``model`` axis (of size > 1)
    divides the expert count, the routed experts run expert-parallel."""
    b, s, d = x.shape
    if rules is not None and is_dtensor(x):
        if _expert_parallel(rules) and \
                cfg.n_experts % rules.model_size() == 0:
            y = _moe_ep(p, x, cfg, rules)
        else:
            y = _moe_whole(p, x, cfg)
        if cfg.n_shared_experts:
            y = y + _shared(p, x, cfg)
        return y
    xt = x.reshape(b * s, d)
    yt = _moe_routed(p["router"], p["wi"], p["wg"], p["wo"], xt, cfg)
    if cfg.n_shared_experts:
        yt = yt + _shared(p, xt, cfg)
    return yt.view(b, s, d)


def _shared(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    hs = F.silu(x @ p["shared_wi"].to(x.dtype)) \
        * (x @ p["shared_wg"].to(x.dtype))
    return hs @ p["shared_wo"].to(x.dtype)


def aux_load_balance_loss(scores: torch.Tensor, expert_idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    gate = torch.softmax(scores.float(), dim=-1)
    me = gate.mean(0)
    flat = expert_idx.reshape(-1).long()
    ce = torch.bincount(flat, minlength=n_experts) / flat.numel()
    return n_experts * torch.sum(me * ce)
