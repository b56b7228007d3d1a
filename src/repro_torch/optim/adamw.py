"""AdamW with float32 master weights over trees of tensors (the port of
the reference's ``optim/adamw.py``).

State layout (one leaf per parameter leaf, the same tree):

* ``mu`` / ``nu``: first / second moments (``mu`` in ``mu_dtype``; ``nu``
  float32, or with ``factored_nu`` a ``{"vr", "vc"}`` pair of row and
  column means for a leaf of two or more dimensions),
* ``master``: float32 copy of the parameters (the parameters themselves
  may be bfloat16; updates are computed in float32 and cast back),
* ``count``: the step counter, a 0-dim int32 tensor on the host (the
  bias corrections are host arithmetic, so a step reads nothing back
  from the device for them).

Unlike the reference's pure function, :func:`adamw_update` writes the
new moments, master weights and parameters into their tensors in place
(under ``torch.no_grad``) and returns them: a model whose optimizer state
is 12 bytes a parameter has no room for a second copy.  For the same
reason the gradient is never copied whole to float32 for clipping: the
global norm is taken leaf by leaf, and each leaf is scaled inside its
own update.

The leaves may be DTensors (the sharded train step): moments and
master weights sit on their parameter's placements (the factored
``vr`` / ``vc`` on theirs, as ``launch.specs.state_sharding`` places
them), each rank updates its own blocks, and :func:`global_norm` sums
every shard's squares over the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..tree import leaves, leaves_with_paths, tree_map

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # leaves whose path contains one of these substrings skip weight decay
    no_decay_keys: Tuple[str, ...] = ("scale", "bias", "norm", "A_log", "D",
                                      "dt_bias")
    # Adafactor-style factored second moment for >= 2-D leaves, and a
    # reduced-precision first moment; the float32 master is unaffected
    factored_nu: bool = False
    mu_dtype: str = "float32"


class OptState(NamedTuple):
    mu: Any
    nu: Any
    master: Any
    count: torch.Tensor


def _is_factored(p: torch.Tensor, cfg: AdamWConfig) -> bool:
    return cfg.factored_nu and p.dim() >= 2


def _nu_init(p: torch.Tensor, cfg: AdamWConfig):
    if _is_factored(p, cfg):
        return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                  device=p.device),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                  dtype=torch.float32, device=p.device)}
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params: Any, cfg: AdamWConfig = AdamWConfig()) -> OptState:
    mu_dt = getattr(torch, cfg.mu_dtype)
    with torch.no_grad():
        return OptState(
            mu=tree_map(lambda p: torch.zeros(p.shape, dtype=mu_dt,
                                              device=p.device), params),
            nu=tree_map(lambda p: _nu_init(p, cfg), params),
            master=tree_map(lambda p: p.detach().to(torch.float32,
                                                    copy=True), params),
            count=torch.zeros((), dtype=torch.int32))


def _leaf_norm(g: torch.Tensor) -> torch.Tensor:
    """A leaf's 2-norm as a float32 scalar.  On the CPU ``vector_norm``
    adds the squares one after another, 0.6 % low over 7e7 float32
    elements, so there they are summed in float64; the card's reduction
    is a tree and sums in float32.  A DTensor's norm is its shards'
    norms combined over the mesh, a plain (replicated) scalar."""
    if _is_dt(g):
        return _leaf_norm_dt(g)
    if g.device.type == "cpu":
        return torch.linalg.vector_norm(g, dtype=torch.float64).float()
    return torch.linalg.vector_norm(g, dtype=torch.float32)


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a device
    scalar; no float32 copy of a leaf on the card)."""
    return torch.linalg.vector_norm(torch.stack(
        [_leaf_norm(g) for g in leaves(grads)]))


def _is_dt(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _leaf_norm_dt(g) -> torch.Tensor:
    """The 2-norm of a DTensor leaf: its local block's squares summed as
    :func:`_leaf_norm` sums them, then over the mesh dimensions that
    shard it (an all-reduce each); replicated dimensions add nothing.  A
    ``Partial`` leaf is reduced first (the squares of partial sums do not
    add up to the square of their sum)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = g.device_mesh
    if any(isinstance(pl, Partial) for pl in g.placements):
        g = g.redistribute(mesh, [Replicate() if isinstance(pl, Partial)
                                  else pl for pl in g.placements])
    loc = g.to_local()
    sq = (_leaf_norm(loc).double() ** 2 if loc.device.type == "cpu"
          else _leaf_norm(loc) ** 2)
    for i, pl in enumerate(g.placements):
        if isinstance(pl, Shard):
            sq = funcol.all_reduce(sq, "sum", (mesh, i))
    return torch.sqrt(sq).float()


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """The gradients in float32 scaled to a global norm of at most
    ``max_norm``, and the norm before clipping (the reference's
    function; :func:`adamw_update` clips leaf by leaf instead)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def _f32(x) -> np.float32:
    return np.float32(x)


def _update_leaf(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu,
                 w: torch.Tensor, decay: bool, scale: torch.Tensor,
                 lr: float, c1: float, c2: float, cfg: AdamWConfig) -> None:
    """One leaf's AdamW step, in place: the gradient scaled by the clip
    factor in float32, the moments, the master weight and the
    parameter.  DTensor leaves update their local blocks (a factored
    ``nu`` through DTensor reductions: its statistics span shards)."""
    if _is_dt(p):
        g = g.redistribute(p.device_mesh, p.placements)
        if isinstance(nu, dict):
            return _update_leaf_factored_dt(p, g, mu, nu, w, decay, scale,
                                            lr, c1, c2, cfg)
        p, g, mu, nu, w = (t.to_local() for t in (p, g, mu, nu, w))
    gf = g.float() * scale
    if mu.dtype == torch.float32:
        mu.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
        m = mu
    else:
        m = mu.float().mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
        mu.copy_(m)
        m = mu.float()
    if isinstance(nu, dict):                       # factored (Adafactor)
        g2 = gf.square_().add_(1e-30)
        nu["vr"].mul_(cfg.b2).add_(g2.mean(-1), alpha=1 - cfg.b2)
        nu["vc"].mul_(cfg.b2).add_(g2.mean(-2), alpha=1 - cfg.b2)
        del g2, gf
        vr, vc = nu["vr"] / c2, nu["vc"] / c2
        vhat = (vr / torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
                )[..., None] * vc[..., None, :]
        denom = vhat.sqrt_().add_(cfg.eps)
    else:
        nu.mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
        del gf
        denom = torch.div(nu, c2).sqrt_().add_(cfg.eps)
    upd = torch.div(m, c1).div_(denom)
    del denom
    if decay:
        upd.add_(w, alpha=cfg.weight_decay)
    w.sub_(upd.mul_(lr))
    p.copy_(w)


def _update_leaf_factored_dt(p, g, mu, nu, w, decay: bool, scale, lr: float,
                             c1: float, c2: float, cfg: AdamWConfig) -> None:
    """:func:`_update_leaf` of a DTensor leaf with a factored ``nu``: the
    row and column means are DTensor reductions redistributed onto
    ``vr`` / ``vc``'s placements; the rest updates local blocks."""
    mesh, pl = p.device_mesh, p.placements
    gl = g.to_local().float() * scale
    ml = mu.to_local()
    if ml.dtype == torch.float32:
        ml.mul_(cfg.b1).add_(gl, alpha=1 - cfg.b1)
        m = ml
    else:
        m = ml.float().mul_(cfg.b1).add_(gl, alpha=1 - cfg.b1)
        ml.copy_(m)
        m = ml.float()
    from torch.distributed.tensor import DTensor
    g2 = DTensor.from_local(gl.square_().add_(1e-30), mesh, pl,
                            run_check=False)
    for key, red in (("vr", g2.mean(-1)), ("vc", g2.mean(-2))):
        v = nu[key]
        v.to_local().mul_(cfg.b2).add_(
            red.redistribute(mesh, v.placements).to_local(),
            alpha=1 - cfg.b2)
    del g2, gl
    vr, vc = nu["vr"] / c2, nu["vc"] / c2
    vhat = (vr / torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
            )[..., None] * vc[..., None, :]
    denom = vhat.redistribute(mesh, pl).to_local().sqrt_().add_(cfg.eps)
    upd = torch.div(m, c1).div_(denom)
    wl = w.to_local()
    if decay:
        upd.add_(wl, alpha=cfg.weight_decay)
    wl.sub_(upd.mul_(lr))
    p.to_local().copy_(wl)


def adamw_update(grads: Any, state: OptState, params: Any, lr: float,
                 cfg: AdamWConfig = AdamWConfig()
                 ) -> Tuple[Any, OptState, Dict[str, Any]]:
    """One AdamW step.  Returns (params, state, metrics), the parameters
    and the state's tensors updated in place; ``metrics["grad_norm"]`` is
    the gradient's global norm before clipping (a device scalar)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.clip_norm)
    count = int(state.count) + 1
    c1 = float(_f32(1.0) - _f32(cfg.b1) ** _f32(count))
    c2 = float(_f32(1.0) - _f32(cfg.b2) ** _f32(count))
    lr = float(_f32(lr))
    flat_g = leaves(grads)
    flat_p = leaves_with_paths(params)
    flat_m = leaves(state.mu)
    flat_w = leaves(state.master)
    flat_v = _nu_leaves(state.nu, params)
    if not len(flat_g) == len(flat_p) == len(flat_m) == len(flat_w) \
            == len(flat_v):
        raise ValueError("adamw_update: the gradient, parameter and state "
                         "trees disagree")
    with torch.no_grad():
        for (path, p), g, m, v, w in zip(flat_p, flat_g, flat_m, flat_v,
                                         flat_w):
            decay = bool(cfg.weight_decay) and not any(
                k in path for k in cfg.no_decay_keys)
            _update_leaf(p, g, m, v, w, decay, scale, lr, c1, c2, cfg)
    new_state = OptState(state.mu, state.nu, state.master,
                         torch.tensor(count, dtype=torch.int32))
    return params, new_state, {"grad_norm": gn, "lr": lr}


def _nu_leaves(nu: Any, params: Any):
    """``nu``'s entry for each parameter leaf, in leaf order: a tensor, or
    a factored leaf's ``{"vr", "vc"}`` dict."""
    if isinstance(params, dict):
        out = []
        for k, v in params.items():
            out += _nu_leaves(nu[k], v)
        return out
    if isinstance(params, (list, tuple)):
        out = []
        for i, v in enumerate(params):
            out += _nu_leaves(nu[i], v)
        return out
    return [nu]
