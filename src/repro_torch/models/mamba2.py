"""Mamba2 (SSD) block for the zamba2 hybrid (the port of the reference's
``models/mamba2.py``).

Multi-head state-space duality form (Dao & Gu 2024) with a chunked
scan: inside a chunk the quadratic (attention-like) form, across chunks
the state ``h: (B, heads, d_head, d_state)`` carried chunk to chunk (the
reference's ``lax.scan``).  A decode step (a state given and
S == 1) runs the O(1) recurrent update on the carried state.

The reference has no kernel here.  The prefill's chunked scan runs on
M1 (:func:`..kernels.ssd_scan.ssd_scan`: the hand-written kernels on the
card when autograd records nothing, the reference's einsums in float32
with its clips otherwise, :func:`..kernels.ssd_scan.ssd_route`); the rest
is torch operations on any device (float32 products on the card run
without TF32, PyTorch's default, as the reference's "highest" precision
asks).  The ssm state is float32; the conv state starts in bfloat16 (the
reference's cache dtype) and comes back in the compute dtype, as the
reference's does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ssd_scan as kss
from .config import ModelConfig
from .layers import dense_init, pdtype
from .sharding import is_dtensor, model_replicated_call

Params = Dict[str, Any]

__all__ = ["init_mamba2", "mamba2_forward", "init_mamba_state"]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head dim, state dim): mamba2's head dim 64."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = max(1, d_inner // 64)
    return d_inner, n_heads, d_inner // n_heads, cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    d_inner, nh, _, ds = _dims(cfg)
    dt = pdtype(cfg)
    dev = gen.device
    return {
        # fused input projection: [z, x, B, C, dt]
        "in_proj": dense_init(gen, d, 2 * d_inner + 2 * ds + nh, dt),
        "conv_w": torch.randn((cfg.ssm_conv, d_inner + 2 * ds), generator=gen,
                              device=dev, dtype=torch.float32).to(dt) * 0.2,
        "A_log": torch.zeros((nh,), dtype=dt, device=dev),
        "D": torch.ones((nh,), dtype=dt, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, d_inner, d, dt),
        "norm_scale": torch.ones((d_inner,), dtype=dt, device=dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along S, then SiLU.  x: (B, S, C), w: (K, C);
    ``state`` (B, K-1, C) holds the previous K-1 inputs (decode).
    Returns (out, the last K-1 inputs)."""
    k = w.shape[0]
    if state is not None:
        xin = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        xin = F.pad(x, (0, 0, k - 1, 0))
    new_state = xin[:, -(k - 1):]
    s = x.shape[1]
    out = xin[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + xin[:, i:i + s] * w[i].to(x.dtype)
    return F.silu(out), new_state


def mamba2_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                   chunk: int = 256,
                   state: Optional[Dict[str, torch.Tensor]] = None,
                   rules=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (out (B, S, D), {"ssm", "conv"} states).  A
    ``state`` with S == 1 is a decode step; with S > 1 a prefill that
    starts from ``state["ssm"]`` and ``state["conv"]``.  With ``rules``
    and a DTensor ``x`` the block runs on every ``model`` rank over its
    data shard with the (``ssm_inner``-sharded) weights gathered
    (:func:`.sharding.model_replicated_call`), M1 on each rank's local
    tensors by the same route."""
    if rules is not None and is_dtensor(x):
        return model_replicated_call(
            rules, lambda xl, pl, sl: mamba2_forward(pl, xl, cfg,
                                                     chunk=chunk, state=sl),
            x, p, state)
    b, s, _ = x.shape
    d_inner, nh, dh, ds = _dims(cfg)

    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xc, B_, C_, dt = torch.split(zxbcdt, [d_inner, d_inner, ds, ds, nh],
                                    dim=-1)
    conv_out, conv_state = _causal_conv(
        torch.cat([xc, B_, C_], dim=-1), p["conv_w"],
        None if state is None else state["conv"])
    xc = conv_out[..., :d_inner]
    B_ = conv_out[..., d_inner:d_inner + ds]
    C_ = conv_out[..., d_inner + ds:]

    dt = F.softplus(dt.float() + p["dt_bias"].float())           # (B,S,nh)
    A = -torch.exp(p["A_log"].float())                           # (nh,)
    xh = xc.reshape(b, s, nh, dh)
    D = p["D"].float()

    if state is not None and s == 1:
        # O(1) recurrence: h' = exp(A dt) h + dt * x outer B
        h = state["ssm"]
        da = torch.exp(dt[:, 0, :, None, None] * A[None, :, None, None])
        upd = (dt[:, 0, :, None, None] * xh[:, 0, :, :, None].float()
               * B_[:, 0, None, None, :].float())
        h = da * h + upd
        y = torch.einsum("bhds,bs->bhd", h, C_[:, 0].float())
        y = y + D[None, :, None] * xh[:, 0].float()
        y = y.reshape(b, 1, d_inner).to(x.dtype)
    else:
        # M1 on the card (kernels/ssd_scan.py), its plain version else
        h0 = state["ssm"] if state is not None else torch.zeros(
            (b, nh, dh, ds), dtype=torch.float32, device=x.device)
        y, h = kss.ssd_scan(xh, B_, C_, dt, A, D, h0, chunk)
    new_state = {"ssm": h, "conv": conv_state}

    # gated RMSNorm + output projection
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * p["norm_scale"].float()
    return yf.to(x.dtype) @ p["out_proj"].to(x.dtype), new_state


def init_mamba_state(cfg: ModelConfig, batch: int, *,
                     device) -> Dict[str, torch.Tensor]:
    """A zero state: ssm float32, conv bfloat16 (the reference's)."""
    d_inner, nh, dh, ds = _dims(cfg)
    return {"ssm": torch.zeros((batch, nh, dh, ds), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * ds),
                                dtype=torch.bfloat16, device=device)}
