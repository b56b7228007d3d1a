"""xLSTM blocks (mLSTM + sLSTM) for xlstm-125m (the port of the
reference's ``models/xlstm.py``).

mLSTM: matrix-memory LSTM, ``C_t = f_t C_{t-1} + i_t v_t k_t^T``, read
out as ``h_t = (C_t q_t) / max(|n_t . q_t|, 1)``, with exponential gating
and a log-domain stabiliser ``m_t``.  A prefill runs the chunked
parallel form (gated linear attention inside a chunk, the matrix state
carried across chunks); a decode step (S == 1 with a state) runs the
recurrent update.  sLSTM: scalar-memory LSTM, a recurrence over time:
kernel X1 (:func:`..kernels.slstm_scan.slstm_scan`, one launch a call)
on the card when autograd records nothing, a loop over positions
otherwise (:func:`..kernels.slstm_scan.slstm_route`).

The reference has no kernel here; apart from X1 this is torch operations
on any device.  States are float32; the sLSTM's ``m`` starts at -1e30, the
mLSTM's at 0, as the reference's do.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init, pdtype
from ..kernels.lm_ops import is_fake
from ..kernels import slstm_scan as ksl
from .sharding import is_dtensor, model_replicated_call

Params = Dict[str, Any]

__all__ = ["init_mlstm", "mlstm_forward", "init_slstm", "slstm_forward",
           "init_xlstm_state"]

#: input-gate pre-activation clip (both mLSTM paths)
_IG_CLIP = 15.0


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    nh = cfg.n_heads
    return nh, cfg.d_model // nh


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    nh, _ = _dims(cfg)
    dt = pdtype(cfg)
    return {"wq": dense_init(gen, d, d, dt), "wk": dense_init(gen, d, d, dt),
            "wv": dense_init(gen, d, d, dt),
            "wif": dense_init(gen, d, 2 * nh, dt),   # input + forget gates
            "wo": dense_init(gen, d, d, dt),
            "ogate": dense_init(gen, d, d, dt)}


def _mlstm_step(q, k, v, ig, logf, state):
    """The recurrent update for one position: q/k/v (B, nh, dh), gates
    (B, nh)."""
    m_prev, c_prev, n_prev = state["m"], state["C"], state["n"]
    m_t = torch.maximum(logf + m_prev, ig)
    fsc = torch.exp(logf + m_prev - m_t)
    isc = torch.exp(ig - m_t)
    c = fsc[..., None, None] * c_prev \
        + isc[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = fsc[..., None] * n_prev + isc[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", c, q)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", n, q).abs(), min=1.0)
    return num / den[..., None], {"C": c, "n": n, "m": m_t}


def _mlstm_chunk(carry, qc, kc, vc, igc, lfc, tril):
    """One chunk of the parallel form; ``carry`` is the stabilised state
    (C, n, m) at scale e^m.  Returns (h (b, cs, nh, dh), new carry)."""
    c_st, n_st, m = carry
    cumf = torch.cumsum(lfc, dim=1)                          # (b, cs, nh)
    # per-position stabiliser: max(L_i + m_prev, max_{j<=i} L_i - L_j + ig_j)
    a = cumf + m[:, None, :]
    intra = torch.cummax(igc - cumf, dim=1).values + cumf
    m_i = torch.maximum(a, intra)
    dmat = (cumf[:, :, None, :] - cumf[:, None, :, :]
            + igc[:, None, :, :] - m_i[:, :, None, :])
    # mask the upper triangle before exp (it would overflow)
    dmat = torch.where(tril[None, :, :, None], dmat, -math.inf)
    w = torch.exp(dmat)
    qk = torch.einsum("bihk,bjhk->bijh", qc, kc)
    aw = w * qk
    num = torch.einsum("bijh,bjhv->bihv", aw, vc)
    den = aw.sum(2)
    # the carried state's contribution
    dec_i = torch.exp(a - m_i)
    num = num + torch.einsum("bhvk,bihk,bih->bihv", c_st, qc, dec_i)
    den = den + torch.einsum("bhk,bihk,bih->bih", n_st, qc, dec_i)
    h = num / torch.clamp(den.abs(), min=1.0)[..., None]
    # the state at the chunk's end stabiliser m_c
    m_c = m_i[:, -1, :]
    tot = cumf[:, -1:, :]
    wj = torch.exp(tot - cumf + igc - m_c[:, None, :])
    fsc = torch.exp(tot[:, 0, :] + m - m_c)
    c_st = fsc[:, :, None, None] * c_st \
        + torch.einsum("bjh,bjhv,bjhk->bhvk", wj, vc, kc)
    n_st = fsc[:, :, None] * n_st + torch.einsum("bjh,bjhk->bhk", wj, kc)
    return h, (c_st, n_st, m_c)


def mlstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  state: Optional[Dict[str, torch.Tensor]] = None,
                  chunk: int = 256, rules=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D); state {"C": (B, nh, dh, dh), "n": (B, nh, dh),
    "m": (B, nh)}.  Returns (out (B, S, D), new state).  The chunked form
    carries the same running-max stabiliser as the recurrence.  With
    ``rules`` and a DTensor ``x``: every ``model`` rank over its data
    shard (:func:`.sharding.model_replicated_call`)."""
    if rules is not None and is_dtensor(x):
        return model_replicated_call(
            rules, lambda xl, pl, sl: mlstm_forward(pl, xl, cfg, state=sl,
                                                    chunk=chunk),
            x, p, state)
    b, s, d = x.shape
    nh, dh = _dims(cfg)
    dt = x.dtype
    qf = (x @ p["wq"].to(dt)).reshape(b, s, nh, dh).float()
    kf = (x @ p["wk"].to(dt)).reshape(b, s, nh, dh).float() / math.sqrt(dh)
    vf = (x @ p["wv"].to(dt)).reshape(b, s, nh, dh).float()
    gates = (x @ p["wif"].to(dt)).float()
    ig = torch.clamp(gates[..., :nh], -_IG_CLIP, _IG_CLIP)      # (B, S, nh)
    logf = F.logsigmoid(gates[..., nh:])

    if state is not None and s == 1:
        h, new_state = _mlstm_step(qf[:, 0], kf[:, 0], vf[:, 0], ig[:, 0],
                                   logf[:, 0], state)
        h = h.reshape(b, 1, d)
    else:
        pad = (-s) % chunk
        cs = min(chunk, s + pad)
        if pad:
            qf, kf, vf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (qf, kf, vf))
            # a -1e30 input gate: padded positions add exactly nothing to
            # the carried state
            ig = F.pad(ig, (0, 0, 0, pad), value=-1e30)
            logf = F.pad(logf, (0, 0, 0, pad))
        if state is None:
            carry = (x.new_zeros((b, nh, dh, dh), dtype=torch.float32),
                     x.new_zeros((b, nh, dh), dtype=torch.float32),
                     x.new_zeros((b, nh), dtype=torch.float32))
        else:
            carry = (state["C"], state["n"], state["m"])
        tril = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                     device=x.device))
        hs = []
        for c0 in range(0, s + pad, cs):
            sl = slice(c0, c0 + cs)
            h_c, carry = _mlstm_chunk(carry, qf[:, sl], kf[:, sl], vf[:, sl],
                                      ig[:, sl], logf[:, sl], tril)
            hs.append(h_c)
        h = torch.cat(hs, dim=1)[:, :s].reshape(b, s, d)
        new_state = dict(zip(("C", "n", "m"), carry))
    og = torch.sigmoid((x @ p["ogate"].to(dt)).float())
    out = (h * og).to(dt) @ p["wo"].to(dt)
    return out, new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    dt = pdtype(cfg)
    return {"wx": dense_init(gen, d, 4 * d, dt),    # z, i, f, o pre-acts
            "wh": dense_init(gen, d, 4 * d, dt),    # recurrent
            "wo": dense_init(gen, d, d, dt)}


def slstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  state: Optional[Dict[str, torch.Tensor]] = None,
                  rules=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The recurrence over time (X1's route).  state: {"h", "c", "n",
    "m"}, each (B, D).  ``rules``: as :func:`mlstm_forward`'s."""
    if rules is not None and is_dtensor(x):
        return model_replicated_call(
            rules, lambda xl, pl, sl: slstm_forward(pl, xl, cfg, state=sl),
            x, p, state)
    b, s, d = x.shape
    pre = (x @ p["wx"].to(x.dtype)).float()                 # (B, S, 4D)
    wh = p["wh"].float()
    if state is None:
        state = init_xlstm_state(cfg, b, "slstm", device=x.device)
    h, c, n, m = (state[key] for key in ("h", "c", "n", "m"))
    if is_fake(x) and s > 1:
        return _slstm_surrogate(p, pre, wh, (h, c, n, m), x.dtype)
    # X1 on the card (kernels/slstm_scan.py), its plain loop else
    hs, (h, c, n, m) = ksl.slstm_scan(pre, wh, h, c, n, m)
    out = hs.to(x.dtype) @ p["wo"].to(x.dtype)
    return out, {"h": h, "c": c, "n": n, "m": m}


def _slstm_surrogate(p: Params, pre, wh, state, dtype):
    """The sLSTM recurrence's work over all S steps at once, for a trace
    on fake tensors (the dry run): the same matrix products and
    elementwise operations as the loop, over (B, S, .) operands, with a
    stand-in for each step's previous ``h`` (fake tensors carry no
    values; the recurrent weight is counted read once).  A Python loop
    over a 32,768-token prefill would take the tracer minutes."""
    h, c, n, m = (t[:, None] for t in state)
    g = pre + torch.tanh(pre[..., :pre.shape[-1] // 4]) @ wh
    z, ig, fg, og = torch.chunk(g, 4, dim=-1)
    logf = F.logsigmoid(fg)
    m_t = torch.maximum(logf + m, ig)
    isc = torch.exp(ig - m_t)
    fsc = torch.exp(logf + m - m_t)
    c = fsc * c + isc * torch.tanh(z)
    n = fsc * n + isc
    h = torch.sigmoid(og) * c / torch.clamp(n.abs(), min=1.0)
    out = h.to(dtype) @ p["wo"].to(dtype)
    return out, {"h": h[:, -1], "c": c[:, -1], "n": n[:, -1],
                 "m": m_t[:, -1]}


def init_xlstm_state(cfg: ModelConfig, batch: int, kind: str, *,
                     device=None) -> Dict[str, torch.Tensor]:
    """A zero state of one block (``kind``: ``"mlstm"`` or ``"slstm"``)."""
    nh, dh = _dims(cfg)
    d = cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    if kind == "mlstm":
        return {"C": zeros(batch, nh, dh, dh), "n": zeros(batch, nh, dh),
                "m": zeros(batch, nh)}
    st = {key: zeros(batch, d) for key in ("h", "c", "n")}
    st["m"] = torch.full((batch, d), -1e30, dtype=torch.float32,
                         device=device)
    return st
