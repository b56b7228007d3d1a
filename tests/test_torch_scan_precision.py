"""M1's tensor-core precision on the CPU, before the card checks it.

M1 (``csrc/ssd_scan.cu``) runs every product of the Mamba2 chunked scan
through TF32 ``wgmma``: a float32 operand splits into hi = TF32 rounded to
nearest (ties away, ``cvt.rna``) and lo = the TF32 rounding of the
remainder, a product takes lo.hi + hi.lo + hi.hi (lo.lo dropped), and a
bf16 operand, exact in TF32, is not split.  This file models that split in
plain PyTorch (the model lives here only; it is not the port's code):

* C.B^T, the entering state's term C.h^T (scaled by exp(L_i)), the masked
  weights W = decay * C.B^T * dt in float32, W.x slab by slab of 64 rows
  (each slab's sum added to the running one in float32), the chunk's state
  contribution (w x)^T.B likewise, the state pass, the ``D`` skip and the
  cast: the kernel's arithmetic, with float32 sums (the card's tensor cores
  add truncating; ``tests/test_torch_cuda.py`` holds that part on the
  card).

It runs at one zamba2-2.7b Mamba2 block's full scan widths (80 heads of
64, state 64, chunk 256, 2,048 rows from a nonzero carried state, bf16 and
float32) on the operands that the reference's own ``mamba2_forward``
hands its chunked scan (``src/repro/models/mamba2.py:115``, ``lax.scan``
at :151), captured from that call together with its result, and holds the
model to the reference within M1's unchanged tolerances: y within one step
of its dtype (2**-7 |y| in bf16, 1e-4 |y| in float32) plus 1e-5 of max|y|,
the final state within 1e-4 |h| plus 1e-5 of max|h|.  The largest errors
(as shares of max|y| and max|h|) are printed; on an x86 CPU at writing:
float32 y 7.5e-6, state 2.5e-5 (the state's own 1e-4 |h| holds it); bf16
y 9.8e-4 (below one bf16 step, 2**-7), state 1.5e-5.  The model's input projection is cut to
d_model 256 (``ssm_expand`` 20 keeps d_inner 5,120 and the 80 heads): it
only makes the scan's operands.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import mamba2 as rm2

ROWS, CHUNK, SLAB = 2048, 256, 64
M1_OF_MAX = 1e-5


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32, to nearest with ties away from zero (the
    bits below the 10-bit mantissa cleared)."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor, exact: bool):
    hi = _tf32(x)
    return hi, None if exact else _tf32(x - hi)


def _mm(a: torch.Tensor, b: torch.Tensor, a_exact: bool, b_exact: bool):
    """a @ b with the kernel's split: lo.hi where a has a lo half, hi.lo
    where b has one, then hi.hi, summed in float32 in that order."""
    ah, al = _split(a, a_exact)
    bh, bl = _split(b, b_exact)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    if al is not None:
        out = out + al @ bh
    if bl is not None:
        out = out + ah @ bl
    return out + ah @ bh


def tf32_split_scan(xh, B_, C_, dt, A, D, h, chunk, exact):
    """M1's arithmetic (see the module docstring): xh (S, nh, dh), B_ / C_
    (S, ds) holding the dtype's values in float32, dt (S, nh), A / D
    (nh,), h (nh, dh, ds) -> (y (S, nh, dh) float32 before the cast, the
    final state).  ``exact``: the operands are bf16 values."""
    s, nh, dh = xh.shape
    ys = []
    for c0 in range(0, s, chunk):
        x = xh[c0:c0 + chunk].permute(1, 0, 2)             # (nh, q, dh)
        bm, cm = B_[c0:c0 + chunk], C_[c0:c0 + chunk]       # (q, ds)
        dtk = dt[c0:c0 + chunk].T                           # (nh, q)
        q = x.shape[1]
        cum = torch.cumsum(dtk * A[:, None], dim=1)         # (nh, q)
        cb = _mm(cm, bm.T, exact, exact)                    # (q, q)
        inter = _mm(cm, h.transpose(1, 2), exact, False)    # (nh, q, dh)
        y = inter * torch.exp(cum)[:, :, None]
        decay = torch.exp(torch.clamp(cum[:, :, None] - cum[:, None, :],
                                      -60.0, 0.0))
        causal = torch.tril(torch.ones((q, q), dtype=torch.bool))
        w = torch.where(causal, (decay * cb) * dtk[:, None, :], 0.0)
        last = cum[:, -1:]
        wj = torch.exp(torch.clamp(last - cum, min=-60.0)) * dtk   # (nh, q)
        contrib = torch.zeros_like(h)
        for j0 in range(0, q, SLAB):
            sl = slice(j0, j0 + SLAB)
            y = y + _mm(w[:, :, sl], x[:, sl], False, exact)
            contrib = contrib + _mm((wj[:, sl, None] * x[:, sl])
                                    .transpose(1, 2), bm[sl], False, exact)
        h = torch.exp(last)[:, :, None] * h + contrib
        ys.append(y.permute(1, 0, 2))
    y = torch.cat(ys, dim=0)
    return y + D[None, :, None] * xh, h


def _reference_scan(dtype):
    """mamba2_forward of the reference at one zamba2-2.7b block's scan
    widths over ROWS rows from a nonzero state: the chunked scan's inputs
    and carried state as it hands them to ``lax.scan`` (caught by a
    stand-in for ``jax.lax.scan`` that runs the real one), and its result:
    y + D x cast to the dtype, as the block forms it, and the final
    state."""
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), d_model=256,
                              ssm_expand=20)
    d_inner, nh, dh, ds = rm2._dims(cfg)
    assert (nh, dh, ds) == (80, 64, 64)
    rng = np.random.default_rng(0)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    p = rm2.init_mamba2(jax.random.PRNGKey(0), cfg)
    p = {k: v.astype(jdt) for k, v in p.items()}
    p["A_log"] = jnp.asarray(rng.uniform(-1, 1, nh), jdt)
    p["dt_bias"] = jnp.asarray(rng.uniform(-1, 0, nh), jdt)
    p["D"] = jnp.asarray(rng.uniform(0, 2, nh), jdt)
    x = jnp.asarray(rng.standard_normal((1, ROWS, cfg.d_model)), jdt)
    state = {"ssm": jnp.asarray(rng.standard_normal((1, nh, dh, ds)),
                                jnp.float32),
             "conv": jnp.zeros((1, cfg.ssm_conv - 1, d_inner + 2 * ds), jdt)}
    seen = {}
    real_scan = jax.lax.scan

    def scan(f, init, xs):
        seen["h0"], seen["xs"] = init, xs
        seen["out"] = real_scan(f, init, xs)
        return seen["out"]

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "scan", scan)
    try:
        _, new_state = rm2.mamba2_forward(p, x, cfg, chunk=CHUNK, state=state)
    finally:
        mp.undo()
    h_fin, ys = seen["out"]
    xs = [np.asarray(jnp.moveaxis(a, 0, 1).astype(jnp.float32))
          .reshape((ROWS,) + a.shape[3:]) for a in seen["xs"]]
    xh, B_, C_, dt = xs
    A = -np.exp(np.asarray(p["A_log"].astype(jnp.float32)))
    D = np.asarray(p["D"].astype(jnp.float32))
    y = np.asarray(jnp.moveaxis(ys, 0, 1)).reshape(ROWS, nh, dh) \
        + D[None, :, None] * xh
    y = np.asarray(jnp.asarray(y).astype(jdt).astype(jnp.float32))
    assert np.array_equal(np.asarray(h_fin), np.asarray(new_state["ssm"]))
    return (xh, B_, C_, dt, A, D, np.asarray(seen["h0"])[0]), \
        (y, np.asarray(h_fin)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tf32_split_model_matches_the_reference_scan(dtype):
    """The TF32-split model of M1 on the reference's own scan operands at
    zamba2-2.7b's full scan widths, against the reference's scan, within
    M1's tolerances (largest errors printed)."""
    ops, (want_y, want_h) = _reference_scan(dtype)
    t = [torch.from_numpy(np.array(a, np.float32)) for a in ops]
    y, h = tf32_split_scan(*t, CHUNK, exact=dtype == torch.bfloat16)
    y = y.to(dtype).float().numpy()
    h = h.numpy()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
    top_y, top_h = np.abs(want_y).max(), np.abs(want_h).max()
    err_y, err_h = np.abs(y - want_y), np.abs(h - want_h)
    print(f"M1 TF32 split {dtype}: y {err_y.max() / top_y:.3g} of max|y| "
          f"{top_y:.4g}, state {err_h.max() / top_h:.3g} of max|h| "
          f"{top_h:.4g}")
    assert (err_y <= rtol * np.abs(want_y) + M1_OF_MAX * top_y).all(), \
        err_y.max()
    assert (err_h <= 1e-4 * np.abs(want_h) + M1_OF_MAX * top_h).all(), \
        err_h.max()


def test_tf32_rounding_is_to_nearest_ties_away():
    """The model's TF32 rounding: exact on values with a 10-bit mantissa,
    to nearest otherwise, ties away from zero, in both signs; hi + lo
    leaves at most 2**-22 of |x|."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp / 4,
                      1.0 + 3 * one_ulp / 4, -(1.0 + one_ulp / 2)])
    want = torch.tensor([1.0, 1.0 + one_ulp, 1.0, 1.0 + one_ulp,
                         -(1.0 + one_ulp)])
    assert torch.equal(_tf32(x), want)
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = _split(v, False)
    assert float(((v - hi - lo).abs() / v.abs()).max()) <= 2.0 ** -22
    b = v.to(torch.bfloat16).float()
    assert torch.equal(_tf32(b), b)
