"""Port MoE (``models/moe.py`` and the MoE block) vs the reference, on the
CPU: the router's two routes, the routed and shared experts, the
capacity drops, the load-balancing loss and the parameter tree.  The
same numpy inputs go through both packages; parameters are the
reference's ``init_moe`` carried across by
``convert.lm_params_from_reference``.

Tolerances: router indices equal (ties to the lower expert, duplicated
router columns included), scores within 1e-4 (float32 sums in two
orders); float32 MoE outputs within 1e-5; bfloat16 within one to two
bf16 steps (0.05 at magnitudes up to 2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models import blocks as rb
from repro.models import moe as rmoe
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import blocks as tb
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe

ARCHS = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"]
F32_TOL = 1e-5
BF16_ATOL = 0.05
SCORE_TOL = 1e-4


def _cfgs(arch, dtype="float32", **kw):
    kw.update(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(r_get_smoke_config(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _moe_params(rcfg, tcfg, seed=0):
    rp = rmoe.init_moe(jax.random.PRNGKey(seed), rcfg)
    tp = convert.lm_params_from_reference(jax.tree.map(np.asarray, rp),
                                          tcfg, device="cpu")
    return rp, tp


def _router_case(rng, t, d, e):
    """(T, D) tokens and a (D, E) router whose columns 1 and 3 are equal
    and best for token 0, and whose last column repeats column 0: exact
    ties in both routes."""
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    w[:, 1] = w[:, 3] = 2.0 * x[0] / np.linalg.norm(x[0])
    w[:, e - 1] = w[:, 0]
    return x, w


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offload", ["dense", "cam"])
@pytest.mark.parametrize("t,d,e,k", [(1, 96, 8, 2), (13, 160, 64, 6),
                                     (40, 2048 // 8, 16, 2)])
def test_router_topk_matches_reference(offload, t, d, e, k, rng):
    x, w = _router_case(rng, t, d, e)
    rv, ri = rmoe.router_topk(jnp.asarray(x), jnp.asarray(w), k, offload)
    tv, ti = tmoe.router_topk(torch.from_numpy(x), torch.from_numpy(w), k,
                              offload)
    assert ti.dtype == torch.int64 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=SCORE_TOL,
                               rtol=SCORE_TOL)
    assert ti[0, :2].tolist() == [1, 3]          # the tie, lower index first


def test_router_routes_agree_and_reject_unknown(rng):
    """``"cam"`` and ``"dense"`` choose the same experts on these inputs
    (the reference's claim: equal up to float32 summation order), and an
    unknown route raises."""
    x, w = _router_case(rng, 64, 160, 64)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    _, cam = tmoe.router_topk(xt, wt, 6, "cam")
    _, dense = tmoe.router_topk(xt, wt, 6, "dense")
    assert torch.equal(cam, dense)
    with pytest.raises(ValueError, match="offload"):
        tmoe.router_topk(xt, wt, 6, "tcam")


# ---------------------------------------------------------------------------
# the experts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
@pytest.mark.parametrize("offload", ["dense", "cam"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, offload, capacity_factor, rng):
    """Routed (and, for deepseek, shared) experts in float32.  At
    capacity factor 0.5 tokens drop: each expert keeps 8 slots (the
    minimum) of 12 choices on average (48 tokens x top-2 over 8
    experts)."""
    rcfg, tcfg = _cfgs(arch, router_offload=offload,
                       capacity_factor=capacity_factor)
    assert (tcfg.n_shared_experts > 0) == (arch == "deepseek-moe-16b")
    rp, tp = _moe_params(rcfg, tcfg)
    x = rng.standard_normal((3, 16, tcfg.d_model)).astype(np.float32)
    want = np.asarray(rmoe.moe_ffn(rp, jnp.asarray(x), rcfg))
    got = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_moe_capacity_drops_tokens(rng):
    """At capacity factor 0.5 the output differs from the drop-free one
    (dropped slots weigh 0) and still matches the reference above; at 64
    no token drops, so one token alone gives its row of the batch."""
    rcfg, tcfg = _cfgs("phi3.5-moe-42b-a6.6b", capacity_factor=0.5)
    _, tp = _moe_params(rcfg, tcfg)
    x = torch.from_numpy(rng.standard_normal((2, 24, tcfg.d_model))
                         .astype(np.float32))
    dropped = tmoe.moe_ffn(tp, x, tcfg)
    free = dataclasses.replace(tcfg, capacity_factor=64.0)
    full = tmoe.moe_ffn(tp, x, free)
    assert not torch.allclose(dropped, full, atol=1e-3)
    alone = tmoe.moe_ffn(tp, x[1:2, 5:6], free)
    torch.testing.assert_close(alone[0, 0], full[1, 5], atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_bfloat16_matches_reference(arch, rng):
    rcfg, tcfg = _cfgs(arch, "bfloat16")
    rp, tp = _moe_params(rcfg, tcfg)
    x = rng.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    want = rmoe.moe_ffn(rp, jnp.asarray(x, jnp.bfloat16), rcfg)
    got = tmoe.moe_ffn(tp, torch.from_numpy(x).bfloat16(), tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=BF16_ATOL)


def test_aux_load_balance_loss_matches_reference(rng):
    scores = rng.standard_normal((50, 16)).astype(np.float32)
    idx = rng.integers(0, 16, (50, 2))
    want = float(rmoe.aux_load_balance_loss(jnp.asarray(scores),
                                            jnp.asarray(idx), 16))
    got = tmoe.aux_load_balance_loss(torch.from_numpy(scores),
                                     torch.from_numpy(idx), 16)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# the block and the parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offload", ["dense", "cam"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_with_cache_matches_reference(arch, offload, rng):
    """``apply_moe_block``: a 6-row prefill into a cache, then one decode
    row, against the reference's block (float32 cache on both sides, so
    the comparison is of the arithmetic, not of bf16 cache rounding)."""
    rcfg, tcfg = _cfgs(arch, router_offload=offload)
    rp = rb.init_moe_block(jax.random.PRNGKey(5), rcfg)
    tp = convert.lm_params_from_reference(jax.tree.map(np.asarray, rp),
                                          tcfg, device="cpu")
    kv, dh = tcfg.n_kv_heads, tcfg.head_dim
    rc = {"k": jnp.zeros((2, 8, kv, dh)), "v": jnp.zeros((2, 8, kv, dh)),
          "len": jnp.zeros((), jnp.int32)}
    tc = {"k": torch.zeros((2, 8, kv, dh)), "v": torch.zeros((2, 8, kv, dh)),
          "len": 0}
    x = rng.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    for xs, start in ((x, 0), (x1, 6)):
        pos = np.broadcast_to(np.arange(start, start + xs.shape[1]),
                              xs.shape[:2]).copy()
        want, rc = rb.apply_moe_block(rp, jnp.asarray(xs), rcfg,
                                      positions=jnp.asarray(pos), cache=rc)
        got, tc = tb.apply_moe_block(tp, torch.from_numpy(xs), tcfg,
                                     positions=torch.from_numpy(pos),
                                     cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_TOL, rtol=F32_TOL)
        assert tc["len"] == int(rc["len"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_params_tree_matches_reference(arch, dtype):
    """``init_params`` gives the reference's keys, shapes and dtypes (the
    routed experts' weights float32 in a bf16 model, as the reference's
    init leaves them), and ``convert`` carries the reference's leaves
    across exactly."""
    rcfg, tcfg = _cfgs(arch, dtype)
    from repro.models import model as rm
    rparams = jax.tree.map(np.asarray, rm.init_params(jax.random.PRNGKey(2),
                                                      rcfg))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), rparams)
    got = tm._tree_map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")),
                       tm.init_params(tcfg, seed=0, device="cpu"))
    assert got == want
    assert want["moe_blocks"]["moe"]["wi"][1] == "float32"
    conv = convert.lm_params_from_reference(rparams, tcfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(rparams)[0]
    for path, a in flat:
        t = conv
        for p in path:
            t = t[p.key]
        assert str(t.dtype).replace("torch.", "") == str(a.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))


def test_tf32x3_kernel_dot_replays_the_split_product(rng):
    """The replay of B2's dot value (the 3xTF32 accumulation alone) that
    the card's router checks hold B2's index swaps to: within float32
    rounding of the float64 product, equal to the eucl replay's
    accumulator, and exact on integer cells."""
    from repro_torch.kernels import cam_search as tcs
    n, dim = 40, 160
    q = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
    got = tcs.tf32x3_kernel_dot(q, p)
    assert got.dtype == torch.float32
    exact = (q.double() * p.double()).sum(1)
    scale = (q.double() * p.double()).abs().sum(1)
    assert bool(((got.double() - exact).abs() <= 1e-6 * scale).all())
    qi = torch.from_numpy(rng.integers(-3, 4, (n, dim)).astype(np.float32))
    pi = torch.from_numpy(rng.integers(-3, 4, (n, dim)).astype(np.float32))
    assert torch.equal(tcs.tf32x3_kernel_dot(qi, pi), (qi * pi).sum(1))
