"""Port train step vs the reference, on the CPU: the optimizer and its
schedules (twins of ``tests/test_substrates.py``), B7's backward (its
plain version against autograd and against ``jax.grad`` of the
reference's ``attn_core``), remat, and one train step of a smoke config
of every family started from the same state in both packages
(``convert.train_state_from_reference``).

Tolerances, all float32:

* the loss within ``LOSS_ATOL`` (1e-5; measured up to 5e-7);
* each gradient leaf within ``GRAD_RTOL`` (1e-4) of its reference norm
  plus ``GRAD_ATOL`` (1e-7: a leaf whose gradient is zero in exact
  arithmetic, as the key bias's is under softmax, holds float noise of
  about 1e-9 on both sides); measured 2e-6;
* the AdamW moments after the step within 1e-6 (mu) / 1e-8 (nu),
  absolute; the master weights and parameters within ``PARAM_ATOL``
  (1e-4; measured 6e-5) where |g| clears ``SIGN_FLOOR`` (1e-6 of the
  leaf's largest gradient), and within 2 lr elsewhere: Adam's first step
  moves each weight by about lr * sign(g), and a near-zero gradient may
  take either sign in the two packages;
* B7's backward: 1e-5 against autograd of the plain forward, 1e-4
  against ``jax.grad`` (two frameworks' float32 sums).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.models import steps as rs
from repro.models.layers import attn_core
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import warmup_cosine as r_warmup_cosine
from repro.optim import warmup_linear as r_warmup_linear
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import steps as ts
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, constant, global_norm,
                               warmup_cosine, warmup_linear)
from repro_torch.tree import leaves_with_paths

LOSS_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
MU_ATOL, NU_ATOL = 1e-6, 1e-8
PARAM_ATOL, SIGN_FLOOR = 1e-4, 1e-6
BWD_ATOL, BWD_JAX_ATOL = 1e-5, 1e-4
LR, B, S = 1e-3, 2, 16

# ---------------------------------------------------------------------------
# optimizer (twins of tests/test_substrates.py)
# ---------------------------------------------------------------------------


def _grad(fn, params):
    leaves = [p.detach().requires_grad_(True) for p in params.values()]
    p = dict(zip(params, leaves))
    grads = torch.autograd.grad(fn(p), leaves)
    return dict(zip(params, grads))


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0]), "scale": torch.tensor([2.0])}
    state = adamw_init(params)
    cfg = AdamWConfig(weight_decay=0.0, clip_norm=100.0)
    for _ in range(300):
        grads = _grad(lambda p: (p["w"] ** 2).sum()
                      + ((p["scale"] - 1.0) ** 2).sum(), params)
        params, state, _ = adamw_update(grads, state, params, 0.1, cfg)
    assert float(params["w"].abs().max()) < 1e-2
    assert abs(float(params["scale"][0]) - 1.0) < 1e-2


def test_adamw_no_decay_on_norm_leaves():
    params = {"w": torch.ones(4), "norm_scale": torch.ones(4)}
    state = adamw_init(params)
    grads = {"w": torch.zeros(4), "norm_scale": torch.zeros(4)}
    params2, _, _ = adamw_update(grads, state, params, 0.1,
                                 AdamWConfig(weight_decay=0.5))
    assert float(params2["w"][0]) < 1.0            # decayed
    assert float(params2["norm_scale"][0]) == 1.0  # excluded


def test_clip_by_global_norm():
    clipped, gn = clip_by_global_norm({"a": torch.full((10,), 10.0)}, 1.0)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    assert float(gn) > 30.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_norm_of_a_wide_leaf(dtype):
    """A leaf of 2e7 elements beside a small one: the global norm within
    1e-6 of float64's (a float32 ``vector_norm`` on the CPU reads 3.7e-4
    low at this size, 6e-3 at qwen2.5-14b's d_ff x d_model)."""
    gen = torch.Generator().manual_seed(0)
    tree = {"a": (1e-3 * torch.randn(20_000_000, generator=gen)).to(dtype),
            "b": torch.ones(3, dtype=dtype)}
    want = float(torch.linalg.vector_norm(torch.cat(
        [tree["a"].double(), tree["b"].double()])))
    gn = global_norm(tree)
    assert gn.dtype == torch.float32
    assert float(gn) == pytest.approx(want, rel=1e-6, abs=0)


def test_bf16_params_master_accumulates_small_updates():
    """bf16 parameters alone would lose 1e-3-scale updates; the float32
    master must accumulate them."""
    params = {"w": torch.ones(4, dtype=torch.bfloat16) * 100.0}
    state = adamw_init(params)
    g = {"w": torch.ones(4)}
    for _ in range(100):
        params, state, _ = adamw_update(g, state, params, 1e-3,
                                        AdamWConfig(weight_decay=0.0))
    assert float(state.master["w"][0]) < 99.95
    assert params["w"].dtype == torch.bfloat16


def test_schedules_monotone_warmup():
    s = warmup_cosine(1e-3, 10, 100)
    vals = [s(i) for i in range(15)]
    assert vals[0] > 0
    assert all(b >= a for a, b in zip(vals[:9], vals[1:10]))
    assert abs(vals[9] - 1e-3) < 1e-9
    assert warmup_linear(1e-3, 10, 100)(99) < 2e-5 + 1e-9
    assert constant(3e-4)(7) == float(np.float32(3e-4))


@pytest.mark.parametrize("warmup,total", [(10, 100), (2, 12), (0, 5)])
def test_schedules_match_reference(warmup, total):
    """float32 arithmetic on both sides: equal within four float32 steps
    (``jnp.cos`` in float32 against the cosine rounded once to float32;
    measured two)."""
    for mine, ref in ((warmup_cosine(3e-4, warmup, total),
                       r_warmup_cosine(3e-4, warmup, total)),
                      (warmup_linear(3e-4, warmup, total, floor=1e-5),
                       r_warmup_linear(3e-4, warmup, total, floor=1e-5))):
        for step in range(total + 3):
            want = float(ref(jnp.asarray(step, jnp.int32)))
            assert mine(step) == pytest.approx(want, rel=4.8e-7, abs=0)


@pytest.mark.parametrize("factored,mu_dtype", [(True, "float32"),
                                               (False, "bfloat16")])
def test_adamw_memory_knobs_match_reference(factored, mu_dtype, rng):
    """``factored_nu`` and a bfloat16 first moment: three steps on the
    same gradients in both packages."""
    from repro.optim import adamw_init as r_init, adamw_update as r_update
    w = rng.standard_normal((6, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    gs = [{"w": rng.standard_normal((6, 5)).astype(np.float32),
           "bias": rng.standard_normal((5,)).astype(np.float32)}
          for _ in range(3)]
    tcfg = AdamWConfig(factored_nu=factored, mu_dtype=mu_dtype)
    rcfg = RAdamWConfig(factored_nu=factored, mu_dtype=mu_dtype)
    tp = {"w": torch.from_numpy(w.copy()), "bias": torch.from_numpy(b.copy())}
    rp = {"w": jnp.asarray(w), "bias": jnp.asarray(b)}
    tstate, rstate = adamw_init(tp, tcfg), r_init(rp, rcfg)
    for g in gs:
        tp, tstate, _ = adamw_update({k: torch.from_numpy(v)
                                      for k, v in g.items()}, tstate, tp,
                                     1e-2, tcfg)
        rp, rstate, _ = r_update({k: jnp.asarray(v) for k, v in g.items()},
                                 rstate, rp, jnp.asarray(1e-2), rcfg)
    for k in ("w", "bias"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                   atol=1e-5, rtol=0)
    assert int(tstate.count) == int(rstate.count) == 3


# ---------------------------------------------------------------------------
# B7's backward
# ---------------------------------------------------------------------------

_BWD_CASES = {
    "gqa_causal": (2, 37, 37, 6, 2, 16, dict(causal=True)),
    "prefix": (1, 40, 40, 4, 1, 32, dict(causal=True, prefix_len=9)),
    "cross": (2, 5, 29, 4, 4, 16, dict(causal=False)),
    "dh48": (1, 24, 24, 4, 2, 48, dict(causal=True)),
    "cache": (1, 3, 40, 4, 2, 16, dict(causal=True, q_start=30, kv_len=33)),
}


@pytest.mark.parametrize("case", sorted(_BWD_CASES))
def test_backward_reference_matches_autograd_and_jax(case, rng):
    b, s, t, h, kvh, dh, kw = _BWD_CASES[case]
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, kvh, dh)).astype(np.float32)
    g = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, lse = tfa.flash_attention_reference(tq, tk, tv, return_lse=True,
                                             **kw)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    got = tfa.flash_attention_backward_reference(
        tq.detach(), tk.detach(), tv.detach(), out.detach(), lse,
        torch.from_numpy(g), **kw)
    # the CPU wrapper is the plain version
    wrapped = tfa.flash_attention_backward(
        tq.detach(), tk.detach(), tv.detach(), out.detach(), lse,
        torch.from_numpy(g), **kw)

    def jloss(q_, k_, v_):
        o = attn_core(q_, k_, v_, **kw).reshape(b, s, h, dh)
        return jnp.sum(o * g)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    for name, a, w, x, j in zip("qkv", got, want, wrapped, jg):
        assert a.shape == w.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, w, atol=BWD_ATOL, rtol=0)
        assert torch.equal(a, x)
        np.testing.assert_allclose(a.numpy(), np.asarray(j),
                                   atol=BWD_JAX_ATOL, rtol=0, err_msg=name)


def test_reference_lse_is_the_rows_logsumexp(rng):
    """``return_lse``: the (B, H, S) log-sum-exp of each row's visible
    scaled scores (what the kernels write for the backward)."""
    q = torch.from_numpy(rng.standard_normal((1, 6, 4, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 6, 2, 16)).astype(
        np.float32))
    _, lse = tfa.flash_attention_reference(q, k, k, return_lse=True)
    sc = torch.einsum("bshd,bthd->bhst", q,
                      k.repeat_interleave(2, dim=2)) / 4.0
    sc = sc.masked_fill(~torch.ones(6, 6, dtype=torch.bool).tril(),
                        -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(sc, -1), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# one train step, both packages, every family
# ---------------------------------------------------------------------------

_FAMILIES = {"dense": ("qwen2.5-14b", {}),
             "moe_dense": ("deepseek-moe-16b", {"router_offload": "dense"}),
             "moe_cam": ("deepseek-moe-16b", {"router_offload": "cam"}),
             "ssm": ("xlstm-125m", {}),
             "hybrid": ("zamba2-2.7b", {}),
             "vlm": ("paligemma-3b", {}),
             "audio": ("whisper-medium", {})}


def _cfgs(arch, extra):
    kw = dict(param_dtype="float32", compute_dtype="float32", **extra)
    return (dataclasses.replace(r_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _batch(cfg, rng):
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_step(family):
    """The reference's state, batch, loss, gradients and the state after
    one step (one jit per family), as numpy."""
    arch, extra = _FAMILIES[family]
    rcfg, _ = _cfgs(arch, extra)
    batch = _batch(rcfg, np.random.default_rng(7))
    step = rs.make_train_step(rcfg, r_warmup_cosine(LR, 2, 10),
                              RAdamWConfig())

    def both(state, b):
        (loss, _), g = jax.value_and_grad(
            lambda p: rs.loss_fn(p, rcfg, b), has_aux=True)(state.params)
        return loss, g, step(state, b)

    state = rs.init_train_state(jax.random.PRNGKey(0), rcfg)
    loss, grads, (new, metrics) = jax.jit(both)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    as_np = functools.partial(jax.tree.map, np.asarray)
    return (as_np(state), batch, float(loss), as_np(grads), as_np(new),
            {k: float(v) for k, v in metrics.items()})


def _by_path(tree):
    return dict(leaves_with_paths(tree))


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_one_train_step_matches_reference(family):
    arch, extra = _FAMILIES[family]
    _, tcfg = _cfgs(arch, extra)
    r_state, batch, r_loss, r_grads, r_new, r_metrics = \
        _reference_step(family)
    state = convert.train_state_from_reference(r_state, tcfg, device="cpu")
    tb = _torch_batch(batch)

    (loss, _), grads = ts._grad_of(state.params, tcfg, tb)
    assert abs(float(loss) - r_loss) <= LOSS_ATOL
    want_g = _by_path(r_grads)
    for path, g in leaves_with_paths(grads):
        w = want_g.pop(path)
        err = np.linalg.norm(g.numpy() - w)
        assert err <= GRAD_RTOL * np.linalg.norm(w) + GRAD_ATOL, path
    assert not want_g

    step = ts.make_train_step(tcfg, warmup_cosine(LR, 2, 10), AdamWConfig())
    new, metrics = step(state, tb)
    assert abs(float(metrics["loss"]) - r_metrics["loss"]) <= LOSS_ATOL
    assert float(metrics["grad_norm"]) == pytest.approx(
        r_metrics["grad_norm"], rel=1e-5)
    assert metrics["lr"] == r_metrics["lr"]
    assert int(new.step) == int(r_new.step) == 1
    assert int(new.opt.count) == int(r_new.opt.count) == 1
    for name, atol in (("mu", MU_ATOL), ("nu", NU_ATOL)):
        want = _by_path(getattr(r_new.opt, name))
        for path, x in leaves_with_paths(getattr(new.opt, name)):
            np.testing.assert_allclose(x.numpy(), want[path], atol=atol,
                                       rtol=0, err_msg=f"{name} {path}")
    g_by = _by_path(r_grads)
    for tree, r_tree in ((new.opt.master, r_new.opt.master),
                         (new.params, r_new.params)):
        want = _by_path(r_tree)
        for path, x in leaves_with_paths(tree):
            g = np.abs(g_by[path])
            clear = g > SIGN_FLOOR * max(g.max(), 1e-30)
            diff = np.abs(x.detach().numpy() - want[path])
            assert diff[clear].max(initial=0) <= PARAM_ATOL, path
            assert diff.max(initial=0) <= 2 * LR, path


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_the_gradients(remat, rng):
    """``forward(train=True)`` under ``remat`` checkpoints each layer
    body: the loss and every gradient are those of ``remat="none"``
    (recomputation repeats the same float32 operations)."""
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-14b"),
                              param_dtype="float32",
                              compute_dtype="float32")
    state = ts.init_train_state(cfg, seed=1, device="cpu")
    tb = _torch_batch(_batch(cfg, rng))
    (l0, _), g0 = ts._grad_of(state.params, cfg, tb)
    (l1, _), g1 = ts._grad_of(state.params,
                              dataclasses.replace(cfg, remat=remat), tb)
    assert float(l0) == float(l1)
    for (path, a), (_, c) in zip(leaves_with_paths(g0),
                                 leaves_with_paths(g1)):
        torch.testing.assert_close(a, c, atol=1e-6, rtol=1e-5, msg=path)


def test_microbatches_and_compression_match_reference():
    """Two microbatches and the int8 error-feedback compressor: one step
    from the same state in both packages."""
    from repro.distributed import ErrorFeedbackInt8 as RInt8
    from repro_torch.distributed import ErrorFeedbackInt8
    rcfg, tcfg = _cfgs("qwen2.5-14b", {})
    batch = _batch(tcfg, np.random.default_rng(3))
    batch = {k: np.concatenate([v, v[::-1]]) for k, v in batch.items()}
    r_state = rs.init_train_state(jax.random.PRNGKey(1), rcfg, RInt8())
    r_step = jax.jit(rs.make_train_step(rcfg, r_warmup_cosine(LR, 2, 10),
                                        RAdamWConfig(), compressor=RInt8(),
                                        microbatches=2))
    r_new, r_metrics = r_step(r_state, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    state = convert.train_state_from_reference(
        jax.tree.map(np.asarray, r_state), tcfg, device="cpu")
    step = ts.make_train_step(tcfg, warmup_cosine(LR, 2, 10),
                              AdamWConfig(), compressor=ErrorFeedbackInt8(),
                              microbatches=2)
    new, metrics = step(state, _torch_batch(batch))
    assert abs(float(metrics["loss"]) - float(r_metrics["loss"])) <= \
        LOSS_ATOL
    want = _by_path(jax.tree.map(np.asarray, r_new.comp.error))
    for path, e in leaves_with_paths(new.comp.error):
        np.testing.assert_allclose(e.numpy(), want[path], atol=1e-5, rtol=0,
                                   err_msg=path)
