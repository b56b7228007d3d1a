"""Port LM (dense family) vs the reference, on the CPU: the config
registry, the layers, and ``forward`` / ``prefill`` / ``decode_step``
logits on the same parameters (the reference's ``init_params`` carried
across by ``convert.lm_params_from_reference``) and the same tokens.

The model is ``reduced(qwen2.5-14b, n_heads=10, d_model=160)``: 2 layers,
10 query heads over 2 kv heads (a GQA group of 5), head dim 16, QKV bias,
RoPE theta 1e6.  Float32 logits agree within 1e-5; bfloat16 logits
within ``BF16_LOGIT_ATOL`` (bf16 rounding of every activation, in two
frameworks that round at different places), with argmax agreement
except near-ties.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as R_ARCH_IDS
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models import layers as rl
from repro.models import model as rm
from repro.models.config import reduced as r_reduced
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models.config import reduced

#: float32 logits: measured max |diff| 4.1e-6 (magnitude up to 4.3); the
#: contract's 1e-4, tightened
F32_TOL = 1e-5
#: bfloat16 logits: measured max |diff| 0.039, one to two bf16 steps at
#: magnitude 2-4
BF16_LOGIT_ATOL = 0.1
NEAR_TIE = 5e-3
B, S, N_PREFILL = 2, 12, 8


def _cfgs(dtype, rope=None):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    if rope is not None:
        kw["rope"] = rope
    ref = dataclasses.replace(
        r_reduced(r_get_config("qwen2.5-14b"), n_heads=10, d_model=160), **kw)
    port = dataclasses.replace(
        reduced(get_config("qwen2.5-14b"), n_heads=10, d_model=160), **kw)
    return ref, port


def _ref_fns(cfg):
    return {
        "forward": jax.jit(lambda p, t: rm.forward(p, cfg, {"tokens": t},
                                                   train=False)),
        "prefill": jax.jit(lambda p, t, c: rm.prefill(p, cfg, {"tokens": t},
                                                      c)),
        "decode": jax.jit(lambda p, t, c: rm.decode_step(p, cfg, t, c)),
    }


@functools.lru_cache(maxsize=None)
def _lm(dtype, rope=None):
    """The model, its parameters on both sides, tokens and the
    reference's jitted entry points, built once per dtype (and
    ``rope`` override)."""
    rcfg, tcfg = _cfgs(dtype, rope)
    assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim) == (10, 2, 16)
    rparams = rm.init_params(jax.random.PRNGKey(3), rcfg)
    np_params = jax.tree.map(np.asarray, rparams)
    tparams = convert.lm_params_from_reference(np_params, tcfg,
                                               device="cpu")
    tokens = np.random.default_rng(11).integers(0, tcfg.vocab, (B, S))
    return dict(dtype=dtype, rcfg=rcfg, tcfg=tcfg, rparams=rparams,
                np_params=np_params, tparams=tparams, tokens=tokens,
                fns=_ref_fns(rcfg))


@pytest.fixture(params=["float32", "bfloat16"])
def lm(request):
    return _lm(request.param)


def _ref_serve(lm):
    """Reference prefill(t[:N_PREFILL]) then decode steps: logits at
    positions N_PREFILL-1 .. S-1, float32 numpy."""
    fns, p, t = lm["fns"], lm["rparams"], jnp.asarray(lm["tokens"],
                                                      jnp.int32)
    cache = rm.init_decode_cache(lm["rcfg"], B, S + 2)
    lg, cache = fns["prefill"](p, t[:, :N_PREFILL], cache)
    outs = [lg]
    for i in range(N_PREFILL, S):
        lg, cache = fns["decode"](p, t[:, i:i + 1], cache)
        outs.append(lg)
    return np.asarray(jnp.concatenate(outs, axis=1), np.float32)


def _port_serve(lm):
    cfg, p = lm["tcfg"], lm["tparams"]
    t = torch.from_numpy(lm["tokens"])
    cache = tm.init_decode_cache(cfg, B, S + 2, device="cpu")
    lg, cache = tm.prefill(p, cfg, {"tokens": t[:, :N_PREFILL]}, cache)
    assert cache["len"] == N_PREFILL
    outs = [lg]
    for i in range(N_PREFILL, S):
        lg, cache = tm.decode_step(p, cfg, t[:, i:i + 1], cache)
        outs.append(lg)
    assert cache["len"] == S
    return torch.cat(outs, dim=1).numpy()


def _assert_logits_close(got, want, dtype):
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_LOGIT_ATOL)
    _assert_argmax_agrees(got, want)


def _assert_argmax_agrees(got, want):
    """argmax agreement everywhere except near-ties of ``want``."""
    pick = got.argmax(-1)
    at_pick = np.take_along_axis(want, pick[..., None], axis=-1)[..., 0]
    bad = ~((pick == want.argmax(-1)) | (want.max(-1) - at_pick < NEAR_TIE))
    assert not bad.any(), f"argmax mismatch beyond near-ties at " \
                          f"{np.argwhere(bad)}"


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


def test_config_registry_matches_reference():
    assert ARCH_IDS == R_ARCH_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(r_get_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(r_get_smoke_config(arch))
        assert get_config(arch).param_count() == \
            r_get_config(arch).param_count()


def test_lm_params_from_reference_keeps_keys_shapes_dtypes(lm):
    flat_r = jax.tree_util.tree_flatten_with_path(lm["np_params"])[0]
    flat_t = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat_t[path + (k,)] = v
    walk(lm["tparams"], ())
    assert len(flat_r) == len(flat_t) > 10
    want_dtype = getattr(torch, lm["dtype"])
    for path, a in flat_r:
        key = tuple(p.key for p in path)
        t = flat_t[key]
        assert tuple(t.shape) == a.shape, key
        assert t.dtype == want_dtype, key
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))


def test_init_params_shapes_match_reference(lm):
    """The port's own random init has the reference's tree, shapes and
    dtypes (not its numbers), is reproducible under its seed, and draws
    each layer on its own."""
    cfg = lm["tcfg"]
    a = tm.init_params(cfg, seed=1, device="cpu")
    b = tm.init_params(cfg, seed=1, device="cpu")
    want = jax.tree.map(lambda x: (x.shape, str(x.dtype)), lm["np_params"])
    got = tm._tree_map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), a)
    assert got == want
    assert all(torch.equal(x, y)
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    wq = a["blocks"]["attn"]["wq"]
    assert not torch.equal(wq[0], wq[1])


def test_other_families_raise_not_implemented():
    """No family of the reference is refused any more: the hybrid and vlm
    smoke models run every entry point.  A family the reference does not
    know raises ``ValueError`` at each of them, as the reference's
    ``init_params`` does."""
    toks = torch.zeros((1, 4), dtype=torch.int64)
    for arch in ("zamba2-2.7b", "paligemma-3b"):
        cfg = get_smoke_config(arch)
        params = tm.init_params(cfg, device="cpu")
        cache = tm.init_decode_cache(cfg, 1, 8, device="cpu")
        batch = {"tokens": toks}
        if cfg.family == "vlm":
            batch["vision"] = torch.zeros((1, cfg.n_vision_tokens,
                                           cfg.d_model))
        assert tm.forward(params, cfg, batch).shape == (1, 4, cfg.vocab)
        _, cache = tm.prefill(params, cfg, batch, cache)
        lg, _ = tm.decode_step(params, cfg, toks[:, :1], cache)
        assert lg.shape == (1, 1, cfg.vocab)
    cfg = dataclasses.replace(get_smoke_config("paligemma-3b"),
                              family="diffusion")
    for call in (lambda: tm.init_params(cfg, device="cpu"),
                 lambda: tm.init_decode_cache(cfg, 1, 8, device="cpu"),
                 lambda: tm.forward({}, cfg, {"tokens": toks}),
                 lambda: tm.prefill({}, cfg, {"tokens": toks}, {}),
                 lambda: tm.decode_step({}, cfg, toks[:, :1], {})):
        with pytest.raises(ValueError, match="unknown family diffusion"):
            call()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(norm, dtype, rng):
    rcfg, tcfg = (dataclasses.replace(c, norm=norm) for c in _cfgs(dtype))
    x = rng.standard_normal((2, 5, 160)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(160).astype(np.float32)
    bias = rng.standard_normal(160).astype(np.float32)
    rp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    want = rl.apply_norm(rp, jnp.asarray(x, dtype), rcfg)
    got = tl.apply_norm(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                        tcfg)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-5 if dtype == "float32" else 0.02,
                               rtol=1e-5 if dtype == "float32" else 0.01)


@pytest.mark.parametrize("rope,theta", [("standard", 1e6), ("2d", 1e4),
                                        ("none", 1e4)])
def test_apply_rope(rope, theta, rng):
    rcfg, tcfg = (dataclasses.replace(c, rope=rope, rope_theta=theta)
                  for c in _cfgs("float32"))
    x = rng.standard_normal((2, 9, 10, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 9))
    want = rl.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), rcfg)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_attention_with_and_without_cache(lm, rng):
    rcfg, tcfg = lm["rcfg"], lm["tcfg"]
    rp = jax.tree.map(lambda a: a[0], lm["rparams"]["blocks"]["attn"])
    tp = tm._layer(lm["tparams"]["blocks"], 0)["attn"]
    dt = tl.cdtype(tcfg)
    x = rng.standard_normal((B, 6, 160)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (B, 6))
    tol = dict(atol=1e-5) if lm["dtype"] == "float32" else dict(atol=0.05)
    want, _ = rl.attention(rp, jnp.asarray(x, rcfg.compute_dtype), rcfg,
                           positions=jnp.asarray(pos))
    got, none = tl.attention(tp, torch.from_numpy(x).to(dt), tcfg,
                             positions=torch.from_numpy(pos.copy()))
    assert none is None
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    # prefill 6 rows into a cache, then one decode row at position 6
    rc = rl.init_cache(rcfg, B, 10)
    tc = tl.init_cache(tcfg, B, 10, "cpu")
    x1 = rng.standard_normal((B, 1, 160)).astype(np.float32)
    for xs, ps in ((x, pos), (x1, np.full((B, 1), 6))):
        want, rc = rl.attention(rp, jnp.asarray(xs, rcfg.compute_dtype),
                                rcfg, positions=jnp.asarray(ps), cache=rc)
        got, tc = tl.attention(tp, torch.from_numpy(xs).to(dt), tcfg,
                               positions=torch.from_numpy(ps.copy()),
                               cache=tc)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)
        assert tc["len"] == int(rc["len"])
        np.testing.assert_array_equal(tc["k"].float().numpy(),
                                      np.asarray(rc["k"], np.float32))


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=False, kv_len=9),
                                dict(causal=True, prefix_len=3),
                                dict(causal=True, q_start=8, kv_len=11)])
def test_attn_core_matches_reference(kw, rng):
    """The port's ``attn_core`` (B7's plain path, reference layout and
    (B, S, H*dh) output) on the reference's cases."""
    s = 3 if "q_start" in kw else 11
    q = rng.standard_normal((2, s, 10, 16)).astype(np.float32)
    k = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    want = rl.attn_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = tl.attn_core(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    assert tuple(got.shape) == (2, s, 160)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def test_ffn_embed_logits(lm, rng):
    rcfg, tcfg = lm["rcfg"], lm["tcfg"]
    dt = tl.cdtype(tcfg)
    tol = dict(atol=1e-5) if lm["dtype"] == "float32" else dict(atol=0.05)
    rp = jax.tree.map(lambda a: a[1], lm["rparams"]["blocks"]["ffn"])
    tp = tm._layer(lm["tparams"]["blocks"], 1)["ffn"]
    x = rng.standard_normal((B, 4, 160)).astype(np.float32)
    want = rl.ffn(rp, jnp.asarray(x, rcfg.compute_dtype), rcfg)
    got = tl.ffn(tp, torch.from_numpy(x).to(dt), tcfg)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    toks = lm["tokens"]
    want = rl.embed(lm["rparams"]["embed"], jnp.asarray(toks), rcfg)
    got = tl.embed(lm["tparams"]["embed"], torch.from_numpy(toks), tcfg)
    assert got.dtype == dt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    want = rl.logits(lm["rparams"]["embed"],
                     jnp.asarray(x, rcfg.compute_dtype), rcfg)
    got = tl.logits(lm["tparams"]["embed"], torch.from_numpy(x).to(dt), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# the model's entry points
# ---------------------------------------------------------------------------


def test_forward_matches_reference(lm):
    want = np.asarray(lm["fns"]["forward"](
        lm["rparams"], jnp.asarray(lm["tokens"], jnp.int32)), np.float32)
    got = tm.forward(lm["tparams"], lm["tcfg"],
                     {"tokens": torch.from_numpy(lm["tokens"])}).numpy()
    assert got.shape == (B, S, lm["tcfg"].vocab)
    _assert_logits_close(got, want, lm["dtype"])


def test_prefill_and_decode_match_reference(lm):
    _assert_logits_close(_port_serve(lm), _ref_serve(lm), lm["dtype"])


def test_absolute_positions_match_reference():
    """A dense model configured without RoPE adds the sinusoidal
    position embedding to its tokens (the reference's ``_embed_tokens``),
    at the decode offset by the cache's ``len`` too: ``forward``,
    ``prefill`` and ``decode_step`` in float32."""
    lm = _lm("float32", "none")
    assert lm["tcfg"].rope == "none"
    pos = torch.from_numpy(np.broadcast_to(np.arange(S), (B, S)).copy())
    np.testing.assert_allclose(
        tm._sinusoidal(pos, 160).numpy(),
        np.asarray(rm._sinusoidal(jnp.asarray(pos.numpy()), 160)),
        atol=1e-6)
    want = np.asarray(lm["fns"]["forward"](
        lm["rparams"], jnp.asarray(lm["tokens"], jnp.int32)), np.float32)
    got = tm.forward(lm["tparams"], lm["tcfg"],
                     {"tokens": torch.from_numpy(lm["tokens"])}).numpy()
    _assert_logits_close(got, want, "float32")
    _assert_logits_close(_port_serve(lm), _ref_serve(lm), "float32")


@pytest.mark.parametrize("rope", [None, "none"])
def test_forward_return_hidden_matches_reference(rope):
    """``forward(return_hidden=True)``: the post-final-norm hidden state
    (the reference's train-step input), float32."""
    lm = _lm("float32", rope)
    want = np.asarray(rm.forward(
        lm["rparams"], lm["rcfg"],
        {"tokens": jnp.asarray(lm["tokens"], jnp.int32)}, train=False,
        return_hidden=True), np.float32)
    got = tm.forward(lm["tparams"], lm["tcfg"],
                     {"tokens": torch.from_numpy(lm["tokens"])},
                     return_hidden=True).numpy()
    assert got.shape == (B, S, lm["tcfg"].d_model)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_prefill_then_decode_matches_forward():
    """The reference's decode-path contract, on the port alone, in
    float32: prefill plus decode steps give the teacher-forced logits
    (atol 0.75 / rtol 0.2, argmax equal except near-ties)."""
    lm = _lm("float32")
    full = tm.forward(lm["tparams"], lm["tcfg"],
                      {"tokens": torch.from_numpy(lm["tokens"])}).numpy()
    want = full[:, N_PREFILL - 1:S]
    got = _port_serve(lm)
    np.testing.assert_allclose(got, want, atol=0.75, rtol=0.2)
    _assert_argmax_agrees(got, want)


@pytest.mark.parametrize("case", ["decode", "prefill"])
def test_cache_write_past_max_len_raises_before_writing(case):
    """A prefill or decode step that would write past the cache's
    ``max_len`` rows raises one ``ValueError`` naming ``len``, ``S`` and
    ``max_len`` before any cache row is written (the reference's
    ``dynamic_update_slice`` clamps the start and overwrites rows)."""
    cfg = get_smoke_config("qwen2.5-14b")
    params = tm.init_params(cfg, seed=0, device="cpu")
    cache = tm.init_decode_cache(cfg, 1, 4, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(1, cfg.vocab, (1, 5)))
    if case == "decode":
        _, cache = tm.prefill(params, cfg, {"tokens": tokens[:, :3]}, cache)
        _, cache = tm.decode_step(params, cfg, tokens[:, 3:4], cache)
        assert cache["len"] == 4
        step = lambda: tm.decode_step(params, cfg, tokens[:, 4:5], cache)
        want = "len=4 rows and S=1 .* max_len=4"
    else:
        step = lambda: tm.prefill(params, cfg, {"tokens": tokens}, cache)
        want = "len=0 rows and S=5 .* max_len=4"
    k, v = cache["k"].clone(), cache["v"].clone()
    with pytest.raises(ValueError, match=want):
        step()
    assert torch.equal(cache["k"], k) and torch.equal(cache["v"], v)
