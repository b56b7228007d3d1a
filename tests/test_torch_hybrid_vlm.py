"""Port LM families hybrid (zamba2: Mamba2 blocks and one shared
attention block) and vlm (paligemma: a prefix-LM over vision
embeddings) vs the reference, on the CPU: the Mamba2 block
(``mamba2_forward``: the chunked scan with padding, a prefill from a
carried state, the O(1) decode step, the causal conv with and without
state), ``forward`` (and ``return_hidden``), prefill + decode, the
parameter tree, and greedy ``Server`` streams.

Models: the smoke configs of zamba2-2.7b (2 layers, one Mamba2 block a
group, head dim 16) and paligemma-3b (2 layers, MQA, 8 vision rows),
plus narrow variants at the full models' head dims: zamba2 with
``n_layers`` 5 and ``shared_attn_every`` 2 (3 groups of 2: the
reference builds 6 Mamba2 blocks for 5 layers) at head dim 80, and
paligemma at head dim 256.  Parameters are the reference's
``init_params`` carried across by ``convert.lm_params_from_reference``;
tokens and vision embeddings come from numpy.

Tolerances (those of ``tests/test_torch_lm_families.py``).  Float32
logits within 1e-5, also with the decode cache in float32 on both sides;
over the reference's bfloat16 attention cache 5e-3 (a key within the
frameworks' summation-order difference of a bf16 rounding boundary
rounds to the neighbouring value on one side); bfloat16 logits within
0.1.  The Mamba2 block alone: float32 outputs and states within 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_get_smoke_config
from repro.launch import serve as rserve
from repro.models import mamba2 as rmb
from repro.models import model as rm
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import mamba2 as tmb
from repro_torch.models import model as tm

F32_TOL = 1e-5
BF16_CACHE_TOL = 5e-3
BF16_LOGIT_ATOL = 0.1
B, S, N_PREFILL = 2, 12, 8

#: name -> (arch, overrides of the smoke config)
MODELS = {
    "zamba2": ("zamba2-2.7b", {}),
    "zamba2-per2-dh80": ("zamba2-2.7b", dict(n_layers=5, shared_attn_every=2,
                                             d_model=160, n_heads=2,
                                             n_kv_heads=2, d_head=80)),
    "paligemma": ("paligemma-3b", {}),
    "paligemma-dh256": ("paligemma-3b", dict(d_model=128, n_heads=2,
                                             n_kv_heads=1, d_head=256)),
}


def _cfgs(name, dtype):
    arch, kw = MODELS[name]
    kw = dict(kw, param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(r_get_smoke_config(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def _lm(name, dtype="float32"):
    """The model on both sides, its inputs and the reference's jitted
    entry points, built once per case."""
    rcfg, tcfg = _cfgs(name, dtype)
    rparams = rm.init_params(jax.random.PRNGKey(3), rcfg)
    np_params = jax.tree.map(np.asarray, rparams)
    tparams = convert.lm_params_from_reference(np_params, tcfg,
                                               device="cpu")
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (B, S))}
    if tcfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, tcfg.n_vision_tokens, tcfg.d_model)).astype(np.float32)
    fns = {"forward": jax.jit(lambda p, b: rm.forward(p, rcfg, b,
                                                      train=False)),
           "prefill": jax.jit(lambda p, b, c: rm.prefill(p, rcfg, b, c)),
           "decode": jax.jit(lambda p, t, c: rm.decode_step(p, rcfg, t, c))}
    return dict(rcfg=rcfg, tcfg=tcfg, rparams=rparams, np_params=np_params,
                tparams=tparams, batch=batch, fns=fns)


@pytest.fixture(params=list(MODELS))
def lm(request):
    return _lm(request.param)


def _rbatch(batch, n=S):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"][:, :n]
    return out


def _tbatch(batch, n=S):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"][:, :n]
    return out


def _ref_serve(lm, f32_cache):
    """Reference prefill(t[:N_PREFILL]) then decode steps: logits at
    positions N_PREFILL-1 .. S-1, float32 numpy."""
    fns, p = lm["fns"], lm["rparams"]
    cache = rm.init_decode_cache(lm["rcfg"], B, S + 2)
    if f32_cache:
        cache = jax.tree.map(
            lambda a: a.astype(jnp.float32)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, cache)
    lg, cache = fns["prefill"](p, _rbatch(lm["batch"], N_PREFILL), cache)
    outs = [lg]
    toks = jnp.asarray(lm["batch"]["tokens"])
    for i in range(N_PREFILL, S):
        lg, cache = fns["decode"](p, toks[:, i:i + 1], cache)
        outs.append(lg)
    return np.asarray(jnp.concatenate(outs, axis=1), np.float32)


def _port_serve(lm, f32_cache):
    cfg, p = lm["tcfg"], lm["tparams"]
    cache = tm.init_decode_cache(cfg, B, S + 2, device="cpu")
    if f32_cache:
        cache = tm._tree_map(
            lambda t: t.float() if isinstance(t, torch.Tensor)
            and t.is_floating_point() else t, cache)
    lg, cache = tm.prefill(p, cfg, _tbatch(lm["batch"], N_PREFILL), cache)
    outs = [lg]
    toks = torch.from_numpy(lm["batch"]["tokens"])
    for i in range(N_PREFILL, S):
        lg, cache = tm.decode_step(p, cfg, toks[:, i:i + 1], cache)
        outs.append(lg)
    prefix = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    assert tm._cache_len(cache, cfg) == prefix + S
    return torch.cat(outs, dim=1).numpy()


# ---------------------------------------------------------------------------
# the entry points against the reference
# ---------------------------------------------------------------------------


def test_forward_matches_reference(lm):
    """Logits of the text positions only (vlm drops its vision rows)."""
    want = np.asarray(lm["fns"]["forward"](lm["rparams"],
                                           _rbatch(lm["batch"])), np.float32)
    got = tm.forward(lm["tparams"], lm["tcfg"], _tbatch(lm["batch"])).numpy()
    assert got.shape == (B, S, lm["tcfg"].vocab) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_forward_return_hidden_matches_reference(lm):
    want = np.asarray(rm.forward(lm["rparams"], lm["rcfg"],
                                 _rbatch(lm["batch"]), train=False,
                                 return_hidden=True), np.float32)
    got = tm.forward(lm["tparams"], lm["tcfg"], _tbatch(lm["batch"]),
                     return_hidden=True).numpy()
    assert got.shape == (B, S, lm["tcfg"].d_model)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_prefill_and_decode_match_reference(lm):
    """Float32 caches on both sides: the arithmetic within 1e-5."""
    np.testing.assert_allclose(_port_serve(lm, True), _ref_serve(lm, True),
                               atol=F32_TOL, rtol=F32_TOL)


def test_prefill_and_decode_match_reference_bf16_cache(lm):
    """The default caches: bfloat16 attention rows (and, for hybrid, a
    bfloat16 conv state that both sides return in the compute dtype)."""
    np.testing.assert_allclose(_port_serve(lm, False),
                               _ref_serve(lm, False), atol=BF16_CACHE_TOL)


def test_prefill_then_decode_matches_forward(lm):
    """The decode contract on the port alone, on a float32 cache: the
    chunked scan and the recurrent step sum in other orders."""
    full = tm.forward(lm["tparams"], lm["tcfg"],
                      _tbatch(lm["batch"])).numpy()[:, N_PREFILL - 1:S]
    np.testing.assert_allclose(_port_serve(lm, True), full, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("name", ["zamba2-per2-dh80", "paligemma-dh256"])
def test_bfloat16_forward_matches_reference(name):
    lm = _lm(name, "bfloat16")
    want = np.asarray(lm["fns"]["forward"](lm["rparams"],
                                           _rbatch(lm["batch"])), np.float32)
    got = tm.forward(lm["tparams"], lm["tcfg"], _tbatch(lm["batch"])).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_LOGIT_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MODELS))
def test_params_tree_matches_reference(name, dtype):
    """``init_params`` gives the reference's keys, shapes and dtypes (one
    unstacked ``shared_attn``; ``ceil(n_layers / per) * per`` stacked
    Mamba2 blocks), each layer drawn on its own; ``convert`` carries the
    reference's leaves across exactly."""
    rcfg, tcfg = _cfgs(name, dtype)
    rparams = jax.tree.map(np.asarray,
                           rm.init_params(jax.random.PRNGKey(2), rcfg))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), rparams)
    tparams = tm.init_params(tcfg, seed=0, device="cpu")
    got = tm._tree_map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")),
                       tparams)
    assert got == want
    if tcfg.family == "hybrid":
        ng, per = tm._groups(tcfg)
        assert tparams["mamba_blocks"]["mamba"]["in_proj"].shape[0] == \
            ng * per >= tcfg.n_layers
        w = tparams["mamba_blocks"]["mamba"]["in_proj"]
    else:
        w = tparams["blocks"]["attn"]["wq"]
    assert not torch.equal(w[0], w[1])
    conv = convert.lm_params_from_reference(rparams, tcfg, device="cpu")
    for path, a in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        t = conv
        for p in path:
            t = t[p.key]
        assert str(t.dtype).replace("torch.", "") == str(a.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))


@pytest.mark.parametrize("name", list(MODELS))
def test_decode_cache_matches_reference(name):
    """``init_decode_cache``: the reference's tree, shapes and dtypes
    (vlm: ``max_len + n_vision_tokens`` rows; hybrid: one attention layer
    per group, the conv state bfloat16), with a host-int ``len``."""
    rcfg, tcfg = _cfgs(name, "float32")
    rc = rm.init_decode_cache(rcfg, 3, 9)
    tc = tm.init_decode_cache(tcfg, 3, 9, device="cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), rc)
    got = tm._tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
        if isinstance(t, torch.Tensor) else ((), "int32"), tc)
    assert got == want
    assert tm._cache_len(tc, tcfg) == 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["zamba2-per2-dh80", "paligemma-dh256"])
def test_greedy_server_streams_match_reference(name):
    """``Server`` (vlm over zero vision embeddings, as the reference
    serves it) gives the reference Server's greedy streams and counts."""
    lm = _lm(name)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, lm["tcfg"].vocab, 6) for _ in range(3)]

    def serve(mod, cfg, params, **kw):
        srv = mod.Server(cfg, params, batch=2, max_len=12, **kw)
        reqs = [mod.Request(rid=i, prompt=p, max_new=5)
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        return [r.out for r in reqs], srv.run()

    want, rstats = serve(rserve, lm["rcfg"], lm["rparams"])
    got, tstats = serve(tserve, lm["tcfg"], lm["tparams"], device="cpu")
    assert got == want and all(len(o) == 5 for o in got)
    for key in ("completed", "prefills", "decode_steps", "tokens"):
        assert tstats[key] == rstats[key], key


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------


def _mamba(rng, d_model=64, ssm_state=16):
    rcfg, tcfg = (dataclasses.replace(c, d_model=d_model, ssm_state=ssm_state)
                  for c in _cfgs("zamba2", "float32"))
    rp = jax.tree.map(np.asarray, rmb.init_mamba2(jax.random.PRNGKey(5),
                                                  rcfg))
    # nonzero A_log, D and dt_bias, so every term of the scan counts
    nh = rp["A_log"].shape[0]
    rp = dict(rp, A_log=rng.standard_normal(nh).astype(np.float32) * 0.5,
              D=rng.standard_normal(nh).astype(np.float32),
              dt_bias=rng.standard_normal(nh).astype(np.float32) * 0.5)
    tp = convert.lm_params_from_reference(rp, tcfg, device="cpu")
    return rcfg, tcfg, rp, tp


def _state(rng, cfg, b):
    d_inner, nh, dh, ds = tmb._dims(cfg)
    return {"ssm": rng.standard_normal((b, nh, dh, ds)).astype(np.float32),
            "conv": rng.standard_normal(
                (b, cfg.ssm_conv - 1, d_inner + 2 * ds)).astype(np.float32)}


def _close_tree(got, want):
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_chunked_scan_matches_reference(with_state, rng):
    """chunk 8 over S = 21: three chunks, the last padded; with a state,
    the prefill starts from its ssm and conv state."""
    rcfg, tcfg, rp, tp = _mamba(rng)
    x = rng.standard_normal((2, 21, 64)).astype(np.float32)
    st = _state(rng, tcfg, 2) if with_state else None
    want, wst = rmb.mamba2_forward(
        rp, jnp.asarray(x), rcfg, chunk=8,
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    got, gst = tmb.mamba2_forward(
        tp, torch.from_numpy(x), tcfg, chunk=8,
        state=None if st is None else tm._tree_map(torch.from_numpy, st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    _close_tree(gst, wst)


def test_mamba2_decode_step_matches_reference(rng):
    """S = 1 with a state: the O(1) recurrence, three steps in a row."""
    rcfg, tcfg, rp, tp = _mamba(rng)
    st = _state(rng, tcfg, 3)
    rst, tst = jax.tree.map(jnp.asarray, st), tm._tree_map(torch.from_numpy,
                                                          st)
    for _ in range(3):
        x = rng.standard_normal((3, 1, 64)).astype(np.float32)
        want, rst = rmb.mamba2_forward(rp, jnp.asarray(x), rcfg, state=rst)
        got, tst = tmb.mamba2_forward(tp, torch.from_numpy(x), tcfg,
                                      state=tst)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_TOL, rtol=F32_TOL)
        _close_tree(tst, rst)


def test_mamba2_chunks_give_the_one_chunk_result(rng):
    """The carried state across chunks gives the single-chunk scan."""
    _, tcfg, _, tp = _mamba(rng)
    x = torch.from_numpy(rng.standard_normal((1, 24, 64)).astype(np.float32))
    one, s1 = tmb.mamba2_forward(tp, x, tcfg, chunk=32)
    many, s2 = tmb.mamba2_forward(tp, x, tcfg, chunk=8)
    torch.testing.assert_close(many, one, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(s2["ssm"], s1["ssm"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state, rng):
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    want, wst = rmb._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 None if st is None else jnp.asarray(st))
    got, gst = tmb._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(gst.numpy(), np.asarray(wst))


def test_mamba_state_matches_reference():
    _, tcfg = _cfgs("zamba2", "float32")
    rst = rmb.init_mamba_state(tcfg, 3)
    tst = tmb.init_mamba_state(tcfg, 3, device="cpu")
    for k in ("ssm", "conv"):
        assert tuple(tst[k].shape) == rst[k].shape
        assert str(tst[k].dtype).replace("torch.", "") == str(rst[k].dtype)
        assert not tst[k].any()
