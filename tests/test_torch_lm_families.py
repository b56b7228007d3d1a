"""Port LM families beyond dense (moe, audio, ssm) vs the reference, on
the CPU: ``forward`` / ``prefill`` / ``decode_step`` logits, the decode
contract (prefill + decode == forward), greedy ``Server`` streams, the
parameter tree, cross-attention (``attention(kv_source=)``), the
encoder and cross-attention decoder blocks, and the xLSTM blocks.

Models: the smoke configs of deepseek-moe-16b (1 dense + 1 MoE layer,
top-2 of 8 experts, 1 shared), phi3.5-moe-42b-a6.6b (2 MoE layers,
LayerNorm), whisper-medium (2 encoder + 2 decoder layers over 16
frames, QKV bias, GELU) and xlstm-125m (one mLSTM/sLSTM pair), each
with ``router_offload`` "dense" and "cam" for the moe family.
Parameters are the reference's ``init_params`` carried across by
``convert.lm_params_from_reference``; tokens and frames come from numpy.

Tolerances.  Float32 logits within 1e-5, as the dense family is held,
with the decode cache in float32 on both sides.  The reference's cache
is bfloat16 whatever the compute dtype; with it, a key or value whose
float32 value lies within the two frameworks' summation-order
difference (about 1e-6) of a bf16 rounding boundary rounds to the
neighbouring bf16 on one side, one bf16 step of the cache entry, which
moves the logits up to about 1e-3: that comparison is held to 5e-3.
Bfloat16 logits within ``BF16_LOGIT_ATOL``.
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
from repro.models import blocks as rb
from repro.models import layers as rl
from repro.models import model as rm
from repro.models import xlstm as rx
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tb
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models import xlstm as tx

F32_TOL = 1e-5
#: float32 compute over the reference's bfloat16 cache (module docstring)
BF16_CACHE_TOL = 5e-3
#: bfloat16 logits: one to two bf16 steps at magnitudes up to about 4
BF16_LOGIT_ATOL = 0.1
B, S, N_PREFILL = 2, 12, 8

#: (arch, router offload)
MODELS = [("deepseek-moe-16b", "dense"), ("deepseek-moe-16b", "cam"),
          ("phi3.5-moe-42b-a6.6b", "dense"), ("phi3.5-moe-42b-a6.6b", "cam"),
          ("whisper-medium", "dense"), ("xlstm-125m", "dense")]
IDS = [f"{a}-{o}" for a, o in MODELS]


def _cfgs(arch, offload, dtype, **kw):
    kw.update(param_dtype=dtype, compute_dtype=dtype, router_offload=offload)
    return (dataclasses.replace(r_get_smoke_config(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def _lm(arch, offload, dtype="float32", capacity_factor=None):
    """The model on both sides, tokens (and frames) and the reference's
    jitted entry points, built once per case."""
    kw = {} if capacity_factor is None else \
        dict(capacity_factor=capacity_factor)
    rcfg, tcfg = _cfgs(arch, offload, dtype, **kw)
    rparams = rm.init_params(jax.random.PRNGKey(3), rcfg)
    np_params = jax.tree.map(np.asarray, rparams)
    tparams = convert.lm_params_from_reference(np_params, tcfg,
                                               device="cpu")
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (B, S))}
    if tcfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)
    fns = {"forward": jax.jit(lambda p, b: rm.forward(p, rcfg, b,
                                                      train=False)),
           "prefill": jax.jit(lambda p, b, c: rm.prefill(p, rcfg, b, c)),
           "decode": jax.jit(lambda p, t, c: rm.decode_step(p, rcfg, t, c))}
    return dict(rcfg=rcfg, tcfg=tcfg, rparams=rparams, np_params=np_params,
                tparams=tparams, batch=batch, fns=fns, dtype=dtype)


@pytest.fixture(params=MODELS, ids=IDS)
def lm(request):
    return _lm(*request.param)


def _rbatch(batch, n=S):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"][:, :n]
    return out


def _tbatch(batch, n=S):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"][:, :n]
    return out


def _f32_cache_r(cache):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, cache)


def _f32_cache_t(cache):
    return tm._tree_map(
        lambda t: t.float() if isinstance(t, torch.Tensor)
        and t.is_floating_point() else t, cache)


def _ref_serve(lm, f32_cache):
    """Reference prefill(t[:N_PREFILL]) then decode steps: logits at
    positions N_PREFILL-1 .. S-1, float32 numpy."""
    fns, p = lm["fns"], lm["rparams"]
    cache = rm.init_decode_cache(lm["rcfg"], B, S + 2)
    if f32_cache:
        cache = _f32_cache_r(cache)
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
        cache = _f32_cache_t(cache)
    lg, cache = tm.prefill(p, cfg, _tbatch(lm["batch"], N_PREFILL), cache)
    outs = [lg]
    toks = torch.from_numpy(lm["batch"]["tokens"])
    for i in range(N_PREFILL, S):
        lg, cache = tm.decode_step(p, cfg, toks[:, i:i + 1], cache)
        outs.append(lg)
    if cfg.family != "ssm":
        assert tm._cache_len(cache, cfg) == S
    return torch.cat(outs, dim=1).numpy()


def _assert_argmax_agrees(got, want, near_tie=5e-3):
    pick = got.argmax(-1)
    at_pick = np.take_along_axis(want, pick[..., None], axis=-1)[..., 0]
    bad = ~((pick == want.argmax(-1)) | (want.max(-1) - at_pick < near_tie))
    assert not bad.any(), f"argmax mismatch at {np.argwhere(bad)}"


# ---------------------------------------------------------------------------
# the entry points against the reference
# ---------------------------------------------------------------------------


def test_forward_matches_reference(lm):
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
    """The default bfloat16 cache on both sides (module docstring)."""
    got, want = _port_serve(lm, False), _ref_serve(lm, False)
    np.testing.assert_allclose(got, want, atol=BF16_CACHE_TOL)
    _assert_argmax_agrees(got, want)


@pytest.mark.parametrize("arch,offload", MODELS, ids=IDS)
def test_prefill_then_decode_matches_forward(arch, offload):
    """The reference's decode contract (``tests/test_models.py``) on the
    port alone, in float32 with capacity factor 64 so that no token
    drops (capacity drops depend on the tokens in a call): prefill plus
    decode steps give the teacher-forced logits within 0.75 + 0.2|x|,
    argmax equal except near-ties; on a float32 cache within 1e-4."""
    lm = _lm(arch, offload, capacity_factor=64.0)
    full = tm.forward(lm["tparams"], lm["tcfg"],
                      _tbatch(lm["batch"])).numpy()[:, N_PREFILL - 1:S]
    got = _port_serve(lm, False)
    np.testing.assert_allclose(got, full, atol=0.75, rtol=0.2)
    _assert_argmax_agrees(got, full)
    # the chunked and recurrent xLSTM forms sum in other orders
    np.testing.assert_allclose(_port_serve(lm, True), full, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "whisper-medium",
                                  "xlstm-125m"])
def test_bfloat16_forward_matches_reference(arch):
    lm = _lm(arch, "cam" if "moe" in arch else "dense", "bfloat16")
    want = np.asarray(lm["fns"]["forward"](lm["rparams"],
                                           _rbatch(lm["batch"])), np.float32)
    got = tm.forward(lm["tparams"], lm["tcfg"], _tbatch(lm["batch"])).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_LOGIT_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["whisper-medium", "xlstm-125m"])
def test_params_tree_matches_reference(arch, dtype):
    """``init_params`` gives the reference's keys, shapes and dtypes, its
    layers drawn each on their own; ``convert`` carries the reference's
    leaves across exactly (the moe family: ``tests/test_torch_moe.py``)."""
    rcfg, tcfg = _cfgs(arch, "dense", dtype)
    rparams = jax.tree.map(np.asarray,
                           rm.init_params(jax.random.PRNGKey(2), rcfg))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), rparams)
    tparams = tm.init_params(tcfg, seed=0, device="cpu")
    got = tm._tree_map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")),
                       tparams)
    assert got == want
    if arch == "whisper-medium":
        wq = tparams["enc_blocks"]["attn"]["wq"]
        assert not torch.equal(wq[0], wq[1])
    conv = convert.lm_params_from_reference(rparams, tcfg, device="cpu")
    for path, a in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        t = conv
        for p in path:
            t = t[p.key]
        assert str(t.dtype).replace("torch.", "") == str(a.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))


def test_convert_keeps_int_leaves_exact():
    big = np.array([2 ** 40 + 1, -3], np.int64)
    out = convert.lm_params_from_reference(
        {"a": {"ids": big, "w": np.float32([1.5])}}, get_smoke_config(
            "xlstm-125m"), device="cpu")
    assert out["a"]["ids"].dtype == torch.int64
    assert out["a"]["ids"].tolist() == big.tolist()
    assert out["a"]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,offload", [("deepseek-moe-16b", "cam"),
                                          ("whisper-medium", "dense"),
                                          ("xlstm-125m", "dense")])
def test_greedy_server_streams_match_reference(arch, offload):
    """``Server`` (the audio family over zero frames, as the reference
    serves it) gives the reference Server's greedy streams and counts."""
    lm = _lm(arch, offload)
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
# layers and blocks
# ---------------------------------------------------------------------------


def _layer_of(lm, name, i=0):
    rp = jax.tree.map(lambda a: a[i], lm["rparams"][name])
    return rp, tm._layer(lm["tparams"][name], i)


def test_cross_attention_matches_reference(rng):
    """``attention(kv_source=)``: keys and values from the encoder
    states, no RoPE (qwen's RoPE config here, so it would show) and no
    causal mask."""
    lm = _lm("whisper-medium", "dense")
    rcfg, tcfg = (dataclasses.replace(c, rope="standard")
                  for c in (lm["rcfg"], lm["tcfg"]))
    rp, tp = _layer_of(lm, "blocks")
    x = rng.standard_normal((B, 5, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 16, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5), (B, 5)).copy()
    want, _ = rl.attention(rp["cross"], jnp.asarray(x), rcfg,
                           positions=jnp.asarray(pos),
                           kv_source=jnp.asarray(enc))
    got, none = tl.attention(tp["cross"], torch.from_numpy(x), tcfg,
                             positions=torch.from_numpy(pos),
                             kv_source=torch.from_numpy(enc))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


def test_encoder_and_xdec_blocks_match_reference(rng):
    lm = _lm("whisper-medium", "dense")
    rcfg, tcfg = lm["rcfg"], lm["tcfg"]
    x = rng.standard_normal((B, 16, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (B, 16)).copy()
    rp, tp = _layer_of(lm, "enc_blocks", 1)
    want, _ = rb.apply_encoder_block(rp, jnp.asarray(x), rcfg,
                                     positions=jnp.asarray(pos))
    got, _ = tb.apply_encoder_block(tp, torch.from_numpy(x), tcfg,
                                    positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    # the decoder block over encoder states, with and without a cache
    rp, tp = _layer_of(lm, "blocks", 1)
    y = rng.standard_normal((B, 4, tcfg.d_model)).astype(np.float32)
    ypos = np.broadcast_to(np.arange(4), (B, 4)).copy()
    kv, dh = tcfg.n_kv_heads, tcfg.head_dim
    rc = {"self": {"k": jnp.zeros((B, 6, kv, dh)),
                   "v": jnp.zeros((B, 6, kv, dh)),
                   "len": jnp.zeros((), jnp.int32)}}
    tc = {"self": {"k": torch.zeros((B, 6, kv, dh)),
                   "v": torch.zeros((B, 6, kv, dh)), "len": 0}}
    for rcache, tcache in ((None, None), (rc, tc)):
        want, rnew = rb.apply_xdec_block(rp, jnp.asarray(y), rcfg,
                                         positions=jnp.asarray(ypos),
                                         enc=jnp.asarray(x), cache=rcache)
        got, tnew = tb.apply_xdec_block(tp, torch.from_numpy(y), tcfg,
                                        positions=torch.from_numpy(ypos),
                                        enc=torch.from_numpy(x),
                                        cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_TOL)
        assert (tnew is None) == (rnew is None)
    assert tnew["self"]["len"] == int(rnew["self"]["len"]) == 4


@pytest.mark.parametrize("s", [1, 7, 300])
def test_xlstm_blocks_match_reference(s, rng):
    """mLSTM (recurrent at S = 1 with a state, chunked otherwise: 300
    rows are two 256-row chunks, the second padded) and sLSTM, from a
    random state, against the reference's; float32 within 1e-5 (the
    chunked form's 256-term sums within 1e-4)."""
    lm = _lm("xlstm-125m", "dense")
    rcfg, tcfg = lm["rcfg"], lm["tcfg"]
    rp, tp = _layer_of(lm, "blocks")
    x = rng.standard_normal((B, s, tcfg.d_model)).astype(np.float32)
    tol = F32_TOL if s < 256 else 1e-4
    for kind, rfn, tfn in (("mlstm", rx.mlstm_forward, tx.mlstm_forward),
                           ("slstm", rx.slstm_forward, tx.slstm_forward)):
        st = {k: rng.standard_normal(np.shape(v)).astype(np.float32) * 0.5
              for k, v in rx.init_xlstm_state(rcfg, B, kind).items()}
        if kind == "slstm":
            st["m"] = np.abs(st["m"])
        want, wst = rfn(rp[kind], jnp.asarray(x), rcfg,
                        state={k: jnp.asarray(v) for k, v in st.items()})
        got, gst = tfn(tp[kind], torch.from_numpy(x), tcfg,
                       state={k: torch.from_numpy(v) for k, v in st.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=tol)
        for k in wst:
            np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]),
                                       atol=tol, rtol=tol)
    # no state: the zero state (sLSTM m at -1e30)
    want, _ = rx.slstm_forward(rp["slstm"], jnp.asarray(x), rcfg)
    got, _ = tx.slstm_forward(tp["slstm"], torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)
    for kind in ("mlstm", "slstm"):
        r = rx.init_xlstm_state(rcfg, B, kind)
        t = tx.init_xlstm_state(tcfg, B, kind, device="cpu")
        assert {k: (v.shape, str(v.dtype)) for k, v in r.items()} == \
            {k: (tuple(v.shape), "float32") for k, v in t.items()}
        for k in r:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(r[k]))
