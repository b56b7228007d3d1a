"""The long-context path of the port against the reference, on the CPU:
the sub-quadratic families' ``long_500k`` way of serving a long prompt
(``launch/specs.py``'s 524,288-row decode shape), cut to a few hundred
tokens.

* zamba2 (hybrid: two groups of two Mamba2 blocks and the shared
  attention block) and xlstm (ssm: two mLSTM/sLSTM pairs), float32, over
  float32 caches: a ``prefill`` of a first piece longer than one 256-row
  chunk, then ``decode_step`` over two pieces of S > 1 tokens (the
  reference's own path: positions from the cache's length, the Mamba2
  and xLSTM blocks continuing from their carried states), then
  single-token steps.  The same numpy tokens go through both packages'
  same calls: logits and the final recurrent states within 1e-5 of the
  largest magnitude of each compared array (and 1e-5 relative): the
  recurrences carry float32 rounding (sums in other orders in the two
  frameworks) over hundreds of positions, and xlstm's logits of
  magnitude up to 5 differ by up to 4e-5 after 430 positions.
* The same pieces against one whole ``prefill`` in the port (another
  chunking: float32 sums in other orders), within the same bound.
* M1's plain version, ``ssd_scan.chunk_scan``, split at a chunk boundary
  with its state carried: bit-identical to one call.
* RoPE at positions 524,000 to 524,304 (past the long_500k prompt's
  end) against the reference's, within 1e-5.
* The routes of M1 and X1 (``ssd_route`` / ``slstm_route``): the plain
  versions on the CPU, on fake tensors and where autograd records.

Parameters are the reference's ``init_params`` carried across by
``convert.lm_params_from_reference``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models import layers as rl
from repro.models import model as rm
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import slstm_scan as ksl
from repro_torch.kernels import ssd_scan as kss
from repro_torch.models import layers as tl
from repro_torch.models import model as tm

TOL = 1e-5
B = 2
#: the first piece (prefill: more than one chunk), two decode_step pieces
#: of one length (one reference compile), then single-token steps
FIRST, PIECE, N_PIECES, N_STEPS = 300, 130, 2, 3
#: name -> (arch, overrides of the smoke config)
MODELS = {"zamba2": ("zamba2-2.7b", dict(n_layers=4, shared_attn_every=2)),
          "xlstm": ("xlstm-125m", dict(n_layers=4))}


def _f32(tree, is_torch):
    if is_torch:
        return tm._tree_map(lambda t: t.float() if t.is_floating_point()
                            else t, tree)
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _close(got, want, err_msg=""):
    """Within ``TOL`` of the largest |want| (and ``TOL`` relative)."""
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=err_msg)


@functools.lru_cache(maxsize=None)
def _lm(name):
    arch, kw = MODELS[name]
    kw = dict(kw, param_dtype="float32", compute_dtype="float32")
    rcfg = dataclasses.replace(r_get_smoke_config(arch), **kw)
    tcfg = dataclasses.replace(get_smoke_config(arch), **kw)
    rparams = rm.init_params(jax.random.PRNGKey(5), rcfg)
    tparams = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), tcfg, device="cpu")
    n = FIRST + N_PIECES * PIECE + N_STEPS
    toks = np.random.default_rng(17).integers(1, tcfg.vocab, (B, n))
    return dict(rcfg=rcfg, tcfg=tcfg, rparams=rparams, tparams=tparams,
                toks=toks, max_len=n + 1)


def _spans():
    spans = [(0, FIRST)]
    for _ in range(N_PIECES):
        spans.append((spans[-1][1], spans[-1][1] + PIECE))
    for _ in range(N_STEPS):
        spans.append((spans[-1][1], spans[-1][1] + 1))
    return spans


@functools.lru_cache(maxsize=None)
def _reference_run(name):
    lm = _lm(name)
    cfg, p, toks = lm["rcfg"], lm["rparams"], jnp.asarray(lm["toks"])
    prefill = jax.jit(lambda p, b, c: rm.prefill(p, cfg, b, c))
    decode = jax.jit(lambda p, t, c: rm.decode_step(p, cfg, t, c))
    cache = _f32(rm.init_decode_cache(cfg, B, lm["max_len"]), False)
    logits = []
    for a, b in _spans():
        if a == 0:
            lg, cache = prefill(p, {"tokens": toks[:, a:b]}, cache)
        else:
            lg, cache = decode(p, toks[:, a:b], cache)
        logits.append(np.asarray(lg, np.float32))
    return logits, jax.tree.map(np.asarray, cache)


def _port_run(name, spans):
    lm = _lm(name)
    cfg, p = lm["tcfg"], lm["tparams"]
    toks = torch.from_numpy(lm["toks"])
    cache = _f32(tm.init_decode_cache(cfg, B, lm["max_len"], device="cpu"),
                 True)
    logits = []
    for a, b in spans:
        if a == 0:
            lg, cache = tm.prefill(p, cfg, {"tokens": toks[:, a:b]}, cache)
        else:
            lg, cache = tm.decode_step(p, cfg, toks[:, a:b], cache)
        logits.append(lg.numpy())
    return logits, cache


def _states(cache, name):
    """The recurrent states of a cache (either package's), as numpy."""
    parts = {"zamba2": [("mamba", "ssm"), ("mamba", "conv")],
             "xlstm": [(kind, key) for kind, keys in
                       (("mlstm", "Cnm"), ("slstm", "hcnm")) for key in keys]}
    return {f"{a}.{b}": np.asarray(cache[a][b], np.float32)
            for a, b in parts[name]}


@pytest.mark.parametrize("name", list(MODELS))
def test_pieces_then_steps_match_the_reference(name):
    """prefill, decode_step over pieces of S > 1, then single steps: every
    call's logits and the final recurrent states within ``_close`` of the
    reference's same calls (float32 on both sides)."""
    want_lg, want_cache = _reference_run(name)
    got_lg, got_cache = _port_run(name, _spans())
    for got, want in zip(got_lg, want_lg):
        assert got.shape == want.shape
        _close(got, want)
    want_st, got_st = _states(want_cache, name), _states(got_cache, name)
    for key, want in want_st.items():
        _close(got_st[key], want, key)
    if name == "zamba2":
        assert int(tm._cache_len(got_cache, _lm(name)["tcfg"])) == \
            int(want_cache["attn"]["len"]) == _spans()[-1][1]


@pytest.mark.parametrize("name", list(MODELS))
def test_pieces_match_one_prefill(name):
    """The same tokens prefilled in pieces (prefill, then decode_step over
    S > 1) and in one ``prefill`` call: the last position's logits and
    the recurrent states within ``_close`` (chunks fall elsewhere: float32
    sums in other orders)."""
    spans = _spans()[:1 + N_PIECES]
    end = spans[-1][1]
    pieces_lg, pieces_cache = _port_run(name, spans)
    whole_lg, whole_cache = _port_run(name, [(0, end)])
    _close(pieces_lg[-1][:, -1:], whole_lg[0])
    got, want = _states(pieces_cache, name), _states(whole_cache, name)
    for key in want:
        _close(got[key], want[key], key)


def test_chunk_scan_split_at_a_chunk_boundary_is_bit_identical():
    """``chunk_scan`` over two chunks equals, bit for bit, the first chunk
    and then the second from the state the first carried."""
    rng = np.random.default_rng(3)
    b, s, nh, dh, ds, chunk = 2, 64, 3, 8, 4, 32

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    xh, B_, C_, h0 = t(b, s, nh, dh), t(b, s, ds), t(b, s, ds), \
        t(b, nh, dh, ds)
    dt = torch.nn.functional.softplus(t(b, s, nh))
    A = -torch.exp(t(nh))
    y, h = kss.chunk_scan(xh, B_, C_, dt, A, h0, chunk)
    y1, h1 = kss.chunk_scan(xh[:, :chunk], B_[:, :chunk], C_[:, :chunk],
                            dt[:, :chunk], A, h0, chunk)
    y2, h2 = kss.chunk_scan(xh[:, chunk:], B_[:, chunk:], C_[:, chunk:],
                            dt[:, chunk:], A, h1, chunk)
    assert torch.equal(y, torch.cat([y1, y2], dim=1))
    assert torch.equal(h, h2)


def test_rope_at_long_500k_positions_matches_the_reference():
    """RoPE over positions 524,000 .. 524,304 (angles of 5e5 radians) at
    zamba2's head dim 80 and the reference's theta: within 1e-5."""
    rcfg = r_get_smoke_config("zamba2-2.7b")
    tcfg = get_smoke_config("zamba2-2.7b")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 305, 2, 80)).astype(np.float32)
    pos = np.arange(524_000, 524_305, dtype=np.int32)[None]
    want = np.asarray(rl.apply_rope(jnp.asarray(x), jnp.asarray(pos), rcfg))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_scan_routes_take_the_plain_versions_off_the_card():
    """``ssd_route`` and ``slstm_route`` give ``"plain"`` for CPU tensors,
    for fake tensors (the dry run) and for operands that autograd
    records; the wrappers then return the plain versions' results and
    count no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import cam_search as tcs
    x = torch.zeros((1, 4, 2, 8))
    assert kss.ssd_route(x) == "plain" and ksl.slstm_route(x) == "plain"
    w = torch.zeros((8, 8), requires_grad=True)
    assert kss.ssd_route(x, w) == "plain"
    with FakeTensorMode():
        fake = torch.empty((1, 4, 2, 8))
        assert kss.ssd_route(fake) == "plain"
        assert ksl.slstm_route(fake) == "plain"
    rng = np.random.default_rng(4)
    pre = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(
        np.float32))
    wh = torch.from_numpy(rng.standard_normal((8, 32)).astype(
        np.float32)).requires_grad_()
    st = [torch.zeros((2, 8)) for _ in range(3)] + \
        [torch.full((2, 8), -1e30)]
    tcs.reset_launch_counts()
    hs, fin = ksl.slstm_scan(pre, wh, *st)
    want_hs, want_fin = ksl.slstm_scan_reference(pre, wh, *st)
    hs.sum().backward()
    assert wh.grad is not None and torch.equal(hs, want_hs)
    assert all(torch.equal(a, b) for a, b in zip(fin, want_fin))
    assert tcs.LAUNCHES["slstm_scan"] == tcs.LAUNCHES["ssd_scan"] == 0


def test_slstm_plain_snapshot_is_the_carried_state():
    """X1's plain version with ``snapshot_at``: the loop from the state it
    returns, over the rest of the positions, is bit-identical to the whole
    loop's tail and final state; a position outside 1..S raises."""
    rng = np.random.default_rng(6)
    pre = torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(
        np.float32))
    wh = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    st = [torch.zeros((2, 4)) for _ in range(3)] + \
        [torch.full((2, 4), -1e30)]
    hs, fin, mid = ksl.slstm_scan_reference(pre, wh, *st, snapshot_at=5)
    tail_hs, tail_fin = ksl.slstm_scan_reference(pre[:, 5:], wh, *mid)
    assert torch.equal(tail_hs, hs[:, 5:])
    assert all(torch.equal(a, b) for a, b in zip(tail_fin, fin))
    with pytest.raises(ValueError, match="snapshot_at"):
        ksl.slstm_scan(pre, wh, *st, snapshot_at=10)
