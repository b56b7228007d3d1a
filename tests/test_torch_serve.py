"""Port serving loop (``launch/serve.py``) vs the reference's, on the CPU:
the same parameters (carried across by ``convert.lm_params_from_reference``)
and the same requests give the same greedy token streams and the same
``stats`` counts.  Float32 smoke config (qwen2.5-14b reduced: 2 layers,
4 heads over 1 kv head, head dim 16, vocab 256), where the two sides'
logits differ by about 2e-6: no near-tie falls inside that here, so the
streams are compared token for token.
"""

import collections
import contextlib
import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_get_smoke_config
from repro.launch import serve as rserve
from repro.models import model as rm
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm

N_REQ, BATCH, PROMPT, MAX_NEW = 5, 2, 12, 6


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _requests(mod, vocab):
    rng = np.random.default_rng(4)
    return [mod.Request(rid=r, prompt=rng.integers(1, vocab, PROMPT),
                        max_new=MAX_NEW) for r in range(N_REQ)]


def _serve(mod, cfg, params, drain=True, **kw):
    srv = mod.Server(cfg, params, batch=BATCH, max_len=PROMPT + MAX_NEW + 1,
                     **kw)
    reqs = _requests(mod, cfg.vocab)
    for r in reqs:
        srv.submit(r)
    out = srv.run(drain=drain)
    return [r.out for r in reqs], out


def test_greedy_streams_and_stats_match_reference():
    rcfg = _f32(r_get_smoke_config("qwen2.5-14b"))
    tcfg = _f32(get_smoke_config("qwen2.5-14b"))
    rparams = rm.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), tcfg, device="cpu")
    want, rstats = _serve(rserve, rcfg, rparams)
    got, tstats = _serve(tserve, tcfg, tparams, device="cpu")
    assert got == want
    assert all(len(o) == MAX_NEW for o in got)
    for key in ("completed", "prefills", "decode_steps", "tokens"):
        assert tstats[key] == rstats[key], key
    assert tstats["completed"] == N_REQ
    assert tstats["decode_steps"] == N_REQ * (MAX_NEW - 1)


def test_temperature_sampling_is_reproducible_under_a_seed():
    cfg = get_smoke_config("qwen2.5-14b")
    params = tm.init_params(cfg, seed=2, device="cpu")
    a, _ = _serve(tserve, cfg, params, temperature=0.8, seed=5,
                  device="cpu")
    b, _ = _serve(tserve, cfg, params, temperature=0.8, seed=5,
                  device="cpu")
    c, _ = _serve(tserve, cfg, params, temperature=0.8, seed=6,
                  device="cpu")
    assert a == b and a != c
    assert all(0 <= t < cfg.vocab for o in a for t in o)


def test_main_runs_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tserve.main(["--arch", "qwen2.5-14b", "--smoke", "--device",
                          "cpu", "--requests", "3", "--max-new", "4"])
    out = json.loads(buf.getvalue())
    assert rc == 0
    assert out["completed"] == 3 and out["tokens"] == 3 * 3
    assert out["prefills"] == 3


def test_server_defaults_to_the_gpu():
    cfg = get_smoke_config("qwen2.5-14b")
    if torch.cuda.is_available():
        assert tserve.Server(cfg, {}, batch=1, max_len=8).device.type == \
            "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.Server(cfg, {}, batch=1, max_len=8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tm.init_params(cfg)


def test_run_without_drain_matches_reference():
    """``run(drain=False)`` returns after the first step that finds the
    queue empty, as the reference's does: the same tokens so far and the
    same counts."""
    rcfg = _f32(r_get_smoke_config("qwen2.5-14b"))
    tcfg = _f32(get_smoke_config("qwen2.5-14b"))
    rparams = rm.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), tcfg, device="cpu")
    want, rstats = _serve(rserve, rcfg, rparams, drain=False)
    got, tstats = _serve(tserve, tcfg, tparams, drain=False, device="cpu")
    assert got == want
    for key in ("completed", "prefills", "decode_steps", "tokens"):
        assert tstats[key] == rstats[key], key
    assert tstats["prefills"] == N_REQ and tstats["completed"] < N_REQ


# ---------------------------------------------------------------------------
# slot caches reused across requests, and the Server's refusal
# ---------------------------------------------------------------------------

FAMILIES = ["qwen2.5-14b", "deepseek-moe-16b", "whisper-medium",
            "xlstm-125m", "zamba2-2.7b", "paligemma-3b"]


def _fresh_stream(cfg, params, prompt, max_new, max_len):
    """One request's greedy tokens through the step functions, from a
    fresh cache (what the Server did before its caches were reused)."""
    from repro_torch.models import steps
    batch = {"tokens": torch.from_numpy(np.asarray(prompt, np.int64))[None]}
    if cfg.family == "vlm":
        batch["vision"] = torch.zeros((1, cfg.n_vision_tokens, cfg.d_model),
                                      dtype=torch.bfloat16)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((1, cfg.encoder_seq, cfg.d_model),
                                      dtype=torch.bfloat16)
    cache = tm.init_decode_cache(cfg, 1, max_len, device="cpu")
    logits, cache = steps.make_prefill_step(cfg)(params, batch, cache)
    out = [int(torch.argmax(logits[0, -1]))]
    decode = steps.make_decode_step(cfg)
    while len(out) < max_new:
        logits, cache = decode(params, torch.tensor([[out[-1]]]), cache)
        out.append(int(torch.argmax(logits[0, -1])))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_reused_slot_caches_give_the_tokens_of_fresh_caches(arch):
    """The Server allocates each slot's cache once and resets it for the
    next request (``model.reset_decode_cache``: ``len`` 0 on the device,
    recurrent states re-initialised, old rows left unread).  Seven
    requests of three prompt lengths over two slots: each request's
    greedy tokens equal those of a fresh cache (float32 smoke config)."""
    cfg = _f32(get_smoke_config(arch))
    params = tm.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(9)
    lens, max_new, max_len = (12, 5, 9), 6, 19
    srv = tserve.Server(cfg, params, batch=2, max_len=max_len, device="cpu")
    reqs = [tserve.Request(rid=r, prompt=rng.integers(1, cfg.vocab,
                                                      lens[r % 3]),
                           max_new=max_new) for r in range(7)]
    for r in reqs:
        srv.submit(r)
    stats = srv.run()
    assert stats["completed"] == 7 and stats["prefills"] == 7
    for r in reqs:
        assert r.out == _fresh_stream(cfg, params, r.prompt, max_new,
                                      max_len), r.rid
    # the slots' caches are the two allocated first, their len on the
    # device (ssm keeps no length)
    assert sum(c is not None for c in srv._caches) == 2
    if cfg.family != "ssm":
        holder = tm._len_holder(srv._caches[0], cfg)
        assert holder["len"].dtype == torch.int32 and holder["len"].dim() == 0


@pytest.mark.parametrize("case", ["prompt", "decode"])
def test_server_refuses_past_max_len_before_writing(case):
    """A prompt longer than ``max_len``, or a decode step past it, raises
    the attention's ``ValueError`` from the Server's host count of the
    slot's rows, before the step runs: no cache row and no length moves
    (on the card the check comes before the graph's replay)."""
    cfg = _f32(get_smoke_config("qwen2.5-14b"))
    params = tm.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    srv = tserve.Server(cfg, params, batch=1, max_len=8, device="cpu")
    if case == "prompt":
        srv.submit(tserve.Request(rid=0, prompt=rng.integers(1, 200, 9),
                                  max_new=2))
        before = {k: t.clone() for k, t in srv._staging.items()}
        with pytest.raises(ValueError, match="len=0 rows and S=9 .* "
                                             "max_len=8"):
            srv.run()
        for k, t in srv._staging.items():
            assert torch.equal(t, before[k]), k
        return
    srv.submit(tserve.Request(rid=0, prompt=rng.integers(1, 200, 6),
                              max_new=5))
    real = srv._decode_slot
    kept = {}

    def decode(i, token):
        if srv._lens[i] == 8:
            kept.update({k: t.clone() for k, t in srv._caches[i].items()})
        return real(i, token)
    srv._decode_slot = decode
    with pytest.raises(ValueError, match="len=8 rows and S=1 .* max_len=8"):
        srv.run()
    assert kept and int(srv._caches[0]["len"]) == 8
    for k, t in srv._caches[0].items():
        assert torch.equal(t, kept[k]), k


def test_decode_step_reads_its_length_from_the_device():
    """``init_decode_cache`` keeps ``len`` as a 0-dim int32 tensor (the
    reference's traced ``len``); prefill and decode return it advanced on
    the device, and the rows a step writes follow it."""
    cfg = _f32(get_smoke_config("qwen2.5-14b"))
    params = tm.init_params(cfg, seed=0, device="cpu")
    cache = tm.init_decode_cache(cfg, 2, 10, device="cpu")
    assert cache["len"].dtype == torch.int32 and cache["len"].dim() == 0
    toks = torch.from_numpy(np.random.default_rng(1).integers(1, 200,
                                                              (2, 6)))
    _, cache = tm.prefill(params, cfg, {"tokens": toks[:, :5]}, cache)
    assert isinstance(cache["len"], torch.Tensor) and int(cache["len"]) == 5
    assert bool((cache["k"][:, :, 5:] == 0).all())
    _, cache = tm.decode_step(params, cfg, toks[:, 5:], cache)
    assert int(cache["len"]) == 6
    assert bool((cache["k"][:, :, 5] != 0).any())
    assert bool((cache["k"][:, :, 6:] == 0).all())


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-moe-16b",
                                  "zamba2-2.7b", "whisper-medium"])
def test_a_decode_step_makes_its_write_rows_once(arch):
    """With a device ``len`` a decode step makes its write rows (``len +
    arange(S)``) and its new length (``len + S``) once, not once a layer:
    at twice the depth the step runs as many operations on the length
    (a 0-dim int32 operand; on the card each is a kernel of every
    replay).  B7 is stubbed: its plain version's masks read the length
    on the CPU, where the kernel reads it inside its own launch."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels import flash_attention as tfa

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(isinstance(a, torch.Tensor) and a.dim() == 0 and
                   a.dtype == torch.int32
                   for a in list(args) + list((kwargs or {}).values())):
                self.ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    def count(n_layers):
        cfg = dataclasses.replace(_f32(get_smoke_config(arch)),
                                  n_layers=n_layers)
        params = tm.init_params(cfg, seed=0, device="cpu")
        batch = {"tokens": torch.arange(1, 6)[None]}
        if cfg.family == "audio":
            batch["frames"] = torch.zeros((1, cfg.encoder_seq, cfg.d_model))
        cache = tm.init_decode_cache(cfg, 1, 12, device="cpu")
        _, cache = tm.prefill(params, cfg, batch, cache)
        real = tfa.flash_attention
        tfa.flash_attention = lambda q, *a, **kw: torch.zeros_like(q)
        try:
            with Count() as c:
                _, cache = tm.decode_step(params, cfg, torch.tensor([[7]]),
                                          cache)
        finally:
            tfa.flash_attention = real
        assert int(tm._cache_len(cache, cfg)) == 6
        return c.ops

    assert count(4) == count(2)
    assert sum(count(2).values()) <= 6


def test_server_holds_at_most_prefill_graphs_steps(monkeypatch):
    """The Server holds one prefill step a prompt length (a captured
    graph on the card) up to ``PREFILL_GRAPHS``, evicting the least
    recently used; a length seen again after its eviction is made anew,
    and every request keeps the tokens of a fresh cache."""
    monkeypatch.setattr(tserve, "PREFILL_GRAPHS", 2)
    cfg = _f32(get_smoke_config("qwen2.5-14b"))
    params = tm.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    lens, max_new, max_len = (9, 4, 6, 9, 4), 3, 14
    srv = tserve.Server(cfg, params, batch=1, max_len=max_len, device="cpu")
    reqs = [tserve.Request(rid=r, prompt=rng.integers(1, cfg.vocab, n),
                           max_new=max_new) for r, n in enumerate(lens)]
    for r in reqs:
        srv.submit(r)
    assert srv.run()["completed"] == len(lens)
    assert list(srv._prefill_steps) == [9, 4]
    for r in reqs:
        assert r.out == _fresh_stream(cfg, params, r.prompt, max_new,
                                      max_len), r.rid
    # on the CPU nothing is captured
    assert srv.graph_stats()["prefill_graphs"] == 0
    assert srv.pool_bytes() is None
