"""Port serving loop (``launch/serve.py``) vs the reference's, on the CPU:
the same parameters (carried across by ``convert.lm_params_from_reference``)
and the same requests give the same greedy token streams and the same
``stats`` counts.  Float32 smoke config (qwen2.5-14b reduced: 2 layers,
4 heads over 1 kv head, head dim 16, vocab 256), where the two sides'
logits differ by about 2e-6: no near-tie falls inside that here, so the
streams are compared token for token.
"""

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
