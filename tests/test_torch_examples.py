"""The port's twins of the reference's examples (``examples/port_*.py``) on
the CPU: each runs in-process through ``main(argv)`` with ``--device
cpu`` and passes its own asserts; the design-space sweep's table and the
router's cost report equal the reference's over the same inputs; the
TCAM, forest and HDC predictions (and accuracies) equal the reference's
pieces on the same seeded inputs, built here; the served LM's greedy
tokens equal the reference ``Server``'s over the same weights; no twin
imports JAX or the reference package; and without ``--device`` each
asks for the GPU and refuses to run without one.

Sizes: every twin at the reference's defaults except these:
``port_hdc_mnist`` retrains beside one traffic client, not three (each
spins on the interpreter lock, and three slow the retraining here ten
times over on a loaded machine); ``port_serve_lm`` serves 3 requests of
4 new tokens; ``port_train_lm`` trains 14 steps of 2 x 32 tokens with a
failure injected at step 8 and a checkpoint every 4 (xlstm at its
reduced config, ``get_smoke_config``: the full 125M model takes about
2 s a step here).
"""

import dataclasses
import importlib.util
import itertools
import re
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.camsim import QUADRO_RTX_6000 as R_QUADRO
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.core import (PAPER_BASE_ARCH as R_PAPER_BASE_ARCH,
                        ArchSpec as RArchSpec, CamType as RCamType,
                        OptimizationTarget as ROptimizationTarget,
                        compile_fn as r_compile_fn, get_plan as r_get_plan)
from repro.data import hdc_mnist_dataset as r_hdc_mnist_dataset
from repro.forest import CamForestClassifier as RForest
from repro.forest import random_forest as r_random_forest
from repro.hdc import HdcClassifier as RHdcClassifier
from repro.launch import serve as rserve
from repro.models import model as rm
from repro_torch import convert
from repro_torch.configs import get_smoke_config

ROOT = Path(__file__).resolve().parents[1]
TWINS = ("dse_sweep", "forest_inference", "hdc_mnist", "moe_router_offload",
         "serve_lm", "tcam_wildcard", "train_lm", "quickstart", "knn_search",
         "serve_knn", "multitenant_serve")


def _twin(name, prefix="port_"):
    """``examples/<prefix><name>.py`` as a module (a fresh import)."""
    path = ROOT / "examples" / f"{prefix}{name}.py"
    spec = importlib.util.spec_from_file_location(f"{prefix}{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_reference_example_has_a_twin():
    ref = {p.stem for p in (ROOT / "examples").glob("*.py")
           if not p.stem.startswith("port_")}
    assert ref == set(TWINS)
    assert all((ROOT / "examples" / f"port_{n}.py").exists() for n in ref)


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_jax_nor_the_reference(name):
    src = (ROOT / "examples" / f"port_{name}.py").read_text()
    bad = re.findall(r"^\s*(?:from|import)\s+(repro\b(?!_torch)\S*|jax\S*)",
                     src, flags=re.M)
    assert not bad, bad


def test_dse_sweep_table_equals_reference():
    out = _twin("dse_sweep").main(["--device", "cpu"])
    want = []
    for size, cam, target in itertools.product(
            (16, 32, 64, 128), (RCamType.TCAM, RCamType.ACAM),
            ROptimizationTarget.ALL):
        arch = RArchSpec(rows=size, cols=size, cam_type=cam
                         ).with_target(target)
        prog = r_compile_fn(_twin("dse_sweep").hdc_kernel,
                            [(10_000, 8192), (10, 8192)], arch, cam_type=cam,
                            value_bits=1, unroll_limit=0)
        rep, plan = prog.cost_report(), prog.plans[0]
        want.append({"design": f"{cam}-{size}x{size}-{target}",
                     "latency_us": rep.latency_us, "energy_uj": rep.energy_uj,
                     "power_w": rep.power_w,
                     "subarrays": plan.physical_subarrays,
                     "banks": plan.banks_used})
    assert out["points"] == want
    assert len(out["front"]) >= 2


def test_moe_router_offload_cost_equals_reference():
    mod = _twin("moe_router_offload")
    out = mod.main(["--device", "cpu"])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4096, 2048)).astype(np.float32)
    w = rng.standard_normal((64, 2048)).astype(np.float32)
    want = r_compile_fn(mod.router_kernel, [x, w], R_PAPER_BASE_ARCH,
                        value_bits=8).cost_report()
    assert dataclasses.asdict(out["cost"]) == dataclasses.asdict(want)
    assert out["gpu"] == R_QUADRO.similarity_workload(4096, 64, 2048)


def test_forest_inference_runs():
    """The twin's predictions equal the reference classifier's, built from
    the same seeded forest and samples."""
    mod = _twin("forest_inference")
    out = mod.main(["--device", "cpu"])
    assert out["summary"]["trees"] == 64
    assert out["served"]["plan"]["backend"] == "cuda"
    rng = np.random.default_rng(0)
    trees = r_random_forest(rng, n_trees=mod.N_TREES, dim=mod.DIM,
                            depth=mod.DEPTH, n_classes=mod.N_CLASSES,
                            feature_frac=0.5)
    ref = RForest(trees, dim=mod.DIM).compile(
        RArchSpec(rows=64, cols=64, cam_type=RCamType.ACAM), batch_hint=128)
    x = rng.standard_normal((mod.N_QUERIES, mod.DIM)).astype(np.float32)
    np.testing.assert_array_equal(out["pred"], np.asarray(ref.predict(x)))


def test_hdc_mnist_runs(monkeypatch):
    """The twin's one-shot and retrained predictions and accuracies equal
    the reference classifier's over the same data and seed (retrained
    offline: the served retraining pushes the same rows)."""
    mod = _twin("hdc_mnist")
    monkeypatch.setattr(mod, "TRAFFIC_CLIENTS", 1)
    out = mod.main(["--device", "cpu"])
    assert out["rows_pushed"] > 0 and out["acc"] >= out["acc0"]
    assert out["served"]["plan"]["packed"]
    train_x, train_y, test_x, test_y = r_hdc_mnist_dataset()
    ref = RHdcClassifier(train_x.shape[1], mod.N_CLASSES, dim=mod.HV_DIM,
                         n_levels=mod.N_LEVELS, seed=0)
    ref.fit(train_x, train_y)
    ref.compile(RArchSpec(rows=8, cols=128), batch_hint=128)
    enc_tr, enc_te = ref.encode(train_x), ref.encode(test_x)
    pred0 = np.asarray(ref.predict(encoded=enc_te))
    np.testing.assert_array_equal(out["pred0"], pred0)
    assert out["acc0"] == float((pred0 == test_y).mean())
    pushed = sum(ref.retrain_epoch(train_x, train_y, encoded=enc_tr)[1]
                 for _ in range(mod.EPOCHS))
    pred = np.asarray(ref.predict(encoded=enc_te))
    np.testing.assert_array_equal(out["pred"], pred)
    assert out["acc"] == float((pred == test_y).mean())
    assert out["rows_pushed"] == pushed


def test_tcam_wildcard_runs_packed_and_ternary():
    """The twin's predictions and accuracy equal the reference example's
    ternary program, planned by the reference, on the same seeded
    gallery and queries."""
    out = _twin("tcam_wildcard").main(["--device", "cpu"])
    plan = out["served"]["plan"]
    assert plan["packed"] and plan["ternary"]
    ref = _twin("tcam_wildcard", prefix="")
    rng = np.random.default_rng(0)
    protos, patterns, care = ref.learn_ternary_rows(rng)
    rplan = r_get_plan(ref.ternary_program(64, ref.N_CLASSES, ref.DIM, 1,
                                           RArchSpec(rows=32, cols=64)))
    labels = rng.integers(0, ref.N_CLASSES, ref.N_QUERIES)
    flips = rng.random((ref.N_QUERIES, ref.DIM)) < ref.NOISE
    queries = np.abs(protos[labels] - flips.astype(np.float32))
    _, idx = rplan.execute(queries, patterns, care)
    pred = np.asarray(idx)[:, 0]
    np.testing.assert_array_equal(out["pred"], pred)
    assert out["accuracy"] == float((pred == labels).mean())


def test_serve_lm_runs(monkeypatch):
    """At temperature 0 over the reference's weights (the smoke config in
    float32 on both sides, so no bf16 near-tie decides a token), the
    twin's Server gives the reference Server's greedy tokens."""
    mod = _twin("serve_lm")
    arch, n_req, batch, prompt_len, max_new = "zamba2-2.7b", 3, 3, 12, 5
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    rcfg = dataclasses.replace(r_get_smoke_config(arch), **f32)
    tcfg = dataclasses.replace(get_smoke_config(arch), **f32)
    rparams = rm.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), tcfg, device="cpu")
    monkeypatch.setattr(mod, "get_smoke_config", lambda _: tcfg)
    monkeypatch.setattr(mod, "model", types.SimpleNamespace(
        init_params=lambda cfg, seed, device=None: tparams))
    out = mod.main(["--device", "cpu", "--arch", arch, "--requests",
                    str(n_req), "--batch", str(batch), "--prompt-len",
                    str(prompt_len), "--max-new", str(max_new),
                    "--temperature", "0"])
    srv = rserve.Server(rcfg, rparams, batch=batch,
                        max_len=prompt_len + max_new + 1, temperature=0.0)
    rng = np.random.default_rng(0)
    reqs = [rserve.Request(rid=r, prompt=rng.integers(1, rcfg.vocab,
                                                      prompt_len),
                           max_new=max_new) for r in range(n_req)]
    for r in reqs:
        srv.submit(r)
    want = srv.run()
    assert out["outputs"] == [r.out for r in reqs]
    assert all(len(o) == max_new for o in out["outputs"])
    for key in ("completed", "prefills", "decode_steps", "tokens"):
        assert out[key] == want[key], key


@pytest.mark.parametrize("moe", [False, True])
def test_train_lm_recovers_and_learns(moe, tmp_path, monkeypatch):
    mod = _twin("train_lm")
    monkeypatch.setattr(mod, "get_config", get_smoke_config)
    out = mod.main(["--device", "cpu", "--steps", "14", "--batch", "2",
                    "--seq", "32", "--fail-at", "8", "--ckpt-every", "4",
                    "--ckpt-dir", str(tmp_path)] + (["--moe"] if moe else []))
    assert out["restarts"] == 1
    assert out["loss_last10"] < out["loss_first10"]


@pytest.mark.parametrize("name", ["dse_sweep", "forest_inference",
                                  "hdc_mnist", "moe_router_offload",
                                  "serve_lm", "tcam_wildcard", "train_lm"])
def test_twin_needs_the_gpu_without_device(name):
    """No fallback: without ``--device`` a twin asks for the GPU, and on a
    machine without one it raises before it runs anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the twin would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _twin(name).main([])
