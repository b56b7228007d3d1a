"""Port training loop and its substrates on the CPU: data loader,
checkpoint, compression, straggler monitor and supervisor (twins of
``tests/test_substrates.py``), the training loop (twins of the training
tests of ``tests/test_integration.py``), and the ``launch.train`` CLI.

Data is the reference's own (``TokenStream`` batches are equal array for
array), and the loop's loss is compared with the reference's loop where
both start from the same state: within ``LOOP_LOSS_ATOL`` (1e-4 after
four float32 steps of the xlstm smoke config, whose per-step parity is
1e-5; ``tests/test_torch_train.py``).  Bit-exact claims (resume, restore)
compare the port with itself.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.data import TokenStream as RTokenStream
from repro.distributed import ErrorFeedbackInt8 as RInt8
from repro.launch.train import TrainLoop as RTrainLoop
from repro_torch import convert
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_pytree, save_pytree)
from repro_torch.configs import get_smoke_config
from repro_torch.data import ShardedLoader, TokenStream
from repro_torch.distributed import (ErrorFeedbackInt8, ErrorFeedbackTopK,
                                     RecoveryConfig, SimulatedFailure,
                                     StragglerMonitor, Supervisor)
from repro_torch.launch import train as ttrain
from repro_torch.launch.train import TrainLoop
from repro_torch.tree import leaves, leaves_with_paths

LOOP_LOSS_ATOL = 1e-4

# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_tokenstream_deterministic_and_resumable():
    a = TokenStream(vocab=1000, seq_len=64, global_batch=4, seed=7)
    b = TokenStream(vocab=1000, seq_len=64, global_batch=4, seed=7)
    np.testing.assert_array_equal(a.batch(5)["tokens"], b.batch(5)["tokens"])
    np.testing.assert_array_equal(
        a.batch(5)["tokens"],
        RTokenStream(vocab=1000, seq_len=64, global_batch=4,
                     seed=7).batch(5)["tokens"])
    ld = ShardedLoader(a)
    ld.next(), ld.next()
    st_ = ld.state_dict()
    x3 = ld.next()["tokens"]
    ld2 = ShardedLoader(b)
    ld2.load_state_dict(st_)
    np.testing.assert_array_equal(ld2.next()["tokens"], x3)


def test_loader_places_batches_on_its_device():
    ld = ShardedLoader(TokenStream(vocab=50, seq_len=8, global_batch=2,
                                   seed=1), device=torch.device("cpu"))
    out = ld.batch(3)
    assert out["tokens"].dtype == torch.int64
    assert out["mask"].dtype == torch.float32
    assert ld.step == 0
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  ld.source.batch(3)["tokens"])


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "nest": {"b": torch.arange(6, dtype=torch.int32),
                     "h": torch.randn((3,), generator=g).bfloat16()},
            "t": (torch.ones(3), torch.zeros(2))}


def _zeros_like(tree):
    from repro_torch.tree import tree_map
    return tree_map(torch.zeros_like, tree)


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save_pytree(tree, str(tmp_path), 7)
    assert latest_step(str(tmp_path)) == 7
    out = restore_pytree(_zeros_like(tree), str(tmp_path))
    assert isinstance(out["t"], tuple)
    for (pa, x), (pb, y) in zip(leaves_with_paths(tree),
                                leaves_with_paths(out)):
        assert pa == pb and x.dtype == y.dtype
        assert torch.equal(x, y)


def test_checkpoint_bf16_stored_as_raw_bits(tmp_path):
    """numpy has no bfloat16: the leaf's 16 bits go in as uint16 and the
    manifest names the dtype."""
    import json
    h = torch.tensor([1.0, -2.5, 3.140625], dtype=torch.bfloat16)
    d = save_pytree({"h": h}, str(tmp_path), 1)
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["arrays"]["h"]["dtype"] == "bfloat16"
    with np.load(os.path.join(d, "host_0.npz")) as z:
        assert z["h"].dtype == np.uint16
    out = restore_pytree({"h": torch.zeros(3, dtype=torch.bfloat16)},
                         str(tmp_path))
    assert torch.equal(out["h"], h)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_pytree({"a": torch.ones(4)}, str(tmp_path), 1)
    with pytest.raises(ValueError):
        restore_pytree({"a": torch.ones(5)}, str(tmp_path))


def test_checkpoint_atomicity_partial_write_invisible(tmp_path):
    save_pytree(_tree(), str(tmp_path), 3)
    os.makedirs(tmp_path / "step_000000009.tmp.0")   # a crashed writer
    assert latest_step(str(tmp_path)) == 3


def test_async_checkpointer_gc_and_snapshot(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        tree = _tree(s)
        ck.save(tree, s)
        tree["a"].add_(100.0)    # an in-place update after the snapshot
    ck.wait()
    steps_left = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps_left == [3, 4]
    out = restore_pytree(_zeros_like(_tree()), str(tmp_path), 4)
    assert torch.equal(out["a"], _tree(4)["a"])


def test_async_checkpointer_keep_one_deletes_before_writing(tmp_path,
                                                            monkeypatch):
    """``keep=1``: each write starts on a disk holding no other step
    directory, one checkpoint is left, and ``log`` has every save."""
    from repro_torch.checkpoint import checkpointer
    seen = []

    def save(tree, ckpt_dir, step, extra=None):
        seen.append(sorted(os.listdir(ckpt_dir)))
        return save_pytree(tree, ckpt_dir, step, extra)

    monkeypatch.setattr(checkpointer, "save_pytree", save)
    ck = AsyncCheckpointer(str(tmp_path), keep=1)
    for s in (1, 2, 3):
        ck.save(_tree(s), s)
    ck.wait()
    assert seen == [[], [], []]
    assert os.listdir(tmp_path) == ["step_000000003"]
    assert [e["step"] for e in ck.log] == [1, 2, 3]
    out = restore_pytree(_zeros_like(_tree()), str(tmp_path))
    assert torch.equal(out["a"], _tree(3)["a"])


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comp", [ErrorFeedbackInt8(),
                                  ErrorFeedbackTopK(density=0.25)])
def test_error_feedback_is_unbiased_over_time(comp):
    params = {"w": torch.zeros(64)}
    state = comp.init(params)
    g_true = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        64).astype(np.float32))}
    total = torch.zeros(64)
    for _ in range(50):
        c, state = comp(g_true, state)
        total = total + c["w"]
    np.testing.assert_allclose(total.numpy() / 50, g_true["w"].numpy(),
                               atol=0.1)


def test_topk_compression_sparsity():
    comp = ErrorFeedbackTopK(density=0.1)
    state = comp.init({"w": torch.zeros(100)})
    g = {"w": torch.from_numpy(np.random.default_rng(1).standard_normal(
        100).astype(np.float32))}
    c, _ = comp(g, state)
    assert int((c["w"] != 0).sum()) <= 10


def test_int8_compression_matches_reference(rng):
    g = rng.standard_normal((5, 7)).astype(np.float32)
    e = (0.01 * rng.standard_normal((5, 7))).astype(np.float32)
    rc, rstate = RInt8()({"w": g}, RInt8().init({"w": g})._replace(
        error={"w": e}))
    comp = ErrorFeedbackInt8()
    tc, tstate = comp({"w": torch.from_numpy(g)},
                      comp.init({"w": torch.zeros(5, 7)})._replace(
                          error={"w": torch.from_numpy(e)}))
    np.testing.assert_allclose(tc["w"].numpy(), np.asarray(rc["w"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tstate.error["w"].numpy(),
                               np.asarray(rstate.error["w"]), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# straggler monitor
# ---------------------------------------------------------------------------


def test_straggler_detection_flags_outlier():
    mon = StragglerMonitor(window=16, z_threshold=4.0)
    for _ in range(16):
        mon.record(0.100 + np.random.default_rng(0).normal(0, 0.001))
    assert mon.record(0.5) is True
    assert mon.record(0.101) is False


def test_straggler_rebalance_suggestion():
    mon = StragglerMonitor(window=16)
    for _ in range(16):
        mon.record(0.1)
    for _ in range(8):
        mon.record(0.3)
    assert mon.suggest_rebalance() < 1.0


# ---------------------------------------------------------------------------
# recovery supervisor
# ---------------------------------------------------------------------------


def test_supervisor_recovers_from_injected_failure(tmp_path):
    sup = Supervisor(RecoveryConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                                    max_restarts=2))
    calls = {"fails": 0}

    def step_fn(state, step):
        if step == 5 and calls["fails"] == 0:
            calls["fails"] += 1
            raise SimulatedFailure("boom")
        return {"x": state["x"] + 1}, {"loss": 1.0 / (step + 1)}

    final, _ = sup.run({"x": torch.zeros(())}, 8, step_fn)
    assert sup.restarts == 1
    assert float(final["x"]) == 8
    assert any("restored_to" in e for e in sup.log)


def test_supervisor_nan_loss_triggers_restore(tmp_path):
    sup = Supervisor(RecoveryConfig(ckpt_dir=str(tmp_path), ckpt_every=1,
                                    max_restarts=3))
    hit = {"n": 0}

    def step_fn(state, step):
        loss = float("nan") if step == 3 and hit["n"] == 0 else 0.5
        if step == 3 and hit["n"] == 0:
            hit["n"] = 1
        return {"x": state["x"] + 1}, {"loss": loss}

    final, _ = sup.run({"x": torch.zeros(())}, 5, step_fn)
    assert sup.restarts == 1
    assert float(final["x"]) == 5


def test_supervisor_retry_budget_exhausts(tmp_path):
    sup = Supervisor(RecoveryConfig(ckpt_dir=str(tmp_path), ckpt_every=1,
                                    max_restarts=1))

    def step_fn(state, step):
        if step == 2:
            raise SimulatedFailure("always")
        return state, {"loss": 1.0}

    with pytest.raises(RuntimeError, match="retry budget"):
        sup.run({"x": torch.zeros(())}, 5, step_fn)


# ---------------------------------------------------------------------------
# the training loop (twins of tests/test_integration.py)
# ---------------------------------------------------------------------------


def _loop(arch, tmp, **kw):
    return TrainLoop(get_smoke_config(arch), ckpt_dir=str(tmp),
                     device="cpu", **kw)


def test_training_loss_decreases(tmp_path):
    loop = _loop("xlstm-125m", tmp_path, batch=8, seq=64, steps=30, lr=3e-3)
    loop.run()
    first = np.mean([h["loss"] for h in loop.history[:5]])
    last = np.mean([h["loss"] for h in loop.history[-5:]])
    assert last < first - 0.2, f"loss {first:.3f} -> {last:.3f}"


def test_loop_loss_tracks_reference_loop(tmp_path):
    """Four steps of both packages' loops from the same state (the
    reference's init carried across) on the same stream: the same
    losses."""
    kw = dict(param_dtype="float32", compute_dtype="float32")
    rcfg = dataclasses.replace(r_smoke("xlstm-125m"), **kw)
    tcfg = dataclasses.replace(get_smoke_config("xlstm-125m"), **kw)
    ref = RTrainLoop(rcfg, batch=4, seq=32, steps=4, lr=3e-3, warmup=2,
                     ckpt_dir=str(tmp_path / "r"))
    loop = TrainLoop(tcfg, batch=4, seq=32, steps=4, lr=3e-3, warmup=2,
                     ckpt_dir=str(tmp_path / "t"), device="cpu")
    loop.state = convert.train_state_from_reference(
        jax.tree.map(np.asarray, ref.state), tcfg, device="cpu")
    ref.run()
    loop.run()
    for a, b in zip(ref.history, loop.history):
        assert abs(a["loss"] - b["loss"]) <= LOOP_LOSS_ATOL
        assert a["lr"] == pytest.approx(b["lr"], rel=4.8e-7, abs=0)


def test_failure_injection_recovers_and_resumes(tmp_path):
    loop = _loop("chatglm3-6b", tmp_path, batch=4, seq=32, steps=12,
                 ckpt_every=4, fail_at=6)
    out = loop.run()
    assert out["restarts"] == 1
    assert np.isfinite(out["final"]["loss"])
    assert len(loop.history) == 12 + 2       # steps 5 and 6 replayed


def _params_equal(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)


def test_resume_bit_exact(tmp_path):
    """Training N steps straight == training k, restoring, training
    N - k."""
    a = _loop("qwen2.5-14b", tmp_path / "a", batch=4, seq=32, steps=8,
              ckpt_every=4, seed=3)
    a.run()
    b = _loop("qwen2.5-14b", tmp_path / "b", batch=4, seq=32, steps=4,
              ckpt_every=4, seed=3)
    b.run()
    c = _loop("qwen2.5-14b", tmp_path / "b", batch=4, seq=32, steps=8,
              ckpt_every=4, seed=3)
    state, step = c.supervisor.restore(c.state)
    c.state = state
    c.loader.step = step
    c.run()
    _params_equal(a.state.params, c.state.params)
    assert int(c.state.step) == 8 and int(c.state.opt.count) == 8


def test_elastic_restore_into_new_state(tmp_path):
    """A checkpoint restores into a freshly built state (another seed):
    every leaf equal."""
    loop = _loop("xlstm-125m", tmp_path, batch=4, seq=32, steps=4,
                 ckpt_every=2, seed=9)
    loop.run()
    fresh = _loop("xlstm-125m", tmp_path, batch=4, seq=32, steps=4,
                  ckpt_every=2, seed=99)
    state, step = fresh.supervisor.restore(fresh.state)
    assert step == 4
    _params_equal(loop.state.params, state.params)
    assert all(p.requires_grad for p in leaves(state.params))


def test_gradient_compression_trains(tmp_path):
    loop = _loop("xlstm-125m", tmp_path, batch=8, seq=64, steps=20, lr=3e-3,
                 compression="int8")
    loop.run()
    first = np.mean([h["loss"] for h in loop.history[:5]])
    last = np.mean([h["loss"] for h in loop.history[-5:]])
    assert last < first - 0.1


def test_moe_cam_offload_end_to_end(tmp_path):
    """deepseek-style MoE with the router's top-k through the CAM search
    (on the CPU its plain version) inside training."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              router_offload="cam")
    loop = TrainLoop(cfg, batch=4, seq=32, steps=6, ckpt_dir=str(tmp_path),
                     device="cpu")
    out = loop.run()
    assert np.isfinite(out["final"]["loss"])


def test_multi_device_mesh_raises(tmp_path):
    """A mesh of more than one device that is no DeviceMesh (here a bare
    count, which names no process group) is refused; sharded training
    over a DeviceMesh is tests/test_torch_sharded_lm.py's."""
    with pytest.raises(ValueError, match="must be a DeviceMesh"):
        TrainLoop(get_smoke_config("xlstm-125m"), batch=2, seq=8, steps=1,
                  ckpt_dir=str(tmp_path), device="cpu", mesh=2)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    rc = ttrain.main(["--device", "cpu", "--smoke", "--arch", "xlstm-125m",
                      "--steps", "5", "--batch", "2", "--seq", "16",
                      "--ckpt-dir", str(tmp_path), "--ckpt-every", "5"])
    assert rc == 0
    assert latest_step(str(tmp_path)) == 5
    assert '"restarts": 0' in capsys.readouterr().out


def test_cli_needs_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would train")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--smoke", "--arch", "xlstm-125m", "--steps", "1",
                     "--ckpt-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# both loops at qwen2.5-14b's width (a script, not a test)
# ---------------------------------------------------------------------------

#: qwen2.5-14b's widths (d_model 5120, 40 / 8 heads, d_ff 13824) cut to one
#: layer and a 8,192-token vocab so that both packages train it on a CPU,
#: at the card's schedule (``chip_smoke.py`` ``lm_train``: lr 3e-4, 2
#: warmup steps, 12 steps), in float32 from one state
WIDE = dict(n_layers=1, vocab=8192, param_dtype="float32",
            compute_dtype="float32")
WIDE_LOOP = dict(batch=2, seq=512, steps=12, lr=3e-4, warmup=2, seed=0)


def wide_loss_curves(tmp: str, cfg_kw=None, loop_kw=None) -> dict:
    """Both packages' ``TrainLoop`` losses, step by step, from the
    reference's initial state carried across."""
    from repro.configs import get_config as r_config
    from repro_torch.configs import get_config
    cfg_kw = {**WIDE, **(cfg_kw or {})}
    loop_kw = {**WIDE_LOOP, **(loop_kw or {})}
    ref = RTrainLoop(dataclasses.replace(r_config("qwen2.5-14b"), **cfg_kw),
                     ckpt_dir=os.path.join(tmp, "r"), ckpt_every=10 ** 6,
                     **loop_kw)
    tcfg = dataclasses.replace(get_config("qwen2.5-14b"), **cfg_kw)
    loop = TrainLoop(tcfg, ckpt_dir=os.path.join(tmp, "t"),
                     ckpt_every=10 ** 6, device="cpu", **loop_kw)
    loop.state = convert.train_state_from_reference(
        jax.tree.map(np.asarray, ref.state), tcfg, device="cpu")
    loop.run()
    del loop.state
    ref.run()
    return {"config": cfg_kw, "loop": loop_kw,
            "reference": [float(h["loss"]) for h in ref.history],
            "port": [float(h["loss"]) for h in loop.history],
            "grad_norm_reference": [float(h["grad_norm"])
                                    for h in ref.history],
            "grad_norm_port": [float(h["grad_norm"]) for h in loop.history]}


if __name__ == "__main__":
    # python tests/test_torch_train_loop.py OUT.json: the two loss curves
    import json
    import sys
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        curves = wide_loss_curves(d)
    with open(sys.argv[1], "w") as f:
        json.dump(curves, f, indent=1)
    print(json.dumps(curves))
