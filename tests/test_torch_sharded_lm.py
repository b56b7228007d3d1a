"""The port's sharded LM on the CPU: 4 gloo ranks over a ``(data 2,
model 2)`` ``DeviceMesh`` (``tests/_sharded_ranks.py``, spawned once per
module), against the port's unsharded path and the reference.

* Every family's smoke config in float32 (and a dense one whose 5 heads
  the model axis does not divide: KV-parallel attention with remat):
  the sharded forward's logits within 1e-5 of the unsharded port's, one
  train step's loss within 1e-5, each gradient leaf within 1e-4 of its
  norm (plus 1e-6: a key bias's gradient is zero up to rounding), and
  AdamW's moments (``mu``; ``nu``, or the factored ``vr`` / ``vc``)
  within 1e-4 of their norm (plus the gradient's 1e-6 carried through:
  1e-7 for ``mu``, 5e-14 for ``nu``) of the unsharded step's.  The
  sharded optimizer's own work is held tighter: each parameter's and
  master weight's change, and each moment, within 1e-4 of its norm of
  what the unsharded AdamW writes from the sharded step's own gradients
  (against the unsharded step the change is ill-conditioned: the first
  step divides each gradient element by its own magnitude, so an element
  that is zero up to rounding moves by about the learning rate either
  way).  The MoE runs at capacity factor 64, where nothing drops,
  expert-parallel (8 experts) and not (3 experts); the dense one also
  with AdamW's factored second moment (and a bfloat16 ``mu``).
* ``make_train_step(microbatches=2)`` on rows of unequal mask counts:
  the sharded step's loss within 1e-5 and each gradient leaf within
  1e-4 of its norm of the unsharded port's (held to the reference's in
  ``test_torch_accumulation.py``), so each microbatch holds the
  reference's global rows.
* The expert-parallel ``moe_ffn`` at a dropping capacity (factor 1,
  capacity counted over each data shard's tokens) against the
  reference's ``moe_ffn(rules=)`` on 4 forced host devices in a child
  process, within 1e-5 of the output's largest magnitude.
* ``TrainLoop(mesh=)`` at 2 x 2 for 3 steps: a run with a failure at
  step 2 and its restore is bit-identical to the run without; the state
  written at 2 x 2 restores unsharded bit for bit, and back onto the
  mesh block for block (into a sharded template, and into a plain one
  by ``shardings=``).

(Gradient accumulation against the reference: ``test_torch_accumulation.py``.)

``python tests/test_torch_sharded_lm.py --ref-moe DIR`` is the child:
it reads ``DIR/moe_in.npz`` and writes ``DIR/moe_ref.npz``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
MOE_CFG = dict(param_dtype="float32", compute_dtype="float32",
               capacity_factor=1.0, router_offload="dense")
MOE_AXES = ("router", "wi", "wg", "wo", "shared_wi", "shared_wg",
            "shared_wo")


def _moe_inputs(path):
    """Seeded numpy inputs of the dropping-capacity EP check."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              **MOE_CFG)
    p = moe.init_moe(torch.Generator().manual_seed(3), cfg)
    rng = np.random.default_rng(4)
    arrays = {k: p[k].numpy() for k in MOE_AXES}
    arrays["x"] = rng.standard_normal((4, 16, cfg.d_model)).astype(
        np.float32)
    np.savez(os.path.join(path, "moe_in.npz"), **arrays)


def _wait(ctx, seconds):
    deadline = time.time() + seconds
    while not ctx.join(timeout=max(deadline - time.time(), 1)):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish within {seconds} s")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 4 ranks once; their results, and the run's directory."""
    import torch.multiprocessing as mp
    tmp = str(tmp_path_factory.mktemp("sharded_lm"))
    _moe_inputs(tmp)
    sys.path.insert(0, HERE)
    import _sharded_ranks
    ctx = mp.start_processes(_sharded_ranks.main, args=(4, tmp), nprocs=4,
                             join=False, start_method="spawn")
    _wait(ctx, 240)
    res = torch.load(os.path.join(tmp, "results.pt"), weights_only=False)
    return res, tmp


def _ok(res, name):
    out = res[name]
    assert "error" not in out, out.get("error")
    return out


@pytest.mark.parametrize("family", ["dense", "dense_kv", "moe", "moe_whole",
                                    "vlm", "audio", "hybrid", "ssm",
                                    "dense_factored"])
def test_sharded_forward_and_step_equal_the_unsharded_port(ranks, family):
    out = _ok(ranks[0], family)
    lg, dlg = out["logits"], out["d_logits"]
    assert dlg.shape == lg.shape
    assert (dlg - lg).abs().max() <= 1e-5 * max(1.0, lg.abs().max())
    assert abs(float(out["d_loss"]) - float(out["loss"])) <= 1e-5
    assert set(out["d_grads"]) == set(out["grads"])
    for path, g in out["grads"].items():
        err = (out["d_grads"][path] - g).abs().max()
        assert err <= 1e-4 * g.norm() + 1e-6, (path, float(err))
    for part, floor in (("mu", 1e-7), ("nu", 5e-14)):
        assert set(out["d_" + part]) == set(out[part])
        for path, want in out[part].items():
            err = (out["d_" + part][path].float() - want.float()).abs().max()
            assert err <= 1e-4 * want.float().norm() + floor, \
                (part, path, float(err))
    for part in ("params", "master", "mu", "nu"):
        assert set(out["d_" + part]) == set(out["r_" + part])
        for path, want in out["r_" + part].items():
            got = out["d_" + part][path].float()
            want = want.float()
            if part in ("params", "master"):     # the change of one step
                old = out["old"][path].float()
                got, want = got - old, want - old
                assert want.norm() > 0, (part, path)
            err = (got - want).abs().max()
            assert err <= 1e-4 * want.norm(), (part, path, float(err))
    # the state really is sharded: some leaf is split over each mesh axis
    pl = " ".join(out["d_placements"].values())
    assert "Shard" in pl


def test_sharded_microbatches_with_ragged_masks_equal_the_unsharded(ranks):
    out = _ok(ranks[0], "accum")
    assert abs(float(out["d_loss"]) - float(out["loss"])) <= 1e-5
    assert set(out["d_grads"]) == set(out["grads"])
    for path, g in out["grads"].items():
        err = (out["d_grads"][path] - g).abs().max()
        assert err <= 1e-4 * g.norm() + 1e-6, (path, float(err))


def test_heads_the_model_axis_does_not_divide_take_the_kv_route(ranks):
    """5 heads over a model axis of 2: the projections' weights stay
    sharded, attention splits the key length."""
    from repro_torch.models.sharding import AbstractMesh, ShardingRules
    rules = ShardingRules(AbstractMesh(data=2, model=2))
    assert rules.resolve("heads", 5) is None
    assert rules.resolve("heads", 4) == "model"
    _ok(ranks[0], "dense_kv")


def _run_ref_moe(tmp):
    from repro.launch.mesh import forced_host_devices_env
    env = forced_host_devices_env(4)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"),
         env.get("PYTHONPATH", "")])
    subprocess.run([sys.executable, os.path.abspath(__file__), "--ref-moe",
                    tmp], check=True, env=env, timeout=180)
    return np.load(os.path.join(tmp, "moe_ref.npz"))["y"]


def test_expert_parallel_moe_with_drops_equals_the_reference(ranks):
    res, tmp = ranks
    out = _ok(res, "moe_drop")
    assert out["placements"] == "(Shard(dim=0), Shard(dim=1))"
    want = _run_ref_moe(tmp)
    got = out["y"].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    # some expert gets more (token, slot) rows of a data shard than its
    # capacity: rows do drop, so this is not the no-drop path
    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              **MOE_CFG)
    d = np.load(os.path.join(tmp, "moe_in.npz"))
    for shard in np.split(d["x"], 2):
        xt = shard.reshape(-1, cfg.d_model)
        cap = max(int(np.ceil(xt.shape[0] * cfg.moe_top_k / cfg.n_experts
                              * cfg.capacity_factor)), 8)
        top = np.argsort(-(xt @ d["router"]), axis=1,
                         kind="stable")[:, :cfg.moe_top_k]
        assert np.bincount(top.ravel(), minlength=cfg.n_experts).max() > cap


def test_train_loop_at_2x2_restores_bit_for_bit(ranks):
    out = _ok(ranks[0], "train_loop")
    plain, failed = out["plain"], out["failed"]
    assert failed["restarts"] == 1 and plain["restarts"] == 0
    assert failed["losses"][-1] == plain["losses"][-1]
    for path, p in plain["params"].items():
        assert torch.equal(failed["params"][path], p), path
    assert out["resharded_equal"]


def test_a_2x2_checkpoint_restores_unsharded(ranks):
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.models import steps
    from repro_torch.tree import leaves_with_paths
    out = _ok(ranks[0], "train_loop")
    sys.path.insert(0, HERE)
    import _sharded_ranks
    template = steps.init_train_state(_sharded_ranks.case_cfg("dense"),
                                      seed=1, device="cpu")
    back = restore_pytree(template, out["ckpt_dir"], 99)
    n = 0
    for path, x in leaves_with_paths(back):
        if isinstance(x, torch.Tensor) and path in out["written"]:
            assert not hasattr(x, "placements")
            assert torch.equal(x, out["written"][path]), path
            n += 1
    assert n == len(out["written"])


def _ref_moe_child(tmp):
    """The reference's EP ``moe_ffn`` on a 2 x 2 mesh of forced host
    devices (run with 4 of them)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models.moe import moe_ffn
    from repro.models.sharding import ShardingRules
    d = np.load(os.path.join(tmp, "moe_in.npz"))
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              **MOE_CFG)
    from repro.launch.mesh import make_local_mesh
    rules = ShardingRules(make_local_mesh(2, 2))
    p = {k: jnp.asarray(d[k]) for k in MOE_AXES}
    y = jax.jit(lambda p, x: moe_ffn(p, x, cfg, rules))(
        p, jnp.asarray(d["x"]))
    np.savez(os.path.join(tmp, "moe_ref.npz"), y=np.asarray(y))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ref-moe":
        _ref_moe_child(sys.argv[2])
    else:
        print(json.dumps({"usage": "--ref-moe DIR"}))
