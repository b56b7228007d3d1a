"""The plan autotuner, the plan store and the serving warm start
(``repro_torch.tune``) against the reference's ``repro.tune``, on the CPU.

Every test of ``tests/test_tune.py`` and of
``tests/test_env.py::TestTuneKnobsAreStrict`` has a twin here, run on the
port's ``"torch"`` backend and on ``"cuda"`` with ``device="cpu"`` (the
kernels' plain versions).  The reference's AOT tier has no counterpart:
every port plan is config-only (``PlanStore._exec_eligible``), and the
AOT twins pin that rule.  The cross-process twin runs torch-only
children.  Parity tests feed the same numpy inputs to both packages:
``workload_digest`` hex for hex, one config record through both
``plan_for_config``s, and a reference ``cfg-jnp-*`` record that the port
never reads.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import cim_dialect as rcd
from repro.core.engine.spec import workload_digest as r_workload_digest
from repro.tune import plan_for_config as r_plan_for_config
from repro.tune import tune_plan as r_tune_plan
from repro_torch.core import cim_dialect as tcd
from repro_torch.core.engine import get_hierarchical_plan, workload_digest
from repro_torch.launch.mesh import forced_devices
from repro_torch.tune import (active_store, plan_for_config,
                              plan_store_stats, reset_plan_store_stats,
                              reset_tune_stats, tune_plan, tune_stats,
                              warm_start_plan)
from repro_torch.tune.tuner import _tuned_spec

from test_torch_kernels import _assert_eucl_close
from test_torch_range import interval_data, range_module
from test_torch_update_rows import sim_module

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ["torch", "cuda"]


def _data(rng, metric, m, n, d):
    if metric == "hamming":
        return ((rng.random((m, d)) > 0.5).astype(np.float32),
                (rng.random((n, d)) > 0.5).astype(np.float32))
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _mod_and_data(metric="hamming", k=4, m=16, n=256, dim=64,
                  arch=None, seed=0):
    rng = np.random.default_rng(seed)
    mod = sim_module(T, tcd, metric, k, metric != "eucl", m, n, dim,
                     arch or T.PAPER_BASE_ARCH)
    q, p = _data(rng, metric, m, n, dim)
    return mod, q, p


def _np(out):
    return tuple(x.numpy() for x in out)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No store and no tuner knob leaks in from the environment."""
    for name in ("REPRO_PLAN_STORE", "REPRO_TUNE_TRIALS", "REPRO_TUNE_REPS",
                 "REPRO_TUNE_BUDGET_S", "REPRO_TUNE_SERVE"):
        monkeypatch.delenv(name, raising=False)
    T.clear_plan_cache()


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
class TestTuner:
    def test_winner_matches_baseline_output(self, backend):
        reset_tune_stats()
        mod, q, p = _mod_and_data()
        res = tune_plan(mod, q, p, trials=6, reps=1, backend=backend,
                        device="cpu")
        assert not res.from_store and res.trials <= 6
        assert res.plan.backend == backend
        base = T.get_plan(mod, backend=backend, device="cpu")
        bv, bi = _np(base.execute(q, p))
        tv, ti = _np(res.plan.execute(q, p))
        # hamming is an integer count: the tuned plan is bit-identical
        assert (bv == tv).all() and (bi == ti).all()
        # the incumbent only ever loses to a faster verified candidate
        assert res.best_s <= res.base_s

    def test_trial_bound_is_respected(self, backend):
        reset_tune_stats()
        mod, q, p = _mod_and_data(n=128)
        res = tune_plan(mod, q, p, trials=2, reps=1, backend=backend,
                        device="cpu")
        assert res.trials <= 2
        assert tune_stats()["trials"] <= 2

    def test_float_metric_winner_is_tolerance_verified(self, backend):
        mod, q, p = _mod_and_data(metric="eucl", n=128)
        res = tune_plan(mod, q, p, trials=4, reps=1, backend=backend,
                        device="cpu")
        base = T.get_plan(mod, backend=backend, device="cpu")
        bv, _ = _np(base.execute(q, p))
        tv, _ = _np(res.plan.execute(q, p))
        np.testing.assert_allclose(bv, tv, rtol=1e-4, atol=1e-4)

    def test_interpreter_only_module_is_rejected(self, backend):
        mod = T.Module("empty", [T.TensorType((4, 8))])
        T.Builder(mod.body).ret(list(mod.arguments))
        with pytest.raises(ValueError, match="similarity/range"):
            tune_plan(mod, np.zeros((4, 8), np.float32), backend=backend,
                      device="cpu")

    def test_history_records_rejections_and_errors_without_raising(
            self, backend):
        mod, q, p = _mod_and_data(n=128)
        res = tune_plan(mod, q, p, trials=8, reps=1, backend=backend,
                        device="cpu")
        assert res.history[0]["baseline"] is True
        assert all("wall_s" in h for h in res.history)

    def test_every_batch_candidate_gives_the_baseline_answers(self, backend):
        """The ragged last micro-batch runs unpadded: each batch on the
        axis (16..2m) is verified, none rejected."""
        reset_tune_stats()
        mod, q, p = _mod_and_data(m=37, n=200, dim=40)
        res = tune_plan(mod, q, p, trials=24, reps=1, backend=backend,
                        device="cpu")
        batches = {h["batch"] for h in res.history
                   if h.get("verified") or h.get("baseline")}
        assert batches == {16, 32, 64, 74}          # 74 = 2m caps 128
        assert tune_stats()["rejected"] == 0
        assert not any(h.get("error") for h in res.history)


@pytest.mark.parametrize("backend", BACKENDS)
def test_refused_candidate_is_recorded_not_raised(backend):
    """A ternary plan on ``"cuda"`` refuses ``pack=False``: the candidate
    lands in the history as an error and the tune goes on.  A ternary
    plan on ``"torch"`` takes both packings and rejects neither."""
    rng = np.random.default_rng(3)
    m, n, dim = 8, 96, 40
    mod = sim_module(T, tcd, "hamming", 3, False, m, n, dim,
                     T.ArchSpec(rows=16, cols=16), care=True)
    q, p = _data(rng, "hamming", m, n, dim)
    care = (rng.random((n, dim)) > 0.2).astype(np.float32)
    res = tune_plan(mod, q, p, care, trials=24, reps=1, backend=backend,
                    device="cpu")
    refused = [h for h in res.history if h.get("error")]
    if backend == "cuda":
        assert [h["pack"] for h in refused] == [False]
        assert "packed execution" in refused[0]["reason"]
        assert res.plan.packed
    else:
        assert refused == []
    want = _np(T.get_plan(mod, backend=backend, device="cpu")
               .execute(q, p, care))
    got = _np(res.plan.execute(q, p, care))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("backend", BACKENDS)
def test_interval_range_plan_tunes_bit_identical(backend, rng):
    m, n, dim = 24, 300, 20
    mod = range_module(T, tcd, m, n, dim, interval=True,
                       arch=T.ArchSpec(rows=32, cols=16))
    q, lo, hi = interval_data(rng, m, n, dim)
    res = tune_plan(mod, q, lo, hi, trials=10, reps=1, backend=backend,
                    device="cpu")
    assert all(h["pack"] is False for h in res.history)    # no pack axis
    base = T.get_plan(mod, backend=backend, device="cpu")
    np.testing.assert_array_equal(res.plan.execute(q, lo, hi).numpy(),
                                  base.execute(q, lo, hi).numpy())


def test_shards_axis_only_on_torch_with_several_devices(rng):
    """The shards axis appears on ``"torch"`` when ``launch.mesh`` sees
    more than one device of the plan's type (here 4 CPU stand-ins), and
    never on ``"cuda"``."""
    mod, q, p = _mod_and_data(n=128)
    with forced_devices(4, "cpu"):
        res = tune_plan(mod, q, p, trials=24, reps=1, backend="torch",
                        device="cpu")
        cuda = tune_plan(mod, q, p, trials=24, reps=1, backend="cuda",
                         device="cpu")
    assert any(h["shards"] == 4 and h.get("verified")
               for h in res.history)
    assert all(h["shards"] == 1 for h in cuda.history)


def test_cuda_sweeps_only_batch_and_pack():
    """The ``"cuda"`` executables lay the gallery out as one block, so
    the tile geometry is an axis of ``"torch"`` only; ``"cuda"``
    candidates keep the heuristic geometry, which its record carries."""
    mod, q, p = _mod_and_data(m=37, n=200, dim=40)
    torch_res = tune_plan(mod, q, p, trials=24, reps=1, backend="torch",
                          device="cpu")
    cuda = tune_plan(mod, q, p, trials=24, reps=1, backend="cuda",
                     device="cpu")
    assert len({h["tile_rows"] for h in torch_res.history}) > 1
    base = cuda.history[0]
    assert all((h["tile_rows"], h["dims_per_tile"])
               == (base["tile_rows"], base["dims_per_tile"])
               for h in cuda.history)
    assert {h["batch"] for h in cuda.history} == {16, 32, 64, 74}
    assert (cuda.config["tile_rows"], cuda.config["dims_per_tile"]) \
        == (base["tile_rows"], base["dims_per_tile"])


# (times of the baseline's sweep execute, of the other sweep executes, of
# the rematch's baseline, of the rematch's winner; reps; winner kept?)
_TIMING_CASES = {
    # the baseline read slow only because it was timed first: the
    # rematch finds no gain and the baseline stays
    "first_timed_noise": ([2.0], [1.0], [1.0], [1.0], 1, False),
    # a real gain survives the rematch, which sets base_s and best_s
    "real_gain": ([2.0], [1.0], [2.0], [1.0], 1, True),
    # faster by less than the candidate's own spread: never the incumbent
    "within_spread": ([2.0, 2.0, 2.0], [1.5, 1.5, 3.0], None, None, 3,
                      False),
}


@pytest.mark.parametrize("case", sorted(_TIMING_CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_winner_must_beat_a_rematched_baseline(backend, case, monkeypatch):
    """A candidate replaces the incumbent only when it wins by more than
    the spread of its timed executes, and the sweep's winner is timed
    again against the baseline (interleaved) before it is kept; the
    result's ``base_s`` / ``best_s`` / ``speedup`` are the rematch's."""
    from repro_torch.tune import tuner
    first, sweep, re_base, re_best, reps, kept = _TIMING_CASES[case]
    mod, q, p = _mod_and_data(m=16, n=128)
    base_plan = T.get_plan(mod, backend=backend, device="cpu")
    calls = {"n": 0, "rematch": False}
    real_rematch = tuner._rematch

    def rematch(base, best, inputs, n):
        calls["rematch"] = True
        assert base is base_plan and best is not base_plan
        return real_rematch(base, best, inputs, n)

    def rep_times(plan, inputs, n):
        calls["n"] += 1
        if calls["rematch"]:
            return list(re_base if plan is base_plan else re_best)[:n]
        return list(first if calls["n"] == 1 else sweep)[:n]

    monkeypatch.setattr(tuner, "_rep_times", rep_times)
    monkeypatch.setattr(tuner, "_rematch", rematch)
    res = tune_plan(mod, q, p, trials=1, reps=reps, backend=backend,
                    device="cpu")
    assert res.trials == 1
    assert (res.plan is not base_plan) == kept
    assert calls["rematch"] == (re_base is not None)
    if kept:
        assert (res.base_s, res.best_s, res.speedup) == (2.0, 1.0, 2.0)
    else:
        assert res.plan is base_plan and res.speedup == 1.0
        assert res.config["batch"] == base_plan.batch


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


class TestPlanStore:
    def test_active_store_unset_is_none(self):
        assert active_store() is None

    def test_active_store_blank_raises(self, monkeypatch):
        monkeypatch.setenv("REPRO_PLAN_STORE", "   ")
        with pytest.raises(ValueError, match="REPRO_PLAN_STORE"):
            active_store()

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_config_roundtrip_and_store_hit(self, backend, tmp_path,
                                            monkeypatch):
        monkeypatch.setenv("REPRO_PLAN_STORE", str(tmp_path))
        reset_plan_store_stats()
        mod, q, p = _mod_and_data(n=128)
        first = tune_plan(mod, q, p, trials=4, reps=1, backend=backend,
                          device="cpu")
        assert not first.from_store
        files = os.listdir(tmp_path)
        assert [f.split("-")[1] for f in files if f.startswith("cfg-")] \
            == [backend]
        rec = json.loads((tmp_path / files[0]).read_text())
        assert rec["unroll"] == 1 and rec["version"] == 1
        assert set(rec) >= {"backend", "tile_rows", "dims_per_tile",
                            "batch", "pack", "shards", "base_s", "best_s",
                            "trials", "speedup", "workload"}
        second = tune_plan(mod, q, p, trials=4, reps=1, backend=backend,
                           device="cpu")
        assert second.from_store and second.trials == 0
        assert second.config["tile_rows"] == first.config["tile_rows"]
        assert plan_store_stats()["config_hits"] >= 1
        fv, fi = _np(first.plan.execute(q, p))
        sv, si = _np(second.plan.execute(q, p))
        assert (fv == sv).all() and (fi == si).all()

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_aot_record_written_for_eligible_plan(self, backend, tmp_path,
                                                  monkeypatch):
        """Twin of the reference's AOT save: at the shape the reference
        serializes (single device, not tiny), the port writes the config
        record only.  ``"cuda"`` kernel libraries already persist in the
        build directory, named by a hash of their sources and flags;
        ``"torch"`` plans are eager and have nothing compiled."""
        monkeypatch.setenv("REPRO_PLAN_STORE", str(tmp_path))
        reset_plan_store_stats()
        mod, q, p = _mod_and_data(m=32, n=768, dim=64)
        res = tune_plan(mod, q, p, trials=3, reps=1, backend=backend,
                        device="cpu")
        assert not res.plan.tiny
        assert not any(f.startswith("aot-") for f in os.listdir(tmp_path))
        stats = plan_store_stats()
        assert stats["exec_saves"] == 0 and stats["exec_skips"] == 1
        assert stats["config_saves"] == 1

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_fresh_plan_adopts_stored_executables(self, backend, tmp_path,
                                                  monkeypatch):
        """Twin of the reference's AOT adoption: a fresh plan built from
        the stored config adopts nothing (config-only store, see the
        previous test) and still gives the tuned plan's results."""
        monkeypatch.setenv("REPRO_PLAN_STORE", str(tmp_path))
        reset_plan_store_stats()
        mod, q, p = _mod_and_data(m=32, n=768, dim=64)
        res = tune_plan(mod, q, p, trials=3, reps=1, backend=backend,
                        device="cpu")
        want = _np(res.plan.execute(q, p))
        T.clear_plan_cache()
        reset_plan_store_stats()
        plan = plan_for_config(res.plan.spec, res.config, device="cpu")
        assert plan is not res.plan
        assert active_store().adopt_executables(plan) is False
        assert plan_store_stats() == dict.fromkeys(plan_store_stats(), 0)
        for w, g in zip(want, _np(plan.execute(q, p))):
            assert (w == g).all()

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_tiny_plans_are_config_only(self, backend, tmp_path,
                                        monkeypatch):
        """The reference keeps tiny plans config-only (their executables
        trace at the caller's query count); every port plan is."""
        monkeypatch.setenv("REPRO_PLAN_STORE", str(tmp_path))
        reset_plan_store_stats()
        arch = T.ArchSpec(rows=16, cols=256)   # one column tile, dim=32
        mod, q, p = _mod_and_data(n=64, dim=32, arch=arch)
        plan = T.get_plan(mod, backend=backend, device="cpu")
        assert plan.tiny == (backend == "torch")
        store = active_store()
        assert store.persist_executables(plan, plan.warm(p)) is False
        assert plan_store_stats()["exec_skips"] == 1
        assert not any(f.startswith("aot-") for f in os.listdir(tmp_path))
        assert store.adopt_executables(plan) is False

    def test_one_store_per_path_and_torn_records_miss(self, tmp_path,
                                                      monkeypatch):
        monkeypatch.setenv("REPRO_PLAN_STORE", str(tmp_path / "s"))
        store = active_store()
        monkeypatch.setenv("REPRO_PLAN_STORE",
                           str(tmp_path / "x" / ".." / "s"))
        assert active_store() is store
        mod, q, p = _mod_and_data(n=64)
        spec = T.get_plan(mod, device="cpu").spec
        path = store.save_config(spec, "cuda", {"backend": "cuda"})
        assert os.path.basename(path) == \
            f"cfg-cuda-{workload_digest(spec)}.json"
        assert not any(f.startswith(".tmp-") for f in os.listdir(store.root))
        with open(path, "w") as f:
            f.write("{not json")
        reset_plan_store_stats()
        assert store.load_config(spec, "cuda") is None
        assert plan_store_stats()["config_misses"] == 1


# ---------------------------------------------------------------------------
# serving warm start
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
class TestServingWarmStart:
    def test_warm_start_plan_noop_without_store(self, backend):
        mod, q, p = _mod_and_data(n=128)
        plan = T.get_plan(mod, backend=backend, device="cpu")
        assert warm_start_plan(plan) is plan

    def test_server_construction_picks_tuned_plan(self, backend, tmp_path,
                                                  monkeypatch):
        from repro_torch.serving import CamSearchServer
        monkeypatch.setenv("REPRO_PLAN_STORE", str(tmp_path))
        # heuristic geometry from a deliberately small arch...
        arch = T.ArchSpec(rows=16, cols=32)
        mod, q, p = _mod_and_data(n=256, dim=64, arch=arch)
        res = tune_plan(mod, q, p, trials=5, reps=1, backend=backend,
                        device="cpu")
        heuristic = T.get_plan(mod, backend=backend, device="cpu")
        with CamSearchServer(heuristic, p) as srv:
            # ...swapped for the stored winner at construction
            assert srv.plan.spec.tile_rows == res.config["tile_rows"]
            assert srv.plan.batch == res.config["batch"]
            assert srv.plan.device == heuristic.device
            v, i = srv.search(q)
            bv, bi = _np(res.plan.execute(q, p))
            np.testing.assert_array_equal(np.asarray(v), bv)
            np.testing.assert_array_equal(np.asarray(i), bi)
        with CamSearchServer(heuristic, p, tuned=False) as srv:
            assert srv.plan is heuristic

    def test_env_kill_switch(self, backend, tmp_path, monkeypatch):
        from repro_torch.serving.server import _resolve_plan
        monkeypatch.setenv("REPRO_PLAN_STORE", str(tmp_path))
        arch = T.ArchSpec(rows=16, cols=32)
        mod, q, p = _mod_and_data(n=256, dim=64, arch=arch)
        tune_plan(mod, q, p, trials=4, reps=1, backend=backend,
                  device="cpu")
        plan = T.get_plan(mod, backend=backend, device="cpu")
        monkeypatch.setenv("REPRO_TUNE_SERVE", "0")
        assert _resolve_plan(plan) is plan

    def test_gateway_tenant_serves_the_winner(self, backend, tmp_path,
                                              monkeypatch):
        from repro_torch.serving import CamServingGateway
        monkeypatch.setenv("REPRO_PLAN_STORE", str(tmp_path))
        arch = T.ArchSpec(rows=16, cols=32)
        mod, q, p = _mod_and_data(n=256, dim=64, arch=arch)
        res = tune_plan(mod, q, p, trials=5, reps=1, backend=backend,
                        device="cpu")
        heuristic = T.get_plan(mod, backend=backend, device="cpu")
        with CamServingGateway() as gw:
            gw.register_tenant("tuned", heuristic, p, replicas=2)
            gw.register_tenant("as_is", heuristic, p, tuned=False)
            rset = gw._tenant("tuned").rset
            assert rset.plan is res.plan
            assert all(r.server.plan is res.plan for r in rset.replicas)
            assert gw._tenant("as_is").rset.plan is heuristic
            v, i = gw.search("tuned", q)
            bv, bi = _np(res.plan.execute(q, p))
            np.testing.assert_array_equal(np.asarray(v), bv)
            np.testing.assert_array_equal(np.asarray(i), bi)

    def test_corrupt_record_never_blocks_construction(self, backend,
                                                      tmp_path, monkeypatch):
        from repro_torch.serving import CamSearchServer
        monkeypatch.setenv("REPRO_PLAN_STORE", str(tmp_path))
        mod, q, p = _mod_and_data(n=128)
        plan = T.get_plan(mod, backend=backend, device="cpu")
        path = active_store().save_config(plan.spec, backend,
                                          {"backend": backend})
        with CamSearchServer(plan, p) as srv:   # record lacks its knobs
            assert srv.plan is plan
        with open(path, "w") as f:
            f.write("\x00garbage")
        with CamSearchServer(plan, p) as srv:
            assert srv.plan is plan


def test_composite_and_sharded_plans_come_back_unchanged(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_STORE", str(tmp_path))
    mod, q, p = _mod_and_data(n=256)
    tune_plan(mod, q, p, trials=3, reps=1, backend="torch", device="cpu")
    hier = get_hierarchical_plan(mod, clusters=4, nprobe=2, device="cpu")
    assert warm_start_plan(hier) is hier
    with forced_devices(2, "cpu"):
        sharded = T.get_plan(mod, backend="torch", shards=2, device="cpu")
    assert sharded.shards == 2 and warm_start_plan(sharded) is sharded


# ---------------------------------------------------------------------------
# cross-process cold start (the contract the store exists for)
# ---------------------------------------------------------------------------

_CHILD = r'''
import json, sys
import numpy as np
import repro_torch.core as T
from repro_torch.core import cim_dialect as cd
from repro_torch.tune import tune_plan, plan_store_stats, tune_stats
m, n, dim, k = 32, 768, 64, 8
mod = T.Module("sim", [T.TensorType((m, dim)), T.TensorType((n, dim))])
a = mod.arguments
b = T.Builder(mod.body)
dev = cd.make_acquire(b)
exe = cd.make_execute(b, dev.result, list(a),
                      [T.TensorType((m, k)), T.TensorType((m, k), "i32")])
blk = exe.region().block()
sim = cd.make_similarity(blk, a[0], a[1], metric="hamming", k=k,
                         largest=True)
cd.make_yield(blk, sim.results)
cd.make_release(b, dev.result)
b.ret(exe.results)
pm = T.PassManager()
pm.add(T.passes.CompulsoryPartition())
mod = pm.run(mod, {"arch": T.PAPER_BASE_ARCH})
rng = np.random.default_rng(7)
q = (rng.random((m, dim)) > 0.5).astype(np.float32)
p = (rng.random((n, dim)) > 0.5).astype(np.float32)
res = tune_plan(mod, q, p, trials=4, reps=1, backend=%(backend)r,
                device="cpu")
v, i = (x.numpy() for x in res.plan.execute(q, p))
print(json.dumps({
    "trials": res.trials, "from_store": res.from_store,
    "store": plan_store_stats(), "tune": tune_stats(),
    "config": {k: res.config[k] for k in
               ("tile_rows", "dims_per_tile", "batch", "pack", "unroll")},
    "imported": sorted(x for x in sys.modules
                       if x.split(".")[0] in ("jax", "repro")),
    "v": v.tolist(), "i": i.tolist()}))
'''


@pytest.mark.parametrize("backend", BACKENDS)
def test_second_process_skips_tuning(backend, tmp_path):
    """Process A tunes and persists; process B must warm-start: zero
    trials, one config hit, no executable tier touched, bit-identical
    results.  Both children import torch and the port only."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_PLAN_STORE=str(tmp_path))
    for name in ("REPRO_TUNE_TRIALS", "REPRO_TUNE_REPS",
                 "REPRO_TUNE_BUDGET_S"):
        env.pop(name, None)

    def run():
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD % {"backend": backend}],
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        return json.loads(proc.stdout.splitlines()[-1])

    cold = run()
    assert cold["imported"] == []
    assert cold["trials"] > 0 and not cold["from_store"]
    assert cold["store"]["config_saves"] == 1
    assert cold["store"]["exec_skips"] == 1
    assert cold["store"]["exec_saves"] == 0

    warm = run()
    assert warm["imported"] == []
    assert warm["from_store"] and warm["trials"] == 0
    assert warm["tune"]["trials"] == 0
    assert warm["store"]["config_hits"] == 1
    assert warm["store"]["exec_hits"] == warm["store"]["exec_misses"] == 0
    assert warm["config"] == cold["config"]
    assert warm["v"] == cold["v"] and warm["i"] == cold["i"], \
        "warm-started plan is not bit-identical to the tuned one"


# ---------------------------------------------------------------------------
# the knobs parse strictly (tests/test_env.py::TestTuneKnobsAreStrict)
# ---------------------------------------------------------------------------


class TestTuneKnobsAreStrict:
    def _mod(self):
        return sim_module(T, tcd, "hamming", 2, False, 4, 32, 16,
                          T.ArchSpec(rows=8, cols=16))

    def test_tune_trials_strict(self, monkeypatch):
        q = np.zeros((4, 16), np.float32)
        p = np.zeros((32, 16), np.float32)
        monkeypatch.setenv("REPRO_TUNE_TRIALS", "many")
        with pytest.raises(ValueError, match="REPRO_TUNE_TRIALS"):
            tune_plan(self._mod(), q, p, device="cpu")
        monkeypatch.setenv("REPRO_TUNE_TRIALS", "0")
        with pytest.raises(ValueError, match="REPRO_TUNE_TRIALS"):
            tune_plan(self._mod(), q, p, device="cpu")

    def test_tune_reps_and_budget_strict(self, monkeypatch):
        q = np.zeros((4, 16), np.float32)
        p = np.zeros((32, 16), np.float32)
        monkeypatch.setenv("REPRO_TUNE_REPS", "thrice")
        with pytest.raises(ValueError, match="REPRO_TUNE_REPS"):
            tune_plan(self._mod(), q, p, device="cpu")
        monkeypatch.delenv("REPRO_TUNE_REPS")
        for bad in ("forever", "nan", "-1"):
            monkeypatch.setenv("REPRO_TUNE_BUDGET_S", bad)
            with pytest.raises(ValueError, match="REPRO_TUNE_BUDGET_S"):
                tune_plan(self._mod(), q, p, device="cpu")

    def test_tune_serve_flag_strict(self, monkeypatch):
        from repro_torch.serving.server import _resolve_plan
        plan = T.get_plan(self._mod(), device="cpu")
        monkeypatch.setenv("REPRO_TUNE_SERVE", "maybe")
        with pytest.raises(ValueError, match="REPRO_TUNE_SERVE"):
            _resolve_plan(plan)

    def test_plan_store_blank_raises(self, monkeypatch):
        monkeypatch.setenv("REPRO_PLAN_STORE", "")
        with pytest.raises(ValueError, match="REPRO_PLAN_STORE"):
            active_store()


# ---------------------------------------------------------------------------
# parity with the reference on the same numpy inputs
# ---------------------------------------------------------------------------

_SIM_CASES = [("hamming", 4, False), ("dot", 3, True), ("eucl", 5, False),
              ("cos", 2, True)]


@pytest.mark.parametrize("metric,k,largest", _SIM_CASES)
def test_workload_digest_matches_reference_for_search(metric, k, largest):
    digests, geoms = set(), set()
    for rows, cols in ((16, 32), (64, 16)):
        rmod = sim_module(R, rcd, metric, k, largest, 9, 150, 70,
                          R.ArchSpec(rows=rows, cols=cols))
        tmod = sim_module(T, tcd, metric, k, largest, 9, 150, 70,
                          T.ArchSpec(rows=rows, cols=cols))
        rspec = R.get_plan(rmod).spec
        tspec = T.get_plan(tmod, backend="torch", device="cpu").spec
        assert workload_digest(tspec) == r_workload_digest(rspec)
        digests.add(workload_digest(tspec))
        geoms.add((tspec.tile_rows, tspec.dims_per_tile))
    assert len(geoms) == 2 and len(digests) == 1   # geometry normalised away


@pytest.mark.parametrize("case", ["interval", "hamming", "eucl"])
def test_workload_digest_matches_reference_for_range(case):
    kw = dict(interval=True) if case == "interval" else \
        dict(metric=case, tau=3.5, below=case == "eucl")
    digests, geoms = set(), set()
    for rows, cols in ((16, 32), (64, 16)):
        rmod = range_module(R, rcd, 7, 120, 33,
                            arch=R.ArchSpec(rows=rows, cols=cols), **kw)
        tmod = range_module(T, tcd, 7, 120, 33,
                            arch=T.ArchSpec(rows=rows, cols=cols), **kw)
        rspec = R.get_plan(rmod).spec
        tspec = T.get_plan(tmod, backend="torch", device="cpu").spec
        assert workload_digest(tspec) == r_workload_digest(rspec)
        digests.add(workload_digest(tspec))
        geoms.add((tspec.tile_rows, tspec.dims_per_tile))
    assert len(geoms) == 2 and len(digests) == 1


_CONFIG = {"tile_rows": 32, "dims_per_tile": 16, "batch": 16, "unroll": 1,
           "shards": 1}
_PARITY = [("hamming", "jnp", "torch"), ("hamming", "pallas", "cuda"),
           ("dot", "jnp", "torch"), ("dot", "pallas", "cuda"),
           ("eucl", "jnp", "torch"), ("eucl", "pallas", "cuda"),
           ("interval", "jnp", "torch"), ("interval", "pallas", "cuda")]


@pytest.mark.parametrize("metric,ref_backend,backend", _PARITY)
def test_plan_for_config_matches_reference(metric, ref_backend, backend,
                                           rng):
    """One config record through both packages' ``plan_for_config``:
    the re-tiled plans agree (hamming, dot and interval bit for bit,
    eucl within the tolerance of ``test_torch_kernels``)."""
    m, n, dim = 21, 130, 40
    if metric == "interval":
        rmod = range_module(R, rcd, m, n, dim, interval=True)
        tmod = range_module(T, tcd, m, n, dim, interval=True)
        ins = interval_data(rng, m, n, dim)
    else:
        largest = metric == "dot"
        rmod = sim_module(R, rcd, metric, 4, largest, m, n, dim,
                          R.ArchSpec(rows=64, cols=64))
        tmod = sim_module(T, tcd, metric, 4, largest, m, n, dim,
                          T.ArchSpec(rows=64, cols=64))
        ins = _data(rng, metric, m, n, dim)
        if metric == "dot":
            ins = tuple(np.where(x > 0, 1.0, -1.0).astype(np.float32)
                        for x in ins)
    pack = None if metric in ("hamming", "dot") else False
    rplan = r_plan_for_config(R.get_plan(rmod).spec,
                              dict(_CONFIG, backend=ref_backend, pack=pack))
    tplan = plan_for_config(T.get_plan(tmod, device="cpu").spec,
                            dict(_CONFIG, backend=backend, pack=pack),
                            device="cpu")
    assert (tplan.spec.tile_rows, tplan.spec.dims_per_tile, tplan.batch) \
        == (rplan.spec.tile_rows, rplan.spec.dims_per_tile, rplan.batch) \
        == (32, 16, 16)
    assert tplan.packed == rplan.packed
    want = rplan.execute(*ins)
    got = tplan.execute(*ins)
    if metric == "interval":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    wv, wi = (np.asarray(x) for x in want)
    gv, gi = _np(got)
    if metric == "eucl":
        _assert_eucl_close(ins[0], ins[1], wv, wi, gv, gi)
    else:
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)


def test_reference_record_is_invisible_to_the_port(tmp_path, monkeypatch):
    """A store directory both packages share: the reference's
    ``cfg-jnp-*`` record is keyed under its backend name, so the port's
    ``"torch"`` tune misses it and writes its own record beside it."""
    monkeypatch.setenv("REPRO_PLAN_STORE", str(tmp_path))
    rng = np.random.default_rng(5)
    q, p = _data(rng, "hamming", 16, 128, 64)
    rmod = sim_module(R, rcd, "hamming", 4, False, 16, 128, 64,
                      R.PAPER_BASE_ARCH)
    tmod = sim_module(T, tcd, "hamming", 4, False, 16, 128, 64,
                      T.PAPER_BASE_ARCH)
    r_tune_plan(rmod, q, p, trials=2, reps=1)

    def records():
        return sorted(f for f in os.listdir(tmp_path)
                      if f.startswith("cfg-"))

    (ref_rec,) = records()
    assert ref_rec.startswith("cfg-jnp-")
    reset_plan_store_stats()
    res = tune_plan(tmod, q, p, trials=2, reps=1, backend="torch",
                    device="cpu")
    assert not res.from_store
    assert plan_store_stats()["config_misses"] == 1
    digest = ref_rec[len("cfg-jnp-"):-len(".json")]
    assert records() == sorted([ref_rec, f"cfg-torch-{digest}.json"])


def test_tuned_spec_matches_reference():
    from repro.tune.tuner import _tuned_spec as r_tuned_spec
    rmod = sim_module(R, rcd, "hamming", 4, False, 9, 150, 70,
                      R.ArchSpec(rows=16, cols=32))
    tmod = sim_module(T, tcd, "hamming", 4, False, 9, 150, 70,
                      T.ArchSpec(rows=16, cols=32))
    rspec = R.get_plan(rmod).spec
    tspec = T.get_plan(tmod, backend="torch", device="cpu").spec
    for tr, dpt in ((512, 256), (7, 13), (150, 70)):
        r, t = r_tuned_spec(rspec, tr, dpt), _tuned_spec(tspec, tr, dpt)
        assert (t.tile_rows, t.dims_per_tile, t.grid_rows, t.grid_cols) \
            == (r.tile_rows, r.dims_per_tile, r.grid_rows, r.grid_cols)


def test_tune_runs_on_tensors_of_the_plan_device(rng):
    """Tensor inputs on the plan's device are used where they lie; the
    result lives there too."""
    mod, q, p = _mod_and_data(n=96)
    res = tune_plan(mod, torch.from_numpy(q), torch.from_numpy(p),
                    trials=2, reps=1, device="cpu")
    v, i = res.plan.execute(torch.from_numpy(q), torch.from_numpy(p))
    assert v.device.type == "cpu" and i.dtype == torch.int32
