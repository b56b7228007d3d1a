"""The port's roofline tally and dry run (``repro_torch.launch.roofline``,
``repro_torch.launch.dryrun``), and the LM kernels' custom ops under
``FakeTensorMode``.

* ``analyze_step`` counts exactly ``L * 2MKK`` FLOPs for an ``L``-step
  matrix loop, and the collectives at the ring costs
  ``tests/test_roofline.py`` pins for the reference: all-reduce
  ``2(n-1)/n * B``, all-gather ``(n-1)/n * B`` (a fake process group of
  16 ranks in this process, destroyed after);
* the bottleneck classification and ``model_flops`` equal the
  reference's (terms scaled to each side's peaks);
* B7, B7b and B2's custom ops give the right shapes and dtypes on fake
  tensors and launch nothing;
* one dry-run cell (``xlstm-125m``, ``train_4k``, one pod) in a child
  process: its per-device parameter bytes equal those derived from the
  reference's ``PartitionSpec``s, and its kernel calls are counted.
Exact equality throughout (FLOPs and bytes are integers here).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import roofline as rl

HERE = os.path.dirname(os.path.abspath(__file__))


def test_analyze_step_counts_loop_flops():
    def step(a, b, n):
        for _ in range(n):
            a = a @ b
        return a

    _, rep = rl.analyze_step(step, torch.randn(4, 8), torch.randn(8, 8), 12)
    assert rep.dot_count == 12
    assert rep.flops == 12 * 2 * 4 * 8 * 8
    # each product reads 4x8 + 8x8 floats and writes 4x8
    assert rep.hbm_bytes == 12 * 4 * (32 + 64 + 32)


@pytest.fixture()
def fake_group():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_analyze_step_charges_ring_costs(fake_group):
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 8), mesh_dim_names=("pod", "data"))

    def step(x, w):
        for _ in range(12):
            x = funcol.all_reduce(x @ w, "sum", (mesh, 1))   # groups of 8
        return funcol.all_gather_tensor(x, 1, (mesh, 0))     # groups of 2

    x, w = torch.randn(4, 8), torch.randn(8, 8)
    _, rep = rl.analyze_step(step, x, w, n_devices=16)
    # all-reduce of f32[4,8] = 128 B in groups of 8: 2 * 7/8 * 128 = 224 B
    assert rep.collective_bytes_by_kind["all_reduce"] == 224 * 12
    # all-gather into f32[4,16] = 256 B in groups of 2: 1/2 * 256 = 128 B
    assert rep.collective_bytes_by_kind["all_gather"] == 128
    assert rep.collective_counts == {"all_reduce": 12, "all_gather": 1}
    # ranks 0-7 share a node (NVLink); ranks 0 and 8 do not (the NIC)
    assert rep.collective_bytes_internode == 128
    assert rep.t_collective == pytest.approx(224 * 12 / rl.LINK_BW
                                             + 128 / rl.NIC_BW, rel=1e-12)
    assert rep.flops == 12 * 2 * 4 * 8 * 8


def test_bottleneck_classification_equals_the_reference_s():
    from repro.launch import roofline as ref
    rng = np.random.default_rng(0)
    for _ in range(200):
        a, b, c = rng.uniform(0.0, 2.0, 3)
        mine = rl.RooflineReport(flops=a * rl.PEAK_FLOPS,
                                 hbm_bytes=b * rl.HBM_BW,
                                 collective_bytes=c * rl.LINK_BW)
        theirs = ref.RooflineReport(flops=a * ref.PEAK_FLOPS,
                                    hbm_bytes=b * ref.HBM_BW,
                                    collective_bytes=c * ref.ICI_BW)
        assert mine.bottleneck == theirs.bottleneck
        assert mine.t_bound == pytest.approx(theirs.t_bound, rel=1e-12)
    rep = rl.RooflineReport(flops=rl.PEAK_FLOPS, hbm_bytes=1.0,
                            collective_bytes=1.0)
    assert rep.bottleneck == "compute" and rep.t_compute == 1.0
    assert rl.bottleneck_advice("memory", "prefill", "dense")


def test_model_flops_equal_the_reference_s():
    from repro.configs import ARCH_IDS, get_config as ref_config
    from repro.launch import roofline as ref, specs as rs
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import SHAPES
    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert rl.model_flops(get_config(arch), SHAPES[shape]) == \
                ref.model_flops(ref_config(arch), rs.SHAPES[shape])


def test_attention_pairs_count_the_visible_keys():
    for s, t, causal, prefix, kv_len, q0 in (
            (8, 8, True, 0, -1, 0), (8, 16, True, 0, 12, 4),
            (5, 9, True, 6, -1, 0), (4, 7, False, 0, 5, 0),
            (1, 32, True, 0, 20, 19)):
        want = 0
        for i in range(s):
            for j in range(t if kv_len < 0 else kv_len):
                if not causal or j <= q0 + i or j < prefix:
                    want += 1
        assert rl.attention_pairs(s, t, causal, prefix, kv_len, q0) == want


def test_lm_kernel_ops_trace_on_fake_tensors_and_launch_nothing():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import cam_search, flash_attention as fa
    cam_search.reset_launch_counts()
    with FakeTensorMode():
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(2, 64, 8, 128, dtype=dt, requires_grad=True)
            k = torch.randn(2, 64, 2, 128, dtype=dt, requires_grad=True)
            v = torch.randn(2, 64, 2, 128, dtype=dt, requires_grad=True)
            out, lse = torch.ops.repro_torch.flash_attention(
                q, k, v, True, 0, -1, 0, True)
            assert out.shape == q.shape and out.dtype == dt
            assert lse.shape == (2, 8, 64) and lse.dtype == torch.float32
            o = fa.flash_attention(q, k, v, causal=True)
            o.float().sum().backward()
            assert q.grad.shape == q.shape and q.grad.dtype == dt
            assert k.grad.shape == k.shape and v.grad.dtype == dt
            dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
                q, k, v, out, lse, out, True, 0, -1, 0)
            assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape,
                                                      v.shape)
        vals, idx = torch.ops.repro_torch.router_topk(
            torch.randn(4096, 2048), torch.randn(64, 2048), 6)
        assert vals.shape == (4096, 6) and vals.dtype == torch.float32
        assert idx.shape == (4096, 6) and idx.dtype == torch.int64
    assert sum(cam_search.LAUNCHES.values()) == 0


def _ref_param_bytes(arch, mesh_shape):
    """Per-device parameter bytes from the reference's PartitionSpecs."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.launch.specs import params_sharding, params_struct
    from repro.models.sharding import ShardingRules

    class _Mesh:
        shape = mesh_shape

    cfg = get_config(arch)
    specs = jax.tree.leaves(params_sharding(cfg, ShardingRules(_Mesh())),
                            is_leaf=lambda x: isinstance(x, P))
    total = 0
    for sds, spec in zip(jax.tree.leaves(params_struct(cfg)), specs):
        n = 1
        for dim, entry in zip(sds.shape, tuple(spec) + (None,) * 8):
            parts = 1
            for a in ((entry,) if isinstance(entry, str) else (entry or ())):
                parts *= mesh_shape[a]
            n *= dim // parts
        total += n * sds.dtype.itemsize
    return total


def test_one_dry_run_cell_in_a_child(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"),
         env.get("PYTHONPATH", "")])
    out = tmp_path / "dry"
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", "xlstm-125m", "--shape", "train_4k",
                    "--mesh", "single", "--out", str(out), "--save-ops"],
                   check=True, env=env, timeout=240, capture_output=True)
    rec = json.loads((out / "xlstm-125m_train_4k_16x16.json").read_text())
    assert "error" not in rec, rec.get("traceback")
    assert rec["kind"] == "train" and rec["microbatches"] == 1
    assert rec["memory"]["params_bytes"] == _ref_param_bytes(
        "xlstm-125m", {"data": 16, "model": 16})
    mem = rec["memory"]
    assert mem["fits"] and mem["peak_bytes"] <= 80e9
    assert mem["temp_peak_bytes"] > 0
    assert mem["peak_bytes"] == mem["total_bytes"] + mem["temp_peak_bytes"]
    assert rec["roofline"]["flops"] > rec["model_flops_per_device"] > 0
    assert rec["roofline"]["collective_bytes"] > 0
    assert json.loads((out / "xlstm-125m_train_4k_16x16.ops.json")
                      .read_text())["aten.mm"] > 0


def _allocator_peak(fn):
    """The CPU allocator's own record of ``fn()``: the most bytes its
    allocations held at once, from the profiler's allocation events in
    time order (relative to the call's start)."""
    from torch._C._profiler import _EventType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as p:
        fn()
    sizes = []

    def walk(node):
        if node.tag == _EventType.Allocation:
            sizes.append((node.start_time_ns, node.extra_fields.alloc_size))
        for child in node.children:
            walk(child)
    for root in p.profiler.kineto_results.experimental_event_tree():
        walk(root)
    live = peak = 0
    for _, n in sorted(sizes):
        live += n
        peak = max(peak, live)
    return peak


@pytest.mark.parametrize("remat", ["none", "full"])
def test_live_bytes_tally_matches_the_allocator(remat):
    """``analyze_step``'s peak of the step's own live bytes against the
    CPU allocator's record of the same train step on real tensors (a
    float32 qwen smoke model, batch 4 x 64): within 2 % (the allocator
    also sees an operation's internal scratch, which the tally cannot)."""
    from repro_torch.models import steps
    from repro_torch.optim import AdamWConfig, warmup_cosine
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-14b"),
                              param_dtype="float32", compute_dtype="float32",
                              remat=remat)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 64)))}
    step = steps.make_train_step(cfg, warmup_cosine(1e-3, 1, 10),
                                 AdamWConfig())
    with torch.enable_grad():
        _, rep = rl.analyze_step(
            step, steps.init_train_state(cfg, seed=0, device="cpu"), batch)
    state = steps.init_train_state(cfg, seed=0, device="cpu")
    want = _allocator_peak(lambda: step(state, batch))
    assert abs(rep.temp_peak_bytes - want) <= 0.02 * want, \
        (rep.temp_peak_bytes, want)


def test_full_remat_lowers_the_train_steps_peak():
    """``remat="full"`` keeps only each layer's input for the backward:
    the train step's peak of live bytes, as the dry run tallies it, falls
    (a 4-layer qwen smoke model, batch 8 x 256)."""
    from repro_torch.models import steps
    from repro_torch.optim import AdamWConfig, warmup_cosine
    peaks = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(get_smoke_config("qwen2.5-14b"),
                                  n_layers=4, remat=remat)
        step = steps.make_train_step(cfg, warmup_cosine(1e-3, 1, 10),
                                     AdamWConfig())
        state = steps.init_train_state(cfg, seed=0, device="cpu")
        batch = {"tokens": torch.zeros((8, 256), dtype=torch.int64)}
        with torch.enable_grad():
            _, rep = rl.analyze_step(step, state, batch)
        peaks[remat] = rep.temp_peak_bytes
    assert 0 < peaks["full"] < 0.75 * peaks["none"], peaks
