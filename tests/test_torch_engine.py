"""Port engine vs the reference, end to end on the CPU: compile_fn ->
get_plan -> SearchPlan.execute.  Backend ``"torch"`` is held against the
reference's ``"jnp"`` and ``"cuda"`` (its kernels' plain versions on CPU
tensors) against ``"pallas"`` (interpret mode).  Integer metrics must be
bit-identical; eucl agrees to the tolerance stated in
test_torch_kernels.py, with index swaps only between float64 near-ties.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import cim_dialect as rcd
from repro_torch import convert
from repro_torch.core import cim_dialect as tcd
from repro_torch.core.engine import _pick_batch
from repro_torch.kernels import cam_search as tcs
from test_torch_frontend import hamming_module, hdc_similarity, knn_kernel
from test_torch_kernels import _assert_eucl_close
from test_torch_update_rows import sim_module

PAIRS = [("jnp", "torch"), ("pallas", "cuda")]


def _cos_sim(inp, weight):
    qn = inp.norm(dim=-1, keepdim=True)
    wn = weight.norm(dim=-1, keepdim=True)
    mm = inp.matmul(weight.transpose(-2, -1))
    sim = mm / wn.transpose(-2, -1) / qn
    return sim.topk(4, largest=True)


def _programs(metric, rng, m):
    """(reference program, port program, inputs) for one metric, built
    with the same arch, options and numpy inputs on both sides."""
    ra, ta = R.ArchSpec(rows=16, cols=32), T.ArchSpec(rows=16, cols=32)
    if metric == "eucl":
        q = rng.standard_normal((m, 100)).astype(np.float32)
        g = rng.standard_normal((150, 100)).astype(np.float32)
        return ((lambda **kw: R.compile_fn(knn_kernel, [q, g], ra,
                                           value_bits=8, **kw)),
                (lambda **kw: T.compile_fn(knn_kernel, [q, g], ta,
                                           value_bits=8, **kw)), [q, g])
    if metric in ("dot", "cos"):
        fn = hdc_similarity if metric == "dot" else _cos_sim
        q = (rng.random((m, 300)) > 0.5).astype(np.float32)
        g = (rng.random((90, 300)) > 0.5).astype(np.float32)
        return ((lambda **kw: R.compile_fn(fn, [q, g], ra, **kw)),
                (lambda **kw: T.compile_fn(fn, [q, g], ta, **kw)), [q, g])
    care = metric == "ternary"
    q = (rng.random((m, 50)) > 0.5).astype(np.float32)
    g = (rng.random((77, 50)) > 0.5).astype(np.float32)
    ins = [q, g] + ([(rng.random((77, 50)) > 0.2).astype(np.int8)]
                    if care else [])
    return ((lambda **kw: R.compile_module(
                hamming_module(R, rcd, m, 77, 50, 6, care), ra,
                value_bits=1, **kw)),
            (lambda **kw: T.compile_module(
                hamming_module(T, tcd, m, 77, 50, 6, care), ta,
                value_bits=1, **kw)), ins)


def _assert_results(metric, ins, ref, port):
    rv, ri = np.asarray(ref[0]), np.asarray(ref[1])
    tv, ti = port[0], port[1]
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    assert tuple(tv.shape) == rv.shape and tuple(ti.shape) == ri.shape
    if metric == "eucl":
        _assert_eucl_close(ins[0].reshape(-1, ins[0].shape[-1]), ins[1],
                           rv.reshape(-1, rv.shape[-1]),
                           ri.reshape(-1, ri.shape[-1]),
                           tv.reshape(-1, tv.shape[-1]).numpy(),
                           ti.reshape(-1, ti.shape[-1]).numpy())
    else:
        assert np.array_equal(tv.numpy(), rv)
        assert np.array_equal(ti.numpy(), ri)


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
@pytest.mark.parametrize("metric", ["eucl", "hamming", "dot", "cos",
                                    "ternary"])
def test_compile_fn_matches_reference(metric, ref_backend, backend, rng):
    rprog, tprog, ins = _programs(metric, rng, 21)
    rp = rprog(backend=ref_backend)
    tp = tprog(backend=backend, device="cpu")
    assert tp.engine_plan.packed == rp.engine_plan.packed
    assert tp.engine_plan.tiny == rp.engine_plan.tiny
    assert dataclasses.asdict(tp.engine_plan.spec) == \
        dataclasses.asdict(rp.engine_plan.spec)
    _assert_results(metric, ins, rp(*ins), tp(*ins))


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
@pytest.mark.parametrize("m", [5, 8, 21])
def test_micro_batching_runtime_m(m, ref_backend, backend, rng):
    """Runtime M below, at, and not a multiple of the micro-batch (8),
    all different from the traced M (13)."""
    rprog, tprog, ins = _programs("hamming", rng, 13)
    rplan = R.get_plan(rprog().stages["cim_partitioned"],
                       backend=ref_backend, batch=8)
    tplan = T.get_plan(tprog(device="cpu").stages["cim_partitioned"],
                       backend=backend, batch=8, device="cpu")
    q = (rng.random((m, 50)) > 0.5).astype(np.float32)
    before = tplan.chunks_run
    _assert_results("hamming", [q, ins[1]], rplan.execute(q, ins[1]),
                    tplan.execute(q, ins[1]))
    assert tplan.chunks_run - before == -(-m // 8)


def test_lead_dims_and_zero_queries(rng):
    rprog, tprog, ins = _programs("dot", rng, 4)
    rp, tp = rprog(backend="jnp"), tprog(backend="torch", device="cpu")
    q3 = (rng.random((2, 3, 300)) > 0.5).astype(np.float32)
    _assert_results("dot", [q3, ins[1]], rp(q3, ins[1]), tp(q3, ins[1]))
    v, i = tp(np.zeros((0, 300), np.float32), ins[1])
    assert v.shape == (0, 1) and i.dtype == torch.int32


def test_cuda_backend_large_k_window(rng):
    """k above one 128-row window: the cuda backend's plain path widens
    its window and still equals the reference; past ``MAX_K`` no window
    fits and the plan takes the matrix route (chosen by shape), still
    equal to the reference bit for bit."""
    m, n, dim, k = 6, 700, 64, 150
    rm = hamming_module(R, rcd, m, n, dim, k)
    tm = hamming_module(T, tcd, m, n, dim, k)
    arch_r, arch_t = R.ArchSpec(rows=64, cols=64), T.ArchSpec(rows=64, cols=64)
    q = (rng.random((m, dim)) > 0.5).astype(np.float32)
    g = (rng.random((n, dim)) > 0.5).astype(np.float32)
    ref = R.compile_module(rm, arch_r, value_bits=1, backend="jnp")(q, g)
    port = T.compile_module(tm, arch_t, value_bits=1, backend="cuda",
                            device="cpu")(q, g)
    _assert_results("hamming", [q, g], ref, port)
    big = tcs.MAX_K + 1
    assert tcs.packed_route(m, n, big, 132) == "matrix"
    ref = R.compile_module(hamming_module(R, rcd, m, n, dim, big), arch_r,
                           value_bits=1, backend="jnp")(q, g)
    port = T.compile_module(hamming_module(T, tcd, m, n, dim, big), arch_t,
                            value_bits=1, device="cpu")(q, g)
    assert port[1].shape == (m, big)
    _assert_results("hamming", [q, g], ref, port)


@pytest.mark.parametrize("metric,pack", [
    ("eucl", None), ("hamming", None), ("hamming", False), ("dot", None),
    ("dot", False), ("ternary", None)])
def test_cuda_matrix_route_matches_reference(metric, pack, rng):
    """k = 400 (> MAX_K) on the ``"cuda"`` backend: the distance kernel's
    matrix and one (value, lowest row id) selection, packed or not (a
    ternary search on the cuda backend is packed), against the
    reference's ``"jnp"`` plan: bit-identical on the integer metrics,
    eucl within its tolerance with near-tie swaps only."""
    m, n, dim, k = 5, 600, 40, 400
    if metric == "eucl":
        q = rng.standard_normal((m, dim)).astype(np.float32)
        g = rng.standard_normal((n, dim)).astype(np.float32)
    else:
        q = (rng.random((m, dim)) > 0.5).astype(np.float32)
        g = (rng.random((n, dim)) > 0.5).astype(np.float32)
    ins = [q, g]
    if metric == "ternary":
        ins.append((rng.random((n, dim)) > 0.2).astype(np.int8))
    rmod = sim_module(R, rcd, "hamming" if metric == "ternary" else metric,
                      k, metric == "dot", m, n, dim,
                      R.ArchSpec(rows=64, cols=64), care=metric == "ternary")
    tmod = sim_module(T, tcd, "hamming" if metric == "ternary" else metric,
                      k, metric == "dot", m, n, dim,
                      T.ArchSpec(rows=64, cols=64), care=metric == "ternary")
    rplan = R.get_plan(rmod, backend="jnp", pack=pack)
    tplan = T.get_plan(tmod, backend="cuda", pack=pack, device="cpu")
    assert tplan.packed == rplan.packed
    assert tcs.float_route(k) == "matrix"
    _assert_results(metric, ins, rplan.execute(*ins), tplan.execute(*ins))
    # the route's row update equals a fresh prepare of the mutated gallery
    gt = torch.from_numpy(g.copy())
    care = torch.from_numpy(ins[2]) if metric == "ternary" else None
    stored = (gt,) if care is None else (gt, care)
    tplan.execute(q, *stored)
    idx = np.array([0, 17, n - 1])
    new = (rng.random((3, dim)) > 0.5).astype(np.float32)
    g2 = tplan.update_rows(gt, idx, new, care=care)
    assert tplan.row_update_fallbacks == 0
    got = tplan.execute(q, g2, *stored[1:])
    want = tplan.execute(q, g2.clone(), *stored[1:])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# plan cache and pattern memo
# ---------------------------------------------------------------------------


def test_plan_cache_hits_and_keys(rng):
    T.clear_plan_cache()
    _, tprog, _ = _programs("eucl", rng, 10)
    p1, p2 = tprog(device="cpu"), tprog(device="cpu")
    assert p1.engine_plan is p2.engine_plan
    stats = T.plan_cache_stats()
    assert stats["hits"] == 1 and stats["misses"] == 1 and stats["plans"] == 1
    p3 = tprog(device="cpu", backend="torch")
    assert p3.engine_plan is not p1.engine_plan
    targets = {id(tprog(device="cpu", target=t).engine_plan)
               for t in ("latency", "power", "density")}
    assert targets == {id(p1.engine_plan)}


def test_pattern_memo_and_in_place_edit(rng):
    _, tprog, ins = _programs("eucl", rng, 10)
    plan = tprog(device="cpu").engine_plan
    q, g = ins
    gt = torch.from_numpy(g.copy())
    h0, m0 = plan.pattern_hits, plan.pattern_misses
    v1, i1 = plan.execute(q, gt)
    plan.execute(q, gt)
    assert (plan.pattern_hits - h0, plan.pattern_misses - m0) == (1, 1)
    gt[int(i1[0, 0])] += 100.0            # in place: same object, new version
    v2, i2 = plan.execute(q, gt)
    assert plan.pattern_misses - m0 == 2
    # the stale layout of the edited gallery was dropped
    assert sum(key[0][0] == id(gt) for key in plan._pattern_cache) == 1
    fresh = plan.execute(q, gt.clone())
    assert torch.equal(v2, fresh[0]) and torch.equal(i2, fresh[1])
    assert i2[0, 0] != i1[0, 0]
    plan.execute(q, g)                    # numpy: prepared every call
    assert plan.pattern_misses - m0 == 4


# ---------------------------------------------------------------------------
# carrying state across
# ---------------------------------------------------------------------------


def test_arch_round_trip():
    for arch in (R.PAPER_BASE_ARCH, R.kazemi_arch(64, bits_per_cell=2),
                 R.ArchSpec(rows=64, cols=128, banks=1024).with_target(
                     "power+density")):
        port = convert.arch_from_reference(arch.to_json())
        assert port.to_json() == arch.to_json()
        assert R.ArchSpec.from_json(port.to_json()) == arch


@pytest.mark.parametrize("metric", ["eucl", "hamming", "ternary"])
def test_prepared_round_trip(metric, rng):
    rprog, tprog, ins = _programs(metric, rng, 10)
    stored = [jnp.asarray(x) for x in ins[1:]]
    for ref_backend, backend in PAIRS:
        rplan = rprog(backend=ref_backend).engine_plan
        tplan = tprog(backend=backend, device="cpu").engine_plan
        arrays = [np.asarray(a) for a in rplan._prepared_patterns(*stored)]
        mine = tplan._prepared_patterns(*(torch.from_numpy(np.asarray(x))
                                          for x in ins[1:]))
        got = convert.prepared_from_reference(
            arrays, packed=rplan.packed, backend=backend, spec=tplan.spec)
        assert len(got) == len(mine)
        for a, b in zip(got, mine):
            assert a.dtype == b.dtype and torch.equal(a, b)
        if backend == "cuda":        # without the spec: equal up to padding
            raw = convert.prepared_from_reference(
                arrays, packed=rplan.packed, backend=backend)
            for a, b in zip(raw, mine):
                rows = min(a.shape[0], b.shape[0])
                cols = min(a.shape[1], b.shape[1])
                assert torch.equal(a[:rows, :cols], b[:rows, :cols])
                assert not a[rows:].any() and not b[rows:].any()


@pytest.mark.parametrize("metric", ["eucl", "hamming", "ternary"])
def test_prepared_round_trip_matrix_route(metric, rng):
    """A ``"pallas"`` plan's prepared operands at k = 400 carried to the
    ``"cuda"`` plan's matrix route (float cells, or packed lanes in rows
    padded to ``PACKED_ROWS``, a ternary's care mask as lanes too) equal
    the port's own prepare, and the plan runs on them."""
    m, n, dim, k = 4, 500, 40, 400
    cell = metric if metric != "ternary" else "hamming"
    if metric == "eucl":
        q = rng.standard_normal((m, dim)).astype(np.float32)
        g = rng.standard_normal((n, dim)).astype(np.float32)
    else:
        q = (rng.random((m, dim)) > 0.5).astype(np.float32)
        g = (rng.random((n, dim)) > 0.5).astype(np.float32)
    stored = [g] + ([(rng.random((n, dim)) > 0.2).astype(np.int8)]
                    if metric == "ternary" else [])
    care = metric == "ternary"
    rplan = R.get_plan(sim_module(R, rcd, cell, k, False, m, n, dim,
                                  R.ArchSpec(rows=64, cols=64), care=care),
                       backend="pallas")
    tplan = T.get_plan(sim_module(T, tcd, cell, k, False, m, n, dim,
                                  T.ArchSpec(rows=64, cols=64), care=care),
                       backend="cuda", device="cpu")
    arrays = [np.asarray(a) for a in rplan._prepared_patterns(
        *(jnp.asarray(x) for x in stored))]
    got = convert.prepared_from_reference(arrays, packed=rplan.packed,
                                          backend="cuda", spec=tplan.spec)
    mine = tplan._prepared_patterns(*(torch.from_numpy(x) for x in stored))
    assert len(got) == len(mine)
    for a, b in zip(got, mine):
        assert a.dtype == b.dtype and torch.equal(a, b)
    want = tplan.execute(q, *stored)
    out = tplan._chunk_fn(torch.from_numpy(q), got)
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


# ---------------------------------------------------------------------------
# refusals and the device contract
# ---------------------------------------------------------------------------


def test_default_device_is_the_gpu(rng):
    _, tprog, _ = _programs("dot", rng, 4)
    if torch.cuda.is_available():
        assert tprog().engine_plan.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tprog()


def test_refusals(rng):
    _, tprog, ins = _programs("ternary", rng, 4)
    with pytest.raises(ValueError, match="packed"):
        tprog(device="cpu", pack=False)
    with pytest.raises(ValueError, match="backend"):
        tprog(device="cpu", backend="jnp")
    # sharding: the "cuda" backend refuses it on the requested count,
    # before clamping, naming "torch" (the reference refuses "pallas");
    # "torch" clamps to this device type's count (one CPU): the
    # unsharded plan, as the reference's clamped plan is
    with pytest.raises(ValueError, match="'torch' backend"):
        tprog(device="cpu", shards=2)
    sh = tprog(device="cpu", backend="torch", shards=2)
    assert sh.engine_plan.shards == 1 and sh.shards == 1
    assert sh.engine_plan is tprog(device="cpu", backend="torch").engine_plan
    prog = tprog(device="cpu")
    with pytest.raises(TypeError, match="FaultModel"):   # not a model
        prog.engine_plan.execute(*ins, faults=object())
    with pytest.raises(ValueError, match="binary"):
        prog(ins[0] * 2, *ins[1:])
    add = T.compile_fn(lambda a, b: a.add(b), [(8, 8), (8, 8)],
                       T.ArchSpec(rows=16, cols=16), device="cpu")
    assert add.engine_plan is None
    # no engine plan: the IR interpreter runs it (it refuses unknown
    # backends and, without CUDA, the default device)
    ones = np.ones((8, 8), np.float32)
    for call in (add, add.execute_interpreted, add.execute_unplanned):
        assert torch.equal(call(ones, ones)[0], torch.full((8, 8), 2.0))
    from repro_torch.core.executor import execute_module
    with pytest.raises(ValueError, match="backend"):
        execute_module(add.stages["cim_partitioned"], ones, ones,
                       backend="pallas", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            execute_module(add.stages["cim_partitioned"], ones, ones)


def test_pick_batch_matches_reference(monkeypatch):
    from repro.core.engine import _pick_batch as ref_pick
    for cap in ("1000", "1024", "6"):
        monkeypatch.setenv("REPRO_ENGINE_MAX_CHUNK", cap)
        for m in (0, 1, 3, 9, 600, 624, 5000):
            assert _pick_batch(m) == ref_pick(m)


def test_import_loads_neither_jax_nor_repro():
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    __import__(m.name)\n"
            "for m in ('repro_torch.forest.forest', "
            "'repro_torch.core.executor', 'repro_torch.kernels.acam', "
            "'repro_torch.hdc', 'repro_torch.hdc.classifier', "
            "'repro_torch.kernels.hdc_encode', 'repro_torch.models.model', "
            "'repro_torch.launch.serve', 'repro_torch.configs', "
            "'repro_torch.kernels.flash_attention'):\n"
            "    assert m in sys.modules, m\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len([n for n in sys.modules if n.startswith('repro_torch')]),"
            " bad)\n")
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) > 20 and bad.strip() == "[]"
