"""The port's sharded plans vs the unsharded ones and the reference, on
the CPU: the twin of ``tests/test_sharded.py`` (and of
``tests/test_hier.py::test_hier_sharded_multi_device``).

The reference proves sharded output equal to unsharded in a child process
with 8 forced host devices.  Torch has no such switch: the port's test
hook ``repro_torch.launch.mesh.forced_devices(8, "cpu")`` makes the CPU
count 8 devices, all the CPU itself, so a plan built under it runs 8
shards as row-tile ranges on one device.  Sharded plans (search, range,
hierarchical, and after ``update_rows``) are held bit-identical to the
port's unsharded plans (indices and values; eucl too, since a shard runs
the same arithmetic on its tiles), to the reference's unsharded plans on
the same numpy inputs (integer metrics bit for bit, eucl to the stated
tolerance), and in two cases to the reference's own sharded plans, run in
a child process under 8 forced host devices as ``tests/test_sharded.py``
runs its child (``python tests/test_torch_sharded.py --child``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

DEVICES = 8
#: the cases the reference's sharded child computes: (metric, largest, n)
CHILD_CASES = (("hamming", False, 23), ("eucl", False, 137))
CHILD_SHAPE = dict(m=9, dim=100, k=6)


def _child_main(out_path: str) -> int:
    """Reference sharded plans under 8 forced host devices: writes the
    CHILD_CASES' inputs and results to ``out_path`` (npz)."""
    import jax

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(os.path.dirname(here), "src"))
    sys.path.insert(0, here)
    from repro.core import ArchSpec, get_plan
    from test_engine import _data, _sim_module

    assert jax.device_count() == DEVICES, jax.device_count()
    rng = np.random.default_rng(7)
    out = {}
    for c, (metric, largest, n) in enumerate(CHILD_CASES):
        m, dim, k = CHILD_SHAPE["m"], CHILD_SHAPE["dim"], CHILD_SHAPE["k"]
        mod = _sim_module(metric, k, largest, m, n, dim,
                          ArchSpec(rows=16, cols=32))
        plan = get_plan(mod, shards=DEVICES)
        assert plan.shards == DEVICES
        q, p = _data(rng, metric, m, n, dim)
        v, i = plan.execute(q, p)
        out.update({f"q{c}": q, f"p{c}": p, f"v{c}": np.asarray(v),
                    f"i{c}": np.asarray(i)})
    np.savez(out_path, **out)
    print("SHARDED-CHILD-OK")
    return 0


if __name__ == "__main__" and "--child" in sys.argv:
    os.environ.setdefault(
        "XLA_FLAGS", f"--xla_force_host_platform_device_count={DEVICES}")
    raise SystemExit(_child_main(sys.argv[sys.argv.index("--child") + 1]))

import repro.core as R                                   # noqa: E402
import repro_torch.core as T                             # noqa: E402
from repro.core import cim_dialect as rcd                # noqa: E402
from repro_torch.core import cim_dialect as tcd          # noqa: E402
from repro_torch.core.engine import get_hierarchical_plan as t_hier  # noqa
from repro_torch.core.engine import module_for_spec      # noqa: E402
from repro_torch.core.executor import execute_module     # noqa: E402
from repro_torch.faults import HardenedPlan              # noqa: E402
from repro_torch.launch.mesh import (device_count, forced_devices,  # noqa
                                     make_data_mesh)
from repro_torch.serving import CamSearchServer          # noqa: E402
from test_engine import _data                            # noqa: E402
from test_torch_kernels import _assert_eucl_close        # noqa: E402
from test_torch_range import interval_data, range_module  # noqa: E402
from test_torch_update_rows import sim_module            # noqa: E402

ARCH = dict(rows=16, cols=32)
METRICS = (("hamming", False), ("dot", False), ("cos", True),
           ("eucl", False))
#: 137 and 23 do not divide over 8 shards (23 < 8 tiles leaves shards
#: all padding), 64 is aligned, and n = 5 < k shows the losing slots
SIZES = (137, 64, 23, 5)


def _modules(metric, largest, m, n, dim, k):
    return (sim_module(R, rcd, metric, k, largest, m, n, dim,
                       R.ArchSpec(**ARCH)),
            sim_module(T, tcd, metric, k, largest, m, n, dim,
                       T.ArchSpec(**ARCH)))


def _sharded(build, n=DEVICES):
    """A plan built under ``n`` stand-in CPU devices."""
    with forced_devices(n, "cpu"):
        return build()


def _np(out):
    return tuple(x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                 for x in out)


def _assert_equal(a, b, msg=""):
    for x, y in zip(_np(a), _np(b)):
        np.testing.assert_array_equal(x, y, err_msg=msg)


def _assert_reference(metric, q, p, ref, port, msg=""):
    rv, ri = _np(ref)
    pv, pi = _np(port)
    if metric == "eucl":
        _assert_eucl_close(q, p, rv, ri, pv, pi)
    else:
        np.testing.assert_array_equal(pi, ri, err_msg=msg)
        np.testing.assert_array_equal(pv, rv, err_msg=msg)


# ---------------------------------------------------------------------------
# clamping and refusals (tests/test_sharded.py::test_shards_clamp_...)
# ---------------------------------------------------------------------------


def test_shards_clamp_to_single_device(rng):
    """On the CPU (one device) a shard request is the unsharded plan
    (the same cache entry as ``shards=1``), equal to the interpreter and
    to the reference's clamped plan; the ``"cuda"`` backend refuses it on
    the requested count, naming ``"torch"``."""
    rmod, mod = _modules("dot", False, 6, 30, 64, 3)
    T.clear_plan_cache()
    with pytest.raises(ValueError, match="'torch' backend"):
        T.get_plan(mod, backend="cuda", shards=8, device="cpu")
    plan = T.get_plan(mod, backend="torch", shards=8, device="cpu")
    assert plan.shards == 1
    assert plan is T.get_plan(mod, backend="torch", shards=1, device="cpu")
    assert plan is T.get_plan(mod, backend="torch", device="cpu")
    rplan = R.get_plan(rmod, shards=8)
    assert rplan.shards == 1
    q, p = _data(rng, "dot", 6, 30, 64)
    got = plan.execute(q, p)
    _assert_equal(got, execute_module(mod, q, p, backend="torch",
                                      device="cpu"))
    _assert_reference("dot", q, p, rplan.execute(q, p), got)


def test_mesh_helpers():
    assert device_count("cpu") == 1
    assert make_data_mesh(8, "cpu") == [torch.device("cpu")]
    with forced_devices(4, "cpu") as mesh:
        assert mesh == [torch.device("cpu")] * 4
        assert device_count("cpu") == 4
        assert make_data_mesh(0, "cpu") == mesh
        assert len(make_data_mesh(16, "cpu")) == 4       # clamps
        assert len(make_data_mesh(3, "cpu")) == 3
        with pytest.raises(RuntimeError, match="already active"):
            with forced_devices(2, "cpu"):
                pass
    assert device_count("cpu") == 1
    if not torch.cuda.is_available():
        assert device_count("cuda") == 0


def test_clamp_and_key_under_the_hook(rng):
    """Requests beyond the stand-in count clamp and share the clamped
    key; the ``"cuda"`` refusal holds whatever the count; ``compile_fn``
    carries ``shards`` to the plan."""
    _, mod = _modules("eucl", False, 8, 40, 64, 3)
    T.clear_plan_cache()
    with forced_devices(DEVICES, "cpu"):
        p16 = T.get_plan(mod, backend="torch", shards=16, device="cpu")
        p8 = T.get_plan(mod, backend="torch", shards=DEVICES, device="cpu")
        with pytest.raises(ValueError, match="'torch' backend"):
            T.get_plan(mod, backend="cuda", shards=DEVICES, device="cpu")

        def knn(q, g):
            diff = q.unsqueeze(1).sub(g)
            return diff.norm(p=2, dim=-1).topk(5, largest=False)

        q = rng.standard_normal((12, 96)).astype(np.float32)
        g = rng.standard_normal((137, 96)).astype(np.float32)
        prog1 = T.compile_fn(knn, [q, g], T.ArchSpec(**ARCH),
                             backend="torch", device="cpu")
        prog8 = T.compile_fn(knn, [q, g], T.ArchSpec(**ARCH),
                             backend="torch", shards=DEVICES, device="cpu")
    assert p16.shards == DEVICES and p16 is p8
    assert prog8.shards == DEVICES and prog8.engine_plan.shards == DEVICES
    _assert_equal(prog1(q, g), prog8(q, g))


# ---------------------------------------------------------------------------
# the parity matrix (tests/test_sharded.py's child, here in process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("metric,largest", METRICS)
def test_sharded_plan_parity_multi_device(metric, largest, n, rng):
    """8 shards equal the unsharded plan bit for bit (values and
    indices), the interpreter, and the reference's plan; a sharded
    ``update_rows`` touching rows in several shards lands each tile on
    its owning shard and equals a fresh prepare."""
    m, dim, k = 9, 100, 6
    rmod, mod = _modules(metric, largest, m, n, dim, k)
    single = T.get_plan(mod, backend="torch", device="cpu")
    sharded = _sharded(lambda: T.get_plan(mod, backend="torch",
                                          shards=DEVICES, device="cpu"))
    assert sharded.shards == DEVICES and sharded is not single
    q, p = _data(rng, metric, m, n, dim)
    got = sharded.execute(q, p)
    _assert_equal(got, single.execute(q, p), f"{metric} n={n}")
    _, ii = execute_module(mod, q, p, backend="torch", device="cpu")
    np.testing.assert_array_equal(got[1].numpy(), ii.numpy())
    _assert_reference(metric, q, p, R.get_plan(rmod).execute(q, p), got)

    g = torch.from_numpy(p.copy())
    sharded.execute(q, g)
    idx = np.unique(np.r_[0, n - 1, rng.choice(n, min(n, 4),
                                               replace=False)])
    new = _data(rng, metric, 1, idx.size, dim)[1]
    g2 = sharded.update_rows(g, idx, new)
    assert sharded.row_update_fallbacks == 0
    _assert_equal(sharded.execute(q, g2), single.execute(q, g2.clone()),
                  f"after update_rows: {metric} n={n}")
    g3 = sharded.update_rows(g2, idx[:1], new[:1] * 0, donate=True)
    assert g3 is g2 and sharded.row_update_fallbacks == 0
    _assert_equal(sharded.execute(q, g3), single.execute(q, g3.clone()))


def test_sharded_plans_match_the_reference_child(tmp_path):
    """The reference's own sharded plans, in a child under 8 forced host
    devices (as ``tests/test_sharded.py`` runs its child), against the
    port's sharded plans on the same inputs."""
    from repro.launch.mesh import forced_host_devices_env

    out = tmp_path / "ref_sharded.npz"
    env = forced_host_devices_env(DEVICES)
    env.pop("REPRO_ENGINE_MAX_CHUNK", None)
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and "SHARDED-CHILD-OK" in res.stdout, (
        f"reference sharded child failed (rc={res.returncode}):\n"
        f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    ref = np.load(out)
    m, dim, k = CHILD_SHAPE["m"], CHILD_SHAPE["dim"], CHILD_SHAPE["k"]
    for c, (metric, largest, n) in enumerate(CHILD_CASES):
        _, mod = _modules(metric, largest, m, n, dim, k)
        plan = _sharded(lambda: T.get_plan(mod, backend="torch",
                                           shards=DEVICES, device="cpu"))
        q, p = ref[f"q{c}"], ref[f"p{c}"]
        _assert_reference(metric, q, p, (ref[f"v{c}"], ref[f"i{c}"]),
                          plan.execute(q, p), f"{metric} n={n}")


# ---------------------------------------------------------------------------
# range plans: match blocks concatenate in shard order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["interval", "hamming", "eucl"])
def test_sharded_range_plan_parity(mode, rng):
    m, n, dim = 7, 150, 24
    arch = dict(arch=T.ArchSpec(rows=16, cols=16))
    if mode == "interval":
        mod = range_module(T, tcd, m, n, dim, interval=True, **arch)
        rmod = range_module(R, rcd, m, n, dim, interval=True,
                            arch=R.ArchSpec(rows=16, cols=16))
        q, lo, hi = interval_data(rng, m, n, dim)
        stored = (lo, hi)
    else:
        tau = 9.0 if mode == "hamming" else 40.0
        mod = range_module(T, tcd, m, n, dim, metric=mode, tau=tau, **arch)
        rmod = range_module(R, rcd, m, n, dim, metric=mode, tau=tau,
                            arch=R.ArchSpec(rows=16, cols=16))
        q, p = _data(rng, mode, m, n, dim)
        stored = (p,)
    single = T.get_plan(mod, backend="torch", device="cpu")
    sharded = _sharded(lambda: T.get_plan(mod, backend="torch",
                                          shards=DEVICES, device="cpu"))
    assert sharded.shards == DEVICES
    got = sharded.execute(q, *stored)
    assert got.dtype == torch.bool and got.shape == (m, n)
    assert torch.equal(got, single.execute(q, *stored))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(R.get_plan(rmod).execute(
                                      q, *stored)))
    src = tuple(torch.from_numpy(s.copy()) for s in stored)
    sharded.execute(q, *src)
    idx = np.array([1, 70, n - 1])
    new = tuple(s[[5, 6, 7]] for s in stored)
    upd = sharded.update_rows(src if len(src) == 2 else src[0], idx,
                              new if len(new) == 2 else new[0])
    upd = upd if isinstance(upd, tuple) else (upd,)
    assert sharded.row_update_fallbacks == 0
    assert torch.equal(sharded.execute(q, *upd),
                       single.execute(q, *(u.clone() for u in upd)))


# ---------------------------------------------------------------------------
# hierarchical plans (tests/test_hier.py::test_hier_sharded_multi_device)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", (137, 192, 61))
@pytest.mark.parametrize("metric,largest", (("hamming", False),
                                            ("dot", True), ("cos", False),
                                            ("eucl", False)))
def test_hier_sharded_multi_device(metric, largest, n, rng):
    """Sharded nprobe = all equals the flat plan (and the reference's
    flat plan); sharded partial nprobe equals the unsharded hierarchical
    plan: the shard split never changes a result."""
    m, dim, k = 7, 64, 5
    rmod, mod = _modules(metric, largest, m, n, dim, k)
    q, p = _data(rng, metric, m, n, dim)
    flat = T.get_plan(mod, backend="torch", device="cpu")
    fr = flat.execute(q, p)
    hs = _sharded(lambda: t_hier(mod, clusters=6, nprobe=6, shards=DEVICES,
                                 device="cpu"))
    assert hs.shards == DEVICES
    got = hs.execute(q, p)
    np.testing.assert_array_equal(got[1].numpy(), fr[1].numpy())
    if metric == "eucl":
        _assert_eucl_close(q, p, fr[0].numpy(), fr[1].numpy(),
                           got[0].numpy(), got[1].numpy())
    else:
        np.testing.assert_array_equal(got[0].numpy(), fr[0].numpy())
        _assert_reference(metric, q, p, R.get_plan(rmod).execute(q, p),
                          got)
    h1 = t_hier(mod, clusters=6, nprobe=2, device="cpu")
    h8 = _sharded(lambda: t_hier(mod, clusters=6, nprobe=2, shards=DEVICES,
                                 device="cpu"))
    _assert_equal(h8.execute(q, p), h1.execute(q, p), f"{metric} n={n}")


@pytest.mark.parametrize("donate", [False, True])
def test_hier_sharded_update_rows(donate, rng):
    """A sharded ``update_rows`` keeps nprobe = all equal to the flat
    plan, and an overflow re-layout equals a fresh sharded layout."""
    metric, m, n, dim, k = "hamming", 6, 160, 64, 4
    _, mod = _modules(metric, False, m, n, dim, k)
    q, p = _data(rng, metric, m, n, dim)
    hs = _sharded(lambda: t_hier(mod, clusters=5, nprobe=5, shards=DEVICES,
                                 device="cpu"))
    flat = T.get_plan(mod, backend="torch", device="cpu")
    g = torch.from_numpy(p.copy())
    hs.execute(q, g)
    idx = np.asarray([0, 3, 64, 121])
    new = (rng.random((4, dim)) > 0.5).astype(np.float32)
    g2 = hs.update_rows(g, idx, new, donate=donate)
    assert (g2 is g) == donate and hs.row_update_fallbacks == 0
    _assert_equal(hs.execute(q, g2), flat.execute(q, g2.clone()))
    # overflow: many rows copied from one pass its cluster's capacity
    many = np.arange(40, 120)
    g3 = hs.update_rows(g2, many, np.repeat(new[:1], many.size, 0),
                        donate=donate)
    _assert_equal(hs.execute(q, g3), flat.execute(q, g3.clone()))
    assert hs.row_update_fallbacks == 0


# ---------------------------------------------------------------------------
# hardening and serving over a sharded plan
# ---------------------------------------------------------------------------


def test_hardened_plan_inherits_or_overrides_shards(rng):
    """``HardenedPlan(shards=)``: inherited from a sharded plan, or
    overridden; the hardened search is the same either way."""
    _, mod = _modules("hamming", False, 5, 60, 32, 3)
    q, p = _data(rng, "hamming", 5, 60, 32)
    with forced_devices(DEVICES, "cpu"):
        plan = T.get_plan(mod, backend="torch", shards=DEVICES, device="cpu")
        inherit = HardenedPlan(plan, replicas=3, spares=4)
        single = HardenedPlan(plan, replicas=3, spares=4, shards=1)
        four = HardenedPlan(plan, replicas=3, spares=4, shards=4)
    assert inherit.plan.shards == DEVICES
    assert single.plan.shards == 1 and four.plan.shards == 4
    for h in (inherit, single, four):
        h.prepare(p)
    want = single.execute(q)
    for h in (inherit, four):
        got = h.execute(q)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert (inherit.plan.spec.n, inherit.plan.spec.k) == (3 * 60 + 4,
                                                          3 * 3 + 4)


def test_served_sharded_plan_has_the_single_device_level(rng):
    """A sharded primary served on the CPU degrades first to the exact
    unsharded plan (``"torch-single"``), the reference's
    ``"jnp-single"``; served results equal the direct call."""
    _, mod = _modules("dot", False, 6, 90, 32, 4)
    q, p = _data(rng, "dot", 6, 90, 32)
    with forced_devices(DEVICES, "cpu"):
        plan = T.get_plan(mod, backend="torch", shards=DEVICES, device="cpu")
        fails = {"primary"}

        def injector(level):
            if level in fails:
                raise RuntimeError("primary down")

        srv = CamSearchServer(plan, p, fault_injector=injector)
        with srv:
            levels = [n for n, _ in srv._levels()]
            assert levels[:2] == ["primary", "torch-single"]
            single = dict(srv._levels())["torch-single"]
            assert single.shards == 1
            v, i = srv.search(q, timeout=60)
    want = _np(plan.execute(q, p))
    np.testing.assert_array_equal(i, want[1])
    np.testing.assert_array_equal(v, want[0])
    assert srv.health()["degraded_batches"] >= 1


def test_composite_primary_degrades_to_a_sharded_flat_plan(rng):
    """A sharded hierarchical primary's ``"torch-flat"`` level is the flat
    plan sharded as it is (the reference's ``"jnp-flat"``)."""
    _, mod = _modules("hamming", False, 6, 90, 32, 4)
    q, p = _data(rng, "hamming", 6, 90, 32)
    with forced_devices(DEVICES, "cpu"):
        hs = t_hier(mod, clusters=4, nprobe=4, shards=DEVICES, device="cpu")
        srv = CamSearchServer(hs, p)
        with srv:
            levels = dict(srv._levels())
            assert levels["torch-flat"].shards == DEVICES
            v, i = srv.search(q, timeout=60)
    flat = T.get_plan(module_for_spec(hs.spec), backend="torch",
                      device="cpu")
    _assert_equal((v, i), flat.execute(q, p))
