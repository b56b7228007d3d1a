"""The port's hierarchical two-stage plans vs the reference, on the CPU.

Twins of ``tests/test_hier.py``'s single-device tests, with the same
numpy inputs fed to both packages: at ``nprobe == clusters`` the port's
hierarchical plan equals its own flat plan and the reference's
hierarchical plan (hamming / dot / cos bit-identical, packed and
unpacked; eucl within the stated tolerance, index swaps only between
float64 near-ties); recall is monotone in ``nprobe`` and equal to the
reference's at every ``nprobe``; ``update_rows`` reassigns rows to the
stored centroids incrementally and equals a fresh layout with the same
centroids, after an overflow re-layout too; the plan serves, with the
exact flat search (``"torch-flat"``) first in the CPU degraded chain.
k-means centroids and assignments equal the reference's bit for bit for
the packable metrics; for eucl, assignments differ only at float64
near-ties between two centroids.

Also here: the hierarchical parts of ``tests/test_plan_cache_keys.py``
and ``tests/test_env.py::test_hier_nprobe_strict_and_applied``.
``tests/test_hier.py::test_hier_sharded_multi_device`` is twinned in
``tests/test_torch_sharded.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.engine import get_hierarchical_plan as r_hier
from repro.core.engine import hier as rh
from repro_torch.core.engine import get_hierarchical_plan as t_hier
from repro_torch.core.engine import hier as th
from test_engine import _data, _sim_module
from test_torch_kernels import _assert_eucl_close
from test_torch_parity_fuzz import _port_module


def _modules(metric, k, largest, m, n, dim, rows=16, cols=32, unroll=64):
    """(reference module, port module) of one fused similarity program
    through each package's partition pass."""
    case = dict(m=m, n=n, dim=dim, k=k, metric=metric, largest=largest,
                care=False, unroll=unroll, rows=rows, cols=cols)
    return (_sim_module(metric, k, largest, m, n, dim,
                        R.ArchSpec(rows=rows, cols=cols),
                        unroll_limit=unroll),
            _port_module(case))


def _np(out):
    return tuple(x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                 for x in out)


def _assert_same(metric, q, p, got, want, msg=""):
    gv, gi = _np(got)
    wv, wi = _np(want)
    assert gv.shape == wv.shape and gi.shape == wi.shape, msg
    if metric == "eucl":
        _assert_eucl_close(q, p, wv, wi, gv, gi)
        return
    np.testing.assert_array_equal(gi, wi, err_msg=f"indices {msg}")
    np.testing.assert_array_equal(gv, wv, err_msg=f"values {msg}")


def _recall(hi, flat_sets, k):
    return float(np.mean([len(set(map(int, row)) & fs) / k
                          for row, fs in zip(hi, flat_sets)]))


def _state(plan, g):
    """The plan's memoised :class:`~repro_torch.core.engine.hier.HierState`
    of gallery tensor ``g`` (a memo hit)."""
    return plan._prepared_patterns(g)


# ---------------------------------------------------------------------------
# the reference's single-device contracts, twinned
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric,largest", [
    ("hamming", False), ("dot", True), ("dot", False), ("cos", True),
    ("eucl", False)])
@pytest.mark.parametrize("pack", [None, False])
def test_nprobe_all_bit_identical_to_flat(metric, largest, pack, rng):
    """Probing every cluster equals the port's flat plan and the
    reference's hierarchical plan."""
    m, n, dim, k = 7, 96, 64, 6
    rmod, tmod = _modules(metric, k, largest, m, n, dim)
    q, p = _data(rng, metric, m, n, dim)
    flat = T.get_plan(tmod, backend="torch", pack=pack, device="cpu")
    hier = t_hier(tmod, clusters=6, nprobe=6, pack=pack, device="cpu")
    ref = r_hier(rmod, clusters=6, nprobe=6, pack=pack)
    assert hier.family == "hierarchical" and hier.packed == ref.packed
    assert hier.spec.nprobe == hier.spec.clusters == 6
    assert dataclasses.asdict(hier.spec) == dataclasses.asdict(ref.spec)
    got = hier.execute(q, p)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    what = f"{metric} largest={largest} pack={pack}"
    _assert_same(metric, q, p, got, flat.execute(q, p), f"flat {what}")
    _assert_same(metric, q, p, got, ref.execute(q, p), f"reference {what}")


def test_recall_monotone_and_partial_probe_cost(rng):
    """Recall grows monotonically in nprobe, hits 1.0 at nprobe=all and
    equals the reference's at every nprobe (the same indices); the
    composite accounts the work to itself, not the coarse stage."""
    m, n, dim, k = 16, 256, 32, 8
    rmod, tmod = _modules("hamming", k, False, m, n, dim)
    q, p = _data(rng, "hamming", m, n, dim)
    _, fi = _np(T.get_plan(tmod, backend="torch", device="cpu")
                .execute(q, p))
    flat_sets = [set(map(int, row)) for row in fi]
    recalls = []
    for nprobe in (1, 2, 4, 8):
        hp = t_hier(tmod, clusters=8, nprobe=nprobe, device="cpu")
        got = hp.execute(q, p)
        _assert_same("hamming", q, p, got,
                     r_hier(rmod, clusters=8, nprobe=nprobe).execute(q, p),
                     f"nprobe={nprobe}")
        recalls.append(_recall(_np(got)[1], flat_sets, k))
    assert all(a <= b + 1e-9 for a, b in zip(recalls, recalls[1:])), recalls
    assert recalls[-1] == 1.0, recalls

    stats = hp.graph_stats()
    assert stats["family"] == "hierarchical"
    assert stats["executions"] >= 1
    assert stats["stage0:search"]["executions"] == 0
    assert hp.coarse is hp.stages[0] and hp.coarse.device == hp.device


def test_factory_contracts(rng):
    """get_hierarchical_plan mirrors get_plan's front door: None for
    non-similarity programs, errors for unsupported axes, clamped
    clustering parameters, the GPU unless the caller asks for the CPU."""
    from test_torch_range import range_module
    from repro_torch.core import cim_dialect as tcd

    _, mod = _modules("hamming", 3, False, 4, 64, 32)
    ew = T.compile_fn(lambda a, b: a.add(b), [(8, 8), (8, 8)],
                      T.ArchSpec(rows=16, cols=16), device="cpu")
    assert t_hier(ew.stages["cim_partitioned"], device="cpu") is None
    assert t_hier(range_module(T, tcd, 4, 16, 32), device="cpu") is None
    # unsupported axes raise instead of silently degrading
    with pytest.raises(ValueError, match="'torch' backend"):
        t_hier(mod, backend="cuda", device="cpu")
    # a shard request clamps to this device type's count (one CPU): the
    # unsharded plan, as the reference's clamped plan is
    one = t_hier(mod, shards=2, device="cpu")
    assert one.shards == 1 and one is t_hier(mod, device="cpu")
    tern = _port_module(dict(m=4, n=64, dim=32, k=3, metric="hamming",
                             largest=False, care=True, unroll=64, rows=16,
                             cols=32))
    with pytest.raises(ValueError, match="ternary"):
        t_hier(tern, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_hier(mod)
    # clustering parameters clamp into valid range
    p = t_hier(mod, clusters=1000, nprobe=4000, device="cpu")
    assert p.spec.clusters <= 64 and p.spec.nprobe <= p.spec.clusters
    # defaults: ~sqrt(n) clusters, nprobe >= 1 — the reference's
    d = t_hier(mod, device="cpu")
    assert 1 <= d.spec.nprobe <= d.spec.clusters <= 64
    rmod, _ = _modules("hamming", 3, False, 4, 64, 32)
    assert dataclasses.asdict(d.spec) == dataclasses.asdict(
        r_hier(rmod).spec)
    # a spec, or a HierarchicalSpec whose fields are the defaults
    assert t_hier(d.spec, device="cpu") is d
    assert t_hier(d.spec.fine, device="cpu") is d


def test_update_rows_incremental_and_overflow(rng):
    """Incremental reassignment keeps nprobe=all parity with the flat
    plan through same-cluster rewrites, cross-cluster moves, and a
    cluster overflow that forces the full re-layout (same centroids);
    each updated layout equals a fresh layout of the mutated gallery
    with the same centroids."""
    m, n, dim, k = 8, 192, 32, 5
    _, mod = _modules("hamming", k, False, m, n, dim)
    q, p = _data(rng, "hamming", m, n, dim)
    flat = T.get_plan(mod, backend="torch", device="cpu")
    hier = t_hier(mod, clusters=6, nprobe=6, device="cpu")
    part = t_hier(mod, clusters=6, nprobe=2, device="cpu")

    g = torch.from_numpy(p)
    hier.execute(q, g)
    gp = g.clone()
    part.execute(q, gp)
    cent = _state(part, gp).centroid_src
    assign = _state(part, gp).assign.copy()
    for step in range(3):
        idx = np.sort(rng.choice(n, size=9, replace=False))
        new = (rng.random((9, dim)) > 0.5).astype(np.float32)
        g = hier.update_rows(g, idx, new)
        _assert_same("hamming", q, p, hier.execute(q, g),
                     flat.execute(q, g), f"update step {step}")
        gp = part.update_rows(gp, idx, new)
        assign[idx] = th._assign_rows(torch.from_numpy(new), cent, "hamming")
        hs = _state(part, gp)
        np.testing.assert_array_equal(hs.assign, assign)
        _assert_same("hamming", q, p, part.execute(q, gp),
                     part._chunk_fn(torch.from_numpy(q),
                                    _fresh_layout(part, hs, gp, assign)),
                     f"partial nprobe, fresh layout, step {step}")
    assert hier.row_update_fallbacks == 0 and part.row_update_fallbacks == 0

    # overflow: clone one row's content everywhere -> every row lands in
    # one cluster, which cannot fit its tile group -> full re-layout
    # with the *same* centroids, still flat-identical
    idx = np.arange(128)
    new = np.tile(g.numpy()[n - 1], (128, 1))
    tpc = _state(hier, g).tpc
    g2 = hier.update_rows(g, idx, new)
    assert _state(hier, g2).tpc > tpc
    assert _state(hier, g2).centroid_src is _state(hier, g).centroid_src
    _assert_same("hamming", q, p, hier.execute(q, g2), flat.execute(q, g2),
                 "overflow re-layout")
    gp2 = part.update_rows(gp, idx, new)
    assign[idx] = th._assign_rows(torch.from_numpy(new), cent, "hamming")
    hs = _state(part, gp2)
    _assert_same("hamming", q, p, part.execute(q, gp2),
                 part._chunk_fn(torch.from_numpy(q),
                                _fresh_layout(part, hs, gp2, assign)),
                 "overflow, fresh layout")
    assert hier.row_update_fallbacks == 0


def _fresh_layout(plan, hs, gallery, assign):
    """The state a full layout builds for ``assign`` with ``hs``'s
    centroids (no k-means)."""
    return th._hier_state(plan.spec, plan.packed, gallery, hs.centroid_src,
                          hs.coarse_prepared, assign)


@pytest.mark.parametrize("donate", [False, True])
def test_update_schedule_invariance(donate, rng):
    """Placement invariance: two update schedules reaching the same
    gallery content give bit-identical results at a *partial* nprobe,
    equal to the reference's; ``donate=True`` writes the gallery in
    place and gives the same results."""
    m, n, dim, k = 8, 160, 32, 4
    rmod, mod = _modules("hamming", k, False, m, n, dim)
    q, p = _data(rng, "hamming", m, n, dim)
    idx_all = np.sort(rng.choice(n, size=24, replace=False))
    new_all = (rng.random((24, dim)) > 0.5).astype(np.float32)

    # schedule A: one bulk update
    T.clear_plan_cache()
    a = t_hier(mod, clusters=6, nprobe=2, device="cpu")
    g0a = torch.from_numpy(p.copy())
    a.execute(q, g0a)
    ga = a.update_rows(g0a, idx_all, new_all, donate=donate)
    assert (ga is g0a) == donate
    ra = _np(a.execute(q, ga))

    # schedule B: same rows in three interleaved slices (different
    # vacate/fill order -> different physical slots)
    T.clear_plan_cache()
    b = t_hier(mod, clusters=6, nprobe=2, device="cpu")
    gb = torch.from_numpy(p.copy())
    b.execute(q, gb)
    for sl in (slice(0, 24, 3), slice(1, 24, 3), slice(2, 24, 3)):
        gb = b.update_rows(gb, idx_all[sl], new_all[sl], donate=donate)
    assert a.row_update_fallbacks == 0 and b.row_update_fallbacks == 0
    np.testing.assert_array_equal(gb.numpy(), ga.numpy())
    rb = _np(b.execute(q, gb))
    np.testing.assert_array_equal(rb[1], ra[1])
    np.testing.assert_array_equal(rb[0], ra[0])

    # the reference's schedule A on the same inputs
    import jax.numpy as jnp
    R.clear_plan_cache()
    ref = r_hier(rmod, clusters=6, nprobe=2)
    g0 = jnp.asarray(p)
    ref.execute(q, g0)
    _assert_same("hamming", q, p, ra,
                 ref.execute(q, ref.update_rows(g0, idx_all, new_all)),
                 "reference schedule")


def test_served_hierarchical_plan(rng):
    """A hierarchical plan as the serving primary: parity with the flat
    plan, live update_gallery on the incremental path, the flat-exact
    fallback level first in the CPU chain, and family-tagged
    telemetry."""
    from repro_torch.serving import CamSearchServer

    m, n, dim, k = 8, 192, 32, 5
    _, mod = _modules("hamming", k, False, m, n, dim)
    q, p = _data(rng, "hamming", m, n, dim)
    flat = T.get_plan(mod, backend="torch", device="cpu")
    hier = t_hier(mod, clusters=6, nprobe=6, device="cpu")

    with CamSearchServer(hier, p, max_wait_ms=0.5) as srv:
        _assert_same("hamming", q, p, srv.search(q), flat.execute(q, p),
                     "served")
        snap = srv.snapshot()
        assert snap["plan"]["family"] == "hierarchical"
        levels = [name for name, _ in srv._levels()]
        assert levels[:2] == ["primary", "torch-flat"], levels
        assert srv._levels()[1][1] is flat

        idx = np.arange(0, 48)
        new = (rng.random((48, dim)) > 0.5).astype(np.float32)
        fb = hier.row_update_fallbacks
        srv.update_gallery(idx, new)
        assert hier.row_update_fallbacks == fb
        g2 = p.copy()
        g2[idx] = new
        _assert_same("hamming", q, p, srv.search(q), flat.execute(q, g2),
                     "served after update_gallery")
        assert srv.snapshot()["gallery_updates"] == 1
        h = srv.health()
        assert h["degraded_batches"] == 0 and h["backend_errors"] == 0


# ---------------------------------------------------------------------------
# k-means against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["hamming", "dot", "cos"])
def test_kmeans_bit_identical_for_packable_metrics(metric, rng):
    """{0,1} cells: the cluster sums are exact integers, so the port's
    centroids and assignments are the reference's bit for bit."""
    n, dim = 300, 48
    rmod, tmod = _modules(metric, 4, False, 5, n, dim)
    if metric == "hamming":
        g = (rng.random((n, dim)) > 0.5).astype(np.float32)
    else:
        g = rng.standard_normal((n, dim)).astype(np.float32)
    rspec = r_hier(rmod, clusters=9, nprobe=3, kmeans_iters=5, seed=3).spec
    tspec = t_hier(tmod, clusters=9, nprobe=3, kmeans_iters=5, seed=3,
                   device="cpu").spec
    import jax.numpy as jnp
    rc, ra = rh._kmeans(jnp.asarray(g), rspec)
    tc, ta = th._kmeans(torch.from_numpy(g), tspec)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(ta, ra)
    assert ta.dtype == np.int32


def test_kmeans_eucl_assignments_differ_only_at_near_ties(rng):
    """eucl: the float32 products and cluster sums run in another order
    than the reference's, so a row may go to the other of two centroids
    that are float64 near-ties for it; no other row may differ, and the
    centroids agree within the eucl tolerance.  Two prepares of one
    gallery give bit-identical centroids."""
    n, dim = 400, 40
    rmod, tmod = _modules("eucl", 4, False, 5, n, dim)
    g = rng.standard_normal((n, dim)).astype(np.float32)
    rspec = r_hier(rmod, clusters=12, nprobe=3).spec
    tspec = t_hier(tmod, clusters=12, nprobe=3, device="cpu").spec
    import jax.numpy as jnp
    rc, ra = rh._kmeans(jnp.asarray(g), rspec)
    tc, ta = th._kmeans(torch.from_numpy(g), tspec)
    rc = np.asarray(rc)
    np.testing.assert_allclose(tc.numpy(), rc, rtol=1e-5, atol=1e-5)
    g64, c64 = g.astype(np.float64), rc.astype(np.float64)
    for r in np.flatnonzero(ta != ra):
        da = ((g64[r] - c64[ta[r]]) ** 2).sum()
        db = ((g64[r] - c64[ra[r]]) ** 2).sum()
        assert abs(da - db) <= 1e-4 + 1e-5 * abs(db), (r, da, db)
    tc2, ta2 = th._kmeans(torch.from_numpy(g), tspec)
    assert torch.equal(tc2, tc) and np.array_equal(ta2, ta)


def test_layout_and_budget_match_reference(rng):
    """The host layout and the probe budget are copies: equal outputs
    for the same assignment."""
    assign = rng.integers(0, 7, size=233).astype(np.int32)
    assign[:40] = 2                              # one crowded cluster
    for got, want in zip(th._layout_from_assign(assign, 7, 16, 233),
                         rh._layout_from_assign(assign, 7, 16, 233)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    cnt = rng.integers(0, 30, size=50).astype(np.int32)
    for nprobe in (1, 5, 50):
        assert th._probe_budget(cnt, nprobe, 30) == \
            rh._probe_budget(cnt, nprobe, 30)


def test_order_key_is_the_composite_order(rng):
    """The int64 selection key sorts as (value, row id): negative and
    positive values, -0.0 folded into +0.0, ±inf, sentinel ids."""
    vals = np.array([3.0, -1.5, -0.0, 0.0, np.inf, -np.inf, 3.0, -1.5,
                     np.inf, 1e-30, -1e-30], np.float32)
    gids = np.array([5, 9, 4, 2, th._SENT, 7, 1, 3, 6, 8, 0], np.int32)
    key = th._order_key(torch.from_numpy(vals), torch.from_numpy(gids))
    got = np.argsort(key.numpy(), kind="stable")
    want = np.lexsort((gids, vals + np.float32(0.0)))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# plan-cache keys and the nprobe knob (tests/test_plan_cache_keys.py,
# tests/test_env.py)
# ---------------------------------------------------------------------------


def test_hierarchical_specs_never_equal_their_fine_spec():
    """The wrapper *type* splits the key even when every delegated field
    agrees; nprobe / clusters / seed / kmeans_iters all join it; the
    port's spec digest equals the reference's."""
    _, mod = _modules("hamming", 3, False, 6, 64, 32)
    rmod, _ = _modules("hamming", 3, False, 6, 64, 32)
    fine = T.get_plan(mod, backend="torch", device="cpu").spec
    base = T.HierarchicalSpec(fine=fine, clusters=8, nprobe=2)
    assert base != fine and fine != base
    for other in (T.HierarchicalSpec(fine=fine, clusters=8, nprobe=3),
                  T.HierarchicalSpec(fine=fine, clusters=4, nprobe=2),
                  T.HierarchicalSpec(fine=fine, clusters=8, nprobe=2,
                                     kmeans_iters=9),
                  T.HierarchicalSpec(fine=fine, clusters=8, nprobe=2,
                                     seed=1)):
        assert base != other
    rspec = r_hier(rmod, clusters=8, nprobe=2).spec
    assert T.spec_digest(base) == R.spec_digest(rspec)
    assert base.flat_spec is fine and base.k == fine.k == 3


def test_hierarchical_plans_share_the_cache():
    """An ordinary plan-cache citizen: same clustering config -> the same
    object, any axis change -> a new one, and the flat plan for the same
    module keeps its own slot."""
    T.clear_plan_cache()
    _, mod = _modules("hamming", 3, False, 6, 64, 32)
    flat = T.get_plan(mod, backend="torch", device="cpu")
    h1 = t_hier(mod, clusters=4, nprobe=2, device="cpu")
    before = T.plan_cache_stats()["hits"]
    h2 = t_hier(mod, clusters=4, nprobe=2, device="cpu")
    assert T.plan_cache_stats()["hits"] == before + 1
    h3 = t_hier(mod, clusters=4, nprobe=4, device="cpu")
    h4 = t_hier(mod, clusters=4, nprobe=2, seed=1, device="cpu")
    h5 = t_hier(mod, clusters=4, nprobe=2, pack=False, device="cpu")
    assert h1 is h2
    assert len({id(h) for h in (h1, h3, h4, h5)}) == 4
    assert all(h is not flat for h in (h1, h3, h4, h5))


def test_hier_nprobe_strict_and_applied(monkeypatch):
    _, mod = _modules("hamming", 2, False, 4, 64, 16, rows=8, cols=16)
    monkeypatch.setenv("REPRO_HIER_NPROBE", "some")
    with pytest.raises(ValueError, match="REPRO_HIER_NPROBE"):
        t_hier(mod, clusters=8, device="cpu")
    monkeypatch.setenv("REPRO_HIER_NPROBE", "-1")
    with pytest.raises(ValueError, match="REPRO_HIER_NPROBE"):
        t_hier(mod, clusters=8, device="cpu")
    T.clear_plan_cache()
    monkeypatch.setenv("REPRO_HIER_NPROBE", "3")
    assert t_hier(mod, clusters=8, device="cpu").spec.nprobe == 3
    # an explicit nprobe argument beats the environment default
    assert t_hier(mod, clusters=8, nprobe=5, device="cpu").spec.nprobe == 5


def test_module_for_spec_builds_the_flat_module():
    """``module_for_spec(HierarchicalSpec)`` is the flat search's module."""
    _, mod = _modules("dot", 4, True, 5, 70, 64)
    hier = t_hier(mod, clusters=5, nprobe=2, device="cpu")
    got = T.engine.extract_plan_spec(T.engine.module_for_spec(hier.spec))
    assert dataclasses.asdict(got) == dataclasses.asdict(hier.spec.fine)


def test_faults_ride_on_the_hierarchical_dispatch(rng):
    """A fault model corrupts the hierarchical plan's stored gallery
    before its prepare, as on every plan: the result equals the
    reference's under the same model, and a null model is clean."""
    from repro.faults import FaultModel as RFaultModel
    from repro_torch.faults import FaultModel

    rmod, mod = _modules("hamming", 5, False, 8, 192, 32)
    q, p = _data(rng, "hamming", 8, 192, 32)
    kw = dict(seed=3, p_stuck=0.05, p_flip=0.02)
    hier = t_hier(mod, clusters=6, nprobe=3, device="cpu")
    got = hier.execute(q, p, faults=FaultModel(**kw))
    _assert_same("hamming", q, p, got,
                 r_hier(rmod, clusters=6, nprobe=3).execute(
                     q, p, faults=RFaultModel(**kw)), "faulted")
    _assert_same("hamming", q, p, hier.execute(q, p, faults=FaultModel()),
                 hier.execute(q, p), "null model")
