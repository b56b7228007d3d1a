"""Port gallery mutation vs the reference, on the CPU: ``update_rows`` on
both plan families and both port backends (``"torch"`` / ``"cuda"``, the
latter running its kernels' plain versions here) against the reference's
``"jnp"`` / ``"pallas"`` plans, mutating the same rows of the same numpy
galleries.

Contract: after an update the next dispatch is a pattern-memo hit with no
fallback, its result is bit-identical to a fresh port plan on the mutated
gallery, and equal to the reference's on that gallery (integer metrics
and interval matches bit for bit; eucl within the tolerance of
``test_torch_engine``).  ``donate=True`` writes in place; ``donate=False``
leaves the old gallery and its memo entry serving the old results.  The
sharded case waits for sharded plans in the port.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import cim_dialect as rcd
from repro_torch.core import cim_dialect as tcd
from repro_torch.core.engine import _update_enabled

from test_torch_range import interval_data, range_module

PAIRS = [("jnp", "torch"), ("pallas", "cuda")]
EUCL_RTOL, EUCL_ATOL = 1e-5, 1e-4


def sim_module(pkg, cd, metric, k, largest, m, n, dim, arch, care=False):
    """Hand-built similarity program through the partition pass, in either
    package (``pkg`` is ``repro.core`` or ``repro_torch.core``)."""
    args = [pkg.TensorType((m, dim)), pkg.TensorType((n, dim))]
    if care:
        args.append(pkg.TensorType((n, dim)))
    mod = pkg.Module("sim", args)
    a = mod.arguments
    b = pkg.Builder(mod.body)
    dev = cd.make_acquire(b)
    exe = cd.make_execute(b, dev.result, list(a),
                          [pkg.TensorType((m, k)),
                           pkg.TensorType((m, k), "i32")])
    blk = exe.region().block()
    sim = cd.make_similarity(blk, a[0], a[1], metric=metric, k=k,
                             largest=largest, care=a[2] if care else None)
    cd.make_yield(blk, sim.results)
    cd.make_release(b, dev.result)
    b.ret(exe.results)
    pm = pkg.PassManager()
    pm.add(pkg.passes.CompulsoryPartition())
    return pm.run(mod, {"arch": arch})


def _data(rng, metric, m, n, d):
    if metric == "hamming":
        return ((rng.random((m, d)) > 0.5).astype(np.float32),
                (rng.random((n, d)) > 0.5).astype(np.float32))
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _plans(metric, k, largest, m, n, dim, rows, cols, ref_backend, backend,
           **kw):
    """(reference plan, port plan, port module) for one program."""
    rmod = sim_module(R, rcd, metric, k, largest, m, n, dim,
                      R.ArchSpec(rows=rows, cols=cols))
    tmod = sim_module(T, tcd, metric, k, largest, m, n, dim,
                      T.ArchSpec(rows=rows, cols=cols))
    return (R.get_plan(rmod, backend=ref_backend, **kw),
            T.get_plan(tmod, backend=backend, device="cpu", **kw), tmod)


def _fresh(tmod, backend, q, *stored, **kw):
    """Full re-prepare oracle: a fresh port plan on the mutated gallery."""
    T.clear_plan_cache()
    out = T.get_plan(tmod, backend=backend, device="cpu", **kw).execute(
        q, *(s.clone() for s in stored))
    T.clear_plan_cache()
    return out


def _assert_equal(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    else:
        assert torch.equal(a, b)


def _assert_like_reference(metric, ref, port):
    rv, ri = np.asarray(ref[0]), np.asarray(ref[1])
    tv, ti = port[0].numpy(), port[1].numpy()
    if metric == "eucl":
        np.testing.assert_allclose(tv, rv, rtol=EUCL_RTOL, atol=EUCL_ATOL)
    else:
        np.testing.assert_array_equal(tv, rv)
        np.testing.assert_array_equal(ti, ri)


def _hit_once(plan, fn):
    """Run ``fn``; assert it was exactly one pattern-memo hit and that no
    update fell back."""
    hits0, miss0, fb0 = (plan.pattern_hits, plan.pattern_misses,
                         plan.row_update_fallbacks)
    out = fn()
    assert plan.pattern_hits == hits0 + 1, "updated layout not memo-seeded"
    assert plan.pattern_misses == miss0
    assert plan.row_update_fallbacks == fb0
    return out


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
@pytest.mark.parametrize("metric,largest", [("hamming", False),
                                            ("dot", True), ("eucl", False)])
def test_update_rows_matches_reference(metric, largest, ref_backend, backend,
                                       rng):
    m, n, dim, k = 6, 37, 64, 4
    rplan, tplan, tmod = _plans(metric, k, largest, m, n, dim, 16, 32,
                                ref_backend, backend)
    q, p = _data(rng, metric, m, n, dim)
    rg, tg = jnp.asarray(p), torch.from_numpy(p.copy())
    rplan.execute(q, rg)
    tplan.execute(q, tg)

    idx = np.array([0, 17, 36])            # first, middle, ragged-last rows
    new = _data(rng, metric, 3, n, dim)[0]
    rg2 = rplan.update_rows(rg, idx, new)
    tg2 = tplan.update_rows(tg, idx, new)
    assert isinstance(tg2, torch.Tensor) and tg2 is not tg
    np.testing.assert_array_equal(tg2.numpy(), np.asarray(rg2))
    np.testing.assert_array_equal(tg2.numpy()[idx], new)

    got = _hit_once(tplan, lambda: tplan.execute(q, tg2))
    assert tplan.row_updates == 1 and tplan.rows_updated == 3
    _assert_equal(got, _fresh(tmod, backend, q, tg2))
    _assert_like_reference(metric, rplan.execute(q, rg2), got)


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_update_rows_unpacked_float_path(ref_backend, backend, rng):
    """pack=False keeps the float layout; updates rewrite it too."""
    rplan, tplan, tmod = _plans("hamming", 3, False, 5, 29, 48, 8, 16,
                                ref_backend, backend, pack=False)
    assert not tplan.packed
    q, p = _data(rng, "hamming", 5, 29, 48)
    rg, tg = jnp.asarray(p), torch.from_numpy(p.copy())
    rplan.execute(q, rg)
    tplan.execute(q, tg)
    idx, new = np.array([2, 28]), _data(rng, "hamming", 2, 29, 48)[0]
    rg2 = rplan.update_rows(rg, idx, new)
    tg2 = tplan.update_rows(tg, idx, new)
    got = _hit_once(tplan, lambda: tplan.execute(q, tg2))
    _assert_equal(got, _fresh(tmod, backend, q, tg2, pack=False))
    _assert_like_reference("hamming", rplan.execute(q, rg2), got)


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_update_rows_range_threshold_and_interval(ref_backend, backend, rng):
    m, n, dim = 4, 29, 48
    idx = np.array([3, 28])
    for interval in (False, True):
        kw = dict(interval=True) if interval else dict(metric="hamming",
                                                       tau=20.0)
        rmod = range_module(R, rcd, m, n, dim,
                            arch=R.ArchSpec(rows=8, cols=16), **kw)
        tmod = range_module(T, tcd, m, n, dim,
                            arch=T.ArchSpec(rows=8, cols=16), **kw)
        rplan = R.get_plan(rmod, backend=ref_backend)
        tplan = T.get_plan(tmod, backend=backend, device="cpu")
        if interval:
            q, lo, hi = interval_data(rng, m, n, dim)
            stored, new = (lo, hi), (lo[idx] - 1.0, hi[idx] + 1.0)
        else:
            q, p = _data(rng, "hamming", m, n, dim)
            stored, new = (p,), (rng.random((2, dim)) > .5).astype(np.float32)
        rs = tuple(jnp.asarray(s) for s in stored)
        ts = tuple(torch.from_numpy(s.copy()) for s in stored)
        rplan.execute(q, *rs)
        tplan.execute(q, *ts)
        rs2 = rplan.update_rows(rs if interval else rs[0], idx, new)
        ts2 = tplan.update_rows(ts if interval else ts[0], idx, new)
        rs2 = rs2 if interval else (rs2,)
        ts2 = ts2 if interval else (ts2,)
        got = _hit_once(tplan, lambda: tplan.execute(q, *ts2))
        assert got.dtype == torch.bool
        _assert_equal(got, _fresh(tmod, backend, q, *ts2))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(rplan.execute(q, *rs2)))


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_update_rows_ternary_keys_on_gallery_care_pair(ref_backend, backend,
                                                       rng):
    """Ternary plans memo on (gallery, care); updating gallery rows keeps
    serving the same wildcard mask and stays bit-exact."""
    m, n, dim, k = 4, 21, 40, 3
    rmod = sim_module(R, rcd, "hamming", k, False, m, n, dim,
                      R.ArchSpec(rows=8, cols=16), care=True)
    tmod = sim_module(T, tcd, "hamming", k, False, m, n, dim,
                      T.ArchSpec(rows=8, cols=16), care=True)
    rplan = R.get_plan(rmod, backend=ref_backend)
    tplan = T.get_plan(tmod, backend=backend, device="cpu")
    q = (rng.random((m, dim)) > .5).astype(np.float32)
    p = (rng.random((n, dim)) > .5).astype(np.float32)
    care = (rng.random((n, dim)) > .3).astype(np.float32)
    rg, rc = jnp.asarray(p), jnp.asarray(care)
    tg, tc = torch.from_numpy(p.copy()), torch.from_numpy(care.copy())
    rplan.execute(q, rg, rc)
    tplan.execute(q, tg, tc)
    with pytest.raises(ValueError, match="care"):
        tplan.update_rows(tg, [0], (rng.random((1, dim)) > .5
                                    ).astype(np.float32))
    idx = np.array([0, 20])
    new = (rng.random((2, dim)) > .5).astype(np.float32)
    rg2 = rplan.update_rows(rg, idx, new, care=rc)
    tg2 = tplan.update_rows(tg, idx, new, care=tc)
    got = _hit_once(tplan, lambda: tplan.execute(q, tg2, tc))
    _assert_equal(got, _fresh(tmod, backend, q, tg2, tc))
    _assert_like_reference("hamming", rplan.execute(q, rg2, rc), got)


def test_update_rows_validation(rng):
    _, plan, _ = _plans("dot", 2, False, 4, 16, 32, 8, 16, "jnp", "torch")
    q, p = _data(rng, "dot", 4, 16, 32)
    g = torch.from_numpy(p)
    good = _data(rng, "dot", 2, 16, 32)[0]
    with pytest.raises(ValueError, match="out of range"):
        plan.update_rows(g, [0, 16], good)
    with pytest.raises(ValueError, match="duplicate"):
        plan.update_rows(g, [3, 3], good)
    with pytest.raises(ValueError, match="shape"):
        plan.update_rows(g, [3], good)             # 2 rows for 1 index
    with pytest.raises(ValueError, match="1-D"):
        plan.update_rows(g, [[1, 2]], good)
    # empty update is a no-op returning the gallery unchanged
    assert plan.update_rows(g, np.empty(0, np.int64),
                            np.empty((0, 32), np.float32)) is g
    assert plan.row_updates == 0
    rplan = T.get_plan(range_module(T, tcd, 4, 16, 32, interval=True),
                       device="cpu")
    with pytest.raises(ValueError, match="care"):
        rplan.update_rows((g, g), [0], (good[:1], good[:1]), care=g)
    with pytest.raises(ValueError, match="stored operand"):
        rplan.update_rows(g, [0], good[:1])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_update_rows_fallback_paths(backend, rng, monkeypatch):
    """Numpy galleries, never-prepared galleries, evicted entries and the
    kill switch all fall back (counted), and stay correct through a full
    re-prepare."""
    _, plan, tmod = _plans("hamming", 2, False, 4, 20, 32, 8, 16, "jnp",
                           backend)
    q, p = _data(rng, "hamming", 4, 20, 32)
    new = _data(rng, "hamming", 1, 20, 32)[0]

    # numpy gallery: never memoised -> fallback, still correct
    fb0 = plan.row_update_fallbacks
    p2 = plan.update_rows(p, [5], new)
    assert isinstance(p2, torch.Tensor)
    assert plan.row_update_fallbacks == fb0 + 1
    _assert_equal(plan.execute(q, p2), _fresh(tmod, backend, q, p2))

    # a tensor gallery that was never dispatched -> memo miss -> fallback
    g = torch.from_numpy(p.copy())
    fb0 = plan.row_update_fallbacks
    plan.update_rows(g, [5], new)
    assert plan.row_update_fallbacks == fb0 + 1

    # an evicted entry: the memo holds REPRO_ENGINE_PATTERN_SLOTS galleries
    monkeypatch.setenv("REPRO_ENGINE_PATTERN_SLOTS", "1")
    g = torch.from_numpy(p.copy())
    plan.execute(q, g)
    plan.execute(q, torch.from_numpy(p.copy()))        # evicts g's entry
    fb0 = plan.row_update_fallbacks
    g2 = plan.update_rows(g, [5], new)
    assert plan.row_update_fallbacks == fb0 + 1
    _assert_equal(plan.execute(q, g2), _fresh(tmod, backend, q, g2))
    monkeypatch.delenv("REPRO_ENGINE_PATTERN_SLOTS")

    # kill switch: mutation still applied, memo rewrite skipped
    monkeypatch.setenv("REPRO_ENGINE_UPDATE", "off")
    assert not _update_enabled()
    g = torch.from_numpy(p.copy())
    plan.execute(q, g)
    misses0, fb0 = plan.pattern_misses, plan.row_update_fallbacks
    g2 = plan.update_rows(g, [5], new)
    assert plan.row_update_fallbacks == fb0 + 1
    got = plan.execute(q, g2)          # full re-prepare (counted miss)
    assert plan.pattern_misses == misses0 + 1
    monkeypatch.delenv("REPRO_ENGINE_UPDATE")
    _assert_equal(got, _fresh(tmod, backend, q, g2))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_update_rows_packed_enforces_binary_contract(backend, rng):
    _, plan, _ = _plans("hamming", 2, False, 4, 16, 32, 8, 16, "jnp",
                        backend)
    assert plan.packed
    q, p = _data(rng, "hamming", 4, 16, 32)
    g = torch.from_numpy(p)
    plan.execute(q, g)
    with pytest.raises(ValueError, match="binary"):
        plan.update_rows(g, [0], np.full((1, 32), 2.0, np.float32))


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_repeated_updates_chain_incrementally(ref_backend, backend, rng):
    """Each update seeds the memo for the next: five chained updates make
    no full re-prepare after the first dispatch."""
    rplan, plan, tmod = _plans("dot", 2, True, 4, 24, 32, 8, 16,
                               ref_backend, backend)
    q, p = _data(rng, "dot", 4, 24, 32)
    rg, g = jnp.asarray(p), torch.from_numpy(p.copy())
    plan.execute(q, g)
    misses0 = plan.pattern_misses
    for step in range(5):
        new = _data(rng, "dot", 2, 24, 32)[0]
        rg = rplan.update_rows(rg, [step, 23 - step], new)
        g = plan.update_rows(g, [step, 23 - step], new)
        plan.execute(q, g)
    assert plan.pattern_misses == misses0
    assert plan.row_update_fallbacks == 0
    got = plan.execute(q, g)
    _assert_equal(got, _fresh(tmod, backend, q, g))
    _assert_like_reference("dot", rplan.execute(q, rg), got)


# ---------------------------------------------------------------------------
# the port's own contract: donate=True in place, donate=False keeps the old
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("family", ["search", "interval", "threshold"])
def test_donate_updates_in_place_and_hits(backend, family, rng):
    m, n, dim = 5, 45, 40
    arch = T.ArchSpec(rows=16, cols=16)
    idx = np.array([1, 44])
    if family == "search":
        tmod = sim_module(T, tcd, "eucl", 3, False, m, n, dim, arch)
        q, p = _data(rng, "eucl", m, n, dim)
        stored, new = (p,), _data(rng, "eucl", 2, n, dim)[0]
    elif family == "interval":
        tmod = range_module(T, tcd, m, n, dim, interval=True, arch=arch)
        q, lo, hi = interval_data(rng, m, n, dim)
        stored, new = (lo, hi), (lo[idx] - 1.0, hi[idx] + 1.0)
    else:
        tmod = range_module(T, tcd, m, n, dim, metric="eucl", tau=70.0,
                            arch=arch)
        q, p = _data(rng, "eucl", m, n, dim)
        stored, new = (p,), _data(rng, "eucl", 2, n, dim)[0]
    plan = T.get_plan(tmod, backend=backend, device="cpu")
    ts = tuple(torch.from_numpy(s.copy()) for s in stored)
    plan.execute(q, *ts)
    multi = len(ts) == 2
    out = plan.update_rows(ts if multi else ts[0], idx, new, donate=True)
    out = out if multi else (out,)
    assert all(a is b for a, b in zip(out, ts))       # written in place
    np.testing.assert_array_equal(out[0].numpy()[idx],
                                  (new[0] if multi else new))
    got = _hit_once(plan, lambda: plan.execute(q, *ts))
    assert len(plan._pattern_cache) == 1          # the stale entry is gone
    _assert_equal(got, _fresh(tmod, backend, q, *ts))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_no_donate_keeps_the_old_gallery_and_its_results(backend, rng):
    _, plan, tmod = _plans("hamming", 3, False, 6, 50, 64, 16, 32, "jnp",
                           backend)
    q, p = _data(rng, "hamming", 6, 50, 64)
    g = torch.from_numpy(p.copy())
    before = plan.execute(q, g)
    g2 = plan.update_rows(g, [0, 49], _data(rng, "hamming", 2, 50, 64)[0])
    assert torch.equal(g, torch.from_numpy(p))        # untouched
    new = _hit_once(plan, lambda: plan.execute(q, g2))
    old = _hit_once(plan, lambda: plan.execute(q, g))
    _assert_equal(old, before)
    _assert_equal(new, _fresh(tmod, backend, q, g2))


def test_tiny_plan_relays_its_one_dense_tile(rng):
    """A tiny plan's row update re-lays its single dense tile (the whole
    gallery) and stays bit-identical to a fresh tiny plan."""
    _, plan, tmod = _plans("dot", 2, True, 4, 30, 32, 8, 256, "jnp", "torch")
    assert plan.tiny
    q, p = _data(rng, "dot", 4, 30, 32)
    g = torch.from_numpy(p.copy())
    plan.execute(q, g)
    g2 = plan.update_rows(g, [7], _data(rng, "dot", 1, 30, 32)[0])
    got = _hit_once(plan, lambda: plan.execute(q, g2))
    _assert_equal(got, _fresh(tmod, "torch", q, g2))
