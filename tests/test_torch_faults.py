"""Port fault injection and hardening (``repro_torch.faults``) against the
reference (``repro.faults``) on the CPU: the same realised fault cells,
the engine with faults equal to the reference's ``plan.execute(faults=)``
(integer metrics bit-identical, eucl to the stated tolerance with index
swaps only between float64 near-ties), and the twins of
``tests/test_faults.py``: model determinism, dispatch-time corruption,
``HardenedPlan`` replication and healing.  Port backend ``"torch"`` and
``"cuda"`` (its kernels' plain versions on CPU tensors) are both held to
the reference's ``"jnp"``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import cim_dialect as rcd
from repro.faults import FaultModel as RFaultModel
from repro.faults import HardenedPlan as RHardenedPlan
from repro_torch.core import cim_dialect as tcd
from repro_torch.core.engine import (extract_plan_spec, extract_range_spec,
                                      module_for_spec)
from repro_torch.faults import FaultModel, HardenedPlan, HealReport
from repro_torch.kernels.cam_search import MAX_K
from test_torch_kernels import _assert_eucl_close
from test_torch_range import range_module
from test_torch_update_rows import sim_module

BACKENDS = ["torch", "cuda"]
ROWS, COLS = 16, 32


def _data(rng, metric, m, n, dim):
    """Metric-appropriate operands (bipolar cells for dot, as the CAM
    stores bits)."""
    if metric == "hamming":
        return ((rng.random((m, dim)) > 0.5).astype(np.float32),
                (rng.random((n, dim)) > 0.5).astype(np.float32))
    if metric == "dot":
        return tuple(np.where(rng.random((r, dim)) < 0.5, -1.0, 1.0
                              ).astype(np.float32) for r in (m, n))
    return (rng.standard_normal((m, dim)).astype(np.float32),
            rng.standard_normal((n, dim)).astype(np.float32))


def _interval_data(rng, m, n, dim, constrained=0.08):
    q = rng.standard_normal((m, dim)).astype(np.float32)
    lo = np.full((n, dim), -np.inf, np.float32)
    hi = np.full((n, dim), np.inf, np.float32)
    sel = rng.random((n, dim)) < constrained
    lo[sel] = (rng.standard_normal(sel.sum()) - 2).astype(np.float32)
    hi[sel] = lo[sel] + 3.5
    return q, lo, hi


def _search(metric="dot", m=6, n=48, dim=32, k=3, backend="torch",
            pack=None, care=False, rows=ROWS, cols=COLS):
    """(reference plan, port plan) for one similarity program."""
    largest = metric != "eucl" and metric != "hamming"
    rmod = sim_module(R, rcd, metric, k, largest, m, n, dim,
                      R.ArchSpec(rows=rows, cols=cols), care=care)
    tmod = sim_module(T, tcd, metric, k, largest, m, n, dim,
                      T.ArchSpec(rows=rows, cols=cols), care=care)
    return (R.get_plan(rmod, pack=pack),
            T.get_plan(tmod, backend=backend, pack=pack, device="cpu"))


def _interval(m=5, n=40, dim=16, backend="torch"):
    arch = dict(rows=8, cols=16)
    return (R.get_plan(range_module(R, rcd, m, n, dim, interval=True,
                                    arch=R.ArchSpec(**arch))),
            T.get_plan(range_module(T, tcd, m, n, dim, interval=True,
                                    arch=T.ArchSpec(**arch)),
                       backend=backend, device="cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(metric, q, p, ref, port):
    """Port result equal to the reference's: bit for bit, or eucl to the
    tolerance with near-tie index swaps only."""
    if isinstance(ref, tuple):
        rv, ri = (_np(x) for x in ref)
        tv, ti = (_np(x) for x in port)
        if metric == "eucl":
            _assert_eucl_close(q, p, rv, ri, tv, ti)
            return
        np.testing.assert_array_equal(tv, rv)
        np.testing.assert_array_equal(ti, ri)
        return
    np.testing.assert_array_equal(_np(port), _np(ref))


def _models(**kw):
    return RFaultModel(**kw), FaultModel(**kw)


# -- model ----------------------------------------------------------------


def test_model_validation():
    for kw in (dict(p_stuck=1.5), dict(p_flip=-0.1), dict(sigma=-1.0),
               dict(seed=-1)):
        with pytest.raises(ValueError):
            FaultModel(**kw)
        with pytest.raises(ValueError):
            RFaultModel(**kw)


def test_null_model_detection():
    assert FaultModel().is_null
    assert FaultModel(drift=0.5, t=0).is_null          # no elapsed time
    assert not FaultModel(p_flip=0.01).is_null
    assert not FaultModel(drift=0.5, t=3).is_null


def test_stuck_cells_are_permanent_flips_are_transient():
    rm, fm = _models(seed=3, p_stuck=0.05, p_flip=0.05)
    s0a, s1a = fm.stuck_masks((40, 16))
    s0b, s1b = fm.rewritten().stuck_masks((40, 16))
    np.testing.assert_array_equal(s0a, s0b)            # permanent
    np.testing.assert_array_equal(s1a, s1b)
    assert not (s0a & s1a).any()                       # disjoint
    fa = fm.flip_mask((40, 16))
    fb = fm.rewritten().flip_mask((40, 16))
    assert (fa != fb).any()                            # redrawn per epoch
    np.testing.assert_array_equal(fa, fm.flip_mask((40, 16)))
    # ... and the very cells the reference draws
    for got, want in zip(fm.stuck_masks((40, 16)), rm.stuck_masks((40, 16))):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fb, rm.rewritten().flip_mask((40, 16)))


def test_drift_accumulates_in_fixed_direction():
    fm = FaultModel(seed=1, drift=0.1, t=2)
    d2 = fm.drift_shift((8, 8))
    d5 = fm.aged(3).drift_shift((8, 8))
    np.testing.assert_array_equal(np.sign(d2), np.sign(d5))
    np.testing.assert_allclose(np.abs(d5), 2.5 * np.abs(d2))
    assert fm.aged(3).suggest_guard(z=0.0) == pytest.approx(0.5)
    assert fm.rewritten().t == 0 and fm.rewritten().epoch == fm.epoch + 1
    np.testing.assert_array_equal(
        d5, RFaultModel(seed=1, drift=0.1, t=5).drift_shift((8, 8)))


def test_corrupt_interval_stuck_semantics():
    lo = np.zeros((4, 4), np.float32)
    hi = np.ones((4, 4), np.float32)
    lo2, hi2 = FaultModel(seed=0, p_stuck=1.0).corrupt_interval(lo, hi)
    wild = (lo2 == -np.inf) & (hi2 == np.inf)          # stuck-at-1
    empty = (lo2 == np.inf) & (hi2 == -np.inf)         # stuck-at-0
    assert (wild | empty).all() and wild.any() and empty.any()
    rlo, rhi = RFaultModel(seed=0, p_stuck=1.0).corrupt_interval(lo, hi)
    np.testing.assert_array_equal(lo2, rlo)
    np.testing.assert_array_equal(hi2, rhi)


@pytest.mark.parametrize("metric", ["hamming", "dot", "eucl", "interval",
                                    "ternary"])
def test_corrupted_cells_equal_reference(metric, rng):
    """The port's model realises exactly the reference's faulted cells
    for every stored-operand domain (the care mask passes through)."""
    kw = dict(seed=9, p_stuck=0.04, p_flip=0.03, sigma=0.05, drift=0.02,
              t=3)
    rm, fm = _models(**kw)
    if metric == "interval":
        _, lo, hi = _interval_data(rng, 1, 30, 12)
        rplan, tplan = _interval(n=30, dim=12)
        srcs = (lo, hi)
    else:
        care = metric == "ternary"
        met = "hamming" if care else metric
        _, p = _data(rng, met, 1, 30, 12)
        rplan, tplan = _search(met, n=30, dim=12, care=care, k=2)
        srcs = (p, (rng.random((30, 12)) > 0.3).astype(np.float32)) \
            if care else (p,)
    got = fm.corrupt_stored(srcs, tplan.spec)
    want = rm.corrupt_stored(srcs, rplan.spec)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert fm.cell_fault_counts((30, 12)) == rm.cell_fault_counts((30, 12))


# -- engine dispatch-time injection ---------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_null_model_bit_identical_to_clean(backend, rng):
    _, plan = _search(backend=backend)
    q, p = _data(rng, "dot", 6, 48, 32)
    v0, i0 = plan.execute(q, p)
    v1, i1 = plan.execute(q, p, faults=FaultModel())
    assert torch.equal(v0, v1) and torch.equal(i0, i1)


def test_faults_reject_garbage_object(rng):
    _, plan = _search()
    q, p = _data(rng, "dot", 6, 48, 32)
    with pytest.raises(TypeError):
        plan.execute(q, p, faults="p=0.1")


@pytest.mark.parametrize("backend", BACKENDS)
def test_seeded_injection_reproducible_and_seed_sensitive(backend, rng):
    rplan, plan = _search(backend=backend)
    q, p = _data(rng, "dot", 6, 48, 32)
    fm = FaultModel(seed=5, p_stuck=0.02, p_flip=0.01)
    va, ia = plan.execute(q, p, faults=fm)
    vb, ib = plan.execute(q, p, faults=FaultModel(seed=5, p_stuck=0.02,
                                                  p_flip=0.01))
    assert torch.equal(ia, ib) and torch.equal(va, vb)
    _, ic = plan.execute(q, p, faults=FaultModel(seed=6, p_stuck=0.02,
                                                 p_flip=0.01))
    assert not torch.equal(ia, ic)
    _assert_same("dot", q, p, rplan.execute(
        q, p, faults=RFaultModel(seed=5, p_stuck=0.02, p_flip=0.01)),
        (va, ia))


@pytest.mark.parametrize("backend", BACKENDS)
def test_packed_and_unpacked_see_identical_faults(backend, rng):
    """Corruption happens in the source metric domain, so the int32
    lanes and the float slab encode the same faulted cells (and the
    reference's uint32 lanes too)."""
    m, n, dim, k = 6, 64, 64, 4
    q, p = _data(rng, "hamming", m, n, dim)
    rm, fm = _models(seed=2, p_stuck=0.03, p_flip=0.01)
    rpacked, packed = _search("hamming", m, n, dim, k, backend, pack=True)
    _, unpacked = _search("hamming", m, n, dim, k, "torch", pack=False)
    assert packed.packed and not unpacked.packed
    vp, ip = packed.execute(q, p, faults=fm)
    vu, iu = unpacked.execute(q, p, faults=fm)
    assert torch.equal(ip, iu) and torch.equal(vp, vu)
    _assert_same("hamming", q, p, rpacked.execute(q, p, faults=rm), (vp, ip))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["hamming-packed", "hamming-unpacked", "dot",
                                  "eucl", "ternary"])
def test_engine_faults_match_reference(case, backend, rng):
    """The port's engine with faults equals the reference's, and equals
    its own clean engine on the pre-corrupted sources (injection is
    exactly a transformation of the stored operands)."""
    metric = case.split("-")[0]
    care = metric == "ternary"
    met = "hamming" if care else metric
    pack = {"hamming-packed": True, "hamming-unpacked": False}.get(case)
    if backend == "cuda" and (care or pack is None) and met == "hamming":
        pack = True             # the cuda backend's ternary path is packed
    m, n, dim, k = 7, 53, 40, 4
    q, p = _data(rng, met, m, n, dim)
    ins = (q, p) + (((rng.random((n, dim)) > 0.25).astype(np.float32),)
                    if care else ())
    rplan, plan = _search(met, m, n, dim, k, backend, pack=pack, care=care)
    kw = dict(seed=7, p_stuck=0.03, p_flip=0.02)
    if metric == "eucl":
        kw.update(sigma=0.05, drift=0.01, t=2)
    rm, fm = _models(**kw)
    got = plan.execute(*ins, faults=fm)
    _assert_same(metric, q, p, rplan.execute(*ins, faults=rm), got)
    corrupted = fm.corrupt_stored(ins[1:], plan.spec)
    want = plan.execute(q, *corrupted)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    clean = plan.execute(*ins)
    assert not (torch.equal(clean[0], got[0])
                and torch.equal(clean[1], got[1]))      # faults bit


@pytest.mark.parametrize("backend", BACKENDS)
def test_range_interval_fault_injection(backend, rng):
    rplan, plan = _interval(backend=backend)
    q, lo, hi = _interval_data(rng, 5, 40, 16)
    rm, fm = _models(seed=4, p_stuck=0.05, sigma=0.01)
    want = plan.execute(q, *fm.corrupt_interval(lo, hi))
    got = plan.execute(q, lo, hi, faults=fm)
    assert torch.equal(want, got)
    assert not torch.equal(plan.execute(q, lo, hi), got)   # faults bit
    _assert_same("interval", q, lo, rplan.execute(q, lo, hi, faults=rm), got)


def test_faulted_layout_never_shadows_the_clean_one(rng):
    """The fault model joins the pattern-memo key: a faulted dispatch
    adds its own entry, the clean entry keeps serving clean results, and
    ``update_rows`` rewrites only the clean entry (the next faulted
    dispatch prepares again in full)."""
    _, plan = _search("hamming", 6, 64, 32, 3, "cuda", pack=True)
    q, p = _data(rng, "hamming", 6, 64, 32)
    g = torch.from_numpy(p)
    fm = FaultModel(seed=1, p_stuck=0.05)
    clean = plan.execute(q, g)
    faulted = plan.execute(q, g, faults=fm)
    assert [k[-1] for k in plan._pattern_cache] == [None, fm]
    again = plan.execute(q, g)
    assert torch.equal(again[0], clean[0]) and torch.equal(again[1], clean[1])
    assert torch.equal(plan.execute(q, g, faults=fm)[1], faulted[1])
    new = plan.update_rows(g, [0, 5], np.ones((2, 32), np.float32))
    assert [k[-1] for k in plan._pattern_cache] == [None, fm, None]
    misses = plan.pattern_misses
    got = plan.execute(q, new, faults=fm)
    assert plan.pattern_misses == misses + 1              # prepared in full
    want = plan.execute(q, *fm.corrupt_stored((new.numpy(),), plan.spec))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_warm_primes_the_faulted_memo(rng):
    _, plan = _search()
    q, p = _data(rng, "dot", 6, 48, 32)
    fm = FaultModel(seed=3, p_flip=0.05)
    srcs = plan.warm(p, faults=fm)
    assert isinstance(srcs[0], torch.Tensor)
    hits = plan.pattern_hits
    plan.execute(q, srcs[0], faults=fm)
    assert plan.pattern_hits == hits + 1
    with pytest.raises(TypeError):
        plan.warm(p, faults=object())


@pytest.mark.parametrize("case", ["search", "ternary", "threshold",
                                  "interval"])
def test_module_for_spec_round_trips(case):
    if case == "interval":
        _, plan = _interval()
    elif case == "threshold":
        plan = T.get_plan(range_module(T, tcd, 5, 40, 24, metric="eucl",
                                       tau=3.0), device="cpu")
    else:
        _, plan = _search("hamming", care=case == "ternary")
    spec = plan.spec
    got = extract_plan_spec(module_for_spec(spec))
    if got is None:
        got = extract_range_spec(module_for_spec(spec))
    assert dataclasses.asdict(got) == dataclasses.asdict(spec)
    phys = extract_plan_spec(module_for_spec(
        dataclasses.replace(spec, n=3 * spec.n), m=11)) if case == "search" \
        else None
    if phys is not None:
        assert phys.n == 3 * spec.n and phys.m == 11


def test_module_for_spec_refuses_a_composite_spec():
    """A composite spec (anything exposing ``flat_spec``) is no longer
    refused: it synthesises the module of its flat equivalent, as the
    reference's does."""
    _, plan = _search()

    @dataclasses.dataclass(frozen=True)
    class Composite:
        flat_spec: object

    got = extract_plan_spec(module_for_spec(Composite(plan.spec)))
    assert dataclasses.asdict(got) == dataclasses.asdict(plan.spec)


# -- HardenedPlan ---------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_hardened_r1_is_bit_identical_search(backend, rng):
    _, plan = _search("eucl", backend=backend)
    q, p = _data(rng, "eucl", 6, 48, 32)
    hp = HardenedPlan(plan, replicas=1, spares=0)
    hp.prepare(p)
    assert hp.plan.device == plan.device and hp.plan.backend == backend
    v0, i0 = plan.execute(q, p)
    v1, i1 = hp.execute(q)
    np.testing.assert_array_equal(i0.numpy(), i1)
    np.testing.assert_array_equal(v0.numpy(), v1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_hardened_r1_is_bit_identical_range(backend, rng):
    _, plan = _interval(backend=backend)
    q, lo, hi = _interval_data(rng, 5, 40, 16)
    hp = HardenedPlan(plan, replicas=1, spares=0)
    hp.prepare(lo, hi)
    np.testing.assert_array_equal(plan.execute(q, lo, hi).numpy(),
                                  hp.execute(q))


def test_replication_improves_topk_agreement(rng):
    """3x replication + median de-dup recovers top-k overlap with the
    clean result, averaged over fault seeds, with exactly the
    reference's per-seed scores."""
    rplan, plan = _search("dot", m=16, n=96, dim=64)
    q, p = _data(rng, "dot", 16, 96, 64)
    k = plan.spec.k
    clean = plan.execute(q, p)[1].numpy()
    hp = HardenedPlan(plan, replicas=3, spares=0)
    hp.prepare(p)
    rhp = RHardenedPlan(rplan, replicas=3, spares=0)
    rhp.prepare(p)

    def agree(a):
        return np.mean([len(set(a[r]) & set(clean[r])) / k
                        for r in range(clean.shape[0])])

    raw_scores, rep_scores = [], []
    for seed in range(8):
        rm, fm = _models(seed=seed, p_stuck=0.02, p_flip=0.01)
        raw = plan.execute(q, p, faults=fm)[1].numpy()
        rep_v, rep_i = hp.execute(q, faults=fm)
        want_v, want_i = rhp.execute(q, faults=rm)
        np.testing.assert_array_equal(rep_i, want_i)
        np.testing.assert_array_equal(rep_v, want_v)
        raw_scores.append(agree(raw))
        rep_scores.append(agree(rep_i))
    assert np.mean(rep_scores) > np.mean(raw_scores)


@pytest.mark.parametrize("backend", BACKENDS)
def test_heal_remaps_faulty_rows_to_spares(backend, rng):
    rplan, plan = _interval(backend=backend)
    q, lo, hi = _interval_data(rng, 5, 40, 16)
    rm, fm = _models(seed=11, p_stuck=0.02, p_flip=0.01)
    hp = HardenedPlan(plan, replicas=2, spares=64)
    hp.prepare(lo, hi)
    report = hp.heal(fm)
    assert report.detected > 0
    assert report.remapped > 0
    assert report.remapped <= report.detected
    snap = hp.snapshot()
    assert snap["spares_free"] == 64 - report.remapped
    # the reference heals the same rows onto the same spares
    rhp = RHardenedPlan(rplan, replicas=2, spares=64)
    rhp.prepare(lo, hi)
    assert dataclasses.asdict(report) == dataclasses.asdict(rhp.heal(rm))
    assert isinstance(report, HealReport)
    np.testing.assert_array_equal(hp.logical_of, rhp.logical_of)
    assert snap == rhp.snapshot()
    got = hp.execute(q, faults=fm)
    np.testing.assert_array_equal(got, np.asarray(rhp.execute(q, faults=rm)))
    if report.unrepairable == 0:
        # fully healed: the faulted physical gallery reads back clean,
        # so execution under the model matches the clean logical result
        np.testing.assert_array_equal(plan.execute(q, lo, hi).numpy(), got)


def test_heal_search_through_update_rows_matches_reference(rng):
    """Healing a hamming search plan goes through the port's incremental
    ``update_rows`` and remaps the reference's rows."""
    rplan, plan = _search("hamming", m=6, n=48, dim=32, k=3, pack=True)
    q, p = _data(rng, "hamming", 6, 48, 32)
    rm, fm = _models(seed=2, p_stuck=0.01, p_flip=0.01)
    hp = HardenedPlan(plan, replicas=3, spares=32)
    hp.prepare(p)
    rhp = RHardenedPlan(rplan, replicas=3, spares=32)
    rhp.prepare(p)
    for got, want in zip(hp.execute(q), rhp.execute(q)):   # memo primed
        np.testing.assert_array_equal(got, np.asarray(want))
    fb = hp.plan.row_update_fallbacks
    report = hp.heal(fm)
    assert report.remapped > 0
    assert dataclasses.asdict(report) == dataclasses.asdict(rhp.heal(rm))
    assert hp.plan.row_update_fallbacks == fb and hp.plan.row_updates >= 1
    for got, want in zip(hp.execute(q), rhp.execute(q)):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(hp.logical_of, rhp.logical_of)
    for got, want in zip(hp.execute(q, faults=fm), rhp.execute(q, faults=rm)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_heal_is_idempotent_when_clean(rng):
    _, plan = _search("eucl")
    _, p = _data(rng, "eucl", 6, 48, 32)
    hp = HardenedPlan(plan, replicas=1, spares=4)
    hp.prepare(p)
    report = hp.heal(FaultModel())          # null model: nothing to find
    assert report.detected == 0 and report.remapped == 0
    assert report.passes == 0               # short-circuits, no readback


def test_hardened_validates_inputs(rng):
    _, plan = _search()
    _, p = _data(rng, "dot", 6, 48, 32)
    with pytest.raises(ValueError):
        HardenedPlan(plan, replicas=0)
    with pytest.raises(ValueError):
        HardenedPlan(plan, replicas=1, spares=-1)
    with pytest.raises(ValueError, match="interval"):
        HardenedPlan(plan, guard=0.5)
    hp = HardenedPlan(plan, replicas=1, spares=0)
    with pytest.raises(RuntimeError):
        hp.execute(p)                       # prepare() not called yet


def test_hardened_candidates_beyond_the_cuda_window_raise_like_get_plan():
    """On the ``"cuda"`` backend the physical plan's ``R k + spares``
    candidates must fit the kernels' window: past ``MAX_K`` the
    constructor raises the ``ValueError`` that ``get_plan`` gives for any
    such ``k``; the ``"torch"`` backend has no window."""
    _, plan = _search("hamming", n=200, k=3, backend="cuda", pack=True)
    spares = MAX_K - 3 * plan.spec.k + 1
    with pytest.raises(ValueError, match="outside the CAM search kernels"):
        HardenedPlan(plan, replicas=3, spares=spares)
    with pytest.raises(ValueError, match="outside the CAM search kernels"):
        T.get_plan(module_for_spec(dataclasses.replace(
            plan.spec, n=3 * plan.spec.n + spares,
            k=3 * plan.spec.k + spares)), backend="cuda", device="cpu")
    hp = HardenedPlan(plan, replicas=3, spares=spares - 1)
    assert hp.plan.spec.k == MAX_K
    assert HardenedPlan(plan, replicas=3, spares=spares,
                        backend="torch").plan.spec.k == MAX_K + 1
