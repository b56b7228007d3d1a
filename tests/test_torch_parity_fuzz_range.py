"""The range family of ``tests/test_parity_fuzz.py`` through the port: the
same random range programs (threshold across hamming / dot / eucl and
both polarities, and the aCAM interval mode; tile geometry x
packed/unpacked x fault model absent/null/real), drawn by the
reference's own generator (``_draw_range_case``) from the same seeds,
with the same inputs and thresholds as ``_run_range_case``.

Each case is compiled by both packages and run through ``get_plan`` ->
``execute`` (the port on ``"torch"`` and on ``"cuda"``, the latter with
its kernels' plain versions on the CPU; the reference on ``"jnp"``) and
through the port's IR interpreter.  Then the port's plans are re-tiled
the way the autotuner re-tiles them (``tune.plan_for_config`` at a
geometry and micro-batch drawn from the tuner's own axes) and held to
the reference's plan at the same config.

Hamming and dot matches and interval matches are bit-identical to the
reference's; eucl matches may differ only at float64 near-ties of the
threshold.  A null fault model is bit-identical to no model; a real one
equals the clean port plan on the reference model's corrupted sources.
The 72 cases are split into ``CHUNKS`` interleaved chunks, the cases of
one parametrised test; every failure message carries the case.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.faults import FaultModel as RFaultModel
from repro.kernels import ref as rref
from repro.tune import plan_for_config as r_plan_for_config
from repro_torch.core import cim_dialect as tcd
from repro_torch.core.executor import execute_module
from repro_torch.faults import FaultModel
from repro_torch.tune import plan_for_config
from test_parity_fuzz import RANGE_CASES, _data_for, _draw_range_case
from test_range import _range_module
from test_torch_range import EUCL_ATOL, EUCL_RTOL, range_module

#: the sweep's cases, split into this many parametrised chunks
CHUNKS = 6
#: the tuner's axis values (``tune.tuner._axis_values``) before clamping
_TILE_ROWS = (16, 32, 64, 128, 256, 512)
_DIMS_PER_TILE = (32, 64, 128, 256)
_BATCHES = (16, 32, 64, 128, 256)


def _cases():
    """The reference's range sweep: the same master seed, the same
    per-case generators (``test_fuzz_range_family``)."""
    master = np.random.default_rng(733)
    return [(i, _draw_range_case(master)) for i in range(RANGE_CASES)]


def _inputs(case, rng):
    """(inputs, tau, reference module, port module) for the case, drawn
    in the order ``_run_range_case`` draws them."""
    m, n, dim = case["m"], case["n"], case["dim"]
    rarch = R.ArchSpec(rows=case["rows"], cols=case["cols"])
    tarch = T.ArchSpec(rows=case["rows"], cols=case["cols"])
    if case["interval"]:
        q = rng.standard_normal((m, dim)).astype(np.float32)
        lo = np.full((n, dim), -np.inf, np.float32)
        hi = np.full((n, dim), np.inf, np.float32)
        sel = rng.random((n, dim)) < 0.2
        lo[sel] = (rng.standard_normal(sel.sum()) - 1.5).astype(np.float32)
        hi[sel] = lo[sel] + rng.uniform(0.5, 4.0)
        return ((q, lo, hi), None,
                _range_module(m, n, dim, rarch, interval=True),
                range_module(T, tcd, m, n, dim, interval=True, arch=tarch))
    metric = case["metric"]
    q, p = _data_for(rng, metric, m, n, dim)
    probe = R.get_plan(_range_module(m, n, dim, rarch, metric=metric,
                                     tau=0.0)).spec
    d = np.asarray(rref.tiled_distances(
        jnp.asarray(q), jnp.asarray(p), metric=metric,
        tile_rows=probe.tile_rows, dims_per_tile=probe.dims_per_tile))
    tau = float(np.quantile(d, case["quantile"]))
    kw = dict(metric=metric, tau=tau, below=case["below"])
    return ((q, p), tau, _range_module(m, n, dim, rarch, **kw),
            range_module(T, tcd, m, n, dim, arch=tarch, **kw))


def _assert_same(case, ins, tau, got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.bool_ and got.shape == want.shape, (what, case)
    if case["interval"] or case["metric"] != "eucl":
        np.testing.assert_array_equal(got, want, err_msg=f"{what} {case}")
        return
    rows, cols = np.nonzero(got != want)
    q64, p64 = ins[0].astype(np.float64), ins[1].astype(np.float64)
    d = ((q64[rows] - p64[cols]) ** 2).sum(1)
    assert np.all(np.abs(d - tau) <= EUCL_ATOL + EUCL_RTOL * abs(tau)), \
        f"{what}: not float64 near-ties {list(zip(rows, cols))} {case}"


def _retile_config(case, spec, rng):
    """A candidate of the tuner's axes, clamped to the workload as
    ``_axis_values`` clamps it."""
    m = spec.m
    return {"tile_rows": min(int(rng.choice(_TILE_ROWS)), spec.n),
            "dims_per_tile": min(int(rng.choice(_DIMS_PER_TILE)), spec.dim),
            "batch": min(int(rng.choice(_BATCHES)), max(8, 2 * m)),
            "pack": case["pack"], "unroll": 1, "shards": 1}


def _run(i, case):
    rng = np.random.default_rng(np.random.SeedSequence([733, i]))
    ins, tau, rmod, tmod = _inputs(case, rng)
    rplan = R.get_plan(rmod, pack=case["pack"])
    want = np.asarray(rplan.execute(*ins))
    for backend in ("torch", "cuda"):
        plan = T.get_plan(tmod, backend=backend, pack=case["pack"],
                          device="cpu")
        assert plan is not None, case
        tspec = plan.spec
        got = plan.execute(*ins).numpy()
        _assert_same(case, ins, tau, got, want, f"{backend}: port!=reference")
        if backend == "torch":
            assert plan.packed == rplan.packed, case
            interp = execute_module(tmod, *ins, device="cpu")[0].numpy()
            np.testing.assert_array_equal(interp, got,
                                          err_msg=f"engine!=interp {case}")
            _check_faults(case, plan, ins, got)

    # the tuner's re-tiling: one config through both packages
    cfg = _retile_config(case, rplan.spec,
                         np.random.default_rng(np.random.SeedSequence(
                             [733, i, 1])))
    rtuned = r_plan_for_config(rplan.spec, dict(cfg, backend="jnp"))
    rwant = np.asarray(rtuned.execute(*ins))
    for backend in ("torch", "cuda"):
        tuned = plan_for_config(tspec, dict(cfg, backend=backend),
                                device="cpu")
        assert (tuned.spec.tile_rows, tuned.spec.dims_per_tile,
                tuned.batch) == (rtuned.spec.tile_rows,
                                 rtuned.spec.dims_per_tile,
                                 rtuned.batch), (cfg, case)
        _assert_same(case, ins, tau, tuned.execute(*ins).numpy(), rwant,
                     f"{backend} at {cfg}: port!=reference")


def _check_faults(case, plan, ins, clean):
    """The reference's ``_check_range_faults`` through the port plan."""
    if case["faults"] is None:
        return
    fm, rm = FaultModel(**case["faults"]), RFaultModel(**case["faults"])
    f = plan.execute(*ins, faults=fm).numpy()
    if fm.is_null:
        np.testing.assert_array_equal(f, clean,
                                      err_msg=f"null-faults!=clean {case}")
        return
    corrupted = rm.corrupt_stored(tuple(np.asarray(s) for s in ins[1:]),
                                  plan.spec)
    w = plan.execute(ins[0], *corrupted).numpy()
    np.testing.assert_array_equal(f, w,
                                  err_msg=f"faults!=corrupted-src {case}")
    f2 = plan.execute(*ins, faults=FaultModel(**case["faults"])).numpy()
    np.testing.assert_array_equal(f, f2,
                                  err_msg=f"faults not reproducible {case}")


def test_sweep_is_the_reference_range_family():
    cases = _cases()
    assert len(cases) == RANGE_CASES
    assert any(c["interval"] for _, c in cases)
    assert {c["metric"] for _, c in cases if not c["interval"]} == \
        {"hamming", "dot", "eucl"}


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_fuzz_range_family_matches_reference(chunk):
    for i, case in _cases()[chunk::CHUNKS]:
        _run(i, case)
