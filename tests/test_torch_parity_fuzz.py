"""The similarity family of ``tests/test_parity_fuzz.py`` through the
port: the same random programs (metric x k x n<k x packed/unpacked x
ternary care masks x tile geometry x unrolled/loop-structured IR x fault
model absent/null/real), drawn by the reference's own generator from the
same seeds, compiled by both packages and run through ``get_plan`` ->
``execute`` (the port on its CPU ``"torch"`` backend, the reference on
``"jnp"``) and through the port's IR interpreter.

Indices and integer values are bit-identical to the reference's; eucl
values agree to the stated tolerance with index swaps only between
float64 near-ties.  A null fault model is bit-identical to no model, and
a real one equals the clean port plan on the reference model's corrupted
sources.  The sweep is split into ``CHUNKS`` interleaved chunks, the
cases of one parametrised test; every failure message carries the case.

The hierarchical family rides along (``_draw_hier_case``, its seeds,
``HIER_CASES``, in ``HIER_CHUNKS`` chunks): at ``nprobe == clusters``
the port's two-stage plan equals its flat plan, at the partial
``nprobe = clusters // 2`` it equals the reference's two-stage plan, and
recall against the flat result is monotone in ``nprobe``.
"""

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.faults import FaultModel as RFaultModel
from repro_torch.core import cim_dialect as tcd
from repro_torch.core.executor import execute_module
from repro_torch.faults import FaultModel
from test_parity_fuzz import (HIER_CASES, SIM_CASES, _data_for,
                              _draw_hier_case, _draw_sim_case, _sim_module,
                              _ternary_module)
from test_torch_kernels import _assert_eucl_close

#: the sweep's cases, split into this many parametrised chunks
CHUNKS = 12
#: the hierarchical sweep's chunks
HIER_CHUNKS = 4


def _cases():
    """The reference's similarity sweep: the same master seed, the same
    per-case generators (``test_fuzz_similarity_family``)."""
    master = np.random.default_rng(20260729)
    out = []
    for i in range(SIM_CASES):
        case = _draw_sim_case(master)
        out.append((i, case))
    return out


def _port_module(case):
    """The case's program built with the port's IR (the twin of the
    reference generator's ``_sim_module`` / ``_ternary_module``)."""
    m, n, dim, k = case["m"], case["n"], case["dim"], case["k"]
    metric = "hamming" if case["care"] else case["metric"]
    args = [T.TensorType((m, dim)), T.TensorType((n, dim))]
    if case["care"]:
        args.append(T.TensorType((n, dim)))
    mod = T.Module("fuzz", args)
    a = mod.arguments
    b = T.Builder(mod.body)
    dev = tcd.make_acquire(b)
    exe = tcd.make_execute(b, dev.result, list(a),
                           [T.TensorType((m, k)),
                            T.TensorType((m, k), "i32")])
    blk = exe.region().block()
    sim = tcd.make_similarity(blk, a[0], a[1], metric=metric, k=k,
                              largest=False if case["care"]
                              else case["largest"],
                              care=a[2] if case["care"] else None)
    tcd.make_yield(blk, sim.results)
    tcd.make_release(b, dev.result)
    b.ret(exe.results)
    pm = T.PassManager()
    pm.add(T.passes.CompulsoryPartition(
        unroll_limit=64 if case["care"] else case["unroll"]))
    return pm.run(mod, {"arch": T.ArchSpec(rows=case["rows"],
                                           cols=case["cols"])})


def _ref_module(case):
    m, n, dim, k = case["m"], case["n"], case["dim"], case["k"]
    arch = R.ArchSpec(rows=case["rows"], cols=case["cols"])
    if case["care"]:
        return _ternary_module(m, n, dim, k, arch)
    return _sim_module(case["metric"], k, case["largest"], m, n, dim, arch,
                       unroll_limit=case["unroll"])


def _inputs(case, rng):
    """The reference sweep's inputs for the case (same draws in the same
    order as ``_run_sim_case``)."""
    m, n, dim = case["m"], case["n"], case["dim"]
    q, p = _data_for(rng, case["metric"], m, n, dim)
    if not case["care"]:
        return (q, p)
    care = (rng.random((n, dim)) > 0.3).astype(np.float32)
    care[rng.integers(n)] = 0.0        # an all-wildcard row
    return (q, p, care)


def _assert_same(case, q, p, got, want, what):
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    assert gv.shape == wv.shape and gi.shape == wi.shape, (what, case)
    if case["metric"] == "eucl":
        try:
            _assert_eucl_close(q.reshape(-1, q.shape[-1]), p, wv, wi, gv, gi)
        except AssertionError as e:
            raise AssertionError(f"{what} {case}") from e
        return
    np.testing.assert_array_equal(gi, wi, err_msg=f"{what} {case}")
    np.testing.assert_array_equal(gv, wv, err_msg=f"{what} {case}")


def _run(i, case):
    rng = np.random.default_rng(np.random.SeedSequence([20260729, i]))
    inputs = _inputs(case, rng)
    q, p = inputs[0], inputs[1]
    mod = _port_module(case)
    plan = T.get_plan(mod, backend="torch", pack=case["pack"], device="cpu")
    rplan = R.get_plan(_ref_module(case), pack=case["pack"])
    assert plan is not None and rplan is not None, case
    assert plan.packed == rplan.packed and plan.tiny == rplan.tiny, case

    ev, ei = (x.numpy() for x in plan.execute(*inputs))
    _assert_same(case, q, p, (ev, ei), rplan.execute(*inputs),
                 "port!=reference")
    _assert_same(case, q, p, tuple(x.numpy() for x in execute_module(
        mod, *inputs, device="cpu")), (ev, ei), "engine!=interp")

    if case["faults"] is None:
        return
    fm, rm = FaultModel(**case["faults"]), RFaultModel(**case["faults"])
    fv, fi = (x.numpy() for x in plan.execute(*inputs, faults=fm))
    if fm.is_null:
        np.testing.assert_array_equal(fi, ei, f"null-faults!=clean {case}")
        np.testing.assert_array_equal(fv, ev, f"null-faults!=clean {case}")
        return
    _assert_same(case, q, p, (fv, fi), rplan.execute(*inputs, faults=rm),
                 "faults: port!=reference")
    corrupted = rm.corrupt_stored(tuple(np.asarray(s) for s in inputs[1:]),
                                  rplan.spec)
    wv, wi = (x.numpy() for x in plan.execute(q, *corrupted))
    np.testing.assert_array_equal(fi, wi, f"faults!=corrupted-src {case}")
    np.testing.assert_array_equal(fv, wv, f"faults!=corrupted-src {case}")


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_fuzz_similarity_family_matches_reference(chunk):
    cases = _cases()
    for i, case in cases[chunk::CHUNKS]:
        _run(i, case)


def _run_hier(i, case):
    """The reference's ``_run_hier_case`` through both packages."""
    rng = np.random.default_rng(np.random.SeedSequence([40817, i]))
    m, n, dim, k = case["m"], case["n"], case["dim"], case["k"]
    metric, c, pack = case["metric"], case["clusters"], case["pack"]
    q, p = _data_for(rng, metric, m, n, dim)
    mod = _port_module(dict(case, care=False))
    rmod = _ref_module(dict(case, care=False))
    flat = T.get_plan(mod, backend="torch", pack=pack, device="cpu")
    fv, fi = (x.numpy() for x in flat.execute(q, p))
    flat_sets = [set(map(int, row)) for row in fi]
    recalls = []
    for nprobe in sorted({1, max(1, c // 2), c}):
        hp = T.get_hierarchical_plan(mod, clusters=c, nprobe=nprobe,
                                     pack=pack, device="cpu")
        hv, hi = (x.numpy() for x in hp.execute(q, p))
        if nprobe == max(1, c // 2):
            # a partial probe depends on the centroids and the coarse
            # ranking: the reference's plan here (its jit is the sweep's
            # cost, so the other nprobe are held to the port's flat plan)
            rp = R.get_hierarchical_plan(rmod, clusters=c, nprobe=nprobe,
                                         pack=pack)
            _assert_same(case, q, p, (hv, hi), rp.execute(q, p),
                         f"hier nprobe={nprobe}: port!=reference")
        if nprobe == c:
            _assert_same(case, q, p, (hv, hi), (fv, fi), "hier!=flat")
        recalls.append(np.mean([
            len(set(map(int, row)) & fs) / max(len(fs), 1)
            for row, fs in zip(hi, flat_sets)]))
    assert all(a <= b + 1e-9 for a, b in zip(recalls, recalls[1:])), \
        f"recall not monotone in nprobe: {recalls} {case}"
    assert recalls[-1] > 1.0 - 1e-9, f"nprobe=all recall {recalls} {case}"


@pytest.mark.parametrize("chunk", range(HIER_CHUNKS))
def test_fuzz_hierarchical_family_matches_reference(chunk):
    master = np.random.default_rng(40817)
    cases = [(i, _draw_hier_case(master)) for i in range(HIER_CASES)]
    for i, case in cases[chunk::HIER_CHUNKS]:
        _run_hier(i, case)
