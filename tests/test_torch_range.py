"""Port range search vs the reference, on the CPU: the range oracles, the
interval (B3) and threshold (B4) kernels' plain versions against the
Pallas kernels in interpret mode, ``RangePlan`` on both port backends
against the reference's ``"jnp"`` / ``"pallas"`` plans, and the port's
IR interpreter against the reference's.

Integer metrics (hamming, dot / cos through bipolar cells) and interval
matches must be bit-identical.  eucl sums floats in another order: every
disagreement must be a float64 near-tie of the threshold,
``|d64 - tau| <= EUCL_ATOL + EUCL_RTOL * |tau|``.  The port's own
``"torch"`` range plan and interpreter share their accumulation order
and are bit-identical on every metric.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import cim_dialect as rcd
from repro.core.executor import execute_module as r_execute
from repro.kernels import acam as racam
from repro.kernels import ref as rref
from repro_torch import convert
from repro_torch.core import cim_dialect as tcd
from repro_torch.core.executor import execute_module as t_execute
from repro_torch.kernels import acam as tacam
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

EUCL_RTOL, EUCL_ATOL = 1e-5, 1e-4
PAIRS = [("jnp", "torch"), ("pallas", "cuda")]
#: (metric, tau, below) of the threshold programs; plus "interval"
THRESHOLD_CASES = [("hamming", 33.0, True), ("dot", 4.0, False),
                   ("cos", -2.0, False), ("eucl", 130.0, True)]


def range_module(pkg, cd, m, n, dim, *, interval=False, metric="hamming",
                 tau=0.0, below=True, arch=None):
    """Hand-built range program through the partition pass, in either
    package (``pkg`` is ``repro.core`` or ``repro_torch.core``)."""
    arch = arch or pkg.ArchSpec(rows=64, cols=64)
    args = [pkg.TensorType((m, dim))] + \
        [pkg.TensorType((n, dim))] * (2 if interval else 1)
    mod = pkg.Module("rng", args)
    b = pkg.Builder(mod.body)
    dev = cd.make_acquire(b)
    exe = cd.make_execute(b, dev.result, list(mod.arguments),
                          [pkg.TensorType((m, n), "i1")])
    blk = exe.region().block()
    if interval:
        rs = cd.make_range_search(blk, mod.arguments[0], lo=mod.arguments[1],
                                  hi=mod.arguments[2],
                                  extra_attrs={"value_bits": 1})
    else:
        rs = cd.make_range_search(blk, mod.arguments[0],
                                  patterns=mod.arguments[1], metric=metric,
                                  threshold=tau, below=below,
                                  extra_attrs={"value_bits": 1})
    cd.make_yield(blk, rs.results)
    cd.make_release(b, dev.result)
    b.ret(exe.results)
    pm = pkg.PassManager()
    pm.add(pkg.passes.CompulsoryPartition())
    return pm.run(mod, {"arch": arch})


def interval_data(rng, m, n, dim, constrained=0.05):
    """Queries + (lo, hi) with +-inf wildcards and a non-trivial match
    rate; row 0 holds query 0 exactly (inclusive bounds)."""
    q = rng.standard_normal((m, dim)).astype(np.float32)
    lo = np.full((n, dim), -np.inf, np.float32)
    hi = np.full((n, dim), np.inf, np.float32)
    sel = rng.random((n, dim)) < constrained
    lo[sel] = (rng.standard_normal(sel.sum()) - 2).astype(np.float32)
    hi[sel] = lo[sel] + 3.5
    if m:
        lo[0], hi[0] = q[0], q[0]
    return q, lo, hi


def threshold_data(rng, metric, m, n, dim):
    if metric == "hamming":
        return [(rng.random((m, dim)) > 0.5).astype(np.float32),
                (rng.random((n, dim)) > 0.5).astype(np.float32)]
    return [rng.standard_normal((m, dim)).astype(np.float32),
            rng.standard_normal((n, dim)).astype(np.float32)]


def _programs(case, rng, m, n, dim=70, runtime_m=None):
    """(reference module, port module, inputs) for one case, built from
    the same numpy inputs."""
    mq = m if runtime_m is None else runtime_m
    if case == "interval":
        kw = dict(interval=True)
        ins = list(interval_data(rng, mq, n, dim))
    else:
        metric, tau, below = next(c for c in THRESHOLD_CASES
                                  if c[0] == case)
        kw = dict(metric=metric, tau=tau, below=below)
        ins = threshold_data(rng, metric, mq, n, dim)
    return (range_module(R, rcd, m, n, dim, **kw),
            range_module(T, tcd, m, n, dim, **kw), ins)


def _near_ties_only(q, p, got, want, tau):
    """Every (query, row) where two eucl match matrices differ is a
    float64 near-tie of the threshold."""
    rows, cols = np.nonzero(np.asarray(got) != np.asarray(want))
    q64, p64 = q.astype(np.float64), p.astype(np.float64)
    d = ((q64[rows] - p64[cols]) ** 2).sum(1)
    assert np.all(np.abs(d - tau) <= EUCL_ATOL + EUCL_RTOL * abs(tau)), \
        (rows, cols, d)


def _assert_match(case, ins, ref, port):
    ref = np.asarray(ref)
    assert port.dtype == torch.bool and tuple(port.shape) == ref.shape
    got = port.numpy()
    if case == "eucl":
        _near_ties_only(ins[0].reshape(-1, ins[0].shape[-1]), ins[1],
                        got.reshape(-1, got.shape[-1]),
                        ref.reshape(-1, ref.shape[-1]), 130.0)
    else:
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric,tau", [("hamming", 28.0), ("dot", 3.0),
                                        ("cos", 0.1), ("eucl", 130.0)])
def test_cam_range_and_exact_oracles_match_reference(metric, tau, rng):
    if metric == "hamming":
        q = (rng.random((7, 64)) > 0.5).astype(np.float32)
        p = (rng.random((40, 64)) > 0.5).astype(np.float32)
        p[3] = q[2]                                  # one exact match
    else:
        q = rng.standard_normal((7, 64)).astype(np.float32)
        p = rng.standard_normal((40, 64)).astype(np.float32)
    ref = np.asarray(rref.cam_range(jnp.asarray(q), jnp.asarray(p), tau,
                                    metric=metric))
    got = tref.cam_range(torch.from_numpy(q), torch.from_numpy(p), tau,
                         metric=metric)
    assert got.dtype == torch.bool and 0 < ref.sum() < ref.size
    if metric in ("hamming", "dot"):
        np.testing.assert_array_equal(got.numpy(), ref)
    else:       # float sums: disagreements only within a near-tie of tau
        d = np.asarray(rref.distances(jnp.asarray(q), jnp.asarray(p),
                                      metric))
        bad = got.numpy() != ref
        assert np.all(np.abs(d[bad] - tau) <= 1e-4 + 1e-5 * abs(tau))
    if metric == "hamming":
        ex = tref.cam_exact(torch.from_numpy(q), torch.from_numpy(p))
        np.testing.assert_array_equal(
            ex.numpy(), np.asarray(rref.cam_exact(jnp.asarray(q),
                                                  jnp.asarray(p))))
        assert ex[2, 3]


def test_threshold_ties_inclusive_and_empty_rows(rng):
    q = (rng.random((1, 32)) > 0.5).astype(np.float32)
    p = np.repeat(q, 4, axis=0)
    p[1, :5] = 1 - p[1, :5]            # distance exactly 5
    p[2, :6] = 1 - p[2, :6]            # distance 6
    p[3, :] = 1 - p[3, :]              # distance 32
    for tau, want in [(5.0, [True, True, False, False]),
                      (4.0, [True, False, False, False])]:
        got = tref.cam_range(torch.from_numpy(q), torch.from_numpy(p), tau)
        ref = np.asarray(rref.cam_range(jnp.asarray(q), jnp.asarray(p), tau))
        np.testing.assert_array_equal(got.numpy()[0], want)
        np.testing.assert_array_equal(got.numpy(), ref)
    far = 1.0 - np.repeat(q, 10, axis=0)          # distance 32 everywhere
    got = tops.cam_range_match(torch.from_numpy(q), torch.from_numpy(far),
                               metric="hamming", threshold=4.0)
    assert got.shape == (1, 10) and not got.any()


def test_acam_oracles_match_reference(rng):
    q = np.array([[0.5, -1.0], [2.0, 0.0], [np.nan, 0.0]], np.float32)
    lo = np.array([[0.5, -np.inf], [0.6, -np.inf], [-np.inf, 0.0]],
                  np.float32)
    hi = np.array([[0.5, np.inf], [1.0, np.inf], [np.inf, np.inf]],
                  np.float32)
    got = tref.acam_match(*map(torch.from_numpy, (q, lo, hi)))
    # inclusive bounds, wildcard dims, and a NaN cell violating nothing
    np.testing.assert_array_equal(got.numpy(), [[True, False, False],
                                                [False, False, True],
                                                [True, True, True]])
    q, lo, hi = interval_data(rng, 23, 137, 70)
    for fn in ("acam_violations", "acam_match"):
        ref = np.asarray(getattr(rref, fn)(*map(jnp.asarray, (q, lo, hi))))
        mine = getattr(tref, fn)(*map(torch.from_numpy, (q, lo, hi)))
        np.testing.assert_array_equal(mine.numpy(), ref)
    assert 0 < ref.sum() < ref.size


# ---------------------------------------------------------------------------
# B3 / B4 plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,dim,n_valid", [(40, 300, 70, 300),
                                             (9, 137, 16, 100)])
def test_acam_plain_matches_pallas(m, n, dim, n_valid, rng):
    q, lo, hi = interval_data(rng, m, n, dim, constrained=0.03)
    ref = np.asarray(racam.acam_match_pallas(
        *map(jnp.asarray, (q, lo, hi)), n_valid=n_valid, interpret=True))
    d = tacam.ACAM_BLOCK_D
    ops = [tops.pad_to_blocks(torch.from_numpy(x), 1, d) for x in (q, lo, hi)]
    got = tacam.acam_match(*ops, n_valid=n_valid)      # CPU: plain version
    np.testing.assert_array_equal(got.numpy(), ref != 0)
    assert not got[:, n_valid:].any() and 0 < ref.sum() < ref.size


def _f32(bits):
    return np.array(bits, np.uint32).view(np.float32)


_TINY = np.float32(2.0 ** -126)                 # the least normal float32
_MAX = np.finfo(np.float32).max
#: edge values of each interval case; every value is a query and every
#: ordered pair a row's (lo, hi) in dim 0 (dims 1..15 wildcards)
ACAM_EDGES = {
    "signed_zeros": [0.0, -0.0, 1.0, -1.0, _TINY, -_TINY],
    "nan_either_sign": [np.nan, _f32(0xFFC00000), _f32(0x7F800001),
                        _f32(0xFFFFFFFF), 0.0, -1.0, np.inf, -np.inf],
    "infinities": [np.inf, -np.inf, 0.0, 1.0, -1.0, _MAX, -_MAX],
    # normal operands a subnormal step apart
    "subnormal_gaps": [_TINY, np.nextafter(_TINY, np.float32(1)),
                       2 * _TINY, np.nextafter(2 * _TINY, np.float32(0)),
                       -_TINY, np.nextafter(-_TINY, np.float32(-1)),
                       np.float32(1.5) * _TINY, 0.0],
    "overflowing_differences": [_MAX, -_MAX, np.float32(3e38),
                                np.float32(-3e38), np.float32(2e38), 0.0],
}


def acam_edges(values, dim=16):
    """Queries (each value in every dim) and rows (every ordered pair of
    values as dim 0's bounds, wildcards elsewhere)."""
    v = np.array(values, np.float32)
    q = np.repeat(v[:, None], dim, 1)
    lo = np.full((v.size ** 2, dim), -np.inf, np.float32)
    hi = np.full((v.size ** 2, dim), np.inf, np.float32)
    lo[:, 0] = np.repeat(v, v.size)
    hi[:, 0] = np.tile(v, v.size)
    return q, lo, hi


def _ieee_match(q, lo, hi):
    """numpy's IEEE compares: no violation in any dim."""
    qq = q[:, None, :]
    return ~((qq < lo[None]) | (qq > hi[None])).any(-1)


@pytest.mark.parametrize("case", sorted(ACAM_EDGES))
def test_acam_signbits_matches_pallas_on_edge_values(case):
    """B3's arithmetic (canonical operands, the sign bits of ``q - lo``
    and ``hi - q`` OR'ed: ``acam_match_signbits``) and the plain version
    against the Pallas kernel (interpret mode), ``ref.acam_violations``
    and numpy's IEEE compares: signed zeros on both sides of a bound, NaN
    of either sign (and a signalling one) in q, lo and hi, infinities
    against wildcards and finite bounds, subnormal gaps between normal
    operands, differences that overflow."""
    q, lo, hi = acam_edges(ACAM_EDGES[case])
    n = lo.shape[0]
    ieee = _ieee_match(q, lo, hi)
    pallas = np.asarray(racam.acam_match_pallas(
        *map(jnp.asarray, (q, lo, hi)), n_valid=n, interpret=True)) != 0
    viol = np.asarray(rref.acam_violations(*map(jnp.asarray, (q, lo, hi))))
    ops = [torch.from_numpy(x) for x in (q, lo, hi)]
    twin = tacam.acam_match_signbits(*ops, n_valid=n).numpy()
    plain = tacam.acam_match_reference(*ops, n_valid=n).numpy()
    for got in (twin, plain, pallas, viol == 0):
        np.testing.assert_array_equal(got, ieee)
    assert 0 < ieee.sum() < ieee.size


def test_acam_signbits_on_subnormal_operands():
    """Subnormal operands: B3's arithmetic and the plain version against
    numpy's IEEE compares.  (XLA on the CPU flushes subnormal operands to
    zero, so the JAX reference is held to them on normal operands with
    subnormal gaps above.)"""
    sub = [np.float32(1e-45), np.float32(2e-45), np.float32(-1e-45),
           np.float32(3e-39), np.float32(-3e-39), 0.0, -0.0, _TINY]
    q, lo, hi = acam_edges(sub)
    n = lo.shape[0]
    ops = [torch.from_numpy(x) for x in (q, lo, hi)]
    ieee = _ieee_match(q, lo, hi)
    np.testing.assert_array_equal(
        tacam.acam_match_signbits(*ops, n_valid=n).numpy(), ieee)
    np.testing.assert_array_equal(
        tacam.acam_match_reference(*ops, n_valid=n).numpy(), ieee)
    assert 0 < ieee.sum() < ieee.size


@pytest.mark.parametrize("m,n,dim,n_valid", [(40, 300, 70, 300),
                                             (9, 137, 16, 100)])
def test_acam_signbits_matches_pallas(m, n, dim, n_valid, rng):
    """B3's arithmetic on interval data with wildcards and a NaN query
    cell, padded to the kernel's 16-dim stages, against the Pallas kernel
    (interpret mode)."""
    q, lo, hi = interval_data(rng, m, n, dim, constrained=0.03)
    q[min(1, m - 1), 2] = np.nan
    ref = np.asarray(racam.acam_match_pallas(
        *map(jnp.asarray, (q, lo, hi)), n_valid=n_valid, interpret=True))
    d = tacam.ACAM_BLOCK_D
    ops = [tops.pad_to_blocks(torch.from_numpy(x), 1, d) for x in (q, lo, hi)]
    got = tacam.acam_match_signbits(*ops, n_valid=n_valid)
    np.testing.assert_array_equal(got.numpy(), ref != 0)
    assert 0 < ref.sum() < ref.size


@pytest.mark.parametrize("metric,to_logical,tau", [
    ("hamming", "identity", 34.0), ("hamming", "bipolar", 2.0),
    ("dot", "identity", 4.0), ("eucl", "identity", 130.0)])
@pytest.mark.parametrize("below", [True, False])
def test_range_plain_matches_pallas(metric, to_logical, tau, below, rng):
    m, n, dim, n_valid = 40, 300, 70, 271
    if metric == "eucl":
        q, p = threshold_data(rng, "eucl", m, n, dim)
    elif metric == "dot":                             # bipolar +-1 cells
        q = np.where(rng.random((m, dim)) > 0.5, 1, -1).astype(np.float32)
        p = np.where(rng.random((n, dim)) > 0.5, 1, -1).astype(np.float32)
    else:
        q, p = threshold_data(rng, "hamming", m, n, dim)
    kw = dict(metric=metric, threshold=tau, below=below,
              to_logical=to_logical, dim=dim, n_valid=n_valid)
    ref = np.asarray(racam.range_match_pallas(
        jnp.asarray(q), jnp.asarray(p), interpret=True, **kw)) != 0
    qp, pp = (tops.pad_to_blocks(torch.from_numpy(x), 1, 8) for x in (q, p))
    got = tacam.range_match(qp, pp, **kw)             # CPU: plain version
    assert 0 < ref.sum() < ref.size
    if metric == "eucl":
        _near_ties_only(q, p, got.numpy(), ref, tau)
    else:
        np.testing.assert_array_equal(got.numpy(), ref)


def test_tf32_split_product_on_knn_scale_eucl_matches_pallas(rng):
    """The range kernel's 3xTF32 arithmetic, emulated in float32 on the
    CPU, against the Pallas kernel (interpret mode) on eucl data at the
    smoke's value scale (the KNN gallery's class centres N(0, 4) plus
    N(0, 1) noise, D = 1024, squared distances about 1,750 near tau):
    every disagreement a float64 near-tie of tau."""
    m, n, dim = 48, 300, 1024
    centers = rng.standard_normal((2, dim)).astype(np.float32) * 2.0
    q = centers[rng.integers(0, 2, m)] + \
        rng.standard_normal((m, dim)).astype(np.float32)
    p = centers[rng.integers(0, 2, n)] + \
        rng.standard_normal((n, dim)).astype(np.float32)
    d64 = ((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1)
    tau = float(np.median(d64[d64 < np.median(d64)]))   # the near class
    assert 1000 < tau < 2500
    kw = dict(metric="eucl", threshold=tau, below=True,
              to_logical="identity", dim=dim, n_valid=n)
    ref = np.asarray(racam.range_match_pallas(
        jnp.asarray(q), jnp.asarray(p), interpret=True, **kw)) != 0
    qt, pt = torch.from_numpy(q), torch.from_numpy(p)
    got = tacam.range_match_reference(qt, pt, tf32x3=True, **kw).numpy()
    assert 0 < ref.sum() < ref.size
    _near_ties_only(q, p, got, ref, tau)
    prod = tacam.tf32_split_product(qt, pt).double()
    exact = torch.from_numpy(q).double() @ torch.from_numpy(p).double().T
    # the split keeps about 22 bits of each product: as close as float32
    # sums (whose own rounding dominates here), far closer than one TF32
    # product
    plain = (qt @ pt.T).double()
    tf32 = (tacam.tf32_round(qt) @ tacam.tf32_round(pt).T).double()
    err = float((prod - exact).abs().max())
    assert err <= 2 * float((plain - exact).abs().max())
    assert 50 * err < float((tf32 - exact).abs().max())


@pytest.mark.parametrize("cells", ["binary", "bipolar"])
def test_tf32_split_product_is_exact_on_binary_and_bipolar_cells(cells,
                                                                 rng):
    """On {0, 1} and +-1 cells lo is 0: the split product equals the
    float32 product and the match equals the Pallas kernel's."""
    m, n, dim = 40, 300, 200
    q, p = threshold_data(rng, "hamming", m, n, dim)
    metric, tau, to_logical = "hamming", 98.0, "identity"
    if cells == "bipolar":
        q, p = 2 * q - 1, 2 * p - 1
        metric, tau = "dot", 4.0
    qt, pt = torch.from_numpy(q), torch.from_numpy(p)
    assert torch.equal(tacam.tf32_round(qt), qt)
    assert torch.equal(tacam.tf32_split_product(qt, pt), qt @ pt.T)
    kw = dict(metric=metric, threshold=tau, below=True,
              to_logical=to_logical, dim=dim, n_valid=n)
    ref = np.asarray(racam.range_match_pallas(
        jnp.asarray(q), jnp.asarray(p), interpret=True, **kw)) != 0
    got = tacam.range_match_reference(qt, pt, tf32x3=True, **kw).numpy()
    assert 0 < ref.sum() < ref.size
    np.testing.assert_array_equal(got, ref)


def test_tf32_round_is_round_to_nearest_ties_away():
    """``tf32_round`` is ``cvt.rna.tf32.f32``: 10 mantissa bits, ties
    away from zero, the low 13 bits cleared."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 0.0,
                         -0.0], dtype=torch.float32)
    got = tacam.tf32_round(x)
    assert torch.equal(got, want)
    assert not bool((got.view(torch.int32) & 0x1FFF).any())


# ---------------------------------------------------------------------------
# RangePlan and the interpreter vs the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
@pytest.mark.parametrize("case", ["hamming", "dot", "cos", "eucl",
                                  "interval"])
@pytest.mark.parametrize("n", [300, 5])
def test_range_plan_matches_reference(case, n, ref_backend, backend, rng):
    rm, tm, ins = _programs(case, rng, 40, n)
    rplan = R.get_plan(rm, backend=ref_backend)
    tplan = T.get_plan(tm, backend=backend, device="cpu")
    assert isinstance(tplan, T.RangePlan)
    assert isinstance(tplan.spec, T.RangeSpec)
    assert (tplan.packed, tplan.tiny) == (rplan.packed, rplan.tiny)
    assert dataclasses.asdict(tplan.spec) == dataclasses.asdict(rplan.spec)
    _assert_match(case, ins, rplan.execute(*ins), tplan.execute(*ins))


@pytest.mark.parametrize("case", ["hamming", "cos", "eucl", "interval"])
def test_interpreter_matches_reference_and_torch_plan(case, rng):
    """The port's interpreter equals the reference's, and the port's
    ``"torch"`` range plan equals its interpreter bit for bit (eucl
    included: the same accumulation order)."""
    rm, tm, ins = _programs(case, rng, 40, 300)
    mine = t_execute(tm, *ins, device="cpu")[0]
    _assert_match(case, ins, r_execute(rm, *ins)[0], mine)
    plan = T.get_plan(tm, backend="torch", device="cpu")
    assert torch.equal(plan.execute(*ins), mine)
    assert torch.equal(t_execute(tm, *ins, backend="cuda", device="cpu")[0],
                       mine)


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
@pytest.mark.parametrize("runtime_m", [0, 3, 21])
def test_runtime_m_differs_from_trace(runtime_m, ref_backend, backend, rng):
    """Runtime query counts below, across and at zero of the traced
    M=13 with a micro-batch of 8."""
    for case in ("hamming", "interval"):
        rm, tm, ins = _programs(case, rng, 13, 77, runtime_m=runtime_m)
        rplan = R.get_plan(rm, backend=ref_backend, batch=8)
        tplan = T.get_plan(tm, backend=backend, batch=8, device="cpu")
        before = tplan.chunks_run
        got = tplan.execute(*ins)
        assert got.shape == (runtime_m, 77) and got.dtype == torch.bool
        assert tplan.chunks_run - before == -(-runtime_m // 8)
        if runtime_m:
            _assert_match(case, ins, rplan.execute(*ins), got)


def test_pack_demotion_and_refusal_on_cuda(rng):
    _, tm, ins = _programs("hamming", rng, 8, 64)
    assert T.get_plan(tm, backend="torch", device="cpu").packed
    assert not T.get_plan(tm, backend="cuda", device="cpu").packed
    with pytest.raises(ValueError, match="packed range"):
        T.get_plan(tm, backend="cuda", pack=True, device="cpu")
    packed = T.get_plan(tm, backend="torch", pack=True, device="cpu")
    floats = T.get_plan(tm, backend="torch", pack=False, device="cpu")
    assert torch.equal(packed.execute(*ins), floats.execute(*ins))
    with pytest.raises(ValueError, match="packed"):
        T.get_plan(_programs("eucl", rng, 8, 64)[1], backend="torch",
                   pack=True, device="cpu")
    # gallery mutation on the demoted plan: memo-seeded, same matches as
    # the packed plan on the mutated gallery
    g = torch.from_numpy(ins[1].copy())
    floats.execute(ins[0], g)
    g2 = floats.update_rows(g, [0], ins[1][1:2])
    assert floats.row_update_fallbacks == 0
    assert torch.equal(floats.execute(ins[0], g2), packed.execute(ins[0], g2))


def test_range_and_search_keys_never_collide(rng):
    T.clear_plan_cache()
    m, n, dim = 8, 32, 64
    pa = T.get_plan(range_module(T, tcd, m, n, dim, tau=10.0), device="cpu")
    pb = T.get_plan(range_module(T, tcd, m, n, dim, tau=10.0), device="cpu")
    pc = T.get_plan(range_module(T, tcd, m, n, dim, tau=11.0), device="cpu")
    pz = T.get_plan(range_module(T, tcd, m, n, dim, tau=-0.0), device="cpu")
    assert pa is pb and pa is not pc and pz.spec.threshold == 0.0
    assert str(pz.spec.threshold) == "0.0"
    from test_torch_frontend import hamming_module
    sim = hamming_module(T, tcd, m, n, dim, 3)
    pm = T.PassManager()
    pm.add(T.passes.CompulsoryPartition())
    ps = T.get_plan(pm.run(sim, {"arch": T.ArchSpec(rows=64, cols=64)}),
                    device="cpu")
    assert isinstance(ps, T.SearchPlan) and not isinstance(ps, T.RangePlan)
    assert ps is not pa and T.plan_cache_stats()["plans"] == 4
    with pytest.raises(ValueError, match="NaN"):
        dataclasses.replace(pa.spec, threshold=float("nan"))


def test_interval_pair_memo_and_in_place_edit(rng):
    _, tm, (q, lo, hi) = _programs("interval", rng, 16, 90)
    plan = T.get_plan(tm, backend="cuda", device="cpu")
    lot, hit = torch.from_numpy(lo.copy()), torch.from_numpy(hi.copy())
    h0, m0 = plan.pattern_hits, plan.pattern_misses
    first = plan.execute(q, lot, hit)
    plan.execute(q, lot, hit)
    assert (plan.pattern_hits - h0, plan.pattern_misses - m0) == (1, 1)
    assert first[0, 0]
    lot[0, 0] = float(q[0, 0]) + 1.0          # in place: row 0 loses query 0
    edited = plan.execute(q, lot, hit)
    assert plan.pattern_misses - m0 == 2 and not edited[0, 0]
    assert torch.equal(edited, plan.execute(q, lot.clone(), hit.clone()))
    assert sum(key[0][0] == id(lot) for key in plan._pattern_cache) == 1


def test_program_without_plan_runs_through_interpreter(rng):
    """Host ops around a search give no engine plan: the call runs the
    interpreter on the program's device and equals the reference."""
    from test_torch_frontend import _add
    a = rng.standard_normal((8, 8)).astype(np.float32)
    b = rng.standard_normal((8, 8)).astype(np.float32)
    arch_r, arch_t = R.ArchSpec(rows=16, cols=16), T.ArchSpec(rows=16,
                                                              cols=16)
    rprog = R.compile_fn(_add, [a, b], arch_r)
    tprog = T.compile_fn(_add, [a, b], arch_t, device="cpu")
    assert tprog.engine_plan is None and tprog.device == torch.device("cpu")
    want = np.asarray(rprog(a, b)[0])
    for call in (tprog, tprog.execute_interpreted, tprog.execute_unplanned):
        got = call(a, b)[0]
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["interval", "hamming", "eucl"])
def test_reference_prepared_range_operands(case, rng):
    """A reference plan's prepared range operands carried across and fed
    to the port's chunk function give the reference's match matrix."""
    rm, tm, ins = _programs(case, rng, 8, 150)
    stored = [jnp.asarray(x) for x in ins[1:]]
    for ref_backend, backend in PAIRS:
        rplan = R.get_plan(rm, backend=ref_backend)
        tplan = T.get_plan(tm, backend=backend, device="cpu")
        arrays = [np.asarray(a) for a in rplan._prepared_patterns(*stored)]
        got = convert.prepared_from_reference(
            arrays, packed=rplan.packed, backend=backend, spec=tplan.spec)
        mine = tplan._prepared_patterns(*map(torch.from_numpy, ins[1:]))
        for a, b in zip(got, mine):
            assert a.dtype == b.dtype and torch.equal(a, b)
        q = torch.from_numpy(ins[0])
        hit = tplan._chunk_fn(q, got)[:, :tplan.spec.n]
        _assert_match(case, ins, rplan.execute(*ins), hit)
