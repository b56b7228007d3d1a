"""The float top-k kernel's tensor-core arithmetic and the engine's ragged
last micro-batch, on the CPU.

* B2's "wgmma" route takes the product as 3xTF32
  (``cam_search.tf32_split_product``); the top-k over that product equals
  the Pallas kernel (interpret mode) bit for bit on {0, 1} and +-1 cells,
  and on eucl every index swap is a float64 near-tie.
* The engine runs the last micro-batch at its own row count: query counts
  624 (one short chunk) and 1030 (1024 + 6) through ``compile_fn`` /
  ``compile_module`` -> ``get_plan`` -> ``execute`` equal the reference
  (its ``"jnp"`` backend, which pads the tail to keep one jitted shape),
  for search, packed and range plans on both port backends, and the
  chunk function sees ``valid`` rows, never the padded batch.

Tolerances as in test_torch_kernels.py and test_torch_range.py: integer
metrics bit-identical; eucl values within ``rtol=1e-5, atol=1e-4`` and
index swaps or match flips only at float64 near-ties.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import cim_dialect as rcd
from repro.kernels import cam_search as rcs
from repro_torch.core import cim_dialect as tcd
from repro_torch.kernels import cam_search as tcs
from test_torch_frontend import hamming_module, knn_kernel
from test_torch_kernels import (_assert_candidates_equal, _assert_eucl_close,
                                _np, _pad_rows, _t)
from test_torch_range import _assert_match, _programs as _range_programs

RAGGED_M = [624, 1030]
BACKENDS = ["torch", "cuda"]


# ---------------------------------------------------------------------------
# B2's 3xTF32 arithmetic against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cells,metric,largest", [
    ("binary", "hamming", False), ("binary", "hamming", True),
    ("bipolar", "dot", True), ("bipolar", "dot", False)])
@pytest.mark.parametrize("k", [1, 6, 33])
def test_tf32_topk_matches_pallas_on_integer_cells(cells, metric, largest, k,
                                                   rng):
    """On {0, 1} and +-1 cells the TF32 lo halves are 0 and every partial
    sum an exact integer: the tensor-core route's arithmetic gives the
    Pallas kernel's candidates bit for bit (ties included: 40 dims give
    few distinct distances)."""
    m, n, dim = 13, 300, 40
    q = (rng.random((m, dim)) > 0.5).astype(np.float32)
    p = (rng.random((n, dim)) > 0.5).astype(np.float32)
    if cells == "bipolar":
        q, p = 2 * q - 1, 2 * p - 1
    p = _pad_rows(p, 384)
    ref = rcs.fused_topk_pallas(jnp.asarray(q), jnp.asarray(p),
                                metric=metric, k=k, largest=largest,
                                block_n=128, n_valid=n)
    qt, pt = _t(q), _t(p)
    assert torch.equal(tcs.tf32_split_product(qt, pt), qt @ pt.T)
    port = tcs.fused_topk_reference(qt, pt, metric=metric, k=k,
                                    largest=largest, n_valid=n, tf32x3=True)
    _assert_candidates_equal(ref, port)


def test_tf32_topk_eucl_swaps_are_near_ties(rng):
    """eucl at the KNN value scale (class centres N(0, 4) plus N(0, 1)
    noise, 1024 dims): the 3xTF32 top-k against the Pallas kernel, values
    within tolerance and every index swap a float64 near-tie; of two equal
    gallery rows the lower ranks first."""
    m, n, dim, k = 24, 250, 1024, 5
    centers = rng.standard_normal((2, dim)).astype(np.float32) * 2.0
    q = centers[rng.integers(0, 2, m)] + \
        rng.standard_normal((m, dim)).astype(np.float32)
    p = centers[rng.integers(0, 2, n)] + \
        rng.standard_normal((n, dim)).astype(np.float32)
    p[7] = p[3]                                  # a planted exact tie
    p = _pad_rows(p, 256)
    rv, ri = rcs.fused_topk_pallas(jnp.asarray(q), jnp.asarray(p),
                                   metric="eucl", k=k, largest=False,
                                   block_n=128, n_valid=n)
    tv, ti = tcs.fused_topk_reference(_t(q), _t(p), metric="eucl", k=k,
                                      largest=False, n_valid=n, tf32x3=True)
    tol = dict(rtol=1e-5, atol=0.1)              # |d| about 2e3 .. 1e4
    np.testing.assert_allclose(tv.numpy(), _np(rv), **tol)
    q64, p64 = q.astype(np.float64), p.astype(np.float64)
    for r, c in zip(*np.nonzero(ti.numpy() != _np(ri))):
        a, b = int(ti[r, c]), int(_np(ri)[r, c])
        da = ((q64[r] - p64[a]) ** 2).sum()
        db = ((q64[r] - p64[b]) ** 2).sum()
        assert abs(da - db) <= tol["atol"] + tol["rtol"] * abs(db)
    # the planted twins: the lower row always ranks first
    idx = ti.numpy()
    for r in range(m):
        row = list(idx[r])
        if 3 in row and 7 in row:
            assert row.index(3) < row.index(7)


# ---------------------------------------------------------------------------
# the ragged last micro-batch
# ---------------------------------------------------------------------------


def _search_programs(kind, rng, m):
    ra, ta = R.ArchSpec(rows=16, cols=32), T.ArchSpec(rows=16, cols=32)
    if kind == "eucl":
        q = rng.standard_normal((m, 100)).astype(np.float32)
        g = rng.standard_normal((150, 100)).astype(np.float32)
        return (lambda **kw: R.compile_fn(knn_kernel, [q, g], ra,
                                          value_bits=8, **kw),
                lambda **kw: T.compile_fn(knn_kernel, [q, g], ta,
                                          value_bits=8, **kw), [q, g])
    q = (rng.random((m, 50)) > 0.5).astype(np.float32)
    g = (rng.random((77, 50)) > 0.5).astype(np.float32)
    return (lambda **kw: R.compile_module(
                hamming_module(R, rcd, m, 77, 50, 6, False), ra,
                value_bits=1, **kw),
            lambda **kw: T.compile_module(
                hamming_module(T, tcd, m, 77, 50, 6, False), ta,
                value_bits=1, **kw), [q, g])


def _chunk_rows(monkeypatch, plan):
    """Record the query rows of every chunk the plan runs."""
    seen = []
    inner = plan._chunk_fn

    def spy(q, pp):
        seen.append(int(q.shape[0]))
        return inner(q, pp)

    monkeypatch.setattr(plan, "_chunk_fn", spy)
    return seen


def _expected_chunks(m, batch):
    return [min(batch, m - s) for s in range(0, m, batch)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["eucl", "packed"])
@pytest.mark.parametrize("m", RAGGED_M)
def test_ragged_search_matches_reference(kind, m, backend, monkeypatch, rng):
    rprog, tprog, ins = _search_programs(kind, rng, m)
    rp = rprog(backend="jnp")
    tp = tprog(backend=backend, device="cpu")
    plan = tp.engine_plan
    assert plan.packed == (kind == "packed") and plan.batch == 1024
    assert not plan.tiny
    seen = _chunk_rows(monkeypatch, plan)
    rv, ri = (np.asarray(x) for x in rp(*ins))
    tv, ti = tp(*ins)
    assert seen == _expected_chunks(m, plan.batch)
    assert tuple(tv.shape) == rv.shape == (m, rv.shape[1])
    if kind == "eucl":
        _assert_eucl_close(ins[0], ins[1], rv, ri, tv.numpy(), ti.numpy())
    else:
        np.testing.assert_array_equal(tv.numpy(), rv)
        np.testing.assert_array_equal(ti.numpy(), ri)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["hamming", "eucl", "interval"])
@pytest.mark.parametrize("m", RAGGED_M)
def test_ragged_range_matches_reference(case, m, backend, monkeypatch, rng):
    rm, tm, ins = _range_programs(case, rng, m, 300)
    rplan = R.get_plan(rm, backend="jnp")
    tplan = T.get_plan(tm, backend=backend, device="cpu")
    assert tplan.batch == 1024 and not tplan.tiny
    seen = _chunk_rows(monkeypatch, tplan)
    want = rplan.execute(*ins)
    got = tplan.execute(*ins)
    assert seen == _expected_chunks(m, tplan.batch)
    _assert_match(case, ins, want, got)
