"""The search route past 384 candidates (``k > MAX_K``) against the
reference, on the CPU.

The reference computes its block top-k inside its Pallas kernels for any
k; the port writes the (M, N) distance matrix (B6, or K1p on the packed
lanes) and selects from it (K1s).  Here the port runs on
``device="cpu"``, so on the kernels' plain versions
(``cam_search.topk_select_reference``, ``packed_distance_reference``),
against the reference's oracles (``repro.kernels.ref``), its ``"jnp"``
plans and its Pallas ops in interpret mode.  Integer metrics must be
bit-identical; eucl agrees to the tolerance of test_torch_kernels.py,
index swaps only between float64 near-ties.  The kernels themselves are
held to these plain versions bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py's ``queue_c``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import cim_dialect as rcd
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch import convert
from repro_torch.core import cim_dialect as tcd
from repro_torch.kernels import cam_search as tcs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packing as tpack
from test_torch_engine import _assert_results
from test_torch_update_rows import sim_module

ARCH_R, ARCH_T = R.ArchSpec(rows=64, cols=64), T.ArchSpec(rows=64, cols=64)


def _matrix(rng, kind, m, n):
    """An (m, n) float32 distance matrix: ``"random"`` normal values,
    ``"tied"`` every entry equal, ``"straddle"`` five values so that
    ties straddle every rank, ``"specials"`` +-inf, huge, tiny and
    negative values with ties (no zeros: the reference's ``lax.top_k``
    orders -0.0 below +0.0, where the port, like the reference's block
    extraction, ties them)."""
    if kind == "random":
        return rng.standard_normal((m, n)).astype(np.float32)
    if kind == "tied":
        return np.full((m, n), 2.0, np.float32)
    if kind == "straddle":
        return rng.integers(0, 5, (m, n)).astype(np.float32)
    pool = np.array([np.inf, -np.inf, -1.5, 2.0, 7.25, -3e38, 3e38, 1e-30],
                    np.float32)
    return pool[rng.integers(0, pool.size, (m, n))]


def _bits(rng, rows, dim, p=0.5):
    return (rng.random((rows, dim)) < p).astype(np.float32)


def _lanes(x: np.ndarray) -> torch.Tensor:
    return tpack.pack_bits(torch.from_numpy(x) != 0)


# ---------------------------------------------------------------------------
# K1s: the selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("largest", [False, True])
@pytest.mark.parametrize("kind", ["random", "tied", "straddle", "specials"])
@pytest.mark.parametrize("k", [385, "n_valid"])
def test_select_matches_reference_top_k(kind, k, largest, rng):
    """K1s's plain version against the reference's top-k with ties to
    the lower index over the live columns: every entry tied, ties
    straddling the k-th rank, infinities; ``n_valid < N``, and
    ``k == n_valid``."""
    m, n, n_valid = 6, 1000, 937
    d = _matrix(rng, kind, m, n)
    kk = n_valid if k == "n_valid" else k
    v, i = tcs.topk_select(torch.from_numpy(d), k=kk, largest=largest,
                           n_valid=n_valid)
    rv, ri = rref._topk_with_ties(jnp.asarray(d[:, :n_valid]), kk, largest)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert np.array_equal(v.numpy(), np.asarray(rv))
    assert np.array_equal(i.numpy(), np.asarray(ri))


@pytest.mark.parametrize("largest", [False, True])
def test_select_ties_signed_zeros_to_the_lower_column(largest):
    """-0.0 and +0.0 tie (``order_key``'s fold), so the lower column
    wins; the values keep their own bits."""
    d = np.array([[0.0, -0.0, 1.0, -0.0, 0.0, -1.0]], np.float32)
    v, i = tcs.topk_select(torch.from_numpy(d), k=5, largest=largest,
                           n_valid=6)
    want = [2, 0, 1, 3, 4] if largest else [5, 0, 1, 3, 4]
    assert i.tolist() == [want]
    assert np.array_equal(v.numpy().view(np.int32), d[:, want].view(np.int32))


def test_select_refusals():
    d = torch.zeros((2, 10))
    with pytest.raises(ValueError, match="k=11"):
        tcs.topk_select(d, k=11, largest=False, n_valid=10)
    with pytest.raises(ValueError, match="n_valid=11"):
        tcs.topk_select(d, k=3, largest=False, n_valid=11)
    with pytest.raises(ValueError, match="float32"):
        tcs.topk_select(d.double(), k=3, largest=False, n_valid=10)
    with pytest.raises(ValueError, match="contiguous"):
        tcs.topk_select(torch.zeros((10, 2)).T, k=3, largest=False,
                        n_valid=10)


@pytest.mark.parametrize("m,k", [(13, 400), (624, 500), (624, 400),
                                 (1, 385)])
def test_select_grid_fills_every_block_slot(m, k):
    """K1s's grid at the KNN width: two blocks an SM on an H100's 132 at
    13 rows and at 624 alike (the sort buffer of k pairs leaves room for
    two), one an SM once it does not, never more blocks than 16-column
    groups."""
    assert tcs.select_grid(m, k, 180_000, 132) == 264
    assert tcs.select_grid(m, 2000, 180_000, 132) == 132
    assert tcs.select_grid(m, 9000, 180_000, 132) == 264
    assert tcs.select_grid(1, 1, 40, 132) == 3


@pytest.mark.parametrize("m,n_valid,grid", [(13, 179_995, 264),
                                            (624, 180_000, 264),
                                            (1, 20_000, 264),
                                            (7, 1_001, 5), (3, 40, 9)])
def test_select_stretches_are_equal(m, n_valid, grid):
    """K1s's stretches cover every live column once and differ by at most
    one 16-column group (a row's shorter last group aside): at 13 rows
    as at 624, every block reads the same bytes."""
    cols = tcs.select_stretches(m, n_valid, grid)
    assert len(cols) == grid and sum(cols) == m * n_valid
    assert min(cols) > 0
    short = m * (-n_valid % tcs._SELECT_GROUP)     # the rows' short groups
    assert max(cols) - min(cols) <= tcs._SELECT_GROUP + min(short, 16)


@pytest.mark.parametrize("m,lanes,name,rows,grid", [
    (1, 32, "swapped", 8, 264), (13, 32, "swapped", 16, 264),
    (17, 32, "swapped", 32, 264),
    (13, 256, "swapped", 16, 132), (33, 32, "swapped", 64, 132),
    (64, 40, "swapped", 64, 132), (64, 256, "streamed", 128, 132),
    (65, 32, "resident", 128, 132), (624, 8, "resident", 128, 132),
    (624, 32, "resident", 128, 132), (624, 40, "streamed", 128, 132),
    (129, 256, "streamed", 128, 132)])
def test_packed_distance_route_by_shape(m, lanes, name, rows, grid):
    """K1p's route: the swapped operands at a 13-row micro-batch (16
    query columns, two blocks an SM while the unpacked queries leave room)
    and up to 64 queries whose unpacked lanes fit 128 KB, the resident
    128-query tile at 624 queries up to 32 lanes, streamed past them; the
    grid never exceeds the tiles."""
    r = tcs.packed_distance_route(m, 180_096, lanes, 132)
    assert (r.name, r.rows, r.grid) == (name, rows, grid)
    assert tcs.packed_distance_route(624, 256, 32, 132).grid == 10
    assert tcs.packed_distance_route(13, 256, 32, 132).grid == 4
    assert tcs.packed_distance_route(33, 180_096, 32, 132, True).grid == 132


# ---------------------------------------------------------------------------
# K1p: the packed distance matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ternary", [False, True])
def test_packed_distance_matches_reference(ternary, rng):
    """K1p's plain version against the reference's packed distances
    (binary and ternary), on lanes with bit 31 set."""
    q = rng.integers(0, 2 ** 32, (7, 16), dtype=np.uint32)
    p = rng.integers(0, 2 ** 32, (256, 16), dtype=np.uint32)
    c = rng.integers(0, 2 ** 32, (256, 16), dtype=np.uint32) \
        if ternary else None
    assert (q >> 31).any() and (p >> 31).any()
    t = [None if x is None else torch.from_numpy(x.view(np.int32))
         for x in (q, p, c)]
    got = tcs.packed_distance(*t)
    want = rref.packed_distances(jnp.asarray(q), jnp.asarray(p),
                                 None if c is None else jnp.asarray(c))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_packed_distance_refusals():
    q = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 128"):
        tcs.packed_distance(q, torch.zeros((100, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 8"):
        tcs.packed_distance(torch.zeros((3, 4), dtype=torch.int32),
                            torch.zeros((128, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        tcs.packed_distance(q.float(), torch.zeros((128, 8)))


# ---------------------------------------------------------------------------
# the route through the public ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("k", [400, 450])
def test_cam_topk_packed_past_the_window(ternary, k, rng):
    """``ops.cam_topk_packed`` past ``MAX_K``: K1p on the lanes (450 rows
    padded to 512: ``n_valid < N``) and K1s, against the reference's
    oracle on the unpacked cells; ``k = 450`` takes every row."""
    m, n, dim = 5, 450, 70
    q, p = _bits(rng, m, dim), _bits(rng, n, dim)
    c = _bits(rng, n, dim, 0.8) if ternary else None
    v, i = tops.cam_topk_packed(_lanes(q), _lanes(p),
                                None if c is None else _lanes(c), k=k)
    if ternary:
        rv, ri = rref.cam_topk_ternary(jnp.asarray(q), jnp.asarray(p),
                                       jnp.asarray(c), k=k)
    else:
        rv, ri = rref.cam_topk(jnp.asarray(q), jnp.asarray(p),
                               metric="hamming", k=k, largest=False)
    assert np.array_equal(v.numpy(), np.asarray(rv))
    assert np.array_equal(i.numpy(), np.asarray(ri))


def test_cam_topk_dot_largest_with_negative_zero_cells(rng):
    """``ops.cam_topk`` on ``dot`` with ``largest=True`` past ``MAX_K``,
    on cells holding -0.0 and negative values (every product an exact
    integer): equal to the reference's Pallas op in interpret mode and
    to its oracle."""
    pool = np.array([-2.0, -1.0, -0.0, 1.0, 2.0], np.float32)
    q = pool[rng.integers(0, pool.size, (5, 24))]
    p = pool[rng.integers(0, pool.size, (600, 24))]
    v, i = tops.cam_topk(torch.from_numpy(q), torch.from_numpy(p),
                         metric="dot", k=400, largest=True)
    for rv, ri in (rops.cam_topk(jnp.asarray(q), jnp.asarray(p),
                                 metric="dot", k=400, largest=True),
                   rref.cam_topk(jnp.asarray(q), jnp.asarray(p),
                                 metric="dot", k=400, largest=True)):
        assert np.array_equal(v.numpy(), np.asarray(rv))
        assert np.array_equal(i.numpy(), np.asarray(ri))


# ---------------------------------------------------------------------------
# the route through the engine
# ---------------------------------------------------------------------------


def _gallery(rng, case, n, dim):
    if case == "identical_rows":          # every distance tied
        return np.repeat(_bits(rng, 1, dim), n, axis=0)
    if case == "straddle":                # six rows, repeated: ties across k
        return _bits(rng, 6, dim)[np.arange(n) % 6]
    return _bits(rng, n, dim)


@pytest.mark.parametrize("case,k", [("identical_rows", 400),
                                    ("straddle", 400), ("ternary", 400),
                                    ("k_is_n", 500)])
def test_packed_matrix_plan_matches_reference(case, k, rng):
    """A packed hamming plan past ``MAX_K`` on the ``"cuda"`` backend
    (K1p, K1s) against the reference's ``"jnp"`` plan, bit for bit."""
    m, n, dim = 5, 500, 72
    care = case == "ternary"
    q, g = _bits(rng, m, dim), _gallery(rng, case, n, dim)
    ins = [q, g] + ([_bits(rng, n, dim, 0.8).astype(np.int8)] if care
                    else [])
    rplan = R.get_plan(sim_module(R, rcd, "hamming", k, False, m, n, dim,
                                  ARCH_R, care=care), backend="jnp")
    tplan = T.get_plan(sim_module(T, tcd, "hamming", k, False, m, n, dim,
                                  ARCH_T, care=care), backend="cuda",
                       device="cpu")
    assert tplan.packed and tcs.packed_route(m, n, k, 132) == "matrix"
    _assert_results("hamming", ins, rplan.execute(*ins), tplan.execute(*ins))


def test_eucl_matrix_plan_on_identical_rows_matches_reference(rng):
    """eucl past ``MAX_K`` (B6, K1s) with every gallery row the same: the
    reference's ``"jnp"`` plan within the eucl tolerance, every index a
    tie."""
    m, n, dim, k = 4, 450, 40, 400
    q = rng.standard_normal((m, dim)).astype(np.float32)
    g = np.repeat(rng.standard_normal((1, dim)).astype(np.float32), n, 0)
    rplan = R.get_plan(sim_module(R, rcd, "eucl", k, False, m, n, dim,
                                  ARCH_R), backend="jnp")
    tplan = T.get_plan(sim_module(T, tcd, "eucl", k, False, m, n, dim,
                                  ARCH_T), backend="cuda", device="cpu")
    assert tcs.float_route(k) == "matrix"
    _assert_results("eucl", [q, g], rplan.execute(q, g),
                    tplan.execute(q, g))


@pytest.mark.parametrize("ternary", [False, True])
def test_packed_matrix_plan_keeps_lanes(ternary, rng):
    """The packed matrix plan's prepared gallery is int32 lanes in rows
    padded to ``PACKED_ROWS``, 32x fewer elements than the cells; a
    ``"pallas"`` plan's prepared lanes carried over by
    ``convert.prepared_from_reference`` equal them, and the plan runs on
    them."""
    m, n, dim, k = 4, 500, 256, 400
    q, g = _bits(rng, m, dim), _bits(rng, n, dim)
    stored = [g] + ([_bits(rng, n, dim, 0.8).astype(np.int8)] if ternary
                    else [])
    rplan = R.get_plan(sim_module(R, rcd, "hamming", k, False, m, n, dim,
                                  ARCH_R, care=ternary), backend="pallas")
    tplan = T.get_plan(sim_module(T, tcd, "hamming", k, False, m, n, dim,
                                  ARCH_T, care=ternary), backend="cuda",
                       device="cpu")
    mine = tplan._prepared_patterns(*(torch.from_numpy(x) for x in stored))
    rows = -(-n // tcs.PACKED_ROWS) * tcs.PACKED_ROWS
    for x in mine:
        assert x.dtype == torch.int32 and tuple(x.shape) == (rows, dim // 32)
        assert 32 * x.numel() == rows * dim
    arrays = [np.asarray(a) for a in rplan._prepared_patterns(
        *(jnp.asarray(x) for x in stored))]
    got = convert.prepared_from_reference(arrays, packed=True,
                                          backend="cuda", spec=tplan.spec)
    assert len(got) == len(mine)
    assert all(torch.equal(a, b) for a, b in zip(got, mine))
    want = tplan.execute(q, *stored)
    out = tplan._chunk_fn(torch.from_numpy(q), got)
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


@pytest.mark.parametrize("ternary", [False, True])
def test_packed_matrix_row_update_equals_fresh_prepare(ternary, rng):
    """A row update on the packed matrix route re-packs the touched rows:
    its lanes equal a fresh prepare of the mutated gallery, and the plan's
    results on it equal the reference's ``"jnp"`` plan on that gallery."""
    m, n, dim, k = 5, 600, 72, 400
    q, g = _bits(rng, m, dim), _bits(rng, n, dim)
    care = torch.from_numpy(_bits(rng, n, dim, 0.8).astype(np.int8)) \
        if ternary else None
    tplan = T.get_plan(sim_module(T, tcd, "hamming", k, False, m, n, dim,
                                  ARCH_T, care=ternary), backend="cuda",
                       device="cpu")
    gt = torch.from_numpy(g.copy())
    extra = () if care is None else (care,)
    tplan.execute(q, gt, *extra)
    idx = np.array([0, 131, 255, n - 1])
    new = _bits(rng, idx.size, dim)
    g2 = tplan.update_rows(gt, idx, new, care=care)
    assert tplan.row_update_fallbacks == 0
    updated = tplan._prepared_patterns(g2, *extra)
    fresh = tplan._prepare(g2.clone(), *extra)
    assert all(torch.equal(a, b) for a, b in zip(updated, fresh))
    g_np = g.copy()
    g_np[idx] = new
    ins = [q, g_np] + ([care.numpy()] if ternary else [])
    rplan = R.get_plan(sim_module(R, rcd, "hamming", k, False, m, n, dim,
                                  ARCH_R, care=ternary), backend="jnp")
    _assert_results("hamming", ins, rplan.execute(*ins),
                    tplan.execute(q, g2, *extra))
