"""Port kernels vs the reference: packing, the plain oracles, and the two
CAM-search kernels' plain versions against the Pallas kernels (interpret
mode on the CPU).  The CUDA kernels themselves are held against their
plain versions in test_torch_cuda.py, on the card.

Tolerances: integer metrics (hamming, dot on {0,1} or bipolar cells,
packed popcounts, ternary) must be bit-identical.  eucl sums float32
products in another order than the reference, so values agree to
``rtol=1e-5, atol=1e-4`` at these widths (|d| < 400, float32 epsilon
1.2e-7 times a few hundred terms), and an index may differ only where
the two rows' float64 distances are within that same tolerance.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import cam_search as rcs
from repro.kernels import ops as rops
from repro.kernels import packing as rpack
from repro.kernels import ref as rref
from repro_torch.kernels import cam_search as tcs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packing as tpack
from repro_torch.kernels import ref as tref

EUCL_RTOL, EUCL_ATOL = 1e-5, 1e-4


def _np(x):
    return np.asarray(x)


def _t(a):
    """numpy -> torch, uint32 lanes as their int32 bit patterns."""
    a = np.array(a)                          # a writable, contiguous copy
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _lanes_equal(ref_lanes, port_lanes):
    return np.array_equal(_np(ref_lanes).view(np.int32), port_lanes.numpy())


def _assert_eucl_close(q, p, ref_v, ref_i, v, i):
    """Values within tolerance; index swaps only between float64 near-ties."""
    np.testing.assert_allclose(v, ref_v, rtol=EUCL_RTOL, atol=EUCL_ATOL)
    q64, p64 = q.astype(np.float64), p.astype(np.float64)
    for r, c in zip(*np.nonzero(i != ref_i)):
        a, b = int(i[r, c]), int(ref_i[r, c])
        da = ((q64[r] - p64[a]) ** 2).sum()
        db = ((q64[r] - p64[b]) ** 2).sum()
        assert abs(da - db) <= EUCL_ATOL + EUCL_RTOL * abs(db), (r, c, a, b)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [1, 31, 32, 33, 64, 100, 257])
def test_pack_bits_matches_reference(dim, rng):
    b = (rng.random((5, dim)) > 0.5).astype(np.float32)
    b[:, 31::32] = 1.0                       # bit 31 set in every full lane
    port = tpack.pack_bits(b)
    assert port.dtype == torch.int32 and port.shape == (5, tpack.lanes(dim))
    assert _lanes_equal(rpack.pack_bits(b), port)
    assert np.array_equal(tpack.unpack_bits(port, dim).numpy(),
                          _np(rpack.unpack_bits(rpack.pack_bits(b), dim)))


def test_pack_bipolar_matches_reference(rng):
    x = rng.standard_normal((4, 70)).astype(np.float32)
    x[0, :3] = [0.0, -0.0, 1e-30]
    assert _lanes_equal(rpack.pack_bipolar(x), tpack.pack_bipolar(x))


@pytest.mark.parametrize("fn", ["popcount32", "popcount32_lut"])
def test_popcount_matches_reference(fn, rng):
    x = rng.integers(0, 2 ** 32, size=(4096,), dtype=np.uint32)
    x[:6] = [0, 1, 2 ** 32 - 1, 0x80000000, 0x7FFFFFFF, 0xC0000001]
    want = _np(getattr(rpack, fn)(x))
    got = getattr(tpack, fn)(x)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # int32 input with bit 31 set (negative values) counts the same
    assert np.array_equal(getattr(tpack, fn)(_t(x)).numpy(), want)


# ---------------------------------------------------------------------------
# plain oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["hamming", "dot", "eucl", "cos"])
def test_distances_match_reference(metric, rng):
    if metric in ("hamming", "dot"):
        q = (rng.random((9, 70)) > 0.5).astype(np.float32)
        p = (rng.random((23, 70)) > 0.5).astype(np.float32)
    else:
        q = rng.standard_normal((9, 70)).astype(np.float32)
        p = rng.standard_normal((23, 70)).astype(np.float32)
    want = _np(rref.distances(q, p, metric))
    got = tref.distances(_t(q), _t(p), metric).numpy()
    if metric in ("hamming", "dot"):
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dim", [33, 100])
def test_packed_and_ternary_distances_match_reference(dim, rng):
    q = (rng.random((7, dim)) > 0.5).astype(np.float32)
    p = (rng.random((23, dim)) > 0.5).astype(np.float32)
    care = (rng.random((23, dim)) > 0.3).astype(np.int8)
    qb, pb, cb = (rpack.pack_bits(x) for x in (q, p, care))
    want = _np(rref.packed_distances(qb, pb, cb))
    got = tref.packed_distances(_t(_np(qb)), _t(_np(pb)), _t(_np(cb)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        tref.ternary_distances(_t(q), _t(p), _t(care)).numpy(),
        _np(rref.ternary_distances(q, p, care)))
    assert np.array_equal(
        tref.packed_distances(_t(_np(qb)), _t(_np(pb))).numpy(),
        _np(rref.packed_distances(qb, pb)))


@pytest.mark.parametrize("k,largest", [(1, False), (5, True), (30, False)])
def test_topk_oracles_tie_heavy_match_reference(k, largest, rng):
    # 6 binary cells: at most 7 distinct distances over 30 rows -> ties
    q = (rng.random((8, 6)) > 0.5).astype(np.float32)
    p = (rng.random((30, 6)) > 0.5).astype(np.float32)
    care = (rng.random((30, 6)) > 0.3).astype(np.float32)
    rv, ri = rref.cam_topk(q, p, metric="hamming", k=k, largest=largest)
    tv, ti = tref.cam_topk(_t(q), _t(p), metric="hamming", k=k,
                           largest=largest)
    assert np.array_equal(tv.numpy(), _np(rv))
    assert np.array_equal(ti.numpy(), _np(ri))
    rv, ri = rref.cam_topk_ternary(q, p, care, k=k, largest=largest)
    tv, ti = tref.cam_topk_ternary(_t(q), _t(p), _t(care), k=k,
                                   largest=largest)
    assert np.array_equal(tv.numpy(), _np(rv))
    assert np.array_equal(ti.numpy(), _np(ri))


@pytest.mark.parametrize("metric,care", [("hamming", False),
                                         ("hamming", True), ("dot", False),
                                         ("eucl", False)])
def test_tiled_oracles_match_reference(metric, care, rng):
    n, dim, k, tr, dpt = 37, 50, 9, 8, 16       # ragged rows, ragged dims
    if metric == "eucl":
        q = rng.standard_normal((6, dim)).astype(np.float32)
        p = rng.standard_normal((n, dim)).astype(np.float32)
    else:
        q = (rng.random((6, dim)) > 0.5).astype(np.float32)
        p = (rng.random((n, dim)) > 0.5).astype(np.float32)
    c = (rng.random((n, dim)) > 0.3).astype(np.int8) if care else None
    rv, ri = rref.cam_topk_tiled(q, p, metric=metric, k=k, largest=False,
                                 tile_rows=tr, dims_per_tile=dpt, care=c)
    tv, ti = tref.cam_topk_tiled(_t(q), _t(p), metric=metric, k=k,
                                 largest=False, tile_rows=tr,
                                 dims_per_tile=dpt,
                                 care=None if c is None else _t(c))
    rd = _np(rref.tiled_distances(q, p, metric=metric, tile_rows=tr,
                                  dims_per_tile=dpt))
    td = tref.tiled_distances(_t(q), _t(p), metric=metric, tile_rows=tr,
                              dims_per_tile=dpt).numpy()
    if metric == "eucl":
        _assert_eucl_close(q, p, _np(rv), _np(ri), tv.numpy(), ti.numpy())
        np.testing.assert_allclose(td, rd, rtol=EUCL_RTOL, atol=EUCL_ATOL)
    else:
        assert np.array_equal(tv.numpy(), _np(rv))
        assert np.array_equal(ti.numpy(), _np(ri))
        assert np.array_equal(td, rd)


def test_merge_and_pad_candidates_match_reference(rng):
    va = np.sort(rng.integers(0, 4, (5, 3)).astype(np.float32), axis=1)
    vb = np.sort(rng.integers(0, 4, (5, 3)).astype(np.float32), axis=1)
    ia = np.tile(np.arange(3, dtype=np.int32), (5, 1))
    ib = ia + 3
    rv, ri = rref.merge_topk(va, ia, vb, ib, k=4, largest=False)
    tv, ti = tref.merge_topk(_t(va), _t(ia), _t(vb), _t(ib), k=4,
                             largest=False)
    assert np.array_equal(tv.numpy(), _np(rv))
    assert np.array_equal(ti.numpy(), _np(ri))
    for largest in (False, True):
        rv, ri = rref.pad_candidates(va, ia, 7, largest)
        tv, ti = tref.pad_candidates(_t(va), _t(ia), 7, largest)
        assert np.array_equal(tv.numpy(), _np(rv))
        assert np.array_equal(ti.numpy(), _np(ri))


# ---------------------------------------------------------------------------
# the kernels' plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _pad_rows(a, rows):
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[:a.shape[0]] = a
    return out


def _assert_candidates_equal(ref, port):
    """Bit-identical candidates.  A window with fewer live rows than k
    fills its tail with losing slots (value -/+3e38): values agree there
    too, but the reference's segmented extraction repeats an index where
    the port lists the padding rows, so indices compare on live slots."""
    rv, ri = _np(ref[0]), _np(ref[1])
    tv, ti = port[0].numpy(), port[1].numpy()
    assert np.array_equal(tv, rv)
    live = np.abs(rv) < 3e38
    assert np.array_equal(ti[live], ri[live])


@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("k,largest,n", [(5, False, 300), (3, True, 300),
                                         (10, False, 7)])
def test_packed_plain_matches_pallas(ternary, k, largest, n, rng):
    m, lanes = 13, 8
    window = tcs.window_rows(k)
    rows = -(-n // window) * window
    q = rng.integers(0, 2 ** 32, size=(m, lanes), dtype=np.uint32)
    p = _pad_rows(rng.integers(0, 2 ** 32, size=(n, lanes),
                               dtype=np.uint32), rows)
    c = _pad_rows(rng.integers(0, 2 ** 32, size=(n, lanes),
                               dtype=np.uint32), rows) if ternary else None
    ref = rcs.fused_topk_packed_pallas(
        jnp.asarray(q), jnp.asarray(p),
        None if c is None else jnp.asarray(c), k=k, largest=largest,
        block_n=window, n_valid=n)
    port = tcs.fused_topk_packed(_t(q), _t(p), None if c is None else _t(c),
                                 k=k, largest=largest, n_valid=n)
    assert port[0].shape == (m, (rows // window) * k)
    _assert_candidates_equal(ref, port)


def test_packed_plain_tie_heavy_matches_pallas(rng):
    # 3 set bits in one lane: distances 0..6 over 200 rows -> heavy ties
    q = (rng.integers(0, 8, size=(9, 8)) & 7).astype(np.uint32)
    p = _pad_rows((rng.integers(0, 8, size=(200, 8)) & 7).astype(np.uint32),
                  256)
    ref = rcs.fused_topk_packed_pallas(jnp.asarray(q), jnp.asarray(p), None,
                                       k=20, largest=False, block_n=128,
                                       n_valid=200)
    port = tcs.fused_topk_packed(_t(q), _t(p), None, k=20, largest=False,
                                 n_valid=200)
    _assert_candidates_equal(ref, port)


@pytest.mark.parametrize("metric,largest", [("hamming", False),
                                            ("dot", True), ("dot", False)])
def test_float_plain_integer_metrics_match_pallas(metric, largest, rng):
    m, n, dim, k = 11, 200, 40, 6
    q = (rng.random((m, dim)) > 0.5).astype(np.float32)
    if metric == "dot":                      # bipolar cells: integer dots
        q = 2 * q - 1
    p = _pad_rows((rng.random((n, dim)) > 0.5).astype(np.float32), 256)
    ref = rcs.fused_topk_pallas(jnp.asarray(q), jnp.asarray(p),
                                metric=metric, k=k, largest=largest,
                                block_n=128, n_valid=n)
    port = tcs.fused_topk(_t(q), _t(p), metric=metric, k=k, largest=largest,
                          n_valid=n)
    _assert_candidates_equal(ref, port)


def test_float_plain_eucl_matches_pallas(rng):
    m, n, dim, k = 11, 300, 40, 6
    q = rng.standard_normal((m, dim)).astype(np.float32)
    p = _pad_rows(rng.standard_normal((n, dim)).astype(np.float32), 384)
    rv, ri = rcs.fused_topk_pallas(jnp.asarray(q), jnp.asarray(p),
                                   metric="eucl", k=k, largest=False,
                                   block_n=128, n_valid=n)
    tv, ti = tcs.fused_topk(_t(q), _t(p), metric="eucl", k=k, largest=False,
                            n_valid=n)
    _assert_eucl_close(q, p, _np(rv), _np(ri), tv.numpy(), ti.numpy())


def test_window_above_128_rows_against_numpy(rng):
    """k > 128 widens the window (checked against a numpy oracle: the
    interpret-mode reference takes seconds per extraction round here)."""
    k, n, lanes = 130, 600, 8
    window = tcs.window_rows(k)
    assert window == 256
    q = rng.integers(0, 2 ** 32, size=(5, lanes), dtype=np.uint32)
    p = _pad_rows(rng.integers(0, 2 ** 32, size=(n, lanes),
                               dtype=np.uint32), 768)
    v, i = tcs.fused_topk_packed(_t(q), _t(p), None, k=k, largest=False,
                                 n_valid=n)
    bits = np.unpackbits(p.view(np.uint8), axis=1)
    qbits = np.unpackbits(q.view(np.uint8), axis=1)
    d = (qbits[:, None, :] != bits[None]).sum(-1).astype(np.float32)
    d[:, n:] = 3e38
    for w in range(3):
        blk = d[:, w * window:(w + 1) * window]
        order = np.argsort(blk, axis=1, kind="stable")[:, :k]
        assert np.array_equal(i.numpy()[:, w * k:(w + 1) * k],
                              order + w * window)
        assert np.array_equal(v.numpy()[:, w * k:(w + 1) * k],
                              np.take_along_axis(blk, order, 1))


def test_kernel_wrappers_reject_bad_operands():
    q = torch.zeros((4, 8), dtype=torch.int32)
    p = torch.zeros((128, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        tcs.fused_topk_packed(q, p, k=tcs.MAX_K + 1, largest=False,
                              n_valid=128)
    with pytest.raises(ValueError, match="multiple"):
        tcs.fused_topk_packed(q, p[:100], k=5, largest=False, n_valid=100)
    with pytest.raises(ValueError, match="multiple of 8"):
        tcs.fused_topk_packed(q[:, :5].contiguous(), p[:, :5].contiguous(),
                              k=5, largest=False,
                              n_valid=128)
    with pytest.raises(ValueError, match="float32"):
        tcs.fused_topk(q, p, metric="eucl", k=5, largest=False, n_valid=128)
    with pytest.raises(ValueError, match="metric"):
        tcs.fused_topk(q.float(), p.float(), metric="cos", k=5,
                       largest=False, n_valid=128)


# ---------------------------------------------------------------------------
# ops level: full search incl. k > n sentinel slots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,n", [(5, 23), (6, 3)])
def test_ops_cam_topk_match_reference(k, n, rng):
    q = (rng.random((7, 100)) > 0.5).astype(np.float32)
    p = (rng.random((23, 100)) > 0.5).astype(np.float32)[:n]
    care = (rng.random((n, 100)) > 0.3).astype(np.float32)
    rv, ri = rops.cam_topk_packed(rpack.pack_bits(q), rpack.pack_bits(p),
                                  k=k, largest=False, tile_rows=8,
                                  lanes_per_tile=2)
    for tv, ti in (tops.cam_topk_packed(tpack.pack_bits(q),
                                        tpack.pack_bits(p), k=k),
                   tops.cam_topk(_t(q), _t(p), metric="hamming", k=k,
                                 largest=False)):
        assert np.array_equal(tv.numpy(), _np(rv))
        assert np.array_equal(ti.numpy(), _np(ri))
    rv, ri = rref.cam_topk_ternary(q, p, care, k=min(k, n), largest=False)
    rv, ri = rref.pad_candidates(rv, ri, k, False)
    tv, ti = tops.cam_topk_packed(tpack.pack_bits(q), tpack.pack_bits(p),
                                  tpack.pack_bits(care), k=k)
    assert np.array_equal(tv.numpy(), _np(rv))
    assert np.array_equal(ti.numpy(), _np(ri))
