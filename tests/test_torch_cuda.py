"""CUDA kernels vs their plain versions, and the port's main path on the
card vs the same path on the CPU.  Every test here needs an NVIDIA GPU
(the ``gpu`` marker) and skips without one.  This file imports neither
JAX nor the reference package, so it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: integer metrics bit-identical; eucl values within
``rtol=1e-5, atol=1e-4`` (|d| up to about 2,500 at these widths, D at
most 1,032) with index swaps only between float64 near-ties; the 3xTF32
kernels' eucl values also bit-identical to the replay of their own
arithmetic (``cam_search.tf32x3_kernel_eucl``) where a test samples them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import cim_dialect as cd
from repro_torch.kernels import acam as tacam
from repro_torch.kernels import cam_search as tcs
from repro_torch.kernels import flash_attention as tfa

pytestmark = pytest.mark.gpu

EUCL_RTOL, EUCL_ATOL = 1e-5, 1e-4


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in fp32
    return torch.device("cuda")


def _lanes(rng, rows, lanes):
    a = rng.integers(0, 2 ** 32, size=(rows, lanes), dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32))


def _assert_eucl_close(q, p, want_v, want_i, v, i):
    np.testing.assert_allclose(v, want_v, rtol=EUCL_RTOL, atol=EUCL_ATOL)
    q64, p64 = q.astype(np.float64), p.astype(np.float64)
    for r, c in zip(*np.nonzero(i != want_i)):
        a, b = int(i[r, c]), int(want_i[r, c])
        da = ((q64[r] - p64[a]) ** 2).sum()
        db = ((q64[r] - p64[b]) ** 2).sum()
        assert abs(da - db) <= EUCL_ATOL + EUCL_RTOL * abs(db), (r, c, a, b)


@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("k,largest", [(1, False), (10, True), (200, False),
                                       (tcs.MAX_K, False)])
def test_packed_kernel_matches_plain(cuda, ternary, k, largest, rng):
    window = tcs.window_rows(k)
    rows, n = 3 * window, 3 * window - 17
    q = _lanes(rng, 150, 32).to(cuda)
    p = _lanes(rng, rows, 32).to(cuda)
    c = _lanes(rng, rows, 32).to(cuda) if ternary else None
    got = tcs.fused_topk_packed(q, p, c, k=k, largest=largest, n_valid=n)
    torch.cuda.synchronize()
    want = tcs.fused_topk_packed_reference(q, p, c, k=k, largest=largest,
                                           n_valid=n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("largest", [False, True])
def test_packed_kernel_at_the_hdc_predict_shape(cuda, ternary, largest, rng):
    """The HDC classifier's predict shape: 1024 queries x 256 lanes
    against one 128-row window of 10 classes, k = 1 (the classifier's
    plan passes largest=False: bipolar dot through hamming)."""
    q = _lanes(rng, 1024, 256).to(cuda)
    p = _lanes(rng, 128, 256).to(cuda)
    c = _lanes(rng, 128, 256).to(cuda) if ternary else None
    assert tcs.packed_route(1024, 128, 1, _sms(cuda)) == "rows"
    got = tcs.fused_topk_packed(q, p, c, k=1, largest=largest, n_valid=10)
    torch.cuda.synchronize()
    want = tcs.fused_topk_packed_reference(q, p, c, k=1, largest=largest,
                                           n_valid=10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].max()) < 10


@pytest.mark.parametrize("route", ["mma", "rows"])
@pytest.mark.parametrize("n_valid", [2047, 2048, 2049, 2111, 2112, 2113,
                                     2175])
def test_packed_kernel_n_valid_at_sub_tile_edges(cuda, route, n_valid, rng):
    """n_valid on each side of a window edge (2048) and of a warp's
    64-row half (2112), on both routes; 17 windows of 128 rows."""
    m = 1024 if route == "mma" else 150
    q = _lanes(rng, m, 32).to(cuda)
    p = _lanes(rng, 17 * 128, 32).to(cuda)
    assert tcs.packed_route(m, p.shape[0], 10, _sms(cuda)) == route
    for care in (None, _lanes(rng, 17 * 128, 32).to(cuda)):
        got = tcs.fused_topk_packed(q, p, care, k=10, largest=False,
                                    n_valid=n_valid)
        torch.cuda.synchronize()
        want = tcs.fused_topk_packed_reference(q, p, care, k=10,
                                               largest=False,
                                               n_valid=n_valid)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("route", ["mma", "rows"])
def test_packed_kernel_lanes_with_bit_31_set(cuda, ternary, route, rng):
    """Lanes with bit 31 set (negative int32): all ones, the sign bit
    alone, and random lanes forced negative, binary and ternary."""
    m = 1024 if route == "mma" else 64
    n = 17 * 128
    q = _lanes(rng, m, 32)
    p = _lanes(rng, n, 32)
    q[::3] |= np.int32(-2 ** 31)
    p[::2] |= np.int32(-2 ** 31)
    q[1], p[5], p[7] = -1, -1, np.int32(-2 ** 31)
    p[9] = q[1]                                  # distance 0 on row 9
    c = None
    if ternary:
        c = _lanes(rng, n, 32)
        c[::2] = -1
        c = c.to(cuda)
    q, p = q.to(cuda), p.to(cuda)
    assert tcs.packed_route(m, n, 10, _sms(cuda)) == route
    for largest in (False, True):
        got = tcs.fused_topk_packed(q, p, c, k=10, largest=largest,
                                    n_valid=n - 3)
        torch.cuda.synchronize()
        want = tcs.fused_topk_packed_reference(q, p, c, k=10,
                                               largest=largest,
                                               n_valid=n - 3)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("lanes", [8, 24, 40, 256])
def test_packed_mma_route_lane_counts(cuda, ternary, k, lanes, rng):
    """The "mma" route at lane counts other than one 32-lane stage: a
    partial stage (8, 24), a restage with a partial one (40) and eight
    full stages (256, an HDC gallery of 17 windows)."""
    m, n = 1024, 17 * 128
    q = _lanes(rng, m, lanes).to(cuda)
    p = _lanes(rng, n, lanes).to(cuda)
    c = _lanes(rng, n, lanes).to(cuda) if ternary else None
    assert tcs.packed_route(m, n, k, _sms(cuda)) == "mma"
    for largest in (False, True):
        got = tcs.fused_topk_packed(q, p, c, k=k, largest=largest,
                                    n_valid=n - 5)
        torch.cuda.synchronize()
        want = tcs.fused_topk_packed_reference(q, p, c, k=k,
                                               largest=largest,
                                               n_valid=n - 5)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("metric,largest", [("hamming", False),
                                            ("dot", True), ("eucl", False)])
def test_float_kernel_matches_plain(cuda, metric, largest, rng):
    n, rows = 500, 512
    if metric == "eucl":
        q = rng.standard_normal((150, 64)).astype(np.float32)
        p = rng.standard_normal((rows, 64)).astype(np.float32)
    else:
        q = (rng.random((150, 64)) > 0.5).astype(np.float32)
        p = (rng.random((rows, 64)) > 0.5).astype(np.float32)
    qt, pt = torch.from_numpy(q).to(cuda), torch.from_numpy(p).to(cuda)
    got = tcs.fused_topk(qt, pt, metric=metric, k=7, largest=largest,
                         n_valid=n)
    torch.cuda.synchronize()
    want = tcs.fused_topk_reference(qt, pt, metric=metric, k=7,
                                    largest=largest, n_valid=n)
    gv, gi = got[0].cpu().numpy(), got[1].cpu().numpy()
    wv, wi = want[0].cpu().numpy(), want[1].cpu().numpy()
    if metric == "eucl":
        _assert_eucl_close(q, p, wv, wi, gv, gi)
    else:
        assert np.array_equal(gv, wv) and np.array_equal(gi, wi)


def _float_operands(rng, metric, m, rows, dim):
    """Queries and a gallery for the float kernel: N(0, 1) cells for eucl,
    {0, 1} for hamming, +-1 for dot; gallery rows 2 and 5 equal (a
    planted exact tie) and every fourth row a copy of the one before."""
    if metric == "eucl":
        q = rng.standard_normal((m, dim)).astype(np.float32)
        p = rng.standard_normal((rows, dim)).astype(np.float32)
    else:
        q = (rng.random((m, dim)) > 0.5).astype(np.float32)
        p = (rng.random((rows, dim)) > 0.5).astype(np.float32)
        if metric == "dot":
            q, p = 2 * q - 1, 2 * p - 1
    p[5] = p[2]
    p[3::4] = p[2::4][:len(p[3::4])]
    return q, p


def _assert_float_kernel(metric, q, p, got, want):
    gv, gi = got[0].cpu().numpy(), got[1].cpu().numpy()
    wv, wi = want[0].cpu().numpy(), want[1].cpu().numpy()
    if metric != "eucl":
        assert np.array_equal(gv, wv) and np.array_equal(gi, wi)
        return
    _assert_eucl_close(q, p, wv, wi, gv, gi)
    # equal rows get equal distances: the lower one ranks first
    for r in range(gi.shape[0]):
        row = list(gi[r])
        for a in range(2, p.shape[0] - 1, 4):
            if a in row and a + 1 in row:
                assert row.index(a) < row.index(a + 1), (r, a)


@pytest.mark.parametrize("metric,largest", [("hamming", False),
                                            ("dot", True), ("eucl", False)])
@pytest.mark.parametrize("k", [5, 128, 200, 384])
@pytest.mark.parametrize("m", [1, 63, 624, 1024])
def test_float_kernel_routes_match_plain(cuda, metric, largest, k, m, rng):
    """Both routes of the float kernel ("wgmma" for 128-row windows,
    "fma" for 256 and 384) against the plain version, at the query
    counts the engine hands it (1, 63, the KNN's 624, a full batch)."""
    window = tcs.window_rows(k)
    assert tcs.float_route(k) == ("wgmma" if window == 128 else "fma")
    rows = 3 * window
    q, p = _float_operands(rng, metric, m, rows, 72)
    qt, pt = torch.from_numpy(q).to(cuda), torch.from_numpy(p).to(cuda)
    before = tcs.LAUNCHES["fused_topk"]
    kw = dict(metric=metric, k=k, largest=largest, n_valid=rows - 17)
    got = tcs.fused_topk(qt, pt, **kw)
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["fused_topk"] == before + 1
    _assert_float_kernel(metric, q, p, got,
                         tcs.fused_topk_reference(qt, pt, **kw))


@pytest.mark.parametrize("metric", ["hamming", "eucl"])
@pytest.mark.parametrize("k", [10, 200])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_float_kernel_n_valid_at_window_edges(cuda, metric, k, edge, rng):
    """n_valid on each side of every window edge, and a single live row;
    windows past n_valid give losing slots (value 3e38, the lowest rows
    first)."""
    window = tcs.window_rows(k)
    rows = 3 * window
    q, p = _float_operands(rng, metric, 150, rows, 40)
    qt, pt = torch.from_numpy(q).to(cuda), torch.from_numpy(p).to(cuda)
    for n_valid in [1] + [w * window + edge for w in (1, 2, 3)
                          if 1 <= w * window + edge <= rows]:
        kw = dict(metric=metric, k=k, largest=False, n_valid=n_valid)
        got = tcs.fused_topk(qt, pt, **kw)
        torch.cuda.synchronize()
        want = tcs.fused_topk_reference(qt, pt, **kw)
        assert torch.equal(got[0].abs() >= 3e38, want[0].abs() >= 3e38)
        _assert_float_kernel(metric, q, p, got, want)


def test_launch_counts_and_refusals(cuda):
    q = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    p = torch.zeros((128, 8), dtype=torch.int32, device=cuda)
    tcs.reset_launch_counts()
    tcs.fused_topk_packed(q, p, k=3, largest=False, n_valid=100)
    tcs.fused_topk_packed(q, p, p, k=3, largest=False, n_valid=100)
    assert tcs.LAUNCHES == {"fused_topk": 0, "fused_topk_packed": 1,
                            "fused_topk_packed_ternary": 1,
                            "acam_match": 0, "range_match": 0,
                            "hdc_encode": 0, "hdc_encode_wide": 0,
                            "distance": 0, "distance_topk": 0,
                            "topk_select": 0, "packed_distance": 0,
                            "flash_attention": 0}
    with pytest.raises(ValueError, match="queries on"):
        tcs.fused_topk_packed(q, p.cpu(), k=3, largest=False, n_valid=100)


def _hamming_module(m, n, dim, k, care):
    types = [T.TensorType((m, dim)), T.TensorType((n, dim))]
    if care:
        types.append(T.TensorType((n, dim), "i8"))
    mod = T.Module("hamming", types)
    a = mod.arguments
    b = T.Builder(mod.body)
    dev = cd.make_acquire(b)
    exe = cd.make_execute(b, dev.result, list(a),
                          [T.TensorType((m, k)), T.TensorType((m, k), "i32")])
    blk = exe.region().block()
    sim = cd.make_similarity(blk, a[0], a[1], metric="hamming", k=k,
                             largest=False, care=a[2] if care else None)
    cd.make_yield(blk, sim.results)
    cd.make_release(b, dev.result)
    b.ret(exe.results)
    return mod


def _knn(q, gallery):
    return q.unsqueeze(1).sub(gallery).norm(p=2, dim=-1).topk(5, largest=False)


def _hdc(queries, class_hvs):
    return queries.matmul(class_hvs.transpose(-2, -1)).topk(1, largest=True)


@pytest.mark.parametrize("metric", ["eucl", "hamming", "dot", "ternary"])
def test_main_path_on_the_card_matches_cpu(cuda, metric, rng):
    arch = T.ArchSpec(rows=32, cols=64)
    if metric == "eucl":
        ins = [rng.standard_normal((37, 96)).astype(np.float32),
               rng.standard_normal((900, 96)).astype(np.float32)]
        build = lambda **kw: T.compile_fn(_knn, ins, arch, value_bits=8, **kw)
        expect = "fused_topk"
    elif metric == "dot":
        ins = [(rng.random((37, 512)) > 0.5).astype(np.float32),
               (rng.random((10, 512)) > 0.5).astype(np.float32)]
        build = lambda **kw: T.compile_fn(_hdc, ins, arch, **kw)
        expect = "fused_topk_packed"
    else:
        care = metric == "ternary"
        ins = [(rng.random((37, 100)) > 0.5).astype(np.float32),
               (rng.random((900, 100)) > 0.5).astype(np.float32)]
        if care:
            ins.append((rng.random((900, 100)) > 0.1).astype(np.int8))
        build = lambda **kw: T.compile_module(
            _hamming_module(37, 900, 100, 10, care), arch, value_bits=1, **kw)
        expect = "fused_topk_packed_ternary" if care else "fused_topk_packed"
    want = build(device="cpu")(*ins)
    tcs.reset_launch_counts()
    got = build()(*[torch.from_numpy(x).to(cuda) for x in ins])
    assert tcs.LAUNCHES[expect] == 1
    assert got[0].device.type == "cuda"
    gv, gi = got[0].cpu().numpy(), got[1].cpu().numpy()
    wv, wi = want[0].numpy(), want[1].numpy()
    if metric == "eucl":
        _assert_eucl_close(ins[0], ins[1], wv, wi, gv, gi)
    else:
        assert np.array_equal(gv, wv) and np.array_equal(gi, wi)


# ---------------------------------------------------------------------------
# range search: B3 (interval) and B4 (threshold)
# ---------------------------------------------------------------------------


def _intervals(rng, m, n, dim, constrained=0.3):
    """Queries + (lo, hi) with +-inf wildcards, a NaN query cell, and
    cells exactly on a bound."""
    q = rng.standard_normal((m, dim)).astype(np.float32)
    lo = np.full((n, dim), -np.inf, np.float32)
    hi = np.full((n, dim), np.inf, np.float32)
    sel = rng.random((n, dim)) < constrained
    lo[sel] = (rng.standard_normal(sel.sum()) - 1.5).astype(np.float32)
    hi[sel] = lo[sel] + 3.0
    lo[0] = q[0]                       # inclusive bounds: row 0 holds q 0
    hi[0] = q[0]
    if m > 1:
        q[1, 3] = np.nan               # a NaN cell adds no violation
    return q, lo, hi


@pytest.mark.parametrize("m,n,dim,n_valid", [(150, 300, 64, 300),
                                             (37, 130, 16, 97),
                                             (1, 5, 112, 5)])
def test_acam_kernel_matches_plain(cuda, m, n, dim, n_valid, rng):
    q, lo, hi = _intervals(rng, m, n, dim)
    qt, lot, hit = (torch.from_numpy(x).to(cuda) for x in (q, lo, hi))
    got = tacam.acam_match(qt, lot, hit, n_valid=n_valid)
    torch.cuda.synchronize()
    want = tacam.acam_match_reference(qt, lot, hit, n_valid=n_valid)
    assert got.dtype == torch.bool and got.shape == (m, n)
    assert torch.equal(got, want)
    assert bool(got[0, 0]) and 0 < int(got.sum()) < got.numel()


def _f32(bits):
    return float(np.array(bits, np.uint32).view(np.float32))


_TINY, _MAX = 2.0 ** -126, float(np.finfo(np.float32).max)
#: signed zeros, NaN of either sign (and a signalling one), infinities,
#: subnormal operands and gaps, and bounds whose differences overflow
ACAM_EDGE_VALUES = np.array(
    [0.0, -0.0, 1.0, -1.0, np.nan, _f32(0xFFC00000), _f32(0x7F800001),
     _f32(0xFFFFFFFF), np.inf, -np.inf, _MAX, -_MAX, 3e38, -3e38,
     _TINY, -_TINY, _f32(0x00800001), _f32(0x00FFFFFF), 1e-45, 2e-45,
     -1e-45, 3e-39, -3e-39], np.float32)


def _acam_edges(rng, m, n, dim):
    """Queries of edge values in every dim; rows with edge-value bounds
    (lo <= hi or not) in two dims and wildcards elsewhere, a few rows all
    wildcards."""
    v = ACAM_EDGE_VALUES
    q = v[(np.arange(m)[:, None] * 7 + np.arange(dim)[None] * 3) % v.size]
    lo = np.full((n, dim), -np.inf, np.float32)
    hi = np.full((n, dim), np.inf, np.float32)
    for d in (0, dim // 2):
        lo[:, d] = v[rng.integers(0, v.size, n)]
        hi[:, d] = v[rng.integers(0, v.size, n)]
    lo[::17], hi[::17] = -np.inf, np.inf
    return q.astype(np.float32), lo, hi


@pytest.mark.parametrize("m", [1, 37, 150])
@pytest.mark.parametrize("n,dim", [(301, 32), (1003, 64)])
def test_acam_kernel_edge_values(cuda, m, n, dim, rng):
    """B3 (no compares: the sign bits of q - lo and hi - q on canonical
    operands) bit-identical to its plain version and to numpy's IEEE
    compares on signed zeros, NaN of either sign in q, lo and hi, +-inf
    against wildcards and finite bounds, subnormal operands and gaps, and
    overflowing differences; N not a multiple of 4 or of the 128-row
    tile.  The card's FADD must give inf - inf and NaN operands a NaN of
    sign 0 (no violation, as the compares give)."""
    q, lo, hi = _acam_edges(rng, m, n, dim)
    want = ~((q[:, None] < lo[None]) | (q[:, None] > hi[None])).any(-1)
    want[:, n - 3:] = False
    qt, lot, hit = (torch.from_numpy(x).to(cuda) for x in (q, lo, hi))
    got = tacam.acam_match(qt, lot, hit, n_valid=n - 3)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert torch.equal(got, tacam.acam_match_reference(qt, lot, hit,
                                                       n_valid=n - 3))
    assert torch.equal(got.cpu(), tacam.acam_match_signbits(
        *map(torch.from_numpy, (q, lo, hi)), n_valid=n - 3))
    assert 0 < int(got.sum()) < got.numel()


def test_acam_kernel_nan_differences_have_sign_zero(cuda):
    """Each violation test alone: one query value against one bound pair
    in a single dimension (15 wildcard dims), so a NaN difference with its
    sign bit set would show as a violation."""
    v = ACAM_EDGE_VALUES
    q = np.full((v.size, 16), 0.0, np.float32)
    q[:, 0] = v
    lo = np.full((v.size ** 2, 16), -np.inf, np.float32)
    hi = np.full((v.size ** 2, 16), np.inf, np.float32)
    lo[:, 0], hi[:, 0] = np.repeat(v, v.size), np.tile(v, v.size)
    want = ~((q[:, None] < lo[None]) | (q[:, None] > hi[None])).any(-1)
    got = tacam.acam_match(*(torch.from_numpy(x).to(cuda)
                             for x in (q, lo, hi)), n_valid=lo.shape[0])
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("metric,to_logical", [("hamming", "identity"),
                                               ("hamming", "bipolar"),
                                               ("dot", "identity"),
                                               ("eucl", "identity")])
@pytest.mark.parametrize("below", [True, False])
def test_range_kernel_matches_plain(cuda, metric, to_logical, below, rng):
    m, n, dim, n_valid = 150, 333, 72, 301
    if metric == "eucl":
        q = rng.standard_normal((m, dim)).astype(np.float32)
        p = rng.standard_normal((n, dim)).astype(np.float32)
        tau = 140.0
    elif metric == "dot":                       # bipolar +-1 cells
        q = np.where(rng.random((m, dim)) > 0.5, 1, -1).astype(np.float32)
        p = np.where(rng.random((n, dim)) > 0.5, 1, -1).astype(np.float32)
        tau = 4.0
    else:
        q = (rng.random((m, dim)) > 0.5).astype(np.float32)
        p = (rng.random((n, dim)) > 0.5).astype(np.float32)
        tau = 36.0 if to_logical == "identity" else 0.0
    qt, pt = torch.from_numpy(q).to(cuda), torch.from_numpy(p).to(cuda)
    kw = dict(metric=metric, threshold=tau, below=below,
              to_logical=to_logical, dim=dim, n_valid=n_valid)
    got = tacam.range_match(qt, pt, **kw)
    torch.cuda.synchronize()
    want = tacam.range_match_reference(qt, pt, **kw)
    assert got.dtype == torch.bool and got.shape == (m, n)
    assert 0 < int(want.sum()) < want.numel()
    if metric != "eucl":
        assert torch.equal(got, want)
        return
    rows, cols = (got != want).nonzero(as_tuple=True)
    q64, p64 = qt.double(), pt.double()
    d64 = ((q64[rows] - p64[cols]) ** 2).sum(1)
    assert bool(((d64 - tau).abs() <= EUCL_ATOL + EUCL_RTOL * tau).all())


def _range_decomposition64(q, p, metric):
    q64, p64 = q.double(), p.double()
    dot = q64 @ p64.T
    if metric == "dot":
        return dot
    f = (lambda x: x * x) if metric == "eucl" else (lambda x: x)
    return -2 * dot + f(q64).sum(1, keepdim=True) + f(p64).sum(1)[None]


def _assert_range_near_ties(got, want, q, p, metric, tau, dim, bipolar):
    rows, cols = (got != want).nonzero(as_tuple=True)
    d64 = _range_decomposition64(q, p, metric)[rows, cols]
    v64 = dim - 2 * d64 if bipolar else d64
    assert bool(((v64 - tau).abs() <= EUCL_ATOL + EUCL_RTOL * abs(tau))
                .all()), (rows, cols, v64)


@pytest.mark.parametrize("m,n,dim", [(70, 1005, 8), (130, 333, 1032),
                                     (1, 129, 72), (257, 640, 40)])
@pytest.mark.parametrize("metric", ["eucl", "hamming"])
def test_range_kernel_ragged_shapes(cuda, m, n, dim, metric, rng):
    """M ragged against the warpgroup's 64 rows, N not a multiple of the
    128-row tile, D = 8, D = 1032 (not a multiple of the 32-float stage):
    eucl within tolerance (near-ties only), {0, 1} hamming exact."""
    if metric == "eucl":
        q = rng.standard_normal((m, dim)).astype(np.float32)
        p = rng.standard_normal((n, dim)).astype(np.float32)
        tau = 2.0 * dim
    else:
        q = (rng.random((m, dim)) > 0.5).astype(np.float32)
        p = (rng.random((n, dim)) > 0.5).astype(np.float32)
        tau = dim / 2.0
    qt, pt = torch.from_numpy(q).to(cuda), torch.from_numpy(p).to(cuda)
    kw = dict(metric=metric, threshold=tau, below=True,
              to_logical="identity", dim=dim, n_valid=n - 2)
    got = tacam.range_match(qt, pt, **kw)
    torch.cuda.synchronize()
    want = tacam.range_match_reference(qt, pt, **kw)
    assert got.shape == (m, n) and not got[:, n - 2:].any()
    assert 0 < int(want.sum()) < want.numel()
    if metric == "hamming":
        assert torch.equal(got, want)
    else:
        _assert_range_near_ties(got, want, qt, pt, metric, tau, dim, False)


@pytest.mark.parametrize("metric,to_logical", [("dot", "identity"),
                                               ("hamming", "identity"),
                                               ("hamming", "bipolar")])
def test_range_kernel_on_non_binary_float_cells(cuda, metric, to_logical,
                                                rng):
    """dot and hamming on float cells that are neither {0, 1} nor +-1:
    the 3xTF32 product holds the eucl tolerance, every disagreement a
    float64 near-tie of tau."""
    m, n, dim = 150, 700, 200
    q = (rng.standard_normal((m, dim)) * 3).astype(np.float32)
    p = (rng.standard_normal((n, dim)) * 3).astype(np.float32)
    qt, pt = torch.from_numpy(q).to(cuda), torch.from_numpy(p).to(cuda)
    d64 = _range_decomposition64(qt, pt, metric)
    v64 = dim - 2 * d64 if to_logical == "bipolar" else d64
    tau = float(v64.median())
    kw = dict(metric=metric, threshold=tau, below=True,
              to_logical=to_logical, dim=dim, n_valid=n)
    got = tacam.range_match(qt, pt, **kw)
    torch.cuda.synchronize()
    want = tacam.range_match_reference(qt, pt, **kw)
    assert 0 < int(want.sum()) < want.numel()
    _assert_range_near_ties(got, want, qt, pt, metric, tau, dim,
                            to_logical == "bipolar")
    emulated = tacam.range_match_reference(qt, pt, tf32x3=True, **kw)
    _assert_range_near_ties(got, emulated, qt, pt, metric, tau, dim,
                            to_logical == "bipolar")


def test_range_kernels_refuse_bad_operands(cuda):
    q = torch.zeros((4, 16), device=cuda)
    p = torch.zeros((10, 16), device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        tacam.acam_match(q[:, :8].contiguous(), p[:, :8].contiguous(),
                         p[:, :8].contiguous(), n_valid=10)
    with pytest.raises(ValueError, match="float32"):
        tacam.acam_match(q.double(), p, p, n_valid=10)
    with pytest.raises(ValueError, match="queries on"):
        tacam.range_match(q, p.cpu(), metric="eucl", threshold=1.0,
                          below=True, to_logical="identity", dim=16,
                          n_valid=10)
    with pytest.raises(ValueError, match="contiguous"):
        tacam.range_match(q, p.T.contiguous().T, metric="eucl",
                          threshold=1.0, below=True, to_logical="identity",
                          dim=16, n_valid=10)
    with pytest.raises(ValueError, match="n_valid"):
        tacam.acam_match(q, p, p, n_valid=11)
    tcs.reset_launch_counts()
    tacam.acam_match(q, p, p, n_valid=10)
    tacam.range_match(q, p, metric="dot", threshold=0.0, below=True,
                      to_logical="identity", dim=16, n_valid=10)
    assert tcs.LAUNCHES["acam_match"] == 1 and tcs.LAUNCHES["range_match"] == 1


@pytest.mark.parametrize("metric", ["hamming", "dot", "eucl"])
def test_ops_range_entry_points_pad_ragged_dims(cuda, metric, rng):
    """Ragged inner dimensions (70) go through the ops wrappers' padding
    and equal the plain versions on the CPU."""
    from repro_torch.kernels import ops as tops
    q, lo, hi = _intervals(rng, 41, 203, 70)
    want = tops.acam_match(*map(torch.from_numpy, (q, lo, hi)))
    got = tops.acam_match(*(torch.from_numpy(x).to(cuda) for x in (q, lo, hi)))
    assert torch.equal(got.cpu(), want)
    if metric == "eucl":
        a = rng.standard_normal((41, 70)).astype(np.float32)
        b = rng.standard_normal((203, 70)).astype(np.float32)
        tau = 135.0
    else:
        a = (rng.random((41, 70)) > 0.5).astype(np.float32)
        b = (rng.random((203, 70)) > 0.5).astype(np.float32)
        tau = 35.0 if metric == "hamming" else 14.0
    kw = dict(metric=metric, threshold=tau)
    want = tops.cam_range_match(torch.from_numpy(a), torch.from_numpy(b), **kw)
    got = tops.cam_range_match(torch.from_numpy(a).to(cuda),
                               torch.from_numpy(b).to(cuda), **kw).cpu()
    if metric != "eucl":
        assert torch.equal(got, want)
    else:
        rows, cols = (got != want).nonzero(as_tuple=True)
        d64 = ((torch.from_numpy(a).double()[rows]
                - torch.from_numpy(b).double()[cols]) ** 2).sum(1)
        assert bool(((d64 - tau).abs() <= EUCL_ATOL + EUCL_RTOL * tau).all())


def _range_program(m, n, dim, interval, metric="hamming", tau=0.0):
    mod = T.Module("rng", [T.TensorType((m, dim))]
                   + [T.TensorType((n, dim))] * (2 if interval else 1))
    a = mod.arguments
    b = T.Builder(mod.body)
    dev = cd.make_acquire(b)
    exe = cd.make_execute(b, dev.result, list(a),
                          [T.TensorType((m, n), "i1")])
    blk = exe.region().block()
    if interval:
        rs = cd.make_range_search(blk, a[0], lo=a[1], hi=a[2],
                                  extra_attrs={"value_bits": 1})
    else:
        rs = cd.make_range_search(blk, a[0], patterns=a[1], metric=metric,
                                  threshold=tau, below=True,
                                  extra_attrs={"value_bits": 1})
    cd.make_yield(blk, rs.results)
    cd.make_release(b, dev.result)
    b.ret(exe.results)
    return mod


@pytest.mark.parametrize("case", ["interval", "hamming", "cos"])
def test_range_main_path_on_the_card_matches_cpu(cuda, case, rng):
    m, n, dim = 37, 300, 70
    arch = T.ArchSpec(rows=64, cols=64)
    cam = T.CamType.ACAM if case == "interval" else T.CamType.TCAM
    if case == "interval":
        ins = list(_intervals(rng, m, n, dim, constrained=0.05))
        ins[0][1, 3] = 0.0                      # no NaN on the main path
        mod = _range_program(m, n, dim, True)
        expect = "acam_match"
    else:
        ins = [(rng.random((m, dim)) > 0.5).astype(np.float32),
               (rng.random((n, dim)) > 0.5).astype(np.float32)]
        tau = 33.0 if case == "hamming" else 4.0
        mod = _range_program(m, n, dim, False, case, tau)
        expect = "range_match"
    want = T.compile_module(mod, arch, cam_type=cam, device="cpu")(*ins)
    tcs.reset_launch_counts()
    prog = T.compile_module(mod, arch, cam_type=cam)
    got = prog(*[torch.from_numpy(x).to(cuda) for x in ins])
    assert tcs.LAUNCHES[expect] == 1 and not prog.engine_plan.packed
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert torch.equal(got.cpu(), want) and 0 < int(want.sum())


def test_forest_on_the_card_matches_traversal(cuda, rng):
    from repro_torch.forest import CamForestClassifier, random_forest
    trees = random_forest(rng, n_trees=40, dim=24, depth=5, n_classes=6,
                          feature_frac=0.5)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    clf = CamForestClassifier(trees, dim=24).compile(
        T.ArchSpec(rows=64, cols=64, cam_type=T.CamType.ACAM),
        batch_hint=128)
    tcs.reset_launch_counts()
    pred = clf.predict(x)
    assert tcs.LAUNCHES["acam_match"] == 3          # 300 queries / 128
    assert pred.device.type == "cuda" and pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.cpu().numpy(),
                                  clf.predict_reference(x))
    assert bool((clf.matches(x).sum(1) == 40).all())


# ---------------------------------------------------------------------------
# B5 hdc_encode and B6 distance
# ---------------------------------------------------------------------------


def _bipolar_t(rng, *shape):
    return torch.from_numpy(
        np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32))


@pytest.mark.parametrize("zero_cells", [False, True])
@pytest.mark.parametrize("m,f,h,levels", [(9, 37, 70, 8), (130, 784, 1000, 16),
                                          (64, 64, 128, 1), (200, 130, 257, 40),
                                          (300, 784, 8192, 16),
                                          (70, 300, 4100, 16)])
def test_hdc_encode_kernel_matches_plain(cuda, m, f, h, levels, zero_cells,
                                         rng):
    """Both routes of the bit-sliced kernel (no zero cell; zero key rows
    and level cells) against the plain version, at HDC/MNIST's width (784
    features, 8192 dims, 16 levels) and widths that are not a multiple of
    32 dims or of a block's 1024."""
    from repro_torch.kernels import hdc_encode as thdc
    from repro_torch.kernels import ref as tref
    q = torch.from_numpy(rng.integers(0, levels, (m, f)).astype(np.int32))
    keys, lv = _bipolar_t(rng, f, h), _bipolar_t(rng, levels, h)
    if zero_cells:                    # the contract's zero cells
        keys[3] = 0.0
        lv[0, :5] = 0.0
    want = thdc.hdc_encode_reference(q, keys, lv)
    planes = thdc.hdc_planes(keys.to(cuda), lv.to(cuda))
    assert planes.has_zero == zero_cells
    before = tcs.LAUNCHES["hdc_encode"]
    got = thdc.hdc_encode_planes(q.to(cuda), planes)
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["hdc_encode"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got.cpu(), tref.hdc_encode(q, keys, lv))
    assert torch.equal(got, thdc.hdc_encode_reference(
        q.to(cuda), keys.to(cuda), lv.to(cuda)))
    assert torch.equal(got, thdc.hdc_encode_bitsliced(q.to(cuda), planes))
    raw = thdc.hdc_encode(q.to(cuda), keys.to(cuda).to(torch.int8),
                          lv.to(cuda))
    assert torch.equal(raw, got)


@pytest.mark.parametrize("zero_cells", [False, True])
def test_hdc_encode_kernel_ties_and_out_of_range_ids(cuda, zero_cells, rng):
    """Even F with key pairs that cancel forces exact zero sums (-> +1);
    ids outside [0, L) contribute nothing, on both routes."""
    from repro_torch.kernels import hdc_encode as thdc
    m, f, h, levels = 70, 64, 300, 4
    keys = _bipolar_t(rng, f, h)
    keys[f // 2:] = -keys[:f // 2]
    lv = _bipolar_t(rng, levels, h)
    if zero_cells:                    # zero cells that keep every tie
        lv[1, :40] = 0.0
    q = rng.integers(0, levels, (m, f)).astype(np.int32)
    q[:, f // 2:] = q[:, :f // 2]          # every sum is exactly zero
    q[1, 5] = -1
    q[2, 9] = levels + 3
    qt = torch.from_numpy(q)
    want = thdc.hdc_encode_reference(qt, keys, lv)
    planes = thdc.hdc_planes(keys.to(cuda), lv.to(cuda))
    assert planes.has_zero == zero_cells
    got = thdc.hdc_encode_planes(qt.to(cuda), planes).cpu()
    assert torch.equal(got, want)
    assert bool((got[3:] == 1).all())


@pytest.mark.parametrize("zero_cells", [False, True])
@pytest.mark.parametrize("f", [255, 256, 1023, 1024, 4096])
def test_hdc_encode_kernel_counts_at_their_widths(cuda, f, zero_cells, rng):
    """Feature counts at each side of the kernel's count widths (8, 10,
    12, 16 bit planes): rows whose products are all -1 (the largest
    count), all +1, half and half (a tie when F is even), and random."""
    from repro_torch.kernels import hdc_encode as thdc
    h, levels = 200, 3
    keys = torch.ones((f, h))
    lv = torch.stack([torch.ones(h), -torch.ones(h), _bipolar_t(rng, 1, h)[0]])
    if zero_cells:
        lv[2, :10] = 0.0
    q = torch.from_numpy(rng.integers(0, levels, (8, f)).astype(np.int32))
    q[0] = 1                                   # every product -1
    q[1] = 0                                   # every product +1
    q[2, :f // 2], q[2, f // 2:] = 0, 1        # half and half
    q[3, :f // 2 + 1], q[3, f // 2 + 1:] = 1, 0
    planes = thdc.hdc_planes(keys.to(cuda), lv.to(cuda))
    got = thdc.hdc_encode_planes(q.to(cuda), planes).cpu()
    assert torch.equal(got, thdc.hdc_encode_reference(q, keys, lv))
    assert bool((got[0] == -1).all()) and bool((got[1] == 1).all())


def test_hdc_encode_kernel_refuses_bad_operands(cuda):
    from repro_torch.kernels import hdc_encode as thdc
    q = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    k = torch.ones((8, 16), device=cuda)
    lv = torch.ones((3, 16), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        thdc.hdc_encode(q.long(), k, lv)
    with pytest.raises(ValueError, match="key rows"):
        thdc.hdc_encode(q, k[:7], lv)
    with pytest.raises(ValueError, match="width"):
        thdc.hdc_encode(q, k, lv[:, :15])
    with pytest.raises(ValueError, match="on cpu"):
        thdc.hdc_encode(q, k.cpu(), lv)
    # 2000 levels (past shared memory) and 2**16 features (past 16-bit
    # counts) were refused; they now take the wide routes, exactly
    many = torch.ones((2000, 16), device=cuda)
    assert torch.equal(thdc.hdc_encode(q, k, many).cpu(),
                       thdc.hdc_encode_reference(q.cpu(), k.cpu(),
                                                 many.cpu()))
    big = torch.zeros((1, 1 << 16), dtype=torch.int32, device=cuda)
    wide = torch.ones((1 << 16, 16), device=cuda)
    assert torch.equal(thdc.hdc_encode(big, wide, lv).cpu(),
                       thdc.hdc_encode_reference(big.cpu(), wide.cpu(),
                                                 lv.cpu()))
    with pytest.raises(ValueError, match="planes"):
        planes = thdc.hdc_planes(k, lv)
        thdc.hdc_encode_planes(q, thdc.HdcPlanes(
            k, lv, planes.key_planes[:, :0], planes.level_planes, False))


@pytest.mark.parametrize("lo,hi,n_levels", [(0.0, 1.0, 16), (-1.0, 2.5, 5),
                                             (0.1, 0.7, 7)])
def test_device_quantisation_matches_numpy_at_every_edge(cuda, lo, hi,
                                                         n_levels, rng):
    """On the card, the float32 quantisation gives the numpy reference's
    level ids within 8 ulps of every bucket edge and on random features."""
    from repro_torch.hdc import ItemMemory
    im = ItemMemory(8, dim=64, n_levels=n_levels, lo=lo, hi=hi, device=cuda)
    c = (np.float32(lo) + np.arange(n_levels + 1) * (hi - lo)
         / n_levels).astype(np.float32)
    steps = np.arange(-8, 9, dtype=np.float32)
    pts = (c[:, None] + steps[None, :] * np.abs(np.spacing(c))[:, None])
    pts = np.resize(pts.astype(np.float32).ravel(), (-(-pts.size // 8)) * 8)
    span = hi - lo
    rand = (rng.random((4096, 8)) * 1.4 * span + lo - 0.2 * span)
    for x in (pts.reshape(-1, 8), rand.astype(np.float32)):
        want = im.quantize(x)
        got = im.level_ids(torch.from_numpy(x).to(cuda))
        assert got.device.type == "cuda" and got.dtype == torch.int32
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        np.testing.assert_array_equal(im.level_ids(x).cpu().numpy(), want)


@pytest.mark.parametrize("metric", ["hamming", "dot", "eucl"])
@pytest.mark.parametrize("m,n,dim", [(1, 1, 8), (150, 301, 72), (129, 640, 1024)])
def test_distance_kernel_matches_plain(cuda, metric, m, n, dim, rng):
    if metric == "eucl":
        q = torch.from_numpy(rng.standard_normal((m, dim)).astype(np.float32))
        p = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
    elif metric == "dot":
        q, p = _bipolar_t(rng, m, dim), _bipolar_t(rng, n, dim)
    else:
        q = torch.from_numpy((rng.random((m, dim)) > .5).astype(np.float32))
        p = torch.from_numpy((rng.random((n, dim)) > .5).astype(np.float32))
    want = tcs.distance_reference(q.to(cuda), p.to(cuda), metric=metric)
    before = tcs.LAUNCHES["distance"]
    got = tcs.distance(q.to(cuda), p.to(cuda), metric=metric)
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["distance"] == before + 1
    if metric == "eucl":
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=EUCL_RTOL, atol=EUCL_ATOL)
    else:
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), tcs.distance_reference(q, p,
                                                             metric=metric))


@pytest.mark.parametrize("metric", ["hamming", "dot", "eucl"])
@pytest.mark.parametrize("m", [1, 129, 624])
@pytest.mark.parametrize("dim", [72, 1024])
def test_distance_kernel_tf32x3_route(cuda, metric, m, dim, rng):
    """B6 on the 3xTF32 pipeline at N = 301 (a ragged last tile): {0, 1}
    hamming and +-1 dot bit-identical to the plain version; eucl within
    tolerance, and 300 entries (the 150 furthest from the plain version and
    150 at random) bit-identical to the replay of the kernel's own
    arithmetic (``tf32x3_kernel_eucl``)."""
    n = 301
    if metric == "eucl":
        q = torch.from_numpy(rng.standard_normal((m, dim)).astype(np.float32))
        p = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
    elif metric == "dot":
        q, p = _bipolar_t(rng, m, dim), _bipolar_t(rng, n, dim)
    else:
        q = torch.from_numpy((rng.random((m, dim)) > .5).astype(np.float32))
        p = torch.from_numpy((rng.random((n, dim)) > .5).astype(np.float32))
    qc, pc = q.to(cuda), p.to(cuda)
    got = tcs.distance(qc, pc, metric=metric)
    torch.cuda.synchronize()
    want = tcs.distance_reference(qc, pc, metric=metric)
    if metric != "eucl":
        assert torch.equal(got, want)
        return
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=EUCL_RTOL, atol=EUCL_ATOL)
    flat = (got - want).abs().flatten()
    pick = torch.cat([flat.topk(min(150, flat.numel())).indices,
                      torch.from_numpy(rng.integers(0, flat.numel(), 150)
                                       ).to(cuda)])
    rows, cols = pick // n, pick % n
    replay = tcs.tf32x3_kernel_eucl(qc[rows], pc[cols])
    assert torch.equal(got[rows, cols], replay)


def test_cam_exact_eucl_on_identical_rows(cuda, rng):
    """Pinned: ``cam_exact(metric="eucl")`` on identical rows.  The 3xTF32
    product truncates each k-step, so the norms (float32 sums) and the
    product do not cancel: identical float rows get the small positive
    distance the replay gives, and no exact match.  Integer-valued rows
    (every partial sum exact) get 0 and match."""
    from repro_torch.kernels import ops as tops
    x = torch.from_numpy(rng.standard_normal((6, 72)).astype(np.float32))
    xi = torch.from_numpy(rng.integers(-3, 4, (6, 72)).astype(np.float32))
    for rows, exact in ((x, False), (xi, True)):
        r = rows.to(cuda)
        d = tops.cam_distances(r, r, metric="eucl").diagonal()
        want = tcs.tf32x3_kernel_eucl(r, r)
        assert torch.equal(d, want)
        assert bool(((want == 0) if exact else (want > 0)).all())
        assert torch.equal(tops.cam_exact(r, r, metric="eucl").diagonal(),
                           torch.full((6,), exact, device=cuda))


def test_ops_distance_entry_points_on_the_card(cuda, rng):
    from repro_torch.kernels import ops as tops
    q = torch.from_numpy((rng.random((33, 45)) > .5).astype(np.float32))
    p = torch.from_numpy((rng.random((70, 45)) > .5).astype(np.float32))
    p[5] = q[2]
    d = tops.cam_distances(q.to(cuda), p.to(cuda), metric="hamming")
    want = (q[:, None, :] != p[None, :, :]).sum(-1).float()
    assert torch.equal(d.cpu(), want)
    assert torch.equal(tops.cam_exact(q.to(cuda), p.to(cuda)).cpu(),
                       want == 0)
    assert torch.equal(tops.cam_range(q.to(cuda), p.to(cuda), 20.0).cpu(),
                       want <= 20.0)


def test_distance_kernel_refuses_bad_operands(cuda):
    q = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        tcs.distance(q[:, :12].contiguous(), q[:, :12].contiguous(),
                     metric="dot")
    with pytest.raises(ValueError, match="metric"):
        tcs.distance(q, q, metric="cos")
    with pytest.raises(ValueError, match="contiguous"):
        tcs.distance(q.T[:8], q, metric="dot")
    with pytest.raises(ValueError, match="float32"):
        tcs.distance(q.double(), q, metric="dot")


# ---------------------------------------------------------------------------
# update_rows on the "cuda" backend: bit-identical to a fresh plan
# ---------------------------------------------------------------------------


def _mutable_program(case, rng, m, n, dim):
    """(compile, queries, stored operands, new rows, care) for one plan
    family on the card."""
    arch = T.ArchSpec(rows=64, cols=64)
    care = None
    if case == "eucl":
        q = rng.standard_normal((m, dim)).astype(np.float32)
        g = rng.standard_normal((n, dim)).astype(np.float32)
        return (lambda: T.compile_fn(_knn, [q, g], arch, value_bits=8), q,
                (g,), (rng.standard_normal((4, dim)).astype(np.float32),),
                None)
    if case in ("packed", "ternary"):
        q = (rng.random((m, dim)) > .5).astype(np.float32)
        g = (rng.random((n, dim)) > .5).astype(np.float32)
        if case == "ternary":
            care = (rng.random((n, dim)) > .2).astype(np.int8)
        return (lambda: T.compile_module(
                    _hamming_module(m, n, dim, 10, case == "ternary"), arch,
                    value_bits=1), q, (g,),
                ((rng.random((4, dim)) > .5).astype(np.float32),), care)
    if case == "interval":
        q, lo, hi = _intervals(rng, m, n, dim)
        return (lambda: T.compile_module(_range_program(m, n, dim, True),
                                         arch, cam_type=T.CamType.ACAM),
                q, (lo, hi),
                (lo[:4] - 1.0, hi[:4] + 1.0), None)
    q = rng.standard_normal((m, dim)).astype(np.float32)
    g = rng.standard_normal((n, dim)).astype(np.float32)
    return (lambda: T.compile_module(
                _range_program(m, n, dim, False, metric="eucl",
                               tau=2.0 * dim), arch), q, (g,),
            (rng.standard_normal((4, dim)).astype(np.float32),), None)


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("case", ["eucl", "packed", "ternary", "interval",
                                  "threshold"])
def test_update_rows_on_the_card_matches_a_fresh_plan(cuda, case, donate,
                                                      rng):
    m, n, dim = 70, 700, 96
    build, q, stored, new, care = _mutable_program(case, rng, m, n, dim)
    T.clear_plan_cache()
    prog = build()
    plan = prog.engine_plan
    assert plan.backend == "cuda" and plan.device.type == cuda.type
    assert plan.packed == (case in ("packed", "ternary"))
    qt = torch.from_numpy(q).to(cuda)
    ts = tuple(torch.from_numpy(s).to(cuda) for s in stored)
    extra = () if care is None else (torch.from_numpy(care).to(cuda),)
    before = prog(qt, *ts, *extra)
    idx = np.array([0, 1, 350, n - 1])
    if len(ts) == 2:
        out = plan.update_rows(ts, idx, new, donate=donate)
    else:
        out = (plan.update_rows(ts[0], idx, new[0],
                                care=extra[0] if extra else None,
                                donate=donate),)
    assert all((a is b) == donate for a, b in zip(out, ts))
    hits0, miss0 = plan.pattern_hits, plan.pattern_misses
    got = prog(qt, *out, *extra)
    assert plan.pattern_hits == hits0 + 1 and plan.pattern_misses == miss0
    assert plan.row_update_fallbacks == 0
    T.clear_plan_cache()
    fresh = build()(qt, *(o.clone() for o in out), *extra)
    got, fresh = (got, fresh) if isinstance(got, tuple) else ((got,),
                                                              (fresh,))
    for a, b in zip(got, fresh):
        assert torch.equal(a, b)
    if not donate:       # the old gallery still gives its old result
        old = prog(qt, *ts, *extra)
        for a, b in zip(old if isinstance(old, tuple) else (old,),
                        before if isinstance(before, tuple) else (before,)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# B7: attention forward (flash_attention.cu) and the LM on the card
# ---------------------------------------------------------------------------

#: the reference's bounds: float32 2e-3; 0.05 where a bfloat16 operand
#: (or bfloat16-rounded probabilities) is involved
B7_F32_ATOL, B7_BF16_ATOL = 2e-3, 0.05
#: (S, T, kwargs) for each masking case
B7_CASES = {
    "causal": (77, 77, dict(causal=True)),
    "full": (50, 133, dict(causal=False)),
    "full_kv_len": (31, 133, dict(causal=False, kv_len=100)),
    "prefix": (100, 100, dict(causal=True, prefix_len=40)),
    "prefill_into_cache": (70, 200, dict(causal=True, kv_len=70)),
    "decode": (1, 300, dict(causal=True, q_start=257, kv_len=258)),
    "chunk": (9, 140, dict(causal=True, q_start=120, kv_len=129)),
}
B7_DTYPES = {"bf16": (torch.bfloat16, torch.bfloat16),
             "f32": (torch.float32, torch.float32),
             "f32_bf16_cache": (torch.float32, torch.bfloat16)}


def _qkv(rng, b, s, t, h, kvh, dh, dtype, kv_dtype, device):
    def make(shape, dt):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device, dt)
    return (make((b, s, h, dh), dtype), make((b, t, kvh, dh), kv_dtype),
            make((b, t, kvh, dh), kv_dtype))


@pytest.mark.parametrize("case", list(B7_CASES))
@pytest.mark.parametrize("dtypes", list(B7_DTYPES))
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 5])
def test_flash_kernel_matches_plain(cuda, case, dtypes, dh, g, rng):
    s, t, kw = B7_CASES[case]
    dtype, kv_dtype = B7_DTYPES[dtypes]
    q, k, v = _qkv(rng, 2, s, t, 2 * g, 2, dh, dtype, kv_dtype, cuda)
    tcs.reset_launch_counts()
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["flash_attention"] == 1
    want = tfa.flash_attention_reference(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    atol = B7_F32_ATOL if dtypes == "f32" else B7_BF16_ATOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtypes", list(B7_DTYPES))
@pytest.mark.parametrize("dh", [16, 32])
def test_flash_kernel_small_head_dims(cuda, dh, dtypes, rng):
    dtype, kv_dtype = B7_DTYPES[dtypes]
    q, k, v = _qkv(rng, 1, 40, 40, 10, 2, dh, dtype, kv_dtype, cuda)
    got = tfa.flash_attention(q, k, v, causal=True)
    want = tfa.flash_attention_reference(q, k, v, causal=True)
    atol = B7_F32_ATOL if dtypes == "f32" else B7_BF16_ATOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_reads_a_strided_cache_view_up_to_kv_len(cuda, dtype,
                                                              rng):
    """k / v are one layer's view of a (layers, B, S_max, KV, dh) cache;
    rows at or past kv_len hold NaN and must never be read."""
    kv_len, s_max = 90, 160
    q = torch.from_numpy(rng.standard_normal((2, 1, 10, 128)).astype(
        np.float32)).to(cuda, dtype)
    # stored (k/v, layers, S_max, B, KV, dh): a layer's (B, S_max, KV, dh)
    # view steps over the batch inside the row stride
    cache = torch.from_numpy(rng.standard_normal(
        (2, 3, s_max, 2, 2, 128)).astype(np.float32)).to(cuda, torch.bfloat16)
    cache[:, :, kv_len:] = float("nan")
    k, v = cache[0, 1].transpose(0, 1), cache[1, 1].transpose(0, 1)
    assert not k.is_contiguous() and k.shape == (2, s_max, 2, 128)
    kw = dict(causal=True, q_start=kv_len - 1, kv_len=kv_len)
    got = tfa.flash_attention(q, k, v, **kw)
    want = tfa.flash_attention_reference(
        q, k[:, :kv_len].contiguous(), v[:, :kv_len].contiguous(), **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=B7_BF16_ATOL,
                               rtol=0)


def test_flash_kernel_contract_violations_raise(cuda, rng):
    q, k, v = _qkv(rng, 1, 8, 8, 4, 2, 48, torch.float32, torch.float32,
                   cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, k, v)
    q, k, v = _qkv(rng, 1, 8, 8, 4, 2, 64, torch.float32, torch.float32,
                   cuda)
    with pytest.raises(ValueError, match="unit last stride"):
        tfa.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3),
                            k, v)
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_attention(q.bfloat16(), k, v)
    with pytest.raises(ValueError, match="is on"):
        tfa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="kv_len"):
        tfa.flash_attention(q, k, v, kv_len=9)


def _small_lm(dtype):
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced
    cfg = reduced(get_config("qwen2.5-14b"), n_layers=3, n_heads=10,
                  d_model=640, d_ff=512, vocab=512)
    return dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)


def test_lm_entry_points_on_the_card_launch_b7_per_layer(cuda):
    """forward / prefill / decode_step on the card: one B7 launch per
    layer and call, logits close to the same model on the CPU.  Float32,
    TF32 off: ``forward`` within 1e-4.  Prefill and decode attend over
    the bfloat16 cache with probabilities rounded to bfloat16, before
    normalising on the card (the Pallas kernel's recurrence) and after it
    on the CPU (``attn_core``), so their logits get the reference's bf16
    attention bound, 0.05, and equal argmaxes."""
    from repro_torch.models import model as tm
    cfg = _small_lm("float32")
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (10, 2, 64)
    cpu_params = tm.init_params(cfg, seed=0, device="cpu")
    params = tm._tree_map(lambda t: t.to(cuda), cpu_params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 20)))

    def run(p, dev):
        t = toks.to(dev)
        out = {}
        tcs.reset_launch_counts()
        out["forward"] = tm.forward(p, cfg, {"tokens": t})
        launches = [tcs.LAUNCHES["flash_attention"]]
        cache = tm.init_decode_cache(cfg, 2, 24, device=dev)
        lg, cache = tm.prefill(p, cfg, {"tokens": t[:, :16]}, cache)
        launches.append(tcs.LAUNCHES["flash_attention"])
        outs = [lg]
        for i in range(16, 20):
            lg, cache = tm.decode_step(p, cfg, t[:, i:i + 1], cache)
            outs.append(lg)
        launches.append(tcs.LAUNCHES["flash_attention"])
        out["serve"] = torch.cat(outs, dim=1)
        return {k: v.cpu() for k, v in out.items()}, launches

    got, launches = run(params, cuda)
    assert launches == [3, 6, 6 + 4 * 3]
    want, cpu_launches = run(cpu_params, torch.device("cpu"))
    assert cpu_launches == [0, 0, 0]
    torch.testing.assert_close(got["forward"], want["forward"], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(got["serve"], want["serve"],
                               atol=B7_BF16_ATOL, rtol=0)
    assert torch.equal(got["serve"].argmax(-1), want["serve"].argmax(-1))


def _recurrence(q, k, v, **kw):
    """The Pallas recurrence at the tile width and kv splits of the route
    the kernel takes for this call."""
    route = tfa.flash_route(q.shape, k.shape, q.dtype, **kw)
    return tfa.flash_attention_recurrence(q, k, v, block_k=route.block_k,
                                          splits=route.splits, **kw)


def _assert_follows_recurrence(got, want, v):
    """bf16: at most 0.1 % of the outputs more than one bf16 step away,
    none by more than one bf16 step of a probability times max|v|."""
    off = (got.float() - want.float()).abs()
    beyond = off > 1e-6 + 2 ** -7 * want.float().abs()
    assert float(beyond.float().mean()) <= 1e-3
    assert float(off.max()) <= 2 ** -8 * float(v.float().abs().max())


@pytest.mark.parametrize("case", ["causal", "prefix", "decode", "chunk"])
@pytest.mark.parametrize("dtypes", list(B7_DTYPES))
def test_flash_kernel_follows_the_pallas_recurrence(cuda, case, dtypes,
                                                    rng):
    """Where bfloat16 probabilities make the kernel and the plain version
    differ (up to the 0.05 bound), the kernel still follows the Pallas
    kernel's own recurrence closely: float32 outputs within 1e-5.  In
    bfloat16 the tensor cores sum the scores in another order, which can
    flip a probability's bf16 rounding: rarely (at most 0.1 % of the
    outputs more than one bf16 step away; the plain version's rounding
    point moves about 15 % of them), and by at most one bf16 step of a
    probability times the largest |v| each."""
    s, t, kw = B7_CASES[case]
    dtype, kv_dtype = B7_DTYPES[dtypes]
    q, k, v = _qkv(rng, 2, s, t, 10, 2, 64, dtype, kv_dtype, cuda)
    got = tfa.flash_attention(q, k, v, **kw)
    want = _recurrence(q, k, v, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        _assert_follows_recurrence(got, want, v)


#: (B, S, T, H, KV, kwargs, route) at the split boundaries and the route
#: threshold: S * H / KV query rows per kv head, at most
#: FLASH_SPLITKV_ROWS (64) on the split-KV route
B7_ROUTE_CASES = {
    "long_cache": (1, 1, 4100, 10, 2,
                   dict(causal=True, q_start=4096, kv_len=4097), "splitkv"),
    "kv_len_inside_one_split": (1, 1, 4100, 10, 2,
                                dict(causal=True, q_start=49, kv_len=50),
                                "splitkv"),
    "chunk_at_4000": (1, 9, 4100, 10, 2,
                      dict(causal=True, q_start=4000, kv_len=4009),
                      "splitkv"),
    "at_threshold": (2, 16, 200, 8, 2,
                     dict(causal=True, q_start=100, kv_len=116), "splitkv"),
    "above_threshold": (2, 17, 200, 8, 2,
                        dict(causal=True, q_start=100, kv_len=117), "wgmma"),
    "served_gqa": (2, 1, 2100, 40, 8,
                   dict(causal=True, q_start=2048, kv_len=2049), "splitkv"),
    "long_prefill": (1, 300, 300, 4, 2, dict(causal=True), "wgmma"),
}


@pytest.mark.parametrize("case", list(B7_ROUTE_CASES))
@pytest.mark.parametrize("dh", [16, 128])
def test_flash_kernel_routes_and_split_boundaries(cuda, case, dh, rng):
    """Each route, chosen by flash_route, against the plain version (0.05)
    and against the Pallas recurrence at the route's own tile width and
    kv splits (one bf16 step); one launch per call."""
    b, s, t, h, kvh, kw, name = B7_ROUTE_CASES[case]
    q, k, v = _qkv(rng, b, s, t, h, kvh, dh, torch.bfloat16, torch.bfloat16,
                   cuda)
    route = tfa.flash_route(q.shape, k.shape, q.dtype, **kw)
    assert route.name == name
    if name == "splitkv":
        assert route.block_k == 64 and route.splits >= 1
    else:
        assert route.block_k == 128 and route.splits is None
    tcs.reset_launch_counts()
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["flash_attention"] == 1
    assert bool(torch.isfinite(got).all())
    want = tfa.flash_attention_reference(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=B7_BF16_ATOL,
                               rtol=0)
    _assert_follows_recurrence(got, _recurrence(q, k, v, **kw), v)


def test_flash_wgmma_reads_a_strided_cache_view_up_to_kv_len(cuda, rng):
    """The prefill route's tensor maps cover a layer's strided view of a
    stacked cache; rows at or past kv_len hold NaN and are never read."""
    kv_len, s_max, s = 90, 160, 70
    q = torch.from_numpy(rng.standard_normal((2, s, 10, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    cache = torch.from_numpy(rng.standard_normal(
        (2, 3, s_max, 2, 2, 128)).astype(np.float32)).to(cuda, torch.bfloat16)
    cache[:, :, kv_len:] = float("nan")
    k, v = cache[0, 1].transpose(0, 1), cache[1, 1].transpose(0, 1)
    kw = dict(causal=True, q_start=kv_len - s, kv_len=kv_len)
    assert tfa.flash_route(q.shape, k.shape, q.dtype, **kw).name == "wgmma"
    got = tfa.flash_attention(q, k, v, **kw)
    kc, vc = k[:, :kv_len].contiguous(), v[:, :kv_len].contiguous()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(
        got.float(), tfa.flash_attention_reference(q, kc, vc, **kw).float(),
        atol=B7_BF16_ATOL, rtol=0)
    _assert_follows_recurrence(got, _recurrence(q, kc, vc, **kw), v[:, :kv_len])


def test_server_on_the_card_matches_cpu(cuda):
    from repro_torch.launch import serve as tserve
    from repro_torch.models import model as tm
    cfg = _small_lm("float32")
    cpu_params = tm.init_params(cfg, seed=3, device="cpu")
    params = tm._tree_map(lambda t: t.to(cuda), cpu_params)

    def serve(p, dev):
        srv = tserve.Server(cfg, p, batch=2, max_len=20, device=dev)
        rng = np.random.default_rng(2)
        reqs = [tserve.Request(rid=i, prompt=rng.integers(1, cfg.vocab, 12),
                               max_new=5) for i in range(3)]
        for r in reqs:
            srv.submit(r)
        tcs.reset_launch_counts()
        stats = srv.run()
        return [r.out for r in reqs], stats, tcs.LAUNCHES["flash_attention"]

    got, stats, launches = serve(params, cuda)
    want, _, _ = serve(cpu_params, "cpu")
    assert got == want
    assert launches == cfg.n_layers * (stats["prefills"]
                                       + stats["decode_steps"]) == 3 * 15


# ---------------------------------------------------------------------------
# serving and faults on the card
# ---------------------------------------------------------------------------


def _served(cuda, metric, rng, n=3000, dim=256):
    """(plan on the card, host queries, gallery tensor on the card)."""
    from repro_torch.core.engine import get_plan
    if metric == "eucl":
        prog = T.compile_fn(_knn, [rng.standard_normal((64, dim)).astype(
            np.float32), rng.standard_normal((n, dim)).astype(np.float32)],
            T.ArchSpec(rows=64, cols=64), value_bits=8)
        plan = prog.engine_plan
        q = rng.standard_normal((52, dim)).astype(np.float32)
        g = rng.standard_normal((n, dim)).astype(np.float32)
    else:
        plan = get_plan(T.compile_module(
            _hamming_module(64, n, dim, 10, False), T.ArchSpec(rows=64,
                                                               cols=64),
            value_bits=1).stages["cim_partitioned"])
        q = (rng.random((52, dim)) > 0.5).astype(np.float32)
        g = (rng.random((n, dim)) > 0.5).astype(np.float32)
    assert plan.device.type == "cuda" and plan.backend == "cuda"
    return plan, q, torch.from_numpy(g).to(cuda)


@pytest.mark.parametrize("metric", ["eucl", "hamming"])
def test_served_results_equal_direct_on_the_card(cuda, metric, rng):
    """Batching changes scheduling, never arithmetic: each request's rows
    served from coalesced batches equal the plan's direct call bit for
    bit (the kernels compute each query row alone), and no batch was
    served degraded."""
    import threading
    from repro_torch.serving import CamSearchServer
    plan, q, g = _served(cuda, metric, rng)
    want_v, want_i = (x.cpu().numpy() for x in plan.execute(q, g))
    expect = "fused_topk" if metric == "eucl" else "fused_topk_packed"
    blocks = np.array_split(np.arange(len(q)), 13)
    got = {}
    tcs.reset_launch_counts()
    with CamSearchServer(plan, g, max_wait_ms=2.0) as srv:
        def client(c):
            got[c] = srv.search(q[blocks[c]], timeout=120)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(len(blocks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        h, snap = srv.health(), srv.snapshot()
    assert tcs.LAUNCHES[expect] >= 1
    for c, rows in enumerate(blocks):
        np.testing.assert_array_equal(got[c][1], want_i[rows])
        np.testing.assert_array_equal(got[c][0], want_v[rows])
    assert h["degraded_batches"] == 0 and h["backend_errors"] == 0
    assert h["breaker"]["state"] == "closed"
    assert snap["requests"] == len(blocks) and snap["plan"]["device"] == \
        str(plan.device)


def test_update_after_dispatch_keeps_the_batch_on_the_old_gallery(cuda,
                                                                   rng):
    """An in-place update (``donate=True``) enqueued after a batch's
    dispatch, but before its finalize, leaves that batch on the old
    gallery: plan-level, and through the server with the writer on a
    stream of its own (the server runs it on the server's stream)."""
    import threading
    from repro_torch.serving import CamSearchServer
    plan, q, g = _served(cuda, "hamming", rng, n=40000)
    n, dim = g.shape
    rows = np.arange(0, n, 3)
    new = (rng.random((rows.size, dim)) > 0.5).astype(np.float32)
    old = tuple(x.cpu() for x in plan.execute(q, g.clone()))
    g2 = g.clone()
    fresh = g.clone()
    fresh[torch.from_numpy(rows).to(cuda)] = torch.from_numpy(new).to(cuda)
    want_new = tuple(x.cpu() for x in plan.execute(q, fresh))
    assert not torch.equal(old[1], want_new[1])

    plan.execute(q, g2)                       # memoise g2's layout
    pending = plan.dispatch(q, g2)
    plan.update_rows(g2, rows, new, donate=True)
    got = tuple(x.cpu() for x in plan.finalize(pending))
    assert torch.equal(got[0], old[0]) and torch.equal(got[1], old[1])
    after = tuple(x.cpu() for x in plan.execute(q, g2))
    assert torch.equal(after[1], want_new[1])

    gate = threading.Event()
    with CamSearchServer(plan, g.clone()) as srv:
        complete = srv._complete_one

        def held(item):
            assert gate.wait(120)
            complete(item)

        srv._complete_one = held
        req = srv.submit(q)
        for _ in range(12000):
            if srv.stats["batches"] >= 1:
                break
            threading.Event().wait(0.01)
        assert srv.stats["batches"] >= 1
        side = torch.cuda.Stream(device=cuda)
        with torch.cuda.stream(side):
            srv.update_gallery(rows, new, donate=True)
        gate.set()
        res = req.wait(timeout=120)
        later = srv.search(q, timeout=120)
    np.testing.assert_array_equal(res.indices, old[1].numpy())
    np.testing.assert_array_equal(res.values, old[0].numpy())
    np.testing.assert_array_equal(later[1], want_new[1].numpy())


@pytest.mark.parametrize("metric", ["eucl", "hamming"])
def test_faulted_cuda_equals_plain_on_corrupted_sources(cuda, metric, rng):
    """A fault model on the ``"cuda"`` backend corrupts the host sources
    before the prepare: the kernels' result equals the plain versions
    (the same plan on the CPU) on the corrupted gallery, and a null model
    is bit-identical to none."""
    from repro_torch.core.engine import get_plan, module_for_spec
    from repro_torch.faults import FaultModel
    plan, q, g = _served(cuda, metric, rng)
    fm = FaultModel(seed=3, p_stuck=1e-3, p_flip=1e-3,
                    sigma=0.02 if metric == "eucl" else 0.0)
    got = tuple(x.cpu().numpy() for x in plan.execute(q, g, faults=fm))
    corrupted, = fm.corrupt_stored((g.cpu().numpy(),), plan.spec)
    on_card = tuple(x.cpu().numpy() for x in plan.execute(
        q, torch.from_numpy(corrupted).to(cuda)))
    np.testing.assert_array_equal(got[0], on_card[0])
    np.testing.assert_array_equal(got[1], on_card[1])
    cpu_plan = get_plan(module_for_spec(plan.spec), backend="cuda",
                        pack=plan.packed, device="cpu")
    plain = tuple(x.numpy() for x in cpu_plan.execute(q, corrupted))
    if metric == "eucl":
        _assert_eucl_close(q, corrupted, plain[0], plain[1], *got)
    else:
        np.testing.assert_array_equal(got[0], plain[0])
        np.testing.assert_array_equal(got[1], plain[1])
    clean = tuple(x.cpu().numpy() for x in plan.execute(q, g))
    null = tuple(x.cpu().numpy() for x in plan.execute(
        q, g, faults=FaultModel(p_stuck=0)))
    np.testing.assert_array_equal(null[0], clean[0])
    np.testing.assert_array_equal(null[1], clean[1])


def test_failing_primary_is_counted_not_hidden(cuda, rng):
    """A plan on the card has no fallback level: a result that cannot be
    read (where a failing launch surfaces) fails its batch, and a
    dispatch that fails its retries fails its batch; both are counted in
    ``backend_errors`` and show in ``health()``, and no plain version
    answers for the kernel.  Later batches are served by the kernels."""
    from repro_torch.serving import CamSearchServer
    from repro_torch.serving.resilience import BREAKER_THRESHOLD, \
        MAX_RETRIES
    plan, q, g = _served(cuda, "hamming", rng)
    want = tuple(x.cpu().numpy() for x in plan.execute(q, g))

    def broken(pending):
        raise RuntimeError("an illegal memory access was encountered")

    plan.finalize = broken
    try:
        with CamSearchServer(plan, g) as srv:
            with pytest.raises(RuntimeError, match="illegal memory"):
                srv.search(q, timeout=120)
            h = srv.health()
    finally:
        del plan.finalize
    assert h["backend_errors"] == 1 and h["degraded_batches"] == 0
    assert h["fallback_levels"] == []
    assert h["breaker"]["consecutive_failures"] == 1
    assert srv.stats["errors"] == 1

    dead = {"primary": True}

    def injector(level):
        if dead[level]:
            raise RuntimeError("dead kernel")

    with CamSearchServer(plan, g, fault_injector=injector) as srv:
        with pytest.raises(RuntimeError, match="dead kernel"):
            srv.search(q, timeout=120)
        h = srv.health()
        dead["primary"] = False
        got = srv.search(q, timeout=120)
        after = srv.health()
    assert h["backend_errors"] == MAX_RETRIES + 1
    assert h["retries"] == MAX_RETRIES and h["degraded_batches"] == 0
    assert h["fallback_levels"] == []
    if MAX_RETRIES + 1 >= BREAKER_THRESHOLD:
        assert h["breaker"]["state"] == "open" and h["status"] == "degraded"
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert after["breaker"]["state"] == "closed"
    assert after["degraded_batches"] == 0 and after["breaker_skips"] == 0


def test_hardened_plans_on_the_card(cuda, rng):
    """``HardenedPlan`` over ``"cuda"`` plans: one replica is the raw
    plan bit for bit; healing an interval plan remaps rows through the
    card's ``update_rows`` and, fully healed, matches the clean plan."""
    from repro_torch.faults import FaultModel, HardenedPlan
    plan, q, g = _served(cuda, "hamming", rng)
    hp = HardenedPlan(plan, replicas=1)
    hp.prepare(g)
    assert hp.plan.device == plan.device
    raw = tuple(x.cpu().numpy() for x in plan.execute(q, g))
    for a, b in zip(hp.execute(q), raw):
        np.testing.assert_array_equal(a, b)
    m, n, dim = 40, 700, 24
    rplan = T.compile_module(_range_program(m, n, dim, True),
                             T.ArchSpec(rows=64, cols=64),
                             cam_type=T.CamType.ACAM).engine_plan
    assert rplan.backend == "cuda" and rplan.device.type == "cuda"
    qi, lo, hi = _intervals(rng, m, n, dim, constrained=0.05)
    qi[1, 3] = 0.0
    hp = HardenedPlan(rplan, replicas=2, spares=128)
    hp.prepare(lo, hi)
    fm = FaultModel(seed=11, p_stuck=2e-3)
    report = hp.heal(fm)
    assert report.detected > 0 and report.remapped > 0
    if report.unrepairable == 0:
        np.testing.assert_array_equal(
            hp.execute(qi, faults=fm),
            rplan.execute(torch.from_numpy(qi).to(cuda),
                          torch.from_numpy(lo).to(cuda),
                          torch.from_numpy(hi).to(cuda)).cpu().numpy())


# ---------------------------------------------------------------------------
# hierarchical two-stage search (the "torch" backend on the card)
# ---------------------------------------------------------------------------


def test_hier_on_the_card_equals_flat_and_repeats_centroids(cuda, rng):
    """nprobe = clusters on the card is bit-identical to flat B1 (packed
    hamming) and within the eucl tolerance of flat B2; the probe launches
    no hand-written kernel; a server over the plan has no degraded level;
    two prepares of one eucl gallery give bit-identical centroids (the
    cluster sums run in a fixed order)."""
    from repro_torch.core.engine import get_hierarchical_plan
    arch = T.ArchSpec(rows=32, cols=64)
    q = (rng.random((37, 100)) > 0.5).astype(np.float32)
    g = (rng.random((900, 100)) > 0.5).astype(np.float32)
    prog = T.compile_module(_hamming_module(37, 900, 100, 10, False), arch,
                            value_bits=1)
    qt, gt = torch.from_numpy(q).to(cuda), torch.from_numpy(g).to(cuda)
    fv, fi = prog(qt, gt)
    hier = get_hierarchical_plan(prog.stages["cim_partitioned"], clusters=9,
                                 nprobe=9)
    assert hier.device.type == "cuda" and hier.coarse.device == hier.device
    tcs.reset_launch_counts()
    hv, hi = hier.execute(qt, gt)
    assert not any(tcs.LAUNCHES.values())
    assert torch.equal(hv, fv) and torch.equal(hi, fi)
    from repro_torch.serving import CamSearchServer
    with CamSearchServer(hier, gt) as srv:          # no chain on the card
        assert [name for name, _ in srv._levels()] == ["primary"]
        sv, si = srv.search(q)
    assert np.array_equal(si, fi.cpu().numpy())

    qe = rng.standard_normal((37, 96)).astype(np.float32)
    ge = rng.standard_normal((900, 96)).astype(np.float32)
    prog = T.compile_fn(_knn, [qe, ge], arch, value_bits=8)
    qt, gt = torch.from_numpy(qe).to(cuda), torch.from_numpy(ge).to(cuda)
    fv, fi = prog(qt, gt)
    hier = get_hierarchical_plan(prog.stages["cim_partitioned"], clusters=12,
                                 nprobe=12)
    hv, hi = hier.execute(qt, gt)
    _assert_eucl_close(qe, ge, fv.cpu().numpy(), fi.cpu().numpy(),
                       hv.cpu().numpy(), hi.cpu().numpy())
    a, b = hier._prepare(gt), hier._prepare(gt)
    assert torch.equal(a.centroid_src, b.centroid_src)
    assert np.array_equal(a.assign, b.assign)


# ---------------------------------------------------------------------------
# k > MAX_K (the matrix route), B5's wide routes, sharding, the gateway
# ---------------------------------------------------------------------------


def _select_case(rng, m, n, data):
    """An (m, n) float32 matrix for the selection: ``"random"`` (normal
    values), ``"equal"`` (every entry the same), ``"specials"`` (few
    values, so ties straddle every rank: +-inf, +-0.0, negatives) or
    ``"hamming"`` (binomial integers, as packed distances crowd)."""
    if data == "random":
        a = rng.standard_normal((m, n)).astype(np.float32)
    elif data == "equal":
        a = np.full((m, n), 3.5, np.float32)
    elif data == "specials":
        pool = np.array([np.inf, -np.inf, 0.0, -0.0, -1.5, 2.0, 7.25, -3e38],
                        np.float32)
        a = pool[rng.integers(0, pool.size, (m, n))]
    else:
        a = rng.binomial(1024, 0.5, (m, n)).astype(np.float32)
    return torch.from_numpy(a)


def _assert_same_bits(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("largest", [False, True])
@pytest.mark.parametrize("data", ["random", "equal", "specials"])
@pytest.mark.parametrize("k", ["385", "8193", "n_valid"])
@pytest.mark.parametrize("m", [1, 13, 624])
def test_topk_select_matches_plain(cuda, m, k, data, largest, rng):
    """K1s against its plain version, bit for bit: one row, a served
    micro-batch and the KNN queries (split over clusters at the first
    two), k past the window, past the shared-memory sort and at
    ``n_valid``; an odd row width takes the unaligned loads."""
    n = 20003 if data == "equal" else 20000
    n_valid = n - 37
    kk = n_valid if k == "n_valid" else int(k)
    dist = _select_case(rng, m, n, data)
    kw = dict(k=kk, largest=largest, n_valid=n_valid)
    dist = dist.to(cuda)
    before = tcs.LAUNCHES["topk_select"]
    got = tcs.topk_select(dist, **kw)
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["topk_select"] == before + 1
    _assert_same_bits(got, tcs.topk_select_reference(dist, **kw))


@pytest.mark.parametrize("data,k,largest", [("hamming", 400, False),
                                            ("random", 500, False),
                                            ("hamming", 385, True)])
@pytest.mark.parametrize("m", [13, 624])
def test_topk_select_at_the_knn_width(cuda, m, data, k, largest, rng):
    """K1s at the KNN gallery's 180,000 columns: binomial integers crowd
    a few bins (the gathered path after two passes), normal values
    spread (after one)."""
    n = 180_000
    dist = _select_case(rng, m, n, data)
    kw = dict(k=k, largest=largest, n_valid=n - 5)
    dist = dist.to(cuda)
    got = tcs.topk_select(dist, **kw)
    _assert_same_bits(got, tcs.topk_select_reference(dist, **kw))
    assert tcs.select_split(m, k, n - 5, _sms(cuda)) == (8 if m == 13 else 1)


def test_topk_select_refusals(cuda):
    d = torch.zeros((4, 300), device=cuda)
    with pytest.raises(ValueError, match="k=301"):
        tcs.topk_select(d, k=301, largest=False, n_valid=300)
    with pytest.raises(ValueError, match="contiguous"):
        tcs.topk_select(d.T, k=3, largest=False, n_valid=4)
    v, i = tcs.topk_select(d[:0], k=3, largest=False, n_valid=300)
    assert v.shape == (0, 3) and i.dtype == torch.int32


@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("m,n,lanes", [(1, 128, 8), (13, 180096, 32),
                                       (300, 1024, 40)])
def test_packed_distance_matches_plain(cuda, m, n, lanes, ternary, rng):
    """K1p against ``ref.packed_distances`` (binary and ternary), bit for
    bit, on lanes with bit 31 set, every pattern row included."""
    from repro_torch.kernels import ref as tref
    q, p = _lanes(rng, m, lanes), _lanes(rng, n, lanes)
    c = _lanes(rng, n, lanes) if ternary else None
    before = tcs.LAUNCHES["packed_distance"]
    got = tcs.packed_distance(q.to(cuda), p.to(cuda),
                              None if c is None else c.to(cuda))
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["packed_distance"] == before + 1
    want = tcs.packed_distance_reference(q, p, c)
    assert torch.equal(got.cpu(), want)
    rows = slice(0, 64)
    assert torch.equal(want[:, rows], tref.packed_distances(q, p[rows],
                       None if c is None else c[rows]))


@pytest.mark.parametrize("metric,largest", [("hamming", False),
                                            ("eucl", False), ("dot", True),
                                            ("packed", False),
                                            ("ternary", True)])
@pytest.mark.parametrize("k", [tcs.MAX_K + 1, 700])
def test_matrix_route_matches_plain(cuda, metric, largest, k, rng):
    """The matrix route against its plain version: B6's matrix (or K1p's
    on packed lanes, binary or ternary) and K1s, bit-identical on
    {0, 1} cells and lanes, eucl within tolerance with near-tie swaps
    only; one launch of each kernel a call."""
    m, n, dim = 70, 1500, 72
    if metric in ("packed", "ternary"):
        n = 1536
        q, p = _lanes(rng, m, 8), _lanes(rng, n, 8)
        args = (q, p, _lanes(rng, n, 8) if metric == "ternary" else None)
        kw = dict(k=k, largest=largest, n_valid=n - 9)
        route, want_fn = tcs.topk_by_packed_distance, \
            tcs.topk_by_packed_distance_reference
        first = "packed_distance"
    else:
        if metric == "eucl":
            q = rng.standard_normal((m, dim)).astype(np.float32)
            p = rng.standard_normal((n, dim)).astype(np.float32)
        else:
            q = (rng.random((m, dim)) > 0.5).astype(np.float32)
            p = (rng.random((n, dim)) > 0.5).astype(np.float32)
        args = (torch.from_numpy(q), torch.from_numpy(p))
        kw = dict(metric=metric, k=k, largest=largest, n_valid=n - 9)
        route, want_fn = tcs.topk_by_distance, tcs.topk_by_distance_reference
        first = "distance_topk"
    tcs.reset_launch_counts()
    got = route(*(None if a is None else a.to(cuda) for a in args), **kw)
    assert tcs.LAUNCHES[first] == 1 and tcs.LAUNCHES["topk_select"] == 1
    assert sum(tcs.LAUNCHES.values()) == 2
    want = want_fn(*args, **kw)
    gv, gi = got[0].cpu().numpy(), got[1].cpu().numpy()
    if metric == "eucl":
        _assert_eucl_close(args[0].numpy(), args[1].numpy(),
                           want[0].numpy(), want[1].numpy(), gv, gi)
    else:
        assert np.array_equal(gv, want[0].numpy())
        assert np.array_equal(gi, want[1].numpy())
    assert int(gi.max()) < n - 9


@pytest.mark.parametrize("metric", ["hamming", "ternary", "eucl"])
def test_matrix_route_main_path_on_the_card(cuda, metric, rng):
    """``compile_module`` with k = 400 on the ``"cuda"`` backend (packed
    hamming and ternary, eucl): the route is picked by shape, launches B6
    or K1p and then K1s and nothing else, and equals the ``"torch"``
    backend on the card."""
    m, n, dim, k = 40, 3000, 96, 400
    care = metric == "ternary"
    if metric == "eucl":
        q = rng.standard_normal((m, dim)).astype(np.float32)
        g = rng.standard_normal((n, dim)).astype(np.float32)
        prog = lambda **kw: T.compile_fn(_knn_k(k), [q, g],  # noqa: E731
                                         T.ArchSpec(rows=64, cols=64), **kw)
    else:
        q = (rng.random((m, dim)) > 0.5).astype(np.float32)
        g = (rng.random((n, dim)) > 0.5).astype(np.float32)
        mod = _hamming_module(m, n, dim, k, care)
        prog = lambda **kw: T.compile_module(  # noqa: E731
            mod, T.ArchSpec(rows=64, cols=64), value_bits=1, **kw)
    ins = [q, g] + ([(rng.random((n, dim)) > 0.2).astype(np.int8)]
                    if care else [])
    tcs.reset_launch_counts()
    got = prog()(*ins)
    first = "distance_topk" if metric == "eucl" else "packed_distance"
    assert tcs.LAUNCHES[first] == 1 and tcs.LAUNCHES["topk_select"] == 1
    assert sum(tcs.LAUNCHES.values()) == 2
    want = prog(backend="torch")(*ins)
    gv, gi = got[0].cpu().numpy(), got[1].cpu().numpy()
    wv, wi = want[0].cpu().numpy(), want[1].cpu().numpy()
    if metric == "eucl":
        _assert_eucl_close(q, g, wv, wi, gv, gi)
    else:
        assert np.array_equal(gv, wv) and np.array_equal(gi, wi)


def _knn_k(k):
    def knn(q, gallery):
        d = q.unsqueeze(1).sub(gallery).norm(p=2, dim=-1)
        return d.topk(k, largest=False)
    return knn


@pytest.mark.parametrize("m,f,h,levels,zero_cells", [
    (40, 65536, 256, 4, False),       # the 32 count planes
    (40, 65536, 96, 3, True),
    (300, 784, 1000, 512, False),     # the level planes in global memory
    (300, 784, 1000, 600, True),
    (17, 65552, 64, 480, False),      # both
])
def test_hdc_encode_wide_routes_match_plain(cuda, m, f, h, levels,
                                            zero_cells, rng):
    from repro_torch.kernels import hdc_encode as thdc
    hi = 2 if zero_cells else 1
    keys = torch.from_numpy(rng.choice([-1, 1, 0][:hi + 1], (f, h))
                            .astype(np.float32))
    lv = torch.from_numpy(rng.choice([-1, 1, 0][:hi + 1], (levels, h))
                          .astype(np.float32))
    q = torch.from_numpy(rng.integers(0, levels, (m, f)).astype(np.int32))
    planes = thdc.hdc_planes(keys.to(cuda), lv.to(cuda))
    assert thdc.hdc_route(f, levels) != "bitsliced"
    before = tcs.LAUNCHES["hdc_encode_wide"]
    got = thdc.hdc_encode_planes(q.to(cuda), planes).cpu()
    assert tcs.LAUNCHES["hdc_encode_wide"] == before + 1
    # the plain version on the card (exact integer sums; TF32 off)
    want = thdc.hdc_encode_reference(q.to(cuda), keys.to(cuda), lv.to(cuda))
    assert torch.equal(got, want.cpu())


def test_hdc_encode_rows_past_one_grid_dimension(cuda, rng):
    """More than 65,535 row blocks (2,097,120 rows) in one launch: the
    rows run on the grid's third dimension, bit-identical to the plain
    version on the rows on both sides of the seam and at the end."""
    from repro_torch.kernels import hdc_encode as thdc
    m, f, h, levels = 2_100_000, 16, 64, 8
    keys = torch.from_numpy(rng.choice([-1.0, 1.0], (f, h))
                            .astype(np.float32))
    lv = torch.from_numpy(rng.choice([-1.0, 1.0], (levels, h))
                          .astype(np.float32))
    q = torch.from_numpy(rng.integers(0, levels, (m, f)).astype(np.int32))
    planes = thdc.hdc_planes(keys.to(cuda), lv.to(cuda))
    got = thdc.hdc_encode_planes(q.to(cuda), planes)
    for rows in (slice(0, 4096), slice(2_097_120 - 2048, 2_097_120 + 2048),
                 slice(m - 4096, m)):
        assert torch.equal(got[rows].cpu(),
                           thdc.hdc_encode_reference(q[rows], keys, lv))
    assert thdc.hdc_route(f, levels) == "bitsliced"


@pytest.mark.parametrize("metric", ["hamming", "eucl"])
def test_sharded_plan_on_cuda_standins(cuda, metric, rng):
    """Four shards on ``cuda:0`` stand-ins (the mesh test hook) equal the
    unsharded ``"torch"`` plan on the card, before and after a sharded
    ``update_rows``; a real shard request on a one-card host clamps."""
    from repro_torch.launch.mesh import forced_devices
    m, n, dim, k = 20, 1100, 64, 7
    if metric == "eucl":
        q = rng.standard_normal((m, dim)).astype(np.float32)
        g = rng.standard_normal((n, dim)).astype(np.float32)
        prog = lambda **kw: T.compile_fn(_knn_k(k), [q, g],  # noqa: E731
                                         T.ArchSpec(rows=64, cols=64),
                                         backend="torch", **kw)
    else:
        q = (rng.random((m, dim)) > 0.5).astype(np.float32)
        g = (rng.random((n, dim)) > 0.5).astype(np.float32)
        mod = _hamming_module(m, n, dim, k, False)
        prog = lambda **kw: T.compile_module(  # noqa: E731
            mod, T.ArchSpec(rows=64, cols=64), value_bits=1,
            backend="torch", **kw)
    one = prog().engine_plan
    if torch.cuda.device_count() == 1:
        assert prog(shards=4).engine_plan is one
    with forced_devices(4, cuda):
        sh = prog(shards=4).engine_plan
    assert sh.shards == 4
    gt = torch.from_numpy(g).to(cuda)
    for a, b in zip(sh.execute(q, gt), one.execute(q, gt)):
        assert torch.equal(a, b)
    idx = np.arange(0, n, 97)
    g2 = sh.update_rows(gt, idx, g[idx[::-1]])
    assert sh.row_update_fallbacks == 0
    for a, b in zip(sh.execute(q, g2), one.execute(q, g2.clone())):
        assert torch.equal(a, b)


def test_gateway_on_the_card_fails_over(cuda, rng):
    """A gateway tenant on the card: served equals direct (B2), a killed
    replica's batches fail (no degraded chain on the card) and every
    request fails over to the healthy one, then the replica is rebuilt
    and readmitted."""
    from repro_torch.serving import CamServingGateway
    n, dim = 2000, 64
    g = rng.standard_normal((n, dim)).astype(np.float32)
    q = rng.standard_normal((13, dim)).astype(np.float32)
    prog = T.compile_fn(_knn, [q, g], T.ArchSpec(rows=64, cols=64))
    want = tuple(x.cpu().numpy() for x in prog.engine_plan.execute(q, g))
    with CamServingGateway(maint_ms=0.0) as gw:
        gw.register_tenant("t", prog, g, replicas=2, unhealthy_k=2)
        v, i = gw.search("t", q, timeout=60)
        assert np.array_equal(v, want[0]) and np.array_equal(i, want[1])
        gw.kill_replica("t", 0)
        for _ in range(6):
            res = gw.submit("t", q).wait(60)
            assert res.error is None and np.array_equal(res.indices, want[1])
        h = gw.health()["tenants"]["t"]
        assert h["stats"]["failovers"] > 0 and h["stats"]["failed"] == 0
        rep = gw.check_tenant("t")
        assert [x["mode"] for x in rep["healed"]] == ["rebuild"]
        assert all(r["state"] == "serving"
                   for r in gw.health()["tenants"]["t"]["replicas"]
                   ["replicas"])


# ---------------------------------------------------------------------------
# the plan autotuner and the served warm start on the card
# ---------------------------------------------------------------------------


def _tune_program(cuda, metric, m, n, dim, seed):
    """(partitioned module, queries, gallery on the card) of a hamming
    top-10 or eucl top-5 program at ``m x n x dim``."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(m, dim, device=cuda, generator=gen)
    g = torch.randn(n, dim, device=cuda, generator=gen)
    if metric == "hamming":
        q, g = (q > 0).float(), (g > 0).float()
        prog = T.compile_module(_hamming_module(m, n, dim, 10, False),
                                T.ArchSpec(rows=64, cols=64), value_bits=1)
    else:
        prog = T.compile_fn(_knn, [q.cpu().numpy(), g.cpu().numpy()],
                            T.ArchSpec(rows=64, cols=64), value_bits=8)
    return prog.stages["cim_partitioned"], q, g


@pytest.mark.parametrize("metric", ["hamming", "eucl"])
@pytest.mark.parametrize("m,n,dim", [(64, 3000, 96), (13, 180000, 1024)])
def test_tune_plan_on_the_card_verifies_the_winner(cuda, metric, m, n, dim):
    """``tune_plan`` on the ``"cuda"`` backend, at a small shape and at a
    gateway request's 13 rows against the KNN gallery: every candidate
    runs on the kernels (none refused, none rejected), and the winner
    equals the baseline (hamming bit for bit, eucl within the
    tolerance)."""
    from repro_torch.tune import reset_tune_stats, tune_plan, tune_stats
    T.clear_plan_cache()
    reset_tune_stats()
    mod, q, g = _tune_program(cuda, metric, m, n, dim, seed=m + n)
    tcs.reset_launch_counts()
    res = tune_plan(mod, q, g, reps=1)
    kernel = "fused_topk_packed" if metric == "hamming" else "fused_topk"
    assert tcs.LAUNCHES[kernel] > res.trials > 0
    assert res.plan.backend == "cuda" and res.plan.device.type == "cuda"
    assert not any(h.get("error") for h in res.history)
    assert tune_stats()["rejected"] == 0
    base = T.get_plan(mod)
    want = [x.cpu().numpy() for x in base.execute(q, g)]
    got = [x.cpu().numpy() for x in res.plan.execute(q, g)]
    if metric == "hamming":
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    else:
        _assert_eucl_close(q.cpu().numpy(), g.cpu().numpy(), want[0],
                           want[1], got[0], got[1])
    T.clear_plan_cache()
    torch.cuda.empty_cache()


def test_refused_candidate_on_the_card_is_recorded(cuda, rng):
    """A ternary plan on the card refuses ``pack=False``: the candidate
    is recorded in the history, the tune goes on, and no plain version
    answers on the card."""
    from repro_torch.tune import tune_plan
    m, n, dim = 24, 2000, 96
    mod = T.compile_module(_hamming_module(m, n, dim, 5, True),
                           T.ArchSpec(rows=64, cols=64),
                           value_bits=1).stages["cim_partitioned"]
    q = (rng.random((m, dim)) > 0.5).astype(np.float32)
    g = (rng.random((n, dim)) > 0.5).astype(np.float32)
    c = (rng.random((n, dim)) > 0.2).astype(np.int8)
    tcs.reset_launch_counts()
    res = tune_plan(mod, q, g, c, reps=1)
    refused = [h for h in res.history if h.get("error")]
    assert [h["pack"] for h in refused] == [False]
    assert res.plan.packed and tcs.LAUNCHES["fused_topk_packed_ternary"] > 0
    want = T.get_plan(mod).execute(q, g, c)
    for a, b in zip(res.plan.execute(q, g, c), want):
        assert torch.equal(a, b)


def test_served_warm_start_on_the_card(cuda, tmp_path, monkeypatch):
    """A server built over the heuristic plan serves with the stored
    winner (its geometry and micro-batch), on the card, bit for bit as
    the winner's direct call; ``tuned=False`` keeps the heuristic
    plan."""
    from repro_torch.serving import CamSearchServer
    from repro_torch.tune import tune_plan
    monkeypatch.setenv("REPRO_PLAN_STORE", str(tmp_path))
    T.clear_plan_cache()
    mod, q, g = _tune_program(cuda, "hamming", 64, 3000, 96, seed=1)
    res = tune_plan(mod, q, g, reps=1)
    heuristic = T.get_plan(mod)
    with CamSearchServer(heuristic, g) as srv:
        assert srv.plan is res.plan
        assert srv.plan.spec.tile_rows == res.config["tile_rows"]
        assert srv.plan.batch == res.config["batch"]
        v, i = srv.search(q[:13], timeout=60)
    want = [x.cpu().numpy() for x in res.plan.execute(q[:13], g)]
    assert np.array_equal(v, want[0]) and np.array_equal(i, want[1])
    with CamSearchServer(heuristic, g, tuned=False) as srv:
        assert srv.plan is heuristic
