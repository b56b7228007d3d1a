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
                            "flash_attention": 0, "flash_attention_bwd": 0,
                            "ssd_scan": 0, "slstm_scan": 0}
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
    """What the kernels once refused (ROADMAP Queue C, C4) now runs: head
    dims 48 and 96 (zero-padded to 64 and 128, the scale still
    1/sqrt(dh)) and operands with a non-unit last stride (copied), each
    matching the plain version forward and backward, on each route."""
    cases = [(48, torch.float32, {}), (96, torch.bfloat16, {}),
             (48, torch.bfloat16, dict(s=2)),        # split-KV
             (64, torch.float32, dict(strided=True)),
             (128, torch.bfloat16, dict(strided=True))]
    for dh, dtype, opt in cases:
        s = opt.get("s", 72)
        q, k, v = _qkv(rng, 2, s, 72, 4, 2, dh, dtype, dtype, cuda)
        if opt.get("strided"):
            q = q.transpose(1, 3).contiguous().transpose(1, 3)
            k = k.transpose(1, 3).contiguous().transpose(1, 3)
            assert q.stride()[3] != 1 and k.stride()[3] != 1
        kw = dict(causal=True, q_start=72 - s)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        got = tfa.flash_attention(qg, kg, vg, **kw)
        want, lse = tfa.flash_attention_reference(q, k, v, return_lse=True,
                                                  **kw)
        atol = B7_F32_ATOL if dtype == torch.float32 else B7_BF16_ATOL
        assert got.shape == q.shape and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=0)
        d_out = torch.randn_like(got)
        grads = torch.autograd.grad(got, (qg, kg, vg), d_out)
        plain = tfa.flash_attention_backward_reference(q, k, v, want, lse,
                                                       d_out, **kw)
        for a, w in zip(grads, plain):
            bound = (B7B_F32_OF_MAX if dtype == torch.float32
                     else B7B_BF16_OF_MAX) * float(w.float().abs().max())
            assert a.shape == w.shape
            assert float((a.float() - w.float()).abs().max()) <= bound


def test_flash_kernel_contract_checks_still_raise(cuda, rng):
    q, k, v = _qkv(rng, 1, 8, 8, 4, 2, 64, torch.float32, torch.float32,
                   cuda)
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_attention(q.bfloat16(), k, v)
    with pytest.raises(ValueError, match="is on"):
        tfa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="kv_len"):
        tfa.flash_attention(q, k, v, kv_len=9)
    with pytest.raises(ValueError, match="disagree"):
        tfa.flash_attention(q, k[..., :32], v)
    with pytest.raises(ValueError, match="exceeds the largest"):
        big = torch.zeros((1, 2, 1, 320), device=cuda)
        tfa.flash_attention(big, big, big)
    out, lse = tfa.flash_attention_reference(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="do not match"):
        tfa.flash_attention_backward(q, k, v, out, lse[:, :, :4], out)


#: B7's backward against its plain version, as a share of the plain
#: gradient's largest magnitude (chip_smoke.py's bounds)
B7B_BF16_OF_MAX, B7B_F32_OF_MAX = 2e-2, 2e-4
#: the forward's log-sum-exp against the plain one
B7_LSE_ATOL = 1e-3
#: (B, S, T, H, KV) and masks.  Beyond the first four (GQA groups of 3):
#: S and T off the 64-row tiles, a kv-tile count of 1 and odd counts (5,
#: 3) for the wgmma route's pairing of kv tiles j and n - 1 - j, groups of
#: 1, 5 and 8, and the causal, prefix, cross and cache masks on them; the
#: last, paligemma-3b's geometry at a small size (an MQA group of 8 over
#: several slices at dh 256, S off the tiles, a prefix)
B7B_CASES = {"causal": (2, 96, 96, 6, 2, dict(causal=True)),
             "prefix": (2, 96, 96, 6, 2, dict(causal=True, prefix_len=40)),
             "cross": (2, 7, 150, 6, 2, dict(causal=False)),
             "cache": (2, 3, 90, 6, 2, dict(causal=True, q_start=70,
                                            kv_len=73)),
             "causal_g5_odd": (2, 200, 300, 10, 2, dict(causal=True,
                                                        q_start=100)),
             "causal_g8_one_tile": (2, 40, 50, 8, 1, dict(causal=True,
                                                          q_start=10)),
             "prefix_g1_odd": (1, 150, 150, 4, 4, dict(causal=True,
                                                       prefix_len=70)),
             "cross_g5": (2, 130, 300, 10, 2, dict(causal=False,
                                                   kv_len=250)),
             "cache_g8": (2, 5, 300, 8, 1, dict(causal=True, q_start=290,
                                                kv_len=295)),
             "paligemma_small": (2, 300, 300, 8, 1, dict(causal=True,
                                                         prefix_len=40))}


@pytest.mark.parametrize("case", list(B7B_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", list(tfa.FLASH_HEAD_DIMS))
def test_flash_backward_matches_plain(cuda, case, dtype, dh, rng):
    """The backward kernels at every instantiated head dim, both dtypes,
    causal / prefix / cross / cache masks, GQA groups of 1, 3, 5 and 8,
    each on the route flash_bwd_route names (wgmma: bf16, at dh 256 with
    its slices; fma: float32)."""
    b, s, t, h, kvh, kw = B7B_CASES[case]
    q, k, v = _qkv(rng, b, s, t, h, kvh, dh, dtype, dtype, cuda)
    d_out = _qkv(rng, b, s, t, h, kvh, dh, dtype, dtype, cuda)[0]
    route = tfa.flash_bwd_route(q.shape, k.shape, dtype, **kw)
    want_route = "fma" if dtype == torch.float32 else "wgmma"
    assert route.name == want_route
    assert route.paired == (want_route == "wgmma" and kw["causal"])
    out, lse = tfa.flash_attention_reference(q, k, v, return_lse=True, **kw)
    tcs.reset_launch_counts()
    got = tfa.flash_attention_backward(q, k, v, out, lse, d_out, **kw)
    assert tcs.LAUNCHES["flash_attention_bwd"] == 1
    want = tfa.flash_attention_backward_reference(q, k, v, out, lse, d_out,
                                                  **kw)
    share = B7B_F32_OF_MAX if dtype == torch.float32 else B7B_BF16_OF_MAX
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        bound = share * float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= bound
    if kw.get("kv_len"):              # rows no query sees get no gradient
        assert not bool(got[1][:, kw["kv_len"]:].any())


@pytest.mark.parametrize("route", ["wgmma", "splitkv", "fma"])
@pytest.mark.parametrize("dh", [64, 80, 256])
def test_flash_forward_log_sum_exp_each_route(cuda, route, dh, rng):
    s = {"wgmma": 200, "splitkv": 5, "fma": 70}[route]
    dtype = torch.float32 if route == "fma" else torch.bfloat16
    q, k, v = _qkv(rng, 2, s, 300, 4, 1, dh, dtype, dtype, cuda)
    kw = dict(causal=True, q_start=300 - s, prefix_len=20)
    assert tfa.flash_route(q.shape, k.shape, dtype, **kw).name == route
    out, lse = tfa._forward_cuda(q, k, v, True, 20, None, 300 - s,
                                 want_lse=True)
    want_out, want = tfa.flash_attention_reference(q, k, v, return_lse=True,
                                                   **kw)
    torch.testing.assert_close(lse, want, atol=B7_LSE_ATOL, rtol=0)
    torch.testing.assert_close(out, tfa.flash_attention(q, k, v, **kw),
                               atol=0, rtol=0)


@pytest.mark.parametrize("dh", [128, 256])
def test_flash_backward_is_deterministic(cuda, dh, rng):
    """dK and dV (an MQA group of 8: at dh 128 summed in registers, the
    two warpgroups' partial sums added in a fixed order; at dh 256 the
    slices' partial sums added in slice order) bit for bit over four
    calls, as dQ."""
    q, k, v = _qkv(rng, 1, 300, 300, 8, 1, dh, torch.bfloat16,
                   torch.bfloat16, cuda)
    assert tfa.flash_bwd_route(q.shape, k.shape, q.dtype).name == "wgmma"
    if dh == 256:
        assert tfa.flash_bwd_slices(q.shape, k.shape) > 1
    d_out = torch.randn_like(q)
    out, lse = tfa._forward_cuda(q, k, v, True, 0, None, 0, want_lse=True)
    first = tfa.flash_attention_backward(q, k, v, out, lse, d_out)
    for _ in range(3):
        again = tfa.flash_attention_backward(q, k, v, out, lse, d_out)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_one_train_step_is_deterministic_and_launches_b7b(cuda):
    """One train step of a small bf16 model on the card, twice from the
    same state: bit-identical parameters; B7's forward twice a layer
    (remat recomputes it) and its backward once."""
    from repro_torch.models import steps as ts
    from repro_torch.optim import constant
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(_small_lm("bfloat16"), remat="full")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 160))).to(cuda)
    step = ts.make_train_step(cfg, constant(1e-3))
    outs = []
    for _ in range(2):
        state = ts.init_train_state(cfg, seed=3)
        tcs.reset_launch_counts()
        state, metrics = step(state, {"tokens": toks})
        assert tcs.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
        assert tcs.LAUNCHES["flash_attention_bwd"] == cfg.n_layers
        assert np.isfinite(float(metrics["loss"]))
        outs.append([p.detach().clone() for p in leaves(state.params)])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


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


#: (B, S, T, H, KV, kwargs, bf16 route, split-KV row tiles) at the head
#: dims of zamba2 (80) and paligemma (256): prefix_len, kv_len, MQA, and
#: both split-KV row tilings (RT 1 up to 16 folded rows, 4 up to 64)
B7_WIDE_CASES = {
    "prefill_prefix_mqa": (2, 300, 300, 8, 1, dict(causal=True,
                                                   prefix_len=100),
                           "wgmma", None),
    "prefill_into_cache": (1, 200, 260, 4, 4, dict(causal=True, kv_len=200),
                           "wgmma", None),
    "full_kv_len": (2, 70, 133, 4, 2, dict(causal=False, kv_len=100),
                    "wgmma", None),
    "decode_mqa": (2, 1, 400, 8, 1, dict(causal=True, q_start=300,
                                         kv_len=301, prefix_len=64),
                   "splitkv", 1),
    "decode_mha": (2, 1, 300, 32, 32, dict(causal=True, q_start=257,
                                           kv_len=258), "splitkv", 1),
    "chunk_mqa": (1, 6, 300, 8, 1, dict(causal=True, q_start=250, kv_len=256,
                                        prefix_len=40), "splitkv", 4),
    "chunk_gqa": (2, 9, 140, 10, 2, dict(causal=True, q_start=120,
                                         kv_len=129), "splitkv", 4),
}


@pytest.mark.parametrize("case", list(B7_WIDE_CASES))
@pytest.mark.parametrize("dtypes", list(B7_DTYPES))
@pytest.mark.parametrize("dh", [80, 256])
def test_flash_kernel_at_head_dims_80_and_256(cuda, case, dtypes, dh, rng):
    """dh 80 (five 32-byte swizzle atoms on the wgmma route, an uneven
    split of the output columns over split-KV's warps) and dh 256 (64-row
    kv tiles on a 2-stage wgmma ring, a 2-stage split-KV ring, two output
    columns a combine thread): one launch of the route flash_route names,
    within the reference's bound of the plain version and following the
    Pallas recurrence at the route's tile width and splits: float32
    within 1e-5; where the probabilities are rounded to a bfloat16 v, the
    one-bf16-step rule (another float32 summation order can flip a
    rounding)."""
    b, s, t, h, kvh, kw, name, rt = B7_WIDE_CASES[case]
    dtype, kv_dtype = B7_DTYPES[dtypes]
    q, k, v = _qkv(rng, b, s, t, h, kvh, dh, dtype, kv_dtype, cuda)
    route = tfa.flash_route(q.shape, k.shape, q.dtype, **kw)
    if dtype == torch.float32:
        assert route == ("fma", 64, None)
    else:
        assert route.name == name
        assert route.block_k == (64 if name == "splitkv" or dh == 256
                                 else 128)
        if rt is not None:
            assert s * h // kvh <= 16 * rt
    tcs.reset_launch_counts()
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    want = tfa.flash_attention_reference(q, k, v, **kw)
    atol = B7_F32_ATOL if dtypes == "f32" else B7_BF16_ATOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    rec = _recurrence(q, k, v, **kw)
    if dtypes == "f32":
        torch.testing.assert_close(got, rec, atol=1e-5, rtol=1e-5)
    else:
        _assert_follows_recurrence(got, rec, v)


@pytest.mark.parametrize("dh", [80, 256])
@pytest.mark.parametrize("s", [1, 70])
def test_flash_kernel_wide_dims_read_a_strided_cache_view(cuda, dh, s, rng):
    """At dh 80 and 256 both bf16 routes read a layer's strided view of a
    stacked cache (tensor maps on the prefill route, cp.async rows on
    split-KV); rows at or past kv_len hold NaN and are never read."""
    kv_len, s_max = 90, 160
    q = torch.from_numpy(rng.standard_normal((2, s, 8, dh)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    cache = torch.from_numpy(rng.standard_normal(
        (2, 3, s_max, 2, 1, dh)).astype(np.float32)).to(cuda, torch.bfloat16)
    cache[:, :, kv_len:] = float("nan")
    k, v = cache[0, 1].transpose(0, 1), cache[1, 1].transpose(0, 1)
    kw = dict(causal=True, q_start=kv_len - s, kv_len=kv_len)
    assert tfa.flash_route(q.shape, k.shape, q.dtype, **kw).name == \
        ("splitkv" if s == 1 else "wgmma")
    got = tfa.flash_attention(q, k, v, **kw)
    kc, vc = k[:, :kv_len].contiguous(), v[:, :kv_len].contiguous()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(
        got.float(), tfa.flash_attention_reference(q, kc, vc, **kw).float(),
        atol=B7_BF16_ATOL, rtol=0)
    _assert_follows_recurrence(got, _recurrence(q, kc, vc, **kw),
                               v[:, :kv_len])


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


#: (B, S, T, H, KV, dtypes, prefix_len, dh) of B7 calls whose start a
#: decode cache holds on the device: qwen2.5-14b's, zamba2-2.7b's and
#: paligemma-3b's decode (split-KV), chatglm3-6b's (16 folded rows a kv
#: head), qwen1.5-32b's (MHA) and mistral-large-123b's (12 folded rows)
#: over the dense serve phase's 717-row caches, a prefill into an empty
#: cache (``wgmma``), and a float32 query over a bf16 cache (FMA)
B7_DEVICE_START_CASES = {
    "qwen_decode": (1, 1, 300, 40, 8, "bf16", 0, 128),
    "zamba2_decode": (1, 1, 300, 32, 32, "bf16", 0, 80),
    "paligemma_decode": (1, 1, 400, 8, 1, "bf16", 64, 256),
    "batch_decode": (2, 1, 2100, 40, 8, "bf16", 0, 128),
    "zamba2_serve": (1, 1, 2081, 32, 32, "bf16", 0, 80),
    "deepseek_serve": (1, 1, 2081, 16, 16, "bf16", 0, 128),
    "chatglm_serve": (1, 1, 717, 32, 2, "bf16", 0, 128),
    "qwen15_serve": (1, 1, 717, 40, 40, "bf16", 0, 128),
    "mistral_serve": (1, 1, 717, 96, 8, "bf16", 0, 128),
    "prefill": (1, 150, 300, 10, 2, "bf16", 0, 128),
    "f32_decode": (2, 1, 200, 10, 2, "f32_bf16_cache", 0, 64),
}


def _device_start_lengths(s, t, bk):
    """kv_len values (the rows after the call): the edges, 1 (or S), one
    tile less one, one tile, one tile plus one, a split boundary and the
    capacity; and every other whole tile count up to the capacity (which
    holds every split count the grid must cover: the kernel's cut is not
    monotone in the tiles)."""
    edges = {max(s, n) for n in (1, bk - 1, bk, bk + 1, 2 * bk, 3 * bk, t)
             if max(s, n) <= t}
    return sorted(edges), sorted({n for n in range(4 * bk, t, bk)
                                  if n >= s} - edges)


@pytest.mark.parametrize("case", list(B7_DEVICE_START_CASES))
def test_flash_kernel_reads_its_start_on_the_device(cuda, case, rng):
    """B7 with ``start`` a device int32 (kv_len = start + S, q_start =
    start) gives the host-int call's output bit for bit at every length,
    eagerly and from one CUDA graph captured once and replayed with the
    start rewritten, over stale finite rows past kv_len; and it follows
    the Pallas recurrence at the live length's tiles and splits: each
    call at the edge lengths, and the whole-tile lengths' outputs
    together for the share beyond one bf16 step (a rate: a decode row of
    zamba2's has 2,560 outputs, three flipped roundings 0.12 %)."""
    b, s, t, h, kvh, dtypes, prefix, dh = B7_DEVICE_START_CASES[case]
    dtype, kv_dtype = B7_DTYPES[dtypes]
    q, k, v = _qkv(rng, b, s, t, h, kvh, dh, dtype, kv_dtype, cuda)
    start = torch.zeros((), dtype=torch.int32, device=cuda)
    kw = dict(causal=True, prefix_len=prefix)
    bk = tfa.flash_route(q.shape, k.shape, dtype, kv_len=s,
                         **kw).block_k
    static_q = q.clone()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfa.flash_attention(static_q, k, v, kv_len=s, start=start, **kw)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = tfa.flash_attention(static_q, k, v, kv_len=s, start=start,
                                  **kw)
    edges, tiles = _device_start_lengths(s, t, bk)
    pooled = [0, 0]
    for n in sorted(edges + tiles):
        host = dict(kw, kv_len=n, q_start=n - s)
        start.fill_(n - s)
        want = tfa.flash_attention(q, k, v, **host)
        eager = tfa.flash_attention(q, k, v, kv_len=s, start=start, **kw)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(eager, want), (case, n)
        assert torch.equal(out, want), (case, n)
        want = _recurrence(q, k, v, **host)
        if dtype != torch.bfloat16:
            torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
        elif n in edges:
            _assert_follows_recurrence(out, want, v)
        else:
            off = (out.float() - want.float()).abs()
            assert float(off.max()) <= 2 ** -8 * float(v.float().abs().max())
            pooled[0] += int((off > 1e-6 + 2 ** -7 * want.float().abs()).sum())
            pooled[1] += off.numel()
    assert pooled[0] <= 1e-3 * pooled[1], pooled


@pytest.mark.parametrize("kv_len", [1, 17, 63, 64])
def test_flash_splitkv_takes_causal_prefill_rows_at_mha(cuda, kv_len, rng):
    """An MHA prefill of up to ``FLASH_SPLITKV_ROWS`` tokens (qwen1.5-32b's
    40 heads over 40 kv heads, dh 128) takes the split-KV route with
    causal rows, over a cache view longer than the prompt: the plain
    version within the bf16 bound, and the Pallas recurrence at the
    route's tiles and splits."""
    q, k, v = _qkv(rng, 1, kv_len, 717, 40, 40, 128, torch.bfloat16,
                   torch.bfloat16, cuda)
    kw = dict(causal=True, kv_len=kv_len)
    route = tfa.flash_route(q.shape, k.shape, q.dtype, **kw)
    assert route.name == "splitkv"
    got = tfa.flash_attention(q, k, v, **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(
        got.float(), tfa.flash_attention_reference(q, k, v, **kw).float(),
        atol=B7_BF16_ATOL, rtol=0)
    _assert_follows_recurrence(got, _recurrence(q, k, v, **kw),
                               v[:, :kv_len])


def test_flash_kernel_device_start_contract(cuda, rng):
    """A device start is a 0-dim int32 on q's device, with kv_len given;
    it serves inference only (no autograd, no fake tensors)."""
    q, k, v = _qkv(rng, 1, 1, 64, 4, 2, 64, torch.bfloat16, torch.bfloat16,
                   cuda)
    start = torch.zeros((), dtype=torch.int32, device=cuda)
    for bad in (start.long(), start.cpu(), start[None]):
        with pytest.raises(ValueError, match="start"):
            tfa.flash_attention(q, k, v, kv_len=1, start=bad)
    with pytest.raises(ValueError, match="start"):
        tfa.flash_attention(q, k, v, start=start)
    with pytest.raises(ValueError, match="inference"):
        tfa.flash_attention(q.float().requires_grad_(), k, v, kv_len=1,
                            start=start)


GRAPHED_FAMILIES = ["qwen2.5-14b", "deepseek-moe-16b", "whisper-medium",
                    "xlstm-125m", "zamba2-2.7b", "paligemma-3b"]


def _eager_stream(cfg, params, prompt, max_new, max_len, device):
    """One request through the step functions, eagerly, from a fresh
    cache: (tokens, each step's last-position logits)."""
    from repro_torch.models import model as tm
    from repro_torch.models import steps
    batch = {"tokens": torch.as_tensor(np.asarray(prompt, np.int64),
                                       device=device)[None]}
    if cfg.family == "vlm":
        batch["vision"] = torch.zeros((1, cfg.n_vision_tokens, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((1, cfg.encoder_seq, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)
    cache = tm.init_decode_cache(cfg, 1, max_len, device=device)
    logits, cache = steps.make_prefill_step(cfg)(params, batch, cache)
    seen = [logits[:, -1].clone()]
    out = [int(torch.argmax(logits[0, -1]))]
    decode = steps.make_decode_step(cfg)
    while len(out) < max_new:
        tok = torch.tensor([[out[-1]]], device=device)
        logits, cache = decode(params, tok, cache)
        seen.append(logits[:, -1].clone())
        out.append(int(torch.argmax(logits[0, -1])))
    return out, seen


@pytest.mark.parametrize("arch", GRAPHED_FAMILIES)
def test_graphed_server_equals_the_eager_steps(cuda, arch):
    """On the card the Server prefills through one captured CUDA graph a
    prompt length and decodes through one a slot: six requests of four
    prompt lengths well below ``max_len`` (live kv tiles 1 to 3 of the
    4 its 200 rows hold) over two slots give the eager steps' greedy
    tokens, and the first request's prefill logits and first four decode
    steps' logits are bit-identical to the eager calls' (each smoke
    config, random weights from seed 0)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as tserve
    from repro_torch.models import model as tm
    cfg = get_smoke_config(arch)
    params = tm.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(2)
    max_new, max_len = 6, 200
    reqs = [tserve.Request(rid=r, prompt=rng.integers(1, cfg.vocab,
                                                      (12, 7, 70, 130)[r % 4]),
                           max_new=max_new) for r in range(6)]
    srv = tserve.Server(cfg, params, batch=2, max_len=max_len, device=cuda)
    seen = {}
    prefill, decode = srv._prefill_slot, srv._decode_slot

    def prefill_slot(i, req):
        lg = prefill(i, req)
        seen.setdefault(req.rid, []).append(lg[:, -1].clone())
        return lg

    def decode_slot(i, token):
        lg = decode(i, token)
        seen[srv.slots[i].rid].append(lg[:, -1].clone())
        return lg
    srv._prefill_slot, srv._decode_slot = prefill_slot, decode_slot
    for r in reqs:
        srv.submit(r)
    assert srv.run()["completed"] == 6
    g = srv.graph_stats()
    assert g["prefill_graphs"] == 4 and g["decode_graphs"] == 2
    assert [n for n, _ in g["prefill_capture_s"]] == [12, 7, 70, 130]
    assert srv.pool_bytes() > 0
    for r in reqs:
        want, logits = _eager_stream(cfg, params, r.prompt, max_new, max_len,
                                     cuda)
        assert r.out == want, r.rid
        if r.rid == 0:
            for i in range(5):
                assert torch.equal(seen[0][i], logits[i]), i


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
        return ([r.out for r in reqs], srv.graph_stats(),
                tcs.LAUNCHES["flash_attention"])

    got, graphs, launches = serve(params, cuda)
    want, _, _ = serve(cpu_params, "cpu")
    assert got == want
    # on the card each layer's B7 is called at each graph's warm-up and
    # capture (one prefill graph, a decode graph a slot), not at replay
    assert graphs["prefill_graphs"] == 1 and graphs["decode_graphs"] == 2
    assert launches == 2 * cfg.n_layers * 3


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


def _select_case(rng, m, n, data, largest=False):
    """An (m, n) float32 matrix for the selection: ``"random"`` (normal
    values), ``"equal"`` (every entry the same), ``"specials"`` (few
    values, so ties straddle every rank: +-inf, +-0.0, negatives),
    ``"hamming"`` (binomial integers, as packed distances crowd),
    ``"sorted"`` (each row ordered best first, so every winner lies in
    the row's first stretch) or ``"clustered"`` (40 % of each row tied at
    the best value: more keys at or below the sampled bound than a row's
    candidate list holds, so the list overflows)."""
    if data == "random":
        a = rng.standard_normal((m, n)).astype(np.float32)
    elif data == "equal":
        a = np.full((m, n), 3.5, np.float32)
    elif data == "specials":
        pool = np.array([np.inf, -np.inf, 0.0, -0.0, -1.5, 2.0, 7.25, -3e38],
                        np.float32)
        a = pool[rng.integers(0, pool.size, (m, n))]
    elif data == "sorted":
        a = np.sort(rng.standard_normal((m, n)).astype(np.float32), axis=1)
        if largest:
            a = a[:, ::-1].copy()
    elif data == "clustered":
        a = rng.standard_normal((m, n)).astype(np.float32)
        a[rng.random((m, n)) < 0.4] = 10.0 if largest else -10.0
    else:
        a = rng.binomial(1024, 0.5, (m, n)).astype(np.float32)
    return torch.from_numpy(a)


def _assert_same_bits(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("largest", [False, True])
@pytest.mark.parametrize("data", ["random", "equal", "specials", "sorted",
                                  "clustered"])
@pytest.mark.parametrize("k", ["385", "8193", "n_valid"])
@pytest.mark.parametrize("m", [1, 13, 624])
def test_topk_select_matches_plain(cuda, m, k, data, largest, rng):
    """K1s against its plain version, bit for bit: one row, a served
    micro-batch and the KNN queries (a row shared out over many blocks at
    the first two), k past the window (the sampled candidate lists; the
    radix select over the row where they overflow, ``"clustered"``, or
    hold ties everywhere, ``"equal"``), past the shared-memory sort and at
    ``n_valid``; an odd row width takes the unaligned loads."""
    n = 20003 if data == "equal" else 20000
    n_valid = n - 37
    kk = n_valid if k == "n_valid" else int(k)
    dist = _select_case(rng, m, n, data, largest)
    kw = dict(k=kk, largest=largest, n_valid=n_valid)
    dist = dist.to(cuda)
    before = tcs.LAUNCHES["topk_select"]
    got = tcs.topk_select(dist, **kw)
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["topk_select"] == before + 1
    _assert_same_bits(got, tcs.topk_select_reference(dist, **kw))


@pytest.mark.parametrize("data,k,largest", [("hamming", 400, False),
                                            ("random", 500, False),
                                            ("hamming", 385, True),
                                            ("sorted", 500, False),
                                            ("clustered", 400, True)])
@pytest.mark.parametrize("m", [13, 624])
def test_topk_select_at_the_knn_width(cuda, m, data, k, largest, rng):
    """K1s at the KNN gallery's 180,000 columns: binomial integers crowd
    a few bins, normal values spread, sorted rows put every winner in
    the first stretch, clustered rows overflow the candidate lists; the
    grid fills two blocks an SM at 13 rows and at 624."""
    n = 180_000
    dist = _select_case(rng, m, n, data, largest)
    kw = dict(k=k, largest=largest, n_valid=n - 5)
    dist = dist.to(cuda)
    got = tcs.topk_select(dist, **kw)
    _assert_same_bits(got, tcs.topk_select_reference(dist, **kw))
    assert tcs.select_grid(m, k, n - 5, _sms(cuda)) == 2 * _sms(cuda)


@pytest.mark.parametrize("m", [13, 624])
def test_k1_repeated_calls_are_bit_identical(cuda, m, rng):
    """Four calls of K1p (packed lanes at the KNN shape, binary and
    ternary) and of K1s (on K1p's matrix, k = 400) give the same bits:
    the candidate lists fill in arrival order, the results do not."""
    n, lanes = 180_096, 32
    q, p, c = (_lanes(rng, rows, lanes).to(cuda) for rows in (m, n, n))
    for care in (None, c):
        mats = [tcs.packed_distance(q, p, care) for _ in range(4)]
        assert all(torch.equal(mats[0], x) for x in mats[1:])
        sel = [tcs.topk_select(mats[0], k=400, largest=False, n_valid=n - 96)
               for _ in range(4)]
        for v, i in sel[1:]:
            _assert_same_bits((v, i), sel[0])
    _assert_same_bits(sel[0], tcs.topk_select_reference(
        mats[0], k=400, largest=False, n_valid=n - 96))


def test_topk_select_refusals(cuda):
    d = torch.zeros((4, 300), device=cuda)
    with pytest.raises(ValueError, match="k=301"):
        tcs.topk_select(d, k=301, largest=False, n_valid=300)
    with pytest.raises(ValueError, match="contiguous"):
        tcs.topk_select(d.T, k=3, largest=False, n_valid=4)
    v, i = tcs.topk_select(d[:0], k=3, largest=False, n_valid=300)
    assert v.shape == (0, 3) and i.dtype == torch.int32


@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("lanes", [8, 32, 40, 256])
@pytest.mark.parametrize("m", [1, 13, 64, 65, 129, 624])
def test_packed_distance_matches_plain(cuda, m, lanes, ternary, rng):
    """K1p against its plain version run on the card (binary and
    ternary), bit for bit, on lanes with bit 31 set, every pattern row
    included, on each route ``packed_distance_route`` picks: swapped up to
    64 queries whose lanes fit, 128-query tiles resident up to 32 lanes
    and streamed past them; 8,320 rows end in half a 256-row tile and,
    at 624 queries, blocks' runs of tiles cross query tiles.  The first
    64 rows also against ``ref.packed_distances`` on the CPU."""
    from repro_torch.kernels import ref as tref
    n = 8320
    q, p = _lanes(rng, m, lanes), _lanes(rng, n, lanes)
    c = _lanes(rng, n, lanes) if ternary else None
    qc, pc = q.to(cuda), p.to(cuda)
    cc = None if c is None else c.to(cuda)
    before = tcs.LAUNCHES["packed_distance"]
    got = tcs.packed_distance(qc, pc, cc)
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["packed_distance"] == before + 1
    assert torch.equal(got, tcs.packed_distance_reference(qc, pc, cc))
    rows = slice(0, 64)
    assert torch.equal(got[:, rows].cpu(), tref.packed_distances(
        q, p[rows], None if c is None else c[rows]))


@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("m", [13, 624])
def test_packed_distance_at_the_knn_shape(cuda, m, ternary, rng):
    """K1p at the KNN gallery (180,096 rows x 32 lanes): the swapped route
    at a 13-row micro-batch (two blocks an SM) and the resident route at
    624 queries, each a persistent run of many tiles a block, bit for bit
    against the plain version on the card."""
    n, lanes = 180_096, 32
    q, p = (_lanes(rng, rows, lanes).to(cuda) for rows in (m, n))
    c = _lanes(rng, n, lanes).to(cuda) if ternary else None
    route = tcs.packed_distance_route(m, n, lanes, _sms(cuda), ternary)
    assert route.name == ("swapped" if m == 13 else "resident")
    assert route.grid == (2 if m == 13 else 1) * _sms(cuda)
    got = tcs.packed_distance(q, p, c)
    assert torch.equal(got, tcs.packed_distance_reference(q, p, c))


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


# ---------------------------------------------------------------------------
# the MoE router on B2, B7 at whisper's non-causal shapes, an MoE block
# ---------------------------------------------------------------------------

#: (D, E, k) of the two MoE configs' routers (deepseek-moe-16b,
#: phi3.5-moe-42b-a6.6b)
ROUTERS = {"deepseek": (2048, 64, 6), "phi3.5": (4096, 16, 2)}
#: B2's dot values against the float32 plain version, as a share of
#: sum |q_i p_i|: 3xTF32 truncates the accumulator toward zero at each of
#: its 3 D / 8 k-steps, which drifts an all-positive sum of 4,096 products
#: by up to 1.5e-5 of the sum (measured on the H100); two scores within
#: it are a float64 near-tie
DOT_RTOL = 1e-4


def _bf16_values(rng, shape, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).bfloat16().float()


@pytest.mark.parametrize("router", list(ROUTERS))
@pytest.mark.parametrize("t", [1, 13, 2048])
def test_b2_at_the_router_shape_matches_plain(cuda, router, t, rng):
    """``ops.cam_topk`` (dot, ``largest=True``) as the ``"cam"`` router
    calls it: tokens against the router's E columns (a gallery of one
    padded 128-row window), bf16-valued as the model's are.  Columns 1
    and 3 are equal and best for token 0; the last repeats column 0.
    Values within ``DOT_RTOL`` of the plain version's, token 0's equal to
    the kernel's own arithmetic (``tf32x3_kernel_dot``) bit for bit;
    indices equal the plain version's but at float64 near-ties whose
    order that arithmetic gives; ties go to the lower column."""
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels import ref as tref
    d, e, k = ROUTERS[router]
    x = _bf16_values(rng, (t, d))
    w = _bf16_values(rng, (d, e), 1 / np.sqrt(d))
    w[:, 1] = w[:, 3] = (2.0 * x[0] / x[0].norm()).bfloat16().float()
    w[:, e - 1] = w[:, 0]
    q, pats = x.to(cuda), w.T.to(cuda)
    tcs.reset_launch_counts()
    v, i = tops.cam_topk(q, pats, metric="dot", k=k, largest=True)
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["fused_topk"] == 1
    assert tuple(i.shape) == (t, k)
    want_v, want_i = tref.cam_topk(q, pats.contiguous(), metric="dot", k=k,
                                   largest=True)
    assert i[0, :2].tolist() == [1, 3]
    scale = (q.double().abs() @ pats.double().abs().T)
    torch.testing.assert_close(
        v.double(), want_v.double(), rtol=0,
        atol=float(DOT_RTOL * scale.max()))
    assert torch.equal(tcs.tf32x3_kernel_dot(q[[0] * k], pats[i[0].long()]),
                       v[0])
    rows, cols = (i != want_i.to(i.dtype)).nonzero(as_tuple=True)
    for r, c in zip(rows.tolist(), cols.tolist()):
        a, b = int(i[r, c]), int(want_i[r, c])
        exact = q[r].double() @ pats[[a, b]].double().T
        assert abs(float(exact[0] - exact[1])) <= \
            DOT_RTOL * float(scale[r, [a, b]].max())
        da, db = tcs.tf32x3_kernel_dot(q[[r, r]], pats[[a, b]]).tolist()
        assert da > db or (da == db and a < b)


@pytest.mark.parametrize("s,t", [(1, 1500), (4, 1500), (1500, 1500)])
@pytest.mark.parametrize("dtypes", list(B7_DTYPES))
def test_flash_kernel_noncausal_at_whisper_shapes(cuda, s, t, dtypes, rng):
    """B7 with ``causal=False`` over 1,500 encoder rows at whisper's 16
    heads and head dim 64: cross-attention at decode (S = 1, split-KV in
    bf16) and at a 4-token prefill, and the encoder's self-attention
    (S = 1,500, the ``wgmma`` route in bf16); against the plain version
    and the Pallas recurrence."""
    dtype, kv_dtype = B7_DTYPES[dtypes]
    q, k, v = _qkv(rng, 1, s, t, 16, 16, 64, dtype, kv_dtype, cuda)
    tcs.reset_launch_counts()
    got = tfa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["flash_attention"] == 1
    want = tfa.flash_attention_reference(q, k, v, causal=False)
    atol = B7_F32_ATOL if dtypes == "f32" else B7_BF16_ATOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    rec = _recurrence(q, k, v, causal=False)
    if dtype == torch.float32:
        torch.testing.assert_close(got, rec, atol=1e-5, rtol=1e-5)
    else:
        _assert_follows_recurrence(got, rec, v)


@pytest.mark.parametrize("offload", ["cam", "dense"])
def test_moe_block_on_the_card_matches_cpu(cuda, offload):
    """One MoE block (deepseek's smoke config in float32: top-2 of 8
    experts, one shared) on the card against the same block on the CPU,
    a 12-row prefill into a cache and one decode row: B7 once per call,
    B2 once per call with ``"cam"`` and never with ``"dense"``; within
    1e-4 (TF32 off; B7 and B2 sum in other orders)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import blocks as tb
    from repro_torch.models import layers as tl
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              param_dtype="float32", compute_dtype="float32",
                              router_offload=offload)
    gen = torch.Generator()
    gen.manual_seed(3)
    cpu_p = tb.init_moe_block(gen, cfg)
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.standard_normal((2, n, cfg.d_model))
                           .astype(np.float32)) for n in (12, 1)]

    def run(dev):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in cpu_p.items()}
        cache = tl.init_cache(cfg, 2, 16, dev, dtype=torch.float32)
        outs, launches = [], []
        for x, start in zip(xs, (0, 12)):
            pos = torch.arange(start, start + x.shape[1]).expand(
                2, x.shape[1]).to(dev)
            tcs.reset_launch_counts()
            y, cache = tb.apply_moe_block(p, x.to(dev), cfg, positions=pos,
                                          cache=cache)
            launches.append((tcs.LAUNCHES["flash_attention"],
                             tcs.LAUNCHES["fused_topk"]))
            outs.append(y.cpu())
        return outs, launches

    got, launches = run(cuda)
    assert launches == [(1, int(offload == "cam"))] * 2
    want, cpu_launches = run(torch.device("cpu"))
    assert cpu_launches == [(0, 0)] * 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the hybrid (zamba2: Mamba2 + a shared attention block at dh 80) and vlm
# (paligemma: a prefix-LM at dh 256) families on the card
# ---------------------------------------------------------------------------

#: narrow models at the full models' head dims, depth 2
WIDE_LMS = {
    "zamba2-dh80": ("zamba2-2.7b", dict(n_layers=2, shared_attn_every=1,
                                        d_model=160, n_heads=2, n_kv_heads=2,
                                        d_head=80)),
    "paligemma-dh256": ("paligemma-3b", dict(n_layers=2, d_model=128,
                                             n_heads=2, n_kv_heads=1,
                                             d_head=256)),
}


def _wide_lm(name, dtype):
    from repro_torch.configs import get_smoke_config
    arch, kw = WIDE_LMS[name]
    return dataclasses.replace(get_smoke_config(arch), param_dtype=dtype,
                               compute_dtype=dtype, **kw)


def test_mamba2_block_on_the_card_matches_cpu(cuda):
    """One Mamba2 block (float32, d_inner 320: 5 heads of 64) on the card
    against the same block on the CPU: a 21-row prefill over 3 chunks of
    8 from a zero state (the conv state bfloat16, as the cache holds it),
    then two decode rows; outputs and states within 1e-4 (full-precision
    float32 einsums and M1's float32 FMAs on the card; sums in other
    orders).  M1 runs once, for the prefill (the decode rows take the O(1)
    recurrence)."""
    from repro_torch.models import blocks as tb
    from repro_torch.models import mamba2 as tmb
    from repro_torch.models import model as tm
    cfg = _wide_lm("zamba2-dh80", "float32")
    gen = torch.Generator()
    gen.manual_seed(4)
    cpu_p = tb.init_mamba_block(gen, cfg)
    cpu_p["mamba"]["A_log"].uniform_(-1.0, 1.0, generator=gen)
    cpu_p["mamba"]["dt_bias"].uniform_(-1.0, 1.0, generator=gen)
    rng = np.random.default_rng(6)
    xs = [torch.from_numpy(rng.standard_normal((2, n, cfg.d_model))
                           .astype(np.float32)) for n in (21, 1, 1)]

    def run(dev):
        p = tm._tree_map(lambda t: t.to(dev), cpu_p)
        st = tmb.init_mamba_state(cfg, 2, device=dev)
        outs = []
        for x in xs:
            if x.shape[1] > 1:
                y, st = tmb.mamba2_forward(p["mamba"], x.to(dev), cfg,
                                           chunk=8, state=st)
            else:
                y, st = tb.apply_mamba_block(p, x.to(dev), cfg, state=st)
            outs.append(y.cpu())
        return outs, {k: t.cpu() for k, t in st.items()}

    tcs.reset_launch_counts()
    got, got_st = run(cuda)
    assert {k: n for k, n in tcs.LAUNCHES.items() if n} == {"ssd_scan": 1}
    want, want_st = run(torch.device("cpu"))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    for k in want_st:
        torch.testing.assert_close(got_st[k], want_st[k], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("name", list(WIDE_LMS))
def test_hybrid_and_vlm_models_on_the_card_match_cpu(cuda, name):
    """zamba2 (dh 80) and paligemma (dh 256, MQA, 8 vision rows) at depth
    2 on the card against the same model on the CPU.  Float32: forward,
    and prefill + decode on a float32 cache (B7's FMA route), within
    1e-4.  Bfloat16: a 72-token prefill and four decode steps on the
    default cache (the wgmma route at prefill: more than 64 query rows a
    kv head; split-KV at decode), finite and within the CPU
    tests' bf16 logit bound, 0.1.  B7 launches once per attention layer
    and call: one shared block per group, one per vlm layer."""
    from repro_torch.models import model as tm
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 76)))
    vision = torch.from_numpy(rng.standard_normal(
        (2, 8, WIDE_LMS[name][1]["d_model"])).astype(np.float32))
    results = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _wide_lm(name, dtype)
        attn_layers = tm._groups(cfg)[0] if cfg.family == "hybrid" \
            else cfg.n_layers
        cpu_params = tm.init_params(cfg, seed=1, device="cpu")
        for where, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
            params = tm._tree_map(lambda t: t.to(dev), cpu_params)
            batch = {"tokens": toks.to(dev)}
            if cfg.family == "vlm":
                batch["vision"] = vision.to(dev)
            out, launches = {}, []
            tcs.reset_launch_counts()
            if dtype == "float32":
                out["forward"] = tm.forward(params, cfg, batch).cpu()
                launches.append(tcs.LAUNCHES["flash_attention"])
            cache = tm.init_decode_cache(cfg, 2, 80, device=dev)
            if dtype == "float32":
                cache = tm._tree_map(
                    lambda t: t.float() if isinstance(t, torch.Tensor)
                    and t.is_floating_point() else t, cache)
            pre = dict(batch, tokens=batch["tokens"][:, :72])
            lg, cache = tm.prefill(params, cfg, pre, cache)
            outs = [lg]
            for i in range(72, 76):
                lg, cache = tm.decode_step(params, cfg,
                                           batch["tokens"][:, i:i + 1], cache)
                outs.append(lg)
            launches.append(tcs.LAUNCHES["flash_attention"])
            out["serve"] = torch.cat(outs, dim=1).cpu()
            results[(dtype, where)] = (out, launches)
        got, launches = results[(dtype, "card")]
        want, cpu_launches = results[(dtype, "cpu")]
        # forward, then (cumulative) one prefill and four decode steps
        assert launches == ([attn_layers, 6 * attn_layers]
                            if dtype == "float32" else [5 * attn_layers])
        assert all(n == 0 for n in cpu_launches)
        for key, w in want.items():
            assert bool(torch.isfinite(got[key]).all())
            if dtype == "float32":
                torch.testing.assert_close(got[key], w, atol=1e-4,
                                           rtol=1e-4)
            else:
                torch.testing.assert_close(got[key], w, atol=0.1, rtol=0)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-moe-16b"])
def test_size_one_mesh_sharded_train_step_equals_unsharded(cuda, arch,
                                                           tmp_path):
    """``make_train_step(rules=)`` over a (data 1, model 1) ``DeviceMesh``
    of one NCCL rank (the DTensor path: state, batch and gradients as
    DTensors, attention on B7 / B7b under ``local_map``, the MoE router
    on B2) against the unsharded step from the same seed, at a small
    width in float32: loss within 1e-5, each gradient leaf within 1e-4
    of its norm, the same kernel launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.loader import _shard_rows
    from repro_torch.launch.train import distribute_state
    from repro_torch.models import steps as ts
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.tree import leaves_with_paths
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32",
                              router_offload="cam")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 64))).to(cuda)}
    grads = []

    class Tap:
        def init(self, params):
            return ()

        def __call__(self, g, st):
            grads.append({p: (x.full_tensor() if hasattr(x, "full_tensor")
                              else x).detach().clone()
                          for p, x in leaves_with_paths(g)})
            return g, st

    def run(rules, b):
        state = ts.init_train_state(cfg, seed=0, device=cuda)
        if rules is not None:
            state = distribute_state(state, rules, cfg)
        tcs.reset_launch_counts()
        _, m = ts.make_train_step(cfg, constant(1e-3), AdamWConfig(),
                                  rules=rules, compressor=Tap())(state, b)
        torch.cuda.synchronize()
        loss = m["loss"]
        return float(loss.full_tensor() if hasattr(loss, "full_tensor")
                     else loss), dict(tcs.LAUNCHES)

    loss, counts = run(None, batch)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        rules = ShardingRules(init_device_mesh(
            "cuda", (1, 1), mesh_dim_names=("data", "model")))
        d_loss, d_counts = run(rules, {k: _shard_rows(rules, v)
                                       for k, v in batch.items()})
    finally:
        dist.destroy_process_group()
    assert d_counts == counts and counts["flash_attention_bwd"] > 0
    assert abs(d_loss - loss) <= 1e-5
    for path, g in grads[0].items():
        err = float((grads[1][path] - g).abs().max())
        assert err <= 1e-4 * float(g.norm()) + 1e-6, (path, err)


# ---------------------------------------------------------------------------
# M1 (the Mamba2 chunked scan) and X1 (the sLSTM recurrence) against their
# plain versions
# ---------------------------------------------------------------------------

#: zamba2-2.7b's Mamba2 widths: heads, head dim, state dim, chunk
SSD_WIDTHS = dict(nh=80, dh=64, ds=64, chunk=256)


def _ssd_operands(rng, b, s, dtype, cuda, nh, dh, ds):
    """M1's operands as ``mamba2_forward`` hands them over: xh, B_ and C_
    views of one (b, s, nh dh + 2 ds) convolution output (unit last
    stride, row stride nh dh + 2 ds), dt = softplus(N(0, 1) - 1) float32,
    A = -exp(U(-1, 1)), D ~ U(0, 2), a nonzero entering state."""
    d_inner = nh * dh
    conv = torch.from_numpy(rng.standard_normal(
        (b, s, d_inner + 2 * ds)).astype(np.float32)).to(cuda, dtype)
    xh = conv[..., :d_inner].reshape(b, s, nh, dh)
    B_, C_ = conv[..., d_inner:d_inner + ds], conv[..., d_inner + ds:]
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, nh)).astype(np.float32) - 1.0)).to(cuda)
    A = -torch.exp(torch.from_numpy(rng.uniform(-1, 1, nh).astype(
        np.float32))).to(cuda)
    D = torch.from_numpy(rng.uniform(0, 2, nh).astype(np.float32)).to(cuda)
    h0 = torch.from_numpy(rng.standard_normal((b, nh, dh, ds)).astype(
        np.float32)).to(cuda)
    return xh, B_, C_, dt, A, D, h0


def _within(got, want, rtol, of_max):
    """Each |got - want| within rtol |want| + of_max max|want|."""
    got, want = got.float(), want.float()
    bound = rtol * want.abs() + of_max * float(want.abs().max())
    return float((got - want).abs().max()), bool(((got - want).abs()
                                                   <= bound).all())


@pytest.mark.parametrize("s", [256, 300, 2048, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(cuda, s, dtype, rng):
    """M1 at zamba2-2.7b's widths (80 heads of 64, state 64, chunk 256)
    from a nonzero state, over one chunk, a padded second chunk, 2,048 and
    32,768 rows, against ``ssd_scan_reference`` on the same operands.
    Float32 sums in other orders: y and the state within 1e-5 of the
    largest |value| (and 1e-4 relative).  bf16 outputs: each y within one
    bf16 step (2**-7 |y|) of the plain version's rounding, plus the same
    float32 bound; the state as in float32."""
    from repro_torch.kernels import ssd_scan as kss
    ops = _ssd_operands(rng, 1, s, dtype, cuda, SSD_WIDTHS["nh"],
                        SSD_WIDTHS["dh"], SSD_WIDTHS["ds"])
    tcs.reset_launch_counts()
    y, h = kss.ssd_scan(*ops, chunk=SSD_WIDTHS["chunk"])
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["ssd_scan"] == 1
    want_y, want_h = kss.ssd_scan_reference(*ops, chunk=SSD_WIDTHS["chunk"])
    assert y.dtype == dtype and y.shape == want_y.shape
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
    err_y, ok_y = _within(y, want_y, rtol, 1e-5)
    err_h, ok_h = _within(h, want_h, 1e-4, 1e-5)
    assert ok_y and ok_h, (err_y, err_h)


def test_ssd_scan_kernel_small_widths_and_batch(cuda, rng):
    """M1 at the smoke config's widths (2 heads of 64, state 16) and a
    chunk of 8 over 3 batch rows of 21 rows (a ragged last chunk), float32,
    within the float32 bound above."""
    from repro_torch.kernels import ssd_scan as kss
    ops = _ssd_operands(rng, 3, 21, torch.float32, cuda, 2, 64, 16)
    y, h = kss.ssd_scan(*ops, chunk=8)
    want_y, want_h = kss.ssd_scan_reference(*ops, chunk=8)
    for got, want in ((y, want_y), (h, want_h)):
        err, ok = _within(got, want, 1e-4, 1e-5)
        assert ok, err


def test_scan_routes_on_the_card(cuda, rng):
    """M1 and X1 launch only where autograd records nothing: operands that
    require grad take the plain versions (and differentiate), the same
    operands under ``torch.no_grad`` take the kernels; a head dim past 64
    raises rather than running the plain version."""
    from repro_torch.kernels import slstm_scan as ksl
    from repro_torch.kernels import ssd_scan as kss
    ops = list(_ssd_operands(rng, 1, 40, torch.float32, cuda, 2, 64, 16))
    ops[0] = ops[0].detach().requires_grad_()
    assert kss.ssd_route(*ops) == "plain"
    tcs.reset_launch_counts()
    y, _ = kss.ssd_scan(*ops, chunk=16)
    y.sum().backward()
    assert ops[0].grad is not None and tcs.LAUNCHES["ssd_scan"] == 0
    with torch.no_grad():
        assert kss.ssd_route(*ops) == "kernel"
        kss.ssd_scan(*ops, chunk=16)
    assert tcs.LAUNCHES["ssd_scan"] == 1
    wide = _ssd_operands(rng, 1, 8, torch.float32, cuda, 1, 80, 16)
    with pytest.raises(ValueError, match="dh and ds up to 64"):
        kss.ssd_scan(*wide, chunk=8)
    pre, wh, *state = _slstm_operands(rng, 1, 5, 64, cuda)
    wh.requires_grad_()
    hs, _ = ksl.slstm_scan(pre, wh, *state)
    hs.sum().backward()
    assert wh.grad is not None and tcs.LAUNCHES["slstm_scan"] == 0


def _slstm_operands(rng, b, s, d, cuda):
    """X1's operands: pre-activations N(0, 1), the recurrent weight
    N(0, 1 / D) (the model's ``dense_init``), a nonzero state: h in
    (-1, 1), n and |c| up to 3, m N(0, 1) with every third entry -1e30
    (a fresh state's)."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    pre = t(rng.standard_normal((b, s, 4 * d)))
    wh = t(rng.standard_normal((d, 4 * d)) / np.sqrt(d))
    h = t(rng.uniform(-1, 1, (b, d)))
    n = t(rng.uniform(1, 3, (b, d)))
    c = t(rng.uniform(-1, 1, (b, d))) * n
    m = rng.standard_normal((b, d))
    m.reshape(-1)[::3] = -1e30
    return pre, wh, h, c, n, t(m)


def _slstm_errors(got, want):
    """The largest difference of hs and each state part, ``n`` and ``c``
    relative to max(|n|, 1), ``m`` relative to max(|m|, 1) (m -1e30 must
    match exactly)."""
    (hs, st), (want_hs, want_st) = got, want
    n_scale = torch.clamp(want_st[2].abs(), min=1.0)
    m_scale = torch.clamp(want_st[3].abs(), min=1.0)
    return {"hs": float((hs - want_hs).abs().max()),
            "h": float((st[0] - want_st[0]).abs().max()),
            "c": float(((st[1] - want_st[1]).abs() / n_scale).max()),
            "n": float(((st[2] - want_st[2]).abs() / n_scale).max()),
            "m": float(((st[3] - want_st[3]).abs() / m_scale).max())}


#: X1 against its plain loop: |h| <= 1, so hs and h absolutely; c and n
#: relative to max(|n|, 1), m to max(|m|, 1) (float32 sums of 768
#: products in other orders, carried through the recurrence)
SLSTM_TOL = 1e-4


@pytest.mark.parametrize("b", [1, 4, 8])
@pytest.mark.parametrize("s", [2, 257, 2048])
def test_slstm_scan_kernel_matches_plain(cuda, b, s, rng):
    """X1 at xlstm-125m's width (D 768) from a nonzero state against the
    plain loop on the same operands, within ``SLSTM_TOL``; one launch."""
    from repro_torch.kernels import slstm_scan as ksl
    ops = _slstm_operands(rng, b, s, 768, cuda)
    tcs.reset_launch_counts()
    got = ksl.slstm_scan(*ops)
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["slstm_scan"] == 1
    want = ksl.slstm_scan_reference(*ops)
    errs = _slstm_errors(got, want)
    assert max(errs.values()) <= SLSTM_TOL, errs


def test_slstm_scan_error_growth(cuda, rng):
    """How X1's difference from the plain loop grows with S (256, 2,048,
    16,384 positions, batch 1, D 768): printed (run with ``-s``) and each
    within ``SLSTM_TOL``."""
    from repro_torch.kernels import slstm_scan as ksl
    pre, wh, *state = _slstm_operands(rng, 1, 16384, 768, cuda)
    rows = {}
    for s in (256, 2048, 16384):
        ops = (pre[:, :s].contiguous(), wh, *state)
        rows[s] = _slstm_errors(ksl.slstm_scan(*ops),
                                ksl.slstm_scan_reference(*ops))
    print(f"slstm_scan error growth: {rows}")
    assert all(max(e.values()) <= SLSTM_TOL for e in rows.values()), rows


def test_slstm_scan_in_a_cuda_graph(cuda, rng):
    """X1 captured in a CUDA graph (its cooperative launch and its
    counter's fill) and replayed over new operands copied into the
    captured ones: bit-identical to the uncaptured launch on the same
    operands."""
    from repro_torch.kernels import slstm_scan as ksl
    ops = _slstm_operands(rng, 2, 300, 768, cuda)
    static = [t.clone() for t in ops]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ksl.slstm_scan(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_hs, out_st = ksl.slstm_scan(*static)
    fresh = _slstm_operands(np.random.default_rng(9), 2, 300, 768, cuda)
    for dst, src in zip(static, fresh):
        dst.copy_(src)
    graph.replay()
    want_hs, want_st = ksl.slstm_scan(*fresh)
    torch.cuda.synchronize()
    assert torch.equal(out_hs, want_hs)
    assert all(torch.equal(a, b) for a, b in zip(out_st, want_st))


def test_slstm_scan_snapshot_is_the_carried_state(cuda, rng):
    """X1 with ``snapshot_at`` writes, during its own launch, the state
    entering that position: X1 from it over the rest of the sequence is
    bit-identical to the whole launch's hs and final state, which the
    snapshot leaves as they are without it."""
    from repro_torch.kernels import slstm_scan as ksl
    pre, wh, *state = _slstm_operands(rng, 2, 600, 768, cuda)
    hs, fin, mid = ksl.slstm_scan(pre, wh, *state, snapshot_at=400)
    plain_hs, plain_fin = ksl.slstm_scan(pre, wh, *state)
    assert torch.equal(hs, plain_hs)
    assert all(torch.equal(a, b) for a, b in zip(fin, plain_fin))
    tail_hs, tail_fin = ksl.slstm_scan(pre[:, 400:].contiguous(), wh, *mid)
    assert torch.equal(tail_hs, hs[:, 400:])
    assert all(torch.equal(a, b) for a, b in zip(tail_fin, fin))
    assert torch.equal(mid[0], hs[:, 399])


@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,dh,ds", [(80, 64, 64), (8, 32, 32)])
def test_ssd_scan_tensor_core_shapes(cuda, chunk, dtype, nh, dh, ds, rng):
    """M1's tensor-core design at S = 1,000 rows (a multiple of neither
    chunk: a ragged last chunk and row tile), chunk 64 and 256, bf16 and
    float32, at zamba2-2.7b's head widths and at dh = ds = 32 (tiles half
    zero-padded), from a carried state: one call over the 1,000 rows, and
    the same rows as two calls of 600 and 400, the second from the
    first's final state.  Each against ``ssd_scan_reference`` within the
    tolerances of ``test_ssd_scan_kernel_matches_plain``."""
    from repro_torch.kernels import ssd_scan as kss
    ops = _ssd_operands(rng, 1, 1000, dtype, cuda, nh, dh, ds)
    xh, B_, C_, dt, A, D, h0 = ops
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
    want_y, want_h = kss.ssd_scan_reference(*ops, chunk=chunk)
    tcs.reset_launch_counts()
    y, h = kss.ssd_scan(*ops, chunk=chunk)
    y1, h1 = kss.ssd_scan(xh[:, :600], B_[:, :600], C_[:, :600], dt[:, :600],
                          A, D, h0, chunk=chunk)
    y2, h2 = kss.ssd_scan(xh[:, 600:], B_[:, 600:], C_[:, 600:], dt[:, 600:],
                          A, D, h1, chunk=chunk)
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["ssd_scan"] == 3
    # the plain version over the same two calls (its chunks restart at 600)
    p1, q1 = kss.ssd_scan_reference(xh[:, :600], B_[:, :600], C_[:, :600],
                                    dt[:, :600], A, D, h0, chunk=chunk)
    p2, q2 = kss.ssd_scan_reference(xh[:, 600:], B_[:, 600:], C_[:, 600:],
                                    dt[:, 600:], A, D, q1, chunk=chunk)
    for got, want, rt in ((y, want_y, rtol), (h, want_h, 1e-4),
                          (torch.cat([y1, y2], 1), torch.cat([p1, p2], 1),
                           rtol), (h2, q2, 1e-4)):
        err, ok = _within(got, want, rt, 1e-5)
        assert ok, err


@pytest.mark.parametrize("b", [1, 3, 9, 64])
@pytest.mark.parametrize("d", [768, 1000])
@pytest.mark.parametrize("s", [1, 300])
def test_slstm_scan_batches_and_widths(cuda, b, d, s, rng):
    """X1's hand-off design at batch 1 (a pass of one row), 3, 9 and 64
    (passes of 8 rows, the last ragged), D 768 and D 1000 (not a multiple
    of 8: the last block's units past D idle; 32 rows of wh a lane), over
    1 and 300 positions, against the plain loop within ``SLSTM_TOL``."""
    from repro_torch.kernels import slstm_scan as ksl
    ops = _slstm_operands(rng, b, s, d, cuda)
    errs = _slstm_errors(ksl.slstm_scan(*ops), ksl.slstm_scan_reference(*ops))
    assert max(errs.values()) <= SLSTM_TOL, errs


@pytest.mark.parametrize("b,d", [(1, 1000), (3, 768)])
def test_slstm_scan_long_sequences(cuda, b, d, rng):
    """X1 over 16,384 positions at batch 1, D 1000 and batch 3, D 768
    against the plain loop within ``SLSTM_TOL``."""
    from repro_torch.kernels import slstm_scan as ksl
    ops = _slstm_operands(rng, b, 16384, d, cuda)
    errs = _slstm_errors(ksl.slstm_scan(*ops), ksl.slstm_scan_reference(*ops))
    assert max(errs.values()) <= SLSTM_TOL, errs


def test_slstm_scan_is_deterministic(cuda, rng):
    """Two launches of X1 on the same operands are bit-identical (the
    warp reduction adds in a fixed order; no atomics)."""
    from repro_torch.kernels import slstm_scan as ksl
    for b in (1, 9):
        ops = _slstm_operands(rng, b, 513, 768, cuda)
        (hs1, st1), (hs2, st2) = ksl.slstm_scan(*ops), ksl.slstm_scan(*ops)
        assert torch.equal(hs1, hs2)
        assert all(torch.equal(a, c) for a, c in zip(st1, st2))


def test_slstm_scan_new_inputs_back_to_back_and_replayed(cuda):
    """X1's hand-off words never let a tag of an earlier launch or replay
    through: three launches back to back on different operands, and three
    replays of one captured graph with different operands copied in, each
    bit-identical to a launch on those operands alone (after a
    synchronize) and within ``SLSTM_TOL`` of the plain loop."""
    from repro_torch.kernels import slstm_scan as ksl
    sets = [_slstm_operands(np.random.default_rng(20 + i), 2, 300, 768, cuda)
            for i in range(3)]
    alone = []
    for ops in sets:
        alone.append(ksl.slstm_scan(*ops))
        torch.cuda.synchronize()
    back = [ksl.slstm_scan(*ops) for ops in sets]     # no sync between
    torch.cuda.synchronize()
    for (hs, st), (w_hs, w_st), ops in zip(back, alone, sets):
        assert torch.equal(hs, w_hs)
        assert all(torch.equal(a, c) for a, c in zip(st, w_st))
        errs = _slstm_errors((hs, st), ksl.slstm_scan_reference(*ops))
        assert max(errs.values()) <= SLSTM_TOL, errs
    static = [t.clone() for t in sets[0]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ksl.slstm_scan(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_hs, out_st = ksl.slstm_scan(*static)
    for ops, (w_hs, w_st) in zip(sets[::-1], alone[::-1]):
        for dst, src in zip(static, ops):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out_hs, w_hs)
        assert all(torch.equal(a, c) for a, c in zip(out_st, w_st))
