"""CUDA kernels vs their plain versions, and the port's main path on the
card vs the same path on the CPU.  Every test here needs an NVIDIA GPU
(the ``gpu`` marker) and skips without one.  This file imports neither
JAX nor the reference package, so it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: integer metrics bit-identical; eucl values within
``rtol=1e-5, atol=1e-4`` (|d| < 300 at these widths) with index swaps
only between float64 near-ties.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import cim_dialect as cd
from repro_torch.kernels import acam as tacam
from repro_torch.kernels import cam_search as tcs

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


def test_launch_counts_and_refusals(cuda):
    q = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    p = torch.zeros((128, 8), dtype=torch.int32, device=cuda)
    tcs.reset_launch_counts()
    tcs.fused_topk_packed(q, p, k=3, largest=False, n_valid=100)
    tcs.fused_topk_packed(q, p, p, k=3, largest=False, n_valid=100)
    assert tcs.LAUNCHES == {"fused_topk": 0, "fused_topk_packed": 1,
                            "fused_topk_packed_ternary": 1,
                            "acam_match": 0, "range_match": 0,
                            "hdc_encode": 0, "distance": 0}
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


@pytest.mark.parametrize("m,f,h,levels", [(9, 37, 70, 8), (130, 784, 1000, 16),
                                          (64, 64, 128, 1), (200, 130, 257, 40)])
def test_hdc_encode_kernel_matches_plain(cuda, m, f, h, levels, rng):
    from repro_torch.kernels import hdc_encode as thdc
    from repro_torch.kernels import ref as tref
    q = torch.from_numpy(rng.integers(0, levels, (m, f)).astype(np.int32))
    keys, lv = _bipolar_t(rng, f, h), _bipolar_t(rng, levels, h)
    keys[3] = 0.0                     # the contract's zero cells
    lv[0, :5] = 0.0
    want = thdc.hdc_encode_reference(q, keys, lv)
    before = tcs.LAUNCHES["hdc_encode"]
    got = thdc.hdc_encode(q.to(cuda), keys.to(cuda), lv.to(cuda))
    torch.cuda.synchronize()
    assert tcs.LAUNCHES["hdc_encode"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got.cpu(), tref.hdc_encode(q, keys, lv))
    assert torch.equal(got, thdc.hdc_encode_reference(
        q.to(cuda), keys.to(cuda), lv.to(cuda)))


def test_hdc_encode_kernel_ties_and_out_of_range_ids(cuda, rng):
    """Even F with key pairs that cancel forces exact zero sums (-> +1);
    ids outside [0, L) contribute nothing."""
    from repro_torch.kernels import hdc_encode as thdc
    m, f, h, levels = 70, 64, 300, 4
    keys = _bipolar_t(rng, f, h)
    keys[f // 2:] = -keys[:f // 2]
    lv = _bipolar_t(rng, levels, h)
    q = rng.integers(0, levels, (m, f)).astype(np.int32)
    q[:, f // 2:] = q[:, :f // 2]          # every sum is exactly zero
    q[1, 5] = -1
    q[2, 9] = levels + 3
    qt = torch.from_numpy(q)
    want = thdc.hdc_encode_reference(qt, keys, lv)
    got = thdc.hdc_encode(qt.to(cuda), keys.to(cuda), lv.to(cuda)).cpu()
    assert torch.equal(got, want)
    assert bool((got[3:] == 1).all())


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
    with pytest.raises(ValueError, match="shared memory"):
        thdc.hdc_encode(q, k, torch.ones((2000, 16), device=cuda))


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
