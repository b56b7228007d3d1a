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
                            "acam_match": 0, "range_match": 0}
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
