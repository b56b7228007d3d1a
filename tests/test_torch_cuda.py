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
                            "fused_topk_packed_ternary": 1}
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
