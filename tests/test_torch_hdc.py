"""Port HDC vs the reference, on the CPU: the hypervector algebra oracles,
the encode kernel's plain version (B5) against the Pallas kernel in
interpret mode, item/level memories and quantisation, and
``HdcClassifier`` on both port backends — one-shot sums, predictions and
a three-epoch retraining trajectory through ``update_rows`` — against the
reference's classifier on the same numpy data.

Every HDC sum is a small integer, so every comparison is bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.arch import ArchSpec as RArch
from repro.hdc import HdcClassifier as RClassifier
from repro.hdc import ItemMemory as RItemMemory
from repro.hdc.encoding import level_hypervectors as r_levels
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch import convert
from repro_torch.core import ArchSpec as TArch
from repro_torch.hdc import HdcClassifier, ItemMemory, level_hypervectors
from repro_torch.hdc.encoding import quantize_levels, random_hypervectors
from repro_torch.kernels import hdc_encode as thdc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

PAIRS = [("jnp", "torch"), ("pallas", "cuda")]


def _bipolar(rng, *shape):
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# hypervector algebra
# ---------------------------------------------------------------------------


def test_bind_bundle_permute_match_reference(rng):
    a, b = _bipolar(rng, 4, 64), _bipolar(rng, 4, 64)
    for fn in (tref.hdc_bind, tops.hdc_bind):
        np.testing.assert_array_equal(
            fn(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
            np.asarray(rref.hdc_bind(jnp.asarray(a), jnp.asarray(b))))
    c = _bipolar(rng, 1, 32)[0]
    stacks = [np.stack([a[0], b[0], a[1]]), np.stack([c, -c]),
              np.stack([a[2], -a[2], b[3], -b[3]])]
    for st in stacks:                      # odd, and even stacks that tie
        got = tops.hdc_bundle(torch.from_numpy(st)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(rref.hdc_bundle(jnp.asarray(st))))
    np.testing.assert_array_equal(
        tops.hdc_bundle(torch.from_numpy(stacks[1])).numpy(),
        np.ones_like(c))                   # a perfect tie -> +1
    for shift in (7, -7, 0, 70):
        np.testing.assert_array_equal(
            tops.hdc_permute(torch.from_numpy(a), shift).numpy(),
            np.asarray(rref.hdc_permute(jnp.asarray(a), shift)))


@pytest.mark.parametrize("m,f,h,levels,ties", [(9, 37, 70, 8, False),
                                               (12, 40, 96, 5, True)])
def test_encode_plain_and_oracle_match_pallas(m, f, h, levels, ties, rng):
    """B5's plain version, the port's dense oracle and the ops entry point
    equal the reference's Pallas kernel (interpret mode) and JAX oracle.
    With ``ties`` every second feature cancels the one before it, so
    exact zero sums (-> +1) are everywhere."""
    q = rng.integers(0, levels, size=(m, f)).astype(np.int32)
    keys = _bipolar(rng, f, h)
    lv = _bipolar(rng, levels, h)
    if ties:
        keys[f // 2:] = -keys[:f // 2]
        q[:, f // 2:] = q[:, :f // 2]
        q[:3] = rng.integers(0, levels, size=(3, f))    # some rows untied
    want = np.asarray(rops.hdc_encode(jnp.asarray(q), jnp.asarray(keys),
                                      jnp.asarray(lv)))
    np.testing.assert_array_equal(
        want, np.asarray(rref.hdc_encode(jnp.asarray(q), jnp.asarray(keys),
                                         jnp.asarray(lv))))
    qt, kt, lt = (torch.from_numpy(x) for x in (q, keys, lv))
    for got in (thdc.hdc_encode_reference(qt, kt, lt),
                thdc.hdc_encode(qt, kt.to(torch.int8), lt.to(torch.int8)),
                tops.hdc_encode(qt, kt, lt), tref.hdc_encode(qt, kt, lt)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    if ties:
        assert (want[3:] == 1).all()


def test_encode_ids_outside_the_levels(rng):
    """The plain version drops an id outside [0, L) as the Pallas kernel's
    one-hot does; the dense oracle gathers it as the JAX oracle does."""
    m, f, h, levels = 5, 16, 40, 4
    q = rng.integers(0, levels, size=(m, f)).astype(np.int32)
    q[0, 3], q[1, 0], q[2, 7] = -1, levels, levels + 5
    keys, lv = _bipolar(rng, f, h), _bipolar(rng, levels, h)
    args = (jnp.asarray(q), jnp.asarray(keys), jnp.asarray(lv))
    targs = tuple(torch.from_numpy(x) for x in (q, keys, lv))
    np.testing.assert_array_equal(thdc.hdc_encode_reference(*targs).numpy(),
                                  np.asarray(rops.hdc_encode(*args)))
    np.testing.assert_array_equal(tref.hdc_encode(*targs).numpy(),
                                  np.asarray(rref.hdc_encode(*args)))


def _encode_case(rng, m, f, h, levels, *, zero_cells, ties, bad_ids):
    """Level ids, keys and levels for one bit-plane case: ``zero_cells``
    zeroes a key row and some level cells; ``ties`` (F even) makes every
    second feature cancel the one before it, so exact zero sums are
    everywhere; ``bad_ids`` puts ids -1 and L + 3 in."""
    q = rng.integers(0, levels, size=(m, f)).astype(np.int32)
    keys = _bipolar(rng, f, h)
    lv = _bipolar(rng, levels, h)
    if ties:
        keys[f // 2:] = -keys[:f // 2]
        q[:, f // 2:] = q[:, :f // 2]
        q[:3] = rng.integers(0, levels, size=(3, f))    # some rows untied
    if zero_cells:
        keys[3] = 0.0
        lv[0, :5] = 0.0
        lv[-1, h // 2:] = 0.0
    if bad_ids:
        q[0, 3], q[1, 0], q[2, f - 1] = -1, levels + 3, -1
    return q, keys, lv


BITSLICED_CASES = [(9, 37, 70, 8), (12, 40, 96, 5), (20, 300, 257, 16),
                   (6, 32, 64, 1)]


@pytest.mark.parametrize("zero_cells", [False, True])
@pytest.mark.parametrize("ties,bad_ids", [(False, False), (True, False),
                                          (False, True), (True, True)])
@pytest.mark.parametrize("m,f,h,levels", BITSLICED_CASES)
def test_bitsliced_encode_matches_pallas(m, f, h, levels, zero_cells, ties,
                                         bad_ids, rng):
    """B5's bit planes and a torch run of its carry-save counting and
    bit-sliced sign equal the Pallas kernel (interpret mode) bit for bit,
    on both routes (no zero cell; zero key rows and level cells), with
    exact ties (F even) and ids -1 and L + 3."""
    if ties and f % 2:
        f += 1
    q, keys, lv = _encode_case(rng, m, f, h, levels, zero_cells=zero_cells,
                               ties=ties, bad_ids=bad_ids)
    want = np.asarray(rops.hdc_encode(jnp.asarray(q), jnp.asarray(keys),
                                      jnp.asarray(lv)))
    qt, kt, lt = (torch.from_numpy(x) for x in (q, keys, lv))
    for cells in ((kt, lt), (kt.to(torch.int8), lt.to(torch.int8))):
        planes = thdc.hdc_planes(*cells)
        assert planes.has_zero == zero_cells
        got = thdc.hdc_encode_bitsliced(qt, planes)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            thdc.hdc_encode_planes(qt, planes).numpy(), want)
    if ties and not bad_ids and not zero_cells:     # the ties are there
        sums = thdc.hdc_sums_reference(qt, kt, lt)
        assert bool((sums[3:] == 0).all())


@pytest.mark.parametrize("h", [31, 32, 33, 96, 100])
def test_bit_planes_hold_the_cells(h, rng):
    """Bit ``i`` of word ``w`` is the cell of dim ``32 w + i``: sign set
    for -1, care set for a nonzero cell, both clear past H; one zero level
    row after the last."""
    cells = rng.integers(-1, 2, size=(5, h)).astype(np.float32)
    planes = thdc.hdc_planes(torch.from_numpy(cells[:3]),
                             torch.from_numpy(cells[3:]))
    w = -(-h // 32)
    assert planes.key_planes.shape == (3, w, 2)
    assert planes.level_planes.shape == (3, w, 2)
    assert planes.key_planes.dtype == torch.int32
    words = torch.cat([planes.key_planes, planes.level_planes[:2]])
    bits = ((words[..., None] >> torch.arange(32, dtype=torch.int32)) & 1)
    bits = bits.permute(0, 2, 1, 3).reshape(5, 2, w * 32).numpy()
    np.testing.assert_array_equal(bits[:, 0, :h], cells < 0)
    np.testing.assert_array_equal(bits[:, 1, :h], cells != 0)
    assert not bits[:, :, h:].any()
    assert not bool(planes.level_planes[2].any())
    assert planes.has_zero == bool((cells == 0).any())


def test_count_planes_cover_the_features():
    """Counts reach F: up to 16 planes below 2**16 features, 32 from
    there on (the wide route; it no longer raises), and the route names
    follow features and levels."""
    assert [thdc.count_planes(f) for f in (1, 255, 256, 1023, 1024, 4095,
                                           4096, 65535, 65536, 2**30)] == \
        [8, 8, 10, 10, 12, 12, 16, 16, 32, 32]
    assert thdc.hdc_route(784, 16) == "bitsliced"
    assert thdc.hdc_route(65536, 16) == "wide"
    assert thdc.hdc_route(784, 512) == "global"
    assert thdc.hdc_route(65536, 512) == "wide+global"
    assert thdc.hdc_route(784, 476) == "bitsliced"


def test_encode_wrapper_refuses_bad_operands():
    q = torch.zeros((4, 8), dtype=torch.int32)
    k, lv = torch.ones((8, 16)), torch.ones((3, 16))
    with pytest.raises(ValueError, match="int32"):
        thdc.hdc_encode(q.long(), k, lv)
    with pytest.raises(ValueError, match="key rows"):
        thdc.hdc_encode(q, k[:7], lv)
    with pytest.raises(ValueError, match="width"):
        thdc.hdc_encode(q, k, lv[:, :15])
    with pytest.raises(ValueError, match="float32 or int8"):
        thdc.hdc_encode(q, k.double(), lv)


# ---------------------------------------------------------------------------
# item / level memories
# ---------------------------------------------------------------------------


def test_level_hypervectors_match_reference():
    for levels, h in ((9, 512), (1, 64), (16, 8192)):
        got = level_hypervectors(np.random.default_rng(4), levels, h)
        np.testing.assert_array_equal(
            got, r_levels(np.random.default_rng(4), levels, h))
    lv = level_hypervectors(np.random.default_rng(0), 9, 512)
    d0 = [(lv[0] != lv[i]).sum() for i in range(9)]
    seg = 512 // 16
    assert d0 == sorted(d0) and d0[1] == seg and d0[-1] == seg * 8


def test_item_memory_matches_reference():
    for kw in (dict(dim=256, n_levels=4, seed=3),
               dict(dim=192, n_levels=5, lo=-1.0, hi=2.5, seed=1)):
        im, rim = ItemMemory(8, device="cpu", **kw), RItemMemory(8, **kw)
        np.testing.assert_array_equal(im.keys, rim.keys)
        np.testing.assert_array_equal(im.levels, rim.levels)
        planes = im._planes
        assert torch.equal(planes.keys, torch.from_numpy(rim.keys))
        assert torch.equal(planes.levels, torch.from_numpy(rim.levels))
        assert not planes.has_zero          # +-1 keys and levels
    im, rim = ItemMemory(8, dim=256, n_levels=4, device="cpu"), \
        RItemMemory(8, dim=256, n_levels=4)
    x = np.array([[0.0, 0.1, 0.26, 0.5, 0.74, 0.99, 1.0, -5.0]], np.float32)
    np.testing.assert_array_equal(im.quantize(x)[0], [0, 0, 1, 2, 2, 3, 3, 0])
    # every bucket edge and its float32 neighbours, plus out-of-range
    edges = np.arange(0, 5, dtype=np.float32) / 4
    pts = np.concatenate([edges, np.nextafter(edges, np.float32(-1)),
                          np.nextafter(edges, np.float32(2)),
                          np.array([-3.0, 7.0, 1.5, -0.25], np.float32)])
    pts = np.resize(pts, (len(pts) // 8 + 1) * 8).reshape(-1, 8)
    np.testing.assert_array_equal(im.quantize(pts), rim.quantize(pts))
    np.testing.assert_array_equal(im.quantize(torch.from_numpy(pts)),
                                  rim.quantize(pts))
    np.testing.assert_array_equal(im.level_ids(pts).numpy(),
                                  rim.quantize(pts))
    with pytest.raises(ValueError):
        im.quantize(np.zeros((2, 5), np.float32))     # wrong feature count
    with pytest.raises(ValueError, match="-1, 0 and"):
        ItemMemory.from_arrays(np.full((8, 16), 2.0, np.float32),
                               np.ones((3, 16), np.float32), device="cpu")
    assert random_hypervectors(np.random.default_rng(1), 3, 9).shape == (3, 9)


QUANT_RANGES = [(0.0, 1.0, 16), (-1.0, 2.5, 5), (0.1, 0.7, 7)]


def edge_points(lo, hi, n_levels, ulps=8):
    """The float32 values within ``ulps`` steps of every bucket edge
    ``lo + k (hi - lo) / n_levels``, as an (M, 8) feature block."""
    c = (np.float32(lo) + np.arange(n_levels + 1) * (hi - lo)
         / n_levels).astype(np.float32)
    steps = np.arange(-ulps, ulps + 1, dtype=np.float32)
    pts = (c[:, None] + steps[None, :] * np.abs(np.spacing(c))[:, None])
    pts = pts.astype(np.float32).ravel()
    return np.resize(pts, (-(-pts.size // 8)) * 8).reshape(-1, 8)


@pytest.mark.parametrize("lo,hi,n_levels", QUANT_RANGES)
def test_torch_quantisation_matches_reference_at_every_edge(lo, hi,
                                                            n_levels):
    """The device quantisation's float32 operations, run here on CPU
    tensors, give the reference's level ids on both sides of every
    bucket edge."""
    rim = RItemMemory(8, dim=64, n_levels=n_levels, lo=lo, hi=hi)
    pts = edge_points(lo, hi, n_levels)
    want = rim.quantize(pts)
    flat = want.ravel()
    per_edge = flat[:(n_levels + 1) * 17].reshape(n_levels + 1, 17)
    assert (per_edge[1:-1, 0] < per_edge[1:-1, -1]).all()   # straddled
    got = quantize_levels(torch.from_numpy(pts), lo, hi, n_levels)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_item_memory_encode_choices(rng):
    im, rim = ItemMemory(12, dim=192, n_levels=5, seed=1, device="cpu"), \
        RItemMemory(12, dim=192, n_levels=5, seed=1)
    x = rng.random((7, 12)).astype(np.float32)
    want = rim.encode(x, kernel="pallas")
    q = im.level_ids(x)
    assert q.dtype == torch.int32 and q.device.type == "cpu"
    got = im.encode(x)                     # the CPU memory: the plain version
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(im.encode(torch.from_numpy(x)).numpy(),
                                  want)
    for fn in (thdc.hdc_encode_reference, tref.hdc_encode):
        np.testing.assert_array_equal(
            fn(q, im._keys_t, im._levels_t).numpy(), want)


# ---------------------------------------------------------------------------
# classifier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_problem():
    rng = np.random.default_rng(7)
    C, F = 5, 24
    templates = rng.random((C, F)).astype(np.float32)

    def draw(n):
        y = rng.integers(0, C, n).astype(np.int32)
        x = np.clip(templates[y] + rng.normal(0, 0.3, (n, F)), 0, 1)
        return x.astype(np.float32), y

    return draw(160), draw(80), C, F


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_classifier_parity_and_retraining(small_problem, ref_backend,
                                          backend):
    (xtr, ytr), (xte, yte), C, F = small_problem
    ref = RClassifier(F, C, dim=256, n_levels=8, seed=0)
    ref.fit(xtr, ytr).compile(RArch(rows=8, cols=64), batch_hint=64,
                              backend=ref_backend)
    clf = HdcClassifier(F, C, dim=256, n_levels=8, seed=0, device="cpu")
    clf.fit(xtr, ytr).compile(TArch(rows=8, cols=64), batch_hint=64,
                              backend=backend)
    assert clf.plan.packed and clf.plan.backend == backend
    np.testing.assert_array_equal(clf.class_sums.numpy(), ref.class_sums)

    pred = clf.predict(xte)
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.numpy(), ref.predict(xte))
    assert torch.equal(pred, clf.predict_interpreted(xte))
    assert torch.equal(pred, clf.predict_reference(xte))

    enc_r = ref.encode(xtr)
    enc_t = clf.encode(xtr)
    np.testing.assert_array_equal(enc_t.numpy(), enc_r)
    for _ in range(3):
        got = clf.retrain_epoch(xtr, ytr, encoded=enc_t)
        assert got == ref.retrain_epoch(xtr, ytr, encoded=enc_r)
        np.testing.assert_array_equal(clf.class_sums.numpy(), ref.class_sums)
    assert clf.plan.row_update_fallbacks == 0
    assert clf.plan.row_updates >= 1
    predN = clf.predict(xte)
    np.testing.assert_array_equal(predN.numpy(), ref.predict(xte))
    assert torch.equal(predN, clf.predict_reference(xte))
    assert torch.equal(predN, clf.predict_interpreted(xte))
    assert clf.summary()["packed"] and clf.summary()["device"] == "cpu"


def test_retrain_step_moves_mass_between_touched_classes(small_problem):
    (xtr, ytr), _, C, F = small_problem
    clf = HdcClassifier(F, C, dim=256, n_levels=8, seed=0,
                        device="cpu").fit(xtr, ytr)
    sums0 = clf.class_sums.clone()
    enc = clf.encode(xtr[:4])
    y = np.array([0, 1, 2, 3])
    preds = np.array([0, 1, 3, 2])         # two misclassified
    changed = clf.retrain_step(enc, y, preds)
    np.testing.assert_array_equal(changed, [2, 3])
    assert torch.equal(clf.class_sums[[0, 1, 4]], sums0[[0, 1, 4]])
    assert torch.equal(clf.class_sums[2], sums0[2] + enc[2].long()
                       - enc[3].long())
    assert clf.retrain_step(enc, y, y).size == 0      # a perfect batch


def test_classifier_served_retraining_matches_offline(small_problem):
    """Retraining through a live ``CamSearchServer`` (search, then
    ``update_gallery``) follows the offline trajectory exactly, and both
    follow the reference's."""
    from repro_torch.serving import CamSearchServer

    (xtr, ytr), (xte, _), C, F = small_problem
    ref = RClassifier(F, C, dim=512, n_levels=8, seed=0)
    ref.fit(xtr, ytr).compile(RArch(rows=8, cols=64), batch_hint=64)
    offline = HdcClassifier(F, C, dim=512, n_levels=8, seed=0, device="cpu")
    offline.fit(xtr, ytr).compile(TArch(rows=8, cols=64), batch_hint=64)
    served = HdcClassifier(F, C, dim=512, n_levels=8, seed=0, device="cpu")
    served.fit(xtr, ytr).compile(TArch(rows=8, cols=64), batch_hint=64)

    enc_tr = offline.encode(xtr)
    enc_r = ref.encode(xtr)
    trajectory = [offline.retrain_epoch(xtr, ytr, encoded=enc_tr)
                  for _ in range(3)]
    want = [ref.retrain_epoch(xtr, ytr, encoded=enc_r) for _ in range(3)]
    assert trajectory == want
    with CamSearchServer(served.plan, served.gallery,
                         max_wait_ms=1.0) as srv:
        got = [served.retrain_epoch(xtr, ytr, encoded=enc_tr, server=srv)
               for _ in range(3)]
        _, idx = srv.search(served.encode(xte), timeout=60)
        snap = srv.snapshot()
    # same deterministic update trajectory -> identical AMs/predictions
    assert got == trajectory
    assert torch.equal(served.class_sums, offline.class_sums)
    np.testing.assert_array_equal(served.class_sums.numpy(), ref.class_sums)
    np.testing.assert_array_equal(idx[:, 0].astype(np.int32),
                                  offline.predict(xte).numpy())
    np.testing.assert_array_equal(idx[:, 0].astype(np.int32),
                                  ref.predict(xte))
    assert snap["plan"]["row_update_fallbacks"] == 0
    assert sum(n for _, n in got) > 0
    assert snap["gallery_updates"] > 0 and snap["rows_updated"] > 0


def test_classifier_from_reference_state(small_problem):
    (xtr, ytr), (xte, _), C, F = small_problem
    ref = RClassifier(F, C, dim=256, n_levels=8, lo=-0.5, hi=1.5, seed=4)
    ref.fit(xtr, ytr).compile(RArch(rows=8, cols=64), batch_hint=64)
    ref.retrain_epoch(xtr, ytr)
    clf = convert.hdc_classifier_from_reference(
        ref.class_sums, ref.item.keys, ref.item.levels, lo=-0.5, hi=1.5,
        device="cpu")
    np.testing.assert_array_equal(clf.class_sums.numpy(), ref.class_sums)
    clf.compile(TArch(rows=8, cols=64), batch_hint=64)
    np.testing.assert_array_equal(clf.predict(xte).numpy(), ref.predict(xte))
    with pytest.raises(ValueError, match="integers"):
        convert.hdc_classifier_from_reference(
            ref.class_sums + 0.5, ref.item.keys, ref.item.levels, lo=-0.5,
            hi=1.5, device="cpu")


def test_classifier_refusals(small_problem):
    (xtr, ytr), _, C, F = small_problem
    clf = HdcClassifier(F, C, dim=64, n_levels=4, device="cpu")
    with pytest.raises(RuntimeError, match="compile"):
        clf.predict(np.zeros((1, F), np.float32))
    clf.fit(xtr, ytr).compile(TArch(rows=8, cols=64), batch_hint=16)
    sums = clf.class_sums.clone()
    with pytest.raises(AttributeError, match="search"):
        clf.retrain_epoch(xtr, ytr, server=object())    # not a server
    assert torch.equal(clf.class_sums, sums)            # nothing applied
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            HdcClassifier(F, C, dim=64)    # the GPU unless asked otherwise


# ---------------------------------------------------------------------------
# B5's size limits, lifted: wide feature counts and many levels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_features,n_levels,dim", [
    (65536, 4, 40),          # 256 x 256 features: the 32-plane counts
    (96, 512, 64),           # more levels than a block's shared memory
    (65552, 477, 33),        # both
])
def test_encode_beyond_the_old_limits_matches_reference(n_features,
                                                        n_levels, dim, rng):
    """Feature counts from 2**16 on and more than 476 levels (which the
    kernel once refused) encode as the reference's ``ItemMemory.encode``
    does, bit for bit: the plain version, and the kernel's own bit-sliced
    counting with its 32 count planes."""
    im = ItemMemory(n_features, dim=dim, n_levels=n_levels, seed=2,
                    device="cpu")
    rim = RItemMemory(n_features, dim=dim, n_levels=n_levels, seed=2)
    x = rng.random((2, n_features)).astype(np.float32)
    want = rim.encode(x)
    np.testing.assert_array_equal(im.encode(x).numpy(), want)
    q = im.level_ids(x)
    np.testing.assert_array_equal(
        thdc.hdc_encode_bitsliced(q, im._planes).numpy(), want)
    assert thdc.hdc_route(n_features, n_levels) != "bitsliced"


def test_encode_wide_ties_and_zero_cells_match_reference(rng):
    """The 32-plane count with zero cells (the care route) against the
    reference's oracle; with +-1 cells and an even F, rows whose features
    split evenly tie to +1."""
    f, h, levels = 65536, 36, 3
    keys = rng.integers(-1, 2, size=(f, h)).astype(np.float32)
    lv = rng.integers(-1, 2, size=(levels, h)).astype(np.float32)
    q = rng.integers(0, levels, size=(2, f)).astype(np.int32)
    want = np.asarray(rref.hdc_encode(jnp.asarray(q), jnp.asarray(keys),
                                      jnp.asarray(lv)))
    planes = thdc.hdc_planes(torch.from_numpy(keys), torch.from_numpy(lv))
    assert planes.has_zero
    qt = torch.from_numpy(q)
    np.testing.assert_array_equal(
        thdc.hdc_encode_bitsliced(qt, planes).numpy(), want)
    np.testing.assert_array_equal(
        thdc.hdc_encode_planes(qt, planes).numpy(), want)
    ones = torch.ones((f, h))
    tie = thdc.hdc_planes(ones, torch.stack([ones[0], -ones[0]]))
    half = torch.tensor([[0, 1] * (f // 2)], dtype=torch.int32)
    assert bool((thdc.hdc_encode_bitsliced(half, tie) == 1.0).all())
