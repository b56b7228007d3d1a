"""Port forest inference vs the reference, on the CPU: the interval
encoding, the device vote, and ``CamForestClassifier`` on both port
backends against the reference's ``predict`` (jnp), the port's own
interpreter and the plain tree traversal — all bit-identical (pure
comparisons and integer counts)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.arch import ArchSpec as RArch
from repro.core.arch import CamType as RCam
from repro.forest import CamForestClassifier as RForest
from repro.forest import forest_to_intervals as r_intervals
from repro.forest import random_forest as r_random_forest
from repro_torch.core.arch import ArchSpec, CamType
from repro_torch.forest import (CamForestClassifier, TreeArrays,
                                forest_to_intervals, random_forest,
                                traverse_matches, vote, vote_device)


def _stump(feature, thr, left_cls, right_cls):
    """depth-1 tree: x[feature] <= thr -> left_cls else right_cls."""
    return TreeArrays(feature=[feature, -1, -1], threshold=[thr, 0, 0],
                      left=[1, -1, -1], right=[2, -1, -1],
                      leaf_class=[0, left_cls, right_cls])


def test_forest_to_intervals_equals_reference():
    trees = random_forest(np.random.default_rng(3), n_trees=9, dim=20,
                          depth=4, n_classes=4, feature_frac=0.5)
    ref_trees = r_random_forest(np.random.default_rng(3), n_trees=9, dim=20,
                                depth=4, n_classes=4, feature_frac=0.5)
    mine, ref = forest_to_intervals(trees, 20), r_intervals(ref_trees, 20)
    for f in ("lo", "hi", "leaf_class", "tree_id"):
        assert np.array_equal(getattr(mine, f), getattr(ref, f)), f
    assert (mine.n_trees, mine.n_classes) == (ref.n_trees, ref.n_classes)
    assert 0 < mine.wildcard_frac == ref.wildcard_frac < 1


@pytest.mark.parametrize("shape", [(16, 4, 24), (7, 3, 10)])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_predict_matches_reference_interpreter_and_traversal(shape, backend,
                                                             rng):
    n_trees, depth, dim = shape
    trees = random_forest(rng, n_trees=n_trees, dim=dim, depth=depth,
                          n_classes=5, feature_frac=0.5)
    x = rng.standard_normal((57, dim)).astype(np.float32)
    ref = RForest(trees, dim=dim).compile(
        RArch(rows=32, cols=32, cam_type=RCam.ACAM), batch_hint=32)
    clf = CamForestClassifier(trees, dim=dim).compile(
        ArchSpec(rows=32, cols=32, cam_type=CamType.ACAM), batch_hint=32,
        backend=backend, device="cpu")
    pred = clf.predict(x)
    assert pred.dtype == torch.int32 and pred.device.type == "cpu"
    want = ref.predict(x)
    np.testing.assert_array_equal(pred.numpy(), want)
    np.testing.assert_array_equal(clf.predict_interpreted(x).numpy(), want)
    np.testing.assert_array_equal(clf.predict_reference(x), want)
    m = clf.matches(x)
    assert m.dtype == torch.bool and bool((m.sum(1) == n_trees).all())
    np.testing.assert_array_equal(
        m.numpy(), traverse_matches(trees, clf.intervals, x))
    assert dataclasses.asdict(clf.plan.spec) == \
        dataclasses.asdict(ref.plan.spec)
    # lo / hi are tensors on the plan's device: the second call hits
    hits = clf.plan.pattern_hits
    clf.predict(torch.from_numpy(x))
    assert clf.plan.pattern_hits == hits + 1


def test_boundary_sample_routes_like_traversal():
    """x exactly at a threshold goes left (<=): the nextafter encoding
    keeps the closed-interval match bit-identical to the traversal."""
    clf = CamForestClassifier([_stump(0, 0.5, 1, 2)], dim=2).compile(
        ArchSpec(rows=8, cols=8, cam_type=CamType.ACAM), device="cpu")
    x = np.array([[0.5, 0.0],
                  [np.nextafter(np.float32(0.5), np.float32(1)), 0.0]],
                 np.float32)
    np.testing.assert_array_equal(clf.predict(x).numpy(), [1, 2])
    np.testing.assert_array_equal(clf.predict_reference(x), [1, 2])


def test_vote_ties_go_to_the_lowest_class():
    leaf_class = np.array([0, 1, 1, 2], np.int32)
    matches = np.array([[True, True, True, False],     # 1 beats 0
                        [True, False, False, True],    # 0-2 tie -> 0
                        [False, False, False, True],   # only 2
                        [False, True, False, True]],   # 1-2 tie -> 1
                       bool)
    want = [1, 0, 2, 1]
    np.testing.assert_array_equal(vote(matches, leaf_class, 3), want)
    onehot = torch.zeros((4, 3))
    onehot[torch.arange(4), torch.from_numpy(leaf_class).long()] = 1.0
    got = vote_device(torch.from_numpy(matches), onehot)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cost_report_and_summary_equal_reference(rng):
    trees = random_forest(rng, n_trees=8, dim=16, depth=3, n_classes=3)
    ref = RForest(trees, dim=16).compile(
        RArch(rows=32, cols=32, cam_type=RCam.ACAM))
    clf = CamForestClassifier(trees, dim=16).compile(
        ArchSpec(rows=32, cols=32, cam_type=CamType.ACAM), device="cpu")
    assert dataclasses.asdict(clf.cost_report()) == \
        dataclasses.asdict(ref.cost_report())
    assert [dataclasses.asdict(p) for p in clf.mapping_plans] == \
        [dataclasses.asdict(p) for p in ref.mapping_plans]
    mine, theirs = clf.summary(), ref.summary()
    assert mine.pop("backend") == "cuda" and theirs.pop("backend") == "jnp"
    assert mine.pop("device") == "cpu"
    assert mine == theirs
    with pytest.raises(ValueError, match="acam"):
        CamForestClassifier(trees, dim=16).compile(
            ArchSpec(rows=16, cols=16, cam_type=CamType.TCAM), device="cpu")
