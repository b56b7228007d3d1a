"""Forest-to-CAM compiler: tree ensembles as aCAM interval galleries.

Encoding (see ``docs/forest.md`` for the full walk-through):

* a branch node tests ``x[f] <= thr`` — the *left* child tightens the
  row's upper bound (``hi[f] = min(hi[f], thr)``), the *right* child
  tightens the lower bound to the **successor float**
  (``lo[f] = nextafter(thr)``): with float32 queries, ``x > thr`` and
  ``x >= nextafter(thr)`` select exactly the same values, so the
  closed-interval aCAM contract ``lo <= x <= hi`` reproduces the tree
  traversal bit-for-bit;
* features a path never tests stay at the full-range wildcard interval
  ``[-inf, +inf]`` — an aCAM cell that can never mismatch;
* every sample therefore matches exactly one leaf row per tree, and the
  class vote is a boolean-matrix x one-hot matmul.

The ensemble representation is plain numpy arrays (:class:`TreeArrays`
— sklearn's ``tree_`` layout without the sklearn dependency); the
optional :func:`from_sklearn` adapter converts a fitted
``RandomForestClassifier`` when sklearn is installed.

Everything up to :class:`CamForestClassifier` is numpy and equals the
reference package's ``repro.forest.forest``; the classifier compiles
through this package's passes and runs its match on the GPU through a
:class:`~repro_torch.core.engine.RangePlan` (the interval kernel by
default), with the class vote on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["TreeArrays", "ForestIntervals", "CamForestClassifier",
           "tree_to_intervals", "forest_to_intervals", "random_forest",
           "from_sklearn", "traverse_matches", "vote", "vote_device"]


@dataclass
class TreeArrays:
    """One fitted decision tree as plain arrays (sklearn ``tree_`` layout).

    ``feature``/``threshold`` describe branch nodes (``x[feature] <=
    threshold`` goes left); ``left``/``right`` hold child node ids with
    ``-1`` marking a leaf; ``leaf_class`` holds the predicted class at
    leaf nodes (ignored elsewhere).
    """

    feature: np.ndarray        # (nodes,) int32
    threshold: np.ndarray      # (nodes,) float32
    left: np.ndarray           # (nodes,) int32, -1 = leaf
    right: np.ndarray          # (nodes,) int32, -1 = leaf
    leaf_class: np.ndarray     # (nodes,) int32

    def __post_init__(self):
        self.feature = np.asarray(self.feature, np.int32)
        self.threshold = np.asarray(self.threshold, np.float32)
        self.left = np.asarray(self.left, np.int32)
        self.right = np.asarray(self.right, np.int32)
        self.leaf_class = np.asarray(self.leaf_class, np.int32)

    @property
    def n_leaves(self) -> int:
        return int((self.left < 0).sum())


@dataclass
class ForestIntervals:
    """A flattened forest: one aCAM interval row per root-to-leaf path."""

    lo: np.ndarray             # (L, D) float32, -inf = wildcard bound
    hi: np.ndarray             # (L, D) float32, +inf = wildcard bound
    leaf_class: np.ndarray     # (L,) int32
    tree_id: np.ndarray        # (L,) int32
    n_trees: int
    n_classes: int

    @property
    def n_rows(self) -> int:
        return self.lo.shape[0]

    @property
    def wildcard_frac(self) -> float:
        """Fraction of cells storing the full-range wildcard interval."""
        wild = np.isinf(self.lo) & np.isinf(self.hi)
        return float(wild.mean())


def tree_to_intervals(tree: TreeArrays, dim: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten one tree into ``(lo, hi, leaf_class)`` interval rows.

    Iterative root-to-leaf walk; each leaf emits the conjunction of the
    threshold tests on its path as one closed interval per feature.
    """
    los, his, cls = [], [], []
    init_lo = np.full(dim, -np.inf, np.float32)
    init_hi = np.full(dim, np.inf, np.float32)
    stack = [(0, init_lo, init_hi)]
    while stack:
        node, lo, hi = stack.pop()
        if tree.left[node] < 0:            # leaf
            los.append(lo)
            his.append(hi)
            cls.append(tree.leaf_class[node])
            continue
        f = int(tree.feature[node])
        thr = np.float32(tree.threshold[node])
        # left: x[f] <= thr
        llo, lhi = lo.copy(), hi.copy()
        lhi[f] = min(lhi[f], thr)
        stack.append((int(tree.left[node]), llo, lhi))
        # right: x[f] > thr  ==  x[f] >= nextafter(thr) in float32
        rlo, rhi = lo.copy(), hi.copy()
        rlo[f] = max(rlo[f], np.nextafter(thr, np.float32(np.inf)))
        stack.append((int(tree.right[node]), rlo, rhi))
    return (np.stack(los), np.stack(his),
            np.asarray(cls, np.int32))


def forest_to_intervals(trees: Sequence[TreeArrays], dim: int,
                        n_classes: Optional[int] = None) -> ForestIntervals:
    """Flatten a whole ensemble into one interval gallery.

    Rows are emitted in tree order, so ``tree_id`` is monotone — the
    sharded engine's concatenation order keeps whole trees contiguous
    across devices (cosmetic: votes are order-invariant anyway).
    """
    los, his, cls, tid = [], [], [], []
    for t, tree in enumerate(trees):
        lo, hi, c = tree_to_intervals(tree, dim)
        los.append(lo)
        his.append(hi)
        cls.append(c)
        tid.append(np.full(c.shape[0], t, np.int32))
    cls_all = np.concatenate(cls)
    if n_classes is None:
        n_classes = int(cls_all.max()) + 1 if cls_all.size else 1
    return ForestIntervals(
        lo=np.concatenate(los), hi=np.concatenate(his),
        leaf_class=cls_all, tree_id=np.concatenate(tid),
        n_trees=len(trees), n_classes=int(n_classes))


def random_forest(rng: np.random.Generator, *, n_trees: int, dim: int,
                  depth: int, n_classes: int,
                  feature_frac: float = 1.0) -> List[TreeArrays]:
    """A synthetic ensemble of random full binary trees.

    Used by the example / benchmark / tests so the forest path needs no
    training dependency: split features are drawn from a per-tree
    subset (``feature_frac < 1`` guarantees untested features, i.e.
    wildcard interval cells), thresholds from N(0, 1), leaf classes
    uniformly.  Structurally identical to a fitted forest as far as
    the compiler is concerned.
    """
    trees = []
    n_feat = max(1, int(round(feature_frac * dim)))
    for _ in range(n_trees):
        feats = rng.choice(dim, size=n_feat, replace=False)
        n_branch = 2 ** depth - 1
        n_nodes = 2 ** (depth + 1) - 1
        feature = np.full(n_nodes, -1, np.int32)
        threshold = np.zeros(n_nodes, np.float32)
        left = np.full(n_nodes, -1, np.int32)
        right = np.full(n_nodes, -1, np.int32)
        leaf_class = np.zeros(n_nodes, np.int32)
        feature[:n_branch] = rng.choice(feats, size=n_branch)
        threshold[:n_branch] = rng.standard_normal(n_branch).astype(np.float32)
        left[:n_branch] = 2 * np.arange(n_branch, dtype=np.int32) + 1
        right[:n_branch] = 2 * np.arange(n_branch, dtype=np.int32) + 2
        leaf_class[n_branch:] = rng.integers(0, n_classes,
                                             n_nodes - n_branch)
        trees.append(TreeArrays(feature, threshold, left, right, leaf_class))
    return trees


def from_sklearn(model: Any) -> List[TreeArrays]:
    """Convert a fitted sklearn forest/tree to :class:`TreeArrays`.

    Accepts a ``RandomForestClassifier``-like ensemble (anything with
    ``estimators_``) or a single fitted ``DecisionTreeClassifier``.
    Thresholds are cast to float32 — the CAM stores float32 cells, so
    the compiled forest's contract is "the float32 rounding of the
    fitted tree", bit-identical between the engine and this package's
    traversal oracle (sklearn's own float64-threshold ``predict`` can
    disagree on values that fall inside the rounding gap).  Aggregation
    also differs by design: the CAM votes the *majority leaf class*
    (one match line per branch, Pedretti et al.), whereas sklearn
    averages per-tree class probabilities — expect high but not exact
    agreement with ``model.predict``.
    """
    try:
        from sklearn.tree import DecisionTreeClassifier  # noqa: F401
    except ImportError as e:                         # pragma: no cover
        raise ImportError(
            "from_sklearn needs scikit-learn installed; build TreeArrays "
            "directly for a dependency-free forest") from e
    estimators = getattr(model, "estimators_", None) or [model]
    trees = []
    for est in estimators:
        t = est.tree_
        leaf = t.children_left < 0
        value = t.value[:, 0, :]
        trees.append(TreeArrays(
            feature=np.where(leaf, -1, t.feature).astype(np.int32),
            threshold=np.where(leaf, 0.0, t.threshold).astype(np.float32),
            left=t.children_left.astype(np.int32),
            right=t.children_right.astype(np.int32),
            leaf_class=np.argmax(value, axis=1).astype(np.int32)))
    return trees


def traverse_matches(trees: Sequence[TreeArrays], intervals: ForestIntervals,
                     x: np.ndarray) -> np.ndarray:
    """(M, L) boolean match matrix by *tree traversal* (the oracle).

    Walks every tree per sample (``x[f] <= thr`` goes left, float32
    compares) and flags the reached leaf's interval row.  Must equal
    the engine's aCAM interval match bit-for-bit.
    """
    x = np.asarray(x, np.float32)
    m = x.shape[0]
    match = np.zeros((m, intervals.n_rows), bool)
    row0 = 0
    for t, tree in enumerate(trees):
        # leaf order must mirror tree_to_intervals' stack walk
        leaf_rows = _leaf_row_index(tree)
        for i in range(m):
            node = 0
            while tree.left[node] >= 0:
                f = int(tree.feature[node])
                node = int(tree.left[node]
                           if x[i, f] <= tree.threshold[node]
                           else tree.right[node])
            match[i, row0 + leaf_rows[node]] = True
        row0 += tree.n_leaves
    return match


def _leaf_row_index(tree: TreeArrays) -> dict:
    """leaf node id -> emitted row offset (tree_to_intervals order)."""
    order = {}
    stack = [0]
    while stack:
        node = stack.pop()
        if tree.left[node] < 0:
            order[node] = len(order)
            continue
        stack.append(int(tree.left[node]))
        stack.append(int(tree.right[node]))
    return order


def vote(matches: np.ndarray, leaf_class: np.ndarray,
         n_classes: int) -> np.ndarray:
    """(M,) majority-vote predictions from a boolean match matrix.

    One vote per matched row (= one per tree); ties break toward the
    lowest class id (``argmax`` returns the first maximum).
    """
    onehot = np.zeros((leaf_class.shape[0], n_classes), np.int32)
    onehot[np.arange(leaf_class.shape[0]), leaf_class] = 1
    counts = np.asarray(matches, np.int32) @ onehot
    return np.argmax(counts, axis=1).astype(np.int32)


def vote_device(matches: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """(M,) int32 majority-vote predictions on the matches' device.

    ``onehot`` is the (L, n_classes) float32 one-hot of the leaf classes.
    The counts come from a float32 matrix product — exact for counts
    below 2**24, and the card has no int32 matmul — and ``argmax``
    returns the first maximum, so ties break toward the lowest class id
    exactly as :func:`vote` does.
    """
    counts = matches.to(torch.float32) @ onehot
    return counts.argmax(dim=1).to(torch.int32)


class CamForestClassifier:
    """Compile a tree ensemble onto an analog CAM and run inference.

    Pipeline: flatten the ensemble to interval rows
    (:func:`forest_to_intervals`), build a ``cim.range_search``
    (interval mode) program, tile it to subarray granularity with the
    standard ``CompulsoryPartition`` pass, lower through ``cim-to-cam``
    / ``cam-map`` with ``CamType.ACAM`` (MappingPlans + camsim cost
    report), and execute matches through the engine's
    :class:`~repro_torch.core.engine.RangePlan` — micro-batched and
    plan-cached, on the GPU by default (``backend="cuda"`` launches the
    interval kernel; ``device="cpu"`` runs on the CPU).
    """

    def __init__(self, trees: Sequence[TreeArrays], dim: int,
                 n_classes: Optional[int] = None):
        self.trees = list(trees)
        self.dim = int(dim)
        self.intervals = forest_to_intervals(self.trees, self.dim, n_classes)
        self.program = None
        self.plan = None
        self._lo = self._hi = self._onehot = None

    # ------------------------------------------------------------------
    def compile(self, arch=None, *, batch_hint: int = 64,
                backend: str = "cuda", shards: Optional[int] = None,
                unroll_limit: int = 64, device=None
                ) -> "CamForestClassifier":
        """Lower the forest onto ``arch`` (must be an ACAM) and build
        the engine plan on ``device`` (``None``: the GPU).  Returns
        ``self`` for chaining."""
        from ..core.arch import ArchSpec, CamType
        from ..core.cim_dialect import (make_acquire, make_execute,
                                        make_range_search, make_release,
                                        make_yield)
        from ..core.engine import get_plan
        from ..core.ir import Builder, Module, PassManager, TensorType
        from ..core.passes import CamMap, CimToCam, CompulsoryPartition

        if arch is None:
            arch = ArchSpec(cam_type=CamType.ACAM)
        n = self.intervals.n_rows
        m = max(1, int(batch_hint))
        mod = Module("forest_inference",
                     [TensorType((m, self.dim)),
                      TensorType((n, self.dim)), TensorType((n, self.dim))],
                     arg_names=["x", "lo", "hi"])
        b = Builder(mod.body)
        dev = make_acquire(b)
        exe = make_execute(b, dev.result, list(mod.arguments),
                           [TensorType((m, n), "i1")])
        blk = exe.region().block()
        rs = make_range_search(
            blk, mod.arguments[0], lo=mod.arguments[1], hi=mod.arguments[2],
            extra_attrs={"value_bits": arch.bits_per_cell})
        make_yield(blk, rs.results)
        make_release(b, dev.result)
        b.ret(exe.results)

        ctx = {"arch": arch}
        pm = PassManager()
        pm.add(CompulsoryPartition(unroll_limit=unroll_limit))
        partitioned = pm.run(mod, ctx)
        pm2 = PassManager()
        pm2.add(CimToCam(cam_type=arch.cam_type))
        cam = pm2.run(partitioned.clone(), ctx)
        pm3 = PassManager(verify_each=False)   # mapped IR is loop-structured
        pm3.add(CamMap())
        mapped = pm3.run(cam, ctx)

        self.arch = arch
        self.stages = {"cim_partitioned": partitioned, "cam": cam,
                       "cam_mapped": mapped}
        self.mapping_plans = ctx.get("plans", [])
        self.plan = get_plan(partitioned, backend=backend, shards=shards,
                             device=device)
        if self.plan is None:                  # pragma: no cover
            raise RuntimeError("forest program did not yield a RangePlan")
        # device tensors: every predict hits the plan's pattern memo
        iv = self.intervals
        where = self.plan.device
        self._lo = torch.from_numpy(iv.lo).to(where)
        self._hi = torch.from_numpy(iv.hi).to(where)
        onehot = np.zeros((iv.n_rows, iv.n_classes), np.float32)
        onehot[np.arange(iv.n_rows), iv.leaf_class] = 1.0
        self._onehot = torch.from_numpy(onehot).to(where)
        return self

    # ------------------------------------------------------------------
    def _require_compiled(self):
        if self.plan is None:
            raise RuntimeError("call compile() first")

    def _queries(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        return x.to(self.plan.device, torch.float32)

    def matches(self, x) -> torch.Tensor:
        """(M, L) boolean branch-match matrix via the engine RangePlan,
        on the plan's device."""
        self._require_compiled()
        return self.plan.execute(self._queries(x), self._lo, self._hi)

    def predict(self, x) -> torch.Tensor:
        """(M,) int32 class predictions through the compiled aCAM path,
        voted on the plan's device."""
        return vote_device(self.matches(x), self._onehot)

    def predict_interpreted(self, x) -> torch.Tensor:
        """Predictions via the IR interpreter (semantic oracle)."""
        from ..core.executor import execute_module

        self._require_compiled()
        match = execute_module(self.stages["cim_partitioned"],
                               self._queries(x), self._lo, self._hi,
                               backend="torch", device=self.plan.device)[0]
        return vote_device(match, self._onehot)

    def predict_reference(self, x: np.ndarray) -> np.ndarray:
        """Predictions via plain per-sample tree traversal (no CAM)."""
        m = traverse_matches(self.trees, self.intervals,
                             np.asarray(x, np.float32))
        return vote(m, self.intervals.leaf_class, self.intervals.n_classes)

    # ------------------------------------------------------------------
    def cost_report(self):
        """camsim latency/energy report for the aCAM forest mapping."""
        from ..camsim import CostModel

        self._require_compiled()
        return CostModel(self.arch).report(self.mapping_plans)

    def summary(self) -> dict:
        iv = self.intervals
        out = {"trees": iv.n_trees, "rows": iv.n_rows, "dim": self.dim,
               "classes": iv.n_classes,
               "wildcard_frac": round(iv.wildcard_frac, 4)}
        if self.plan is not None:
            out.update(backend=self.plan.backend, shards=self.plan.shards,
                       batch=self.plan.batch, device=str(self.plan.device),
                       grid=(self.plan.spec.grid_rows,
                             self.plan.spec.grid_cols))
            rep = self.cost_report()
            out.update(latency_us=round(rep.latency_us, 3),
                       energy_uj=round(rep.energy_uj, 3))
        return out
