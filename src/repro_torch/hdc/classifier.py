"""HDC classifier: associative memory served by the search engine.

Training keeps per-class **integer accumulators** (sums of bipolar
training encodings, int64 on the device); the served associative memory
is their sign (majority bundle, tie -> +1).  Classification lowers to the
compiled similarity stack: a ``cim.similarity`` program (``metric="dot"``,
``k=1``, ``largest=True``) over bipolar operands, which the engine runs
as a packed XOR+popcount hamming search (argmax-dot == argmin-hamming for
bipolar data), the hand-crafted design the compiler targets.

Retraining is the perceptron-style HDC update: each misclassified
encoding is subtracted from the predicted class's accumulator and added
to the true class's.  Only the touched classes' AM rows change, and
:meth:`HdcClassifier.retrain_epoch` pushes just those rows through
:meth:`SearchPlan.update_rows` — or, against live traffic, through a
:class:`~repro_torch.serving.CamSearchServer`'s ``update_gallery``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .encoding import ItemMemory

__all__ = ["HdcClassifier"]

#: encodings converted to int64 at a time while accumulating class sums
_SUM_CHUNK = 4096


class HdcClassifier:
    """Encode -> associative-memory classify -> retrain, on the engine.

    Parameters mirror :class:`ItemMemory` (features, hypervector dim,
    quantisation levels/range, ``device``: ``None`` is the GPU);
    ``n_classes`` sizes the associative memory.  Call :meth:`fit`
    (one-shot bundling), :meth:`compile` (lower to a ``SearchPlan``),
    then :meth:`predict` / :meth:`retrain_epoch`.  Encodings,
    predictions and the class sums are tensors on the device.
    """

    def __init__(self, n_features: int, n_classes: int, *, dim: int = 2048,
                 n_levels: int = 16, lo: float = 0.0, hi: float = 1.0,
                 seed: int = 0, device=None):
        self._init(ItemMemory(n_features, dim=dim, n_levels=n_levels, lo=lo,
                              hi=hi, seed=seed, device=device), n_classes)

    @classmethod
    def from_item_memory(cls, item: ItemMemory,
                         n_classes: int) -> "HdcClassifier":
        """A classifier over an existing item memory."""
        self = cls.__new__(cls)
        self._init(item, n_classes)
        return self

    def _init(self, item: ItemMemory, n_classes: int) -> None:
        self.item = item
        self.device = item.device
        self.n_classes = int(n_classes)
        self.dim = item.dim
        # integer accumulators: sums of +-1 encodings stay exact
        self.class_sums = torch.zeros((self.n_classes, self.dim),
                                      dtype=torch.int64, device=self.device)
        self.plan = None
        self._gallery = None

    # -- encoding / training ----------------------------------------------

    def encode(self, x) -> torch.Tensor:
        """(M, F) features -> (M, H) bipolar encodings (float32)."""
        return self.item.encode(x)

    def _encodings(self, x, encoded) -> torch.Tensor:
        enc = self.encode(x) if encoded is None else encoded
        return torch.as_tensor(enc, device=self.device)

    def _labels(self, y) -> torch.Tensor:
        return torch.as_tensor(y, device=self.device).to(torch.int64)

    def am(self) -> torch.Tensor:
        """(C, H) bipolar associative memory: sign of the accumulators,
        tie -> +1 (the :func:`~repro_torch.kernels.ref.hdc_bundle`
        contract)."""
        return torch.where(self.class_sums >= 0, 1.0, -1.0).to(torch.float32)

    def _accumulate(self, rows: torch.Tensor, enc: torch.Tensor,
                    sign: int) -> None:
        """``class_sums[rows[i]] += sign * enc[i]`` in exact int64, a chunk
        of encodings at a time."""
        for s in range(0, rows.shape[0], _SUM_CHUNK):
            self.class_sums.index_add_(
                0, rows[s:s + _SUM_CHUNK],
                enc[s:s + _SUM_CHUNK].to(torch.int64), alpha=sign)

    def fit(self, x=None, y=None, encoded=None) -> "HdcClassifier":
        """One-shot training: bundle every encoding into its class."""
        enc = self._encodings(x, encoded)
        y = self._labels(y)
        self._accumulate(y, enc, 1)
        self._refresh_gallery(np.unique(y.cpu().numpy()))
        return self

    # -- lowering ----------------------------------------------------------

    def compile(self, arch=None, *, batch_hint: int = 64,
                backend: str = "cuda", shards: Optional[int] = None,
                pack: Optional[bool] = None, device=None) -> "HdcClassifier":
        """Lower classification onto ``arch`` and build the engine plan
        on ``device`` (``None``: the classifier's device).

        The program is a hand-built fused ``cim.similarity`` (dot, k=1,
        largest) run through ``CompulsoryPartition``, so the plan lands in
        the process-wide cache and packs automatically.  Returns ``self``.
        """
        from ..core.arch import ArchSpec
        from ..core.cim_dialect import (make_acquire, make_execute,
                                        make_release, make_similarity,
                                        make_yield)
        from ..core.engine import get_plan
        from ..core.ir import Builder, Module, PassManager, TensorType
        from ..core.passes import CompulsoryPartition

        if arch is None:
            arch = ArchSpec(rows=32, cols=64)
        m = max(1, int(batch_hint))
        mod = Module("hdc_classify",
                     [TensorType((m, self.dim)),
                      TensorType((self.n_classes, self.dim))],
                     arg_names=["queries", "am"])
        b = Builder(mod.body)
        dev = make_acquire(b)
        exe = make_execute(b, dev.result, list(mod.arguments),
                           [TensorType((m, 1)), TensorType((m, 1), "i32")])
        blk = exe.region().block()
        sim = make_similarity(blk, mod.arguments[0], mod.arguments[1],
                              metric="dot", k=1, largest=True)
        make_yield(blk, sim.results)
        make_release(b, dev.result)
        b.ret(exe.results)

        pm = PassManager()
        pm.add(CompulsoryPartition())
        self.stages = {"cim_partitioned": pm.run(mod, {"arch": arch})}
        self.arch = arch
        self.plan = get_plan(self.stages["cim_partitioned"], backend=backend,
                             shards=shards, pack=pack,
                             device=self.device if device is None else device)
        if self.plan is None:                  # pragma: no cover
            raise RuntimeError("HDC program did not yield a SearchPlan")
        self._gallery = self.am().to(self.plan.device)
        return self

    def _require_compiled(self):
        if self.plan is None:
            raise RuntimeError("call compile() first")

    @property
    def gallery(self) -> torch.Tensor:
        """The served associative memory (plan-memoised tensor)."""
        self._require_compiled()
        return self._gallery

    def _refresh_gallery(self, changed: np.ndarray) -> None:
        """Push changed AM rows into the plan's memoised layout."""
        if self.plan is None or self._gallery is None:
            return
        changed = np.asarray(changed, np.int64)
        if changed.size == 0:
            return
        rows = self.am()[torch.as_tensor(changed, device=self.device)]
        self._gallery = self.plan.update_rows(self._gallery, changed, rows)

    # -- inference ---------------------------------------------------------

    def predict(self, x=None, *, encoded=None) -> torch.Tensor:
        """(M,) int32 class predictions through the compiled search plan,
        on the plan's device."""
        self._require_compiled()
        enc = self._encodings(x, encoded)
        _, idx = self.plan.execute(enc, self._gallery)
        return idx[:, 0].to(torch.int32)

    def predict_interpreted(self, x=None, *, encoded=None) -> torch.Tensor:
        """Predictions via the IR interpreter (semantic oracle)."""
        from ..core.executor import execute_module

        self._require_compiled()
        enc = self._encodings(x, encoded)
        am = self.am()
        # the interpreter runs the traced shape exactly: chunk to the
        # module's query count, padding the tail with its last row
        m = self.plan.spec.m
        outs = [torch.empty((0,), dtype=torch.int32, device=self.device)]
        for s in range(0, enc.shape[0], m):
            chunk = enc[s:s + m]
            valid = chunk.shape[0]
            if valid < m:
                chunk = torch.cat([chunk, chunk[-1:].expand(m - valid, -1)])
            _, idx = execute_module(self.stages["cim_partitioned"], chunk,
                                    am, backend="torch",
                                    device=self.plan.device)
            outs.append(idx[:valid, 0].to(torch.int32).to(self.device))
        return torch.cat(outs)

    def predict_reference(self, x=None, *, encoded=None) -> torch.Tensor:
        """Predictions via dense argmax-dot (lowest index on ties, the
        tie-break the engine pins)."""
        enc = self._encodings(x, encoded)
        scores = enc.to(torch.float32) @ self.am().T
        return torch.argmax(scores, dim=1).to(torch.int32)

    # -- retraining --------------------------------------------------------

    def retrain_step(self, encoded, y, preds) -> np.ndarray:
        """Apply the perceptron update for one prediction batch.

        Misclassified encodings move from the predicted class's
        accumulator to the true class's.  Returns the sorted, unique
        class ids (host int64) whose accumulators changed — the rows to
        push.  :meth:`retrain_epoch` does both.
        """
        enc = torch.as_tensor(encoded, device=self.device)
        y = self._labels(y)
        preds = self._labels(preds)
        wrong = preds != y
        yw, pw = y[wrong], preds[wrong]
        if yw.numel() == 0:
            return np.empty((0,), np.int64)
        ew = enc[wrong]
        self._accumulate(yw, ew, 1)
        self._accumulate(pw, ew, -1)
        return np.unique(torch.cat([yw, pw]).cpu().numpy())

    def retrain_epoch(self, x=None, y=None, *, encoded=None,
                      server=None) -> Tuple[float, int]:
        """One retraining epoch; returns (pre-update accuracy, number of
        AM rows pushed).

        Predictions come from the live path — the attached
        ``CamSearchServer`` when given (so retraining competes with real
        traffic), the compiled plan otherwise — and the touched AM rows
        go back through ``server.update_gallery`` / ``plan.update_rows``,
        i.e. the gallery mutates between micro-batches while the server
        keeps serving.
        """
        self._require_compiled()
        enc = self._encodings(x, encoded)
        y = self._labels(y)
        if server is not None:
            _, idx = server.search(enc)
            preds = torch.as_tensor(idx[:, 0], device=self.device).to(
                torch.int64)
        else:
            preds = self.predict(encoded=enc).to(torch.int64)
        acc = int((preds == y).sum()) / y.shape[0]
        changed = self.retrain_step(enc, y, preds)
        if changed.size:
            if server is not None:
                rows = self.am()[torch.as_tensor(changed, device=self.device)]
                server.update_gallery(changed, rows)
                self._gallery = server.gallery
            else:
                self._refresh_gallery(changed)
        return acc, int(changed.size)

    def summary(self) -> dict:
        out = {"classes": self.n_classes, "dim": self.dim,
               "features": self.item.n_features,
               "levels": self.item.n_levels, "device": str(self.device)}
        if self.plan is not None:
            out.update(backend=self.plan.backend, shards=self.plan.shards,
                       packed=self.plan.packed, batch=self.plan.batch,
                       grid=(self.plan.spec.grid_rows,
                             self.plan.spec.grid_cols))
        return out
