"""Deterministic synthetic datasets (see package docstring)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["TokenStream", "hdc_dataset", "hdc_mnist_dataset", "knn_dataset"]


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


@dataclass
class TokenStream:
    """Deterministic packed LM batches.

    Documents are sampled with a Zipfian unigram model plus injected
    copy/repeat structure (so a model can actually reduce loss), packed
    back-to-back into ``seq_len``-token rows with EOS=0 separators.
    ``batch(i)`` is a pure function of ``(seed, i)``.
    """

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    mean_doc_len: int = 512

    def _doc(self, rng: np.random.Generator) -> np.ndarray:
        n = max(8, int(rng.exponential(self.mean_doc_len)))
        # zipf-ish unigram over the vocab
        base = (rng.pareto(1.2, size=n) * 7).astype(np.int64) % (self.vocab - 1)
        tok = base + 1                       # 0 is EOS
        # repeat structure: copy a prefix window somewhere later
        if n > 32:
            w = int(rng.integers(8, 17))
            src = int(rng.integers(0, n - 2 * w))
            dst = int(rng.integers(src + w, n - w))
            tok[dst:dst + w] = tok[src:src + w]
        return tok

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        rng = _rng(self.seed, index)
        rows = np.zeros((self.global_batch, self.seq_len), np.int32)
        mask = np.ones((self.global_batch, self.seq_len), np.float32)
        for b in range(self.global_batch):
            buf: list = []
            while len(buf) < self.seq_len:
                buf.extend(self._doc(rng).tolist())
                buf.append(0)                # EOS
            rows[b] = np.asarray(buf[: self.seq_len], np.int32)
        return {"tokens": rows, "mask": mask}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def hdc_dataset(n_classes: int = 10, dim: int = 8192, n_queries: int = 10000,
                seed: int = 7, noise: float = 0.15,
                binary: bool = True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """HDC class hypervectors + noisy queries (the paper's MNIST/8k stand-in).

    Returns (class_hvs (C, D), queries (Q, D), labels (Q,)).  Queries are
    class vectors with ``noise`` fraction of dimensions flipped — the
    associative-memory recall workload of Kazemi et al. [22].
    """
    rng = _rng(seed, 0)
    classes = rng.integers(0, 2, size=(n_classes, dim)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=n_queries)
    flips = rng.random((n_queries, dim)) < noise
    queries = classes[labels].copy()
    queries[flips] = 1.0 - queries[flips]
    if not binary:                       # multi-bit (MCAM) variant
        classes = classes * 14 + rng.integers(0, 2, classes.shape)
        queries = queries * 14 + rng.integers(0, 2, queries.shape)
    return classes, queries, labels


def hdc_mnist_dataset(n_train: int = 512, n_test: int = 256,
                      n_classes: int = 10, side: int = 14, seed: int = 3,
                      noise: float = 0.3, overlap: float = 0.55
                      ) -> Tuple[np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
    """MNIST-shaped *feature* samples for the end-to-end HDC pipeline.

    Unlike :func:`hdc_dataset` (which hands out ready-made class
    hypervectors — the associative-memory *recall* workload), this
    returns raw ``side x side`` images in ``[0, 1]`` that must be
    **encoded** into hypervectors: each class owns a blob template
    drawn as ``overlap`` parts shared background + ``(1 - overlap)``
    class-specific structure, and samples add pixel noise.  The overlap
    makes classes confusable enough that one-shot HDC training lands
    mid-range and perceptron retraining visibly improves it — the
    regime Figs. 8/9 retrain in.

    Returns ``(train_x (n_train, side*side), train_y, test_x, test_y)``.
    """
    rng = _rng(seed, 2)
    dim = side * side
    background = rng.random(dim).astype(np.float32)
    templates = (overlap * background[None, :]
                 + (1 - overlap) * rng.random((n_classes, dim))
                 ).astype(np.float32)

    def draw(n: int) -> Tuple[np.ndarray, np.ndarray]:
        y = rng.integers(0, n_classes, size=n).astype(np.int32)
        x = templates[y] + rng.normal(0.0, noise, (n, dim)).astype(np.float32)
        return np.clip(x, 0.0, 1.0).astype(np.float32), y

    train_x, train_y = draw(n_train)
    test_x, test_y = draw(n_test)
    return train_x, train_y, test_x, test_y


def knn_dataset(n_gallery: int = 180_000, dim: int = 1024,
                n_queries: int = 624, n_classes: int = 2,
                seed: int = 11) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """KNN gallery/query features (the Pneumonia X-ray stand-in).

    Class-conditional Gaussians in feature space; returns
    (gallery (N, D), g_labels, queries (Q, D), q_labels)."""
    rng = _rng(seed, 1)
    centers = rng.standard_normal((n_classes, dim)).astype(np.float32) * 2.0
    g_labels = rng.integers(0, n_classes, size=n_gallery)
    gallery = centers[g_labels] + rng.standard_normal(
        (n_gallery, dim)).astype(np.float32)
    q_labels = rng.integers(0, n_classes, size=n_queries)
    queries = centers[q_labels] + rng.standard_normal(
        (n_queries, dim)).astype(np.float32)
    return gallery, g_labels.astype(np.int32), queries, q_labels.astype(np.int32)
