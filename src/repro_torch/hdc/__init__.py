"""Hyperdimensional computing on CAM — the paper's flagship workload.

Samples are encoded into bipolar *hypervectors* (record-based encoding:
per-feature key hypervectors bound with quantised level hypervectors,
majority-bundled), class prototypes live in an **associative memory** of
bundled training encodings, and classification is a nearest-neighbour
search: the engine's packed-hamming
:class:`~repro_torch.core.engine.SearchPlan` (bipolar argmax-dot ==
argmin-hamming).

* :mod:`repro_torch.hdc.encoding` — item/level memories and the
  hypervector encoder (the hand-written CUDA kernel, its one-hot matmul
  plain version and the dense oracle, all bit-identical).
* :mod:`repro_torch.hdc.classifier` — :class:`HdcClassifier`: one-shot
  training and perceptron-style retraining whose touched AM rows go
  through ``SearchPlan.update_rows``.
"""

from .classifier import HdcClassifier
from .encoding import ItemMemory, level_hypervectors

__all__ = ["HdcClassifier", "ItemMemory", "level_hypervectors"]
