"""Deterministic synthetic datasets (numpy only) and the loader.

* ``hdc_dataset`` / ``knn_dataset`` — the paper's two benchmark workloads
  (HDC hypervectors, KNN feature gallery) with class structure so accuracy
  is meaningful.
* ``TokenStream`` / ``hdc_mnist_dataset`` — the LM corpus and the raw
  MNIST-shaped HDC features.
* ``ShardedLoader`` — one process's loader: batches placed on a device,
  the state one integer.

Same seeds, same arrays as the reference package's ``repro.data``.
"""

from .loader import ShardedLoader
from .synthetic import TokenStream, hdc_dataset, hdc_mnist_dataset, knn_dataset

__all__ = ["TokenStream", "hdc_dataset", "hdc_mnist_dataset", "knn_dataset",
           "ShardedLoader"]
