"""Deterministic synthetic datasets (numpy only).

* ``hdc_dataset`` / ``knn_dataset`` — the paper's two benchmark workloads
  (HDC hypervectors, KNN feature gallery) with class structure so accuracy
  is meaningful.
* ``TokenStream`` / ``hdc_mnist_dataset`` — the LM corpus and the raw
  MNIST-shaped HDC features.

Same seeds, same arrays as the reference package's ``repro.data``.
"""

from .synthetic import TokenStream, hdc_dataset, hdc_mnist_dataset, knn_dataset

__all__ = ["TokenStream", "hdc_dataset", "hdc_mnist_dataset", "knn_dataset"]
