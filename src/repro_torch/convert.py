"""Carry a reference plan's state across to the port.

There are no weights: what gives a plan its results is its architecture,
its spec and its prepared gallery.  The spec is rebuilt by compiling the
same program; these two functions carry the other two.

* :func:`arch_from_reference` reads the reference's ``ArchSpec.to_json()``.
* :func:`prepared_from_reference` turns the reference plan's prepared
  operands (``PlanBase._prepared_patterns`` in the reference, as numpy
  arrays) into the port's tensors: uint32 lanes become int32 bit
  patterns, float tiles pass through.  A ``"jnp"`` plan's tile layout is
  the ``"torch"`` backend's, element for element.  A ``"pallas"`` plan
  pads the gallery to its own blocks; given ``spec``, the operands are
  re-padded to the ``"cuda"`` kernels' blocks, which makes them equal to
  what the port's own prepare produces.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .core.arch import ArchSpec
from .core.engine.spec import SimilaritySpec
from .kernels import packing as kpack
from .kernels.cam_search import BLOCK_K, window_rows
from .kernels.ops import pad_to_blocks

__all__ = ["arch_from_reference", "prepared_from_reference"]


def arch_from_reference(arch_json: str) -> ArchSpec:
    """The port's :class:`ArchSpec` for a reference ``ArchSpec.to_json()``."""
    return ArchSpec.from_json(arch_json)


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def prepared_from_reference(arrays: Sequence[np.ndarray], *, packed: bool,
                            backend: str,
                            spec: Optional[SimilaritySpec] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """The port's prepared operands for a reference plan's.

    ``backend`` names the port backend the operands are for: ``"torch"``
    (from a reference ``"jnp"`` plan) or ``"cuda"`` (from ``"pallas"``).
    For ``"cuda"`` with ``spec`` given, each operand is cut to its
    logical extent (``spec.n`` rows, the dim's floats or lanes) and
    padded to the kernels' blocks.  The tensors are on the CPU.
    """
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    out = []
    for a in arrays:
        a = np.asarray(a)
        if packed != (a.dtype == np.uint32):
            raise ValueError(f"a {'packed' if packed else 'float'} plan's "
                             f"operands cannot be {a.dtype}")
        t = _to_tensor(a)
        if backend == "cuda" and spec is not None:
            cols = kpack.lanes(spec.dim) if packed else spec.dim
            t = pad_to_blocks(t[:spec.n, :cols],
                              window_rows(min(spec.k, spec.n)), BLOCK_K)
        out.append(t)
    return tuple(out)
