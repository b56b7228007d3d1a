"""Carry a reference plan's or model's state across to the port.

A plan has no weights: what gives it its results is its architecture,
its spec and its prepared gallery.  The spec is rebuilt by compiling the
same program; these two functions carry the other two.

* :func:`arch_from_reference` reads the reference's ``ArchSpec.to_json()``.
* :func:`hdc_classifier_from_reference` rebuilds a trained reference
  ``HdcClassifier`` from its state: class sums, keys and levels.
* :func:`lm_params_from_reference` turns the reference LM's parameter
  pytree (numpy arrays) into the port's dict, key for key.
* :func:`train_state_from_reference` turns the reference's
  ``TrainState`` (parameters, AdamW state, step, compressor residual; as
  numpy) into the port's, so that one step can start from the same state
  in both packages.
* :func:`prepared_from_reference` turns the reference plan's prepared
  operands (``PlanBase._prepared_patterns`` in the reference, as numpy
  arrays) into the port's tensors: uint32 lanes become int32 bit
  patterns, float tiles pass through.  A ``"jnp"`` plan's tile layout is
  the ``"torch"`` backend's, element for element.  A ``"pallas"`` plan
  pads the gallery to its own blocks; given ``spec``, the operands are
  re-padded to the ``"cuda"`` kernels' blocks (past ``MAX_K``, the
  matrix route's: packed lanes stay lanes), which makes them equal to
  what the port's own prepare produces.  Range plans are carried the
  same way: an interval plan's padded ``(lo, hi)`` float32 pair (with
  its ``±inf`` wildcards) and a threshold plan's padded encoded
  patterns (or, from ``"jnp"``, their tiles and packed lanes).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .core.arch import ArchSpec
from .core.engine.spec import RangeSpec, SimilaritySpec
from .kernels import packing as kpack
from .kernels.acam import ACAM_BLOCK_D
from .kernels.cam_search import BLOCK_K, MAX_K, PACKED_ROWS, window_rows
from .kernels.ops import pad_to_blocks

__all__ = ["arch_from_reference", "prepared_from_reference",
           "hdc_classifier_from_reference", "lm_params_from_reference",
           "train_state_from_reference"]


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
                            spec: Optional[Union[SimilaritySpec,
                                                 RangeSpec]] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """The port's prepared operands for a reference plan's.

    ``backend`` names the port backend the operands are for: ``"torch"``
    (from a reference ``"jnp"`` plan) or ``"cuda"`` (from ``"pallas"``).
    For ``"cuda"`` with ``spec`` given, each operand is cut to its
    logical extent (``spec.n`` rows, the dim's floats or lanes) and
    padded to the kernels' blocks: a window multiple of rows for a
    search (past ``MAX_K``, the matrix route's row block), no row padding
    for a range plan, and the inner dimension to
    :data:`~.kernels.cam_search.BLOCK_K` (threshold, search) or
    :data:`~.kernels.acam.ACAM_BLOCK_D` (interval).  The tensors are on
    the CPU.
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
        if backend == "cuda" and isinstance(spec, RangeSpec):
            if packed:
                raise ValueError("the cuda range kernels take float cells")
            block = ACAM_BLOCK_D if spec.mode == "interval" else BLOCK_K
            t = pad_to_blocks(t[:spec.n, :spec.dim], 1, block)
        elif backend == "cuda" and spec is not None:
            cols = kpack.lanes(spec.dim) if packed else spec.dim
            t = pad_to_blocks(t[:spec.n, :cols], _cuda_rows(spec, packed),
                              BLOCK_K)
        out.append(t)
    return tuple(out)


def _cuda_rows(spec: SimilaritySpec, packed: bool) -> int:
    """The row block of a ``"cuda"`` search plan's prepared gallery: the
    kernels' window, or past ``MAX_K`` (the matrix route, no window) the
    packed distance kernel's row block for lanes and none for floats."""
    k = min(spec.k, spec.n)
    if k > MAX_K:
        return PACKED_ROWS if packed else 1
    return window_rows(k)


def hdc_classifier_from_reference(class_sums: np.ndarray, keys: np.ndarray,
                                  levels: np.ndarray, *, lo: float,
                                  hi: float, device=None):
    """A port :class:`~repro_torch.hdc.HdcClassifier` holding a trained
    reference classifier's state (numpy ``class_sums`` (C, H) integers,
    ``keys`` (F, H), ``levels`` (L, H), and the quantisation range
    ``[lo, hi]``) on ``device`` (``None``: the GPU).  It encodes and
    predicts as the reference does; call ``compile`` before ``predict``.
    """
    from .hdc import HdcClassifier, ItemMemory

    sums = np.asarray(class_sums)
    if sums.ndim != 2 or sums.shape[1] != np.shape(keys)[1]:
        raise ValueError(f"class sums {sums.shape} do not match keys "
                         f"{np.shape(keys)}")
    if not np.array_equal(sums, np.round(sums)):
        raise ValueError("class sums must be integers")
    item = ItemMemory.from_arrays(keys, levels, lo=lo, hi=hi, device=device)
    clf = HdcClassifier.from_item_memory(item, sums.shape[0])
    clf.class_sums.copy_(torch.from_numpy(sums.astype(np.int64)))
    return clf


def lm_params_from_reference(params, cfg, *, device=None):
    """The port's LM parameters for the reference's ``init_params``
    pytree of the model ``cfg`` describes (nested dicts of numpy arrays,
    or arrays ``np.asarray`` takes): the same keys and shapes, each leaf
    exact in its own dtype (``cfg.param_dtype`` for most; the MoE
    experts' weights are float32 in the reference whatever it names), on
    ``device`` (``None``: the GPU)."""
    from .core.engine.base import resolve_device

    return _tree_to(params, resolve_device(device))


def _tree_to(tree, dev):
    """Nested dicts of numpy arrays as tensors on ``dev``, each exact in
    its own dtype."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        # via float32: numpy has no bfloat16 that torch reads (exact)
        return torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device=dev)


def train_state_from_reference(state, cfg, *, device=None):
    """The port's :class:`~repro_torch.models.steps.TrainState` for the
    reference's (``params``; ``opt``, an ``OptState`` of ``mu``, ``nu``,
    ``master`` and ``count``; ``step``; ``comp``, ``()`` or a
    ``CompressionState`` whose ``error`` may be None), its leaves numpy
    arrays or what ``np.asarray`` takes.  The parameters become leaves
    that require grad; the counters 0-dim int32 tensors on the host."""
    from .core.engine.base import resolve_device
    from .distributed.compression import CompressionState
    from .models.steps import TrainState
    from .optim import OptState
    from .tree import leaves

    dev = resolve_device(device)
    params = lm_params_from_reference(state.params, cfg, device=dev)
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    opt = state.opt
    comp = state.comp
    if hasattr(comp, "error"):
        comp = CompressionState(error=None if comp.error is None
                                else _tree_to(comp.error, dev))
    else:
        comp = ()
    count = torch.tensor(int(np.asarray(opt.count)), dtype=torch.int32)
    return TrainState(
        params=params,
        opt=OptState(mu=_tree_to(opt.mu, dev), nu=_tree_to(opt.nu, dev),
                     master=_tree_to(opt.master, dev), count=count),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        comp=comp)

