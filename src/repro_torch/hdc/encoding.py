"""Item/level memories and the record-based hypervector encoder.

Encoding contract (shared bit for bit by every path, and with the
reference):

* features are quantised into ``n_levels`` buckets over ``[lo, hi]``;
* each feature position owns a random bipolar *key* hypervector, each
  level a *level* hypervector from a thermometer code (adjacent levels
  differ in ``H / (2 * (L - 1))`` dimensions);
* a sample is the majority bundle over features of
  ``bind(key[f], level[q[f]])``, sign ties -> +1.

Keys and levels are drawn with numpy from ``SeedSequence([seed, 0])``
exactly as the reference draws them, so they are equal bit for bit.
The memory's device picks the encode path: on a CUDA device the features
are quantised there (:func:`quantize_levels`, the reference's float32
operations) and encoded by the hand-written kernel
(:func:`repro_torch.kernels.hdc_encode.hdc_encode_planes`, on bit
planes built once); on the CPU they are quantised in numpy and encoded
by the kernel's plain version.  All sums
are small integers, exact in float32 and int32, so both paths emit the
reference's hypervectors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.engine.base import resolve_device
from ..kernels import hdc_encode as khdc

__all__ = ["ItemMemory", "level_hypervectors", "quantize_levels",
           "random_hypervectors"]


def random_hypervectors(rng: np.random.Generator, n: int,
                        dim: int) -> np.ndarray:
    """(n, dim) i.i.d. random bipolar +-1 hypervectors (float32)."""
    return np.where(rng.random((n, dim)) < 0.5, -1.0, 1.0).astype(np.float32)


def level_hypervectors(rng: np.random.Generator, n_levels: int,
                       dim: int) -> np.ndarray:
    """(L, dim) thermometer-correlated level hypervectors.

    Level 0 is random; each next level flips a fresh segment of
    ``dim // (2 * (L - 1))`` dimensions (no dimension flips twice), so
    the top level sits at ~50% hamming distance from the bottom and
    similarity decays linearly with level distance.
    """
    lv = np.empty((n_levels, dim), np.float32)
    lv[0] = random_hypervectors(rng, 1, dim)[0]
    if n_levels == 1:
        return lv
    perm = rng.permutation(dim)
    seg = dim // (2 * (n_levels - 1))
    for level in range(1, n_levels):
        lv[level] = lv[level - 1]
        flip = perm[(level - 1) * seg:level * seg]
        lv[level, flip] = -lv[level, flip]
    return lv


def quantize_levels(x: torch.Tensor, lo: float, hi: float,
                    n_levels: int) -> torch.Tensor:
    """(M, F) float32 features -> (M, F) int32 level ids on ``x``'s device,
    by the reference's numpy float32 operations: ``x - lo``, divided by
    ``hi - lo`` (a float64 difference rounded to float32), times
    ``n_levels``, truncated and clipped to ``[0, n_levels)``.

    ``lo`` and the span are 0-dim tensors filled on ``x``'s device (no
    blocking copy from the host), so the division is a true float32
    division and not a multiplication by a reciprocal, which PyTorch
    substitutes for a host-scalar divisor on CUDA and which rounds
    differently at bucket edges.  A scaled value past the int32 range
    (non-finite, or about 1e8 spans from ``lo``) is outside the contract:
    numpy's cast is undefined there.
    """
    def scalar(v):
        return torch.full((), float(np.float32(v)), dtype=torch.float32,
                          device=x.device)
    lo_t, span = scalar(lo), scalar(hi - lo)
    t = (x - lo_t) / span
    return (t * n_levels).to(torch.int32).clamp_(0, n_levels - 1)


def _check_alphabet(x: np.ndarray, what: str) -> None:
    """The encode kernel's sums are exact only on {-1, 0, +1} cells."""
    if not np.isin(x, (-1.0, 0.0, 1.0)).all():
        raise ValueError(f"{what} must hold only -1, 0 and +1 cells")


class ItemMemory:
    """Key + level hypervector memories with a fixed quantisation range.

    Deterministic in ``seed``; the keys and levels live on ``device``
    (``None``: the GPU) as float32 and as the bit planes the encode
    kernel reads (:func:`~repro_torch.kernels.hdc_encode.hdc_planes`),
    checked once to hold only -1, 0 and +1.  ``encode``
    takes ``(M, F)`` float features and returns ``(M, H)`` bipolar
    hypervectors, a float32 tensor on that device.
    """

    def __init__(self, n_features: int, *, dim: int = 2048,
                 n_levels: int = 16, lo: float = 0.0, hi: float = 1.0,
                 seed: int = 0, device=None):
        if n_levels < 1:
            raise ValueError("n_levels must be >= 1")
        if not hi > lo:
            raise ValueError(f"need hi > lo, got [{lo}, {hi}]")
        self.n_features = int(n_features)
        self.dim = int(dim)
        self.n_levels = int(n_levels)
        self.lo, self.hi = float(lo), float(hi)
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0]))
        self._place(random_hypervectors(rng, self.n_features, self.dim),
                    level_hypervectors(rng, self.n_levels, self.dim),
                    device)

    @classmethod
    def from_arrays(cls, keys: np.ndarray, levels: np.ndarray, *,
                    lo: float = 0.0, hi: float = 1.0,
                    device=None) -> "ItemMemory":
        """An item memory holding given ``keys`` (F, H) and ``levels``
        (L, H), for instance a reference memory's."""
        keys = np.asarray(keys, np.float32)
        levels = np.asarray(levels, np.float32)
        if keys.ndim != 2 or levels.ndim != 2 or \
                keys.shape[1] != levels.shape[1]:
            raise ValueError(f"keys {keys.shape} and levels {levels.shape} "
                             f"must be (F, H) and (L, H)")
        self = cls.__new__(cls)
        self.n_features, self.dim = keys.shape
        self.n_levels = levels.shape[0]
        if not hi > lo:
            raise ValueError(f"need hi > lo, got [{lo}, {hi}]")
        self.lo, self.hi = float(lo), float(hi)
        self._place(keys, levels, device)
        return self

    def _place(self, keys: np.ndarray, levels: np.ndarray, device) -> None:
        _check_alphabet(keys, "keys")
        _check_alphabet(levels, "levels")
        self.keys, self.levels = keys, levels
        self.device = resolve_device(device)
        self._keys_t = torch.from_numpy(keys).to(self.device)
        self._levels_t = torch.from_numpy(levels).to(self.device)
        # the encode kernel's bit planes, built once: no launch repacks them
        self._planes = khdc.hdc_planes(self._keys_t, self._levels_t)

    def _check_features(self, shape) -> None:
        if len(shape) != 2 or shape[1] != self.n_features:
            raise ValueError(f"features must be (M, {self.n_features}), "
                             f"got {tuple(shape)}")

    def quantize(self, x) -> np.ndarray:
        """(M, F) float features -> (M, F) int32 level indices, in numpy
        float32 arithmetic as the reference quantises."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x, np.float32)
        self._check_features(x.shape)
        t = (x - self.lo) / (self.hi - self.lo)
        return np.clip((t * self.n_levels).astype(np.int32), 0,
                       self.n_levels - 1)

    def level_ids(self, x) -> torch.Tensor:
        """(M, F) features -> (M, F) int32 level ids on the memory's
        device, equal to :meth:`quantize`'s.  A memory on a CUDA device
        quantises there (:func:`quantize_levels`; numpy features are
        copied up as float32); a CPU memory runs :meth:`quantize`."""
        if self.device.type == "cpu":
            return torch.from_numpy(self.quantize(x))
        x = torch.as_tensor(x).to(self.device, torch.float32)
        self._check_features(x.shape)
        return quantize_levels(x, self.lo, self.hi, self.n_levels)

    def encode(self, x) -> torch.Tensor:
        """(M, F) features -> (M, H) bipolar hypervectors (float32 tensor
        on the memory's device): the encode kernel on a CUDA device, its
        plain version on the CPU."""
        return khdc.hdc_encode_planes(self.level_ids(x), self._planes)
