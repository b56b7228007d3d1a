"""Deterministic CAM device-fault models.

The memristive CAM literature this repo compiles for (aCAM: arxiv
1907.08177; tree-in-CAM: arxiv 2103.08986) is explicit that stored
patterns are *analog device state*, not bits in DRAM: cells get stuck,
writes flip bits, conductances sit on a Gaussian around their target
and drift over time.  :class:`FaultModel` expresses those effects as a
**pure, seeded transformation of the stored operands** — the engine
corrupts the source gallery host-side, in numpy, before its
(fault-agnostic) prepare, so every backend and layout (``"torch"`` /
``"cuda"``, packed int32 lanes and float slabs, both plan families)
executes the *same* faulted cells while oracles keep the clean ones.
The draws are the reference package's own (``SeedSequence``-keyed
numpy), so both packages corrupt exactly the same cells.

Determinism contract:

* **stuck cells** are keyed on ``seed`` alone — permanent: the same
  physical cell is stuck across write epochs and time steps.
* **bit flips** and **analog noise** are keyed on ``(seed, epoch)`` —
  transient write-time effects: bumping ``epoch`` (a rewrite / scrub)
  redraws them.
* **drift** direction is keyed on ``seed``; its magnitude is
  ``drift * t`` — deterministic aging, reset by a rewrite in the
  hardening layer's remap path.

Corruption happens in the *source metric domain* (bipolar ±1 cells for
dot/cos, {0, 1} cells for hamming, raw floats for euclidean, ``(lo,
hi)`` bounds for aCAM intervals), so the packed and unpacked encodings
of a faulted gallery are bit-identical — a flip lands in the int32
lane and the float slab alike.  Care masks (ternary wildcard config)
pass through clean: faults target the stored pattern conductances.
"""

from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple

import numpy as np

__all__ = ["FaultModel"]

#: SeedSequence spawn keys — distinct per effect so draws never alias
_TAG_STUCK, _TAG_FLIP, _TAG_NOISE, _TAG_DRIFT = 1, 2, 3, 4


@dataclass(frozen=True)
class FaultModel:
    """Seeded, fully deterministic CAM fault model.

    Frozen and hashable on purpose: the engine keys its prepared-
    pattern memo on ``(sources, fault model)``, so two dispatches with
    the same model reuse one corrupted layout, and the clean entry
    (``faults=None``) is never polluted.
    """

    seed: int = 0
    #: per-cell probability of a *permanent* stuck cell (split evenly
    #: between stuck-at-0 and stuck-at-1)
    p_stuck: float = 0.0
    #: per-cell probability of a *transient* write-time bit flip
    #: (redrawn each write ``epoch``); on analog cells a flip swaps the
    #: cell to its complementary extreme
    p_flip: float = 0.0
    #: std-dev of per-cell Gaussian conductance noise on analog cells /
    #: interval bounds (redrawn each write ``epoch``)
    sigma: float = 0.0
    #: per-time-step deterministic conductance drift magnitude; each
    #: cell drifts in a fixed (seeded) direction by ``drift * t``
    drift: float = 0.0
    #: elapsed time steps since the last write (drives drift)
    t: int = 0
    #: write epoch — bump on rewrite/scrub to redraw transient effects
    epoch: int = 0
    #: analog value a stuck-at-1 cell reads back as
    stuck_hi: float = 1.0

    def __post_init__(self):
        if self.seed < 0 or self.t < 0 or self.epoch < 0:
            raise ValueError("seed, t and epoch must be non-negative")
        for name in ("p_stuck", "p_flip"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.sigma < 0 or self.drift < 0:
            raise ValueError("sigma and drift must be non-negative")

    # -- identity ----------------------------------------------------------

    @property
    def is_null(self) -> bool:
        """True when the model cannot corrupt anything — the engine
        normalises null models to ``None`` so ``FaultModel(p_stuck=0)``
        is *bit-identical* to running with no fault model at all."""
        return (self.p_stuck == 0.0 and self.p_flip == 0.0
                and self.sigma == 0.0 and (self.drift == 0.0 or self.t == 0))

    def rewritten(self) -> "FaultModel":
        """The model after a gallery rewrite: transient flips/noise are
        redrawn (new epoch) and drift restarts from the fresh write."""
        return replace(self, epoch=self.epoch + 1, t=0)

    def aged(self, steps: int) -> "FaultModel":
        """The model ``steps`` time steps later (drift accumulates)."""
        return replace(self, t=self.t + int(steps))

    def suggest_guard(self, z: float = 2.0) -> float:
        """aCAM sensing guard-band: widen interval bounds by ``z``
        noise std-devs plus the accumulated drift, trading false-match
        rate for miss rate (see docs/robustness.md)."""
        return float(z * self.sigma + self.drift * self.t)

    # -- deterministic draws -----------------------------------------------

    def _rng(self, tag: int, *extra: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, tag, *extra]))

    def stuck_masks(self, shape: Tuple[int, ...]):
        """Permanent stuck-cell masks ``(stuck0, stuck1)`` for a stored
        operand of ``shape`` — keyed on seed + shape only, invariant
        across epochs and time steps."""
        u = self._rng(_TAG_STUCK, *shape).random(shape)
        return u < self.p_stuck / 2.0, \
            (u >= self.p_stuck / 2.0) & (u < self.p_stuck)

    def flip_mask(self, shape: Tuple[int, ...]):
        """Transient write-time bit-flip mask — redrawn per epoch."""
        rng = self._rng(_TAG_FLIP, self.epoch, *shape)
        return rng.random(shape) < self.p_flip

    def noise(self, shape: Tuple[int, ...], comp: int = 0) -> np.ndarray:
        """Per-cell Gaussian conductance noise — redrawn per epoch;
        ``comp`` separates the draws for multi-component operands
        (interval ``lo`` vs ``hi``)."""
        rng = self._rng(_TAG_NOISE, self.epoch, comp, *shape)
        return (self.sigma * rng.standard_normal(shape)).astype(np.float32)

    def drift_shift(self, shape: Tuple[int, ...], comp: int = 0) -> np.ndarray:
        """Deterministic drift offset ``±drift * t`` with a per-cell
        fixed (seeded) direction."""
        rng = self._rng(_TAG_DRIFT, comp, *shape)
        sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
        return (sign * (self.drift * self.t)).astype(np.float32)

    # -- domain corruptions ------------------------------------------------

    def corrupt_bits(self, x: np.ndarray, *, bipolar: bool) -> np.ndarray:
        """Corrupt binary cells.

        ``bipolar`` selects the ±1 alphabet (dot/cos galleries, where
        the CAM stores the sign bit via ``x > 0``); otherwise {0, 1}
        (hamming).  Flips first, then stuck cells (a stuck cell wins
        over any write).
        """
        x = np.asarray(x)
        bits = (x > 0) if bipolar else (x != 0)
        bits = bits ^ self.flip_mask(bits.shape)
        s0, s1 = self.stuck_masks(bits.shape)
        bits = (bits | s1) & ~s0
        if bipolar:
            return np.where(bits, 1.0, -1.0).astype(np.float32)
        return bits.astype(np.float32)

    def corrupt_analog(self, x: np.ndarray) -> np.ndarray:
        """Corrupt analog cells (euclidean galleries): Gaussian noise +
        drift, flips swing the cell to its complementary extreme, stuck
        cells read 0 / ``stuck_hi``."""
        x = np.asarray(x, np.float32)
        y = x + self.noise(x.shape) + self.drift_shift(x.shape)
        flip = self.flip_mask(x.shape)
        y = np.where(flip, np.float32(self.stuck_hi) - y, y)
        s0, s1 = self.stuck_masks(x.shape)
        y = np.where(s0, np.float32(0.0), y)
        y = np.where(s1, np.float32(self.stuck_hi), y)
        return y.astype(np.float32)

    def corrupt_interval(self, lo: np.ndarray, hi: np.ndarray):
        """Corrupt aCAM interval bounds.

        Noise and drift move each bound independently (widening *or*
        narrowing the acceptance band); ±inf wildcard bounds are
        unaffected by additive noise by IEEE arithmetic.  A flipped
        cell swaps its bounds (an inverted programming pulse); a
        stuck-at-1 cell always conducts (wildcard ``(-inf, +inf)``), a
        stuck-at-0 cell never matches (empty ``(+inf, -inf)``).
        """
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        shape = lo.shape
        lo2 = lo + self.noise(shape, 0) + self.drift_shift(shape, 0)
        hi2 = hi + self.noise(shape, 1) + self.drift_shift(shape, 1)
        flip = self.flip_mask(shape)
        lo2, hi2 = (np.where(flip, hi2, lo2).astype(np.float32),
                    np.where(flip, lo2, hi2).astype(np.float32))
        s0, s1 = self.stuck_masks(shape)
        inf = np.float32(np.inf)
        lo2 = np.where(s1, -inf, np.where(s0, inf, lo2))
        hi2 = np.where(s1, inf, np.where(s0, -inf, hi2))
        return lo2.astype(np.float32), hi2.astype(np.float32)

    # -- engine entry point ------------------------------------------------

    def corrupt_stored(self, srcs: Tuple[Any, ...], spec) -> Tuple[Any, ...]:
        """Corrupt a plan's stored operands according to its spec.

        ``srcs`` is the stored-operand tuple exactly as the plan sees
        it — ``(gallery,)`` / ``(gallery, care)`` for similarity,
        ``(patterns,)`` / ``(lo, hi)`` for range — and the same
        structure comes back with the pattern cells faulted.  Dispatch
        is duck-typed on the spec (``mode`` marks a range spec) so this
        module never imports the engine.
        """
        if getattr(spec, "mode", None) == "interval":
            return self.corrupt_interval(srcs[0], srcs[1])
        metric = spec.metric
        pat = np.asarray(srcs[0])
        if metric in ("dot", "cos"):
            out = self.corrupt_bits(pat, bipolar=True)
        elif metric == "hamming":
            out = self.corrupt_bits(pat, bipolar=False)
        else:
            out = self.corrupt_analog(pat)
        return (out,) + tuple(srcs[1:])

    # -- telemetry ---------------------------------------------------------

    def cell_fault_counts(self, shape: Tuple[int, ...]) -> Dict[str, int]:
        """Realised fault counts for a stored operand of ``shape`` —
        surfaced by the serving ``health()`` endpoint."""
        s0, s1 = self.stuck_masks(shape)
        return {"stuck0": int(s0.sum()), "stuck1": int(s1.sum()),
                "flips": int(self.flip_mask(shape).sum())}
