"""Hardening passes: replication, self-healing remap, guard bands.

Fault *injection* (:mod:`repro_torch.faults.model`) answers "what breaks";
this module answers "how do we keep serving anyway", with the three
mechanisms the memristive-CAM literature actually deploys:

* **Redundant-row replication** — each logical row is stored ``R``
  times (plus ``spares`` empty rows); physical search runs over the
  replicated gallery through the *unmodified* engine (either backend,
  packed or not), and a majority/median vote de-duplicates physical
  candidates back to logical results at finalize.
* **Faulty-row remap (self-healing)** — :meth:`HardenedPlan.heal`
  compares a simulated device *readback* of the stored gallery against
  per-row checksums of the clean content and rewrites rows that
  mismatch onto spare rows using the engine's existing
  :meth:`~repro_torch.core.engine.SearchPlan.update_rows` machinery.  Rows
  that stay faulty after the configured passes (stuck cells at every
  spare, or spares exhausted) are reported unrepairable and their
  physical slots excluded from the vote.
* **aCAM sensing guard-bands** — interval plans widen each finite
  ``(lo, hi)`` bound by a margin (typically
  :meth:`FaultModel.suggest_guard`, a few noise sigmas plus drift), so
  conductance noise stops flipping marginal matches; the price is a
  higher false-match rate, which the forest/HDC vote absorbs.

A ``HardenedPlan`` with ``replicas=1, spares=0, guard=0`` is
**bit-identical** to the raw plan — the vote over one replica is the
identity — which the test suite pins.

The clean content, checksums, readback and search vote live on the host
(numpy), as in the reference package; the physical operands live on the
wrapped plan's device, where the range vote also runs.  ``execute``
returns host numpy arrays, the reference's output type.

The search family's physical plan asks for ``replicas * k + spares``
candidates.  On the ``"cuda"`` backend a count beyond the kernels' window
(``kernels.cam_search.MAX_K``) takes the matrix route, as any plan with a
larger ``k`` does.
"""

import zlib
from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..core.engine import RangeSpec, get_plan, module_for_spec
from ..core.engine.base import _host
from ..core.envcfg import env_int

__all__ = ["HardenedPlan", "HealReport", "row_checksums",
           "detect_faulty_rows"]

#: losing-candidate index sentinel (same as ``kref.pad_candidates``)
_PAD_IDX = 2 ** 30


def row_checksums(arrs: Tuple[np.ndarray, ...]) -> np.ndarray:
    """Per-row CRC32 over all stored components.

    The digest primitive shared by :class:`HardenedPlan` (physical-row
    readback checks) and the serving replica layer (replica-divergence
    detection): row ``p``'s checksum covers row ``p`` of *every*
    component — gallery and care mask, or interval ``(lo, hi)`` — so
    two stored copies agree iff their checksum vectors agree.
    """
    n = arrs[0].shape[0]
    return np.array([
        zlib.crc32(b"".join(np.ascontiguousarray(a[p]).tobytes()
                            for a in arrs))
        for p in range(n)], np.uint32)


def detect_faulty_rows(readback: Tuple[Any, ...],
                       clean: Tuple[np.ndarray, ...],
                       tolerance: float = 0.0) -> np.ndarray:
    """Row mask of a simulated device readback diverging from the
    clean stored content.

    Digital cells (``tolerance <= 0``) compare exactly via
    :func:`row_checksums`; analog cells use a per-cell absolute
    tolerance — typically :meth:`FaultModel.suggest_guard`, a few
    noise sigmas plus drift — since Gaussian read noise perturbs every
    cell and only outliers (stuck cells, flipped bounds, excessive
    drift) indicate a row worth rewriting.  Handles ``inf`` bounds
    (``inf == inf`` matches; ``inf - finite`` is an outlier).
    """
    clean = tuple(np.asarray(c, np.float32) for c in clean)
    if tolerance <= 0.0:
        crc = row_checksums(tuple(np.asarray(a, np.float32)
                                  for a in readback))
        return crc != row_checksums(clean)
    bad = np.zeros(clean[0].shape[0], bool)
    for rb, cl in zip(readback, clean):
        rb = np.asarray(rb, np.float32)
        same = rb == cl                         # matching cells/infs
        with np.errstate(invalid="ignore"):     # inf - inf -> nan
            diff = np.where(same, 0.0, np.abs(rb - cl))
        bad |= ~(np.nan_to_num(diff, nan=np.inf) <= tolerance).all(axis=1)
    return bad


@dataclass
class HealReport:
    """Outcome of one :meth:`HardenedPlan.heal` run."""

    detected: int          # distinct faulty physical rows found (all passes)
    remapped: int          # rows rewritten onto spares (all passes)
    unrepairable: int      # live rows still faulty when healing stopped
    passes: int            # detection passes run
    spares_free: int       # spare slots still available afterwards


def _heal_passes_default() -> int:
    return env_int("REPRO_FAULT_HEAL_PASSES", 3, min_value=1)


class HardenedPlan:
    """A fault-hardened wrapper around one compiled plan.

    Compiles a *physical* plan for the replicated gallery (``n_phys =
    replicas * n + spares`` rows, top-``replicas * k + spares``
    candidates for the search family) via
    :func:`~repro_torch.core.engine.module_for_spec`, keeps the clean
    stored content plus per-row checksums on the host, and maps physical
    results back to logical rows with a majority/median vote.  The
    physical plan is an ordinary plan-cache citizen: backend, packing,
    sharding and device are inherited from the wrapped plan (backend,
    packing and sharding may be overridden), and fault injection happens
    through the same ``faults=`` dispatch hook as everywhere else.

    Physical layout: replica ``r`` of logical row ``j`` lives at
    physical row ``r * n + j``; spares occupy the tail.  ``logical_of``
    maps physical -> logical with ``-1`` for dead rows and unused
    spares (dead rows stay allocated — their fault draws are
    position-keyed — but never contribute to results).
    """

    def __init__(self, plan, *, replicas: int = 1, spares: int = 0,
                 guard: float = 0.0, backend: Optional[str] = None,
                 pack: Optional[bool] = None, shards: Optional[int] = None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if spares < 0:
            raise ValueError(f"spares must be >= 0, got {spares}")
        if guard < 0:
            raise ValueError(f"guard must be >= 0, got {guard}")
        spec = plan.spec
        self.spec = spec
        self.replicas = int(replicas)
        self.spares = int(spares)
        self.guard = float(guard)
        self.is_range = isinstance(spec, RangeSpec)
        if not self.is_range and guard:
            raise ValueError("guard bands only apply to aCAM interval plans")
        if self.is_range and guard and spec.mode != "interval":
            raise ValueError("guard bands only apply to aCAM interval plans")
        self.n = spec.n
        self.n_phys = self.replicas * spec.n + self.spares
        if self.is_range:
            phys_spec = replace(spec, n=self.n_phys)
        else:
            phys_spec = replace(spec, n=self.n_phys,
                                k=self.replicas * spec.k + self.spares)
        self.plan = get_plan(
            module_for_spec(phys_spec),
            backend=plan.backend if backend is None else backend,
            pack=plan.packed if pack is None else pack,
            shards=(plan.shards if plan.shards > 1 else None)
            if shards is None else shards,
            device=plan.device)
        assert self.plan is not None
        self.phys_spec = self.plan.spec
        #: physical -> logical row map; -1 = dead row or unused spare
        self.logical_of = np.concatenate(
            [np.tile(np.arange(self.n, dtype=np.int32), self.replicas),
             np.full(self.spares, -1, np.int32)])
        self._free = list(range(self.replicas * self.n, self.n_phys))
        #: physical operands, tensors on the plan's device
        self._stored: Optional[Tuple[torch.Tensor, ...]] = None
        self._clean: Optional[Tuple[np.ndarray, ...]] = None
        self._logical: Optional[Tuple[np.ndarray, ...]] = None
        self._crc: Optional[np.ndarray] = None
        self.heals = 0
        self.rows_remapped = 0
        self.unrepairable = 0

    # -- stored content ----------------------------------------------------

    def prepare(self, *stored) -> None:
        """Store the logical content: ``(gallery[, care])`` for the
        search family, ``(patterns,)`` / ``(lo, hi)`` for range.  Guard
        bands are applied to finite interval bounds *before*
        replication, so every replica (and every healed rewrite)
        carries the widened intervals."""
        stored = tuple(_host(s).astype(np.float32) for s in stored)
        if self.is_range and self.spec.mode == "interval" and self.guard:
            lo, hi = stored
            stored = (np.where(np.isfinite(lo), lo - self.guard, lo),
                      np.where(np.isfinite(hi), hi + self.guard, hi))
        self._logical = stored
        phys = []
        for comp, arr in enumerate(stored):
            tail = self._spare_fill(comp, arr)
            phys.append(np.concatenate([np.tile(arr, (self.replicas, 1)),
                                        tail]).astype(np.float32))
        self._clean = tuple(phys)
        self._stored = self._to_device(self._clean)
        self._crc = self._checksums(self._clean)

    def _to_device(self, arrs: Tuple[np.ndarray, ...]
                   ) -> Tuple[torch.Tensor, ...]:
        """Copies of the host arrays on the plan's device (never views:
        the host arrays are edited in place by :meth:`_remap`)."""
        return tuple(torch.tensor(a, device=self.plan.device) for a in arrs)

    def _spare_fill(self, comp: int, arr: np.ndarray) -> np.ndarray:
        """Placeholder content for spare rows.

        Interval spares are the empty interval ``(+inf, -inf)`` (never
        match); everything else is zeros except ternary care masks
        (all-compare, so a spare never degenerates into an
        all-wildcard row with distance zero).
        """
        shape = (self.spares, arr.shape[1])
        if self.is_range and self.spec.mode == "interval":
            return np.full(shape, np.inf if comp == 0 else -np.inf,
                           np.float32)
        if not self.is_range and comp == 1:      # care mask
            return np.ones(shape, np.float32)
        return np.zeros(shape, np.float32)

    @staticmethod
    def _checksums(arrs: Tuple[np.ndarray, ...]) -> np.ndarray:
        """Per-physical-row CRC32 over all stored components."""
        return row_checksums(arrs)

    def _logical_rows(self, logical_idx: np.ndarray
                      ) -> Tuple[np.ndarray, ...]:
        return tuple(a[logical_idx] for a in self._logical)

    # -- execution ---------------------------------------------------------

    def execute(self, queries, faults=None):
        """Run the hardened search: physical plan + majority vote.

        Returns logical-domain results as host numpy arrays —
        ``(values, indices)`` with logical row indices for the search
        family, an ``(M, n)`` logical match matrix for range.  ``faults``
        corrupts the *physical* gallery (each replica draws independent
        position-keyed faults — that is the whole point of replication).
        """
        if self._stored is None:
            raise RuntimeError("call prepare(*stored) before execute")
        out = self.plan.execute(queries, *self._stored, faults=faults)
        if self.is_range:
            return self._finalize_range(out)
        v, i = (x.cpu().numpy() for x in out)
        return self._finalize_search(v, i)

    def _finalize_search(self, v: np.ndarray, i: np.ndarray):
        """Median-vote de-duplication of physical top-k candidates.

        Groups candidates by logical row, aggregates each group's
        value as the median over its surviving replicas (a clean
        majority outvotes a corrupt minority), re-ranks, and pads back
        to logical ``k`` with the engine's losing sentinels.  With one
        replica and no spares this reproduces the raw plan's output
        bit-exactly (median of one value is that value; the sort key
        matches the engine's value-then-lower-index tie-break).
        """
        spec = self.spec
        lead, kp = v.shape[:-1], v.shape[-1]
        v2 = v.reshape(-1, kp)
        i2 = i.reshape(-1, kp)
        lose = -np.inf if spec.largest else np.inf
        out_v = np.full((v2.shape[0], spec.k), lose, np.float32)
        out_i = np.full((v2.shape[0], spec.k), _PAD_IDX, np.int32)
        for r in range(v2.shape[0]):
            groups = {}
            for val, pi in zip(v2[r], i2[r]):
                if pi >= self.n_phys:
                    continue                    # padded losing slot
                lg = int(self.logical_of[pi])
                if lg < 0:
                    continue                    # dead row / unused spare
                groups.setdefault(lg, []).append(val)
            agg = sorted(
                ((float(np.median(vs)), lg) for lg, vs in groups.items()),
                key=(lambda t: (-t[0], t[1])) if spec.largest
                else (lambda t: (t[0], t[1])))
            for j, (val, lg) in enumerate(agg[:spec.k]):
                out_v[r, j] = val
                out_i[r, j] = lg
        return (out_v.reshape(lead + (spec.k,)),
                out_i.reshape(lead + (spec.k,)))

    def _finalize_range(self, match: torch.Tensor) -> np.ndarray:
        """Strict-majority vote over each logical row's live replicas.

        A logical row matches iff more than half of its live physical
        copies match (use odd ``replicas`` — an even split loses).
        Rows with zero live copies never match.  The votes are counted on
        the match matrix's device, one ``index_add_`` of the live
        physical columns into their logical rows (the reference's dense
        physical-to-logical one-hot product, without the
        ``(n_phys, n)`` matrix).
        """
        lead = tuple(match.shape[:-1])
        m2 = match.reshape(-1, self.n_phys)
        live = np.nonzero(self.logical_of >= 0)[0]
        dev = m2.device
        votes = torch.zeros((m2.shape[0], self.n), dtype=torch.int32,
                            device=dev)
        votes.index_add_(
            1, torch.as_tensor(self.logical_of[live], dtype=torch.int64,
                               device=dev),
            m2[:, torch.as_tensor(live, device=dev)].to(torch.int32))
        quorum = torch.as_tensor(
            np.bincount(self.logical_of[live], minlength=self.n),
            dtype=torch.int32, device=dev)
        return (2 * votes > quorum[None, :]).reshape(
            lead + (self.n,)).cpu().numpy()

    # -- self-healing ------------------------------------------------------

    def heal(self, model, *, max_passes: Optional[int] = None,
             tolerance: Optional[float] = None) -> HealReport:
        """Detect faulty rows by checksum readback and remap to spares.

        ``model`` simulates the device readback
        (``corrupt_stored`` of the physical arrays).  Digital cells
        compare exactly (CRC32 of the readback row vs the stored
        checksum); analog cells use a tolerance —
        ``model.suggest_guard(z=4)`` by default — since Gaussian read
        noise perturbs *every* cell and only outliers (stuck cells,
        flipped bounds, excessive drift) indicate a row worth
        rewriting.  Each pass rewrites every detected row onto a free
        spare via the engine's ``update_rows``; the next pass checks
        the new positions (a spare can be faulty too — fault draws are
        position-keyed).  Healing never bumps the model's write epoch;
        callers model a scrub by passing ``model.rewritten()``.
        """
        if self._stored is None:
            raise RuntimeError("call prepare(*stored) before heal")
        if model is None or model.is_null:
            return HealReport(0, 0, 0, 0, len(self._free))
        if max_passes is None:
            max_passes = _heal_passes_default()
        if tolerance is None:
            tolerance = model.suggest_guard(z=4.0)
        detected = remapped = 0
        passes = 0
        # each physical position counts as one detection event, even if
        # it stays bad across passes (spares exhausted)
        seen_bad = np.zeros(self.n_phys, bool)
        for passes in range(1, max_passes + 1):
            bad = self._detect(model, tolerance)
            detected += int((bad & ~seen_bad).sum())
            seen_bad |= bad
            targets = np.nonzero(bad)[0]
            if targets.size == 0 or not self._free:
                break
            moves_from, moves_to = [], []
            for p in targets:
                if not self._free:
                    break
                moves_from.append(int(p))
                moves_to.append(self._free.pop(0))
            self._remap(np.array(moves_from, np.int64),
                        np.array(moves_to, np.int64))
            remapped += len(moves_to)
        self.heals += 1
        self.rows_remapped += remapped
        final_bad = self._detect(model, tolerance)
        detected += int((final_bad & ~seen_bad).sum())
        unrepairable = int(final_bad.sum())
        self.unrepairable = unrepairable
        return HealReport(detected=detected, remapped=remapped,
                          unrepairable=unrepairable, passes=passes,
                          spares_free=len(self._free))

    def _detect(self, model, tolerance: float) -> np.ndarray:
        """Faulty-live-row mask from a simulated readback."""
        readback = model.corrupt_stored(self._clean, self.phys_spec)
        bad = detect_faulty_rows(readback, self._clean, tolerance)
        return bad & (self.logical_of >= 0)

    def _remap(self, frm: np.ndarray, to: np.ndarray) -> None:
        """Rewrite the logical content of faulty rows onto spares.

        Goes through the plan's incremental ``update_rows`` (only the
        touched row tiles re-prepare) except for ternary plans, whose
        care cells ``update_rows`` cannot rewrite — those rebuild both
        physical operands host-side and take a full re-prepare on the
        next dispatch.
        """
        logical = self.logical_of[frm].astype(np.int64)
        rows = self._logical_rows(logical)
        ternary = not self.is_range and len(self._stored) > 1
        if ternary:
            for comp, blk in enumerate(rows):
                self._clean[comp][to] = blk
            self._stored = self._to_device(self._clean)
        else:
            if len(self._stored) > 1:
                upd = self.plan.update_rows(self._stored, to, rows)
                self._stored = tuple(upd)
            else:
                upd = self.plan.update_rows(self._stored[0], to, rows[0])
                self._stored = (upd,)
            for comp, blk in enumerate(rows):
                self._clean[comp][to] = blk
        self._crc[to] = self._checksums(tuple(a[to] for a in self._clean))
        self.logical_of[to] = logical
        self.logical_of[frm] = -1

    # -- telemetry ---------------------------------------------------------

    def snapshot(self) -> dict:
        live = self.logical_of >= 0
        copies = np.bincount(self.logical_of[live], minlength=self.n) \
            if self._stored is not None else np.zeros(self.n, int)
        return {
            "replicas": self.replicas, "spares": self.spares,
            "guard": self.guard, "n": self.n, "n_phys": self.n_phys,
            "spares_free": len(self._free), "heals": self.heals,
            "rows_remapped": self.rows_remapped,
            "unrepairable": self.unrepairable,
            "min_live_copies": int(copies.min()) if copies.size else 0,
        }
