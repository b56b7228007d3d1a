"""Architecture specification for CAM-based accelerators (paper §II-C, §III-B).

The accelerator is a four-level hierarchy::

    system -> B banks -> T mats/bank -> A arrays/mat -> S subarrays/array
    subarray = R rows x C columns of CAM cells

Each level has an *access mode* (``parallel`` or ``sequential``).  All active
rows within a subarray are always searched in parallel; *selective row
pre-charging* (Zukowski & Wang [27]) lets a subarray hold multiple data
batches and search them over multiple cycles (the paper's ``cam-density``
mode).  The spec also carries the CAM cell type and the optimization target,
mirroring the JSON architecture-description input of Fig. 3.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional

__all__ = ["CamType", "SearchType", "Metric", "AccessMode", "ArchSpec",
           "OptimizationTarget", "PAPER_BASE_ARCH", "kazemi_arch"]


class CamType:
    BCAM = "bcam"
    TCAM = "tcam"
    MCAM = "mcam"
    ACAM = "acam"
    ALL = (BCAM, TCAM, MCAM, ACAM)


class SearchType:
    EXACT = "exact"      # EX: all cells match
    BEST = "best"        # BE: minimum-distance row(s) (winner-take-all)
    RANGE = "range"      # TH: distance below threshold
    ALL = (EXACT, BEST, RANGE)


class Metric:
    HAMMING = "hamming"
    EUCLIDEAN = "eucl"
    DOT = "dot"
    COSINE = "cos"
    ALL = (HAMMING, EUCLIDEAN, DOT, COSINE)

    @staticmethod
    def validate(name: str) -> str:
        """Reject unknown metric names at construction time.

        The engine and IR accept every member of ``ALL`` (including
        ``cos``, which the physical search runs as bipolar Hamming);
        anything else used to surface only as a deep ``ValueError``
        inside kernel dispatch.
        """
        if name not in Metric.ALL:
            raise ValueError(
                f"unknown metric {name!r}; expected one of {Metric.ALL}")
        return name


class AccessMode:
    PARALLEL = "parallel"
    SEQUENTIAL = "sequential"


class OptimizationTarget:
    LATENCY = "latency"
    POWER = "power"
    DENSITY = "density"          # array utilization via selective search
    POWER_DENSITY = "power+density"
    ALL = (LATENCY, POWER, DENSITY, POWER_DENSITY)


@dataclass(frozen=True)
class ArchSpec:
    """Static description of one CAM accelerator configuration."""

    rows: int = 32                      # R: rows per subarray
    cols: int = 32                      # C: columns per subarray
    subarrays_per_array: int = 8        # S
    arrays_per_mat: int = 4             # A
    mats_per_bank: int = 4              # T
    banks: int = 0                      # B; 0 = "as many as needed" (paper IV-B)
    cam_type: str = CamType.TCAM
    bits_per_cell: int = 1              # 1 = binary, >1 = multi-bit (MCAM)
    # access mode per level, outermost first: bank, mat, array, subarray
    access: Dict[str, str] = field(default_factory=lambda: {
        "bank": AccessMode.PARALLEL,
        "mat": AccessMode.PARALLEL,
        "array": AccessMode.PARALLEL,
        "subarray": AccessMode.PARALLEL,
    })
    # optimization knobs (paper §III-D2 "built-in optimizations")
    target: str = OptimizationTarget.LATENCY
    max_active_subarrays: int = 0       # 0 = unlimited (cam-base); 1 = cam-power
    selective_search: bool = False      # cam-density: multiple batches/array
    supports_selective: bool = True

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.cam_type not in CamType.ALL:
            raise ValueError(f"unknown cam type {self.cam_type}")
        if self.target not in OptimizationTarget.ALL:
            raise ValueError(f"unknown optimization target {self.target}")
        for lvl in ("bank", "mat", "array", "subarray"):
            if self.access.get(lvl) not in (AccessMode.PARALLEL, AccessMode.SEQUENTIAL):
                raise ValueError(f"bad access mode for {lvl}: {self.access.get(lvl)}")

    # -- capacity ------------------------------------------------------
    @property
    def subarray_cells(self) -> int:
        return self.rows * self.cols

    @property
    def subarrays_per_bank(self) -> int:
        return self.subarrays_per_array * self.arrays_per_mat * self.mats_per_bank

    @property
    def cells_per_bank(self) -> int:
        return self.subarrays_per_bank * self.subarray_cells

    def banks_needed(self, total_rows: int, total_cols: int) -> int:
        """Banks required to hold a ``total_rows x total_cols`` pattern matrix."""
        tiles = math.ceil(total_rows / self.rows) * math.ceil(total_cols / self.cols)
        per_bank = self.subarrays_per_bank
        if self.selective_search:
            # selective search stacks multiple row-batches in one subarray
            batches = max(self.rows // max(1, min(total_rows, self.rows)), 1)
            # handled more precisely by the mapper; here: capacity unchanged
        return max(1, math.ceil(tiles / per_bank))

    # -- derived convenience --------------------------------------------
    def with_target(self, target: str) -> "ArchSpec":
        """Returns a spec with optimization knobs set for ``target``."""
        if target == OptimizationTarget.LATENCY:
            return replace(self, target=target, max_active_subarrays=0,
                           selective_search=False)
        if target == OptimizationTarget.POWER:
            return replace(self, target=target, max_active_subarrays=1,
                           selective_search=False)
        if target == OptimizationTarget.DENSITY:
            return replace(self, target=target, max_active_subarrays=0,
                           selective_search=True)
        if target == OptimizationTarget.POWER_DENSITY:
            return replace(self, target=target, max_active_subarrays=1,
                           selective_search=True)
        raise ValueError(target)

    # -- (de)serialization ----------------------------------------------
    def to_json(self) -> str:
        d = {k: getattr(self, k) for k in (
            "rows", "cols", "subarrays_per_array", "arrays_per_mat",
            "mats_per_bank", "banks", "cam_type", "bits_per_cell", "target",
            "max_active_subarrays", "selective_search", "supports_selective")}
        d["access"] = dict(self.access)
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "ArchSpec":
        d = json.loads(s)
        return ArchSpec(**d)


#: The paper's validation/DSE configuration (§IV-B): 4 mats/bank, 4
#: arrays/mat, 8 subarrays/array, banks as needed.
PAPER_BASE_ARCH = ArchSpec(rows=32, cols=32, subarrays_per_array=8,
                           arrays_per_mat=4, mats_per_bank=4, banks=0)


def kazemi_arch(cols: int, rows: int = 32, bits_per_cell: int = 1) -> ArchSpec:
    """The hand-crafted HDC design of Kazemi et al. [22]: 32 x C arrays."""
    return ArchSpec(rows=rows, cols=cols, subarrays_per_array=8,
                    arrays_per_mat=4, mats_per_bank=4, banks=0,
                    cam_type=CamType.TCAM if bits_per_cell == 1 else CamType.MCAM,
                    bits_per_cell=bits_per_cell)
