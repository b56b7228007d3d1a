"""Eva-CAM-analog energy/latency model for FeFET CAM hierarchies.

Technology anchor points (paper §IV-A1, 2FeFET CAM [20] @ 45 nm, numbers
extracted from Eva-CAM [29]):

* search latency 0.86 ns for a 16x16 subarray, 7.5 ns for 256x256 — the
  match-line discharges more slowly for larger columns; we fit the power law
  ``t_search(C) = 0.86 ns * (C/16)**0.78`` through both points.
* readout/merge peripheral latency grows with the priority-encoder depth,
  ``t_periph(R) = gamma*log2(R) + delta``; gamma/delta are fit to the
  iso-capacity execution-time anchors (58 us @16x16 -> 150 us @256x256 for
  10k HDC queries, Fig. 9).

Latency composition per query (validated against the paper's mode ratios):

    t_query = stack * (t_periph + n_seq_search * t_search)

* ``stack`` — selective-search batches per subarray (cam-density): each
  batch is a full search+sense sub-cycle.
* ``n_seq_search`` — serialized subarray searches inside one sub-cycle:
  cam-power enables one subarray slot of an array at a time (fixed schedule
  over all S slots), sequential-access levels multiply in.
* parallel searches across arrays/mats/banks overlap; the sensing/merge
  periphery is pipelined once per sub-cycle.

Energy composition per query:

    E = sum over logical tiles of
          cols * (rows_active*e_cell + rows_programmed*e_ml)   # cell + ML/DL
        + rows_active * e_sa                                   # sensing
        + per-cycle hierarchy periphery (bank/mat/array/subarray drivers)

``rows_programmed = rows_active * stack`` under selective search: stacked
batches keep their data lines loaded, reproducing the paper's density-mode
energy crossover (cheaper at small subarrays — fewer banks — but 1.4x/5.1x
at 128/256 where parasitics dominate).  Multi-bit cells raise ML/DL voltage:
``e_cell``/``e_ml`` scale by ``multibit_energy_factor`` (paper Fig. 7b).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, asdict
from typing import Dict, Iterable, List, Optional, Sequence

from ..core.arch import ArchSpec, CamType
from ..core.passes.cam_map import MappingPlan

__all__ = ["TechParams", "CostModel", "CostReport", "FEFET_45NM"]


@dataclass(frozen=True)
class TechParams:
    """Technology constants (energies in femtojoule, times in nanoseconds)."""

    name: str = "2FeFET-45nm"
    # latency
    t_search16_ns: float = 0.86          # 16x16 anchor
    t_search_col_exp: float = 0.78       # fits 7.5 ns @ C=256
    t_periph_gamma_ns: float = 0.64      # * log2(R)
    t_periph_delta_ns: float = 2.38
    t_write_row_ns: float = 4.0          # FeFET program pulse per row
    # energy (fJ)
    e_cell_fj: float = 0.1               # per active cell per search
    e_ml_fj: float = 0.04                # ML/DL parasitic per programmed row-col
    e_sa_fj: float = 0.5                 # sense amp per active row
    # subarray periphery scales with its perimeter (row drivers + column
    # sense/encode), anchored at 32x32 — this is what keeps iso-capacity
    # configurations near-constant in energy (paper Fig. 9)
    e_sub_fj: float = 150.0              # subarray periphery @32x32 per query
    e_array_fj: float = 60.0             # array drivers per query
    e_mat_fj: float = 250.0              # mat routing per query
    e_bank_fj: float = 9000.0            # bank periphery per query

    def e_sub_scaled_fj(self, rows: int, cols: int) -> float:
        return self.e_sub_fj * (rows + cols) / 64.0
    e_write_cell_fj: float = 50.0        # FeFET program energy per cell
    # multi-bit (MCAM) factors — higher ML and DL voltages (paper IV-B)
    multibit_energy_factor: float = 2.2
    multibit_latency_factor: float = 1.15
    # analog (ACAM) sensing: ADC cost instead of SA
    acam_sense_factor: float = 3.0

    def t_search_ns(self, cols: int, cam_type: str = CamType.TCAM,
                    bits_per_cell: int = 1) -> float:
        t = self.t_search16_ns * (max(cols, 1) / 16.0) ** self.t_search_col_exp
        if bits_per_cell > 1 or cam_type == CamType.MCAM:
            t *= self.multibit_latency_factor
        return t

    def t_periph_ns(self, rows: int) -> float:
        return self.t_periph_gamma_ns * math.log2(max(rows, 2)) + self.t_periph_delta_ns


FEFET_45NM = TechParams()


@dataclass
class CostReport:
    """Latency / energy / power summary for one compiled program."""

    latency_ns: float = 0.0
    energy_fj: float = 0.0
    write_latency_ns: float = 0.0
    write_energy_fj: float = 0.0
    breakdown_fj: Dict[str, float] = field(default_factory=dict)
    search_cycles: int = 0
    queries: int = 0

    # -- derived -----------------------------------------------------------
    @property
    def latency_us(self) -> float:
        return self.latency_ns * 1e-3

    @property
    def energy_uj(self) -> float:
        return self.energy_fj * 1e-9

    @property
    def power_w(self) -> float:
        # fJ / ns == microwatt*1e0 ... (1e-15 J / 1e-9 s) = 1e-6 W
        return (self.energy_fj / max(self.latency_ns, 1e-12)) * 1e-6

    @property
    def edp_nj_s(self) -> float:
        # energy (nJ) * latency (s)
        return (self.energy_fj * 1e-6) * (self.latency_ns * 1e-9)

    def merged_with(self, other: "CostReport") -> "CostReport":
        br = dict(self.breakdown_fj)
        for k, v in other.breakdown_fj.items():
            br[k] = br.get(k, 0.0) + v
        return CostReport(
            latency_ns=self.latency_ns + other.latency_ns,
            energy_fj=self.energy_fj + other.energy_fj,
            write_latency_ns=self.write_latency_ns + other.write_latency_ns,
            write_energy_fj=self.write_energy_fj + other.write_energy_fj,
            breakdown_fj=br,
            search_cycles=self.search_cycles + other.search_cycles,
            queries=self.queries + other.queries)

    def as_dict(self) -> Dict[str, float]:
        return {"latency_us": self.latency_us, "energy_uj": self.energy_uj,
                "power_w": self.power_w, "edp_nj_s": self.edp_nj_s,
                "search_cycles": self.search_cycles, "queries": self.queries,
                **{f"e_{k}_fj": v for k, v in self.breakdown_fj.items()}}


class CostModel:
    """Evaluates MappingPlans against :class:`TechParams`."""

    def __init__(self, arch: ArchSpec, tech: TechParams = FEFET_45NM):
        self.arch = arch
        self.tech = tech

    # ------------------------------------------------------------------
    def plan_report(self, plan: MappingPlan) -> CostReport:
        a, t = plan.arch, self.tech
        mb = a.bits_per_cell > 1 or a.cam_type == CamType.MCAM
        e_scale = t.multibit_energy_factor if mb else 1.0
        sense_scale = t.acam_sense_factor if a.cam_type == CamType.ACAM else 1.0

        t_search = t.t_search_ns(a.cols, a.cam_type, a.bits_per_cell)
        t_periph = t.t_periph_ns(a.rows)

        # ---- sequential search factor inside one sub-cycle -------------
        arrays_used = max(1, math.ceil(plan.physical_subarrays / a.subarrays_per_array))
        mats_used = max(1, math.ceil(arrays_used / a.arrays_per_mat))
        if a.max_active_subarrays == 1:
            # cam-power: fixed one-slot-at-a-time schedule over the S slots
            sub_factor = a.subarrays_per_array
        elif a.max_active_subarrays > 1:
            sub_factor = math.ceil(a.subarrays_per_array / a.max_active_subarrays)
        elif a.access["subarray"] == "sequential":
            sub_factor = min(a.subarrays_per_array, plan.physical_subarrays)
        else:
            sub_factor = 1
        lvl_factor = 1
        if a.access["array"] == "sequential":
            lvl_factor *= min(a.arrays_per_mat, arrays_used)
        if a.access["mat"] == "sequential":
            lvl_factor *= min(a.mats_per_bank, mats_used)
        if a.access["bank"] == "sequential":
            lvl_factor *= plan.banks_used
        n_seq = sub_factor * lvl_factor

        t_query_ns = plan.stack * (t_periph + n_seq * t_search)
        latency_ns = plan.m_queries * plan.rounds * t_query_ns

        # ---- energy ------------------------------------------------------
        rows_act = plan.rows_active_per_search
        rows_prog = min(a.rows, rows_act * plan.stack)
        cols = a.cols
        per_tile = (cols * (rows_act * t.e_cell_fj + rows_prog * t.e_ml_fj) * e_scale
                    + rows_act * t.e_sa_fj * sense_scale)
        e_cells = plan.searches * per_tile
        # hierarchy periphery: drivers/routing of the *provisioned* units fire
        # once per query (stacked sub-cycles reuse the charged periphery, so
        # cam-density's fewer subarrays/banks save energy — paper Fig. 8a)
        cycles = plan.m_queries * plan.rounds * plan.stack
        queries = plan.m_queries * plan.rounds
        e_hier = queries * (plan.banks_used * t.e_bank_fj
                            + mats_used * t.e_mat_fj
                            + arrays_used * t.e_array_fj
                            + plan.physical_subarrays
                            * t.e_sub_scaled_fj(a.rows, a.cols))
        e_search_total = e_cells + e_hier

        # ---- one-time writes (program the CAM) ---------------------------
        w_lat = plan.rounds * plan.stack * rows_act * t.t_write_row_ns
        w_en = (plan.logical_tiles * rows_act * cols * t.e_write_cell_fj
                * e_scale * plan.rounds)

        return CostReport(
            latency_ns=latency_ns + w_lat,
            energy_fj=e_search_total + w_en,
            write_latency_ns=w_lat,
            write_energy_fj=w_en,
            breakdown_fj={"cells": e_cells, "hierarchy": e_hier, "write": w_en},
            search_cycles=int(cycles * n_seq),
            queries=plan.m_queries)

    def report(self, plans: Sequence[MappingPlan]) -> CostReport:
        total = CostReport()
        for p in plans:
            total = total.merged_with(self.plan_report(p))
        return total
