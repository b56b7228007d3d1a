"""CAM device simulation: Eva-CAM-analog cost model + GPU baseline model.

`repro_torch.camsim` plays the role of the paper's extended simulation
infrastructure (§IV-A2): it models the architecture, estimates performance
and energy from the compiler's :class:`~repro_torch.core.passes.cam_map.MappingPlan`,
supports different underlying CAM designs (TCAM binary / MCAM multi-bit /
ACAM analog), and performs chip-level estimation including peripherals.
"""

from .cost import TechParams, CostModel, CostReport, FEFET_45NM
from .gpu import CIM_SYSTEM, CimSystemModel, GpuModel, QUADRO_RTX_6000

__all__ = ["TechParams", "CostModel", "CostReport", "FEFET_45NM",
           "GpuModel", "QUADRO_RTX_6000", "CimSystemModel", "CIM_SYSTEM"]
