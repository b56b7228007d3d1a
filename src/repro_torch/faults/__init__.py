"""Device-fault injection and hardening for CAM plans.

``FaultModel`` (:mod:`repro_torch.faults.model`, a copy of the reference
package's numpy model, so both corrupt the same cells) is the seeded,
deterministic fault generator every plan accepts at dispatch time
(``plan.execute(..., faults=model)``); ``HardenedPlan``
(:mod:`repro_torch.faults.harden`) wraps a plan with replication,
checksum-readback self-healing, and aCAM guard bands.
"""

from .harden import (HardenedPlan, HealReport, detect_faulty_rows,
                     row_checksums)
from .model import FaultModel

__all__ = ["FaultModel", "HardenedPlan", "HealReport", "row_checksums",
           "detect_faulty_rows"]
