"""C4CAM transformation passes (paper §III-D).

Pipeline order (see `repro_torch.core.compiler`):

1. ``TorchToCim``      — torch ops -> per-op acquire/execute/release blocks
2. ``FuseExecuteBlocks`` + ``SimilarityMatching`` — Algorithm 1
3. ``CompulsoryPartition`` — tile to subarray granularity, merge_partial
4. ``CimToCam``        — device allocation + write/search/read lowering
5. ``CamMap``          — nested scf.parallel hierarchy mapping + MappingPlan
"""

from .torch_to_cim import TorchToCim
from .fuse_similarity import FuseExecuteBlocks, SimilarityMatching
from .partition import CompulsoryPartition
from .cim_to_cam import CimToCam
from .cam_map import CamMap, MappingPlan

__all__ = ["TorchToCim", "FuseExecuteBlocks", "SimilarityMatching",
           "CompulsoryPartition", "CimToCam", "CamMap", "MappingPlan"]
