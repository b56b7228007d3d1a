"""C4CAM compile driver (paper Fig. 3) on PyTorch.

``compile_module`` runs the progressive-lowering pipeline::

    torch IR --torch-to-cim--> cim IR --cim-fuse-ops + similarity-match-->
    fused cim --cim-partition--> partitioned cim --cim-to-cam--> cam IR
    --cam-map--> mapped cam IR (+ MappingPlans)

and returns a :class:`CompiledCamProgram` bundling every IR snapshot,
the :class:`~repro_torch.core.passes.cam_map.MappingPlan`s, a cost report
from the Eva-CAM-analog model (:mod:`repro_torch.camsim`), and — for pure
similarity programs — a cached :class:`~repro_torch.core.engine.SearchPlan`
that executes the search.

``backend="cuda"`` (the default) runs the hand-written Hopper kernels;
``backend="torch"`` the eager reference-tiled tournament.  ``device=None``
means the GPU and raises where CUDA is absent; pass ``device="cpu"`` to
run on the CPU (the ``"cuda"`` backend then runs the kernels' plain
versions).  Programs without an engine plan need the IR interpreter
(``core/executor.py``), which a later slice of the port brings; calling
them raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .arch import ArchSpec, CamType
from .engine import PlanBase, get_plan, resolve_device
from .ir import Module, PassManager
from .passes import (CamMap, CimToCam, CompulsoryPartition, FuseExecuteBlocks,
                     SimilarityMatching, TorchToCim)
from .passes.cam_map import MappingPlan
from .torch_dialect import trace

__all__ = ["CompiledCamProgram", "compile_module", "compile_fn", "C4CAMCompiler"]

_NO_INTERPRETER = (
    "this program has no engine plan (it is not a pure similarity search) "
    "and needs the op-by-op IR interpreter, core/executor.py, which is not "
    "ported to repro_torch yet")


@dataclass
class CompiledCamProgram:
    """The artifact returned by C4CAM compilation."""

    arch: ArchSpec
    cam_type: str
    stages: Dict[str, Module]
    snapshots: List[Tuple[str, str]]
    plans: List[MappingPlan]
    matched_patterns: List[str]
    backend: str = "cuda"
    engine_plan: Optional[PlanBase] = None
    shards: int = 1

    def __call__(self, *inputs):
        """Execute the program through its compiled search plan:
        ``(values float32, indices int32)`` tensors on the plan's device."""
        if self.engine_plan is None:
            raise NotImplementedError(_NO_INTERPRETER)
        return self.engine_plan.execute(*inputs)

    def execute_interpreted(self, *inputs):
        """Op-by-op interpretation of the partitioned IR."""
        raise NotImplementedError(_NO_INTERPRETER)

    def execute_unplanned(self, *inputs):
        """The interpreter walk with the configured backend."""
        raise NotImplementedError(_NO_INTERPRETER)

    def cost_report(self):
        from ..camsim import CostModel
        cm = CostModel(self.arch)
        return cm.report(self.plans)

    def dump(self, stage: str = "cam_mapped") -> str:
        return self.stages[stage].dump()


def compile_module(module: Module, arch: ArchSpec, *,
                   cam_type: str = CamType.TCAM,
                   target: Optional[str] = None,
                   unroll_limit: int = 64,
                   value_bits: Optional[int] = None,
                   backend: str = "cuda",
                   shards: Optional[int] = None,
                   pack: Optional[bool] = None,
                   device=None) -> CompiledCamProgram:
    dev = resolve_device(device)
    if target is not None:
        arch = arch.with_target(target)
    ctx: Dict[str, Any] = {"arch": arch, "value_bits": value_bits}
    stages: Dict[str, Module] = {"torch": module}

    pm1 = PassManager()
    pm1.add(TorchToCim())
    m = pm1.run(module.clone(), ctx)
    stages["cim"] = m.clone()

    pm2 = PassManager()
    pm2.add(FuseExecuteBlocks()).add(SimilarityMatching())
    m = pm2.run(m, ctx)
    stages["cim_fused"] = m.clone()

    pm3 = PassManager()
    pm3.add(CompulsoryPartition(unroll_limit=unroll_limit))
    m = pm3.run(m, ctx)
    stages["cim_partitioned"] = m.clone()

    pm4 = PassManager()
    pm4.add(CimToCam(cam_type=cam_type))
    m = pm4.run(m, ctx)
    stages["cam"] = m.clone()

    pm5 = PassManager(verify_each=False)   # mapped IR is loop-structured
    pm5.add(CamMap())
    m = pm5.run(m, ctx)
    stages["cam_mapped"] = m

    snapshots = (pm1.snapshots + pm2.snapshots[1:] + pm3.snapshots[1:]
                 + pm4.snapshots[1:] + pm5.snapshots[1:])
    engine_plan = get_plan(stages["cim_partitioned"], backend=backend,
                           shards=shards, pack=pack, device=dev)
    return CompiledCamProgram(
        arch=arch, cam_type=cam_type, stages=stages, snapshots=snapshots,
        plans=ctx.get("plans", []),
        matched_patterns=ctx.get("matched_patterns", []),
        backend=backend, engine_plan=engine_plan,
        shards=engine_plan.shards if engine_plan is not None else 1)


def compile_fn(fn: Callable, example_inputs: Sequence[Any], arch: ArchSpec,
               **kw) -> CompiledCamProgram:
    """Trace a TorchScript-like callable and compile it (end-to-end path).
    ``example_inputs`` may be numpy arrays, tensors or shape tuples."""
    return compile_module(trace(fn, example_inputs), arch, **kw)


class C4CAMCompiler:
    """Object-style front door mirroring the paper's tool (arch spec + app)."""

    def __init__(self, arch: ArchSpec, cam_type: str = CamType.TCAM,
                 backend: str = "cuda", shards: Optional[int] = None,
                 device=None):
        self.arch = arch
        self.cam_type = cam_type
        self.backend = backend
        self.shards = shards
        self.device = device

    def compile(self, fn: Callable, example_inputs: Sequence[Any],
                target: Optional[str] = None, **kw) -> CompiledCamProgram:
        kw.setdefault("shards", self.shards)
        kw.setdefault("device", self.device)
        return compile_fn(fn, example_inputs, self.arch,
                          cam_type=self.cam_type, target=target,
                          backend=self.backend, **kw)
