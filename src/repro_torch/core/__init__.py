"""C4CAM core on PyTorch: the paper's compiler and its search engine.

Public API::

    from repro_torch.core import (ArchSpec, C4CAMCompiler, compile_fn, trace,
                                  CamType, OptimizationTarget, PAPER_BASE_ARCH)

    arch = PAPER_BASE_ARCH.with_target("power")
    prog = compile_fn(hdc_similarity, [queries, classes], arch)  # on the GPU
    values, indices = prog(queries, classes)     # hand-written CUDA kernels
    report = prog.cost_report()                  # latency / energy / power
"""

from .arch import (AccessMode, ArchSpec, CamType, Metric, OptimizationTarget,
                   PAPER_BASE_ARCH, SearchType, kazemi_arch)
from .compiler import C4CAMCompiler, CompiledCamProgram, compile_fn, compile_module
from .engine import (CompositePlan, HierarchicalPlan, HierarchicalSpec,
                     PendingSearch, PlanBase, RangePlan, RangeSpec,
                     SearchPlan, SimilaritySpec, clear_plan_cache,
                     extract_range_spec, get_hierarchical_plan, get_plan,
                     plan_cache_stats, spec_digest, workload_digest)
from .ir import Block, Builder, IRError, Module, Operation, Pass, PassManager, TensorType, Value, verify
from .torch_dialect import TracedTensor, trace

__all__ = [
    "AccessMode", "ArchSpec", "CamType", "Metric", "OptimizationTarget",
    "PAPER_BASE_ARCH", "SearchType", "kazemi_arch",
    "C4CAMCompiler", "CompiledCamProgram", "compile_fn", "compile_module",
    "CompositePlan", "HierarchicalPlan", "HierarchicalSpec",
    "PendingSearch", "PlanBase", "RangePlan", "RangeSpec", "SearchPlan",
    "SimilaritySpec", "extract_range_spec",
    "clear_plan_cache", "get_hierarchical_plan", "get_plan",
    "plan_cache_stats", "spec_digest", "workload_digest",
    "Block", "Builder", "IRError", "Module", "Operation", "Pass",
    "PassManager", "TensorType", "Value", "verify",
    "TracedTensor", "trace",
]
