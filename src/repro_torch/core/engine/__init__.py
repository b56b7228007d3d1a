"""Search-plan execution engine: compiled, cached execution of ``cim`` IR.

The package follows the reference's layering:

* :mod:`.spec` — the frozen plan specs (:class:`SimilaritySpec`,
  :class:`RangeSpec`), the structural IR analysis
  (:func:`extract_plan_spec`, :func:`extract_range_spec`) and its
  inverse (:func:`module_for_spec`).
* :mod:`.base` — :class:`PlanBase`: micro-batched dispatch, the
  pattern-prep memo and the ``update_rows`` relay.
* :mod:`.executables` — the ``"torch"`` (eager reference-tiled) and
  ``"cuda"`` (hand-written kernels) backends.
* :mod:`.plans` — the leaf families :class:`SearchPlan` (top-k) and
  :class:`RangePlan` (boolean threshold / aCAM interval match).
* :mod:`.cache` — the process-wide plan cache behind :func:`get_plan` /
  :func:`plan_cache_stats` / :func:`clear_plan_cache`.
* :mod:`.composite` — the plan-graph layer: :class:`CompositePlan`
  (plans built from other plans) and :class:`HierarchicalSpec`.
* :mod:`.hier` — :class:`HierarchicalPlan`: IVF-style two-stage search
  (coarse centroid ``SearchPlan`` -> fine probing of the selected
  cluster tiles), built via :func:`get_hierarchical_plan`.

Fault injection rides on dispatch (``faults=``, see
:mod:`repro_torch.faults`); ``shards=`` splits a ``"torch"`` plan's row
tiles over :func:`repro_torch.launch.mesh.make_data_mesh`'s devices.
"""

from .base import (PendingSearch, PlanBase, _as_2d, _pick_batch,
                   _update_enabled, resolve_device)
from .cache import clear_plan_cache, get_plan, plan_cache_stats
from .composite import CompositePlan, HierarchicalSpec
from .hier import HierarchicalPlan, get_hierarchical_plan
from .plans import RangePlan, SearchPlan
from .spec import (RangeSpec, SimilaritySpec, _bits, _check_binary_cells,
                   _encode, _metric_values, _resolve_pack, extract_plan_spec,
                   extract_range_spec, module_for_spec, spec_digest,
                   spec_fingerprint)

__all__ = [
    "SimilaritySpec", "RangeSpec", "HierarchicalSpec", "PlanBase",
    "SearchPlan", "RangePlan", "CompositePlan", "HierarchicalPlan",
    "PendingSearch", "extract_plan_spec", "extract_range_spec", "get_plan",
    "get_hierarchical_plan", "resolve_device", "plan_cache_stats",
    "clear_plan_cache", "spec_digest", "spec_fingerprint", "module_for_spec",
]
