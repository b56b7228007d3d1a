"""Search-plan execution engine: compiled, cached execution of ``cim`` IR.

The package follows the reference's layering:

* :mod:`.spec` — the frozen plan spec (:class:`SimilaritySpec`) and the
  structural IR analysis (:func:`extract_plan_spec`).
* :mod:`.base` — :class:`PlanBase`: micro-batched dispatch and the
  pattern-prep memo.
* :mod:`.executables` — the ``"torch"`` (eager reference-tiled) and
  ``"cuda"`` (hand-written kernels) backends.
* :mod:`.plans` — the leaf family :class:`SearchPlan` (top-k).
* :mod:`.cache` — the process-wide plan cache behind :func:`get_plan` /
  :func:`plan_cache_stats` / :func:`clear_plan_cache`.

Range plans, composite and hierarchical plans, sharding, gallery
mutation and fault injection come with later slices of the port.
"""

from .base import PendingSearch, PlanBase, _as_2d, _pick_batch, resolve_device
from .cache import clear_plan_cache, get_plan, plan_cache_stats
from .plans import SearchPlan
from .spec import (SimilaritySpec, _bits, _check_binary_cells, _encode,
                   _metric_values, _resolve_pack, extract_plan_spec,
                   spec_digest, spec_fingerprint)

__all__ = [
    "SimilaritySpec", "PlanBase", "SearchPlan", "PendingSearch",
    "extract_plan_spec", "get_plan", "resolve_device", "plan_cache_stats",
    "clear_plan_cache", "spec_digest", "spec_fingerprint",
]
