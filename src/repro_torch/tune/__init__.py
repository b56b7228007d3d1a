"""Plan autotuning + persistent plan store.

Two pieces, usable separately but designed together:

* :mod:`.tuner` — :func:`tune_plan`: greedy coordinate-descent search
  over the engine's plan knobs (tile geometry, micro-batch, packing,
  shard count), measuring real executions and keeping the fastest
  *verified* candidate.
* :mod:`.store` — :class:`PlanStore`: a directory (``REPRO_PLAN_STORE``)
  persisting winning configs, so a fresh process skips the search.  The
  kernels' compiled libraries persist on their own
  (:mod:`repro_torch.kernels.build`).

Typical flows::

    from repro_torch.tune import tune_plan
    res = tune_plan(module, queries, gallery)   # searches, maybe persists
    res.plan.execute(queries, gallery)

    # cold start in a later process (REPRO_PLAN_STORE set):
    res = tune_plan(module, queries, gallery)   # res.trials == 0
"""

from .store import (PlanStore, active_store, plan_store_stats,
                    reset_plan_store_stats)
from .tuner import (TuneResult, plan_for_config, reset_tune_stats, tune_plan,
                    tune_stats, warm_start_plan)

__all__ = [
    "PlanStore", "active_store", "plan_store_stats",
    "reset_plan_store_stats",
    "TuneResult", "plan_for_config", "tune_plan", "tune_stats",
    "reset_tune_stats", "warm_start_plan",
]
