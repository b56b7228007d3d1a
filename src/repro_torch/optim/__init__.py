"""AdamW and learning-rate schedules (the port of the reference's
``optim/``).

AdamW with decoupled weight decay, float32 master weights, global-norm
clipping, and warmup + cosine / linear schedules.  The optimizer state
mirrors the parameter tree: dicts of tensors, one leaf per parameter.
"""

from .adamw import AdamWConfig, OptState, adamw_init, adamw_update, \
    clip_by_global_norm, global_norm
from .schedule import Schedule, constant, warmup_cosine, warmup_linear

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "Schedule",
           "warmup_cosine", "warmup_linear", "constant"]
