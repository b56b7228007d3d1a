"""One process's loader with O(1) resumable state (the port of the
reference's ``data/loader.py``).

The reference slices each global batch by host (``process_index`` /
``process_count``) and may place it with a ``NamedSharding``; the port
builds the whole global batch in every process (it is a pure function of
the step, cheap to make), so ``host_slice`` is the identity; a batch is
placed on the loader's ``device``, and with ``sharding`` (a
:class:`..models.sharding.ShardingRules` over a ``DeviceMesh``) each
leaf becomes a DTensor sharded over the batch axes, each rank keeping
its own rows.  The state is the integer
``step``: batch content is a pure function of (seed, step), so a
restore replays exactly the batches it would have seen.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

__all__ = ["ShardedLoader"]


@dataclass
class ShardedLoader:
    """Wraps a ``batch(i) -> dict`` source (e.g. ``TokenStream``).  With a
    ``device``, batches are tensors there (integer arrays as int64, the
    index dtype of the embedding); without, the source's numpy arrays."""

    source: Any
    device: Optional[Any] = None
    step: int = 0
    sharding: Optional[Any] = None

    def host_slice(self, arr: np.ndarray) -> np.ndarray:
        return arr                      # one process holds the whole batch

    def place(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        out = {}
        for k, v in batch.items():
            local = self.host_slice(v)
            if self.device is not None:
                t = torch.from_numpy(np.ascontiguousarray(local))
                if not t.is_floating_point():
                    t = t.long()
                local = t.to(self.device)
                if self.sharding is not None:
                    local = _shard_rows(self.sharding, local)
            out[k] = local
        return out

    def batch(self, step: int) -> Dict[str, Any]:
        """The placed batch of ``step`` (the loader's own step stays)."""
        return self.place(self.source.batch(step))

    def next(self) -> Dict[str, Any]:
        out = self.batch(self.step)
        self.step += 1
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        while True:
            yield self.next()

    # -- checkpointable state -------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    def load_state_dict(self, d: Dict[str, int]) -> None:
        self.step = int(d["step"])


def _shard_rows(rules, t: torch.Tensor):
    """``t`` (the whole batch on every rank) as a DTensor sharded over
    the rules' batch axes (``launch.specs.batch_sharding``)."""
    from torch.distributed.tensor import distribute_tensor
    pl = rules.placements(("batch",) + (None,) * (t.dim() - 1),
                          tuple(t.shape))
    return distribute_tensor(t, rules.mesh, pl, src_data_rank=None)
