"""Failure-recovery supervisor (the port of the reference's
``distributed/recovery.py``).

``Supervisor.run`` wraps the train loop body:

* catches step failures (raised exceptions, injected ``SimulatedFailure``,
  and NaN / Inf loss — the "silent" failure mode),
* restores the newest checkpoint and replays the data stream to the
  restored step (the loader's state is one integer),
* enforces a retry budget.

A restore builds the state anew from the checkpoint into the current
state's structure, devices and dtypes (``restore_pytree``): a state the
failed step had half updated in place is replaced whole.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from ..checkpoint import AsyncCheckpointer, latest_step, restore_pytree

__all__ = ["RecoveryConfig", "SimulatedFailure", "Supervisor"]


class SimulatedFailure(RuntimeError):
    """Injected fault (stands in for a lost card or a preemption)."""


@dataclass(frozen=True)
class RecoveryConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 3
    nan_is_failure: bool = True
    keep: int = 3


@dataclass
class Supervisor:
    cfg: RecoveryConfig
    restarts: int = 0
    log: list = field(default_factory=list)

    def __post_init__(self):
        self.ckpt = AsyncCheckpointer(self.cfg.ckpt_dir, keep=self.cfg.keep)

    # ------------------------------------------------------------------
    def maybe_save(self, state: Any, step: int,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        if step % self.cfg.ckpt_every == 0 and step > 0:
            self.ckpt.save(state, step, extra)

    def check_health(self, metrics: Dict[str, Any]) -> None:
        if not self.cfg.nan_is_failure:
            return
        loss = metrics.get("loss")
        if loss is not None and not math.isfinite(float(loss)):
            raise SimulatedFailure(f"non-finite loss {loss!r}")

    def restore(self, template: Any) -> Tuple[Any, int]:
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint to restore under {self.cfg.ckpt_dir}")
        return restore_pytree(template, self.cfg.ckpt_dir, step), step

    # ------------------------------------------------------------------
    def run(self, state: Any, n_steps: int,
            step_fn: Callable[[Any, int], Tuple[Any, Dict[str, Any]]],
            start_step: int = 0,
            on_metrics: Optional[Callable[[int, Dict[str, Any]], None]] = None
            ) -> Tuple[Any, Dict[str, Any]]:
        """Supervised loop: ``step_fn(state, step)`` with auto-recovery."""
        step = start_step
        last_metrics: Dict[str, Any] = {}
        while step < n_steps:
            try:
                new_state, metrics = step_fn(state, step)
                self.check_health(metrics)
                state = new_state
                last_metrics = metrics
                step += 1
                self.maybe_save(state, step)
                if on_metrics:
                    on_metrics(step, metrics)
            except (SimulatedFailure, FloatingPointError) as e:
                self.restarts += 1
                self.log.append({"step": step, "error": repr(e),
                                 "restart": self.restarts})
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"retry budget exhausted after {self.restarts - 1} "
                        f"restarts") from e
                self.ckpt.wait()
                state, step = self.restore(state)
                self.log.append({"restored_to": step})
        self.ckpt.wait()
        return state, last_metrics
