"""Straggler detection: per-step deadline monitor with robust statistics
(the port of the reference's ``distributed/straggler.py``).

A step's time is taken to a ``torch.cuda.synchronize`` when the monitor's
``device`` is a CUDA device: the card runs behind the host, so the host
clock alone would time the enqueue.  At 1000+ nodes the common failure mode is not crashes but *slow* steps
(thermal throttling, a flaky HBM stack, background daemons).  The monitor
keeps an exponential moving average and a median-absolute-deviation window
of step wall-times; a step exceeding ``ema + z * 1.4826 * MAD`` (or the
hard deadline) is flagged.  Hooks:

* ``on_straggle(step, dt, stats)`` — logging / paging;
* ``suggest_rebalance()`` — when a *persistent* slow rank is detected the
  caller may shrink that rank's microbatch share (the train loop re-slices
  its per-host batch); here this returns the recommended fraction.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

import torch

__all__ = ["StragglerMonitor"]


@dataclass
class StragglerMonitor:
    window: int = 32
    z_threshold: float = 4.0
    hard_deadline_s: float = 0.0          # 0 = none
    ema_alpha: float = 0.1
    on_straggle: Optional[Callable[[int, float, Dict[str, float]], None]] = None
    device: Optional[Any] = None          # a CUDA device: sync at stop

    _times: Deque[float] = field(default_factory=collections.deque)
    _ema: float = 0.0
    _t0: float = 0.0
    baseline_median: float = 0.0      # frozen after the first full window
    slow_steps: List[int] = field(default_factory=list)
    step_count: int = 0

    def _sync(self) -> None:
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self._sync()
        dt = time.perf_counter() - self._t0
        self.record(dt)
        return dt

    def record(self, dt: float) -> bool:
        """Returns True when the step is flagged as a straggler."""
        self.step_count += 1
        stats = self.stats()
        slow = False
        if len(self._times) >= 8:
            # MAD floor of 2% of the median: identical step times otherwise
            # make the bound degenerate and flag ordinary jitter.
            mad = max(stats["mad"], 0.02 * stats["median"])
            bound = stats["median"] + self.z_threshold * 1.4826 * mad
            slow = dt > bound
        if self.hard_deadline_s and dt > self.hard_deadline_s:
            slow = True
        self._ema = dt if not self._ema else \
            (1 - self.ema_alpha) * self._ema + self.ema_alpha * dt
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.popleft()
        if not self.baseline_median and len(self._times) >= self.window:
            self.baseline_median = stats["median"]
        if slow:
            self.slow_steps.append(self.step_count)
            if self.on_straggle:
                self.on_straggle(self.step_count, dt, stats)
        return slow

    def stats(self) -> Dict[str, float]:
        ts = sorted(self._times)
        if not ts:
            return {"median": 0.0, "mad": 0.0, "ema": self._ema}
        median = ts[len(ts) // 2]
        mad = sorted(abs(t - median) for t in ts)[len(ts) // 2]
        return {"median": median, "mad": mad, "ema": self._ema}

    def suggest_rebalance(self) -> float:
        """Fraction of the nominal microbatch this rank should keep.

        Compares the smoothed current step time (EMA) against the frozen
        healthy baseline; a persistent >20% slowdown suggests shedding load
        proportional to it (one-off spikes barely move the EMA)."""
        if not self.baseline_median or self._ema <= 0:
            return 1.0
        if self._ema < 1.2 * self.baseline_median:
            return 1.0
        return max(0.5, min(1.0, self.baseline_median / self._ema))
