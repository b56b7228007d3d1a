"""Learning-rate schedules as pure step -> lr callables (the reference's
``optim/schedule.py``): ``step`` is an int, the result a Python float
computed in float32, as the reference's ``jnp.float32`` arithmetic."""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], float]

__all__ = ["Schedule", "warmup_cosine", "warmup_linear", "constant"]

_F = np.float32


def constant(lr: float) -> Schedule:
    return lambda step: float(_F(lr))


def warmup_linear(lr: float, warmup: int, total: int,
                  floor: float = 0.0) -> Schedule:
    def fn(step):
        s = _F(step) + _F(1.0)
        warm = s / _F(max(warmup, 1))
        decay = _F(1.0) - (s - _F(warmup)) / _F(max(total - warmup, 1))
        return float(_F(lr) * np.clip(min(warm, decay), _F(floor / lr),
                                      _F(1.0)))
    return fn


def warmup_cosine(lr: float, warmup: int, total: int,
                  floor_frac: float = 0.1) -> Schedule:
    def fn(step):
        s = _F(step) + _F(1.0)
        warm = s / _F(max(warmup, 1))
        prog = np.clip((s - _F(warmup)) / _F(max(total - warmup, 1)),
                       _F(0.0), _F(1.0))
        cos = _F(floor_frac) + _F(1 - floor_frac) * _F(0.5) * (
            _F(1.0) + _F(math.cos(math.pi * float(prog))))
        return float(_F(lr) * (warm if s < warmup else cos))
    return fn
