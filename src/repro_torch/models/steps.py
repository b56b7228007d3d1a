"""Serve steps (the port of the reference's ``models/steps.py``, serve
part): plain callables in place of the functions the reference jits.
The train step comes with the optimizer (ROADMAP Queue A item 8)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from . import model as model_mod
from .config import ModelConfig

Params = Dict[str, Any]

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params: Params, batch: Dict[str, torch.Tensor],
                     cache: Params):
        return model_mod.prefill(params, cfg, batch, cache)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params: Params, tokens: torch.Tensor, cache: Params):
        return model_mod.decode_step(params, cfg, tokens, cache)
    return decode_step
