"""Assigned-architecture registry: ``get_config("<arch-id>")``.

One module per architecture with the exact published configuration
(``[source; verified-tier]`` noted per file).  ``ARCHS`` maps arch id ->
module; every module exposes ``CONFIG`` (full) and ``smoke_config()``
(reduced, CPU-runnable).
"""

from importlib import import_module
from typing import Dict, List

from ..models.config import ModelConfig, reduced

_MODULES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "mistral-large-123b": "mistral_large_123b",
    "qwen2.5-14b": "qwen2p5_14b",
    "qwen1.5-32b": "qwen1p5_32b",
    "chatglm3-6b": "chatglm3_6b",
    "xlstm-125m": "xlstm_125m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe_42b",
    "paligemma-3b": "paligemma_3b",
    "whisper-medium": "whisper_medium",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return import_module(f".{_MODULES[arch]}", __package__).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "ModelConfig"]
