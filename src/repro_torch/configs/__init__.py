"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

Counterpart of ``repro.configs``.  Arch ids use the published spelling
(dashes/dots); module names are the pythonified equivalents.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    shape_applicable,
    smoke_config,
)

_ARCH_MODULES: Dict[str, str] = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "arctic-480b": "arctic_480b",
    "whisper-medium": "whisper_medium",
    "gemma2-2b": "gemma2_2b",
    "gemma3-27b": "gemma3_27b",
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen2.5-14b": "qwen2_5_14b",
    "pixtral-12b": "pixtral_12b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "xlstm-350m": "xlstm_350m",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {list(SHAPES)}")
    return SHAPES[name]
