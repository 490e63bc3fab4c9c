"""Architecture registry: the 10 architectures of the JAX package's configs.

Plain data. All ten build, run forward and train in the port
(``models.lm.LM``); the cache modes of serving raise
``NotImplementedError`` (``models.blocks.check_ported``).
"""
from __future__ import annotations

import importlib
from typing import Dict

from .base import SHAPES, ModelConfig, ShapeSpec, input_specs, shape_applicable, sub_quadratic  # noqa: F401

ARCHS = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-14b": "qwen3_14b",
    "gemma3-4b": "gemma3_4b",
    "minicpm3-4b": "minicpm3_4b",
    "qwen2-0.5b": "qwen2_0_5b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mamba2-2.7b": "mamba2_2_7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"{__name__}.{ARCHS[name]}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {name: get_config(name, smoke) for name in ARCHS}
