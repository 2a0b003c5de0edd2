"""Architecture config registry.

``get_config(arch)`` returns the full (paper-exact) ModelConfig;
``get_reduced(arch)`` the CPU-smoke shrink. ``ARCHS`` lists all assigned ids.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, RunConfig,
    SHAPES, SHAPES_BY_NAME, reduced,
)

_MODULES: Dict[str, str] = {
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_reduced(arch: str, **kw) -> ModelConfig:
    return reduced(get_config(arch), **kw)


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES_BY_NAME:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES_BY_NAME)}")
    return SHAPES_BY_NAME[name]


def cells(include_skips: bool = False):
    """Yield (arch, shape, skip_reason|None) for the 40 assigned cells."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            skip = None
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                skip = "skip:full-attn (sub-quadratic attention required)"
            if skip is None or include_skips:
                yield arch, shape, skip


__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "RunConfig",
    "SHAPES", "SHAPES_BY_NAME", "ARCHS",
    "get_config", "get_reduced", "get_shape", "cells", "reduced",
]
