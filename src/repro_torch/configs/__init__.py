"""Architecture config registry.

``get(name)`` -> full published config; ``get_smoke(name)`` -> reduced
same-family config for CPU smoke tests.

``ARCHS`` holds the reference registry's architectures whose model family
the package runs (dense, vlm, moe), in the reference's order; the others
(falcon-mamba-7b, deepseek-v3-671b, zamba2-7b, seamless-m4t-large-v2)
arrive with their families (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401  (re-exports)
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    SSMConfig,
    ShapeSpec,
    LONG_CONTEXT_OK,
    cell_applicable,
)

ARCHS = [
    "granite-3-2b",
    "minitron-4b",
    "gemma-2b",
    "qwen3-14b",
    "mixtral-8x7b",
    "llava-next-mistral-7b",
]

# extra (non-assigned) configs: the paper-scale end-to-end example model
EXTRA = ["florbench-100m"]


def _module(name: str):
    return importlib.import_module("repro_torch.configs."
                                   + name.replace("-", "_"))


def get(name: str) -> ModelConfig:
    if name not in ARCHS + EXTRA:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS + EXTRA}")
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    if name not in ARCHS + EXTRA:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS + EXTRA}")
    return _module(name).SMOKE


def list_archs() -> list[str]:
    return list(ARCHS)
