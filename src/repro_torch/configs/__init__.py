"""Architecture config registry.

``get(name)`` -> full published config; ``get_smoke(name)`` -> reduced
same-family config for CPU smoke tests.

This slice of the package runs the dense florbench-100m model only; the
other architectures of the reference registry arrive with their model
families (ROADMAP queue 1, item 11).
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

ARCHS: list[str] = []

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
