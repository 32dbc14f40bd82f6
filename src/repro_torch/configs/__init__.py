"""Architecture config registry.

``get(name)`` -> full published config; ``get_smoke(name)`` -> reduced
same-family config for CPU smoke tests.

``ARCHS`` holds the reference registry's ten architectures in its order;
``with_layers(cfg, n)`` cuts a config's depth and keeps its widths.
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
    "falcon-mamba-7b",
    "deepseek-v3-671b",
    "mixtral-8x7b",
    "zamba2-7b",
    "seamless-m4t-large-v2",
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


def with_layers(cfg: ModelConfig, n: int) -> ModelConfig:
    """``cfg`` cut to ``n`` layers, widths unchanged (the launchers'
    ``--layers``). An encoder-decoder cuts its encoder and its decoder to
    ``n`` each. A MoE config keeps its leading dense layers, so at ``n ==
    first_dense_layers`` its MoE stack has length zero (the reference
    builds the same tree); a hybrid keeps whole groups of ``attn_period``
    blocks and a tail of ``n % attn_period``."""
    if cfg.num_decoder_layers:
        return cfg.replace(num_layers=n, num_decoder_layers=n)
    return cfg.replace(num_layers=n)
