"""Timing: the program's profiler spans, and the EMAs of the Flor
adaptive-checkpointing controller."""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    runs, so the range and the device work launched inside it share the
    profiler's timeline; with no profiler, a shared null context after one
    check (no dispatcher op, nothing in a fake-tensor trace)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


class EMA:
    """Exponential moving average with bias correction (Flor uses EMAs of
    materialization/compute times so early noisy samples wash out)."""

    def __init__(self, beta: float = 0.7):
        self.beta = beta
        self._v = 0.0
        self._n = 0

    def update(self, x: float) -> float:
        self._v = self.beta * self._v + (1.0 - self.beta) * float(x)
        self._n += 1
        return self.value

    @property
    def value(self) -> float:
        if self._n == 0:
            return 0.0
        return self._v / (1.0 - self.beta ** self._n)

    @property
    def count(self) -> int:
        return self._n
