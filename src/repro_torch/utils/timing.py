"""Wall-clock instrumentation for the Flor adaptive-checkpointing controller."""
from __future__ import annotations

import time


class Stopwatch:
    """Context-manager stopwatch. `elapsed` in seconds after the block."""

    def __init__(self):
        self.elapsed = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed


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
