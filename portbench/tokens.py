"""Token ids of a step, made from (seed, step) by a counter hash.

The splitmix64 counter of the program's ``data/synthetic.py``, copied here so
that the program cannot change what the benchmark feeds it. The seed is mixed
first, so any seed below 2**64 gives its own stream; a step's ids depend on
(seed, step) alone, so the reference regenerates the very ids the program was
handed.

Distributions (a mix file's ``"tokens"``):
  {"distribution": "uniform"}            every id of the vocabulary alike;
  {"distribution": "zipf", "s": 1.1}     id r drawn with weight (r + 1) ** -s.
"""
from __future__ import annotations

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = (x + _GOLDEN).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def uniform01(seed: int, step: int, n: int, salt: int = 0) -> np.ndarray:
    """``n`` float64 draws in [0, 1) of step ``step`` of stream ``seed``."""
    key = _splitmix64(np.array([seed % (1 << 64)], dtype=np.uint64))[0]
    key = _splitmix64(np.array([key ^ np.uint64(step % (1 << 48))
                                ^ np.uint64((salt & 0xFFFF) << 48)],
                               dtype=np.uint64))[0]
    with np.errstate(over="ignore"):
        r = _splitmix64(key + np.arange(n, dtype=np.uint64))
    return (r >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def step_tokens(spec: dict, vocab: int, batch: int, seq: int, seed: int,
                step: int) -> np.ndarray:
    """int32 [batch, seq] token ids of one step under the mix's ``spec``."""
    u = uniform01(seed, step, batch * seq)
    kind = spec.get("distribution", "uniform")
    if kind == "uniform":
        ids = np.floor(u * vocab).astype(np.int64)
    elif kind == "zipf":
        w = np.arange(1, vocab + 1, dtype=np.float64) ** -float(spec["s"])
        cdf = np.cumsum(w)
        ids = np.searchsorted(cdf / cdf[-1], u, side="right")
    else:
        raise ValueError(f"unknown token distribution {kind!r}")
    return np.clip(ids, 0, vocab - 1).astype(np.int32).reshape(batch, seq)
