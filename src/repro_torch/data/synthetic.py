"""Deterministic synthetic data: a pure function of (step, seed).

This determinism is a correctness substrate for Flor: logical redo of any
epoch reproduces the exact same batches, so record and replay consume
bit-identical inputs without storing any data (the paper's assumption that
model-training inputs are replayable, made structural).

Tokens come from a splitmix64-style counter hash — stateless, seekable,
cheap. Text tokens follow a skewed (Zipf-ish) distribution so losses move.
"""
from __future__ import annotations

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _counters(step: int, seed: int, n: int, salt: int) -> np.ndarray:
    base = (np.uint64(seed) << np.uint64(32)) ^ np.uint64(step) \
        ^ (np.uint64(salt) << np.uint64(48))
    return _splitmix64(base + np.arange(n, dtype=np.uint64))


def _tokens(step, seed, shape, vocab, salt=0):
    r = _counters(step, seed, int(np.prod(shape)), salt)
    u = (r >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    # Zipf-ish skew so the model has structure to learn
    toks = np.floor(vocab * np.power(u, 3.0)).astype(np.int64)
    return np.clip(toks, 0, vocab - 1).astype(np.int32).reshape(shape)


def _embeds(step, seed, shape, salt=1):
    r = _counters(step, seed, int(np.prod(shape)), salt)
    u = (r >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    return ((u - 0.5) * 2.0).astype(np.float32).reshape(shape)


def synthetic_batch(cfg, batch: int, seq: int, step: int, seed: int = 0) -> dict:
    """Batch matching Model.input_specs for a train shape."""
    if cfg.family == "audio":
        half = seq // 2
        return {
            "enc_embeds": _embeds(step, seed, (batch, half, cfg.d_model)),
            "dec_tokens": _tokens(step, seed, (batch, half), cfg.vocab_size),
        }
    if cfg.family == "vlm":
        F = cfg.frontend_tokens
        return {
            "embeds": _embeds(step, seed, (batch, F, cfg.d_model)),
            "tokens": _tokens(step, seed, (batch, seq - F), cfg.vocab_size),
        }
    return {"tokens": _tokens(step, seed, (batch, seq), cfg.vocab_size)}


def batch_for_step(cfg, shape, step: int, seed: int = 0) -> dict:
    return synthetic_batch(cfg, shape.global_batch, shape.seq_len, step, seed)
