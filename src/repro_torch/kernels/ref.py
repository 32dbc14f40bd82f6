"""Plain-torch versions of the hand-written kernels (their references).

Each function computes what its CUDA kernel computes (kernels/chunk_delta.py,
kernels/quantize.py, kernels/flash_attention.py) with ordinary tensor ops, on
any device. The CPU path of
``kernels/ops.py`` runs these; ``chip_smoke.py`` holds every kernel against
them on the card.

Integer arithmetic: torch has no unsigned 32-bit multiply-wrap or xor-reduce,
so the fingerprint works on int64 tensors holding values in [0, 2**32) and
keeps only the low 32 bits of every product (``_mul32`` splits one factor
into 16-bit halves so no int64 product overflows). Digests are returned as
int32 bit patterns, the form the CUDA kernels write.
"""
from __future__ import annotations

import numpy as np
import torch

FP_PRIME1 = 2654435761
FP_PRIME2 = 2246822519
FP_PRIME3 = 3266489917

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 `a` in [0, 2**32) and a 32-bit constant
    `b`, without an int64 product ever exceeding 2**49."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _xor_reduce_rows(v: torch.Tensor) -> torch.Tensor:
    """Row-wise xor of a [G, B] integer tensor (pairwise folding)."""
    while v.shape[1] > 1:
        if v.shape[1] % 2:
            v = torch.nn.functional.pad(v, (0, 1))
        h = v.shape[1] // 2
        v = v[:, :h] ^ v[:, h:]
    return v[:, 0]


def as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 tensor with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def fingerprint_ref(x_u32: torch.Tensor) -> torch.Tensor:
    """Per-row fingerprint of a [G, B] word view (int64 values in
    [0, 2**32)). Returns [G, 2] int32 digest bit patterns:
    v = (x ^ j*P1) * P2, d0 = xor over v, d1 = sum of v*P3 (all mod 2**32)."""
    G, B = x_u32.shape
    pos = _mul32(torch.arange(B, dtype=torch.int64, device=x_u32.device),
                 FP_PRIME1)[None, :]
    v = _mul32(x_u32.to(torch.int64) ^ pos, FP_PRIME2)
    d0 = _xor_reduce_rows(v)
    d1 = _mul32(v, FP_PRIME3).sum(dim=1) & _M32
    return as_int32_bits(torch.stack([d0, d1], dim=1))


def changed_mask_ref(digest: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """[G,2] x [G,2] -> bool [G]; True where the chunk changed."""
    return (digest != prev).any(dim=1)


def fingerprint_changed_ref(x_u32: torch.Tensor, prev: torch.Tensor):
    """Fused-kernel reference: ([G,2] digests, int32 [G] changed mask)."""
    d = fingerprint_ref(x_u32)
    return d, changed_mask_ref(d, prev).to(torch.int32)


def _block_scale(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    """max(absmax / qmax, 1e-12) exactly as the reference package computes
    it under jit: XLA folds the division by the constant into a multiply by
    the f32-rounded reciprocal, and the stored scales (hence the wire bytes
    and chunk hashes) carry that rounding."""
    recip = torch.full((), 1.0 / qmax, dtype=torch.float32,
                       device=absmax.device)
    return torch.clamp_min(absmax * recip, 1e-12)


def quantize_ref(x: torch.Tensor):
    """Blockwise int8 quantization of [G, B] f32. Returns (q int8 [G, B],
    scale f32 [G]): scale = max(absmax * fl(1/127), 1e-12), q = clip(rint(x
    / scale), -127, 127) — correctly rounded division by the scale, round
    half to even."""
    x = x.to(torch.float32)
    scale = _block_scale(x.abs().amax(dim=1), 127.0)
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[G, B] int8 x [G] f32 -> f32 [G, B]: q * scale per row."""
    return q.to(torch.float32) * scale[:, None]


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """q [B,H,Sq,d], k/v [B,KV,Sk,d] with H % KV == 0 -> [B,H,Sq,d] in q's
    dtype. f32 scores and softmax; the causal mask keeps col <= row +
    (Sk - Sq) and writes -1e30 elsewhere, so a fully masked row (Sq > Sk)
    averages v uniformly."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, d).to(torch.float32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32))
    s = s * float(scale if scale is not None else 1.0 / np.sqrt(d))
    if causal:
        keep = torch.arange(Sk, device=q.device)[None, :] \
            <= torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        s = torch.where(keep, s, torch.full((), -1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, v.to(torch.float32))
    return o.reshape(B, H, Sq, d).to(q.dtype)


def gather_quantize_ref(x: torch.Tensor, idx: torch.Tensor, block: int = 256):
    """Gather + quantize over the [G, W] float chunk view: returns
    (q int8 [C, W], scales f32 [C, W // block])."""
    rows = x.to(torch.float32).index_select(0, idx.to(torch.int64))
    C, W = rows.shape
    q, s = quantize_ref(rows.reshape(C * (W // block), block))
    return q.reshape(C, W), s.reshape(C, W // block)


def gather_quantize4_ref(x: torch.Tensor, idx: torch.Tensor,
                         block: int = 256):
    """Gather + int4 quantize over the [G, W] float chunk view: returns
    (packed uint8 [C, W // 2], scales f32 [C, W // block]) in the half-split
    nibble layout (element j in the low nibble of byte j, element j + W/2 in
    its high nibble)."""
    rows = x.to(torch.float32).index_select(0, idx.to(torch.int64))
    C, W = rows.shape
    sub = rows.reshape(C * (W // block), block)
    scale = _block_scale(sub.abs().amax(dim=1), 7.0)
    q = torch.clamp(torch.round(sub / scale[:, None]), -7, 7).to(torch.int32)
    q = q.reshape(C, W)
    lo = q[:, : W // 2] & 0xF
    hi = q[:, W // 2:] & 0xF
    return (lo | (hi << 4)).to(torch.uint8), scale.reshape(C, W // block)
