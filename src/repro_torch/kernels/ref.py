"""Plain-torch versions of the hand-written kernels (their references).

Each function computes what its CUDA kernel computes (kernels/chunk_delta.py,
kernels/quantize.py, kernels/flash_attention.py: the forward and the
training backward) with ordinary tensor ops, on
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


def _causal_keep(Sq: int, Sk: int, device) -> torch.Tensor:
    """[Sq, Sk] bool: key col visible to query row iff col <= row + Sk - Sq
    (the causal mask aligned to the last key)."""
    return torch.arange(Sk, device=device)[None, :] \
        <= torch.arange(Sq, device=device)[:, None] + (Sk - Sq)


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None,
                        return_lse: bool = False):
    """q [B,H,Sq,d], k/v [B,KV,Sk,d] with H % KV == 0 -> [B,H,Sq,d] in q's
    dtype. f32 scores and softmax; the causal mask keeps col <= row +
    (Sk - Sq) and writes -1e30 elsewhere, so a fully masked row (Sq > Sk)
    averages v uniformly. ``return_lse``: (o, lse [B,H,Sq] f32), lse = m +
    log(l) of the scaled scores."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, d).to(torch.float32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32))
    s = s * float(scale if scale is not None else 1.0 / np.sqrt(d))
    if causal:
        s = torch.where(_causal_keep(Sq, Sk, q.device), s,
                        torch.full((), -1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, v.to(torch.float32))
    o = o.reshape(B, H, Sq, d).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def split_pair_ref(x: torch.Tensor, dtype: torch.dtype):
    """The kernels' hi + lo pair of f32 ``x`` in a 16-bit ``dtype``: hi =
    fl16(x), lo = fl16(x - hi), both returned as f32. hi + lo is x to within
    2**-16 relative (f16: plus its subnormal floor); in f32 lo is 0."""
    hi = x.to(dtype).to(torch.float32)
    return hi, (x - hi).to(dtype).to(torch.float32)


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                            scale=None):
    """The flash-attention backward's arithmetic in plain torch: (dq
    [B,H,Sq,d], dk, dv [B,KV,Sk,d]) in q's dtype from q, k, v, the forward's
    o and lse [B,H,Sq] (f32) and dO ``do``. D = rowsum(dO o) in f32 from
    the stored o; P = exp(s scale - lse), dS = P (dP - D), dP = dO v^T, 0
    where masked; a row that sees no key (causal, Sq > Sk) has P = 1/Sk
    and dS = 0. P and dS enter their products as the hi + lo pair
    (``split_pair_ref`` in q's dtype), every product summed in f32: dV = sum over the group's query
    heads of P^T dO, dK = scale dS^T q, dQ = scale dS k."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G, f32, dt = H // KV, torch.float32, q.dtype
    scale = float(scale if scale is not None else 1.0 / np.sqrt(d))
    qg = q.reshape(B, KV, G, Sq, d).to(f32)
    og = o.reshape(B, KV, G, Sq, d).to(f32)
    dog = do.reshape(B, KV, G, Sq, d).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    D = (dog * og).sum(dim=-1)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
    p = torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None].to(f32))
    seen = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        seen = _causal_keep(Sq, Sk, q.device)
        blind = (torch.arange(Sq, device=q.device) + (Sk - Sq) < 0)[:, None]
        p = torch.where(seen, p, torch.where(
            blind, torch.full((), 1.0 / Sk, dtype=f32, device=q.device),
            torch.zeros((), dtype=f32, device=q.device)))
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, vf)
    ds = torch.where(seen, p * (dp - D[..., None]),
                     torch.zeros((), dtype=f32, device=q.device))
    split = dt != f32                        # in f32 lo is 0
    parts_p = split_pair_ref(p, dt) if split else (p,)
    parts_ds = split_pair_ref(ds, dt) if split else (ds,)
    dv = sum(torch.einsum("bkgqs,bkgqd->bksd", x, dog) for x in parts_p)
    dk = sum(torch.einsum("bkgqs,bkgqd->bksd", x, qg) for x in parts_ds)
    dq = sum(torch.einsum("bkgqs,bksd->bkgqd", x, kf) for x in parts_ds)
    return ((dq * scale).reshape(B, H, Sq, d).to(dt), (dk * scale).to(dt),
            dv.to(dt))


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
