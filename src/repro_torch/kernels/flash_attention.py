"""Flash attention forward kernels (CUDA: ``csrc/flash_wgmma.cu`` on the
tensor cores, ``csrc/flash_attention.cu`` on the CUDA cores).

GQA attention with an online softmax: q [B, H, Sq, d], k/v [B, KV, Sk, d]
(the reference package's layouts), optional causal mask aligned to the
bottom right (key col visible to query row iff col <= row + Sk - Sq), f32
scores and accumulation, output in q's dtype. f32, bf16 and f16 inputs and
head dims 1..256 run on the card; anything else raises.

Route, by dtype and head dim (``route``); each route is the kernel for its
inputs, not a fallback, and both count as ``flash_attention`` launches:

- ``wgmma``: bf16 / f16 with d 64 or 128. 128-row query tiles, K/V tiles
  of 64 keys brought in by TMA through a 2-stage ring, S = Q K^T and
  O += P V on the tensor cores (wgmma) with f32 accumulators. P is split as
  hi = fl16(p) and lo = fl16(p - hi), and both products are accumulated:
  a single 16-bit rounding of p errs by up to 2**-9 * sum(p |v|), past the
  1e-4 atol on rows whose output cancels; hi + lo keeps it near 2**-17.
- ``cuda-core``: f32 (no TF32: its tolerance is 2e-6), and bf16 / f16 at
  other head dims. 64-row query tiles, f32 FMAs on the CUDA cores.

Key split (``split_plan``): when the grid of (query tile x head x batch)
holds fewer CTAs than the card runs at once for the route
(``RESIDENT_CTAS``), the 64-key tiles are cut into ``n_split`` ranges of
``per`` tiles each, as many as keep the grid within one wave
(``split_ranges``: every key in exactly one range). Each split writes its
unnormalised f32 accumulator and its row max m and row sum l into scratch;
a second kernel combines them,
o = sum_i w_i acc_i / sum_i w_i l_i with w_i = exp(m_i - max_i m_i), and a
split that saw no key tile (l_i = 0) weighs nothing. Rows that see no key
(causal, Sq > Sk) score every key at -1e30 in every split, so they still
average v.

Replaces ``flash_attention_pallas`` of the reference package's
``kernels/flash_attention.py``; the plain-torch version is
``kernels/ref.py::flash_attention_ref`` (einsum + f32 softmax). As in the
reference, no model calls it: ``attention_impl="pallas"`` falls through to
the chunked attention, and ``ops.flash_attention`` is its entry point.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256
KEY_TILE = 64                 # keys per tile, both routes
# CTAs an H100 (132 SMs) holds at once, by route: one tensor-core CTA per SM
# (384 threads at 168 registers), two CUDA-core CTAs (99 KB of shared
# memory each at head dim 128)
RESIDENT_CTAS = {"wgmma": 132, "cuda-core": 264}

# launches by route since the process started (each also counts as one
# ``flash_attention`` launch in cuda_build.launches)
route_launches = {"wgmma": 0, "cuda-core": 0}


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes inputs of this dtype and head dim."""
    if dtype in (torch.bfloat16, torch.float16) and d in (64, 128):
        return "wgmma"
    return "cuda-core"


def query_tile(rt: str) -> int:
    """Query rows per CTA of a route's kernel."""
    return 128 if rt == "wgmma" else 64


def split_plan(B: int, H: int, Sq: int, Sk: int, block_q: int,
               slots: int, block_k: int = KEY_TILE) -> tuple[int, int]:
    """(n_split, per): the key tiles of every query tile cut into n_split
    ranges of ``per`` tiles, as many splits as keep the grid within
    ``slots`` CTAs; (1, all tiles) when the grid alone fills them."""
    ctas = -(-Sq // block_q) * H * B
    n_kt = -(-Sk // block_k)
    want = max(1, min(n_kt, slots // ctas))
    per = -(-n_kt // want)
    return -(-n_kt // per), per


def split_ranges(Sk: int, n_split: int, per: int,
                 block_k: int = KEY_TILE) -> list[tuple[int, int]]:
    """The key range [k0, k1) of each split (the kernels' arithmetic)."""
    return [(s * per * block_k, min((s + 1) * per * block_k, Sk))
            for s in range(n_split)]


def plan(B: int, H: int, Sq: int, Sk: int, d: int,
         dtype: torch.dtype) -> dict:
    """What a call at these shapes runs: route, query tile, key split."""
    rt = route(dtype, d)
    bq = query_tile(rt)
    n_split, per = split_plan(B, H, Sq, Sk, bq, RESIDENT_CTAS[rt])
    return {"route": rt, "block_q": bq, "n_split": n_split, "per": per}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, scale=None) -> torch.Tensor:
    """o [B, H, Sq, d] = softmax(q k^T * scale (+ causal mask)) v."""
    if not q.is_cuda:
        raise ValueError("the CUDA flash-attention kernel takes a CUDA tensor")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q [B,H,Sq,d], k/v [B,KV,Sk,d]")
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, KV, Sk, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be [{B}, KV, Sk, {d}] and equal, got "
                         f"{list(k.shape)} / {list(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"H {H} must be a multiple of KV {KV}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes one of f32/bf16/f16 for "
                         f"q, k and v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if Sk == 0:
        raise ValueError("flash_attention needs at least one key")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    # contiguous, and 16-byte aligned for the TMA tensor maps
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    scale = float(scale if scale is not None else 1.0 / np.sqrt(d))
    p = plan(B, H, Sq, Sk, d, q.dtype)
    n_split, per = p["n_split"], p["per"]
    part_o = part_ml = out                    # unused with one split
    if n_split > 1:
        part_o = torch.empty((n_split, B, H, Sq, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((n_split, B, H, Sq, 2), dtype=torch.float32,
                              device=q.device)
    wgmma = p["route"] == "wgmma"
    lib = cuda_build.library("flash_wgmma" if wgmma else "flash_attention")
    launch = lib.fa_wgmma_launch if wgmma else lib.fa_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     part_o.data_ptr(), part_ml.data_ptr(), B, H, KV, Sq, Sk,
                     d, scale, int(bool(causal)), _DTYPE_CODE[q.dtype],
                     n_split, per, stream)
        cuda_build.launched(err, "flash_attention")
        route_launches[p["route"]] += 1
        if n_split > 1:
            err = cuda_build.library("flash_attention").fa_combine_launch(
                part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                B * H * Sq, d, n_split, _DTYPE_CODE[q.dtype], stream)
            cuda_build.check(err, "flash_attention combine")
    return out
