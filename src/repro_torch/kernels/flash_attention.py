"""Flash attention forward kernel (CUDA, ``csrc/flash_attention.cu``).

GQA attention with an online softmax: q [B, H, Sq, d], k/v [B, KV, Sk, d]
(the reference package's layouts), optional causal mask aligned to the
bottom right (key col visible to query row iff col <= row + Sk - Sq), f32
scores and accumulation, output in q's dtype. f32, bf16 and f16 inputs and
head dims 1..256 run on the card; anything else raises.

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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = float(scale if scale is not None else 1.0 / np.sqrt(d))
    lib = cuda_build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), B, H, KV, Sq, Sk, d,
                            scale, int(bool(causal)),
                            _DTYPE_CODE[q.dtype], stream)
    cuda_build.launched(err, "flash_attention")
    return out
