"""Flash attention kernels: the forward (CUDA: ``csrc/flash_wgmma.cu`` on the
tensor cores, ``csrc/flash_attention.cu`` on the CUDA cores) and, for
training, the backward of the tensor-core route (``csrc/flash_wgmma_bwd.cu``).

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

Training (``flash_attention_bwd_cuda``): the ``wgmma`` route also writes
each row's f32 log-sum-exp ``lse`` (``return_lse``; under a key split the
combine kernel writes it), and the backward takes q, k, v, o, dO and lse
and returns dq, dk, dv in q's dtype: D = rowsum(dO o) by a small kernel,
then one kernel over (128-key tile, KV head, batch) for dK and dV, which
sums a KV head's G query heads in one CTA, and one over (128-row query
tile, head, batch) for dQ; no atomics, so two calls give the same bits.
P and dS enter their 16-bit products as the hi + lo pair in both passes
(float32 probabilities, as the forward's P). Every backward call counts
one ``flash_attention_bwd`` launch.
The ``wgmma`` route and the backward read and write every [B, H, S, d]
tensor by its strides (head dim contiguous, 4-D TMA maps), so the model's
[B, S, H, d] seen through a transpose needs no copy (``_tma_ready``).

Replaces ``flash_attention_pallas`` of the reference package's
``kernels/flash_attention.py``; the plain-torch versions are
``kernels/ref.py::flash_attention_ref`` (einsum + f32 softmax) and
``flash_attention_bwd_ref``. The reference's kernel has no VJP, and its
models train through the chunked or naive attention; here
``models/attention.py`` trains through ``ops.FlashAttention`` (these
kernels on a CUDA tensor) where the inputs allow, and
``ops.flash_attention`` / ``ops.flash_attention_bwd`` are the entry points.
"""
from __future__ import annotations

import ctypes

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
# ``flash_attention`` launch in cuda_build.launches, each backward as one
# ``flash_attention_bwd``)
route_launches = {"wgmma": 0, "cuda-core": 0}
bwd_route_launches = {"wgmma": 0}


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


def _check_qkv(q, k, v):
    """(B, H, KV, Sq, Sk, d) of q [B, H, Sq, d], k/v [B, KV, Sk, d]; raises
    on what the kernels do not take."""
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
    return B, H, KV, Sq, Sk, d


def _aligned(*ts):
    """Contiguous, 16-byte aligned copies where needed (the CUDA-core
    kernel's plain indexing)."""
    ts = (t.contiguous() for t in ts)
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ts]


def _tma_ready(*ts):
    """Each tensor as it lies where the tensor-core kernels' TMA maps can
    read it (head dim contiguous, every other stride a positive multiple of
    8 elements, 16-byte aligned: the model's [B, S, H, d] seen as [B, H, S,
    d] through a transpose is), else a contiguous, aligned copy."""
    out = []
    for t in ts:
        if t.stride(-1) != 1 or t.data_ptr() % 16 \
                or any(st <= 0 or st % 8 for st in t.stride()[:-1]):
            t = _aligned(t)[0]
        out.append(t)
    return out


def _layouts(*ts):
    """The (batch, head, row) element strides of each [B, H, rows, d]
    tensor in turn, as the kernels' ``lay`` array."""
    vals = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, scale=None, *,
                         return_lse: bool = False):
    """o [B, H, Sq, d] = softmax(q k^T * scale (+ causal mask)) v; with
    ``return_lse`` (o, lse [B, H, Sq] f32), which takes the ``wgmma``
    route's inputs only. On that route q, k and v are
    read as they lie where the TMA maps can (``_tma_ready``), and o takes
    q's layout when the keys are not split."""
    B, H, KV, Sq, Sk, d = _check_qkv(q, k, v)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    scale = float(scale if scale is not None else 1.0 / np.sqrt(d))
    p = plan(B, H, Sq, Sk, d, q.dtype)
    wgmma = p["route"] == "wgmma"
    if return_lse and not wgmma:
        raise ValueError(f"lse needs the wgmma route (bf16 / f16, d 64 or "
                         f"128), got {q.dtype}, d {d}")
    n_split, per = p["n_split"], p["per"]
    q, k, v = (_tma_ready if wgmma else _aligned)(q, k, v)
    out = torch.empty_like(q) if wgmma and n_split == 1 else \
        torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    part_o = part_ml = out                    # unused with one split
    if n_split > 1:
        part_o = torch.empty((n_split, B, H, Sq, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((n_split, B, H, Sq, 2), dtype=torch.float32,
                              device=q.device)
    lse_ptr = lse.data_ptr() if lse is not None else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if wgmma:
            err = cuda_build.library("flash_wgmma").fa_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                part_o.data_ptr(), part_ml.data_ptr(),
                lse_ptr if n_split == 1 else None, _layouts(q, k, v, out), B,
                H, KV, Sq, Sk, d, scale, int(bool(causal)),
                _DTYPE_CODE[q.dtype], n_split, per, stream)
        else:
            err = cuda_build.library("flash_attention").fa_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                part_o.data_ptr(), part_ml.data_ptr(), B, H, KV, Sq, Sk, d,
                scale, int(bool(causal)), _DTYPE_CODE[q.dtype], n_split, per,
                stream)
        cuda_build.launched(err, "flash_attention")
        route_launches[p["route"]] += 1
        if n_split > 1:
            err = cuda_build.library("flash_attention").fa_combine_launch(
                part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                lse_ptr, B * H * Sq, d, n_split, _DTYPE_CODE[q.dtype], stream)
            cuda_build.check(err, "flash_attention combine")
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q, k, v, o, do, lse, causal: bool = True,
                             scale=None):
    """(dq [B, H, Sq, d], dk, dv [B, KV, Sk, d]) in q's dtype: the gradients
    of ``flash_attention_cuda``'s o with respect to q, k and v, given dO
    ``do`` and the forward's ``o`` and ``lse``. bf16 / f16 at d 64 or 128."""
    B, H, KV, Sq, Sk, d = _check_qkv(q, k, v)
    if route(q.dtype, d) != "wgmma":
        raise ValueError(f"the flash-attention backward takes bf16 / f16 at "
                         f"head dim 64 or 128, got {q.dtype}, d {d}")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o and dO must be {list(q.shape)} {q.dtype}, got "
                         f"{list(o.shape)} {o.dtype} / {list(do.shape)} "
                         f"{do.dtype}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [{B}, {H}, {Sq}] float32, got "
                         f"{list(lse.shape)} {lse.dtype}")
    if any(t.device != q.device for t in (o, do, lse)):
        raise ValueError("q, k, v, o, dO and lse must be on one device")
    q, k, v, o, do = _tma_ready(q, k, v, o, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    lse = lse.contiguous()
    dvec = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    scale = float(scale if scale is not None else 1.0 / np.sqrt(d))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = cuda_build.library("flash_wgmma_bwd").fa_wgmma_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            _layouts(q, k, v, o, do, dq, dk, dv), B, H, KV, Sq, Sk, d, scale,
            int(bool(causal)), _DTYPE_CODE[q.dtype], stream)
        cuda_build.launched(err, "flash_attention_bwd")
        bwd_route_launches["wgmma"] += 1
    return dq, dk, dv
