"""Device dispatch for the hand-written kernels, plus the wire codecs.

Dispatch goes by the tensor's device: a CUDA tensor always launches the
hand-written kernel (a build or launch failure raises), a CPU tensor runs
the kernel's plain-torch version from ``kernels/ref.py``. Public ops take
natural leaf shapes; padding and row views are handled here.

Digests are int32 bit patterns on the device (torch's uint32 has few CUDA
ops); callers view them as ``np.uint32`` at the host boundary.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.chunk_delta import (TILE_G, changed_mask_cuda,
                                             fingerprint_changed_cuda,
                                             fingerprint_cuda, grid_rows,
                                             word_view)
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.quantize import (Q4_BLOCK, Q8_BLOCK,
                                          dequantize_rows_cuda,
                                          gather_quantize4_cuda,
                                          gather_quantize_cuda,
                                          quantize_rows_cuda)
from repro_torch.kernels.ref import (changed_mask_ref, dequantize_ref,
                                     fingerprint_changed_ref, fingerprint_ref,
                                     flash_attention_bwd_ref,
                                     flash_attention_ref,
                                     gather_quantize4_ref, gather_quantize_ref,
                                     quantize_ref)

CHUNK_WORDS = 1024        # 4 KiB chunks (uint32 words)


def _widen(words: torch.Tensor) -> torch.Tensor:
    """Word-unit tensor -> int64 values in [0, 2**32), zero-extended (a
    plain int16 -> int32 cast would sign-extend bf16/f16 words)."""
    w = words.to(torch.int64)
    if words.dtype == torch.int16:
        return w & 0xFFFF
    if words.dtype == torch.int32:
        return w & 0xFFFFFFFF
    return w                                   # uint8: already unsigned


def _as_u32_blocks(x: torch.Tensor, chunk_words: int) -> torch.Tensor:
    """View any tensor as [G, chunk_words] words (int64 values in
    [0, 2**32), zero-padded), G % 8 == 0 — the plain version's input."""
    words, _ = word_view(x)
    raw = _widen(words)
    n = raw.numel()
    g = -(-n // chunk_words)
    g = -(-g // TILE_G) * TILE_G
    raw = torch.nn.functional.pad(raw, (0, g * chunk_words - n))
    return raw.reshape(g, chunk_words)


def native_bytes_per_word(dtype) -> int:
    """How many ORIGINAL-array bytes one word of `_as_u32_blocks` output
    carries. Must mirror the dtype dispatch above: bf16/f16 widen one
    2-byte element per word; 4- and 8-byte dtypes are raw views (4 bytes per
    word); everything else widens one byte per word."""
    name = dtype_name(dtype)
    if name in ("bfloat16", "float16"):
        return 2
    return 4 if _itemsize(name) in (4, 8) else 1


def dtype_name(dtype) -> str:
    """numpy-style dtype name ("float32", "bfloat16", ...) of a torch or
    numpy dtype or a name — the string manifests record."""
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def _itemsize(name: str) -> int:
    return getattr(torch, name).itemsize


def fingerprint_leaf(x: torch.Tensor, chunk_words: int = CHUNK_WORDS):
    """Per-chunk int32 [G, 2] digest of one tensor (one pass)."""
    if x.is_cuda:
        return fingerprint_cuda(x, chunk_words)
    return fingerprint_ref(_as_u32_blocks(x, chunk_words))


def fingerprint_and_changed(x: torch.Tensor, prev_digest: torch.Tensor,
                            chunk_words: int = CHUNK_WORDS):
    """Fused fingerprint + compare: one pass over the leaf yielding both the
    new [G, 2] digests and the int32 [G] changed mask. Use when a previous
    digest exists; first-sight leaves go through ``fingerprint_leaf``."""
    if x.is_cuda:
        return fingerprint_changed_cuda(x, prev_digest, chunk_words)
    return fingerprint_changed_ref(_as_u32_blocks(x, chunk_words),
                                   prev_digest)


def changed_chunks(digest: torch.Tensor, prev_digest: torch.Tensor):
    """int32 [G] mask (1 = changed) of the rows where two int32 [G, 2]
    digest arrays differ."""
    if digest.is_cuda:
        return changed_mask_cuda(digest, prev_digest)
    return changed_mask_ref(digest, prev_digest).to(torch.int32)


def gather_changed_blocks(x: torch.Tensor, idx: torch.Tensor,
                          chunk_words: int = CHUNK_WORDS) -> torch.Tensor:
    """int32 [C, W] word rows (u32 bit patterns) of the block view of `x`
    selected by `idx` — the only device->host payload of an exact leaf.
    Reads only the selected rows (index arithmetic on the flat word view, no
    padded copy of the leaf); words past the leaf's end are zeros."""
    words, _ = word_view(x)
    n = words.numel()
    pos = idx.to(device=x.device, dtype=torch.int64)[:, None] * chunk_words \
        + torch.arange(chunk_words, device=x.device)[None, :]
    vals = words[pos.clamp(max=max(n - 1, 0))]
    if words.dtype != torch.int32:
        vals = _widen(vals).to(torch.int32)
    return torch.where(pos < n, vals, torch.zeros((), dtype=torch.int32,
                                                  device=x.device))


def quantizable_dtype(dtype) -> bool:
    """True for dtypes the fused quantize path supports: the float dtypes
    whose word view carries exactly one element per word, so float chunk
    rows align 1:1 with fingerprint chunks."""
    return dtype_name(dtype) in ("float32", "bfloat16", "float16")


def _padded_float_blocks(x: torch.Tensor, chunk_words: int) -> torch.Tensor:
    """The leaf's [g, chunk_words] f32 chunk view, g TILE_G-aligned — the
    shared row layout of every fused gather variant (plain version input)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    g = -(-n // chunk_words)
    g = -(-g // TILE_G) * TILE_G
    flat = torch.nn.functional.pad(flat, (0, g * chunk_words - n))
    return flat.reshape(g, chunk_words)


def gather_quantize_blocks(x: torch.Tensor, idx: torch.Tensor,
                           chunk_words: int = CHUNK_WORDS,
                           block: int = Q8_BLOCK):
    """Fused gather + blockwise-int8 quantize of the CHANGED chunk rows of a
    float leaf: (q int8 [C, W], scales f32 [C, W // block]); only rows named
    by ``idx`` are read."""
    block = min(block, chunk_words)            # small-chunk configs
    if x.is_cuda:
        return gather_quantize_cuda(x, idx, chunk_words, block)
    return gather_quantize_ref(_padded_float_blocks(x, chunk_words), idx,
                               block)


def gather_quantize4_blocks(x: torch.Tensor, idx: torch.Tensor,
                            chunk_words: int = CHUNK_WORDS,
                            block: int = Q4_BLOCK):
    """Fused gather + blockwise-int4 quantize of the CHANGED chunk rows:
    (packed uint8 [C, chunk_words // 2], scales f32 [C, chunk_words //
    block]), half-split nibble layout."""
    block = min(block, chunk_words)            # small-chunk configs
    if x.is_cuda:
        return gather_quantize4_cuda(x, idx, chunk_words, block)
    return gather_quantize4_ref(_padded_float_blocks(x, chunk_words), idx,
                                block)


def chunk_absmax(x: torch.Tensor, chunk_words: int = CHUNK_WORDS):
    """Per-chunk-row f32 absmax of a float leaf ([g] over the padded row
    layout the fused gathers use). The encoding selector turns this into a
    guaranteed per-chunk error bound before any gather runs. Plain torch:
    full rows reduce in place, only the partial last row is handled apart."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    g = grid_rows(n, chunk_words)
    out = torch.zeros((g,), dtype=torch.float32, device=x.device)
    full = n // chunk_words
    if full:
        out[:full] = flat[:full * chunk_words].view(full, chunk_words) \
            .abs().amax(dim=1)
    if n % chunk_words:
        out[full] = flat[full * chunk_words:].abs().amax()
    return out


def quantize_blocks(x: torch.Tensor, block: int = 256):
    """Flat blockwise int8 quantization of any tensor: (q int8 [G, block],
    scale f32 [G]), G rounded up to a multiple of TILE_G; the rows past the
    tensor's end quantize zeros."""
    n = x.numel()
    g = -(-n // block)
    g = -(-g // TILE_G) * TILE_G
    if x.is_cuda:
        if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            x = x.to(torch.float32)
        return quantize_rows_cuda(x, block, g)
    flat = x.reshape(-1).to(torch.float32)
    flat = torch.nn.functional.pad(flat, (0, g * block - n))
    return quantize_ref(flat.reshape(g, block))


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor, shape,
                      dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``quantize_blocks``: ``q * scale`` trimmed to ``shape``
    and cast to ``dtype``."""
    n = int(np.prod(shape, dtype=np.int64))
    if q.is_cuda:
        wide = dtype not in (torch.float32, torch.bfloat16, torch.float16)
        out = dequantize_rows_cuda(q, scale, n,
                                   torch.float32 if wide else dtype)
        return out.reshape(shape).to(dtype)
    x = dequantize_ref(q, scale)
    return x.reshape(-1)[:n].reshape(shape).to(dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale=None,
                    return_lse: bool = False):
    """GQA attention forward: q [B,H,Sq,d], k/v [B,KV,Sk,d] -> [B,H,Sq,d]
    in q's dtype (causal mask aligned to the last key, as the reference);
    with ``return_lse`` (o, lse [B,H,Sq] f32), what the backward takes."""
    kw = dict(causal=causal, scale=scale, return_lse=return_lse)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, **kw)
    return flash_attention_ref(q, k, v, **kw)


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        scale=None):
    """The backward of ``flash_attention``: (dq, dk, dv) in q's dtype from
    the forward's inputs, its o and lse, and dO ``do``."""
    kw = dict(causal=causal, scale=scale)
    if q.is_cuda:
        return flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    return flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)


class FlashAttention(torch.autograd.Function):
    """o = ``flash_attention(q, k, v)`` as one autograd node whose backward
    is ``flash_attention_bwd``: the kernels on a CUDA tensor, their plain
    versions on the CPU. It saves q, k, v, o and the f32 lse [B,H,Sq],
    never a score matrix. ``apply(q, k, v, causal, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.to(q.dtype), lse,
                                         **ctx.kw)
        return dq, dk, dv, None, None


def launch_counts() -> dict:
    """Kernel launches so far in this process, by kernel (each wrapper
    counts one per kernel it launches, and nothing else)."""
    return dict(cuda_build.launches)


def reset_launch_counts():
    for k in cuda_build.launches:
        cuda_build.launches[k] = 0


# ------------------------------------------------------------- q8 wire codec
# Self-describing quantized chunk payload (little-endian):
#   [u32 n_elems][u32 block][f32 scales[ceil(n_elems/block)]][int8 q[n_elems]]

def q8_encode_chunk(q_row: np.ndarray, scales: np.ndarray, n_elems: int,
                    block: int = Q8_BLOCK) -> bytes:
    """Pack one quantized chunk row (int8 [W], f32 [W // block]) into the
    q8 wire format, trimming to the chunk's real `n_elems`."""
    n_sub = -(-n_elems // block)
    head = np.uint32(n_elems).tobytes() + np.uint32(block).tobytes()
    return (head
            + np.ascontiguousarray(scales[:n_sub], np.float32).tobytes()
            + np.ascontiguousarray(q_row[:n_elems], np.int8).tobytes())


def _f32_to_native_bytes(x: np.ndarray, dtype) -> bytes:
    """f32 values -> the leaf dtype's bytes. bfloat16 goes through torch
    (round to nearest even), so no numpy bfloat16 type is needed."""
    name = dtype_name(dtype)
    if name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return t.to(torch.bfloat16).view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(x.astype(np.dtype(name))).tobytes()


def q8_decode_chunk(payload: bytes, dtype) -> bytes:
    """Dequantize one q8 chunk payload back to the leaf's native bytes."""
    n = int(np.frombuffer(payload[:4], np.uint32)[0])
    block = int(np.frombuffer(payload[4:8], np.uint32)[0])
    n_sub = -(-n // block)
    scales = np.frombuffer(payload[8:8 + 4 * n_sub], np.float32)
    q = np.frombuffer(payload[8 + 4 * n_sub:8 + 4 * n_sub + n], np.int8)
    pad = (-n) % block
    qf = np.pad(q.astype(np.float32), (0, pad)).reshape(n_sub, block)
    return _f32_to_native_bytes((qf * scales[:, None]).reshape(-1)[:n], dtype)


# ------------------------------------------------------------- q4 wire codec
# Self-describing int4 chunk payload (little-endian):
#   [u32 n_elems][u32 block][f32 scales[W/block]][u8 packed[W/2]]
# scales and packed bytes cover the FULL kernel row W (W is recovered from
# the payload length). Nibbles use the half-split layout: byte j holds
# element j (low) and element j + W/2 (high), signed two's-complement.

def q4_encode_chunk(packed_row: np.ndarray, scales: np.ndarray,
                    n_elems: int, block: int = Q4_BLOCK) -> bytes:
    """Pack one int4-quantized chunk row (uint8 [W // 2], f32 [W // block])
    into the q4 wire format. The packed row is kept whole; `n_elems` in the
    header trims on decode."""
    head = np.uint32(n_elems).tobytes() + np.uint32(block).tobytes()
    return (head
            + np.ascontiguousarray(scales, np.float32).tobytes()
            + np.ascontiguousarray(packed_row, np.uint8).tobytes())


def q4_decode_chunk(payload: bytes, dtype) -> bytes:
    """Dequantize one q4 chunk payload back to the leaf's native bytes."""
    n = int(np.frombuffer(payload[:4], np.uint32)[0])
    block = int(np.frombuffer(payload[4:8], np.uint32)[0])
    after = len(payload) - 8
    n_sub = after // (4 + block // 2)
    W = n_sub * block
    scales = np.frombuffer(payload[8:8 + 4 * n_sub], np.float32)
    packed = np.frombuffer(payload[8 + 4 * n_sub:], np.uint8)
    q = np.empty(W, np.int8)
    lo = (packed & 0xF).astype(np.int8)
    hi = (packed >> 4).astype(np.int8)
    q[: W // 2] = lo - ((lo > 7) << 4)       # sign-extend 4 -> 8 bits
    q[W // 2:] = hi - ((hi > 7) << 4)
    qf = q.astype(np.float32).reshape(n_sub, block)
    return _f32_to_native_bytes((qf * scales[:, None]).reshape(-1)[:n], dtype)


# -------------------------------------------------------- decode dispatch --
def decode_wire_chunk(payload: bytes, enc: str, dtype) -> bytes:
    """Decode one stored chunk body to native leaf bytes given its manifest
    ``enc`` marker ("raw", "q8", "q4", optionally with the "+z" entropy
    suffix)."""
    if enc.endswith("+z"):
        from repro_torch.parallel.compression import entropy_decode_bytes
        payload = entropy_decode_bytes(payload)
        enc = enc[:-2]
    if enc == "q8":
        return q8_decode_chunk(payload, dtype)
    if enc == "q4":
        return q4_decode_chunk(payload, dtype)
    return payload
