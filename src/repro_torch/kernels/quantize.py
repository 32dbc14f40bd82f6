"""Blockwise quantize kernels (CUDA, ``csrc/quantize.cu``).

The checkpoint fast path for error-bounded slots: the changed chunk rows of
a float leaf leave the card already in the q8 (int8 + scales) or q4 (packed
nibbles + scales) wire format, read in one pass from the leaf's own storage.
Beside them, the plain per-row int8 quantize / dequantize pair of
``ops.quantize_blocks`` / ``ops.dequantize_blocks``.

Replaces ``gather_quantize_pallas`` / ``gather_quantize4_pallas`` /
``quantize_pallas`` / ``dequantize_pallas`` of the reference package's
``kernels/quantize.py``. The plain-torch versions are
``kernels/ref.py::gather_quantize_ref`` / ``gather_quantize4_ref`` over the
padded float row view (``ops._padded_float_blocks``), and ``quantize_ref`` /
``dequantize_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build

Q8_BLOCK = 256
Q4_BLOCK = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def q4_lanes(chunk_words: int, block: int) -> int:
    """Lanes that share one sub-block in the q4 kernel (``gq4_kernel``): a
    thread owns 16 packed bytes, i.e. 16 elements of each half-row. Raises
    for a row shape the kernel does not take."""
    W = chunk_words
    n_sub = W // block if block and W % block == 0 else 0
    if W % 32 or block % 16 or not (n_sub == 1 or n_sub % 2 == 0):
        raise ValueError(
            f"the q4 kernel takes chunk_words a multiple of 32 and a block "
            f"of 16k elements dividing it into 1 or an even number of "
            f"sub-blocks; got chunk_words {W}, block {block}")
    lanes = W // 32 if n_sub == 1 else block // 16
    if lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"the q4 kernel reduces a sub-block over a power "
                         f"of two <= 32 lanes; block {block} of chunk_words "
                         f"{W} needs {lanes}")
    return lanes


def q8_lanes(chunk_words: int, block: int) -> int:
    """Lanes that share one sub-block in the q8 kernel (``gq8_kernel``): a
    thread owns 16 consecutive elements of the row, its 16 output bytes.
    Raises for a row shape the kernel does not take."""
    W = chunk_words
    lanes = block // 16
    if not 0 < block <= W or W % block or block % 16 or lanes > 32 \
            or lanes & (lanes - 1):
        raise ValueError(
            f"the q8 kernel takes a block of 16 times a power of two, at "
            f"most 512 elements, dividing chunk_words; got chunk_words {W}, "
            f"block {block}")
    return lanes


def _launch(x: torch.Tensor, idx: torch.Tensor, chunk_words: int,
            block: int, q4: bool):
    if not x.is_cuda:
        raise ValueError("the CUDA gather-quantize kernel takes a CUDA tensor")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"gather-quantize takes f32/bf16/f16, got {x.dtype}")
    W = chunk_words
    if W % block:
        raise ValueError(f"chunk_words {W} must be a multiple of block "
                         f"{block}")
    lanes = q4_lanes(W, block) if q4 else q8_lanes(W, block)
    flat = x.contiguous().reshape(-1)
    n = flat.numel()
    idx = idx.to(device=x.device, dtype=torch.int32).contiguous()
    C = idx.numel()
    n_sub = W // block
    out = torch.empty((C, W // 2 if q4 else W),
                      dtype=torch.uint8 if q4 else torch.int8,
                      device=x.device)
    scales = torch.empty((C, n_sub), dtype=torch.float32, device=x.device)
    if C == 0:
        return out, scales
    lib = cuda_build.library("quantize")
    launch = lib.gq4_launch if q4 else lib.gq8_launch
    # the 16-byte loads need a 16-byte aligned start
    src = flat if flat.data_ptr() % 16 == 0 else flat.clone()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(src.data_ptr(), n, _DTYPE_CODE[x.dtype], W, block,
                     lanes, idx.data_ptr(), C, out.data_ptr(),
                     scales.data_ptr(), stream)
    cuda_build.launched(err, "gather_quantize4" if q4 else "gather_quantize")
    return out, scales


def gather_quantize_cuda(x: torch.Tensor, idx: torch.Tensor,
                         chunk_words: int, block: int = Q8_BLOCK):
    """Rows ``idx`` of the leaf's [G, chunk_words] float view -> (q int8
    [C, W], scales f32 [C, W // block]). One read of each row, in 16-byte
    loads; the row shapes it takes are those ``q8_lanes`` accepts (64 KiB
    rows of 256-element blocks on the record path)."""
    return _launch(x, idx, chunk_words, block, q4=False)


def gather_quantize4_cuda(x: torch.Tensor, idx: torch.Tensor,
                          chunk_words: int, block: int = Q4_BLOCK):
    """Rows ``idx`` -> (packed uint8 [C, W // 2] half-split nibbles, scales
    f32 [C, W // block]). One read of each row, in 16-byte loads; the row
    shapes it takes are those ``q4_lanes`` accepts (64 KiB rows of 256-
    element blocks on the record path)."""
    return _launch(x, idx, chunk_words, block, q4=True)


def quantize_rows_cuda(x: torch.Tensor, block: int, rows: int):
    """The leaf's flat elements as ``rows`` rows of ``block`` (zeros past
    its end) -> (q int8 [rows, block], scale f32 [rows]), read in place."""
    if not x.is_cuda:
        raise ValueError("the CUDA quantize kernel takes a CUDA tensor")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"quantize_rows takes f32/bf16/f16, got {x.dtype}")
    flat = x.contiguous().reshape(-1)
    if flat.numel() > rows * block:
        raise ValueError(f"{flat.numel()} elements exceed {rows} rows of "
                         f"{block}")
    q = torch.empty((rows, block), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, scale
    lib = cuda_build.library("quantize")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qr_launch(flat.data_ptr(), flat.numel(),
                            _DTYPE_CODE[x.dtype], rows, block, q.data_ptr(),
                            scale.data_ptr(), stream)
    cuda_build.launched(err, "quantize_rows")
    return q, scale


def dequantize_rows_cuda(q: torch.Tensor, scale: torch.Tensor, n: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """The first ``n`` elements of ``q * scale[:, None]`` ([G, B] int8 and
    [G] f32 on the card), flat, in ``dtype`` (f32/bf16/f16)."""
    if not q.is_cuda:
        raise ValueError("the CUDA dequantize kernel takes a CUDA tensor")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"dequantize_rows writes f32/bf16/f16, got {dtype}")
    G, B = q.shape
    if q.dtype != torch.int8 or scale.shape != (G,) \
            or scale.dtype != torch.float32 or scale.device != q.device:
        raise ValueError(f"need int8 q [G, B] and f32 scale [{G}] on "
                         f"{q.device}, got {q.dtype} {list(q.shape)}, "
                         f"{scale.dtype} {list(scale.shape)} on "
                         f"{scale.device}")
    if n > G * B:
        raise ValueError(f"{n} elements exceed the {G} x {B} rows")
    q, scale = q.contiguous(), scale.contiguous()
    out = torch.empty((n,), dtype=dtype, device=q.device)
    if n == 0:
        return out
    lib = cuda_build.library("quantize")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dq_launch(q.data_ptr(), scale.data_ptr(), G, B, n,
                            _DTYPE_CODE[dtype], out.data_ptr(), stream)
    cuda_build.launched(err, "dequantize_rows")
    return out
