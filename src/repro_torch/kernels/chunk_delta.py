"""Chunk fingerprint and changed-mask kernels (CUDA, ``csrc/chunk_delta.cu``).

The async writer wants to know WHICH chunks of a leaf changed since the last
materialized checkpoint without copying the whole leaf to the host. These
kernels compute a position-mixed 64-bit digest per chunk on the card, in one
read of the leaf, straight from its own storage (no padded word copy); only
chunks whose digest changed are transferred.

Replaces ``fingerprint_pallas`` / ``fingerprint_changed_pallas`` /
``changed_mask_pallas`` of the reference package's ``kernels/chunk_delta.py``.
The plain-torch versions are ``kernels/ref.py::fingerprint_ref`` /
``fingerprint_changed_ref`` / ``changed_mask_ref``; the CPU path of
``kernels/ops.py`` uses them and ``chip_smoke.py`` holds these kernels
against them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build

TILE_G = 8                     # digest rows are padded to a multiple of this


def word_view(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(flat word-unit tensor, bytes per word) of a leaf — the dtype
    dispatch of ``ops._as_u32_blocks``: bf16/f16 are 2-byte words, 4- and
    8-byte dtypes 4-byte words (an 8-byte element is two words), every other
    dtype one word per byte."""
    flat = x.contiguous().reshape(-1)
    if flat.dtype in (torch.bfloat16, torch.float16):
        return flat.view(torch.int16), 2
    isz = flat.element_size()
    if isz in (4, 8):
        return flat.view(torch.int32), 4
    return flat.view(torch.uint8), 1


def grid_rows(n_words: int, chunk_words: int) -> int:
    g = -(-n_words // chunk_words)
    return -(-g // TILE_G) * TILE_G


def _launch(x: torch.Tensor, chunk_words: int, prev):
    if not x.is_cuda:
        raise ValueError("the CUDA fingerprint kernel takes a CUDA tensor")
    words, bpw = word_view(x)
    n = words.numel()
    G = grid_rows(n, chunk_words)
    digest = torch.empty((G, 2), dtype=torch.int32, device=x.device)
    mask = None
    if prev is not None:
        if prev.shape != (G, 2) or prev.dtype != torch.int32 \
                or prev.device != x.device:
            raise ValueError(f"prev digest must be int32 [{G}, 2] on "
                             f"{x.device}, got {prev.dtype} "
                             f"{list(prev.shape)} on {prev.device}")
        prev = prev.contiguous()
        mask = torch.empty((G,), dtype=torch.int32, device=x.device)
    if G == 0:
        return digest, mask
    lib = cuda_build.library("chunk_delta")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fp_launch(words.data_ptr(), n, bpw, chunk_words, G,
                            prev.data_ptr() if prev is not None else None,
                            digest.data_ptr(),
                            mask.data_ptr() if mask is not None else None,
                            stream)
    name = "fingerprint" if prev is None else "fingerprint_changed"
    cuda_build.launched(err, name)
    return digest, mask


def fingerprint_cuda(x: torch.Tensor, chunk_words: int) -> torch.Tensor:
    """Leaf on the card -> int32 [G, 2] digest bit patterns."""
    return _launch(x, chunk_words, None)[0]


def fingerprint_changed_cuda(x: torch.Tensor, prev: torch.Tensor,
                             chunk_words: int):
    """Fused digest + compare in ONE pass over the leaf: (int32 [G, 2]
    digests, int32 [G] changed mask against ``prev``)."""
    return _launch(x, chunk_words, prev)


def changed_mask_cuda(digest: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """int32 [G] mask of the rows where two int32 [G, 2] digest arrays on
    the card differ (1 = changed)."""
    if not digest.is_cuda:
        raise ValueError("the CUDA changed-mask kernel takes a CUDA tensor")
    G = digest.shape[0]
    for name, t in (("digest", digest), ("prev", prev)):
        if t.shape != (G, 2) or t.dtype != torch.int32 \
                or t.device != digest.device:
            raise ValueError(f"{name} must be int32 [{G}, 2] on "
                             f"{digest.device}, got {t.dtype} "
                             f"{list(t.shape)} on {t.device}")
    digest, prev = digest.contiguous(), prev.contiguous()
    mask = torch.empty((G,), dtype=torch.int32, device=digest.device)
    if G == 0:
        return mask
    lib = cuda_build.library("chunk_delta")
    with torch.cuda.device(digest.device):
        stream = torch.cuda.current_stream(digest.device).cuda_stream
        err = lib.cm_launch(digest.data_ptr(), prev.data_ptr(), G,
                            mask.data_ptr(), stream)
    cuda_build.launched(err, "changed_mask")
    return mask
