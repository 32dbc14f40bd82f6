"""The writer-thread ENTROPY STAGE of the checkpoint wire pipeline.

A host-side byte-plane shuffle + high-level compress applied to
already-gathered checkpoint chunks on the WRITER thread (never the step
path — its cost lands in the adaptive controller's ``bg_s`` accumulator).
Transposing an f32 payload into byte planes groups the exponent bytes of
neighboring values, which a generic per-chunk zstd/zlib pass cannot exploit
— that's where the extra shrink over the store's own level-3 compression
comes from. The output is self-describing (magic + stride + raw length),
and the inner codec is ``utils.codec.Compressor`` so the zlib fallback
works where zstandard is absent.

(The reference package's gradient-compression codec in the same module is
ROADMAP queue 1, item 14.)
"""
from __future__ import annotations

import numpy as np

from repro_torch.utils.codec import Compressor

# wire header: magic byte, byte-plane stride (1 = no shuffle), u32 raw length
_ENTROPY_MAGIC = 0xE7
_entropy_codec = Compressor(level=9)      # writer-thread time, spent on bytes


def entropy_encode_bytes(data: bytes, itemsize: int = 1) -> bytes:
    """Byte-plane shuffle (stride = ``itemsize``; 1 disables the shuffle,
    right for q8/q4 payloads whose bytes are already homogeneous) then
    compress at a high level. Returns a self-describing payload for
    ``entropy_decode_bytes``."""
    stride = itemsize if itemsize > 1 and len(data) % itemsize == 0 else 1
    body = data
    if stride > 1:
        body = np.frombuffer(data, np.uint8).reshape(-1, stride) \
            .T.tobytes()                  # plane-major: all byte-0s, then 1s…
    head = bytes([_ENTROPY_MAGIC, stride]) \
        + np.uint32(len(data)).tobytes()
    return head + _entropy_codec.compress(body)


def entropy_decode_bytes(payload: bytes) -> bytes:
    """Inverse of :func:`entropy_encode_bytes`."""
    if not payload or payload[0] != _ENTROPY_MAGIC:
        raise ValueError("not an entropy-stage payload (bad magic)")
    stride = payload[1]
    raw_len = int(np.frombuffer(payload[2:6], np.uint32)[0])
    body = _entropy_codec.decompress(payload[6:])
    if stride > 1:
        body = np.frombuffer(body, np.uint8).reshape(stride, -1) \
            .T.tobytes()
    assert len(body) == raw_len, (len(body), raw_len)
    return body
