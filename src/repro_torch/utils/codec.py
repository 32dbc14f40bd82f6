"""Optional-dependency codecs with stdlib fallbacks.

The container may not ship ``zstandard`` or ``msgpack``; the store (and the
HLO archive) must keep working anyway. Two codecs live here:

* byte compression — zstd when available, else ``zlib``. Decompression
  sniffs the frame magic (zstd: ``28 B5 2F FD``; zlib: first byte ``0x78``),
  so a store written with one codec is readable by a process that has the
  other *writer* but both readers: reading a zstd frame without the
  zstandard module is the only unrecoverable combination, and it raises a
  clear error instead of garbage.
* manifest serialization — msgpack when available, else compact JSON.
  JSON documents start with ``{``; msgpack maps never do (fixmap/map16/map32
  lead bytes are >= 0x80), so the on-disk format is self-describing and the
  file name can stay ``*.msgpack`` either way.

Thread-safety: zstd (de)compressor objects are NOT safe for concurrent use;
per-thread instances are kept (concurrent writers segfaulted). zlib module
functions are safe as-is.
"""
from __future__ import annotations

import json
import threading
import zlib

try:                                   # optional accelerated codecs
    import zstandard as _zstd
except ImportError:                    # pragma: no cover - env dependent
    _zstd = None

try:
    import msgpack as _msgpack
except ImportError:                    # pragma: no cover - env dependent
    _msgpack = None

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
ZLIB_FIRST = 0x78                      # CMF byte for deflate/32K window

have_zstd = _zstd is not None
have_msgpack = _msgpack is not None


class Compressor:
    """Best-available byte compressor with format-sniffing decompression."""

    def __init__(self, level: int = 3):
        self.level = level
        self._tl = threading.local()

    # zstd contexts are per-thread; see module docstring
    @property
    def _cctx(self):
        c = getattr(self._tl, "cctx", None)
        if c is None:
            c = self._tl.cctx = _zstd.ZstdCompressor(level=self.level)
        return c

    @property
    def _dctx(self):
        d = getattr(self._tl, "dctx", None)
        if d is None:
            d = self._tl.dctx = _zstd.ZstdDecompressor()
        return d

    def compress(self, data: bytes) -> bytes:
        if _zstd is not None:
            return self._cctx.compress(data)
        return zlib.compress(data, self.level)

    def decompress(self, payload: bytes) -> bytes:
        if payload[:4] == ZSTD_MAGIC:
            if _zstd is None:
                raise RuntimeError(
                    "payload is zstd-compressed but the 'zstandard' module "
                    "is not installed; install it to read this store")
            return self._dctx.decompress(payload)
        if payload[:1] and payload[0] == ZLIB_FIRST:
            return zlib.decompress(payload)
        # unknown leader: let the best available codec try (covers zstd
        # skippable frames and future formats), error otherwise
        if _zstd is not None:
            return self._dctx.decompress(payload)
        return zlib.decompress(payload)


def pack_obj(obj) -> bytes:
    """Serialize a manifest-like dict (msgpack if available, else JSON)."""
    if _msgpack is not None:
        return _msgpack.packb(obj)
    return json.dumps(obj, separators=(",", ":")).encode()


def unpack_obj(payload: bytes):
    """Inverse of :func:`pack_obj`, sniffing the format."""
    if payload[:1] == b"{":
        return json.loads(payload.decode())
    if _msgpack is None:
        raise RuntimeError(
            "manifest is msgpack-encoded but the 'msgpack' module is not "
            "installed; install it to read this store")
    return _msgpack.unpackb(payload)
