"""A plain reader of the checkpoint store's v1-v3 manifests and chunks.

Written from the store's documented layout, not from its code:

    <root>/manifests/[<run>/]<key>.msgpack   a manifest: JSON (or msgpack)
    <root>/objects/<h[:2]>/<h>.zst           a chunk: zlib (or zstd) bytes

A manifest lists its leaves: ``path``, ``dtype``, ``shape`` and either
``chunks`` (every chunk hash; v1 and full v2/v3 manifests) or, in a delta
(``kind == "delta"``), a sparse ``delta`` {index: hash} whose other chunks are
inherited from the ``parent`` manifest, walked until every index is known.
v3 marks each chunk's encoding (``enc`` / ``denc``): "raw" native bytes;
"q8" [u32 n][u32 block][f32 scales][int8 q]; "q4" [u32 n][u32 block]
[f32 scales][u8 nibbles, element j low and j + W/2 high]; a "+z" suffix
wraps either in an entropy stage [u8 magic][u8 stride][u32 length][codec
bytes of the stride-transposed body]. A raw chunk's file name is the
blake2b-128 of its bytes, which ``read_tree`` checks.
"""
from __future__ import annotations

import hashlib
import json
import os
import zlib

import numpy as np

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _decompress(payload: bytes) -> bytes:
    if payload[:4] == ZSTD_MAGIC:
        import zstandard
        return zstandard.ZstdDecompressor().decompress(payload)
    return zlib.decompress(payload)


def _unpack(payload: bytes) -> dict:
    if payload[:1] == b"{":
        return json.loads(payload.decode())
    import msgpack
    return msgpack.unpackb(payload)


def _safe(key: str) -> str:
    return key.replace("/", "_").replace("@", "_at_").replace(":", "_")


class StoreReader:
    """A run's private store (``<run dir>/store``: no namespace)."""

    def __init__(self, root: str):
        self.root = root

    def keys(self) -> list[str]:
        d = os.path.join(self.root, "manifests")
        if not os.path.isdir(d):
            return []
        return sorted(f[:-len(".msgpack")] for f in os.listdir(d)
                      if f.endswith(".msgpack"))

    def manifest(self, key: str, run: str | None = None) -> dict:
        """A manifest of the store, in ``run``'s namespace if given (a
        parent qualified as "<run>::<key>")."""
        parts = [self.root, "manifests"] + ([_safe(run)] if run else []) \
            + [_safe(key) + ".msgpack"]
        with open(os.path.join(*parts), "rb") as f:
            return _unpack(f.read())

    def chunk(self, h: str) -> bytes:
        with open(os.path.join(self.root, "objects", h[:2], h + ".zst"),
                  "rb") as f:
            return _decompress(f.read())

    def resolve(self, key: str) -> list[dict]:
        """Every leaf of ``key`` with its full (hash, encoding) list."""
        m = self.manifest(key)
        run = None
        out = []
        for leaf in m["leaves"]:
            n = int(leaf["n_chunks"]) if "n_chunks" in leaf \
                else len(leaf["chunks"])
            if leaf.get("chunks"):
                hs = list(leaf["chunks"])
                enc = list(leaf.get("enc") or ["raw"] * n)
            else:
                hs, enc = [None] * n, [None] * n
                for i, h in (leaf.get("delta") or {}).items():
                    hs[int(i)] = h
                    enc[int(i)] = (leaf.get("denc") or {}).get(i, "raw")
            out.append({"path": leaf["path"], "dtype": leaf["dtype"],
                        "shape": leaf["shape"], "nbytes": leaf.get("nbytes"),
                        "chunks": hs, "enc": enc})
        parent = m.get("parent") if m.get("kind") == "delta" else None
        while parent is not None and any(None in lf["chunks"] for lf in out):
            prun, pkey = parent.split("::", 1) if "::" in parent \
                else (run, parent)
            run = prun or None
            pm = self.manifest(pkey, run=run)
            by_path = {lf["path"]: lf for lf in pm["leaves"]}
            for lf in out:
                src = by_path.get(lf["path"])
                if src is None:
                    continue
                full = src.get("chunks")
                for i, h in enumerate(lf["chunks"]):
                    if h is not None:
                        continue
                    if full:
                        lf["chunks"][i] = full[i]
                        lf["enc"][i] = (src.get("enc") or ["raw"] * len(
                            full))[i]
                    elif str(i) in (src.get("delta") or {}):
                        lf["chunks"][i] = src["delta"][str(i)]
                        lf["enc"][i] = (src.get("denc") or {}).get(str(i),
                                                                   "raw")
            parent = pm.get("parent") if pm.get("kind") == "delta" else None
        if any(None in lf["chunks"] for lf in out):
            raise ValueError(f"{key}: a chunk no manifest of its chain names")
        return out

    def read_tree(self, key: str) -> dict:
        """{path: (numpy array of the leaf's native bytes as uint8, dtype
        name, shape, whether any chunk was stored lossy)} of checkpoint
        ``key``."""
        out = {}
        for lf in self.resolve(key):
            body = []
            for h, e in zip(lf["chunks"], lf["enc"]):
                raw = self.chunk(h)
                if e == "raw" and hashlib.blake2b(
                        raw, digest_size=16).hexdigest() != h:
                    raise ValueError(f"{key} {lf['path']}: chunk {h} does "
                                     "not hash to its name")
                body.append(decode_chunk(raw, e, lf["dtype"]))
            data = b"".join(body)
            n = lf["nbytes"] if lf["nbytes"] is not None \
                else int(np.prod(lf["shape"], dtype=np.int64)) \
                * itemsize(lf["dtype"])
            out[lf["path"]] = (np.frombuffer(data[:n], np.uint8),
                               lf["dtype"], tuple(lf["shape"]),
                               any(e != "raw" for e in lf["enc"]))
        return out


def itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


def values(raw: np.ndarray, dtype: str) -> np.ndarray:
    """A leaf's native bytes as float64 values."""
    if dtype == "bfloat16":
        return (raw.view(np.uint16).astype(np.uint32) << 16).view(
            np.float32).astype(np.float64)
    return raw.view(np.dtype(dtype)).astype(np.float64)


def _f32_to(x: np.ndarray, dtype: str) -> bytes:
    if dtype == "bfloat16":
        u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
        r = (u + 0x7FFF + ((u >> 16) & 1)) >> 16        # round to nearest even
        return r.astype(np.uint16).tobytes()
    return x.astype(np.dtype(dtype)).tobytes()


def decode_chunk(payload: bytes, enc: str, dtype: str) -> bytes:
    if enc.endswith("+z"):
        stride, n = payload[1], int(np.frombuffer(payload[2:6], np.uint32)[0])
        body = _decompress(payload[6:])
        if stride > 1:
            body = np.frombuffer(body, np.uint8).reshape(stride, -1).T.tobytes()
        payload, enc = body[:n], enc[:-2]
    if enc == "raw":
        return payload
    n = int(np.frombuffer(payload[:4], np.uint32)[0])
    block = int(np.frombuffer(payload[4:8], np.uint32)[0])
    if enc == "q8":
        n_sub = -(-n // block)
        scales = np.frombuffer(payload[8:8 + 4 * n_sub], np.float32)
        q = np.frombuffer(payload[8 + 4 * n_sub:8 + 4 * n_sub + n], np.int8)
        q = np.pad(q.astype(np.float32), (0, n_sub * block - n))
        return _f32_to((q.reshape(n_sub, block) * scales[:, None])
                       .reshape(-1)[:n], dtype)
    if enc == "q4":
        n_sub = (len(payload) - 8) // (4 + block // 2)
        W = n_sub * block
        scales = np.frombuffer(payload[8:8 + 4 * n_sub], np.float32)
        packed = np.frombuffer(payload[8 + 4 * n_sub:], np.uint8)
        lo = (packed & 0xF).astype(np.int16)
        hi = (packed >> 4).astype(np.int16)
        q = np.concatenate([lo - 16 * (lo > 7), hi - 16 * (hi > 7)])[:W]
        return _f32_to((q.astype(np.float32).reshape(n_sub, block)
                        * scales[:, None]).reshape(-1)[:n], dtype)
    raise ValueError(f"unknown chunk encoding {enc!r}")
