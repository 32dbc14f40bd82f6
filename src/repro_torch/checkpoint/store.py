"""Content-addressed, chunked checkpoint store (lean checkpointing substrate).

Every pytree leaf is serialized to raw bytes, split into chunks, and stored
under its blake2b hash (compressed). A checkpoint is a small manifest mapping
leaf paths to chunk-hash lists.

Dedup IS the paper's "lean checkpointing" at chunk granularity: unchanged
leaves (frozen weights in fine-tuning, optimizer slots of frozen params,
repeated epochs after convergence) share chunks with earlier checkpoints, so
the marginal bytes of a checkpoint track what actually CHANGED — without any
static analysis, because the checkpointed state is explicit (the train
step's TrainState).

Three manifest generations coexist:

* v1 (``put_tree``) — full manifests; every leaf lists every chunk hash.
* v2 (older pipeline manifests) — ``kind`` is ``"full"`` or ``"delta"``. A
  delta manifest names a ``parent`` key and stores only the chunk hashes
  that changed since the parent; unchanged hashes are inherited by walking
  the parent chain at read time (``resolve_manifest``). The pipeline bounds
  chain length by writing a full manifest every K checkpoints, so
  resolution never chases unbounded history.
* v3 (written by ``checkpoint/pipeline.py``) — v2 plus per-chunk ENCODINGS:
  a chunk body is either raw native bytes or a self-describing blockwise
  int8 payload (``"q8"``, kernels/ops.py wire codec). Encodings resolve
  through the parent chain exactly like hashes, and ``get_tree``
  dequantizes transparently, so readers never care which generation wrote a
  chunk.
* v4 (``kind == "sharded"``, mesh-aware pipeline) — a STITCHING manifest: a
  run recorded on a device mesh writes one ordinary v3 full/delta member
  manifest per STORE SHARD (simulated host), each covering only the device
  shards that host owns, plus a global v4 manifest recording the logical
  layout: per-leaf global shape, the recorded physical PartitionSpec, and
  each device shard's index bounds + owning store shard. Members chain
  deltas independently (``<key>.shard<h>`` -> ``<parent>.shard<h>``), so
  delta inheritance works per shard exactly as it does globally.
  ``resolve_manifest`` resolves every member chain; ``get_tree`` stitches —
  or, given a DTensor `like` leaf, reads ONLY the chunks that rank's shard
  overlaps and reshards (checkpoint/mesh.py), which is what lets an
  N-process recording restore bit-identically on an M-process or
  single-process mesh.

Multi-run sharing (run lineage). One store root may be SHARED by many runs:
each run gets a manifest namespace (``run_id``), so checkpoint keys like
``train@2.0`` never collide across runs, while the content-addressed
``objects/`` pool is shared — a fine-tune of a fine-tune stores (and, with
the warm-started pipeline, transfers) only true deltas against its ancestor
run. Cross-run references use QUALIFIED keys, ``"<run_id>::<key>"``
(``"::<key>"`` addresses the flat, un-namespaced layout explicitly — an
UNqualified key always binds to the handle's own namespace): a delta
manifest whose ``parent`` is qualified resolves through the parent run's
namespace transparently; unqualified parents resolve in the namespace of the
manifest that names them. Run records themselves (parent run, final keys,
status) live in ``checkpoint/lineage.py``'s ``RunRegistry`` beside the store.

``gc(live_keys)`` removes manifests outside the parent-closure of the live
set — ACROSS namespaces: a chunk survives while reachable from any live
manifest's chain, so deleting one run's registration reclaims only what no
surviving run inherits. Chunk writes are tmp+rename atomic: chunks are
cross-run shared state, and a truncated chunk from a killed writer must
never be silently inherited by a descendant run.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.utils.codec import Compressor, pack_obj, unpack_obj
from repro_torch.utils.pytree import (keystr, tree_flatten,
                                      tree_flatten_with_path, tree_graft,
                                      tree_unflatten)

CHUNK = 4 * 1024 * 1024

MANIFEST_VERSION = 3

_CURRENT_RUN = object()          # sentinel: list_keys() default namespace


def _leaf_to_np(x) -> tuple[np.ndarray, str]:
    """(host array holding the leaf's bytes, manifest dtype name). Tensors
    come to the host; bfloat16 travels as its uint16 bit pattern, since
    numpy has no bfloat16 type here."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    a = np.asarray(x)
    return a, str(a.dtype)


def _hash(b: bytes) -> str:
    return hashlib.blake2b(b, digest_size=16).hexdigest()


# A chunk file holds 64 KiB of native bytes; a pool's time goes to zlib,
# blake2b and the per-file system calls, all of which release the GIL. The
# batch calls (``put_chunks`` / ``get_chunks``) overlap them over this many
# threads: on an 8-core NVIDIA H100 host, 8 threads put 4.5x the bytes of
# one and got 1.8x (tools/store_io_probe.py).
IO_THREADS = 8


def _pmap(fn: Callable, items: list) -> list:
    """``[fn(x) for x in items]``, over ``IO_THREADS`` threads when there is
    more than one item; results in the items' order."""
    if len(items) < 2:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(min(IO_THREADS, len(items))) as ex:
        return list(ex.map(fn, items))


def np_dtype(name: str) -> np.dtype:
    """Host STORAGE dtype for a manifest dtype string: the numpy dtype of
    the same name, or uint16 for ``bfloat16`` (same bytes, and numpy has no
    bfloat16 type without ml_dtypes)."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    return np.dtype(name)


def _to_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """Host array of a leaf's bytes -> CPU tensor of the manifest dtype."""
    t = torch.from_numpy(arr)
    if name == "bfloat16":
        return t.view(torch.int16).view(torch.bfloat16)
    return t


class CheckpointStore:
    """Thread-safe on-disk store, shareable across runs. Layout:
       <root>/objects/<h[:2]>/<h>.zst        — chunk payloads (shared pool)
       <root>/shards/<host>/objects/...      — per-store-shard pools (mesh
                                               record: each simulated host's
                                               local disk; same addressing)
       <root>/manifests/<key>.msgpack        — un-namespaced manifests
       <root>/manifests/<run>/<key>.msgpack  — per-run manifest namespaces
       <root>/meta/[<run>/]<name>.json       — run-level metadata
       <root>/runs/<run>.json                — RunRegistry records (lineage.py)
    (File extensions are historical; the actual codec is sniffed from
    content, see utils/codec.py.)

    ``run_id`` selects the namespace unqualified keys read and write;
    ``None`` (the default, and the only mode before multi-run sharing) is
    the flat un-namespaced layout. Keys of the form ``"<run>::<key>"`` are
    fully qualified and address any namespace from any handle.
    """

    def __init__(self, root: str, compress_level: int = 3,
                 run_id: Optional[str] = None,
                 prefer_shards: Optional[Iterable] = None):
        self.root = root
        self.run_id = run_id
        # shard-pool read affinity: a multi-host replay worker that only has
        # its own host's pool mounted locally lists those shard ids here, so
        # fallback chunk scans hit local disk first. Purely an ORDERING —
        # content addressing keeps every pool a valid source, so resharded
        # restores that need another host's chunks still work when the
        # store root is shared (network FS).
        self.prefer_shards = [str(s) for s in (prefer_shards or ())]
        os.makedirs(os.path.join(root, "objects"), exist_ok=True)
        os.makedirs(os.path.join(root, "manifests"), exist_ok=True)
        os.makedirs(os.path.join(root, "meta"), exist_ok=True)
        self._codec = Compressor(level=compress_level)
        self._lock = threading.Lock()
        # objects/<h[:2]>/ (and manifest-namespace) fan-out dirs, cached to
        # avoid a mkdir syscall on every chunk (the delta pipeline writes
        # many small chunks)
        self._dirs: set[str] = set()

    # ------------------------------------------------------------ naming --
    def _split_key(self, key: str) -> tuple[Optional[str], str]:
        """(run namespace, run-local key). Unqualified keys belong to this
        handle's namespace."""
        if "::" in key:
            rid, k = key.split("::", 1)
            return rid or None, k
        return self.run_id, key

    def _norm_key(self, key: str) -> tuple[Optional[str], str]:
        """Filesystem-space identity: (sanitized namespace | None, sanitized
        key). Idempotent for already-sanitized names, so raw keys
        ('train@2.0') and list_keys() output ('train_at_2.0') normalize to
        the same tuple."""
        rid, k = self._split_key(key)
        return (_safe(rid) if rid else None, _safe(k))

    def qualify(self, key: str) -> str:
        """This handle's fully-qualified form of a run-local key."""
        if self.run_id and "::" not in key:
            return f"{self.run_id}::{key}"
        return key

    def _ensure_dir(self, d: str):
        if d not in self._dirs:
            os.makedirs(d, exist_ok=True)
            self._dirs.add(d)

    # ------------------------------------------------------------ chunks --
    def _chunk_path(self, h: str, shard=None) -> str:
        """On-disk path of a chunk: the flat shared pool, or (``shard``)
        one store shard's pool — ``shards/<h(ost)>/objects/`` — which in a
        real deployment is that host's local disk."""
        if shard is None:
            base = os.path.join(self.root, "objects")
        else:
            base = os.path.join(self.root, "shards", str(shard), "objects")
        return os.path.join(base, h[:2], h + ".zst")

    def _shard_ids(self) -> list[str]:
        """Store shards with a chunk pool on disk (sorted numerically when
        possible so fallback scans are deterministic)."""
        d = os.path.join(self.root, "shards")
        if not os.path.isdir(d):
            return []
        ids = [e for e in os.listdir(d)
               if os.path.isdir(os.path.join(d, e))]
        return sorted(ids, key=lambda s: (not s.isdigit(),
                                          int(s) if s.isdigit() else s))

    def _find_chunk(self, h: str, shard=None) -> Optional[str]:
        """Locate a chunk, preferring ``shard``'s pool, then the flat pool,
        then every other shard pool. Content addressing makes any copy
        valid; the fallback keeps reads working when a tree is restored on
        a different mesh shape than recorded it."""
        cands = []
        if shard is not None:
            cands.append(self._chunk_path(h, shard))
        for s in self.prefer_shards:
            if shard is None or str(shard) != s:
                cands.append(self._chunk_path(h, s))
        cands.append(self._chunk_path(h))
        seen = {str(shard)} if shard is not None else set()
        seen.update(self.prefer_shards)
        for s in self._shard_ids():
            if s in seen:
                continue
            cands.append(self._chunk_path(h, s))
        for p in cands:
            if os.path.exists(p):
                return p
        return None

    def put_chunk(self, data: bytes, shard=None) -> tuple[str, int, bool]:
        """Store one content-addressed chunk (``shard`` selects a store
        shard's pool — bytes recorded on a host land on that host's disk).
        Returns (hash, compressed_bytes_written, was_new)."""
        h = _hash(data)
        return (h,) + self._put_hashed(h, data, shard)

    def _put_hashed(self, h: str, data: bytes, shard) -> tuple[int, bool]:
        path = self._chunk_path(h, shard)
        if os.path.exists(path):
            return 0, False
        self._ensure_dir(os.path.dirname(path))
        payload = self._codec.compress(data)
        _atomic_write(path, payload)   # chunks are cross-run shared state
        return len(payload), True

    def put_chunks(self, datas: list, shard=None) -> list[tuple[str, int, bool]]:
        """``put_chunk`` over a batch, in parallel (``IO_THREADS``), with
        the results of calling it on each in turn: a hash that repeats
        within the batch is written by its first occurrence only."""
        hashes = _pmap(_hash, datas)
        first: dict[str, int] = {}
        for i, h in enumerate(hashes):
            first.setdefault(h, i)
        todo = sorted(first.values())
        done = dict(zip(todo, _pmap(
            lambda i: self._put_hashed(hashes[i], datas[i], shard), todo)))
        return [(h,) + done.get(i, (0, False)) for i, h in enumerate(hashes)]

    # kept under the old private name too — tests and older callers use it
    _put_chunk = put_chunk

    def get_chunk(self, h: str, shard=None) -> bytes:
        path = self._chunk_path(h, shard)
        if not os.path.exists(path):
            found = self._find_chunk(h, shard)
            if found is None:
                raise FileNotFoundError(
                    f"chunk {h} not in any pool of {self.root}")
            path = found
        with open(path, "rb") as f:
            return self._codec.decompress(f.read())

    _get_chunk = get_chunk

    def get_chunks(self, hashes: list, shard=None) -> list[bytes]:
        """``get_chunk`` over a batch, in parallel (``IO_THREADS``)."""
        return _pmap(lambda h: self.get_chunk(h, shard), list(hashes))

    def _iter_chunk_files(self):
        """Every chunk file across the flat pool and all shard pools as
        (path, filename) — the single sweep gc/stats share."""
        pools = [os.path.join(self.root, "objects")]
        pools += [os.path.join(self.root, "shards", s, "objects")
                  for s in self._shard_ids()]
        for pool in pools:
            for dirpath, _, files in os.walk(pool):
                for fn in files:
                    yield os.path.join(dirpath, fn), fn

    # --------------------------------------------------------- manifests --
    def _mpath(self, rid_safe: Optional[str], key_safe: str) -> str:
        parts = [self.root, "manifests"]
        if rid_safe:
            parts.append(rid_safe)
        parts.append(key_safe + ".msgpack")
        return os.path.join(*parts)

    def _manifest_path(self, key: str) -> str:
        return self._mpath(*self._norm_key(key))

    def put_manifest(self, manifest: dict, key: Optional[str] = None):
        """Atomically persist a manifest (crash-safe tmp+rename). ``key``
        defaults to the manifest's own (run-local) key."""
        mpath = self._manifest_path(key if key is not None
                                    else manifest["key"])
        self._ensure_dir(os.path.dirname(mpath))
        _atomic_write(mpath, pack_obj(manifest))

    def get_manifest(self, key: str) -> dict:
        with open(self._manifest_path(key), "rb") as f:
            return unpack_obj(f.read())

    def delete_manifest(self, key: str, delete_chunks: bool = False):
        """Remove one manifest; optionally its directly-listed chunks.
        ``delete_chunks`` is only safe when the caller knows the chunks are
        not shared (e.g. the unique random calibration probe)."""
        if delete_chunks:
            try:
                m = self.get_manifest(key)
            except FileNotFoundError:
                m = None
            if m is not None:
                for h in _manifest_chunk_hashes(m):
                    try:
                        os.remove(self._chunk_path(h))
                    except FileNotFoundError:
                        pass
        try:
            os.remove(self._manifest_path(key))
        except FileNotFoundError:
            pass

    def _load_tuple(self, t: tuple, cache: dict) -> Optional[dict]:
        """Memoized manifest read by normalized (rid, key) tuple; None for a
        missing file. Shared by stats() and gc() so each manifest is read at
        most once per pass."""
        if t not in cache:
            try:
                with open(self._mpath(*t), "rb") as f:
                    cache[t] = unpack_obj(f.read())
            except FileNotFoundError:
                cache[t] = None
        return cache[t]

    def _parent_of(self, manifest: dict,
                   child_rid_safe: Optional[str]) -> Optional[tuple]:
        """Normalized (rid, key) of a manifest's parent. Unqualified parents
        live in the same namespace as the child manifest."""
        parent = manifest.get("parent")
        if not parent:
            return None
        if "::" in parent:
            rid, k = parent.split("::", 1)
            return (_safe(rid) if rid else None, _safe(k))
        return (child_rid_safe, _safe(parent))

    def resolve_manifest(self, key: str, _max_depth: int = 10_000) -> dict:
        """Return a manifest with every leaf's full chunk-hash list, walking
        the delta parent chain as needed — across run namespaces when the
        chain crosses a run boundary (warm-started derived runs). v1 and
        full v2 manifests return (normalized) as-is."""
        cur_rid, _ = self._split_key(key)
        manifest = self.get_manifest(key)
        if manifest.get("kind") == "sharded":
            # v4 stitching manifest: resolve every member chain. Members are
            # plain v3 full/delta manifests (one per store shard) living in
            # the SAME namespace as the global key, so each member chain
            # inherits deltas independently, across run lineage included.
            resolved = dict(manifest)
            members: dict[int, dict] = {}
            hops = 0
            for hid, mkey in (manifest.get("members") or {}).items():
                mres = self.resolve_manifest(f"{cur_rid or ''}::{mkey}",
                                             _max_depth=_max_depth)
                members[int(hid)] = mres
                hops = max(hops, int(mres.get("hops", 0)))
            resolved["members_resolved"] = members
            # a restore pays the DEEPEST member chain (shards resolve in
            # parallel on their owning hosts)
            resolved["hops"] = hops
            return resolved
        if manifest.get("version", 1) < 2 or manifest.get("kind", "full") == "full":
            return manifest
        # delta: seed hole-filled lists from this manifest, then walk
        # parents. Per-chunk encodings (v3) resolve alongside the hashes: an
        # enc slot is filled from whichever manifest supplied the chunk.
        leaves = []
        unresolved: dict[str, dict] = {}
        for leaf in manifest["leaves"]:
            n = int(leaf["n_chunks"])
            if leaf.get("chunks"):
                # already-complete list (e.g. a re-saved resolved manifest)
                chunks = list(leaf["chunks"])
                enc = list(leaf.get("enc") or ["raw"] * n)
            else:
                chunks = [None] * n
                enc = [None] * n
                denc = leaf.get("denc") or {}
                for i, h in (leaf.get("delta") or {}).items():
                    chunks[int(i)] = h
                    enc[int(i)] = denc.get(i, "raw")
            out = dict(leaf)
            out.pop("delta", None)
            out.pop("denc", None)
            out["chunks"] = chunks
            out["_enc"] = enc
            leaves.append(out)
            if any(c is None for c in chunks):
                unresolved[leaf["path"]] = out
        parent = manifest.get("parent")
        depth = 0
        while unresolved and parent is not None:
            depth += 1
            if depth > _max_depth:
                raise RuntimeError(f"delta chain too deep resolving {key!r}")
            if "::" in parent:
                cur_rid, parent = parent.split("::", 1)
                cur_rid = cur_rid or None
            # always re-qualify: "::key" is the explicit flat form — a bare
            # key would rebind to THIS handle's namespace
            pkey = f"{cur_rid or ''}::{parent}"
            try:
                pm = self.get_manifest(pkey)
            except FileNotFoundError as e:
                raise RuntimeError(
                    f"delta manifest {key!r} references missing parent "
                    f"{pkey!r} — deleted outside store.gc (which retains "
                    f"the parent closure across run lineage)?") from e
            by_path = {lf["path"]: lf for lf in pm["leaves"]}
            for path, out in list(unresolved.items()):
                src = by_path.get(path)
                if src is None:
                    continue
                if "chunks" in src and src["chunks"] is not None:
                    senc = src.get("enc")
                    for i, c in enumerate(out["chunks"]):
                        if c is None:
                            out["chunks"][i] = src["chunks"][i]
                            out["_enc"][i] = senc[i] if senc else "raw"
                else:
                    sdenc = src.get("denc") or {}
                    for i_s, h in (src.get("delta") or {}).items():
                        i = int(i_s)
                        if out["chunks"][i] is None:
                            out["chunks"][i] = h
                            out["_enc"][i] = sdenc.get(i_s, "raw")
                if all(c is not None for c in out["chunks"]):
                    del unresolved[path]
            parent = pm.get("parent") \
                if pm.get("version", 1) >= 2 and pm.get("kind") == "delta" \
                else None
        if unresolved:
            missing = {p: [i for i, c in enumerate(o["chunks"]) if c is None]
                       for p, o in unresolved.items()}
            raise RuntimeError(
                f"unresolvable delta manifest {key!r}: missing chunks "
                f"{missing} (parent chain broken — was the store gc'd with "
                f"an incomplete live set?)")
        for out in leaves:
            enc = ["raw" if e is None else e for e in out.pop("_enc")]
            if any(e != "raw" for e in enc):
                out["enc"] = enc
            else:
                out.pop("enc", None)
        resolved = dict(manifest)
        resolved["leaves"] = leaves
        # parent hops this resolution actually walked — restore accounting
        # feeds it to the learned cost model (calibration meta "hop_s")
        resolved["hops"] = depth
        return resolved

    # ------------------------------------------------------------- trees --
    def put_tree(self, key: str, tree: Any, meta: Optional[dict] = None) -> dict:
        """Serialize a pytree of arrays as a v1 full manifest.
        Returns stats incl. dedup savings. (The delta-aware record path lives
        in checkpoint/pipeline.py; this remains the simple whole-tree API.)"""
        flat, treedef = tree_flatten_with_path(tree)
        leaves = []
        new_bytes = 0
        total_bytes = 0
        new_chunks = 0
        total_chunks = 0
        for path, leaf in flat:
            arr, dtype = _leaf_to_np(leaf)
            raw = arr.tobytes()
            pieces = [raw[off:off + CHUNK]
                      for off in range(0, max(len(raw), 1), CHUNK)]
            chunks = []
            for piece, (h, nb, new) in zip(pieces, self.put_chunks(pieces)):
                chunks.append(h)
                new_bytes += nb
                total_bytes += len(piece)
                new_chunks += int(new)
                total_chunks += 1
            leaves.append({
                "path": keystr(path),
                "dtype": dtype,
                "shape": list(arr.shape),
                "chunks": chunks,
            })
        manifest = {
            "key": self._split_key(key)[1],
            "treedef": str(treedef),
            "leaves": leaves,
            "meta": meta or {},
        }
        self.put_manifest(manifest, key=key)
        return {"key": key, "total_bytes": total_bytes, "new_bytes": new_bytes,
                "total_chunks": total_chunks, "new_chunks": new_chunks}

    def get_tree(self, key: str, like: Any = None,
                 manifest: Optional[dict] = None,
                 stats_out: Optional[dict] = None):
        """Load a checkpoint (delta manifests resolve transparently, across
        run lineage) as torch tensors. If `like` (a pytree with the same
        structure) is given, tensors are unflattened into that structure, each
        on its `like` leaf's device; otherwise a flat {path: CPU tensor} dict
        is returned. Pass a pre-``resolve_manifest``'d `manifest` to skip
        re-resolution. Returned tensors own WRITABLE copies of the bytes.

        v4 sharded manifests stitch through checkpoint/mesh.py: a DTensor
        `like` leaf restores SELECTIVELY (this rank reads only the chunks its
        shard overlaps) to a DTensor of the same mesh and placements; other
        leaves stitch whole. ``stats_out`` (a dict, sharded path only)
        receives read accounting: {chunks_read, bytes_by_shard}."""
        if manifest is None:
            manifest = self.resolve_manifest(key)
        if manifest.get("kind") == "sharded":
            from repro_torch.checkpoint.mesh import stitch_tree
            return stitch_tree(self, manifest, like=like,
                               stats_out=stats_out)
        arrays = []
        for leaf in manifest["leaves"]:
            dt = np_dtype(leaf["dtype"])
            enc = leaf.get("enc")
            if enc and any(e != "raw" for e in enc):
                # encoded chunks decode transparently to native bytes — q8,
                # q4, and entropy-compressed ("+z") payloads alike (deferred
                # import: the wire codecs live with the kernels)
                from repro_torch.kernels.ops import decode_wire_chunk
                raw = b"".join(
                    decode_wire_chunk(c, e, leaf["dtype"])
                    for c, e in zip(self.get_chunks(leaf["chunks"]), enc))
            else:
                raw = b"".join(self.get_chunks(leaf["chunks"]))
            nbytes = int(leaf.get("nbytes",
                                  int(np.prod(leaf["shape"], dtype=np.int64))
                                  * dt.itemsize))
            arr = np.frombuffer(raw[:nbytes], dtype=dt).copy()
            arrays.append(_to_tensor(arr.reshape(leaf["shape"]),
                                     leaf["dtype"]))
        if like is not None:
            flat, treedef = tree_flatten(like)
            if len(flat) == len(arrays):
                arrays = [a.to(lk.device) if isinstance(lk, torch.Tensor)
                          else a for lk, a in zip(flat, arrays)]
                return tree_unflatten(treedef, arrays)
            # an empty dict of `like` (a script-tier changeset variable
            # still at its first value `{}`) takes the dicts the checkpoint
            # holds at its path, on the device of `like`'s tensors
            dev = next((x.device for x in flat
                        if isinstance(x, torch.Tensor)), None)
            try:
                return tree_graft(like, {leaf["path"]: a for leaf, a in
                                         zip(manifest["leaves"], arrays)},
                                  dev)
            except (KeyError, ValueError):
                raise ValueError(f"structure mismatch: like has {len(flat)}"
                                 f" leaves, checkpoint {len(arrays)}") \
                    from None
        return {leaf["path"]: a for leaf, a in zip(manifest["leaves"], arrays)}

    def has(self, key: str) -> bool:
        return os.path.exists(self._manifest_path(key))

    def list_keys(self, run=_CURRENT_RUN) -> list[str]:
        """Sanitized run-local manifest names in one namespace (default:
        this handle's)."""
        rid = self.run_id if run is _CURRENT_RUN else run
        d = os.path.join(self.root, "manifests")
        if rid:
            d = os.path.join(d, _safe(rid))
        if not os.path.isdir(d):
            return []
        return sorted(f[: -len(".msgpack")] for f in os.listdir(d)
                      if f.endswith(".msgpack")
                      and not os.path.isdir(os.path.join(d, f)))

    def list_namespaces(self) -> list[str]:
        """Sanitized run namespaces that have at least one manifest dir."""
        d = os.path.join(self.root, "manifests")
        return sorted(e for e in os.listdir(d)
                      if os.path.isdir(os.path.join(d, e)))

    def _iter_manifest_tuples(self):
        """Every manifest in the store as (rid_safe | None, key_safe)."""
        for k in self.list_keys(run=None):
            yield (None, k)
        for rid in self.list_namespaces():
            for k in self.list_keys(run=rid):
                yield (rid, k)

    # --------------------------------------------------------------- stats --
    def stats(self, keys: Optional[Iterable[str]] = None,
              include_chunks: bool = True, per_key: bool = False) -> dict:
        """Single-pass, memoized summary of manifests (default: the whole
        store; pass `keys` — possibly qualified — to restrict to one run's
        manifests while chain depths still follow parents across runs).
        Returns {manifests, full_manifests, delta_manifests, max_chain_depth,
        chunks, stored_bytes}. Chain depth is the number of parent hops a
        restore resolves; broken links (missing parents) end the chain
        rather than raising — this is a diagnostic, not a restore.
        `include_chunks=False` skips the objects-pool walk (O(store) stat
        calls on a large shared pool) and reports chunks/stored_bytes as
        0 — use it when only manifest counts/depths are needed.
        `per_key=True` adds a ``per_key`` map {input key: {depth, kind,
        direct_chunks}} — the resume-cost raw material the replay planner
        turns into per-segment estimates."""
        cache: dict[tuple, Optional[dict]] = {}

        def load(t):
            return self._load_tuple(t, cache)

        if keys is not None:
            key_list = list(keys)
            targets = [self._norm_key(k) for k in key_list]
        else:
            key_list = None
            targets = list(self._iter_manifest_tuples())
        depth: dict[tuple, int] = {}
        counts = {"full": 0, "delta": 0}
        max_depth = 0
        n_manifests = 0
        info: dict[tuple, dict] = {}

        def walk(t0) -> int:
            """Chain depth of one manifest tuple — walk up to the first
            memoized ancestor (or the chain end), then unwind; every
            manifest is read at most once store-wide."""
            chain: list[tuple] = []
            seen: set[tuple] = set()
            t = t0
            while t is not None and t not in depth and t not in seen:
                seen.add(t)
                mm = load(t)
                if mm is None:
                    depth[t] = 0          # broken link: chain ends here
                    break
                chain.append(t)
                t = self._parent_of(mm, t[0])
            for node in reversed(chain):
                p = self._parent_of(load(node), node[0])
                depth[node] = depth[p] + 1 if p is not None and p in depth \
                    else (1 if p is not None and p in seen else 0)
            return depth.get(t0, 0)

        for t0 in targets:
            m = load(t0)
            if m is None:
                continue
            n_manifests += 1
            kind = m.get("kind", "full") if m.get("version", 1) >= 2 else "full"
            counts[kind] = counts.get(kind, 0) + 1
            d0 = walk(t0)
            shards_info = None
            if kind == "sharded":
                # v4: depth/chunks live on the per-store-shard member
                # chains; a restore pays the deepest one (shards resolve in
                # parallel), so that is the depth reported for the key
                shards_info = {}
                for hid, mkey in (m.get("members") or {}).items():
                    mt = (t0[0], _safe(mkey))
                    mm = load(mt)
                    if mm is None:
                        continue
                    shards_info[str(hid)] = {
                        "depth": walk(mt),
                        "chunks": sum(1 for _ in _manifest_chunk_hashes(mm)),
                    }
                if shards_info:
                    d0 = max(s["depth"] for s in shards_info.values())
            max_depth = max(max_depth, d0)
            if per_key:
                direct = sum(1 for _ in _manifest_chunk_hashes(m))
                encc = _manifest_enc_counts(m)
                if shards_info:
                    direct = sum(s["chunks"] for s in shards_info.values())
                    encc = {}
                    for hid, mkey in (m.get("members") or {}).items():
                        mm = load((t0[0], _safe(mkey)))
                        if mm is None:
                            continue
                        for e, c in _manifest_enc_counts(mm).items():
                            encc[e] = encc.get(e, 0) + c
                info[t0] = {"depth": d0, "kind": kind,
                            "direct_chunks": direct,
                            "enc_counts": encc}
                if shards_info is not None:
                    info[t0]["shards"] = shards_info
        chunks = 0
        stored = 0
        if include_chunks:
            for p, fn in self._iter_chunk_files():
                if fn.endswith(".zst"):
                    chunks += 1
                    stored += os.path.getsize(p)
        out = {"manifests": n_manifests,
               "full_manifests": counts.get("full", 0),
               "delta_manifests": counts.get("delta", 0),
               "sharded_manifests": counts.get("sharded", 0),
               "max_chain_depth": max_depth,
               "chunks": chunks, "stored_bytes": stored}
        if per_key:
            if key_list is not None:
                out["per_key"] = {k: info[self._norm_key(k)]
                                  for k in key_list
                                  if self._norm_key(k) in info}
            else:
                # whole-store pass: qualified "rid::key" form ("::key" =
                # explicit flat namespace)
                out["per_key"] = {f"{rid or ''}::{k}": v
                                  for (rid, k), v in info.items()}
        return out

    def encoding_mix(self, key: str) -> dict:
        """Resolved per-encoding storage mix of one checkpoint: for every
        chunk a restore of `key` reads (chain-inherited included),
        {enc: {"chunks": n, "stored_bytes": b}} with b the on-disk
        (compressed) size — dedup-shared chunks count once per reference,
        matching what a restore actually reads. v4 sharded keys aggregate
        over all member manifests."""
        m = self.resolve_manifest(key)
        mix: dict[str, dict] = {}
        size_cache: dict[str, int] = {}

        def chunk_size(h: str) -> int:
            if h not in size_cache:
                p = self._find_chunk(h)
                try:
                    size_cache[h] = os.path.getsize(p) if p else 0
                except OSError:
                    size_cache[h] = 0
            return size_cache[h]

        def add_leaves(leaves):
            for leaf in leaves:
                enc = leaf.get("enc")
                for i, h in enumerate(leaf.get("chunks") or []):
                    if h is None:
                        continue
                    e = enc[i] if enc else "raw"
                    d = mix.setdefault(e, {"chunks": 0, "stored_bytes": 0})
                    d["chunks"] += 1
                    d["stored_bytes"] += chunk_size(h)

        if m.get("kind") == "sharded":
            for mm in (m.get("members_resolved") or {}).values():
                add_leaves(mm["leaves"])
        else:
            add_leaves(m["leaves"])
        return mix

    # ------------------------------------------------------------ closure --
    def _parent_closure(self, keys: Iterable[str],
                        cache: dict) -> set[tuple]:
        """Normalized (rid, key) tuples of `keys` plus every ancestor their
        delta chains resolve through (across run namespaces) AND, for v4
        sharded manifests, their per-store-shard member manifests — a live
        stitching manifest pins every shard chain it stitches, so multi-run
        gc can never collect a live shard's chunks. Tuples whose manifest is
        missing are dropped."""
        live = {self._norm_key(k) for k in keys}
        frontier = list(live)
        while frontier:
            t = frontier.pop()
            m = self._load_tuple(t, cache)
            if m is None:
                live.discard(t)
                continue
            nxt = []
            p = self._parent_of(m, t[0])
            if p is not None:
                nxt.append(p)
            # sharded (v4) members live in the global key's namespace
            for mkey in (m.get("members") or {}).values():
                nxt.append((t[0], _safe(mkey)))
            for p in nxt:
                if p not in live:
                    live.add(p)
                    frontier.append(p)
        return live

    def closure_chunks(self, keys: Iterable[str]) -> set[str]:
        """Every chunk hash reachable from `keys`' manifest parent closure —
        the byte footprint a set of checkpoints actually pins. Two runs'
        closures intersected/differenced give the `runs diff` view of what
        lineage sharing saves."""
        cache: dict[tuple, Optional[dict]] = {}
        hashes: set[str] = set()
        for t in self._parent_closure(keys, cache):
            m = self._load_tuple(t, cache)
            if m is not None:
                hashes.update(_manifest_chunk_hashes(m))
        return hashes

    def chunk_bytes(self, hashes: Iterable[str]) -> int:
        """On-disk (compressed) bytes of the given chunk hashes, wherever
        they live (flat or shard pools); missing chunks count 0."""
        total = 0
        for h in hashes:
            p = self._find_chunk(h)
            if p is not None:
                try:
                    total += os.path.getsize(p)
                except OSError:
                    pass
        return total

    # ---------------------------------------------------------------- gc --
    def gc(self, live_keys: Iterable[str]) -> dict:
        """Delete manifests outside the parent-closure of ``live_keys`` and
        every chunk no surviving manifest references. The closure follows
        delta parents ACROSS run namespaces (qualified ``run::key`` refs), so
        a derived run pins exactly the ancestor manifests its chain resolves
        through — a chunk survives while ANY live run can still reach it.
        Returns {kept_manifests, deleted_manifests, kept_chunks,
        deleted_chunks, deleted_bytes}."""
        with self._lock:
            cache: dict[tuple, Optional[dict]] = {}

            def load(t):
                return self._load_tuple(t, cache)

            # normalize to filesystem-space (rid, key) tuples (callers pass
            # raw keys, listings yield sanitized names) and take the parent
            # closure: a live delta manifest pins its ancestry, run
            # boundaries included
            live = self._parent_closure(live_keys, cache)
            referenced: set[str] = set()
            deleted_manifests = 0
            namespaces: set[Optional[str]] = set()
            for t in list(self._iter_manifest_tuples()):
                namespaces.add(t[0])
                if t not in live:
                    try:
                        os.remove(self._mpath(*t))
                    except FileNotFoundError:
                        pass
                    deleted_manifests += 1
                    continue
                m = load(t)
                if m is not None:
                    referenced.update(_manifest_chunk_hashes(m))
            for rid in namespaces:       # drop emptied namespace dirs
                if rid:
                    try:
                        os.rmdir(os.path.join(self.root, "manifests", rid))
                    except OSError:
                        pass
            kept = deleted = deleted_bytes = deleted_tmp = 0
            now = time.time()
            # sweep the flat pool AND every store shard's pool — a chunk
            # hash is live wherever it lives
            for p, fn in self._iter_chunk_files():
                if not fn.endswith(".zst"):
                    # stray .tmp from a KILLED writer (the in-process
                    # failure path unlinks its own): reclaim once aged —
                    # a live writer holds a tmp for milliseconds, so the
                    # age gate never races an in-flight _atomic_write
                    deleted_tmp += _reclaim_stale_tmp(p, now)
                    continue
                h = fn[: -len(".zst")]
                if h in referenced:
                    kept += 1
                else:
                    deleted_bytes += os.path.getsize(p)
                    os.remove(p)
                    deleted += 1
            for dirpath, _, files in os.walk(os.path.join(self.root,
                                                          "manifests")):
                for fn in files:
                    if not fn.endswith(".msgpack"):
                        deleted_tmp += _reclaim_stale_tmp(
                            os.path.join(dirpath, fn), now)
            return {"kept_manifests": len(live), "deleted_manifests": deleted_manifests,
                    "kept_chunks": kept, "deleted_chunks": deleted,
                    "deleted_bytes": deleted_bytes,
                    "deleted_tmp_files": deleted_tmp}

    # -------------------------------------------------------------- meta --
    def _meta_path(self, name: str) -> str:
        parts = [self.root, "meta"]
        if self.run_id:
            parts.append(_safe(self.run_id))
        parts.append(_safe(name) + ".json")
        return os.path.join(*parts)

    def put_meta(self, name: str, obj: dict):
        path = self._meta_path(name)
        self._ensure_dir(os.path.dirname(path))
        _atomic_write(path, json.dumps(obj, indent=1, default=str).encode())

    def get_meta(self, name: str) -> Optional[dict]:
        path = self._meta_path(name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def stored_bytes(self) -> int:
        total = 0
        for p, _ in self._iter_chunk_files():
            total += os.path.getsize(p)
        return total

    def shard_stored_bytes(self) -> dict:
        """On-disk bytes per store shard pool — the `runs show` per-shard
        breakdown."""
        out: dict[str, int] = {}
        for s in self._shard_ids():
            total = 0
            pool = os.path.join(self.root, "shards", s, "objects")
            for dirpath, _, files in os.walk(pool):
                for fn in files:
                    total += os.path.getsize(os.path.join(dirpath, fn))
            out[s] = total
        return out


def _atomic_write(path: str, payload: bytes):
    """Crash-safe write: tmp file + atomic rename, tmp unlinked on failure.
    A killed writer can leave a stray ``*.tmp.*`` (ignored by every reader
    and by gc's chunk sweep) but never a truncated object under its final
    name — which matters doubly now that chunks are shared across runs."""
    tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)          # atomic: crash-safe
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


STALE_TMP_S = 60.0       # a live _atomic_write holds its tmp far less


def _reclaim_stale_tmp(path: str, now: float) -> int:
    """Delete one stray ``*.tmp.*`` file if it is old enough that no live
    writer can still own it. Returns 1 if reclaimed."""
    if ".tmp." not in os.path.basename(path):
        return 0
    try:
        if now - os.path.getmtime(path) > STALE_TMP_S:
            os.remove(path)
            return 1
    except OSError:
        pass
    return 0


def _manifest_chunk_hashes(manifest: dict):
    """Every chunk hash DIRECTLY listed by a manifest (no chain resolution —
    ancestors list their own)."""
    for leaf in manifest["leaves"]:
        for h in leaf.get("chunks") or []:
            if h is not None:
                yield h
        for h in (leaf.get("delta") or {}).values():
            yield h


def _manifest_enc_counts(manifest: dict) -> dict:
    """Per-encoding chunk counts of the chunks DIRECTLY listed by a manifest
    (chunks without a recorded encoding count as "raw")."""
    counts: dict[str, int] = {}
    for leaf in manifest.get("leaves") or []:
        enc = leaf.get("enc")
        for i, h in enumerate(leaf.get("chunks") or []):
            if h is None:
                continue
            e = enc[i] if enc else "raw"
            counts[e] = counts.get(e, 0) + 1
        denc = leaf.get("denc") or {}
        for i in (leaf.get("delta") or {}):
            e = denc.get(i, "raw")
            counts[e] = counts.get(e, 0) + 1
    return counts


_MEMBER_RE = None


def member_base(key: str) -> Optional[str]:
    """Base checkpoint key of a sharded MEMBER manifest name
    (``train_at_2.0.shard3`` -> ``train_at_2.0``; raw ``train@2.0.shard3``
    works too); ``None`` for non-member keys. Used by live-set construction
    (lineage.live_keys, context gc): a member whose global v4 stitch was
    never written — a host crashed between member publication and the
    stitch — must NOT seed the gc closure, or the orphans it left would be
    pinned forever. Members of STITCHED checkpoints need no seeding: the
    v4 manifest pulls them (and, through per-shard parent chains, every
    incomplete predecessor a later delta still inherits from) into the
    closure."""
    global _MEMBER_RE
    if _MEMBER_RE is None:
        import re
        _MEMBER_RE = re.compile(r"^(?P<base>.+)\.shard\d+$")
    m = _MEMBER_RE.match(key)
    return m.group("base") if m else None


def filter_orphan_members(keys: Iterable[str]) -> list[str]:
    """Drop member-manifest names whose base (stitched v4) key is absent
    from the SAME listing — the gc-seed form of the orphan rule above."""
    keys = list(keys)
    present = set(keys)
    return [k for k in keys
            if (lambda b: b is None or b in present)(member_base(k))]


def _safe(key: str) -> str:
    return key.replace("/", "_").replace("@", "_at_").replace(":", "_")
