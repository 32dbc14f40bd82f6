"""Mesh-sharded record/restore geometry for the checkpoint pipeline.

Record side: ``device_maps`` + ``owned_shards`` enumerate, per pytree leaf,
the disjoint shards this process owns together with each shard's global
index bounds and owning STORE SHARD. A leaf is a ``DTensor`` on a
``DeviceMesh`` with one process per mesh position; the shard of a rank is
its local tensor, at the bounds ``compute_local_shape_and_global_offset``
gives. A replicated shard is owned by the rank at coordinate 0 on every
``Replicate`` mesh dim — the reference package's ``replica_id == 0`` — so
the owners of the fleet cover every leaf exactly once. The pipeline runs
the fused fingerprint+gather pass on each shard's own contiguous buffer
and writes its chunks to that shard's pool: bytes never leave their rank's
device except to its own store shard. The shard ids, store shards, bounds
and recorded specs are the ones the reference writes for the same mesh
shape, so the two packages' manifests agree.

Restore side: ``stitch_tree`` rebuilds a tree from a v4 stitching manifest.
A target DTensor (a sharded `like` leaf, or a spec re-resolved on a new
mesh via ``parallel.sharding.respec``) is assembled on each rank from ONLY
the recorded chunks its own index box overlaps — chunk ranges come from the
box's byte envelope in the recorded shard's local row-major layout — and
wrapped with ``DTensor.from_local``, so an N-process recording restores
onto an M-process (or single-process) mesh reading just what each rank's
layout needs, with no collective.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import _to_tensor, np_dtype


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


# ------------------------------------------------------------ record side --
def mesh_meta(mesh, shard_axes=()) -> dict:
    """Serializable description of the recording layout for manifest v4 /
    store meta: mesh axes in order, the store-shard axes, and counts."""
    from repro_torch.parallel.sharding import mesh_axis_sizes
    sizes = mesh_axis_sizes(mesh)
    sa = [str(a) for a in (shard_axes or sizes)]
    n_store = 1
    for a in sa:
        n_store *= sizes[a]
    return {"axes": [[a, n] for a, n in sizes.items()],
            "shard_axes": sa,
            "n_devices": int(mesh.mesh.numel()),
            "n_store_shards": n_store}


def device_maps(mesh, shard_axes=()) -> tuple[dict, dict]:
    """({rank: ordinal}, {rank: store_shard}).

    The ordinal is the rank's flat index in ``mesh.mesh`` (the stable shard
    id manifests record). The store shard is the flat index of the rank's
    coordinates restricted to ``shard_axes`` — the default ``()`` means ALL
    mesh axes: one store shard per mesh position."""
    names = [str(a) for a in mesh.mesh_dim_names]
    sa = [str(a) for a in (shard_axes or names)]
    for a in sa:
        if a not in names:
            raise ValueError(f"ckpt_shard_axes entry {a!r} is not a mesh "
                             f"axis (mesh axes: {names})")
    grid = mesh.mesh.cpu().numpy()
    dims = grid.shape
    sel = [names.index(a) for a in sa]
    ords: dict[int, int] = {}
    hosts: dict[int, int] = {}
    for flat, idx in enumerate(np.ndindex(*dims)):
        r = int(grid[idx])
        ords[r] = flat
        h = 0
        for axpos in sel:
            h = h * dims[axpos] + idx[axpos]
        hosts[r] = h
    return ords, hosts


def owned_shards(leaf, mesh, ords: dict, hosts: dict,
                 process_index: Optional[int] = None,
                 anchor: tuple[int, int] = (0, 0)) -> list[dict]:
    """This process's owner shards of one leaf: [{sid, hid, bounds, data},
    ...] sorted by sid, where ``bounds`` is the shard's global index box
    ``[[lo, hi), ...]`` and ``data`` its own contiguous tensor.

    A DTensor on ``mesh`` contributes this rank's local shard when the
    rank owns it (coordinate 0 on every Replicate mesh dim), else nothing.
    Any other leaf (a plain tensor, numpy array or Python scalar) is the
    same value on every process: a single-process record files it whole
    under (0, 0); in a fleet (``process_index`` set) only process 0 files
    it, under ``anchor`` — the (sid, hid) of process 0's mesh position —
    keeping every byte inside a pool its writer owns."""
    if _is_dtensor(leaf):
        from torch.distributed.tensor import Replicate

        from repro_torch.parallel.sharding import local_box
        if leaf.device_mesh != mesh:
            raise ValueError("a DTensor leaf lies on another mesh than the "
                             "record's; place it on the record mesh")
        rank = int(mesh.get_rank())
        coord = mesh.get_coordinate()
        if any(isinstance(p, Replicate) and c != 0
               for p, c in zip(leaf.placements, coord)):
            return []
        return [{"sid": ords[rank], "hid": hosts[rank],
                 "bounds": local_box(leaf.shape, mesh, leaf.placements),
                 "data": leaf.to_local().contiguous()}]
    if process_index is not None and process_index != 0:
        return []
    sid, hid = anchor if process_index is not None else (0, 0)
    full = [[0, int(d)] for d in getattr(leaf, "shape", ())]
    return [{"sid": sid, "hid": hid, "bounds": full, "data": leaf}]


def local_anchor(mesh, ords: dict, hosts: dict,
                 process_index: int) -> tuple[int, int]:
    """(sid, hid) of ``process_index``'s mesh position — the pool host and
    off-mesh leaves are filed under in a fleet record. (0, 0) for a
    process outside the mesh."""
    if process_index in ords:
        return ords[process_index], hosts[process_index]
    return 0, 0


def leaf_spec_entries(leaf) -> Optional[list]:
    """The recorded physical spec of a DTensor leaf in
    ``parallel.sharding.spec_entries`` form (None for other leaves) — what
    a resharded restore re-resolves on the target mesh."""
    if not _is_dtensor(leaf):
        return None
    from repro_torch.parallel.sharding import (spec_entries,
                                               spec_from_placements)
    return spec_entries(spec_from_placements(leaf.placements, leaf.ndim,
                                             leaf.device_mesh))


# ----------------------------------------------------------------- box math --
def box_intersect(a, b) -> Optional[list]:
    """Intersection of two index boxes ([] = scalar box, full overlap);
    None when empty."""
    out = []
    for (al, ah), (bl, bh) in zip(a, b):
        lo, hi = max(int(al), int(bl)), min(int(ah), int(bh))
        if lo >= hi:
            return None
        out.append([lo, hi])
    return out


def chunk_range(rec_bounds, box, itemsize: int, chunk_bytes: int,
                n_chunks: int) -> tuple[int, int]:
    """Chunk index range [lo, hi) of a recorded shard's chunking that
    covers ``box`` (global coords, inside ``rec_bounds``): the byte
    envelope from the first to the last element of the box in the shard's
    local row-major layout. Exact for leading-dim sharding; a conservative
    superset when the box is a strided sub-block."""
    local = [hi - lo for lo, hi in rec_bounds]
    strides = []
    s = 1
    for d in reversed(local):
        strides.append(s)
        s *= d
    strides.reverse()
    first = sum((bl - rl) * st
                for (bl, _), (rl, _), st in zip(box, rec_bounds, strides))
    last = sum((bh - 1 - rl) * st
               for (_, bh), (rl, _), st in zip(box, rec_bounds, strides))
    lo = (first * itemsize) // chunk_bytes
    hi = -(-((last + 1) * itemsize) // chunk_bytes)
    return max(0, lo), min(n_chunks, hi)


# ---------------------------------------------------------------- restore --
def _member_leaves(resolved_member: dict) -> dict:
    """{member leaf path: leaf} with a one-shot cache on the member."""
    cached = resolved_member.get("_by_path")
    if cached is None:
        cached = {lf["path"]: lf for lf in resolved_member["leaves"]}
        resolved_member["_by_path"] = cached
    return cached


def _note_read(stats: Optional[dict], hid: int, nbytes: int, n: int):
    if stats is None:
        return
    stats["chunks_read"] = stats.get("chunks_read", 0) + n
    by = stats.setdefault("bytes_by_shard", {})
    by[hid] = by.get(hid, 0) + nbytes


def _read_shard_range(store, mleaf: dict, store_shard: int, c_lo: int,
                      c_hi: int, dtype: str,
                      stats: Optional[dict]) -> bytes:
    """Decoded native bytes of chunks [c_lo, c_hi) of one recorded shard
    (encoded chunks — q8 / q4 / entropy-compressed — decode transparently,
    as in the flat get_tree)."""
    enc = mleaf.get("enc")
    chunks = mleaf["chunks"]
    parts = []
    for i in range(c_lo, c_hi):
        raw = store.get_chunk(chunks[i], shard=store_shard)
        if enc and enc[i] != "raw":
            from repro_torch.kernels.ops import decode_wire_chunk
            raw = decode_wire_chunk(raw, enc[i], dtype)
        parts.append(raw)
    out = b"".join(parts)
    _note_read(stats, store_shard, len(out), c_hi - c_lo)
    return out


def _read_box(store, mleaf: dict, store_shard: int, rec_bounds, box,
              dtype: str, chunk_words: int,
              stats: Optional[dict]) -> np.ndarray:
    """The sub-array ``box`` (global coords) of one recorded shard,
    reading only the chunks covering the box's byte envelope."""
    from repro_torch.kernels.ops import native_bytes_per_word
    dt = np_dtype(dtype)
    cn = int(chunk_words) * native_bytes_per_word(dtype)
    nbytes = int(mleaf["nbytes"])
    n_chunks = int(mleaf["n_chunks"])
    c_lo, c_hi = chunk_range(rec_bounds, box, dt.itemsize, cn, n_chunks)
    raw = _read_shard_range(store, mleaf, store_shard, c_lo, c_hi, dtype,
                            stats)
    start = c_lo * cn
    flat = np.zeros(nbytes, dtype=np.uint8)
    flat[start:start + len(raw)] = np.frombuffer(raw, np.uint8)[:nbytes - start]
    local = flat.view(dt).reshape([hi - lo for lo, hi in rec_bounds])
    rel = tuple(slice(bl - rl, bh - rl)
                for (bl, bh), (rl, _) in zip(box, rec_bounds))
    # reshape after ascontiguousarray: it promotes 0-d results to (1,),
    # which would break the 0-d assignment for scalar leaves downstream
    return np.ascontiguousarray(local[rel]).reshape(
        tuple(hi - lo for lo, hi in box))


def _stitch_leaf_full(store, resolved: dict, leaf: dict,
                      stats: Optional[dict]) -> np.ndarray:
    """Full host stitch of one v4 leaf: every recorded shard's bytes land
    in its global bounds box."""
    dt = np_dtype(leaf["dtype"])
    out = np.empty(tuple(leaf["shape"]), dtype=dt)
    members = resolved["members_resolved"]
    for se in leaf["shards"]:
        mleaf = _member_leaves(members[int(se["hid"])])[
            f"{leaf['path']}::shard{se['sid']}"]
        raw = _read_shard_range(store, mleaf, int(se["hid"]), 0,
                                int(mleaf["n_chunks"]), leaf["dtype"], stats)
        local = np.frombuffer(raw[:int(mleaf["nbytes"])], dtype=dt) \
            .reshape([hi - lo for lo, hi in se["bounds"]])
        out[tuple(slice(lo, hi) for lo, hi in se["bounds"])] = local
    return out


def _local_piece(store, resolved: dict, leaf: dict, tbox: list,
                 stats: Optional[dict]) -> np.ndarray:
    """The host array of global box ``tbox`` of one v4 leaf, assembled from
    only the recorded chunks that box overlaps."""
    dt = np_dtype(leaf["dtype"])
    chunk_words = int(resolved["chunk_words"])
    members = resolved["members_resolved"]
    out = np.empty([hi - lo for lo, hi in tbox], dtype=dt)
    for se in leaf["shards"]:
        ov = box_intersect(se["bounds"], tbox)
        if ov is None:
            continue
        mleaf = _member_leaves(members[int(se["hid"])])[
            f"{leaf['path']}::shard{se['sid']}"]
        piece = _read_box(store, mleaf, int(se["hid"]), se["bounds"], ov,
                          leaf["dtype"], chunk_words, stats)
        out[tuple(slice(lo - tl, hi - tl)
                  for (lo, hi), (tl, _) in zip(ov, tbox))] = piece
    return out


def _resharded_leaf(store, resolved: dict, leaf: dict, mesh, pls, device,
                    stats: Optional[dict]):
    """One v4 leaf as a DTensor laid out by ``pls`` on ``mesh``: this
    rank's shard assembles from only the recorded chunks its box
    overlaps, on ``device``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.sharding import _contiguous_stride, local_box
    shape = tuple(leaf["shape"])
    tbox = local_box(shape, mesh, pls)
    local = _to_tensor(_local_piece(store, resolved, leaf, tbox, stats),
                       leaf["dtype"]).to(device)
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def stitch_tree(store, resolved: dict, like: Any = None,
                stats_out: Optional[dict] = None):
    """get_tree for a v4 sharded manifest. A DTensor `like` leaf restores
    to a DTensor of its mesh and placements on its device (each rank reads
    only the chunks its shard needs); another tensor `like` leaf restores
    whole onto its device; without `like` every leaf stitches whole to a
    CPU tensor in a flat {path: tensor} dict. ``stats_out`` receives
    {chunks_read, bytes_by_shard}."""
    from repro_torch.utils.pytree import tree_flatten, tree_unflatten
    stats: dict = {"chunks_read": 0, "bytes_by_shard": {}}
    like_flat = treedef = None
    if like is not None:
        like_flat, treedef = tree_flatten(like)
        if len(like_flat) != len(resolved["leaves"]):
            raise ValueError(f"structure mismatch: like has "
                             f"{len(like_flat)} leaves, checkpoint "
                             f"{len(resolved['leaves'])}")
    arrays = []
    for i, leaf in enumerate(resolved["leaves"]):
        lk = like_flat[i] if like_flat is not None else None
        if lk is not None and _is_dtensor(lk):
            arrays.append(_resharded_leaf(
                store, resolved, leaf, lk.device_mesh, tuple(lk.placements),
                lk.device, stats))
            continue
        t = _to_tensor(_stitch_leaf_full(store, resolved, leaf, stats),
                       leaf["dtype"])
        arrays.append(t.to(lk.device) if isinstance(lk, torch.Tensor) else t)
    if stats_out is not None:
        stats_out.update(stats)
    if like is not None:
        return tree_unflatten(treedef, arrays)
    return {leaf["path"]: a for leaf, a in zip(resolved["leaves"], arrays)}


def restore_sharded_tree(store, key: str, mesh, device=None,
                         stats_out: Optional[dict] = None) -> dict:
    """Restore a v4 checkpoint RESHARDED onto ``mesh``: each leaf's
    recorded physical spec re-resolves through
    ``parallel.sharding.respec`` (the record-time divisibility and
    used-axis fallbacks) and this rank assembles its own shard on
    ``device`` (the mesh's device type, index of the current device, by
    default). Every rank of ``mesh`` calls it. Returns {path: DTensor} —
    the explicit cross-mesh entry point; ``get_tree`` reshards whenever its
    `like` holds DTensors."""
    from repro_torch.parallel.sharding import placements, respec
    resolved = store.resolve_manifest(key)
    if resolved.get("kind") != "sharded":
        raise ValueError(f"{key!r} is not a sharded (v4) manifest")
    if device is None:
        device = torch.device(mesh.device_type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    stats: dict = {"chunks_read": 0, "bytes_by_shard": {}}
    out = {}
    for leaf in resolved["leaves"]:
        pls = placements(respec(leaf.get("spec"), leaf["shape"], mesh), mesh)
        out[leaf["path"]] = _resharded_leaf(store, resolved, leaf, mesh, pls,
                                            device, stats)
    if stats_out is not None:
        stats_out.update(stats)
    return out
