"""CheckpointPipeline: the delta-aware record-side checkpoint flow.

The paper's "lean checkpointing" thesis is that checkpoint cost should track
what CHANGED, not model size. This layer wires the device-side
fingerprint path end-to-end so the record path does, in order:

1. **Fingerprint + diff on device, fused** — per leaf, `DeltaTracker` runs
   the fused fingerprint+changed CUDA kernel (one read of the leaf at HBM
   bandwidth produces BOTH the new digests and the change mask). Digests
   never leave the device; only the [G] change mask and the changed rows do.
2. **Transfer only changed chunks, wire-format** — exact leaves gather the
   changed u32 block rows; leaves matching the per-slot ``quantize_slots``
   policy run the fused gather+quantize kernel instead, so the rows leave
   the device already blockwise-int8 (q + scales — the q8 wire format, ~4x
   smaller than f32). On a frozen-majority workload the device->host
   traffic drops by the frozen fraction times the codec ratio —
   `transferred_bytes` in the per-checkpoint stats is this real DMA payload
   (wire-byte accounting), the honest M_i input for the adaptive
   controller's ε-overhead model.
3. **Write stage** (`AsyncWriter` job, FIFO on the writer thread) — hash the
   wire chunks (blake2b-16), store them content-addressed, and emit a
   **delta manifest**. In **overlap mode** (``overlap=True``) steps 1-2 are
   split: the training thread only DISPATCHES the fused fingerprint pass
   (digest state updates to async device arrays; no host sync), and the
   mask sync + gather + encode all run here on the writer thread — the
   foreground stall shrinks to kernel-launch time, and the bounded queue
   provides natural backpressure when the writer falls behind.

Delta manifest format (store manifest v3)::

    {
      "key": str, "version": 3,
      "kind": "full" | "delta",
      "parent": str | null,          # delta only: previous checkpoint key
      "treedef": str,
      "chunk_words": int,            # fingerprint chunk size in u32 words
      "meta": {...},
      "leaves": [{
         "path": str, "dtype": str, "shape": [int], "nbytes": int,
         "n_chunks": int,
         "leaf_enc": "q8"|"eb:...",  # slot POLICY, only when lossy
         "chunks": [hash, ...],      # kind == "full": complete ordered list
         "enc": [enc, ...],          # full only, parallel to chunks; only
                                     # present when any chunk is non-raw.
                                     # Per-chunk enc is "raw" | "q8" | "q4",
                                     # optionally suffixed "+z" when the
                                     # writer-thread entropy stage kept a
                                     # compressed payload
         "delta": {"<idx>": hash},   # kind == "delta": changed indices only
         "denc": {"<idx>": enc},     # delta only: non-raw changed chunks
      }, ...],
    }

v2 manifests (no per-chunk encodings — everything raw/exact) remain fully
readable; `resolve_manifest` inherits encodings through the parent chain
exactly like chunk hashes, and `get_tree` decodes non-raw chunks
transparently on restore (kernels.ops.decode_wire_chunk). Exact slots
restore bit-identical; q8 slots restore with per-element error bounded by
half a quantization step (absmax_block / 254), q4 by absmax_block / 14.
Slots declared via ``error_bounds`` pick, per changed chunk, the cheapest
encoding whose GUARANTEED bound (delta.Q4_ATOL_DIV / Q8_ATOL_DIV margins)
satisfies the slot's atol.

Mesh-aware record (``mesh=``, a ``DeviceMesh``; leaves placed on it as
``DTensor``s): the same flow runs PER SHARD — each shard's fused
fingerprint+gather pass reads only its own contiguous buffer (the CUDA
kernels launch on each local shard, never on a gathered tensor), its wire
chunks land in its store shard, and the job writes one v3 member manifest
per store shard plus a v4 stitching manifest recording the global layout
(per-leaf shape, recorded spec, shard bounds + placement). Delta chains run
per shard (``<key>.shard<h>``), so inheritance, full-every bounds and
structure-change fallbacks behave exactly as in the flat path — a layout
change is a structure change and forces a full manifest. A DeviceMesh has
one process per position, so a mesh of more than one position records as a
fleet (``dist=``): each process writes its own members and the lead stitches
the v4 through the file rendezvous (parallel/rendezvous.py). See
checkpoint/mesh.py for the restore-side stitch/reshard geometry.

Cross-run warm start (``warm_start``) seeds a scope from an ancestor run's
final resolved manifest, so a derived run's first checkpoint is a delta
against it.

A delta manifest inherits every unlisted chunk hash from its parent chain
(`CheckpointStore.resolve_manifest`). Chains are bounded: a FULL manifest is
written (a) for the first checkpoint of a scope, (b) every `full_every`
checkpoints, and (c) whenever the leaf structure changes (leaf added or
removed, dtype or shape changed) — so restore never chases unbounded
history and structure changes never alias stale chunks. A leaf whose chunk
size in native bytes is `chunk_words * native_bytes_per_word(dtype)`; the
final chunk is truncated to the leaf's `nbytes`, so restored bytes
concatenate exactly.

Scopes: checkpoints of different SkipBlocks pass distinct `scope` ids, so
each block keeps its own digest state, parent chain and full-manifest
cadence — interleaved blocks never diff against each other's trees.
"""
from __future__ import annotations

import fnmatch
import time
from typing import Any, Iterable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.async_writer import AsyncWriter
from repro_torch.checkpoint.delta import DeltaTracker, blocks_to_native_bytes
from repro_torch.kernels.ops import (Q4_BLOCK, Q8_BLOCK, dtype_name,
                                     native_bytes_per_word, q4_encode_chunk,
                                     q8_encode_chunk, quantizable_dtype)
from repro_torch.parallel.compression import entropy_encode_bytes
from repro_torch.utils.pytree import keystr, tree_flatten_with_path

DEFAULT_FULL_EVERY = 8
# fallback hop cost for full_every="auto" before any replay calibration has
# been learned — mirror of replay.plan.RESTORE_HOP_S (kept local: pipeline
# must not import the replay layer)
DEFAULT_HOP_S = 0.002
# storage/fingerprint granularity: 16384 u32 words = 64 KiB chunks for
# 4-byte dtypes. Finer chunks transfer marginally less but cost one object
# FILE per chunk — at 4 KiB the filesystem round-trips dominate the write
# stage.
PIPELINE_CHUNK_WORDS = 16 * 1024


class CheckpointPipeline:
    def __init__(self, store, *, chunk_words: int = PIPELINE_CHUNK_WORDS,
                 full_every=DEFAULT_FULL_EVERY,
                 async_stage: bool = True, max_queue: int = 2,
                 on_materialized=None,
                 quantize_slots: Optional[Iterable[str]] = None,
                 error_bounds: Optional[dict] = None,
                 entropy: bool = True,
                 overlap: bool = False,
                 mesh=None, shard_axes: Iterable[str] = (),
                 dist=None):
        self.store = store
        self.chunk_words = chunk_words
        # full_every="auto": start at the default cadence and retune after
        # every full manifest from the store's learned read/hop costs — see
        # _retune_full_every. Restore-bound stores shorten chains; stores
        # with cheap manifest hops lengthen them.
        self.full_every_auto = (full_every == "auto")
        self.full_every = DEFAULT_FULL_EVERY if self.full_every_auto \
            else max(1, int(full_every))
        self.tracker = DeltaTracker(chunk_words)
        # mesh-aware record: each shard runs the fused fingerprint pass over
        # its OWN buffer, its chunks land in its store shard, and a v4
        # stitching manifest records the layout. shard_axes picks which mesh
        # axes map onto store shards (default: all — one store shard per
        # mesh position).
        self.mesh = mesh
        self.shard_axes = tuple(shard_axes or ())
        # fleet record: ``dist`` is a parallel.rendezvous.StitchRendezvous
        # carrying this process's ProcessGroup. Each process fingerprints /
        # gathers ONLY the shards it owns and writes ONLY its own store
        # shards' member manifests; the lead process gathers every
        # process's publication through the file barrier and writes the v4
        # stitch (or marks the checkpoint incomplete past the deadline).
        self.dist = dist
        self._anchor = (0, 0)
        self._incomplete: list[str] = []
        self._key_chain: dict[str, list[str]] = {}
        if dist is not None and mesh is None:
            raise ValueError("dist= (a fleet record) needs mesh=")
        if mesh is not None:
            from repro_torch.checkpoint.mesh import (device_maps,
                                                     local_anchor, mesh_meta)
            if dist is None and mesh.mesh.numel() > 1:
                raise ValueError(
                    f"a DeviceMesh of {mesh.mesh.numel()} positions is a "
                    f"fleet of as many processes: pass dist= (a "
                    f"StitchRendezvous) so the lead stitches the v4")
            self._dev_ord, self._dev_host = device_maps(mesh,
                                                        self.shard_axes)
            self._mesh_meta = mesh_meta(mesh, self.shard_axes)
            if dist is not None:
                self._anchor = local_anchor(mesh, self._dev_ord,
                                            self._dev_host, 0)
        self._mesh_meta_written = False
        # per-slot lossy policy: leaf paths matching any of these names /
        # glob patterns are stored blockwise-int8 (q8 wire format) when the
        # dtype supports it. Empty (the default) = every leaf exact, so the
        # bit-identical restore invariant holds unless explicitly opted out.
        self.quantize_slots = tuple(quantize_slots or ())
        # declarative per-slot error bounds: {slot_or_glob: atol}. A matching
        # leaf uses the ADAPTIVE encoding selector — per changed chunk, the
        # cheapest wire encoding (q4 / q8 / raw) whose guaranteed blockwise
        # bound satisfies the atol. Takes precedence over quantize_slots.
        self.error_bounds = dict(error_bounds or {})
        # writer-thread entropy stage: byte-compress already-gathered wire
        # chunks of lossy-policy leaves off the step path (kept only when it
        # actually shrinks them). Requires the async stage — a sync pipeline
        # would pay it on the training thread, violating the epsilon budget.
        self.entropy = bool(entropy)
        # overlap mode defers mask-sync + gather to the writer thread; it
        # needs the async stage to exist (sync pipelines gain nothing)
        self.overlap = bool(overlap) and async_stage
        self._on_mat = on_materialized
        self.writer = AsyncWriter(store, max_queue=max_queue,
                                  on_materialized=self._materialized) \
            if async_stage else None
        # submit-side per-scope state (owned by the training thread)
        self._sig: dict[str, dict[str, tuple]] = {}
        self._last_key: dict[str, Optional[str]] = {}
        self._since_full: dict[str, int] = {}
        # writer-side per-scope state: path -> full ordered chunk-hash list
        # (and the parallel per-chunk encoding list). Only the writer thread
        # (or the inline sync path) touches them; jobs run FIFO so they
        # always reflect the previously written manifest.
        self._hashes: dict[str, dict[str, list]] = {}
        self._encs: dict[str, dict[str, list]] = {}
        self._stats: list[dict] = []

    def _slot_policy(self, pstr: str, dtype: str) -> str:
        """Per-leaf encoding POLICY: "eb:<atol>" when the leaf path matches
        an error_bounds entry (adaptive selector), "q8" when it matches a
        quantize_slots entry, "raw" otherwise. Both matchers take a slot
        name or a glob over the keystr path, and only fire when the dtype is
        one the fused quantize path supports. error_bounds wins when a leaf
        matches both."""
        if not quantizable_dtype(dtype):
            return "raw"
        for pat, atol in self.error_bounds.items():
            if _match_slot(pstr, pat):
                return f"eb:{float(atol):g}"
        for pat in self.quantize_slots:
            if _match_slot(pstr, pat):
                return "q8"
        return "raw"

    @staticmethod
    def _policy_delta_kwargs(policy: str) -> dict:
        """DeltaTracker kwargs for one leaf policy string."""
        if policy.startswith("eb:"):
            return {"error_bound": float(policy[3:])}
        if policy != "raw":
            return {"enc": policy}
        return {}

    # -------------------------------------------------------------- record --
    def submit(self, key: str, tree: Any, meta: Optional[dict] = None,
               scope: str = "default", block: bool = True) -> Optional[dict]:
        """Fingerprint `tree`, transfer only changed chunks, and enqueue the
        write stage. Returns submit-side stats (or None when the writer
        queue is full and block=False — the checkpoint is skipped and the
        device digest state is rolled back so the next delta stays correct).
        """
        if self.mesh is not None:
            return self._submit_sharded(key, tree, meta, scope, block)
        t_submit0 = time.perf_counter()
        flat, treedef = tree_flatten_with_path(tree)
        prev_sig = self._sig.get(scope, {})
        sig: dict[str, tuple] = {}
        payload_leaves = []
        rollback: list[tuple[str, Any]] = []
        transferred = 0
        logical = 0
        changed_chunks_n = 0
        total_chunks_n = 0
        structure_changed = False
        for path, leaf in flat:
            pstr = keystr(path)
            leaf = _as_tensor(leaf)
            dtype = dtype_name(leaf.dtype)
            shape = list(leaf.shape)
            nbytes = leaf.numel() * leaf.element_size()
            policy = self._slot_policy(pstr, dtype)
            # the policy is part of the structure signature: flipping a
            # slot's policy (or changing its error bound) forces a FULL
            # manifest (and a digest reset), so a chain never inherits
            # chunks recorded under another encoding without declaring it
            # per-chunk. Per-chunk choices WITHIN one "eb:" policy do not
            # force fulls — the manifest's enc/denc fields carry them.
            sig[pstr] = (dtype, tuple(shape), policy)
            if nbytes == 0:
                payload_leaves.append({
                    "path": pstr, "dtype": dtype, "shape": shape,
                    "nbytes": 0, "n_chunks": 0, "enc": "raw",
                    "changed_idx": [], "chunks": [], "chunk_encs": []})
                continue
            tpath = f"{scope}::{pstr}"
            old = prev_sig.get(pstr)
            if old is None or old != sig[pstr]:
                structure_changed = True
                # dtype change with identical block count would otherwise
                # slip through the digest comparison
                self.tracker.forget(tpath)
            rollback.append((tpath, self.tracker._digests.get(tpath)))
            n_chunks = -(-nbytes // (self.chunk_words
                                     * native_bytes_per_word(dtype)))
            lmeta = {"path": pstr, "dtype": dtype, "shape": shape,
                     "nbytes": nbytes, "n_chunks": n_chunks, "enc": policy}
            logical += nbytes
            total_chunks_n += n_chunks
            dkw = self._policy_delta_kwargs(policy)
            if self.overlap:
                # dispatch-only: the fused fingerprint+mask launches here;
                # mask sync, gather and encode run on the writer thread
                lmeta["handle"] = self.tracker.delta_dispatch(
                    tpath, _fp_view(leaf), **dkw)
            else:
                d = self.tracker.delta(tpath, _fp_view(leaf), **dkw)
                idx_keep, chunks_keep, encs_keep, t_bytes = _encode_changed(
                    d, lmeta, self.chunk_words)
                lmeta["changed_idx"] = idx_keep
                lmeta["chunks"] = chunks_keep
                lmeta["chunk_encs"] = encs_keep
                transferred += t_bytes
                changed_chunks_n += len(idx_keep)
            payload_leaves.append(lmeta)
        if set(prev_sig) - set(sig):           # leaf removed
            structure_changed = True
        last = self._last_key.get(scope)
        since = self._since_full.get(scope, 0)
        full = (last is None or structure_changed
                or since + 1 >= self.full_every)
        payload = {
            "key": key, "scope": scope, "meta": meta or {},
            "kind": "full" if full else "delta",
            "parent": None if full else last,
            "treedef": str(treedef), "chunk_words": self.chunk_words,
            "leaves": payload_leaves, "overlap": self.overlap,
            # overlap mode: transferred/changed are only known once the
            # writer thread finalizes the deferred gathers (None here; the
            # materialized stat carries the measured values)
            "transferred_bytes": None if self.overlap else transferred,
            "logical_bytes": logical,
            "changed_chunks": None if self.overlap else changed_chunks_n,
            "total_chunks": total_chunks_n,
            # foreground stall on the training thread (fused fingerprint +
            # mask sync + changed-row DMA — or dispatch-only in overlap
            # mode): part of the real M_i — the epsilon overhead invariant
            # is meaningless if this goes uncounted
            "submit_stall_s": time.perf_counter() - t_submit0,
        }
        ok = self._dispatch(payload, block=block)
        if not ok:
            # checkpoint skipped: next delta must still diff against the
            # last STORED checkpoint
            for tpath, prev in rollback:
                if prev is None:
                    self.tracker.forget(tpath)
                else:
                    self.tracker._digests[tpath] = prev
            return None
        self._sig[scope] = sig
        self._last_key[scope] = key
        self._since_full[scope] = 0 if full else since + 1
        return {"key": key, "kind": payload["kind"],
                "parent": payload["parent"],
                "transferred_bytes": payload["transferred_bytes"],
                "logical_bytes": logical,
                "changed_chunks": payload["changed_chunks"],
                "total_chunks": total_chunks_n,
                "overlap": self.overlap,
                "submit_stall_s": payload["submit_stall_s"]}

    def _dispatch(self, payload: dict, block: bool) -> bool:
        job = self._make_job(payload)
        if self.writer is not None:
            return self.writer.submit_job(payload["key"], job, block=block)
        t0 = time.perf_counter()
        stat = job(self.store)
        stat["materialize_s"] = time.perf_counter() - t0
        self._materialized(stat)
        return True

    def _make_job(self, payload: dict):
        if payload.get("sharded"):
            return lambda store: self._sharded_job(payload, store)

        def job(store):
            scope = payload["scope"]
            if payload.get("overlap"):
                # deferred half of the fused pass: sync masks, gather (and
                # quantize) changed rows, encode wire payloads — all off the
                # training thread
                transferred = 0
                changed_n = 0
                for leaf in payload["leaves"]:
                    h = leaf.pop("handle", None)
                    if h is None:              # zero-byte leaf
                        continue
                    d = self.tracker.finalize(h)
                    idx_keep, chunks_keep, encs_keep, t_bytes = \
                        _encode_changed(d, leaf, payload["chunk_words"])
                    leaf["changed_idx"] = idx_keep
                    leaf["chunks"] = chunks_keep
                    leaf["chunk_encs"] = encs_keep
                    transferred += t_bytes
                    changed_n += len(idx_keep)
                payload["transferred_bytes"] = transferred
                payload["changed_chunks"] = changed_n
            entropy_s = sum(self._entropy_pass(leaf)
                            for leaf in payload["leaves"])
            hashes_map = self._hashes.setdefault(scope, {})
            encs_map = self._encs.setdefault(scope, {})
            full = payload["kind"] == "full"
            new_bytes = 0
            new_chunks = 0
            stored_bytes = 0
            manifest_leaves = []
            for leaf in payload["leaves"]:
                path, n = leaf["path"], leaf["n_chunks"]
                lenc = leaf.get("enc", "raw")
                cencs = leaf.get("chunk_encs") \
                    or ["raw"] * len(leaf["changed_idx"])
                base = hashes_map.get(path)
                if base is None or len(base) != n:
                    base = [None] * n
                else:
                    base = list(base)
                ebase = encs_map.get(path)
                if ebase is None or len(ebase) != n:
                    ebase = ["raw"] * n        # pre-v3 state: chunks are raw
                else:
                    ebase = list(ebase)
                delta_hashes = {}
                for i, data, ce in zip(leaf["changed_idx"], leaf["chunks"],
                                       cencs):
                    h, nb, new = store.put_chunk(data)
                    base[i] = h
                    ebase[i] = ce
                    delta_hashes[str(i)] = h
                    new_bytes += nb
                    new_chunks += int(new)
                    stored_bytes += len(data)
                if any(h is None for h in base):
                    raise RuntimeError(
                        f"delta pipeline inconsistency for leaf {path!r}: "
                        f"unchanged chunks have no known hash (manifest kind "
                        f"{payload['kind']!r})")
                hashes_map[path] = base
                encs_map[path] = ebase
                mleaf = {"path": path, "dtype": leaf["dtype"],
                         "shape": leaf["shape"], "nbytes": leaf["nbytes"],
                         "n_chunks": n}
                if lenc != "raw":
                    # leaf-level POLICY (what this pipeline writes), distinct
                    # from the per-chunk enc lists below: a warm start seeds
                    # the structure signature from it
                    mleaf["leaf_enc"] = lenc
                if full:
                    mleaf["chunks"] = base
                    if any(e != "raw" for e in ebase):
                        mleaf["enc"] = ebase
                else:
                    mleaf["delta"] = delta_hashes
                    denc = {str(i): ce
                            for i, ce in zip(leaf["changed_idx"], cencs)
                            if ce != "raw"}
                    if denc:
                        mleaf["denc"] = denc
                manifest_leaves.append(mleaf)
            if full:    # drop leaves that left the tree
                current = {lf["path"] for lf in payload["leaves"]}
                for stale in set(hashes_map) - current:
                    del hashes_map[stale]
                    encs_map.pop(stale, None)
            store.put_manifest({
                "key": payload["key"], "version": 3,
                "kind": payload["kind"], "parent": payload["parent"],
                "treedef": payload["treedef"],
                "chunk_words": payload["chunk_words"],
                "meta": payload["meta"], "leaves": manifest_leaves,
            })
            if full:
                self._retune_full_every(store, payload["logical_bytes"])
            return {"key": payload["key"], "kind": payload["kind"],
                    "parent": payload["parent"],
                    "transferred_bytes": payload["transferred_bytes"],
                    "logical_bytes": payload["logical_bytes"],
                    "changed_chunks": payload["changed_chunks"],
                    "total_chunks": payload["total_chunks"],
                    "submit_stall_s": payload["submit_stall_s"],
                    "overlap": payload.get("overlap", False),
                    "new_bytes": new_bytes, "new_chunks": new_chunks,
                    "stored_bytes": stored_bytes,
                    "entropy_s": entropy_s,
                    "full_every": self.full_every}
        return job

    def _entropy_pass(self, leaf: dict) -> float:
        """Writer-thread entropy stage for one leaf: byte-compress its wire
        chunks in place (suffixing the chunk encoding with "+z") when the
        leaf has a lossy policy and compression actually pays — a payload is
        kept only below 0.95x its original size, so restore never decodes a
        compression pass that bought nothing. Runs ONLY when an async writer
        exists; on a sync pipeline this stage would land on the training
        thread and silently inflate the foreground stall. Returns seconds
        spent (the caller reports them as ``entropy_s`` so the adaptive
        controller can move them to the background accumulator)."""
        if self.writer is None or not self.entropy:
            return 0.0
        if leaf.get("enc", "raw") == "raw" or not leaf.get("chunks"):
            return 0.0
        t0 = time.perf_counter()
        chunks = leaf["chunks"]
        cencs = list(leaf.get("chunk_encs")
                     or ["raw"] * len(chunks))
        # raw chunks of a lossy-policy leaf (adaptive selector fallback) are
        # still float words — byte-plane shuffle at the dtype's width;
        # q8/q4 payloads are already byte-homogeneous, stride 1
        raw_isz = 2 if leaf["dtype"] in ("bfloat16", "float16") else 4
        for j, (data, ce) in enumerate(zip(chunks, cencs)):
            if ce.endswith("+z"):
                continue
            z = entropy_encode_bytes(
                data, itemsize=raw_isz if ce == "raw" else 1)
            if len(z) < 0.95 * len(data):
                chunks[j] = z
                cencs[j] = ce + "+z"
        leaf["chunk_encs"] = cencs
        return time.perf_counter() - t0

    def _retune_full_every(self, store, full_bytes: int):
        """Close the loop on the full-manifest cadence (full_every="auto"):
        pick the chain length K whose worst-case replay overhead — K
        manifest hops — costs about half the time re-reading a full
        checkpoint does, using the store's measured read bandwidth and the
        learned per-hop resolve cost (restore calibration). A
        restore-bound store (expensive hops) gets short chains; a store with
        cheap local hops amortizes fulls over long ones. Runs on the writer
        thread right after each full manifest; submit() reads the updated
        value for the next cadence decision."""
        if not self.full_every_auto:
            return
        calib = store.get_meta("store_calib") or {}
        read_bps = float(calib.get("read_bps") or calib.get("write_bps")
                         or 1e9)
        hop_s = float(calib.get("hop_s") or DEFAULT_HOP_S)
        full_read_s = full_bytes / max(read_bps, 1.0)
        self.full_every = min(64, max(2, int(0.5 * full_read_s
                                             / max(hop_s, 1e-9))))

    # ------------------------------------------------------ sharded record --
    def _submit_sharded(self, key: str, tree: Any, meta: Optional[dict],
                        scope: str, block: bool) -> Optional[dict]:
        """Mesh-aware submit: per pytree leaf, enumerate the disjoint owner
        shards (checkpoint/mesh.py) and run the fused fingerprint+gather
        pass on EACH shard's own device buffer — no all-gather; a shard's
        bytes only move device -> its store shard. Emits one v3
        member manifest per store shard plus a v4 stitching manifest."""
        from repro_torch.checkpoint.mesh import leaf_spec_entries, owned_shards
        t_submit0 = time.perf_counter()
        flat, treedef = tree_flatten_with_path(tree)
        prev_sig = self._sig.get(scope, {})
        sig: dict[str, tuple] = {}
        entries: list[dict] = []       # one per (leaf, device shard)
        layout: list[dict] = []        # global-manifest leaves
        rollback: list[tuple[str, Any]] = []
        transferred = 0
        logical = 0
        changed_chunks_n = 0
        total_chunks_n = 0
        structure_changed = False
        shard_stall: dict[int, float] = {}
        for path, leaf in flat:
            pstr = keystr(path)
            leaf = _as_tensor(leaf)
            dtype = dtype_name(leaf.dtype)
            shape = list(leaf.shape)
            nbytes = leaf.numel() * leaf.element_size()
            policy = self._slot_policy(pstr, dtype)
            if nbytes == 0:
                sig[pstr] = (dtype, tuple(shape), policy, ())
                layout.append({"path": pstr, "dtype": dtype, "shape": shape,
                               "nbytes": 0, "spec": None, "shards": []})
                continue
            shards = owned_shards(
                leaf, self.mesh, self._dev_ord, self._dev_host,
                process_index=(self.dist.group.process_id
                               if self.dist is not None else None),
                anchor=self._anchor)
            # the placement is part of the structure signature: a layout
            # change (resharded mid-run, mesh swap) forces a FULL manifest —
            # per-shard digests from another layout cover different bytes
            mesh_sig = tuple((s["sid"], s["hid"],
                              tuple(map(tuple, s["bounds"])))
                             for s in shards)
            sig[pstr] = (dtype, tuple(shape), policy, mesh_sig)
            layout.append({"path": pstr, "dtype": dtype, "shape": shape,
                           "nbytes": nbytes,
                           "spec": leaf_spec_entries(leaf),
                           "shards": [{"sid": s["sid"], "hid": s["hid"],
                                       "bounds": s["bounds"]}
                                      for s in shards]})
            logical += nbytes
            if prev_sig.get(pstr) != sig[pstr]:
                structure_changed = True
                for s in shards:
                    self.tracker.forget(f"{scope}::{pstr}::s{s['sid']}")
            for s in shards:
                tpath = f"{scope}::{pstr}::s{s['sid']}"
                rollback.append((tpath, self.tracker._digests.get(tpath)))
                local = s["data"]
                lnb = local.numel() * local.element_size()
                n_chunks = -(-lnb // (self.chunk_words
                                      * native_bytes_per_word(dtype)))
                ent = {"path": pstr, "sid": s["sid"], "hid": s["hid"],
                       "bounds": s["bounds"], "dtype": dtype,
                       "shape": list(local.shape),
                       "nbytes": lnb, "n_chunks": n_chunks, "enc": policy}
                total_chunks_n += n_chunks
                dkw = self._policy_delta_kwargs(policy)
                t0 = time.perf_counter()
                if self.overlap:
                    ent["handle"] = self.tracker.delta_dispatch(
                        tpath, _fp_view(local), **dkw)
                else:
                    d = self.tracker.delta(tpath, _fp_view(local), **dkw)
                    idx_keep, chunks_keep, encs_keep, t_bytes = \
                        _encode_changed(d, ent, self.chunk_words)
                    ent["changed_idx"] = idx_keep
                    ent["chunks"] = chunks_keep
                    ent["chunk_encs"] = encs_keep
                    transferred += t_bytes
                    changed_chunks_n += len(idx_keep)
                # per-store-shard foreground cost (each process of a fleet
                # pays its own shards' share)
                shard_stall[s["hid"]] = shard_stall.get(s["hid"], 0.0) \
                    + (time.perf_counter() - t0)
                entries.append(ent)
        if set(prev_sig) - set(sig):
            structure_changed = True
        last = self._last_key.get(scope)
        since = self._since_full.get(scope, 0)
        full = (last is None or structure_changed
                or since + 1 >= self.full_every)
        payload = {
            "key": key, "scope": scope, "meta": meta or {},
            "sharded": True, "mesh": self._mesh_meta,
            "kind": "full" if full else "delta",
            "parent": None if full else last,
            "treedef": str(treedef), "chunk_words": self.chunk_words,
            "entries": entries, "layout": layout, "overlap": self.overlap,
            "transferred_bytes": None if self.overlap else transferred,
            "logical_bytes": logical,
            "changed_chunks": None if self.overlap else changed_chunks_n,
            "total_chunks": total_chunks_n,
            "shard_stall_s": shard_stall,
            "submit_stall_s": time.perf_counter() - t_submit0,
        }
        ok = self._dispatch(payload, block=block)
        if not ok:
            for tpath, prev in rollback:
                if prev is None:
                    self.tracker.forget(tpath)
                else:
                    self.tracker._digests[tpath] = prev
            return None
        self._sig[scope] = sig
        self._last_key[scope] = key
        self._since_full[scope] = 0 if full else since + 1
        if self.dist is not None:
            self._key_chain.setdefault(scope, []).append(key)
        return {"key": key, "kind": payload["kind"], "sharded": True,
                "parent": payload["parent"],
                "transferred_bytes": payload["transferred_bytes"],
                "logical_bytes": logical,
                "changed_chunks": payload["changed_chunks"],
                "total_chunks": total_chunks_n,
                "overlap": self.overlap,
                "n_store_shards": self._mesh_meta["n_store_shards"],
                "shard_stall_s": dict(shard_stall),
                "submit_stall_s": payload["submit_stall_s"]}

    def _sharded_job(self, payload: dict, store) -> dict:
        """Writer half of a sharded checkpoint: per store shard, write the
        changed chunks into that shard's pool and a v3 member manifest
        (chained ``<key>.shard<h>`` -> ``<parent>.shard<h>``); then the v4
        stitching manifest. Members land BEFORE the global manifest, so a
        crash can leave orphan members but never a global that references a
        missing one."""
        scope = payload["scope"]
        if payload.get("overlap"):
            transferred = 0
            changed_n = 0
            for ent in payload["entries"]:
                h = ent.pop("handle", None)
                if h is None:
                    continue
                t0 = time.perf_counter()
                d = self.tracker.finalize(h)
                idx_keep, chunks_keep, encs_keep, t_bytes = _encode_changed(
                    d, ent, payload["chunk_words"])
                ent["changed_idx"] = idx_keep
                ent["chunks"] = chunks_keep
                ent["chunk_encs"] = encs_keep
                transferred += t_bytes
                changed_n += len(idx_keep)
                ss = payload["shard_stall_s"]
                ss[ent["hid"]] = ss.get(ent["hid"], 0.0) \
                    + (time.perf_counter() - t0)
            payload["transferred_bytes"] = transferred
            payload["changed_chunks"] = changed_n
        entropy_s = sum(self._entropy_pass(ent)
                        for ent in payload["entries"])
        hashes_map = self._hashes.setdefault(scope, {})
        encs_map = self._encs.setdefault(scope, {})
        full = payload["kind"] == "full"
        key, parent = payload["key"], payload["parent"]
        by_hid: dict[int, list[dict]] = {}
        for ent in payload["entries"]:
            by_hid.setdefault(ent["hid"], []).append(ent)
        new_bytes = 0
        new_chunks = 0
        members: dict[str, str] = {}
        shard_write_s: dict[int, float] = {}
        shard_bytes: dict[int, int] = {}
        for hid in sorted(by_hid):
            t0 = time.perf_counter()
            mleaves = []
            for ent in by_hid[hid]:
                wkey = f"{ent['path']}::shard{ent['sid']}"
                n = ent["n_chunks"]
                lenc = ent["enc"]
                cencs = ent.get("chunk_encs") \
                    or ["raw"] * len(ent["changed_idx"])
                base = hashes_map.get(wkey)
                base = [None] * n if base is None or len(base) != n \
                    else list(base)
                ebase = encs_map.get(wkey)
                ebase = ["raw"] * n if ebase is None or len(ebase) != n \
                    else list(ebase)
                delta_hashes = {}
                for i, data, ce in zip(ent["changed_idx"], ent["chunks"],
                                       cencs):
                    h, nb, new = store.put_chunk(data, shard=hid)
                    base[i] = h
                    ebase[i] = ce
                    delta_hashes[str(i)] = h
                    new_bytes += nb
                    new_chunks += int(new)
                    shard_bytes[hid] = shard_bytes.get(hid, 0) + len(data)
                if any(h is None for h in base):
                    raise RuntimeError(
                        f"sharded delta inconsistency for {wkey!r}: "
                        f"unchanged chunks have no known hash (manifest "
                        f"kind {payload['kind']!r})")
                hashes_map[wkey] = base
                encs_map[wkey] = ebase
                mleaf = {"path": wkey, "dtype": ent["dtype"],
                         "shape": ent["shape"], "nbytes": ent["nbytes"],
                         "n_chunks": n, "bounds": ent["bounds"]}
                if lenc != "raw":
                    mleaf["leaf_enc"] = lenc
                if full:
                    mleaf["chunks"] = base
                    if any(e != "raw" for e in ebase):
                        mleaf["enc"] = ebase
                else:
                    mleaf["delta"] = delta_hashes
                    denc = {str(i): ce
                            for i, ce in zip(ent["changed_idx"], cencs)
                            if ce != "raw"}
                    if denc:
                        mleaf["denc"] = denc
                mleaves.append(mleaf)
            member_key = f"{key}.shard{hid}"
            store.put_manifest({
                "key": member_key, "version": 3,
                "kind": payload["kind"],
                "parent": f"{parent}.shard{hid}" if parent else None,
                "treedef": payload["treedef"],
                "chunk_words": payload["chunk_words"],
                "store_shard": hid, "meta": {},
                "leaves": mleaves,
            })
            members[str(hid)] = member_key
            shard_write_s[hid] = time.perf_counter() - t0
        if full:
            current = {f"{ent['path']}::shard{ent['sid']}"
                       for ent in payload["entries"]}
            for stale in set(hashes_map) - current:
                del hashes_map[stale]
                encs_map.pop(stale, None)
        # stitched: True = v4 written, False = marked incomplete, None =
        # outcome unknown here (non-lead of a distributed fleet; the lead
        # decides, close() reconciles the tips from the store)
        stitched: Optional[bool] = True
        t_stitch = time.perf_counter()
        if self.dist is None:
            store.put_manifest({
                "key": key, "version": 4, "kind": "sharded",
                "ckpt_kind": payload["kind"], "parent": parent,
                "treedef": payload["treedef"],
                "chunk_words": payload["chunk_words"],
                "mesh": payload["mesh"], "members": members,
                "meta": payload["meta"], "leaves": payload["layout"],
            })
        else:
            stitched = self._dist_stitch(payload, store, members)
        stitch_s = time.perf_counter() - t_stitch
        if not self._mesh_meta_written and \
                (self.dist is None or self.dist.group.is_lead):
            store.put_meta("mesh", payload["mesh"])
            self._mesh_meta_written = True
        if full and stitched:
            self._retune_full_every(store, payload["logical_bytes"])
        return {"key": key, "kind": payload["kind"], "sharded": True,
                "stitched": stitched,
                "parent": parent,
                "transferred_bytes": payload["transferred_bytes"],
                "logical_bytes": payload["logical_bytes"],
                "changed_chunks": payload["changed_chunks"],
                "total_chunks": payload["total_chunks"],
                "submit_stall_s": payload["submit_stall_s"],
                "overlap": payload.get("overlap", False),
                "new_bytes": new_bytes, "new_chunks": new_chunks,
                "n_store_shards": len(by_hid),
                "shard_stall_s": dict(payload["shard_stall_s"]),
                "shard_write_s": shard_write_s,
                "shard_bytes": shard_bytes,
                # the v4 write; in a fleet, publication plus (on the lead)
                # the wait for every process's marker
                "stitch_s": stitch_s,
                "entropy_s": entropy_s,
                "full_every": self.full_every}

    # ------------------------------------------------- distributed stitch --
    def _dist_stitch(self, payload: dict, store,
                     members: dict) -> Optional[bool]:
        """Multi-process tail of a sharded checkpoint (writer thread).
        Every process PUBLISHES its member-manifest names + local layout
        fragment through the file rendezvous; the LEAD process gathers all
        publications, validates them, merges the global layout, and writes
        the v4 stitch atomically. Publication order is the crash-safety
        invariant: member manifests land before the marker, the marker
        before the stitch — so a crash anywhere in between leaves only
        unreferenced members (GC food), never a v4 naming a missing one.
        Past the deadline (or on validation failure) the lead marks the
        checkpoint ``incomplete`` in run meta and training moves on.

        Returns the stitch outcome on the lead (True = v4 written, False =
        incomplete); ``None`` on non-leads, whose publication returns long
        before the lead's verdict exists — their stats must not claim an
        outcome, and close() reconciles their tips from the store."""
        import os as _os
        from repro_torch.parallel import rendezvous as rdv
        key = payload["key"]
        group = self.dist.group
        if rdv.crash_requested(key, group.process_id):
            # fault injection: die AFTER member publication, BEFORE the
            # marker — the exact window the crash-safety argument is about
            _os._exit(rdv.CRASH_EXIT_CODE)
        self.dist.publish(key, {
            "process": group.process_id,
            "kind": payload["kind"],
            "members": dict(members),
            "layout_shards": {lf["path"]: lf["shards"]
                              for lf in payload["layout"]},
        })
        if not group.is_lead:
            return None      # publication done; outcome is the lead's call
        got = self.dist.gather(key)
        merged = self._merge_markers(store, payload, got) \
            if got is not None else None
        if merged is None:
            self._mark_incomplete(store, key)
            return False
        layout, all_members = merged
        store.put_manifest({
            "key": key, "version": 4, "kind": "sharded",
            "ckpt_kind": payload["kind"], "parent": payload["parent"],
            "treedef": payload["treedef"],
            "chunk_words": payload["chunk_words"],
            "mesh": payload["mesh"], "members": all_members,
            "meta": payload["meta"], "leaves": layout,
        })
        self.dist.clear(key)
        return True

    def _merge_markers(self, store, payload: dict,
                       got: list) -> Optional[tuple]:
        """Validate every host's publication and merge the global (layout,
        members). None on any inconsistency — a member manifest missing
        from disk, a host that decided a different full/delta kind, or a
        shard set that does not tile a leaf — so a bad fleet state becomes
        an ``incomplete`` checkpoint instead of a corrupt stitch."""
        all_members: dict[str, str] = {}
        for marker in got:
            if marker.get("kind") != payload["kind"]:
                return None
            for hid, mkey in marker["members"].items():
                if not store.has(mkey):
                    return None
                all_members[str(hid)] = mkey
        layout = []
        for lf in payload["layout"]:
            merged = {k: v for k, v in lf.items() if k != "shards"}
            shards: list[dict] = []
            for marker in got:
                shards.extend(marker["layout_shards"].get(lf["path"], []))
            shards.sort(key=lambda s: s["sid"])
            merged["shards"] = shards
            layout.append(merged)
            if lf["nbytes"] > 0 and lf["shape"]:
                covered = 0
                for s in shards:
                    vol = 1
                    for lo, hi in s["bounds"]:
                        vol *= max(0, hi - lo)
                    covered += vol
                want = 1
                for d in lf["shape"]:
                    want *= int(d)
                if covered != want:
                    return None    # shards don't tile the leaf
        return layout, all_members

    def _mark_incomplete(self, store, key: str):
        """Record a failed stitch in run meta (lead-only, so the
        read-modify-write never races): the replay planner skips these
        keys, and close() rolls final_keys back past them."""
        self._incomplete.append(key)
        cur = store.get_meta("incomplete_ckpts") or {"keys": []}
        if key not in cur["keys"]:
            cur["keys"].append(key)
        store.put_meta("incomplete_ckpts", cur)

    def _materialized(self, stat: dict):
        self._stats.append(stat)
        if self._on_mat:
            self._on_mat(stat)

    # ---------------------------------------------------------- warm start --
    def warm_start(self, scope: str, parent_key: str, manifest: dict,
                   arrays_by_path: dict) -> dict:
        """Seed one scope's record state from an ancestor run's final
        RESOLVED manifest, so the next submit() is a delta against it.

        `parent_key` must be the key the shared store resolves the manifest
        under — QUALIFIED (``"run::key"``) when it lives in another run's
        namespace. `manifest` is the ``resolve_manifest`` output (complete
        chunk lists per leaf); `arrays_by_path` the restored tensors keyed
        by leaf path. Seeds:

        * structure signatures — so the first submit is not forced full;
        * writer-side chunk-hash lists — so unchanged chunks inherit the
          ancestor's hashes instead of tripping the consistency check;
        * device digests — the fingerprint over the restored bytes, on each
          tensor's own device (the CUDA kernel for tensors on the card), so
          only truly-changed chunks transfer.

        Call before the scope's first submit (its writer-side state is not
        yet shared with the writer thread). Raises ValueError when the
        manifest cannot seed this pipeline (v4, v1, unresolved holes,
        different `chunk_words`) — the caller falls back to a cold start."""
        if manifest.get("kind") == "sharded":
            raise ValueError(
                f"warm start from sharded (v4) manifest {manifest['key']!r} "
                "is not supported yet — the derived run records cold")
        if manifest.get("version", 1) < 2:
            raise ValueError(
                f"warm start needs a v2 pipeline manifest; {manifest['key']!r}"
                " is v1 (put_tree) and uses incompatible chunking")
        if int(manifest.get("chunk_words") or 0) != self.chunk_words:
            raise ValueError(
                f"chunk_words mismatch: manifest {manifest.get('chunk_words')}"
                f" vs pipeline {self.chunk_words} — digests would never match")
        sig: dict[str, tuple] = {}
        hashes: dict[str, list] = {}
        encs: dict[str, list] = {}
        seeded_bytes = 0
        for leaf in manifest["leaves"]:
            path = leaf["path"]
            chunks = leaf.get("chunks")
            if chunks is None or any(h is None for h in chunks):
                raise ValueError(
                    f"manifest {manifest['key']!r} is not resolved at leaf "
                    f"{path!r} — pass resolve_manifest() output")
            if path not in arrays_by_path:
                raise ValueError(f"restored tree is missing leaf {path!r}")
            sig[path] = (leaf["dtype"], tuple(leaf["shape"]),
                         leaf.get("leaf_enc", "raw"))
            hashes[path] = list(chunks)
            encs[path] = list(leaf.get("enc") or ["raw"] * len(chunks))
            nbytes = int(leaf.get("nbytes", 0))
            seeded_bytes += nbytes
            if nbytes > 0:
                self.tracker.seed(f"{scope}::{path}",
                                  _fp_view(_as_tensor(arrays_by_path[path])))
        self._sig[scope] = sig
        self._hashes[scope] = hashes
        self._encs[scope] = encs
        self._last_key[scope] = parent_key
        self._since_full[scope] = 0
        return {"scope": scope, "parent": parent_key,
                "leaves": len(sig), "seeded_bytes": seeded_bytes}

    # ----------------------------------------------------------- lifecycle --
    def drain(self):
        if self.writer is not None:
            self.writer.drain()

    def close(self):
        if self.writer is not None:
            self.writer.close()
            self.writer = None
        if self.dist is not None:
            # roll each scope's tip back to the newest STITCHED key: a tail
            # checkpoint whose stitch never happened (crashed peer,
            # straggler past the deadline) has member manifests but no v4,
            # and final_keys must never name it. Non-lead processes learn
            # the outcome here, from the store, without extra coordination.
            for scope, chain in self._key_chain.items():
                if chain and not self.dist.group.is_lead:
                    self._await_stitch(chain[-1])
                live = [k for k in chain if self.store.has(k)]
                self._last_key[scope] = live[-1] if live else None

    def _await_stitch(self, key: str):
        """Non-lead close-time wait for the lead's verdict on the tip key:
        either the v4 appears or the key lands in the incomplete meta.
        Bounded by the stitch timeout — a dead lead costs one deadline,
        never a wedge."""
        deadline = time.monotonic() + self.dist.timeout_s
        while time.monotonic() < deadline:
            if self.store.has(key):
                return
            inc = self.store.get_meta("incomplete_ckpts") or {"keys": []}
            if key in inc.get("keys", []):
                return
            time.sleep(0.02)

    def chain_keys(self) -> list[str]:
        """The tip checkpoint key of every scope's delta chain. A GC that
        runs mid-record MUST keep these live (their parent closure carries
        every chunk hash the next delta manifest will inherit)."""
        return [k for k in self._last_key.values() if k]

    def reset(self):
        """Forget all digest / chain state (next submits are full)."""
        self.tracker.reset()
        self._sig.clear()
        self._last_key.clear()
        self._since_full.clear()
        self._hashes.clear()
        self._encs.clear()

    @property
    def stats(self) -> list[dict]:
        return list(self._stats)


def _encode_changed(d: dict, lmeta: dict, chunk_words: int):
    """Turn one finalized delta record into per-chunk wire payloads.

    Iterates the delta's ``enc_groups`` — one group per wire encoding the
    tracker chose (a fixed-policy leaf has at most one; the adaptive
    error-bound selector can split one checkpoint's changed chunks across
    q4 / q8 / raw). Raw rows: gathered u32 blocks back to native bytes,
    last chunk trimmed to the leaf's real length. q8 / q4 rows: already
    int8 (resp. packed-nibble) + scales from the fused gather kernels —
    packed into the self-describing chunk formats (per-chunk element count,
    so the last chunk trims the same way). Returns (idx_keep, chunks_keep,
    encs_keep, transferred_bytes) with the three lists parallel and sorted
    by chunk index."""
    nbytes, n_chunks = lmeta["nbytes"], lmeta["n_chunks"]
    dtype = lmeta["dtype"]
    itemsize = 2 if dtype in ("bfloat16", "float16") else 4
    total_elems = nbytes // itemsize
    chunk_native = chunk_words * native_bytes_per_word(dtype)
    out: dict[int, tuple[str, bytes]] = {}
    for gr in d["enc_groups"]:
        e = gr["enc"]
        if e == "q8":
            block = min(Q8_BLOCK, chunk_words)
            for j, i in enumerate(gr["idx"].tolist()):
                n_el = chunk_words if i < n_chunks - 1 \
                    else total_elems - (n_chunks - 1) * chunk_words
                out[int(i)] = ("q8", q8_encode_chunk(
                    gr["q"][j], gr["scales"][j], n_el, block))
        elif e == "q4":
            block = min(Q4_BLOCK, chunk_words)
            for j, i in enumerate(gr["idx"].tolist()):
                n_el = chunk_words if i < n_chunks - 1 \
                    else total_elems - (n_chunks - 1) * chunk_words
                out[int(i)] = ("q4", q4_encode_chunk(
                    gr["packed"][j], gr["scales"][j], n_el, block))
        else:
            native = blocks_to_native_bytes(gr["blocks"], dtype)
            # tracker clamps changed_idx to the leaf's real chunk count, so
            # every row lands in [0, n_chunks); only the last needs trimming
            for i, data in zip(gr["idx"].tolist(), native):
                if i == n_chunks - 1:
                    data = data[: nbytes - (n_chunks - 1) * chunk_native]
                out[int(i)] = ("raw", data)
    idx_keep = sorted(out)
    encs_keep = [out[i][0] for i in idx_keep]
    chunks_keep = [out[i][1] for i in idx_keep]
    return idx_keep, chunks_keep, encs_keep, \
        sum(len(c) for c in chunks_keep)


def _match_slot(pstr: str, pat: str) -> bool:
    """True when a keystr leaf path matches a slot name or glob pattern."""
    return (f"['{pat}']" in pstr or f'["{pat}"]' in pstr
            or f".{pat}" in pstr or fnmatch.fnmatch(pstr, pat))


def _as_tensor(leaf) -> torch.Tensor:
    """A tensor leaf as is; numpy arrays and Python scalars as CPU tensors."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.asarray(leaf)
    # a copy, not ascontiguousarray: that promotes a 0-d scalar to shape (1,)
    return torch.from_numpy(a if a.flags.c_contiguous and a.flags.writeable
                            else a.copy())


def _fp_view(leaf: torch.Tensor) -> torch.Tensor:
    """The tensor the fingerprint actually runs over. 64-bit leaves get a
    bit-preserving int32 view (two words per element), exactly the word
    view the reference package fingerprints for its 64-bit host leaves
    (native_bytes_per_word is 4 either way)."""
    if leaf.element_size() == 8:
        return leaf.contiguous().reshape(-1).view(torch.int32)
    return leaf
