"""FlorContext: per-run global state shared by generator / SkipBlock.

Mirrors the paper's parameterized-branching state machine (section 4.2):
mode in {record, replay}; replay phase in {init, exec}; plus the probed-block
set, the adaptive controller, the checkpoint store/async writer, and the
fingerprint log (background by default — `repro_torch.logging`; ``flor.log`` on
the step path is an enqueue, and observed logging cost draws down the same
epsilon budget that gates checkpoint materialization).

Run lineage: `store_root=` shares one content-addressed store across runs
(per-run manifest namespaces, global chunk dedup); `parent_run=` declares
the lineage edge. The binding persists in `<run_dir>/flor.run.json`; run
records live in the `RunRegistry` beside the store.

Record and hindsight replay (init/exec phases, planned visit lists, physical
restore onto the live state's device) are ported; warm start, the query
index and mesh-sharded / multi-process record or replay are later slices
(ROADMAP queue 1) and raise NotImplementedError here.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Optional

from repro_torch.checkpoint import (CheckpointPipeline, CheckpointStore,
                              RunIdCollision, RunRegistry)
from repro_torch.checkpoint.lineage import (generate_run_id, read_run_meta,
                                      write_run_meta)
from repro_torch.core.adaptive import AdaptiveController
from repro_torch.logging import (DEFAULT_QUEUE_DEPTH, DEFAULT_SPILL_BYTES,
                                 FingerprintLog, jsonable)

# Contexts form a STACK: `flor.Session` pushes on enter and pops on exit, so
# nested and sequential sessions compose without a single mutable global.
_CTX_STACK: list["FlorContext"] = []
# The legacy `flor.init` shim manages exactly one stack entry of its own.
_LEGACY_CTX: Optional["FlorContext"] = None


class FlorDeprecationWarning(DeprecationWarning):
    """Raised-or-warned category for deprecated Flor arguments. Set
    ``FLOR_STRICT_DEPRECATIONS=1`` to turn any use into a hard error."""


def _deprecated(msg: str):
    if os.environ.get("FLOR_STRICT_DEPRECATIONS"):
        raise FlorDeprecationWarning(msg)
    warnings.warn(msg, FlorDeprecationWarning, stacklevel=3)


class FlorContext:
    def __init__(self, run_dir: str, mode: str = "record", *,
                 epsilon: float = 1.0 / 15, adaptive: bool = True,
                 pid: int = 0, nworkers: int = 1, init_mode: str = "strong",
                 probed: Optional[set] = None,
                 segments: Optional[list] = None,
                 async_materialize: bool = True,
                 full_manifest_every: int = 8, store_root: Optional[str] = None,
                 parent_run: Optional[str] = None, run_id: Optional[str] = None,
                 async_log: bool = True, log_index: bool = True,
                 log_queue_depth: int = DEFAULT_QUEUE_DEPTH,
                 log_spill_bytes: int = DEFAULT_SPILL_BYTES,
                 ckpt_quantize_slots=(), ckpt_error_bounds=(),
                 ckpt_overlap: bool = False,
                 mesh=None, ckpt_shard_axes=(),
                 distributed=False, stitch_timeout_s: float = 30.0):
        if mode not in ("record", "replay"):
            raise ValueError(f"mode must be 'record' or 'replay', got {mode!r}")
        if mesh is not None or distributed:
            raise NotImplementedError(
                "mesh-sharded / multi-process record and replay are not "
                "ported yet (ROADMAP queue 1, items 12-13)")
        if ckpt_quantize_slots:
            _deprecated(
                "ckpt_quantize_slots is deprecated: declare WHAT error each "
                "slot tolerates via ckpt_error_bounds={slot: atol} and let "
                "the pipeline pick the cheapest encoding per chunk "
                "(ckpt_quantize_slots still works as fixed q8)")
        self.run_dir = run_dir
        self.mode = mode
        self.replay_phase = "init"           # init | exec (replay only)
        self.pid = pid
        self.nworkers = nworkers
        self.init_mode = init_mode           # strong | weak
        self.probed: set = set(probed or ())
        # planned replay (repro_torch.replay): an explicit ordered visit list
        # [(epoch, "init"|"exec"), ...] supersedes the contiguous
        # pid/nworkers split — the generator iterates exactly these
        self.segments = None if segments is None else \
            tuple((e, ph) for e, ph in segments)
        self.current_epoch: Optional[int] = None
        self._intra_epoch_counts: dict[str, int] = {}
        self.controller = AdaptiveController(epsilon=epsilon, enabled=adaptive)
        # ---- run lineage binding (multi-run shared store) ----
        # `store_root=` shares one content-addressed store across runs: each
        # run gets a manifest NAMESPACE (its run id) so keys never collide,
        # while chunks dedup globally. Without it, the store stays private
        # at <run_dir>/store in the legacy flat layout. Record writes the
        # binding to <run_dir>/flor.run.json; replay reads it back, so a
        # derived run's hindsight replay reconnects to the shared store (and
        # resolves through ancestor-run chunks) with zero extra arguments.
        os.makedirs(run_dir, exist_ok=True)
        if mode == "record":
            shared = store_root is not None
            self.store_root = os.path.abspath(store_root) if shared \
                else os.path.join(run_dir, "store")
            saved = read_run_meta(run_dir)
            generated = False
            if run_id:
                self.run_id = run_id
            elif shared and saved.get("run_id") \
                    and saved.get("store_root") == self.store_root:
                # re-init of the same run dir against the same shared store
                # is a crash-restart/resume, not a new run: forking a fresh
                # namespace would orphan the run's own checkpoints
                self.run_id = saved["run_id"]
            else:
                self.run_id = generate_run_id()
                generated = True
            if parent_run is None and self.run_id == saved.get("run_id"):
                # resuming the same run (however identified) keeps its
                # lineage edge
                parent_run = saved.get("parent_run")
            self.namespace = self.run_id if shared else None
            self.parent_run = parent_run
            self._run_meta = {
                "run_id": self.run_id, "namespace": self.namespace,
                "store_root": self.store_root if shared else None,
                "parent_run": self.parent_run}
            if self.run_id == saved.get("run_id"):   # resume: keep bindings
                self._run_meta["warm_start_keys"] = \
                    saved.get("warm_start_keys") or {}
            # register BEFORE binding the store handle: simultaneous
            # recorders race the registry on a shared filesystem. The
            # atomic create-or-retry applies to every NEW registration —
            # a generated id retries with a fresh one, an explicit id
            # surfaces the conflict (two recorders given the same
            # --run-id must not silently clobber each other); a resume of
            # this run's own (run_dir, namespace) is never a collision.
            self.registry = RunRegistry(self.store_root)
            for attempt in range(8):
                try:
                    self.registry.register(self.run_id,
                                           parent=self.parent_run,
                                           run_dir=os.path.abspath(run_dir),
                                           namespace=self.namespace,
                                           exclusive=True)
                    break
                except RunIdCollision:
                    if not generated or attempt == 7:
                        raise
                    self.run_id = generate_run_id()
                    self.namespace = self.run_id if shared else None
                    self._run_meta["run_id"] = self.run_id
                    self._run_meta["namespace"] = self.namespace
            self._registered = True
            write_run_meta(run_dir, self._run_meta)
        else:
            # replay reconnects through the binding record persisted: the
            # store (private or shared), the namespace and the lineage edge
            saved = read_run_meta(run_dir)
            self._run_meta = saved
            self.run_id = run_id or saved.get("run_id")
            self.store_root = os.path.abspath(store_root) if store_root \
                else (saved.get("store_root")
                      or os.path.join(run_dir, "store"))
            self.namespace = saved.get("namespace") if saved \
                else (self.run_id if store_root else None)
            self.parent_run = parent_run or saved.get("parent_run")
            self.registry = RunRegistry(self.store_root)
            self._registered = False
        self.store = CheckpointStore(self.store_root, run_id=self.namespace)
        if mode == "record":
            self._snapshot_source()
        if adaptive and mode == "record":
            # a resumed run (or any run sharing this store namespace) already
            # measured the store's throughput: reuse the persisted figure and
            # skip the ~8MB probe write; fresh stores still calibrate once
            calib = self.store.get_meta("store_calib")
            if calib and calib.get("write_bps"):
                self.controller.write_bps = float(calib["write_bps"])
            else:
                calib = self._calibrate_store()
                calib["measured_at"] = time.time()
                self.store.put_meta("store_calib", calib)
                self.controller.write_bps = calib["write_bps"]
        self.async_materialize = async_materialize
        # the delta-aware record flow; replay never submits checkpoints, so
        # it gets no pipeline (and no idle writer thread)
        self.pipeline = CheckpointPipeline(
            self.store, async_stage=async_materialize,
            full_every=full_manifest_every,
            quantize_slots=ckpt_quantize_slots,
            error_bounds=dict(ckpt_error_bounds or {}),
            overlap=ckpt_overlap,
            on_materialized=self._on_materialized) \
            if mode == "record" else None
        # backward-compat handle (benchmarks call ctx.writer.drain())
        self.writer = self.pipeline.writer if self.pipeline else None
        # ``log_index`` (the incremental sqlite query index) is accepted for
        # spec compatibility; the index arrives with the query slice, so
        # this run's logs are file-scan-served.
        # record resumes (seq continues from the tail); each replay attempt
        # rotates its per-pid log so stale lines never pollute deferred_check.
        # async_log (default) puts serialization + I/O on a background stage
        # writing crash-safe segments; the observed logging overhead feeds
        # the controller so it shares the epsilon budget with checkpoints.
        stream = "record" if mode == "record" else f"replay_p{pid}"
        self.log = FingerprintLog(
            os.path.join(run_dir, "logs", f"{stream}.jsonl"),
            fresh=(mode == "replay"), async_log=async_log,
            queue_depth=log_queue_depth, spill_bytes=log_spill_bytes,
            store=self.store, stream=stream,
            on_overhead=self.controller.observe_logging)
        self._block_keys_meta: dict[str, dict] = {}
        # ---- session-surface state (flor.loop / flor.checkpointing /
        # flor.arg): nesting depth of active flor.loop iterators (0 = the
        # next loop opened is the MAIN loop), the stack of declared
        # checkpointing scopes, and replay-stable hyperparameters
        self.loop_depth = 0
        self.scope_stack: list = []
        self.block_executed: dict[str, bool] = {}
        # record-side per-(block, epoch) execution profile: the replay
        # planner's exec-cost estimates come from here (store meta
        # "block_profile"), so cost-balanced partitioning sees real skew
        self._block_profile: dict[str, dict[int, dict]] = {}
        self._hparams: dict = {}
        self._arg_overrides = _parse_arg_overrides(
            os.environ.get("FLOR_ARGS", ""))
        self.t_start = time.time()
        # background-materialization callback bookkeeping: map store key ->
        # block id so M_i lands on the right block
        self._key_to_block: dict[str, str] = {}
        self.restore_stats: list[dict] = []

    def _snapshot_source(self):
        """Keep a copy of the driving script in store meta ("source") for
        `--probe auto` source-diff detection (paper section 3.2). A resumed
        run keeps the ORIGINAL recorded copy — the diff base must be what
        the run actually executed first. The script tier overwrites this
        with the exact user script it instruments."""
        try:
            import __main__
            path = getattr(__main__, "__file__", None)
            if not path or not os.path.isfile(path) \
                    or os.path.getsize(path) > (1 << 20):
                return
            if self.store.get_meta("source"):
                return
            with open(path) as f:
                self.store.put_meta("source", {"path": os.path.abspath(path),
                                               "src": f.read()})
        except Exception:
            pass                 # snapshotting is best-effort, never fatal

    def _calibrate_store(self) -> dict:
        """One ~8MB probe measures real store throughput BOTH ways: the write
        (serialize+compress+write — the pre-measurement M estimate) and a
        read-back (read+decompress+deserialize — the replay planner's
        restore-cost prior, refined later by observed restores in finish()).
        The probe is UNIQUE random data (so its chunks cannot be shared with
        any real checkpoint) and is deleted afterwards — calibration must not
        pollute list_keys() or stored_bytes() accounting."""
        import numpy as np
        rng = np.random.default_rng()        # unseeded => unshared chunks
        probe = rng.standard_normal(1 << 21).astype(np.float32)   # 8 MB
        t0 = time.perf_counter()
        self.store.put_tree("__calib__", {"x": probe})
        dt_w = max(time.perf_counter() - t0, 1e-4)
        t0 = time.perf_counter()
        self.store.get_tree("__calib__")
        dt_r = max(time.perf_counter() - t0, 1e-4)
        self.store.delete_manifest("__calib__", delete_chunks=True)
        return {"write_bps": max(probe.nbytes / dt_w, 1e7),
                "read_bps": max(probe.nbytes / dt_r, 1e7)}

    # ------------------------------------------------------------ keys ----
    def begin_epoch(self, epoch: int):
        self.current_epoch = epoch
        self._intra_epoch_counts = {}

    def block_key(self, block_id: str) -> str:
        """Stable checkpoint key for the CURRENT occurrence of a block."""
        idx = self._intra_epoch_counts.get(block_id, 0)
        return f"{block_id}@{self.current_epoch}.{idx}"

    def advance_block(self, block_id: str):
        self._intra_epoch_counts[block_id] = \
            self._intra_epoch_counts.get(block_id, 0) + 1

    def note_block_profile(self, block_id: str, seconds: float):
        """Record that `block_id` EXECUTED in the current epoch for
        `seconds` (record mode only) — the planner's per-segment exec-cost
        ground truth."""
        if self.mode != "record" or self.current_epoch is None:
            return
        try:
            epoch = int(self.current_epoch)
        except (TypeError, ValueError):
            return
        cell = self._block_profile.setdefault(block_id, {}) \
            .setdefault(epoch, {"n": 0, "s": 0.0})
        cell["n"] += 1
        cell["s"] += float(seconds)

    # ----------------------------------------------------- materialization
    def _on_materialized(self, stat: dict):
        block = self._key_to_block.pop(stat["key"], None)
        if block is None:
            return
        if stat.get("overlap"):
            # overlap mode: the fused pass ran async with the step, and the
            # mask sync + gather + encode + write all happened on the writer
            # thread. Only the measured foreground stall (dispatch + any
            # queue backpressure) is record overhead; the writer-thread time
            # is accounted separately, and the transfer fraction — unknown
            # at submit — lands here once measured
            self.controller.observe_materialization(
                block, stat.get("submit_stall_s", 0.0))
            self.controller.note_background(stat["materialize_s"])
            if stat.get("transferred_bytes") is not None:
                self.controller.note_transfer(block,
                                              stat["transferred_bytes"],
                                              stat["logical_bytes"])
        else:
            # M_i = foreground stall on the training thread (fingerprint +
            # changed-chunk DMA) + background write stage; counting only the
            # latter would let the eps-overhead invariant undercount record
            # cost. The writer-thread entropy stage is the exception: it
            # only runs when an async writer exists, so its seconds are
            # genuinely concurrent with training — they move to the
            # background accumulator instead of the epsilon-charged M_i
            entropy_s = stat.get("entropy_s") or 0.0
            self.controller.observe_materialization(
                block,
                max(0.0, stat["materialize_s"] - entropy_s)
                + stat.get("submit_stall_s", 0.0))
            if entropy_s:
                self.controller.note_background(entropy_s)

    def submit_checkpoint(self, block_id: str, key: str, tree, meta):
        assert self.pipeline is not None, \
            "submit_checkpoint is a record-mode operation"
        self._key_to_block[key] = block_id
        self.controller.note_submitted(block_id)
        stat = self.pipeline.submit(key, tree, meta, scope=block_id)
        if stat is not None and stat["transferred_bytes"] is not None:
            # overlap mode reports None here (the gather is deferred to the
            # writer thread); the measured figure arrives in _on_materialized
            self.controller.note_transfer(block_id,
                                          stat["transferred_bytes"],
                                          stat["logical_bytes"])

    # ------------------------------------------------------- warm start --
    def warm_start(self, block_id: str = "train", like=None):
        """Cross-run warm start (restore the parent run's final checkpoint
        and seed the delta pipeline with it) is a later slice of this
        package (ROADMAP queue 1, item 8)."""
        raise NotImplementedError(
            "warm_start is not ported yet (ROADMAP queue 1, item 8)")

    # ---------------------------------------------------- hyperparameters --
    def hparam(self, name: str, default=None):
        """Replay-stable hyperparameter (`flor.arg`). Record: resolve the
        value (``FLOR_ARGS="name=value,..."`` overrides the code default),
        persist it in store meta, return it. Replay: return the RECORDED
        value — the run dir, not the code, is the source of truth — coerced
        to the default's type when one is given."""
        if self.mode == "record":
            val = default
            if name in self._arg_overrides:
                val = _coerce(self._arg_overrides[name], default)
            self._hparams[name] = jsonable(val, name)
            self.store.put_meta("hparams", {"args": self._hparams})
            return val
        recorded = (self.store.get_meta("hparams") or {}).get("args", {})
        if name in recorded:
            return _coerce(recorded[name], default)
        return default        # hindsight arg the record run never declared

    def restore_checkpoint(self, key: str, like=None):
        """Load a checkpoint (delta manifests resolve transparently) and
        account the restore for the controller's restore/materialize ratio
        and replay diagnostics. Each sample records the restored byte count
        and the parent hops the resolution walked — finish() fits a learned
        restore cost model (read_bps, hop_s) from them that the replay
        planner consumes via store calibration meta."""
        import numpy as np
        from repro_torch.checkpoint.store import np_dtype
        t0 = time.perf_counter()
        manifest = self.store.resolve_manifest(key)
        read_stats: dict = {}
        tree = self.store.get_tree(key, like=like, manifest=manifest,
                                   stats_out=read_stats)
        dt = time.perf_counter() - t0
        nbytes = sum(
            int(lf["nbytes"]) if lf.get("nbytes") is not None
            else int(np.prod(lf["shape"], dtype=np.int64))
            * np_dtype(lf["dtype"]).itemsize
            for lf in manifest["leaves"])
        sample = {"key": key, "restore_s": dt, "bytes": nbytes,
                  "hops": int(manifest.get("hops") or 0)}
        if read_stats.get("bytes_by_shard"):
            # sharded restore: what each store shard actually served (a
            # resharded read touches only overlapping chunks) — the raw
            # material for per-shard read_bps calibration
            sample["shard_bytes"] = {str(k): int(v) for k, v in
                                     read_stats["bytes_by_shard"].items()}
            sample["chunks_read"] = int(read_stats.get("chunks_read") or 0)
        self.restore_stats.append(sample)
        return tree, dt

    # ---------------------------------------------------------------- gc --
    def gc(self, keep_keys: Optional[list] = None) -> dict:
        """Collect unreferenced chunks. Default live set = every manifest
        key of THIS run (removes only orphans from crashed/partial runs);
        pass `keep_keys` for rolling retention on long record runs. The
        active delta-chain tips are always kept live — collecting them would
        leave the pipeline inheriting chunk hashes from deleted manifests,
        making every subsequent checkpoint unrestorable. In a shared store,
        every OTHER registered run stays fully live: retention here is a
        run-local policy; cross-run reclamation is the registry's job
        (`python -m repro_torch.launch.runs gc`)."""
        if self.pipeline is not None:
            self.pipeline.drain()      # don't race in-flight manifests
        live = self.store.list_keys() if keep_keys is None \
            else list(keep_keys)
        if self.pipeline is not None:
            # on BOTH branches: a warm-started run's tip may be a parent-run
            # key that does not appear in this run's own namespace listing
            live += self.pipeline.chain_keys()
        live = [self.store.qualify(k) for k in live]
        # every OTHER registered run stays fully live (retention is a
        # run-local policy; cross-run reclamation belongs to `runs gc`)
        live += self.registry.live_keys(self.store,
                                        exclude_run_id=self.run_id)
        return self.store.gc(live)

    # ------------------------------------------------------------ finish --
    def finish(self, status: str = "finished"):
        # close the log FIRST: it drains the background stage (rows become
        # durable) and its final overhead totals land in the controller
        # snapshot persisted below. A deferred background-log error must
        # NOT abort finalization — the pipeline still drains, the registry
        # still records the run, and the error re-raises at the end.
        log_err: Optional[BaseException] = None
        try:
            self.log.close()
        except BaseException as e:
            log_err = e
        final_keys: dict[str, str] = {}
        if self.pipeline is not None:
            pipeline, self.pipeline = self.pipeline, None
            pipeline.close()
            self.writer = None
            final_keys = {s: k for s, k in pipeline._last_key.items() if k}
        if self._registered:
            # the per-scope tips are what a derived run warm-starts from
            self.registry.finalize(self.run_id, final_keys=final_keys,
                                   status=status)
            self._registered = False
        if self._block_profile:
            # merge over any previous profile so a resumed run keeps the
            # epochs it recorded before the restart
            prev = (self.store.get_meta("block_profile") or {}).get("blocks",
                                                                    {})
            for bid, per_epoch in self._block_profile.items():
                cur = prev.setdefault(bid, {})
                cur.update({str(e): v for e, v in per_epoch.items()})
            self.store.put_meta("block_profile", {"blocks": prev})
        self.store.put_meta(f"controller_{self.mode}_p{self.pid}",
                            self.controller.snapshot())
        self._persist_restore_calib()
        if log_err is not None:
            raise log_err

    def _persist_restore_calib(self):
        """Fold observed restores into store calibration meta: a learned
        (read_bps, hop_s) restore cost model the replay planner consumes
        (plan.restore_cost). Measured restores supersede the probe read-back
        — they go through the real chunk/decompress/delta-resolve path at
        real checkpoint sizes — and hop_s is only fit when the samples
        actually span different chain depths (a rank-deficient fit would
        hallucinate a hop latency)."""
        fit = _fit_restore_model(self.restore_stats)
        shard_fit = _fit_shard_read_bps(self.restore_stats)
        if fit is None and shard_fit is None:
            return
        try:
            calib = dict(self.store.get_meta("store_calib") or {})
            calib.update(fit or {})
            if shard_fit:
                # per-store-shard service rate (merged over runs): the
                # planner's max-over-hosts restore cost consumes it
                merged = dict(calib.get("shard_read_bps") or {})
                merged.update(shard_fit)
                calib["shard_read_bps"] = merged
            calib["restore_samples"] = len(self.restore_stats)
            calib["restore_measured_at"] = time.time()
            self.store.put_meta("store_calib", calib)
        except OSError:
            pass            # calibration is advisory, never fatal at finish


def _fit_restore_model(stats: list) -> Optional[dict]:
    """Least-squares (read_bps, hop_s) from restore samples of the form
    {"restore_s", "bytes", "hops"}. Model: t = bytes/read_bps + hops*hop_s.
    Returns {"read_bps"} alone when the samples don't constrain hop_s (all
    the same chain depth, or the fit goes non-physical), None when there is
    nothing usable to learn from."""
    import numpy as np
    rows = [s for s in stats
            if s.get("bytes") and float(s.get("restore_s") or 0) > 0]
    if not rows:
        return None
    b = np.array([float(s["bytes"]) for s in rows])
    h = np.array([float(s.get("hops") or 0) for s in rows])
    t = np.array([float(s["restore_s"]) for s in rows])
    # effective end-to-end throughput: the always-valid fallback figure
    eff_bps = float(np.clip(b.sum() / max(t.sum(), 1e-9), 1e6, 1e12))
    if len(rows) >= 3 and np.unique(h).size >= 2:
        coef, *_ = np.linalg.lstsq(np.stack([b, h], axis=1), t, rcond=None)
        sec_per_byte, hop_s = float(coef[0]), float(coef[1])
        if sec_per_byte > 0 and hop_s >= 0:
            return {"read_bps": float(np.clip(1.0 / sec_per_byte, 1e6, 1e12)),
                    "hop_s": hop_s}
    return {"read_bps": eff_bps}


def _fit_shard_read_bps(stats: list) -> Optional[dict]:
    """Per-store-shard service rate from sharded restore samples (those that
    carry a {"shard_bytes": {hid: bytes}} breakdown). Shards are read
    concurrently in production, so attributing each sample's full wall time
    to every participating shard gives a conservative (lower-bound) per-shard
    rate — exactly the right bias for a cost model used to schedule work."""
    bytes_by = {}
    secs_by = {}
    for s in stats:
        sb = s.get("shard_bytes")
        wall = float(s.get("restore_s") or 0)
        if not sb or wall <= 0:
            continue
        for hid, nbytes in sb.items():
            if not nbytes:
                continue
            bytes_by[str(hid)] = bytes_by.get(str(hid), 0) + int(nbytes)
            secs_by[str(hid)] = secs_by.get(str(hid), 0.0) + wall
    if not bytes_by:
        return None
    return {hid: float(min(max(bytes_by[hid] / max(secs_by[hid], 1e-9),
                                1e6), 1e12))
            for hid in bytes_by}


def _parse_arg_overrides(spec: str) -> dict[str, str]:
    """``FLOR_ARGS="epochs=12,peak_lr=3e-4"`` -> {"epochs": "12", ...}."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _coerce(val, default):
    """Coerce a recorded/override value to the default's type (JSON and env
    round-trips lose int/float/bool/tuple-ness)."""
    if default is None or isinstance(val, type(default)):
        return val
    try:
        if isinstance(default, bool):
            return val if isinstance(val, bool) \
                else str(val).lower() in ("1", "true", "yes", "on")
        return type(default)(val)
    except (TypeError, ValueError):
        return val


# ------------------------------------------------------- context binding --
def push_context(ctx: FlorContext) -> FlorContext:
    _CTX_STACK.append(ctx)
    return ctx


def pop_context(ctx: FlorContext):
    """Unbind `ctx`. Sessions unwind LIFO; an out-of-order pop (e.g. a
    leaked legacy context under an active Session) removes just that entry."""
    if ctx in _CTX_STACK:
        _CTX_STACK.remove(ctx)


def get_context() -> FlorContext:
    if not _CTX_STACK:
        raise RuntimeError(
            "no active Flor context — enter `with flor.Session(run_dir, "
            "mode=...)` (or call the legacy flor.init) first")
    return _CTX_STACK[-1]


def init(run_dir: str, mode: str = "record", **kw) -> FlorContext:
    """DEPRECATED shim: the pre-Session single-slot API. Finishes any
    previous init()-made context, then constructs and binds a new one. The
    old context is unbound BEFORE construction, so a constructor failure
    leaves no closed context reachable from get_context()."""
    global _LEGACY_CTX
    _deprecated("flor.init() is deprecated; use `with flor.Session(run_dir, "
                "mode=...)` (typed RecordSpec/ReplaySpec/LineageSpec specs)")
    if _LEGACY_CTX is not None:
        old, _LEGACY_CTX = _LEGACY_CTX, None
        pop_context(old)
        old.finish()
    ctx = FlorContext(run_dir, mode, **kw)
    _LEGACY_CTX = ctx
    return push_context(ctx)


def finish():
    """DEPRECATED shim: finish + unbind the context made by flor.init()."""
    global _LEGACY_CTX
    _deprecated("flor.finish() is deprecated; Session.__exit__ finishes "
                "the run")
    if _LEGACY_CTX is not None:
        old, _LEGACY_CTX = _LEGACY_CTX, None
        pop_context(old)
        old.finish()
