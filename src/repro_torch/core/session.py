"""The session-first Flor surface: typed specs, `flor.Session`, nested
`flor.loop`, declarative `flor.checkpointing`, replay-stable `flor.arg`.

The paper pitches Flor as a library adopted with minimal ceremony; FlorDB
(arXiv:2408.02498) shows where that lands: named nested loops instead of a
hand-paired ``step_into``/``end`` protocol, checkpointing declared as a
scope instead of threaded through call sites, and hyperparameters that
record on record and replay the recorded value on replay.

    with flor.Session(run_dir) as sess:                   # record
        lr = flor.arg("peak_lr", 1e-3)
        with flor.checkpointing(state=state) as ckpt:
            for epoch in flor.loop("epochs", range(flor.arg("epochs", 8))):
                for step, batch in flor.loop("train", lambda: loader()):
                    ckpt.state, m = ts(ckpt.state, batch)
                flor.log("loss", m["loss"])
        state = ckpt.state

Replay is the same script with ``mode="replay"`` (plus any hindsight
``flor.log`` probes): the OUTER loop drives epoch bookkeeping and the
replay init/exec phases; each INNER loop is a SkipBlock — skipped epochs
yield nothing and the checkpointing scope is physically restored, probed
epochs re-execute logically. Loops opened with no enclosing
``checkpointing`` scope are sub-epoch probes: they always execute and never
checkpoint.

Sessions nest and sequence (the context binding is a stack, not a global);
the legacy ``flor.init``/``finish`` shims keep working but warn with
:class:`FlorDeprecationWarning`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, fields
from typing import Any, Iterable, Optional, Union

from repro_torch.core.context import (FlorContext, FlorDeprecationWarning,  # noqa: F401
                                get_context, pop_context, push_context)
from repro_torch.core.generator import epoch_iter
from repro_torch.core.skipblock import skipblock
from repro_torch.logging import DEFAULT_QUEUE_DEPTH, DEFAULT_SPILL_BYTES

VALID_INIT_MODES = ("strong", "weak")


def _check_log_knobs(queue_depth: int, spill_bytes: int):
    """Shared RecordSpec/ReplaySpec validation of the logging knobs."""
    if queue_depth < 1:
        raise ValueError(f"log_queue_depth must be >= 1, got {queue_depth}")
    if spill_bytes < 0:
        raise ValueError("log_spill_bytes must be >= 0 (0 disables), "
                         f"got {spill_bytes}")


# ------------------------------------------------------------- typed specs --
@dataclass(frozen=True)
class RecordSpec:
    """Record-side knobs (subsumes the old kwargs bag's record half).

    ``epsilon`` budgets TOTAL record overhead — checkpoint materialization
    AND observed background-logging cost share it (docs/logging.md). The
    ``log_*`` knobs configure the background logging subsystem
    (``repro_torch.logging``): ``async_log=False`` reverts ``flor.log`` to the
    synchronous flat-file path; ``log_queue_depth`` bounds how far the
    training thread can run ahead of the log writer before enqueues apply
    backpressure; a logged array larger than ``log_spill_bytes`` host bytes
    is spilled to the checkpoint store and logged as a ``{"ref": ...}``
    pointer row (0 disables spilling).

    ``ckpt_error_bounds`` declares WHAT ERROR each lossy slot tolerates
    instead of how to encode it: ``{"mu": 1e-2}`` (slot name or glob ->
    absolute per-element tolerance). The pipeline picks, per changed chunk,
    the cheapest wire encoding whose guaranteed blockwise bound satisfies
    the tolerance — int4 packed nibbles when the chunk's amplitude allows,
    else int8, else exact — and the writer thread may additionally
    entropy-compress the result. ``ckpt_quantize_slots`` is the older
    fixed-q8 spelling (DEPRECATED — prefer an error bound of
    ``absmax / 126`` intent via ``ckpt_error_bounds``); when a slot matches
    both, the error bound wins. Everything unmatched stays exact: the
    bit-identical restore invariant holds by default.

    ``full_manifest_every`` bounds delta-chain length; pass ``"auto"`` to
    let the pipeline retune the cadence from the store's measured read
    bandwidth and learned per-hop restore cost (restore-bound stores get
    short chains, cheap-hop stores amortize fulls over long ones).
    ``ckpt_overlap`` overlaps the fused fingerprint pass with training: the
    step thread only dispatches kernels and the mask sync + gather + encode
    move to the writer thread (the adaptive controller then charges only
    the measured foreground stall against epsilon)."""
    epsilon: float = 1.0 / 15          # record-overhead budget (Eq. 1)
    adaptive: bool = True              # adaptive checkpointing (section 5.3)
    async_materialize: bool = True     # background checkpoint write stage
    full_manifest_every: Any = 8       # delta-chain length bound (or "auto")
    async_log: bool = True             # background flor.log (repro_torch.logging)
    log_index: bool = True             # incremental query index (repro_torch.querydb)
    log_queue_depth: int = DEFAULT_QUEUE_DEPTH    # bounded queue (backpressure)
    log_spill_bytes: int = DEFAULT_SPILL_BYTES    # spill threshold (0 = off)
    ckpt_quantize_slots: tuple = ()    # slots stored lossy-q8 (deprecated)
    ckpt_error_bounds: tuple = ()      # {slot: atol} adaptive encodings
    ckpt_overlap: bool = False         # overlap fused pass with the step
    # mesh-sharded record: with a jax.sharding.Mesh here, each device shard
    # fingerprints/gathers its OWN buffer and writes to its host's store
    # shard (v4 stitching manifests; restore reshards onto any mesh).
    # ckpt_shard_axes picks the mesh axes that map onto store shards
    # (default () = all axes: one store shard per device).
    mesh: Optional[Any] = None
    ckpt_shard_axes: tuple = ()
    # true multi-process record (jax.distributed): every REAL host runs the
    # fused pass over its local shards and publishes member manifests into
    # its own pool; process 0 stitches the v4 through a file rendezvous.
    # ``distributed=True`` reads the fleet shape from the initialized jax
    # runtime (process_index/process_count); a
    # parallel.rendezvous.ProcessGroup pins it explicitly. A host past
    # ``stitch_timeout_s`` marks the checkpoint incomplete (replay skips
    # it) instead of wedging training.
    distributed: Any = False
    stitch_timeout_s: float = 30.0

    def __post_init__(self):
        if not 0 < self.epsilon <= 1:
            raise ValueError(f"epsilon must be in (0, 1], got {self.epsilon}")
        if isinstance(self.full_manifest_every, str):
            if self.full_manifest_every != "auto":
                raise ValueError(
                    "full_manifest_every must be an int >= 1 or \"auto\", "
                    f"got {self.full_manifest_every!r}")
        elif self.full_manifest_every < 1:
            raise ValueError("full_manifest_every must be >= 1")
        _check_log_knobs(self.log_queue_depth, self.log_spill_bytes)
        if isinstance(self.ckpt_quantize_slots, str):
            raise ValueError(
                "ckpt_quantize_slots must be a sequence of slot names / "
                "globs, not a bare string (a string would match per-char)")
        object.__setattr__(self, "ckpt_quantize_slots",
                           tuple(self.ckpt_quantize_slots))
        if isinstance(self.ckpt_error_bounds, str):
            raise ValueError(
                "ckpt_error_bounds must be a {slot: atol} mapping (or a "
                "sequence of (slot, atol) pairs), not a bare string")
        eb = self.ckpt_error_bounds
        pairs = sorted(eb.items()) if isinstance(eb, dict) \
            else sorted(tuple(p) for p in eb)
        for p in pairs:
            if len(p) != 2 or not isinstance(p[0], str) or not p[0]:
                raise ValueError(
                    f"ckpt_error_bounds entries must be (slot, atol) with a "
                    f"non-empty slot name/glob, got {p!r}")
            if not float(p[1]) > 0:
                raise ValueError(
                    f"ckpt_error_bounds atol must be > 0, got {p[1]!r} for "
                    f"slot {p[0]!r}")
        object.__setattr__(self, "ckpt_error_bounds",
                           tuple((s, float(a)) for s, a in pairs))
        if self.ckpt_overlap and not self.async_materialize:
            raise ValueError("ckpt_overlap requires async_materialize=True "
                             "(the writer thread finalizes the deferred "
                             "fused pass)")
        if isinstance(self.ckpt_shard_axes, str):
            raise ValueError("ckpt_shard_axes must be a sequence of mesh "
                             "axis names, not a bare string")
        object.__setattr__(self, "ckpt_shard_axes",
                           tuple(self.ckpt_shard_axes))
        if self.mesh is not None and not hasattr(self.mesh, "devices"):
            raise ValueError(f"mesh must be a jax.sharding.Mesh, got "
                             f"{type(self.mesh).__name__}")
        if self.ckpt_shard_axes and self.mesh is None:
            raise ValueError("ckpt_shard_axes requires mesh=")
        if self.mesh is not None and self.ckpt_shard_axes:
            names = {str(a) for a in self.mesh.axis_names}
            bad = [a for a in self.ckpt_shard_axes if str(a) not in names]
            if bad:
                raise ValueError(f"ckpt_shard_axes {bad} not in mesh axes "
                                 f"{sorted(names)}")
        if self.distributed and self.mesh is None:
            raise ValueError("distributed record requires mesh= (the global "
                             "device mesh spanning every process)")
        if not float(self.stitch_timeout_s) > 0:
            raise ValueError(f"stitch_timeout_s must be > 0, got "
                             f"{self.stitch_timeout_s!r}")

    def to_kwargs(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


@dataclass(frozen=True)
class ReplaySpec:
    """Replay-side knobs: work assignment, init mode, probed blocks.

    Two assignment forms:
      * ``segments=`` — an explicit ordered visit list from the replay
        planner (``repro_torch.replay``): ``[(epoch, "init"|"exec"), ...]``, or
        bare epochs (treated as exec visits). ``plan=`` accepts a
        ``ReplayPlan`` directly and derives the full single-worker visit
        list (and the probed set, unless given).
      * ``pid``/``nworkers`` — the legacy contiguous split, kept as a
        deprecation shim (the generator warns when ``nworkers > 1``).

    The ``log_*`` knobs mirror :class:`RecordSpec`'s: hindsight probes
    logged during replay go through the same background subsystem (each
    replay attempt rotates its per-pid stream)."""
    pid: int = 0
    nworkers: int = 1
    init_mode: str = "strong"          # strong | weak
    probed: frozenset = frozenset()    # block names to re-execute ('*' = all)
    segments: Optional[tuple] = None   # planned visits [(epoch, phase), ...]
    plan: Optional[Any] = None         # a ReplayPlan (repro_torch.replay.plan)
    async_log: bool = True             # background flor.log (repro_torch.logging)
    log_index: bool = True             # incremental query index (repro_torch.querydb)
    log_queue_depth: int = DEFAULT_QUEUE_DEPTH
    log_spill_bytes: int = DEFAULT_SPILL_BYTES

    def __post_init__(self):
        _check_log_knobs(self.log_queue_depth, self.log_spill_bytes)
        if self.init_mode not in VALID_INIT_MODES:
            raise ValueError(f"init_mode must be one of {VALID_INIT_MODES}, "
                             f"got {self.init_mode!r}")
        if self.plan is not None:
            if self.segments is None:
                object.__setattr__(self, "segments",
                                   tuple(self.plan.visits_for()))
            if not self.probed:
                object.__setattr__(self, "probed",
                                   frozenset(self.plan.probed))
        if self.segments is not None:
            norm = []
            for s in self.segments:
                e, ph = s if isinstance(s, (tuple, list)) else (s, "exec")
                if ph not in ("init", "exec"):
                    raise ValueError(f"segment phase must be 'init' or "
                                     f"'exec', got {ph!r}")
                norm.append((int(e), ph))
            object.__setattr__(self, "segments", tuple(norm))
            if self.pid < 0:
                raise ValueError(f"pid must be >= 0, got {self.pid}")
        elif not 0 <= self.pid < self.nworkers:
            raise ValueError(f"pid {self.pid} outside [0, {self.nworkers})")
        object.__setattr__(self, "probed", frozenset(self.probed))

    def to_kwargs(self) -> dict:
        return {"pid": self.pid, "nworkers": self.nworkers,
                "init_mode": self.init_mode, "probed": set(self.probed),
                "segments": self.segments, "async_log": self.async_log,
                "log_index": self.log_index,
                "log_queue_depth": self.log_queue_depth,
                "log_spill_bytes": self.log_spill_bytes}


@dataclass(frozen=True)
class LineageSpec:
    """Multi-run shared-store binding (PR 2's run lineage, typed)."""
    store_root: Optional[str] = None   # shared store (default: private store)
    run_id: Optional[str] = None       # explicit id in the shared store
    parent_run: Optional[str] = None   # ancestor run id: enables warm_start

    def __post_init__(self):
        if self.parent_run and not self.store_root:
            # a parent ref only resolves against a store that can hold two
            # runs; a private flat store cannot
            raise ValueError("parent_run requires store_root (a shared "
                             "store) to resolve the ancestor")

    def to_kwargs(self) -> dict:
        return {"store_root": self.store_root, "run_id": self.run_id,
                "parent_run": self.parent_run}


_RECORD_KEYS = {f.name for f in fields(RecordSpec)}
_REPLAY_KEYS = {f.name for f in fields(ReplaySpec)}
_LINEAGE_KEYS = {f.name for f in fields(LineageSpec)}


def specs_from_kwargs(mode: str, kw: dict) -> tuple[
        Optional[RecordSpec], Optional[ReplaySpec], Optional[LineageSpec]]:
    """Partition a legacy kwargs bag into typed specs (unknown keys raise).
    Used by the `flor.init` shim and `exec_instrumented` so every entry
    point validates through the same typed layer."""
    rec_kw = {k: v for k, v in kw.items() if k in _RECORD_KEYS}
    rep_kw = {k: v for k, v in kw.items() if k in _REPLAY_KEYS}
    lin_kw = {k: v for k, v in kw.items() if k in _LINEAGE_KEYS}
    unknown = set(kw) - _RECORD_KEYS - _REPLAY_KEYS - _LINEAGE_KEYS
    if unknown:
        raise TypeError(f"unknown Flor arguments {sorted(unknown)}; valid: "
                        f"{sorted(_RECORD_KEYS | _REPLAY_KEYS | _LINEAGE_KEYS)}")
    if rep_kw.get("probed") is not None:
        rep_kw["probed"] = frozenset(rep_kw["probed"])
    record = RecordSpec(**rec_kw) if (rec_kw and mode == "record") else None
    replay = ReplaySpec(**rep_kw) if (rep_kw and mode == "replay") else None
    lineage = LineageSpec(**lin_kw) if any(v is not None
                                           for v in lin_kw.values()) else None
    return record, replay, lineage


# ------------------------------------------------------------------ session --
class Session:
    """An explicit Flor run: `with flor.Session(run_dir, mode=...) as sess`.

    Owns one :class:`FlorContext` for its extent, binds it on the context
    STACK (so sessions nest and sequence safely — no single mutable global),
    and finishes it on exit (registry status ``finished``, or ``failed``
    when the body raised). All module-level surface functions
    (``flor.loop``/``checkpointing``/``log``/``arg``) resolve the innermost
    active session; the methods on this object address THIS session
    explicitly, which is the primary, non-ambient path.
    """

    def __init__(self, run_dir: str, mode: str = "record", *,
                 record: Optional[RecordSpec] = None,
                 replay: Optional[ReplaySpec] = None,
                 lineage: Optional[LineageSpec] = None):
        if mode not in ("record", "replay"):
            raise ValueError(f"mode must be 'record' or 'replay', got {mode!r}")
        if mode == "record" and replay is not None:
            raise ValueError("ReplaySpec given for a record session")
        if mode == "replay" and record is not None:
            raise ValueError("RecordSpec given for a replay session")
        self.run_dir = run_dir
        self.mode = mode
        self.record = record if mode == "record" else None
        self.replay = replay if mode == "replay" else None
        self.lineage = lineage or LineageSpec()
        self._ctx: Optional[FlorContext] = None

    # ------------------------------------------------------- lifecycle --
    def __enter__(self) -> "Session":
        if self._ctx is not None:
            raise RuntimeError("Session is not re-entrant; create a new one")
        kw = dict(self.lineage.to_kwargs())
        if self.mode == "record":
            kw.update((self.record or RecordSpec()).to_kwargs())
        else:
            kw.update((self.replay or ReplaySpec()).to_kwargs())
        self._ctx = FlorContext(self.run_dir, self.mode, **kw)
        push_context(self._ctx)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        ctx, self._ctx = self._ctx, None
        if ctx is not None:
            pop_context(ctx)
            ctx.finish(status="finished" if exc_type is None else "failed")
        return False

    @property
    def ctx(self) -> FlorContext:
        if self._ctx is None:
            raise RuntimeError("Session is not active (use `with Session(...) "
                               "as sess:`)")
        return self._ctx

    # ------------------------------------------------- explicit surface --
    @property
    def run_id(self):
        """This run's registry id (record: generated or explicit; replay:
        read back from ``flor.run.json``)."""
        return self.ctx.run_id

    @property
    def parent_run(self):
        """Ancestor run id of the lineage edge, or None (same value on
        record and replay — replay reads the recorded binding)."""
        return self.ctx.parent_run

    @property
    def store_root(self):
        """The checkpoint store this session reads/writes (shared root or
        the private ``<run_dir>/store``)."""
        return self.ctx.store_root

    @property
    def current_epoch(self):
        """Epoch of the outer loop's current iteration (None outside it).
        On replay this follows the planned visit order, not 0..N."""
        return self.ctx.current_epoch

    def log(self, key: str, value):
        """Log a metric/probe value into THIS session's fingerprint log.
        Record: the row becomes part of the fingerprint replay must
        reproduce. Replay: rows land in the attempt's own per-pid stream and
        are diffed (or, for hindsight-only keys, admitted) by
        ``flor.deferred_check``. Non-blocking by default: the value is
        captured and enqueued; serialization and I/O happen on the
        background log stage (``RecordSpec/ReplaySpec(async_log=)``)."""
        ctx = self.ctx
        ctx.log.log(ctx.current_epoch, key, value)

    def arg(self, name: str, default=None):
        """Replay-stable hyperparameter. Record: resolve (``FLOR_ARGS=``
        overrides the default), persist to store meta, return. Replay:
        return the RECORDED value, coerced to the default's type."""
        return self.ctx.hparam(name, default)

    def loop(self, name: str, iterable):
        """Named Flor loop bound to THIS session (see module-level
        :func:`loop`). Record: iterate + bookkeep (outer) / checkpoint via
        the enclosing scope (inner). Replay: the outer loop walks the
        planned init/exec visits; inner loops skip-and-restore or
        re-execute per the probed set."""
        return loop(name, iterable, ctx=self.ctx)

    def checkpointing(self, **slots) -> "checkpointing":
        """Declare WHAT gets checkpointed for the loops in the scope.
        Record: the slots are the Loop End Checkpoint payload. Replay: a
        skipped block physically restores INTO these slots."""
        return checkpointing(_ctx=self.ctx, **slots)

    def executed(self, name: str) -> bool:
        """Whether block `name`'s latest occurrence actually ran. Record:
        always True after the loop. Replay: False when it was skipped and
        physically restored — guard post-loop logging with this."""
        return self.ctx.block_executed.get(name, False)

    def warm_start(self, block_id: str = "train", like=None):
        """Restore the parent run's final checkpoint for `block_id`.
        Record: also seeds the delta pipeline (first checkpoint becomes a
        cross-run delta). Replay: restore only, through the parent run's
        chunks."""
        return self.ctx.warm_start(block_id, like=like)


# -------------------------------------------------------------- scopes -----
class CheckpointScope:
    """A mutable namespace of named state slots — WHAT gets checkpointed for
    the `flor.loop` blocks in its extent. Slots are read/written as
    attributes or items; a skipped block's physical restore lands back in
    the same slots."""

    def __init__(self, slots: dict):
        object.__setattr__(self, "_slots", dict(slots))

    def __getattr__(self, name: str):
        try:
            return object.__getattribute__(self, "_slots")[name]
        except KeyError:
            raise AttributeError(f"no checkpointing slot {name!r} "
                                 f"(declared: {sorted(self._slots)})") from None

    def __setattr__(self, name: str, value):
        self._slots[name] = value

    def __getitem__(self, name: str):
        return self._slots[name]

    def __setitem__(self, name: str, value):
        self._slots[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._slots

    def keys(self):
        return self._slots.keys()

    def update(self, **kw):
        self._slots.update(kw)

    def state_dict(self) -> dict:
        """The checkpoint payload: a plain dict pytree of the slots."""
        return dict(self._slots)

    def _restore(self, tree: dict):
        self._slots.update(tree)

    def __repr__(self):
        return f"CheckpointScope({sorted(self._slots)})"


class checkpointing:
    """``with flor.checkpointing(state=..., opt=...) as ckpt:`` — declare the
    checkpointed state for the `flor.loop` blocks inside the scope, instead
    of threading it through `skipblock.end`. Scopes nest; a loop binds to
    the INNERMOST active scope. Record: the slots are each block's Loop End
    Checkpoint payload. Replay: a skipped block physically restores the
    recorded payload INTO the slots; an executed block leaves what the
    re-execution computed."""

    def __init__(self, _ctx: Optional[FlorContext] = None, **slots):
        self._ctx = _ctx
        self._scope = CheckpointScope(slots)
        self._bound: Optional[FlorContext] = None

    def __enter__(self) -> CheckpointScope:
        self._bound = self._ctx or get_context()
        self._bound.scope_stack.append(self._scope)
        return self._scope

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._bound is not None and self._scope in self._bound.scope_stack:
            self._bound.scope_stack.remove(self._scope)
        self._bound = None
        return False


# --------------------------------------------------------------- flor.loop --
def loop(name: str, iterable: Union[Iterable, Any], *,
         ctx: Optional[FlorContext] = None):
    """Named Flor loop. The FIRST loop entered on a context is the MAIN loop
    (epoch bookkeeping, replay partitioning and init/exec phases); loops
    nested inside it are SkipBlocks bound to the innermost
    `flor.checkpointing` scope — on replay they skip (yield nothing,
    physically restore the scope) or re-execute per the probed set. A
    nested loop with NO active scope is a sub-epoch probe: always executes,
    never checkpoints.

    ``iterable`` may be a zero-arg callable returning the iterable — it is
    only invoked when the block actually executes, so skipped epochs never
    pay for (or leak) data-loader construction."""
    ctx = ctx or get_context()
    if ctx.loop_depth == 0 and ctx.current_epoch is None:
        return _outer_loop(ctx, name, _materialize(iterable))
    return _inner_loop(ctx, name, iterable)


def _materialize(iterable):
    return iterable() if callable(iterable) else iterable


def _outer_loop(ctx: FlorContext, name: str, iterable: Iterable):
    ctx.loop_depth += 1
    try:
        for e in epoch_iter(ctx, iterable, name=name):
            yield e
    finally:
        ctx.loop_depth -= 1
        # sequential main loops on one context each start fresh
        ctx.current_epoch = None


def _inner_loop(ctx: FlorContext, name: str, iterable):
    scope = ctx.scope_stack[-1] if ctx.scope_stack else None
    if scope is None:
        yield from _probe_loop(ctx, name, iterable)
        return
    execute = skipblock._open(ctx, name)
    ctx.loop_depth += 1
    completed = False
    try:
        if execute:
            for item in _materialize(iterable):
                yield item
        completed = True
    finally:
        ctx.loop_depth -= 1
        if completed:
            # both branches close the block: executed -> (maybe) memoize the
            # scope's slots; skipped -> physically restore them
            scope._restore(
                skipblock._close(ctx, name, scope.state_dict()))
        else:
            # early exit (break / exception): no checkpoint — replay then
            # re-executes this block logically, the only consistent outcome
            skipblock._abort(ctx, name)


def _probe_loop(ctx: FlorContext, name: str, iterable):
    """A nested loop with no checkpointing scope: nothing declared to
    restore, so it always executes (logical redo on replay)."""
    t0 = time.perf_counter()
    ctx.block_executed[name] = True
    ctx.loop_depth += 1
    try:
        for item in _materialize(iterable):
            yield item
    finally:
        ctx.loop_depth -= 1
        elapsed = time.perf_counter() - t0
        ctx.controller.observe_execution(name, elapsed)
        ctx.note_block_profile(name, elapsed)
        ctx.advance_block(name)


# ----------------------------------------------------------- module surface --
def arg(name: str, default=None):
    """Replay-stable hyperparameter: record the resolved value on record
    (``FLOR_ARGS="name=value,..."`` overrides the code default), return the
    RECORDED value on replay."""
    return get_context().hparam(name, default)


def executed(name: str) -> bool:
    """Whether the most recent occurrence of loop/block `name` actually ran
    (False = skipped + physically restored). Guard post-loop logging that
    only makes sense after real execution."""
    return skipblock.executed(name)
