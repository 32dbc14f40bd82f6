"""The Flor public API (paper: ``import flor``) — session-first.

Record:
    import repro_torch.flor as flor
    with flor.Session(run_dir) as sess:               # mode="record"
        lr = flor.arg("peak_lr", 1e-3)                # replay-stable hparam
        with flor.checkpointing(state=state) as ckpt:
            for epoch in flor.loop("epochs", range(flor.arg("epochs", N))):
                for step, batch in flor.loop("train", lambda: loader()):
                    ckpt.state, m = train_step(ckpt.state, batch)
                flor.log("loss", m["loss"])
        state = ckpt.state

Each inner loop closes with a Loop End Checkpoint of the ``checkpointing``
scope: the delta pipeline fingerprints every leaf on the card, moves only the
changed chunks (in the q8/q4 wire formats for slots declared in
``RecordSpec(ckpt_error_bounds=)``), and writes them to the content-addressed
store on a background thread. ``flor.log`` is an enqueue; a background stage
pays the device->host copy and the I/O.

Replay (hindsight logging): the same script with
    flor.Session(run_dir, mode="replay",
                 replay=flor.ReplaySpec(probed={"train"}))
plus any ``flor.log(...)`` probes you wished you had. Skipped epochs yield
nothing and the ``checkpointing`` scope is restored physically from the Loop
End Checkpoint onto the device of the live state; probed epochs re-execute.
Parallel replay is planned: ``flor.build_plan(run_dir, probed=...)``
(``probed="auto"`` source-diffs the recorded script copy with
``flor.detect_probes``) selects which epochs re-execute, and a cost-balanced
scheduler hands each worker a visit list (``ReplaySpec(segments=...)``;
``python -m repro_torch.launch.replay`` drives it end to end).
``flor.merge_replay_logs`` merges the workers' logs by plan segment and
``flor.deferred_check(*flor.run_logs(run_dir))`` diffs replay against
record. ``flor.sampling_generator`` replays a sampled subset of epochs.

Run lineage (multi-run shared store): point several runs at one store and
declare the edge —

    with flor.Session(runB_dir,
                      lineage=flor.LineageSpec(store_root=STORE,
                                               parent_run="base",
                                               run_id="ft1")) as sess:
        state = sess.warm_start("train", like=state)  # ancestor's final ckpt
        ...fine-tune...                               # 1st ckpt already a delta

The restored tensors land on the devices of ``like``'s leaves, and the
pipeline's digests are seeded there, so the first checkpoint moves only the
chunks that changed since the ancestor's final checkpoint.

Query the accumulated logs of a whole lineage as data:

    flor.log_records(STORE)           # flat rows: run_id, parent_run, epoch,
                                      #   seq, key, value (+ replay sources)
    flor.pivot(STORE, "loss")         # one row per (run, epoch), keys as cols
    flor.reindex(STORE)               # catch the sqlite query index up

Queries are served by the incrementally-maintained sqlite index
(``<store_root>/index/flor.db``, repro_torch.querydb) whenever its
watermarks prove it current, and fall back to scanning the log files
otherwise; the two paths return identical rows. From the shell:
``python -m repro_torch.launch.runs list|show|gc|rm|diff|logs|pivot|reindex
--store-root ...``.

Hands-free mode (paper section 3, the script tier): ``import flor`` is the
only change to a training script. ``flor.exec_instrumented(path, run_dir=,
mode=)`` rewrites the script's AST (``flor.instrument_source``): the main
loop's iterator goes through ``flor.loop``, and each nested loop whose
changeset the Table-1 rules can estimate (``flor.analyze_loop``) becomes a
named ``flor.loop`` inside a ``flor.checkpointing`` scope over that
changeset. The un-instrumented source is kept in store meta, so
``flor.detect_probes`` and ``flor.build_plan(probed="auto")`` diff it
against an edited copy.

Legacy surface: ``flor.init/finish/generator/skipblock`` keep working as
thin shims but warn with ``FlorDeprecationWarning``.

Mesh-sharded and multi-process runs are later slices (ROADMAP queue 1,
items 12-13) and raise NotImplementedError.
"""
from __future__ import annotations

from repro_torch.core.changeset import (  # noqa: F401
    analyze_loop, augment_changeset, outer_assignments, register_augmenter)
from repro_torch.core.context import (  # noqa: F401
    FlorContext, FlorDeprecationWarning, finish, get_context, init)
from repro_torch.core.fingerprint import deferred_check, run_logs  # noqa: F401
from repro_torch.core.generator import (generator, partition,  # noqa: F401
                                        sampling_generator)
from repro_torch.core.instrument import (  # noqa: F401
    exec_instrumented, instrument_source)
from repro_torch.core.probes import detect_probes  # noqa: F401
from repro_torch.core.query import (log_records,  # noqa: F401
                                    merge_replay_logs, pivot)
from repro_torch.core.session import (  # noqa: F401
    CheckpointScope, LineageSpec, RecordSpec, ReplaySpec, Session, arg,
    checkpointing, executed, loop)
from repro_torch.logging import FingerprintLog, FlorLogValueWarning  # noqa: F401
from repro_torch.querydb import reindex  # noqa: F401
from repro_torch.core.skipblock import skipblock  # noqa: F401
from repro_torch.replay import ReplayPlan, build_plan  # noqa: F401


def log(key: str, value):
    """Log a metric / probe value into the fingerprint log. A non-blocking
    enqueue by default: a tensor is snapshotted on its device and the
    background stage pays the copy, serialization and I/O, drawing from the
    same epsilon overhead budget as checkpoints. Replay logs into the
    attempt's own stream (``replay_p<pid>``); keys the record run logged
    too are diffed by ``deferred_check``, new keys are hindsight probes."""
    ctx = get_context()
    ctx.log.log(ctx.current_epoch, key, value)


def warm_start(block_id: str = "train", like=None):
    """Restore the parent run's final checkpoint for `block_id` (see
    ``LineageSpec(store_root=, parent_run=)``) and, when recording, seed
    the delta pipeline so this run's first checkpoint is a cross-run delta
    against its ancestor. Returns the restored state — unflattened into
    `like` (each tensor on its `like` leaf's device) when given, else a
    flat {path: CPU tensor} dict."""
    return get_context().warm_start(block_id, like=like)


def augment(namespace_subset: dict, namespace: dict) -> dict:
    """Script-tier helper: apply framework-knowledge augmentation to a
    changeset dict (``core/instrument.py`` emits calls to this)."""
    names = list(namespace_subset)
    extra = augment_changeset(names, namespace)
    out = dict(namespace_subset)
    for n in extra:
        if n not in out and n in namespace:
            out[n] = namespace[n]
    return out


def current_epoch():
    """Epoch of the active outer loop's current iteration (None outside
    one); on replay it follows the planned visit order."""
    return get_context().current_epoch
