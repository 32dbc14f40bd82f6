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

Warm start, the cross-run query surface and mesh / multi-process runs are
later slices (ROADMAP queue 1) and raise NotImplementedError.
"""
from __future__ import annotations

from repro_torch.core.context import (  # noqa: F401
    FlorContext, FlorDeprecationWarning, get_context)
from repro_torch.core.fingerprint import deferred_check, run_logs  # noqa: F401
from repro_torch.core.generator import sampling_generator  # noqa: F401
from repro_torch.core.probes import detect_probes  # noqa: F401
from repro_torch.core.query import merge_replay_logs  # noqa: F401
from repro_torch.core.session import (  # noqa: F401
    CheckpointScope, LineageSpec, RecordSpec, ReplaySpec, Session, arg,
    checkpointing, executed, loop)
from repro_torch.logging import FingerprintLog, FlorLogValueWarning  # noqa: F401
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


def current_epoch():
    """Epoch of the active outer loop's current iteration (None outside
    one); on replay it follows the planned visit order."""
    return get_context().current_epoch
