"""The Flor public API (paper: ``import flor``) — session-first, record side.

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

This package records. Hindsight replay (``Session(mode="replay")``), warm
start, and the query surface are the next slices (ROADMAP queue 1); replay
mode raises NotImplementedError until then.
"""
from __future__ import annotations

from repro_torch.core.context import (  # noqa: F401
    FlorContext, FlorDeprecationWarning, get_context)
from repro_torch.core.session import (  # noqa: F401
    CheckpointScope, LineageSpec, RecordSpec, Session, arg, checkpointing,
    executed, loop)
from repro_torch.logging import FingerprintLog, FlorLogValueWarning  # noqa: F401


def log(key: str, value):
    """Log a metric / probe value into the fingerprint log. A non-blocking
    enqueue by default: a tensor is snapshotted on its device and the
    background stage pays the copy, serialization and I/O, drawing from the
    same epsilon overhead budget as checkpoints."""
    ctx = get_context()
    ctx.log.log(ctx.current_epoch, key, value)


def current_epoch():
    """Epoch of the active outer loop's current iteration (None outside
    one)."""
    return get_context().current_epoch
