"""SkipBlock (paper section 4.2): parameterized branching + side-effect
memoization/restoration, in functional form (the state is a pytree of
tensors that the train step replaces, never mutates).

Usage (the functional tier — the changeset is the explicit state pytree):

    if flor.skipblock.step_into("train"):
        for batch in batches(epoch):
            state, metrics = train_step(state, batch)
    state = flor.skipblock.end("train", state)

``end`` must run on BOTH branches: when the block executed it (maybe)
memoizes and passes state through; when it was skipped it restores the Loop
End Checkpoint — the physical half of physiological recovery.
"""
from __future__ import annotations

import time
from typing import Any

from repro_torch.core.context import get_context
from repro_torch.utils.pytree import block_until_ready, tree_bytes
from repro_torch.utils.timing import span


class _SkipBlockAPI:
    def __init__(self):
        self._t_enter: dict[str, float] = {}
        self._executed: dict[str, bool] = {}

    # -- internal protocol (shared with the session surface's flor.loop) --
    def _open(self, ctx, block_id: str) -> bool:
        with span("repro_torch.flor.block"):
            key = ctx.block_key(block_id)
            if ctx.mode == "record":
                execute = True
            else:
                has = ctx.store.has(key)
                if ctx.replay_phase == "init":
                    # initialization: skip whenever physically possible
                    execute = not has
                else:
                    # work segment: re-execute probed blocks (logical
                    # redo); skip unprobed memoized blocks (physical redo)
                    probed = block_id in ctx.probed or "*" in ctx.probed
                    execute = probed or not has
            self._executed[block_id] = execute
            ctx.block_executed[block_id] = execute   # per-context
            self._t_enter[block_id] = time.perf_counter()
            return execute

    def _abort(self, ctx, block_id: str):
        """Abandon an open block without memoizing (early exit / exception):
        no checkpoint is written, so replay re-executes the block logically —
        the only consistent outcome for a partially-run body. In record mode
        this is worth a warning: an every-epoch early exit (e.g. a `break`
        in an instrumented legacy loop) would silently leave the whole run
        checkpoint-less."""
        ran = self._executed.pop(block_id, False)
        self._t_enter.pop(block_id, None)
        if ran and ctx.mode == "record":
            import warnings
            warnings.warn(
                f"flor block {block_id!r} exited early (break/exception); "
                f"no checkpoint was written for this occurrence, so replay "
                f"will re-execute it logically", stacklevel=3)
        ctx.advance_block(block_id)

    def executed(self, block_id: str) -> bool:
        """Whether the most recent occurrence of `block_id` on the ACTIVE
        context actually ran (False = it was skipped and physically restored
        on replay). Per-context state: sequential/nested sessions never see
        each other's blocks."""
        return get_context().block_executed.get(block_id, False)

    # ---------------------------------------------------------------------
    def step_into(self, block_id: str) -> bool:
        """True => execute the enclosed loop; False => skip (end() restores).
        DEPRECATED with end(): use `for x in flor.loop(name, iterable)`
        inside a `with flor.checkpointing(...)` scope."""
        from repro_torch.core.context import _deprecated
        _deprecated("flor.skipblock.step_into/end are deprecated; use "
                    "flor.loop(name, iterable) + flor.checkpointing(...)")
        return self._open(get_context(), block_id)

    # ---------------------------------------------------------------------
    def end(self, block_id: str, state: Any) -> Any:
        """Close the block. Returns the (possibly restored) state."""
        return self._close(get_context(), block_id, state)

    def _close(self, ctx, block_id: str, state: Any) -> Any:
        executed = self._executed.pop(block_id, True)
        if executed:
            # the card runs the block's launches asynchronously: wait for
            # them so C_i measures the work, not its enqueue (the wait is
            # the block's device work, outside Flor's span)
            block_until_ready(state)
        with span("repro_torch.flor.block"):
            return self._closed(ctx, block_id, state, executed)

    def _closed(self, ctx, block_id: str, state: Any, executed: bool):
        key = ctx.block_key(block_id)
        elapsed = time.perf_counter() - self._t_enter.pop(block_id, time.perf_counter())

        if executed:
            ctx.controller.observe_execution(block_id, elapsed)
            if ctx.mode == "record":
                ctx.note_block_profile(block_id, elapsed)
                est = tree_bytes(state)
                if ctx.controller.should_materialize(block_id, est_bytes=est):
                    ctx.submit_checkpoint(block_id, key, state,
                                          meta={"epoch": ctx.current_epoch,
                                                "block": block_id})
            ctx.advance_block(block_id)
            return state

        # skipped: physical restoration from the Loop End Checkpoint (delta
        # manifests resolve transparently through the store)
        restored, restore_s = ctx.restore_checkpoint(key, like=state)
        ctx.controller.observe_restore(block_id, restore_s)
        ctx.advance_block(block_id)
        return restored


skipblock = _SkipBlockAPI()
