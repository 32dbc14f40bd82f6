"""The Flor generator (paper section 5.4, Fig. 9): main-loop iterator
partitioning + worker initialization for hindsight parallelism.

Each of G workers receives a contiguous work segment of the main loop. Before
its segment it runs an INIT segment with SkipBlocks in replay-init mode:

  strong init — every epoch 0..k-1 (each restored physically from its Loop
    End Checkpoint when one exists, re-executed logically otherwise);
  weak init   — only from the LATEST materialized checkpoint <= k-1 (the
    paper's weak init assumes the k-1 checkpoint exists; with adaptive/sparse
    checkpointing we generalize to the nearest one, re-executing the gap).

Workers never communicate — replay is embarrassingly parallel.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

from repro_torch.core.context import get_context


def partition(items: Sequence, nworkers: int, pid: int) -> tuple[list, list]:
    """Contiguous split of `items` over workers; returns (before, mine).
    Work is balanced to within one item (paper Fig. 13 load-balancing note)."""
    n = len(items)
    base, rem = divmod(n, nworkers)
    start = pid * base + min(pid, rem)
    size = base + (1 if pid < rem else 0)
    return list(items[:start]), list(items[start:start + size])


def _latest_ckpt_epoch(ctx, epochs: Sequence[int], block_hint: str = "") -> Optional[int]:
    """Latest epoch in `epochs` with at least one materialized checkpoint."""
    for e in reversed(list(epochs)):
        keys = [k for k in ctx.store.list_keys()
                if k.endswith(f"_at_{e}.0") or f"_at_{e}." in k]
        if keys:
            return e
    return None


def sampling_generator(iterator: Iterable, sample: Sequence[int]):
    """Sampling replay (paper section 8, implemented): random access to any
    subset of main-loop iterations. For each sampled epoch the nearest
    materialized checkpoint <= epoch-1 provides the start state (weak-init
    machinery); the gap re-executes logically; everything else is skipped.
    This is the paper's 'searching and approximate query processing' POC —
    binary-search over the loss trajectory costs O(log N) epoch replays."""
    ctx = get_context()
    assert ctx.mode == "replay", "sampling replay is a replay-time feature"
    items = list(iterator)
    index = {e: i for i, e in enumerate(items)}
    todo = sorted(set(sample), key=lambda e: index[e])
    covered = -1
    for e in todo:
        i = index[e]
        if i <= covered:
            continue
        # init: jump to the nearest checkpointed epoch before e
        anchor = _latest_ckpt_epoch(ctx, items[covered + 1:i])
        start = index[anchor] if anchor is not None else covered + 1
        ctx.replay_phase = "init"
        for j in range(start, i):
            ctx.begin_epoch(items[j])
            yield items[j]
        ctx.replay_phase = "exec"
        ctx.begin_epoch(e)
        yield e
        covered = i


def epoch_iter(ctx, iterator: Iterable, name: Optional[str] = None):
    """MAIN-loop epoch iteration against an explicit context: record-side
    run metadata, replay-side work assignment + strong/weak init phases.
    Both the legacy ``generator()`` shim and the session-surface
    ``flor.loop`` outer iterator drive this.

    Replay iterates one of two assignments:
      * planned segments (``ctx.segments``, from ``repro_torch.replay``'s
        ReplayPlan/scheduler): an explicit ordered visit list
        ``[(epoch, "init"|"exec"), ...]`` — the query-driven path;
      * the legacy contiguous ``pid``/``nworkers`` split (deprecation shim).
    """
    items = list(iterator)

    if ctx.mode == "record":
        ctx.store.put_meta("run", {"num_epochs": len(items),
                                   "main_loop": name,
                                   "epochs": [int(e) if isinstance(e, (int,))
                                              else None for e in items]})
        for e in items:
            ctx.begin_epoch(e)
            yield e
        return

    # ---- replay: planned segments ----
    if ctx.segments is not None:
        index = {}
        for i, e in enumerate(items):
            try:
                index[e] = i
            except TypeError:
                pass
        for epoch, phase in ctx.segments:
            item = items[index[epoch]] if epoch in index else epoch
            ctx.replay_phase = "exec" if phase == "exec" else "init"
            ctx.begin_epoch(item)
            yield item
        ctx.replay_phase = "exec"
        return

    # ---- replay: legacy contiguous split ----
    if ctx.nworkers > 1:
        from repro_torch.core.context import _deprecated
        _deprecated("the contiguous pid/nworkers replay split is deprecated;"
                    " build a ReplayPlan (repro_torch.replay.build_plan) and pass "
                    "ReplaySpec(segments=...)")
    init_all, work = partition(items, ctx.nworkers, ctx.pid)
    if ctx.init_mode == "weak" and init_all:
        anchor = _latest_ckpt_epoch(ctx, init_all)
        if anchor is None:
            init_sgmnt = init_all            # no checkpoints: full logical redo
        else:
            # jump to the anchor checkpoint, re-execute any gap after it
            init_sgmnt = [e for e in init_all if e >= anchor]
    else:
        init_sgmnt = init_all

    ctx.replay_phase = "init"
    for e in init_sgmnt:
        ctx.begin_epoch(e)
        yield e
    ctx.replay_phase = "exec"
    for e in work:
        ctx.begin_epoch(e)
        yield e


def generator(iterator: Iterable):
    """DEPRECATED shim: wrap the MAIN loop's iterator (Fig. 8 line 2).
    New code spells this ``for e in flor.loop("epochs", iterator)``."""
    from repro_torch.core.context import _deprecated
    _deprecated("flor.generator() is deprecated; use "
                "flor.loop(name, iterable) under a flor.Session")
    return epoch_iter(get_context(), iterator)
