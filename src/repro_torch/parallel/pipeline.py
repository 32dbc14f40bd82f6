"""GPipe-style pipeline parallelism (opt-in), the reference package's
``parallel/pipeline.py``: a composable building block for a "stage" mesh
axis.

The schedule is the classic skewed scan: with S stages and M microbatches,
time step t lets stage s work on microbatch (t - s). States live in a
[S, mb, ...] buffer that shifts one stage down per step (``torch.roll``).
The reference's ``lax.scan`` over the M + S - 1 ticks is a loop here, and
its ``jax.vmap`` of the stage function over the stage axis is
``torch.func.vmap``: every stage works on its own buffer slot at each
tick. Gradients flow through the scan.

The buffer goes through ``constrain(buf, ("stage", ...))``. Under a mesh
whose rules put "stage" on a mesh axis of S ranks (the reference's
``rules={"stage": [("stage",), ()]}``), the buffer is sharded over it: each
rank holds its stage's slot and applies its own stage's parameters, and
the roll becomes a ``ppermute`` to the next stage (the collective-permute
the reference's roll lowers to); the last stage's outputs are psummed
over the axis (the other ranks add zeros), so every rank returns the whole
result. A stage's own compute runs on its rank with no mesh installed: a
"stage" axis composes with no other mesh axis yet. Bubble fraction is the
usual (S-1)/(M+S-1).
"""
from __future__ import annotations

import torch

from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import (constrain, current_mesh,
                                           physical_spec, spec_axes,
                                           use_mesh)
from repro_torch.utils.pytree import tree_leaves, tree_map


def stage_scan(stage_fn, stage_params, x, *, microbatches: int):
    """Run ``x`` through S pipeline stages.

    stage_fn(params_slice, h) -> h  applies ONE stage (a group of layers).
    stage_params: pytree stacked on a leading S axis (logical "stage").
    x: [B, ...] with B % microbatches == 0.

    Returns the result of stage S-1 applied after ... after stage 0.
    """
    S = tree_leaves(stage_params)[0].shape[0]
    B = x.shape[0]
    assert B % microbatches == 0, (B, microbatches)
    mb = B // microbatches
    xs = x.reshape(microbatches, mb, *x.shape[1:])

    # state buffer: what each stage is currently holding
    buf = x.new_zeros((S, mb) + tuple(x.shape[1:]))
    logical = ("stage",) + (None,) * (buf.ndim - 1)
    if current_mesh() is not None:
        sax = spec_axes(physical_spec(logical, buf.shape), buf.ndim)[0]
        if sax:         # each rank makes its own slot of the buffer
            return _sharded_scan(stage_fn, stage_params, xs, S, sax)
    buf = constrain(buf, logical, have=(None,) * buf.ndim)
    run = torch.func.vmap(stage_fn)
    outs = []
    for t in range(microbatches + S - 1):
        if t < microbatches:
            # inject the next microbatch into stage 0's slot
            buf = torch.cat([xs[t][None], buf[1:]])
        # every stage processes its current microbatch (the slots of
        # stages not yet reached hold zeros and are never collected)
        processed = run(stage_params, buf)
        if t >= S - 1:
            # stage S-1's output is microbatch t - (S - 1)
            outs.append(processed[S - 1])
        # shift: stage s+1 receives stage s's output next step
        buf = torch.roll(processed, 1, dims=0)
    return torch.stack(outs).reshape(B, *x.shape[1:])


def _sharded_scan(stage_fn, stage_params, xs, S: int, sax: tuple):
    """The scan with the stage buffer sharded over mesh axis ``sax`` of S
    ranks: this rank's slot only. ``stage_params`` leaves hold all S
    stages (each rank takes its own) or this rank's one."""
    if len(sax) != 1 or col.axis_size(sax[0]) != S:
        raise ValueError(f"a sharded stage scan needs one mesh axis of {S} "
                         f"ranks for its {S} stages, got {sax}")
    axis = sax[0]
    me = col.axis_index(axis)
    mine = tree_map(lambda w: w[me] if w.shape[0] == S else w[0],
                    stage_params)
    M = xs.shape[0]
    ring = [(i, (i + 1) % S) for i in range(S)]
    slot = torch.zeros_like(xs[0])
    outs = []
    # Every rank keeps the same graph (values it does not use enter times
    # zero, as the reference's masked lanes do), so each runs the same
    # collectives, in the same order, in the backward pass too.
    for t in range(M + S - 1):
        if me == 0 and t < M:
            # inject the next microbatch into stage 0
            slot = xs[t] + 0 * slot if t else xs[t]
        with use_mesh(None):        # a stage's own compute is local
            processed = stage_fn(mine, slot)
        if t >= S - 1:
            # stage S-1's output is microbatch t - (S - 1)
            outs.append(processed if me == S - 1 else 0 * processed)
        # shift: stage s+1 receives stage s's output next step
        slot = col.ppermute(processed, axis, ring)
    out = col.psum(torch.stack(outs), axis)
    return out.reshape(-1, *xs.shape[2:])


def bubble_fraction(n_stages: int, microbatches: int) -> float:
    return (n_stages - 1) / (microbatches + n_stages - 1)
