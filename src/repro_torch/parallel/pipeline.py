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

The buffer goes through ``constrain(buf, ("stage", ...))``: the identity
without a mesh; under a mesh it raises until sharded model compute
exists (ROADMAP queue 1, item 10). Bubble fraction is the usual
(S-1)/(M+S-1).
"""
from __future__ import annotations

import torch

from repro_torch.parallel.sharding import constrain
from repro_torch.utils.pytree import tree_leaves


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
    buf = constrain(buf, ("stage",) + (None,) * (buf.ndim - 1))
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


def bubble_fraction(n_stages: int, microbatches: int) -> float:
    return (n_stages - 1) / (microbatches + n_stages - 1)
