"""Sharding construction for the launches: map every step input and output
(TrainState, batch, caches) to a ``parallel.sharding.MeshSharding`` — a
spec on the mesh, whose ``placements`` are its torch form — through the
logical-axis resolver, as the reference package's ``launch/specs.py`` does
with NamedShardings."""
from __future__ import annotations

import torch

from repro_torch.models.api import build_model
from repro_torch.parallel.sharding import MeshSharding, physical_spec
from repro_torch.train.state import TrainState


def _shardings_from_axes(axes, shapes, mesh):
    """Pair a nested dict of logical-axes tuples with the same nesting of
    shapes (a ``torch.Size``, a ``(torch.Size, dtype)`` spec leaf, or a
    tensor)."""
    if isinstance(axes, dict):
        return {k: _shardings_from_axes(axes[k], shapes[k], mesh)
                for k in axes}
    if isinstance(shapes, torch.Tensor):
        shape = shapes.shape
    elif isinstance(shapes, torch.Size):
        shape = shapes
    else:                                   # a (torch.Size, dtype) spec leaf
        shape = shapes[0]
    return MeshSharding(mesh, physical_spec(axes, tuple(shape), mesh))


def param_shardings(model, mesh, serve=False):
    """(shardings, shapes) of the parameter tree. ``serve`` with the
    config's ``serve_replicate_fsdp`` drops the FSDP ("embed") dim, so
    weights replicate over pod/data for serving."""
    shapes = model.param_shapes()
    axes = model.param_axes()
    if serve and model.cfg.serve_replicate_fsdp:
        def drop_fsdp(ax):
            if isinstance(ax, dict):
                return {k: drop_fsdp(v) for k, v in ax.items()}
            return tuple(None if a == "embed" else a for a in ax)
        axes = drop_fsdp(axes)
    return _shardings_from_axes(axes, shapes, mesh), shapes


def state_shardings(cfg, mesh, state: TrainState) -> TrainState:
    """TrainState shardings: params/mu/nu share the param specs; step/rng
    are replicated. ``state`` gives the shapes (tensors or shapes with the
    TrainState's nesting)."""
    axes = build_model(cfg).param_axes()
    rep = MeshSharding(mesh, ())
    return TrainState(params=_shardings_from_axes(axes, state.params, mesh),
                      mu=_shardings_from_axes(axes, state.mu, mesh),
                      nu=_shardings_from_axes(axes, state.nu, mesh),
                      step=rep, rng=rep)


def batch_shardings(model, shape, mesh):
    """(shardings, specs) of the step inputs for a ``ShapeSpec``."""
    specs = model.input_specs(shape)
    axes = model.input_axes(shape)
    return {k: MeshSharding(mesh, physical_spec(axes[k], specs[k][0], mesh))
            for k in specs}, specs


def cache_shardings(model, shape, mesh):
    """(shardings, spec) of the decode caches for a ``ShapeSpec``."""
    spec = model.cache_spec(shape.global_batch, shape.seq_len)
    return _shardings_from_axes(model.cache_axes(), spec, mesh), spec
