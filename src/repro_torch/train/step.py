"""train_step factory: loss + ``torch.autograd.grad`` + clip + AdamW (the
clip folded into the update, ``train/optimizer.py``).

The step is functional, as in the reference package: it returns a NEW
TrainState and never writes the old one in place, so a checkpoint whose
deferred gather still holds the old tensors reads the submitted bytes.
Entry points run on the card unless the caller asks for the CPU.

With a ``mesh`` (a ("data", "model") ``DeviceMesh`` over a fleet of
processes) the step is sharded, as the reference's jitted step is under
GSPMD: the state's leaves are DTensors laid out by
``launch.specs.state_shardings`` (parameters on "embed" over "data",
heads / kv_heads / mlp / vocab / expert over "model"), and the step runs on
their local tensors — explicit SPMD (``models/`` under ``use_mesh``) with
the collectives of ``parallel/collectives.py``. It backpropagates the
global batch's loss divided by the number of ranks (cotangents are partial
sums), psums each leaf's gradient over the axes the leaf is replicated on,
clips by the global norm that counts each element once, and runs AdamW on
the local shards. ``init_state`` never holds the whole state in one
process: each leaf is made whole, sliced and freed in turn, so the state
is bit-identical to ``place`` of the unsharded one. Every family runs
sharded. ``train_step.local_step`` is the step on one rank's local tensors
(what the dry run traces on the production mesh).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models import build_model
from repro_torch.train.optimizer import (AdamWState, adamw, clip_scale,
                                         norm_and_scale, sharded_global_norm)
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.state import TrainState
from repro_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.utils.timing import span


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist — there is no
    silent fallback to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run on the CPU)")
    return device


def batch_to_device(batch: dict, device) -> dict:
    """Host numpy batch (data/synthetic.py) -> tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, np.ndarray) else v.to(device)
            for k, v in batch.items()}


def build_loss_fn(cfg):
    model = build_model(cfg)

    def loss_fn(params, batch):
        return model.loss(params, batch)

    return loss_fn


def build_train_step(cfg, *, device="cuda", mesh=None, peak_lr=3e-4,
                     warmup=100, total_steps=10000, grad_clip=1.0,
                     weight_decay=0.1):
    """Returns (init_state(seed) -> TrainState, train_step(state, batch) ->
    (state, metrics)), both on ``device`` (default the card). ``batch``
    may hold host numpy arrays; they are moved to the device. With
    ``mesh``, the sharded step (every rank passes the global batch)."""
    device = resolve_device(device)
    model = build_model(cfg)
    sched = warmup_cosine(peak_lr, warmup, total_steps)
    opt_init, opt_update = adamw(sched, weight_decay=weight_decay,
                                 moment_dtype=cfg.moment_dtype)
    if mesh is not None:
        return _sharded_step(cfg, model, device, mesh, sched, opt_update,
                             grad_clip)

    def init_state(seed: int = 0) -> TrainState:
        params = model.init(seed, device)
        opt = opt_init(params)
        gen = torch.Generator().manual_seed(int(seed) + 1)
        rng = torch.randint(0, 2 ** 32, (2,), generator=gen,
                            dtype=torch.int64).to(torch.uint32)
        return TrainState(params=params, mu=opt.mu, nu=opt.nu,
                          step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          rng=rng.to(device))

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        batch = batch_to_device(batch, device)
        leaves, treedef = tree_flatten(state.params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        with span("repro_torch.step.forward"):
            loss, metrics = model.loss(tree_unflatten(treedef, leaves), batch)
        # a leaf the loss does not read (a zero-length layer stack, as in
        # a MoE config cut to its leading dense layers) has a zero gradient
        with span("repro_torch.step.backward"):
            grads = tree_unflatten(treedef, [
                torch.zeros_like(p) if g is None else g for p, g in zip(
                    leaves, torch.autograd.grad(loss, leaves,
                                                allow_unused=True))])
        # the clip is the update's: it scales each gradient as it reads it
        with span("repro_torch.step.optimizer"):
            gnorm, scale = norm_and_scale(grads, grad_clip)
            new_params, opt = opt_update(grads,
                                         AdamWState(state.mu, state.nu),
                                         state.params, state.step, scale)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        metrics["lr"] = sched(state.step)
        new_state = TrainState(params=new_params, mu=opt.mu, nu=opt.nu,
                               step=state.step + 1, rng=state.rng)
        return new_state, metrics

    return init_state, train_step


def _sharded_step(cfg, model, device, mesh, sched, opt_update, grad_clip):
    """(init_state, train_step) on ``mesh``: see the module docstring."""
    from repro_torch.models.transformer import mesh_param_specs
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import (mesh_axis_sizes, place,
                                               place_local, spec_axes,
                                               use_mesh)

    specs = mesh_param_specs(cfg, mesh)
    is_spec = lambda x: isinstance(x, tuple)  # noqa: E731
    spec_leaves = tree_flatten(specs, is_leaf=is_spec)[0]
    axes = tuple(mesh_axis_sizes(mesh))
    n_ranks = math.prod(mesh_axis_sizes(mesh).values())
    mdt = getattr(torch, cfg.moment_dtype)

    def spec_at(path):
        t = specs
        for k in path:
            t = t[k]
        return t

    def init_state(seed: int = 0) -> TrainState:
        params = model.init(seed, device, place=lambda path, x: place(
            x, mesh, spec_at(path)))

        def zeros(x):
            return place_local(torch.zeros(x.to_local().shape, dtype=mdt,
                                           device=device), x)
        gen = torch.Generator().manual_seed(int(seed) + 1)
        rng = torch.randint(0, 2 ** 32, (2,), generator=gen,
                            dtype=torch.int64).to(torch.uint32)
        return TrainState(
            params=params, mu=tree_map(zeros, params),
            nu=tree_map(zeros, params),
            step=place(torch.zeros((), dtype=torch.int32, device=device),
                       mesh, ()),
            rng=place(rng.to(device), mesh, ()))

    def local_step(params, mu, nu, step, batch, batch_specs=None):
        """One step on this rank's shards: ``params``, ``mu``, ``nu`` and
        ``step`` local tensors laid out by the state's specs, ``batch``
        the global batch (or its shards, laid out by ``batch_specs``).
        Returns (params, mu, nu, step + 1, metrics), local."""
        leaves, treedef = tree_flatten(params)
        local = [x.detach().requires_grad_(True) for x in leaves]
        with use_mesh(mesh):
            with span("repro_torch.step.forward"):
                loss, metrics = model.loss(tree_unflatten(treedef, local),
                                           batch, batch_specs)
            with span("repro_torch.step.backward"):
                raw = torch.autograd.grad(loss / n_ranks, local,
                                          allow_unused=True)
                with torch.no_grad():
                    grads = []
                    for p, g, spec in zip(local, raw, spec_leaves):
                        g = torch.zeros_like(p) if g is None else g
                        used = {a for ax in spec_axes(spec, p.ndim)
                                for a in ax}
                        rep = tuple(a for a in axes if a not in used)
                        grads.append(col.psum(g, rep) if rep else g)
                    del raw
            with span("repro_torch.step.optimizer"):
                with torch.no_grad():
                    gnorm = sharded_global_norm(grads, spec_leaves)
                new_params, opt = opt_update(
                    tree_unflatten(treedef, grads), AdamWState(mu, nu),
                    tree_unflatten(treedef, [p.detach() for p in local]),
                    step, clip_scale(gnorm, grad_clip) if grad_clip else None)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        metrics["lr"] = sched(step)
        return new_params, opt.mu, opt.nu, step + 1, metrics

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        batch = batch_to_device(batch, device)
        to_local = lambda t: tree_map(  # noqa: E731
            lambda x: x.to_local(), t)
        params, mu, nu, step, metrics = local_step(
            to_local(state.params), to_local(state.mu), to_local(state.nu),
            state.step.to_local(), batch)
        new_state = TrainState(
            params=tree_map(place_local, params, state.params),
            mu=tree_map(place_local, mu, state.mu),
            nu=tree_map(place_local, nu, state.nu),
            step=place_local(step, state.step), rng=state.rng)
        return new_state, metrics

    train_step.local_step = local_step
    return init_state, train_step
