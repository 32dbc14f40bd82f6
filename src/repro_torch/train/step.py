"""train_step factory: loss + ``torch.autograd.grad`` + clip + AdamW.

The step is functional, as in the reference package: it returns a NEW
TrainState and never writes the old one in place, so a checkpoint whose
deferred gather still holds the old tensors reads the submitted bytes.
Entry points run on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import build_model
from repro_torch.train.optimizer import (AdamWState, adamw,
                                         clip_by_global_norm, global_norm)
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.state import TrainState
from repro_torch.utils.pytree import tree_flatten, tree_unflatten


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


def build_train_step(cfg, *, device="cuda", peak_lr=3e-4, warmup=100,
                     total_steps=10000, grad_clip=1.0, weight_decay=0.1):
    """Returns (init_state(seed) -> TrainState, train_step(state, batch) ->
    (state, metrics)), both on ``device`` (default the card). ``batch``
    may hold host numpy arrays; they are moved to the device."""
    device = resolve_device(device)
    model = build_model(cfg)
    sched = warmup_cosine(peak_lr, warmup, total_steps)
    opt_init, opt_update = adamw(sched, weight_decay=weight_decay,
                                 moment_dtype=cfg.moment_dtype)

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
        loss, metrics = model.loss(tree_unflatten(treedef, leaves), batch)
        # a leaf the loss does not read (a zero-length layer stack, as in
        # a MoE config cut to its leading dense layers) has a zero gradient;
        # nothing else keeps the raw gradients, so clipping frees them
        grads = tree_unflatten(treedef, [
            torch.zeros_like(p) if g is None else g for p, g in zip(
                leaves, torch.autograd.grad(loss, leaves, allow_unused=True))])
        if grad_clip:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
        else:
            gnorm = global_norm(grads)
        new_params, opt = opt_update(grads, AdamWState(state.mu, state.nu),
                                     state.params, state.step)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        metrics["lr"] = sched(state.step)
        new_state = TrainState(params=new_params, mu=opt.mu, nu=opt.nu,
                               step=state.step + 1, rng=state.rng)
        return new_state, metrics

    return init_state, train_step
