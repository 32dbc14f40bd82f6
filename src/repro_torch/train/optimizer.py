"""AdamW on pytrees of tensors, functional: every update returns NEW
tensors and never writes one in place, so checkpoint handles and logged
values taken from an earlier state keep its bytes (checkpoint/delta.py).

Moments are stored in ``moment_dtype`` (fp32 default) but all arithmetic is
fp32, as in the reference package.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.utils.pytree import (tree_flatten, tree_leaves, tree_map,
                                      tree_unflatten)


class AdamWState(NamedTuple):
    mu: object
    nu: object


def adamw(schedule: Callable, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          moment_dtype="float32"):
    mdt = getattr(torch, moment_dtype)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
        return AdamWState(mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params, step):
        """Returns (new_params, new_state). step is the 0-based int32 step
        tensor."""
        t = step.to(torch.float32) + 1.0
        lr = schedule(step)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)

        def upd(g, m, v, p):
            # f32 temporaries are dropped as soon as they are spent: for a
            # 0.93 B-element leaf each one is 3.7 GB on the card
            g32 = g.float()
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * g32.square()
            del g32
            step_ = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
            m_new, v_new = m32.to(mdt), v32.to(mdt)
            del m32, v32
            p32 = p.float()
            if weight_decay and p.ndim >= 2:   # decay matrices only
                step_ = step_ + weight_decay * p32
            return (p32 - lr * step_).to(p.dtype), m_new, v_new

        g_leaves, treedef = tree_flatten(grads)
        out = [upd(g, m, v, p) for g, m, v, p in zip(
            g_leaves, tree_leaves(state.mu), tree_leaves(state.nu),
            tree_leaves(params))]
        pick = lambda i: tree_unflatten(treedef, [o[i] for o in out])
        return pick(0), AdamWState(mu=pick(1), nu=pick(2))

    return init, update


@torch.no_grad()
def global_norm(tree):
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tree_leaves(tree)]).sum())


@torch.no_grad()
def clip_by_global_norm(grads, max_norm):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn
