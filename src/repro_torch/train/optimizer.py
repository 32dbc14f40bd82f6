"""AdamW on pytrees of tensors, functional: every update returns NEW
tensors and never writes one in place, so checkpoint handles and logged
values taken from an earlier state keep its bytes (checkpoint/delta.py).

Moments are stored in ``moment_dtype`` (fp32 default) but all arithmetic is
fp32, as in the reference package. The update is elementwise, so the
sharded step runs it on local shards; only the global norm needs the mesh
(``sharded_global_norm``).

The clip is folded into the update: ``update`` takes the clip ``scale`` and
scales each gradient as it reads it, so no clipped copy of the gradients is
written. Real CUDA leaves run the norm and the update as the multi-tensor
kernels of ``kernels/adamw.py`` (``norm_and_scale``, ``update``; the route
is ``kernels/adamw.routed``), which give the bits of ``plain_update`` for
the same scale and raise on a CUDA leaf they cannot take; the CPU's
tensors and the dry run's fake ones run ``plain_update``, the per-leaf
chain of torch operations. ``route_elems`` counts the elements each route
updated.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import adamw as fused
from repro_torch.utils.pytree import (tree_flatten, tree_leaves, tree_map,
                                      tree_unflatten)

# elements updated so far in this process, by route (counted per update)
route_elems = {"fused": 0, "plain": 0}


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
    def update(grads, state: AdamWState, params, step, scale=None):
        """Returns (new_params, new_state). step is the 0-based int32 step
        tensor; ``scale`` (a scalar tensor, or None) the clip scale each
        gradient is multiplied by first."""
        g_leaves, treedef = tree_flatten(grads)
        m_leaves, v_leaves = tree_leaves(state.mu), tree_leaves(state.nu)
        p_leaves = tree_leaves(params)
        route = "fused" if fused.routed(
            [*g_leaves, *p_leaves, *m_leaves, *v_leaves]) else "plain"
        new_p, new_m, new_v = (fused.update if route == "fused"
                               else plain_update)(
            g_leaves, p_leaves, m_leaves, v_leaves,
            [bool(weight_decay) and p.ndim >= 2 for p in p_leaves], scale,
            *step_scalars(schedule, step, b1, b2), b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay, moment_dtype=mdt)
        route_elems[route] += sum(p.numel() for p in p_leaves)
        pick = lambda leaves: tree_unflatten(treedef, leaves)
        return pick(new_p), AdamWState(mu=pick(new_m), nu=pick(new_v))

    return init, update


def step_scalars(schedule: Callable, step, b1, b2):
    """(lr, c1, c2) of the 0-based ``step``: the learning rate and the two
    moments' bias corrections."""
    t = step.to(torch.float32) + 1.0
    return schedule(step), 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)


@torch.no_grad()
def plain_update(grads, params, mu, nu, decay, scale, lr, c1, c2, *, b1, b2,
                 eps, weight_decay, moment_dtype):
    """(params', mu', nu') as lists: AdamW leaf by leaf in torch operations,
    with the arguments and results of ``kernels/adamw.update``, whose
    reference it is on the card."""
    out = [_leaf_update(g, p, m, v, d, scale, lr, c1, c2, b1, b2, eps,
                        weight_decay, moment_dtype)
           for g, p, m, v, d in zip(grads, params, mu, nu, decay)]
    return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]


def _leaf_update(g, p, m, v, decay, scale, lr, c1, c2, b1, b2, eps,
                 weight_decay, mdt):
    # f32 temporaries are dropped as soon as they are spent: for a
    # 0.93 B-element leaf each one is 3.7 GB on the card
    if scale is not None:
        g = (g.float() * scale).to(g.dtype)
    g32 = g.float()
    m32 = b1 * m.float() + (1 - b1) * g32
    v32 = b2 * v.float() + (1 - b2) * g32.square()
    del g32
    step_ = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
    m_new, v_new = m32.to(mdt), v32.to(mdt)
    del m32, v32
    p32 = p.float()
    if decay:                               # decay matrices only
        step_ = step_ + weight_decay * p32
    return (p32 - lr * step_).to(p.dtype), m_new, v_new


@torch.no_grad()
def global_norm(tree):
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tree_leaves(tree)]).sum())


@torch.no_grad()
def sharded_global_norm(grads, specs):
    """The global norm of local gradient shards laid out by ``specs`` (one
    spec per leaf, in ``tree_leaves`` order) on the installed mesh: each
    leaf's local sum of squares is psummed over the axes it is sharded on
    (and not over those it is replicated on), so every element counts
    once. Leaves are summed in groups of equal sharded axes."""
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import spec_axes

    groups: dict = {}
    for g, spec in zip(tree_leaves(grads), specs):
        key = tuple(sorted({a for ax in spec_axes(spec, g.ndim)
                            for a in ax}))
        groups.setdefault(key, []).append(g.float().square().sum())
    total = [col.psum(torch.stack(v).sum(), key)
             for key, v in sorted(groups.items())]
    return torch.sqrt(torch.stack(total).sum())


@torch.no_grad()
def clip_scale(gn, max_norm):
    """The factor that brings a global norm ``gn`` to at most
    ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)


@torch.no_grad()
def norm_and_scale(grads, max_norm):
    """(gn, scale): the gradients' global norm and, with a ``max_norm``,
    the clip scale for ``update`` (else None). Real CUDA leaves
    (``kernels/adamw.routed``) run the multi-tensor kernels, which compute
    both on the card in a fixed summation order (the same bits on every
    call); the CPU's and fake leaves ``global_norm`` and ``clip_scale``."""
    leaves = tree_leaves(grads)
    if fused.routed(leaves):
        return fused.norm_and_scale(leaves, max_norm)
    gn = global_norm(grads)
    return gn, clip_scale(gn, max_norm) if max_norm else None
