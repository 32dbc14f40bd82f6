"""Mixture-of-Experts: the single-device path of the reference package's
``models/moe.py``.

Top-k routing (softmax or sigmoid router, renormalized weights, the Switch
load-balance loss on each token's first choice), GShard-style capacity
``max(ceil(top_k * T / E * capacity_factor), 4)`` per expert with drops in
the reference's order, the experts' FFNs over an [E, C, d] buffer, and the
shared experts added outside.

Dispatch and combine are permutations, so a step gives the same bits every
time it runs on the card (hindsight replay re-executes steps and must end
on the recorded state): the choices are sorted by expert id with a stable
sort, as the reference's ``argsort``; each token is repeated ``top_k``
times by a reshape, so its gradient is a sum over ``k``; each [E, C] slot
gathers the one choice that fills it; each choice gathers its own slot's
output back; and a token's ``k`` outputs are summed in a fixed order.
Every row that a gather reads is read by at most one destination, except
a zero pad row that stands for empty slots and dropped choices, whose
gradient is discarded. No scatter-add, hence no atomics on the card.

The reference's expert-parallel branch (under a mesh with a "model" axis)
arrives with mesh-sharded record (ROADMAP queue 1, item 5); this package
has no mesh context yet, and ``RecordSpec(mesh=...)`` raises.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import (activation, dense_spec, is_gated,
                                       mlp_apply)


def moe_spec(cfg):
    mo = cfg.moe
    d, E, f = cfg.d_model, mo.num_experts, mo.d_ff_expert
    spec = {
        "router": dense_spec((d, E), ("embed", None)),
        "experts": {
            "wi": dense_spec((E, d, f), ("expert", "embed", "mlp"), fan_in=d),
            "wo": dense_spec((E, f, d), ("expert", "mlp", "embed"), fan_in=f),
        },
    }
    if is_gated(cfg.ffn_activation):
        spec["experts"]["wg"] = dense_spec((E, d, f),
                                           ("expert", "embed", "mlp"),
                                           fan_in=d)
    if mo.num_shared_experts:
        fs = f * mo.num_shared_experts
        spec["shared"] = {
            "wi": dense_spec((d, fs), ("embed", "mlp")),
            "wo": dense_spec((fs, d), ("mlp", "embed"), fan_in=fs),
        }
        if is_gated(cfg.ffn_activation):
            spec["shared"]["wg"] = dense_spec((d, fs), ("embed", "mlp"))
    return spec


def top_k(scores, k: int):
    """(values, ids) of the ``k`` largest entries of each row, ties to the
    lowest index, as ``jax.lax.top_k`` orders them."""
    ids = torch.sort(scores.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    return scores.gather(-1, ids), ids


def route(cfg, router_w, x_flat):
    """Router logits -> (top-k weights [T,k] f32, top-k ids [T,k], aux)."""
    mo = cfg.moe
    logits = torch.einsum("td,de->te", x_flat,
                          router_w.to(x_flat.dtype)).float()
    if mo.router == "sigmoid":
        scores = torch.sigmoid(logits)
        w, ids = top_k(scores, mo.top_k)
        probs = scores / torch.clamp_min(scores.sum(-1, keepdim=True), 1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, ids = top_k(probs, mo.top_k)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    E = logits.shape[-1]
    f_e = F.one_hot(ids[:, 0], E).float().mean(0)
    aux = E * (f_e * probs.mean(0)).sum()
    return w, ids, aux


def _expert_ffn(cfg, pe, buf):
    """buf [E, C, d] through each expert's MLP."""
    act = activation(cfg.ffn_activation)
    h = torch.bmm(buf, pe["wi"].to(buf.dtype))
    if "wg" in pe:
        h = act(torch.bmm(buf, pe["wg"].to(buf.dtype))) * h
    else:
        h = act(h)
    return torch.bmm(h, pe["wo"].to(buf.dtype))


def capacity(cfg, tokens: int) -> int:
    mo = cfg.moe
    return max(int(np.ceil(mo.top_k * tokens / mo.num_experts
                           * mo.capacity_factor)), 4)


def moe_local(cfg, p, x_flat, cap: int):
    """Dispatch / experts / combine over all experts of the layer.
    Returns (out [T,d], aux, dropped fraction)."""
    mo = cfg.moe
    T, d = x_flat.shape
    k, E = mo.top_k, mo.num_experts
    n = T * k
    w, ids, aux = route(cfg, p["router"], x_flat)
    dev = x_flat.device

    ids_f = ids.reshape(-1)                    # choice i is token i // k's
    order = torch.sort(ids_f, stable=True).indices   # sorted place -> choice
    place = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=dev))     # choice -> sorted place
    # choices per expert, counted into a fixed [E] buffer (bincount's
    # length depends on the ids' values, which a fake-tensor trace cannot
    # know); integer adds, so the same counts in any order
    counts = torch.zeros(E, dtype=torch.int64, device=dev).index_add_(
        0, ids_f, torch.ones_like(ids_f))
    start = torch.cumsum(counts, 0) - counts   # an expert's first place
    pos = place - start[ids_f]                 # a choice's slot in its expert
    keep = pos < cap
    dropped = (~keep).sum().float() / max(n, 1)

    # slot (e, c) holds the choice at sorted place start[e] + c while c is
    # below the expert's kept count; other slots read the zero pad row n
    c = torch.arange(cap, device=dev)
    filled = c[None, :] < torch.clamp(counts, max=cap)[:, None]
    src = order[torch.clamp(start[:, None] + c[None, :], max=n - 1)]
    src = torch.where(filled, src, n)
    x_rep = x_flat[:, None, :].expand(T, k, d).reshape(n, d)
    x_pad = torch.cat([x_rep, x_rep.new_zeros(1, d)])
    buf = x_pad[src.reshape(-1)].reshape(E, cap, d)

    out_buf = _expert_ffn(cfg, p["experts"], buf)

    slot = torch.where(keep, ids_f * cap + pos, E * cap)
    out_pad = torch.cat([out_buf.reshape(E * cap, d),
                         out_buf.new_zeros(1, d)])
    contrib = (out_pad[slot] * w.reshape(-1).to(out_pad.dtype)[:, None]) \
        .reshape(T, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out, aux, dropped


def moe_apply(cfg, p, x):
    """x [B,S,d] -> (y [B,S,d], {"moe_aux", "moe_dropped"})."""
    B, S, d = x.shape
    y_flat, aux, dropped = moe_local(cfg, p, x.reshape(B * S, d),
                                     capacity(cfg, B * S))
    y = y_flat.reshape(B, S, d)
    if "shared" in p:
        y = y + mlp_apply(cfg, p["shared"], x)
    return y, {"moe_aux": aux, "moe_dropped": dropped}
