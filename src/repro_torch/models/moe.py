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
Empty slots and dropped choices read a zero pad row. Apart from that row
the two gathers are inverse permutations of each other, so the backward
of each is a gather through the other's index (``_PadGather``): a row
that nothing read gets a zero gradient by reading the incoming
gradient's pad row, and nothing is summed into the pad row, so a step's
work does not depend on how many slots are empty or choices dropped. No
scatter-add, hence no atomics on the card.

Under a profiler the layer's stages open spans inside the model's
``repro_torch.ffn``: ``repro_torch.moe.route``, ``.dispatch`` (sort,
counts, slot map, gather), ``.experts`` and ``.combine`` (gather, gate
weights, sum over ``k``).

Under a mesh with a "model" axis ``moe_apply`` runs the reference's
expert-parallel branch (its ``shard_map``) on local shards: tokens sharded
over the data axes and replicated over "model"; each "model" rank runs the
experts it holds — E / model of them (``e_offset`` its first) when the
axis divides the expert count, else every expert's slice of ``d_ff`` —
over a capacity computed from its own tokens, and the partial outputs are
psummed over "model". With ``dense_layout="dp"`` the tokens are sharded
over "model" too: all-gathered for dispatch, the outputs reduce-scattered.
The router loss and the drop fraction are averaged over the token axes
other than "model"; the drop fraction is the first "model" rank's (over
its own experts), the value the reference's replicated out_spec reads.
Inside each shard the dispatch stays the permutations above.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import (activation, dense_spec, dot,
                                       is_gated, mlp_apply)
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import (current_mesh, mesh_axis_sizes,
                                           physical_spec, relayout,
                                           spec_axes)
from repro_torch.utils.timing import span


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
    logits = dot("td,de->te", x_flat, router_w.to(x_flat.dtype)).float()
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


class _PadGather(torch.autograd.Function):
    """``cat([x, zeros(1, d)])[idx]``: the rows of ``x`` [R, d] at ``idx``
    [M], where the index R reads a zero row. ``inv`` [R] is the inverse
    map: ``idx[inv[r]] == r`` for every row r that some index reads, and
    ``inv[r] == M`` for a row that none reads. The backward is then the
    same gather of the incoming gradient through ``inv``, each row read
    once: the bits of the indexing backward's sum into a zero buffer (but
    the sign of a zero), without its serial sum of every pad index into
    one discarded row."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return torch.cat([x, x.new_zeros(1, x.shape[1])])[idx]

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return torch.cat([g, g.new_zeros(1, g.shape[1])])[inv], None, None


def capacity(cfg, tokens: int) -> int:
    mo = cfg.moe
    return max(int(np.ceil(mo.top_k * tokens / mo.num_experts
                           * mo.capacity_factor)), 4)


def moe_local(cfg, p, x_flat, cap: int, e_offset: int = 0,
              e_local: int = None):
    """Dispatch / experts / combine over the experts [e_offset, e_offset +
    e_local) that ``p["experts"]`` holds (all of the layer's by default).
    Returns (out [T,d] — the sum over the local experts only, aux,
    dropped fraction of the choices routed to them)."""
    mo = cfg.moe
    T, d = x_flat.shape
    k = mo.top_k
    El = mo.num_experts if e_local is None else e_local
    n = T * k
    with span("repro_torch.moe.route"):
        w, ids, aux = route(cfg, p["router"], x_flat)
    dev = x_flat.device

    with span("repro_torch.moe.dispatch"):
        # choice i is token i // k's; choices routed elsewhere sort last
        # under the sentinel El (the reference's sort key)
        local = ids.reshape(-1) - e_offset
        mine = (local >= 0) & (local < El)
        key = torch.where(mine, local, El)
        order = torch.sort(key, stable=True).indices  # sorted place -> choice
        place = torch.empty_like(order).scatter_(
            0, order, torch.arange(n, device=dev))  # choice -> sorted place
        # choices per expert, counted into a fixed [El + 1] buffer
        # (bincount's length depends on the ids' values, which a fake-tensor
        # trace cannot know); integer adds, so the same counts in any order
        counts = torch.zeros(El + 1, dtype=torch.int64,
                             device=dev).index_add_(0, key,
                                                    torch.ones_like(key))
        start = torch.cumsum(counts, 0) - counts  # an expert's first place
        pos = place - start[key]          # a choice's slot in its expert
        keep = mine & (pos < cap)
        dropped = (mine & ~keep).sum().float() / mine.sum().clamp_min(1)

        # slot (e, c) holds the choice at sorted place start[e] + c while c
        # is below the expert's kept count; other slots read the pad row n.
        # A kept choice i sits in slot[i], so src[slot[i]] == i: each index
        # undoes the other
        c = torch.arange(cap, device=dev)
        filled = c[None, :] < torch.clamp(counts[:El], max=cap)[:, None]
        src = order[torch.clamp(start[:El, None] + c[None, :], max=n - 1)]
        src = torch.where(filled, src, n).reshape(-1)
        slot = torch.where(keep, key * cap + pos, El * cap)
        x_rep = x_flat[:, None, :].expand(T, k, d).reshape(n, d)
        buf = _PadGather.apply(x_rep, src, slot).reshape(El, cap, d)

    with span("repro_torch.moe.experts"):
        out_buf = _expert_ffn(cfg, p["experts"], buf)

    with span("repro_torch.moe.combine"):
        got = _PadGather.apply(out_buf.reshape(El * cap, d), slot, src)
        contrib = (got * w.reshape(-1).to(got.dtype)[:, None]) \
            .reshape(T, k, d)
        out = contrib[:, 0]
        for j in range(1, k):
            out = out + contrib[:, j]
    return out, aux, dropped


def _sharded_moe(cfg, p, x, have, specs):
    """The reference's expert-parallel ``shard_map`` branch, term for term,
    on local shards: ``x`` [B, S, d] laid out by ``have``; returns (y in
    ``x``'s layout, aux, dropped)."""
    mo = cfg.moe
    mesh = current_mesh()
    ms = mesh_axis_sizes(mesh)["model"]
    if spec_axes(have, 3)[1]:          # sequence parallelism: whole rows
        rows = (have[0], None, None)
        y, aux, drop = _sharded_moe(cfg, p, relayout(x, have, rows), rows,
                                    specs)
        return relayout(y, rows, have), aux, drop
    B, S, d = x.shape
    x_have = (spec_axes(have, 1)[0] or None, None)
    nb = 1
    for a in spec_axes(have, 1)[0]:
        nb *= col.axis_size(a)
    dp = cfg.dense_layout == "dp"
    # divisibility-aware token sharding (decode with B*S==1 replicates)
    tok_spec = physical_spec(("batch_dp3" if dp else "batch", None),
                             (B * nb * S, d), mesh)
    tok_axes = spec_axes(tok_spec, 2)[0]
    xl = relayout(x.reshape(B * S, d), x_have, tok_spec)
    t_local = xl.shape[0]
    ep = mo.num_experts % ms == 0
    e_local = mo.num_experts // ms if ep else mo.num_experts
    model_in_tok = dp and "model" in tok_axes
    t_dispatch = t_local * (ms if model_in_tok else 1)
    cap = capacity(cfg, t_dispatch)
    if ep:
        want = {k: ("model", None, None) for k in p["experts"]}
    else:
        want = {k: (None, None, "model") for k in p["experts"]}
        want["wo"] = (None, "model", None)        # wo is [E, f, d]: slice f
    experts = {k: relayout(w, specs["experts"][k], want[k])
               for k, w in p["experts"].items()}
    pl = {"router": p["router"], "experts": experts}
    off = col.axis_index("model") * e_local if ep else 0
    if model_in_tok:
        # dp layout: tokens are sharded over "model" too — gather them for
        # dispatch, reduce-scatter the combined outputs
        xg = col.all_gather(xl, "model", 0)
        out, aux, drop = moe_local(cfg, pl, xg, cap, off, e_local)
        out = col.psum_scatter(out.float(), "model", 0)
    else:
        out, aux, drop = moe_local(cfg, pl, xl, cap, off, e_local)
        out = col.psum(out.float(), "model")
    # metrics differ across token shards: average them. Over "model" the
    # router loss is the same on every rank; the drop fraction is the
    # first rank's, the value a replicated out_spec reads there
    mean_axes = tuple(a for a in tok_axes if a != "model")
    drop = col.psum(drop * (col.axis_index("model") == 0), "model")
    if mean_axes:
        aux = col.pmean(aux, mean_axes)
        drop = col.pmean(drop, mean_axes)
    y = relayout(out.to(x.dtype), tok_spec, x_have)
    return y.reshape(B, S, d), aux, drop


def moe_apply(cfg, p, x, have=None, specs=None):
    """x [B,S,d] -> (y [B,S,d], {"moe_aux", "moe_dropped"}). Under a mesh
    with a "model" axis: the expert-parallel branch on local shards, ``x``
    laid out by ``have``, the weights by their "model" ``specs``."""
    B, S, d = x.shape
    mesh = current_mesh()
    if mesh is not None and "model" in mesh_axis_sizes(mesh):
        y, aux, dropped = _sharded_moe(cfg, p, x, have, specs)
    else:
        y_flat, aux, dropped = moe_local(cfg, p, x.reshape(B * S, d),
                                         capacity(cfg, B * S))
        y = y_flat.reshape(B, S, d)
    if "shared" in p:
        y = y + mlp_apply(cfg, p["shared"], x, have,
                          None if specs is None else specs["shared"])
    return y, {"moe_aux": aux, "moe_dropped": dropped}
