"""Decoder-only LM assembly for the dense, vlm, moe (with MLA or GQA
attention), ssm and hybrid families.

Layers stay STACKED on a leading axis (``params["layers"][name]`` is
[num_layers, ...]), so parameter paths and shapes equal the reference
package's tree; the forward indexes one layer at a time where the reference
``lax.scan``s. The hybrid's ``shared_attn`` is one block applied after each
group of Mamba2 blocks, so its gradient is the sum over its applications,
in the same order every step. The loss is sequence-chunked so [B,S,vocab]
logits never materialize for large-vocab configs.

Serving: ``lm_prefill`` runs a prompt through every layer and lays each
layer's decode cache into a stack preallocated from its spec (one row per
layer, zero-size leaves for a stack of no layers); it returns the last
position's logits only. ``lm_decode`` copies the stacks once and writes
the new token into the copy layer by layer, so the caches it was given are
left as they were.

One walk serves every layout (explicit SPMD): it runs on local shards,
each layer's weights FSDP-gathered over every axis but "model" as it is
used (``use_params``), the blocks of ``attention`` / ``mla`` / ``mamba`` /
``moe`` / ``layers`` on their local tensors with each activation's layout
declared, a vlm's embedding prefix cut to the local rows, the residual's
sequence over "model" with ``seq_shard``; caches are local slices laid out
by the reference's cache axes (``cspecs``), logits come back replicated.
With no mesh installed every spec resolves to replication, each relayout
and collective is the identity, and the same walk runs on whole tensors.

Training checkpoints each block's activations as the reference's
``_remat`` does (``cfg.remat``, ``cfg.remat_policy``): a block is one
``checkpointed`` layer whose backward recomputes it from its input and its
local weight shards, gathering them again; the step's bits are the same
with any setting.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba, mla
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (batch_axis, cache_from_spec,
                                       embed_tokens, gathered_logits_weight,
                                       embedding_spec, lm_logits, mlp_apply,
                                       mlp_spec, norm_spec,
                                       padded_vocab_size, recomputed,
                                       rms_norm, rope_tables, unembed_spec,
                                       write_layer)
from repro_torch.models.params import _map_specs, stack_spec
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import (constrain, constrain_spec,
                                           current_mesh, global_shape,
                                           local_shape, model_spec,
                                           physical_spec, relayout,
                                           spec_axes)
from repro_torch.utils.pytree import tree_flatten, tree_unflatten
from repro_torch.utils.timing import span


def _remat(cfg, fn):
    """The reference's per-layer activation checkpointing of ``fn`` (a
    layer: tensors in, a tuple of tensors out): ``fn`` itself with
    ``remat=False``; else a call whose backward recomputes ``fn`` from its
    saved inputs, keeping, with ``remat_policy="dots"``, the outputs of its
    batch-free matmuls (``layers.dot``). Any other policy, "full" among
    them, saves nothing, as the reference's ``_remat`` has it."""
    if not cfg.remat:
        return fn
    return functools.partial(recomputed, fn,
                             dots=cfg.remat_policy == "dots")


def checkpointed(cfg, fn, p, *xs, **kw):
    """``fn(p, *xs, cfg=cfg, **kw)`` through ``_remat``: the layer's
    parameters ``p`` (a dict of tensors) flattened into the recomputed
    inputs after the tensors ``xs``; ``kw`` (specs, layouts, the RoPE
    tables) is passed as it is and never differentiated."""
    leaves, treedef = tree_flatten(p)
    return _remat(cfg, _unflattened)(*xs, *leaves, layer=fn,
                                     treedef=treedef, nx=len(xs), cfg=cfg,
                                     **kw)


def _unflattened(*inputs, layer, treedef, nx, **kw):
    return layer(tree_unflatten(treedef, inputs[nx:]), *inputs[:nx], **kw)


def padded_vocab(cfg) -> int:
    v = cfg.vocab_size
    return v if v < 512 else padded_vocab_size(v, 512)


# ------------------------------------------------------------- blocks -----

def _attn_spec(cfg):
    return mla.mla_spec(cfg) if cfg.mla else attn.attn_spec(cfg)


def dense_block_spec(cfg):
    return {
        "ln1": norm_spec(cfg.d_model),
        "attn": _attn_spec(cfg),
        "ln2": norm_spec(cfg.d_model),
        "mlp": mlp_spec(cfg, cfg.d_ff),
    }


def moe_block_spec(cfg):
    return {
        "ln1": norm_spec(cfg.d_model),
        "attn": _attn_spec(cfg),
        "ln2": norm_spec(cfg.d_model),
        "moe": moe_mod.moe_spec(cfg),
    }


def _attention(cfg, p, x, window, rope, have=None, specs=None):
    if cfg.mla:
        return mla.mla_attention(cfg, p, x, rope, have=have, specs=specs)
    return attn.self_attention(cfg, p, x, causal=True, window=window,
                               rope=rope, have=have, specs=specs)


def rope_tables_for(cfg, S: int, device, start: int = 0):
    """(cos, sin) tables of positions start .. start+S-1, computed once per
    forward or decode step; None for ssm."""
    if cfg.family == "ssm":
        return None
    dim = cfg.mla.qk_rope_head_dim if cfg.mla else cfg.resolved_head_dim()
    return rope_tables(S, dim, cfg.rope_theta, device, start)


def res_axes(cfg):
    """Residual-stream logical axes (the reference's): with
    ``cfg.seq_shard`` the sequence dim over "model", with
    ``dense_layout="dp"`` the batch over every mesh axis."""
    return (batch_axis(cfg), "seq_mp" if cfg.seq_shard else None, None)


def _ffn(cfg, p, h, have, specs):
    """A block's MLP, or its MoE layer: (y, the MoE metrics or None)."""
    if "moe" in p:
        return moe_mod.moe_apply(cfg, p["moe"], h, have, specs.get("moe"))
    return mlp_apply(cfg, p["mlp"], h, have, specs.get("mlp")), None


def block(cfg, p, x, window=None, rope=None, have=None, specs=None):
    """One attention + MLP (or MoE) block: (x, the MoE metrics or None).
    ``x`` is the local residual laid out by ``have``, ``p`` a layer's
    gathered weights and ``specs`` their "model" specs (both default to
    whole)."""
    have, specs = have or (None, None, None), specs or {}
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    with span("repro_torch.attention"):
        x = x + _attention(cfg, p["attn"], h, window, rope, have,
                           specs.get("attn"))
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    with span("repro_torch.ffn"):
        y, metrics = _ffn(cfg, p, h, have, specs)
    return constrain(x + y, res_axes(cfg), have), metrics


def dense_block(cfg, p, x, window=None, rope=None, have=None, specs=None):
    """One attention + MLP block (``block`` without metrics)."""
    return block(cfg, p, x, window, rope, have, specs)[0]


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# -------------------------------------------------------------- specs -----

def lm_param_spec(cfg):
    pv = padded_vocab(cfg)
    spec = {"embed": embedding_spec(cfg, pv), "ln_f": norm_spec(cfg.d_model)}
    if not cfg.tie_embeddings:
        spec["unembed"] = unembed_spec(cfg, pv)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        spec["layers"] = stack_spec(dense_block_spec(cfg), cfg.num_layers)
    elif fam == "moe":
        nd = cfg.moe.first_dense_layers
        if nd:
            spec["dense_layers"] = stack_spec(dense_block_spec(cfg), nd)
        spec["layers"] = stack_spec(moe_block_spec(cfg), cfg.num_layers - nd)
    elif fam == "ssm":
        spec["layers"] = stack_spec(mamba.mamba1_spec(cfg), cfg.num_layers)
    elif fam == "hybrid":
        g, per, tail = _hybrid_shape(cfg)
        spec["groups"] = stack_spec(stack_spec(mamba.mamba2_spec(cfg), per),
                                    g)
        spec["shared_attn"] = dense_block_spec(cfg)
        if tail:
            spec["tail"] = stack_spec(mamba.mamba2_spec(cfg), tail)
    else:
        raise ValueError(fam)
    return spec


def _hybrid_shape(cfg):
    """(groups, Mamba2 blocks per group, trailing Mamba2 blocks)."""
    g = cfg.num_layers // cfg.attn_period
    return g, cfg.attn_period - 1, cfg.num_layers - g * cfg.attn_period


# ------------------------------------------------------------ forward -----

def _inputs(cfg, params, specs, tokens, tok_have=None, embeds=None,
            emb_have=None):
    """The input sequence on local rows, in the compute dtype: the vlm's
    embedding prefix (if any, laid out by ``emb_have``) followed by the
    embeddings of ``tokens`` (laid out by ``tok_have``; None: whole), the
    residual's layout (``res_axes``) applied. Returns (the local tokens,
    x, its spec)."""
    tokens, ts = constrain_spec(tokens, (batch_axis(cfg), None),
                                have=tok_have or (None, None))
    x, xs = embed_tokens(cfg, params["embed"]["table"], tokens,
                         getattr(torch, cfg.dtype), have=ts,
                         table_spec=specs["embed"]["table"])
    if embeds is not None:
        e = relayout(embeds.to(x.dtype), emb_have or (None, None, None), xs)
        x = torch.cat([e, x], dim=1)
    x, xs = constrain_spec(x, res_axes(cfg), have=xs)
    return tokens, x, xs


def _embed_inputs(cfg, params, tokens, embeds=None):
    """The whole input sequence (no mesh): ``_inputs``' x."""
    return _inputs(cfg, params, {"embed": {"table": ()}}, tokens,
                   embeds=embeds)[1]


# ------------------------------------------------------ the one walk -----

def mesh_param_specs(cfg, mesh=None) -> dict:
    """Each parameter's spec on ``mesh`` (the installed one by default),
    resolved from its logical axes at its global shape — the specs
    ``launch.specs.state_shardings`` lays the state out by; with no mesh,
    replication (``()``) everywhere."""
    mesh = mesh or current_mesh()
    if cfg.family == "audio":
        from repro_torch.models.encdec import encdec_param_spec
        spec = encdec_param_spec(cfg)
    else:
        spec = lm_param_spec(cfg)
    return _map_specs(lambda _, sp: tuple(physical_spec(sp.axes, sp.shape,
                                                        mesh)), spec)


def use_params(tree, specs, i=None):
    """Layer ``i`` of a stacked tree of local parameter shards (the whole
    tree when ``i`` is None), each FSDP-gathered over every axis but
    "model" (all-gather forward, reduce-scatter backward). Returns (the
    gathered tree, its "model" specs)."""
    if isinstance(tree, dict):
        pairs = {k: use_params(tree[k], specs[k], i) for k in tree}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    if i is not None:
        tree, specs = tree[i], specs[1:]
    keep = model_spec(specs)
    return relayout(tree, specs, keep), keep


def sub_stack(tree, specs, j):
    """Entry ``j`` of the leading axis of a stacked tree of local shards
    and its specs, nothing gathered (a hybrid's group of layers)."""
    if isinstance(tree, dict):
        pairs = {k: sub_stack(tree[k], specs[k], j) for k in tree}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    return tree[j], specs[1:]


def _blocks(cfg, params, specs):
    """Every block of the stack in order: (kind — "attn" for a dense / MoE
    block or the hybrid's shared attention, "mamba1" / "mamba2" —, its
    weights as this rank holds them, their specs, the path of its layer in
    the caches). A layer's weights are local shards, which its user
    gathers (``use_params``: inside a recomputed layer, so its backward
    gathers them again, one layer at a time); the hybrid's shared block,
    applied once a group, comes gathered once, with its "model" specs
    (gathering it again is the identity)."""
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        for name in ("dense_layers", "layers"):
            for i in range(_depth(params[name]) if name in params else 0):
                yield ("attn",) + sub_stack(params[name], specs[name], i) \
                    + ((name, i),)
    elif fam == "ssm":
        kind = f"mamba{cfg.ssm.version}"
        for i in range(_depth(params["layers"])):
            yield (kind,) + sub_stack(params["layers"], specs["layers"], i) \
                + (("layers", i),)
    elif fam == "hybrid":
        g, per, tail = _hybrid_shape(cfg)
        shared, ssp = use_params(params["shared_attn"], specs["shared_attn"])
        for j in range(g):
            grp, gsp = sub_stack(params["groups"], specs["groups"], j)
            for i in range(per):
                yield ("mamba2",) + sub_stack(grp, gsp, i) \
                    + (("groups", j, i),)
            yield "attn", shared, ssp, ("shared_attn", j)
        for i in range(tail):
            yield ("mamba2",) + sub_stack(params["tail"], specs["tail"], i) \
                + (("tail", i),)
    else:
        raise ValueError(fam)


def _mamba(kind):
    return {"mamba1": (mamba.mamba1_forward, mamba.mamba1_decode),
            "mamba2": (mamba.mamba2_forward, mamba.mamba2_decode)}[kind]


def _attn_layer(p, x, *, cfg, sp, rope, have):
    """One attention + MLP / MoE block from its weights as ``_blocks``
    gives them: (x,) or, for a MoE block, (x, moe_aux, moe_dropped)."""
    p, sp = use_params(p, sp)
    x, m = block(cfg, p, x, cfg.sliding_window, rope, have, sp)
    return (x,) if m is None else (x, m["moe_aux"], m["moe_dropped"])


def _mamba_layer(p, x, *, cfg, sp, kind, have):
    """One Mamba block and its residual: (x,)."""
    p, sp = use_params(p, sp)
    return (x + _mamba(kind)[0](cfg, p, x, have=have, specs=sp),)


def _forward(cfg, params, specs, x, xs):
    """Every block and the final norm over the local residual ``x`` (laid
    out by ``xs``): returns (hidden, metrics). Each block is one
    ``checkpointed`` layer, as the reference's ``_remat`` wraps each scan
    body (the hybrid's shared block at each of its uses)."""
    # the whole sequence's tables: attention gathers a sharded sequence
    rope = rope_tables_for(cfg, global_shape(x.shape, xs)[1], x.device)
    aux, drop = [], []
    for kind, p, sp, _ in _blocks(cfg, params, specs):
        if kind != "attn":
            x, = checkpointed(cfg, _mamba_layer, p, x, sp=sp, kind=kind,
                              have=xs)
            continue
        x, *m = checkpointed(cfg, _attn_layer, p, x, sp=sp, rope=rope,
                             have=xs)
        if m:
            aux.append(m[0])
            drop.append(m[1].detach())
    # with no MoE layer (depth cut to the leading dense layers) there is
    # no router loss to add; the reference's mean over the empty stack
    # is NaN, and so is its loss (ROADMAP queue 3)
    metrics = {"moe_aux": torch.stack(aux).mean(),
               "moe_dropped": torch.stack(drop).mean()} if aux else {}
    ln_f, _ = use_params(params["ln_f"], specs["ln_f"])
    return rms_norm(x, ln_f, cfg.norm_eps), metrics


def lm_forward(cfg, params, tokens, embeds=None):
    """Returns (final hidden states [B, S_total, d], metrics); under a
    mesh ``params`` are local shards and the hidden states this rank's
    rows of the residual's layout."""
    specs = mesh_param_specs(cfg)
    _, x, xs = _inputs(cfg, params, specs, tokens, embeds=embeds)
    return _forward(cfg, params, specs, x, xs)


# --------------------------------------------------------------- loss -----

def _loss_chunk_size(cfg, S):
    if cfg.loss_chunk:
        return min(cfg.loss_chunk, S)
    if S * padded_vocab(cfg) > 64 * 1024 * 1024:
        return max(1, min(1024, S))
    return S


def _vocab_parallel_lse_gold(logits, y, vax):
    """lse and the gold logit of vocab-sharded ``logits``: the max and the
    sum of exponentials psummed over ``vax`` (the max a stop-gradient
    shift), the gold logit from the one shard that holds the label."""
    m = col.pmax(logits.amax(dim=-1), vax)
    s = col.psum(torch.exp(logits - m[..., None]).sum(dim=-1), vax)
    V = logits.shape[-1]
    local = y - col.axis_index(vax[0]) * V
    mine = (local >= 0) & (local < V)
    gold = logits.gather(-1, local.clamp(0, V - 1)[..., None])[..., 0]
    return m + torch.log(s), col.psum(gold * mine, vax)


def ce_loss(cfg, params, hidden, labels, mask=None, have=None, specs=None):
    """Chunked cross-entropy. hidden [B,T,d] aligned with labels [B,T].
    Returns (mean nll, {"ce", "z_loss"}), all f32. ``hidden`` and
    ``labels`` are local rows laid out by ``have`` (batch), ``params`` the
    local shards laid out by ``specs`` (both default to whole): the
    logits are vocab-parallel where the weight's vocab dim stays sharded
    and the sums are psummed over the batch axes, so the loss is the
    global batch's mean on every rank."""
    with span("repro_torch.head"):
        pv = padded_vocab(cfg)
        B, T, _ = hidden.shape
        have = have or (None, None, None)
        if mask is None:
            mask = torch.ones((B, T), dtype=torch.float32,
                              device=hidden.device)
        C = _loss_chunk_size(cfg, T)
        params, specs = gathered_logits_weight(cfg, params, specs or {}, have)
        tot = hidden.new_zeros((), dtype=torch.float32)
        cnt = hidden.new_zeros((), dtype=torch.float32)
        zsq = hidden.new_zeros((), dtype=torch.float32)
        for s in range(0, T, C):
            y = labels[:, s:s + C].long()
            logits, ls = lm_logits(cfg, params, hidden[:, s:s + C], pv,
                                   have=have, specs=specs)
            logits, vax = logits.float(), spec_axes(ls, 3)[2]
            if vax:
                lse, gold = _vocab_parallel_lse_gold(logits, y, vax)
            else:
                lse = torch.logsumexp(logits, dim=-1)
                gold = logits.gather(-1, y[..., None])[..., 0]
            m_c = mask[:, s:s + C]
            tot = tot + ((lse - gold) * m_c).sum()
            cnt = cnt + m_c.sum()
            zsq = zsq + (lse.square() * m_c).sum()
        bax = spec_axes(have, 3)[0]
        tot, cnt, zsq = (col.psum(t, bax) for t in (tot, cnt, zsq))
        cnt = torch.clamp_min(cnt, 1.0)
        return tot / cnt, {"ce": tot / cnt, "z_loss": zsq / cnt}


def lm_loss(cfg, params, batch, batch_specs=None):
    """Next-token loss for decoder-only families. batch: tokens [B,S] and,
    for vlm, embeds [B,F,d] prefix. Under a mesh every rank passes its
    local parameter shards and the global batch (or, with
    ``batch_specs``, its own shards of it, laid out by those specs); each
    computes on its own rows, and the loss is the global batch's on every
    rank."""
    bs = batch_specs or {}
    embeds = batch.get("embeds")
    specs = mesh_param_specs(cfg)
    tokens, x, xs = _inputs(cfg, params, specs, batch["tokens"],
                            bs.get("tokens"), embeds, bs.get("embeds"))
    hidden, metrics = _forward(cfg, params, specs, x, xs)
    rows = (xs[0], None, None)
    hidden = relayout(hidden, xs, rows)          # the whole sequence
    if embeds is not None:
        F = embeds.shape[1]
        h = hidden[:, F - 1: F + tokens.shape[1] - 1]
        loss, lm = ce_loss(cfg, params, h, tokens, have=rows, specs=specs)
    else:
        loss, lm = ce_loss(cfg, params, hidden[:, :-1], tokens[:, 1:],
                           have=rows, specs=specs)
    metrics.update(lm)
    if cfg.moe is not None and cfg.moe.router_aux_loss \
            and "moe_aux" in metrics:
        loss = loss + cfg.moe.router_aux_loss * metrics["moe_aux"]
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------- prefill / decode ----

def attn_cache_spec(cfg, batch: int, max_len: int, dtype):
    """One attention layer's decode cache: MLA's latent cache or the KV
    cache (a ring under a sliding window)."""
    if cfg.mla:
        return mla.mla_cache_spec(cfg, batch, max_len, dtype)
    return attn.init_cache_spec(cfg, batch, max_len, dtype)


def mamba_cache_spec(cfg, batch: int, dtype):
    if cfg.ssm.version == 1:
        return mamba.mamba1_cache_spec(cfg, batch, dtype)
    return mamba.mamba2_cache_spec(cfg, batch, dtype)


def _depth(tree) -> int:
    """Length of the leading (layer) axis of a stacked tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def local_cache_spec(spec, cspecs):
    """``spec`` (global (torch.Size, dtype) leaves) with each leaf's shape
    cut to one rank's slice of its layout in ``cspecs``."""
    if isinstance(spec, dict):
        return {k: local_cache_spec(spec[k], cspecs[k]) for k in spec}
    shape, dtype = spec
    return torch.Size(local_shape(shape, cspecs)), dtype


def _drop_lead(cspecs, k: int = 1):
    """Per-layer specs of a stacked cache's specs."""
    if isinstance(cspecs, dict):
        return {n: _drop_lead(v, k) for n, v in cspecs.items()}
    return tuple(cspecs)[k:]


def _relayout_tree(tree, have, want):
    if isinstance(tree, dict):
        return {k: _relayout_tree(tree[k], have[k], want[k]) for k in tree}
    return relayout(tree, have, want)


def _cache_at(caches, cspecs, path):
    """The stack holding layer ``path`` of the caches (a view), the
    layer's index in it and the layer's cache specs."""
    stack = caches[path[0]]
    for j in path[1:-1]:
        stack = _layer(stack, j)
    return stack, path[-1], _drop_lead(cspecs[path[0]], len(path) - 1)


def _attn_prefill(cfg, p, sp, x, xs, max_len, dtype, rope, cspec):
    """One attention block AND its cache's local slice."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla:
        out, (c_kv, k_r) = mla.mla_attention(cfg, p["attn"], h, rope,
                                             return_latents=True, have=xs,
                                             specs=sp["attn"])
        cache = mla.mla_prefill_cache(c_kv, k_r, max_len, dtype,
                                      (xs[0], None, None), cspec)
    else:
        out, (k, v, ks) = attn.self_attention(
            cfg, p["attn"], h, causal=True, window=cfg.sliding_window,
            rope=rope, return_kv=True, have=xs, specs=sp["attn"])
        cache = attn.prefill_cache(cfg, k, v, max_len, dtype, ks, cspec)
    x = x + out
    y, _ = _ffn(cfg, p, rms_norm(x, p["ln2"], cfg.norm_eps), xs, sp)
    return x + y, cache


def _replicated_logits(cfg, params, specs, x, xs):
    """Final norm and logits of local rows ``x`` [B, 1, d], all-gathered
    to every rank: [B, vocab_size] (the reference's replicated
    out_sharding)."""
    ln_f, _ = use_params(params["ln_f"], specs["ln_f"])
    x = rms_norm(x, ln_f, cfg.norm_eps)
    logits, ls = lm_logits(cfg, params, x, padded_vocab(cfg), have=xs,
                           specs=specs)
    logits = relayout(logits, ls, (None, None, None))
    return logits[:, 0, :cfg.vocab_size]


def lm_prefill(cfg, params, specs, batch, bspecs, max_len: int, cspecs,
               local_spec):
    """Consume a prompt; return (primed caches, the last position's logits
    [B, vocab_size] on every rank). ``params`` are laid out by ``specs``,
    ``batch`` by ``bspecs`` (None entries: whole); the caches are made as
    this rank's slices (``local_spec``: their local shapes) of the
    layouts ``cspecs`` (the reference's ``cache_shardings``). Caches hold
    ``max_len`` positions (the window, if smaller), in the compute dtype;
    Mamba states in f32."""
    dtype = getattr(torch, cfg.dtype)
    _, x, xs = _inputs(cfg, params, specs, batch["tokens"],
                       bspecs.get("tokens"), batch.get("embeds"),
                       bspecs.get("embeds"))
    rope = rope_tables_for(cfg, global_shape(x.shape, xs)[1], x.device)
    caches = cache_from_spec(local_spec, x.device)
    for kind, p, sp, path in _blocks(cfg, params, specs):
        p, sp = use_params(p, sp)
        stack, i, cspec = _cache_at(caches, cspecs, path)
        if kind == "attn":
            x, c = _attn_prefill(cfg, p, sp, x, xs, max_len, dtype, rope,
                                 cspec)
        else:
            out, (c, chave) = _mamba(kind)[0](cfg, p, x, return_cache=True,
                                             have=xs, specs=sp)
            x, c = x + out, _relayout_tree(c, chave, cspec)
        write_layer(stack, i, c)
    rows = (xs[0], None, None)
    x = relayout(x, xs, rows)[:, -1:]
    return caches, _replicated_logits(cfg, params, specs, x, rows)


def lm_decode(cfg, params, specs, caches, cspecs, tokens, tok_have,
              pos: int):
    """One decode step. tokens [B,1] (laid out by ``tok_have``; None:
    whole); ``pos`` their position; ``caches`` this rank's slices laid out
    by ``cspecs``. Returns (logits [B, vocab_size] on every rank, new
    caches); ``caches`` is not written."""
    _, x, xs = _inputs(cfg, params, specs, tokens, tok_have)
    new = _clone(caches)
    rope = rope_tables_for(cfg, 1, x.device, start=pos)
    for kind, p, sp, path in _blocks(cfg, params, specs):
        p, sp = use_params(p, sp)
        stack, i, cspec = _cache_at(new, cspecs, path)
        cache = _layer(stack, i)
        if kind != "attn":
            out, _ = _mamba(kind)[1](cfg, p, x, cache, have=xs, specs=sp,
                                     cspec=cspec)
            x = x + out
            continue
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        step = mla.mla_decode if cfg.mla else attn.decode_attention
        out, _ = step(cfg, p["attn"], h, cache, pos, rope, have=xs,
                      specs=sp["attn"], cspec=cspec)
        x = x + out
        y, _ = _ffn(cfg, p, rms_norm(x, p["ln2"], cfg.norm_eps), xs, sp)
        x = x + y
    return _replicated_logits(cfg, params, specs, x, xs), new
