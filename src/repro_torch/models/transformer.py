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
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba, mla
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (batch_axis, embed_tokens,
                                       embedding_spec, empty_stack,
                                       lm_logits, mlp_apply, mlp_spec,
                                       norm_spec, padded_vocab_size,
                                       rms_norm, rope_tables,
                                       stack_cache_spec, unembed_spec,
                                       write_layer)
from repro_torch.models.params import _map_specs, stack_spec
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import (constrain, constrain_spec,
                                           current_mesh, model_spec,
                                           physical_spec, relayout,
                                           spec_axes)


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
        return mla.mla_attention(cfg, p, x, rope)
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


def dense_block(cfg, p, x, window=None, rope=None, have=None, specs=None):
    """One attention + MLP block. Under a mesh ``x`` is the local residual
    laid out by ``have``, ``p`` a layer's gathered weights and ``specs``
    their "model" specs."""
    specs = specs or {}
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _attention(cfg, p["attn"], h, window, rope, have,
                       specs.get("attn"))
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp_apply(cfg, p["mlp"], h, have, specs.get("mlp"))
    return constrain(x, res_axes(cfg), have)


def moe_block(cfg, p, x, window=None, rope=None, have=None, specs=None):
    specs = specs or {}
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _attention(cfg, p["attn"], h, window, rope, have,
                       specs.get("attn"))
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y, metrics = moe_mod.moe_apply(cfg, p["moe"], h, have, specs.get("moe"))
    x = x + y
    return constrain(x, res_axes(cfg), have), metrics


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

def _embed_inputs(cfg, params, tokens, embeds):
    """The input sequence in the compute dtype: the vlm's embedding prefix
    (if any) followed by the token embeddings."""
    compute_dtype = getattr(torch, cfg.dtype)
    parts = []
    if embeds is not None:
        parts.append(embeds.to(compute_dtype))
    if tokens is not None:
        parts.append(embed_tokens(cfg, params["embed"]["table"], tokens,
                                  compute_dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


# --------------------------------------------------------- under a mesh --

def mesh_param_specs(cfg, mesh=None) -> dict:
    """Each parameter's spec on ``mesh`` (the installed one by default),
    resolved from its logical axes at its global shape — the specs
    ``launch.specs.state_shardings`` lays the state out by."""
    mesh = mesh or current_mesh()
    return _map_specs(lambda _, sp: tuple(physical_spec(sp.axes, sp.shape,
                                                        mesh)),
                      lm_param_spec(cfg))


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


def check_sharded(cfg, embeds=None):
    """Raise for what runs sharded only in the next slice of the port."""
    if cfg.family not in ("dense", "moe") or cfg.mla or cfg.seq_shard \
            or embeds is not None:
        raise NotImplementedError(
            f"{cfg.name}: sharded compute covers the dense and MoE "
            f"families with GQA attention; MLA, SSM, hybrid, encoder-"
            f"decoder, vision prefixes and sequence parallelism run under "
            f"a mesh in the next slice of the port (ROADMAP queue 1, "
            f"item 3)")


def _sharded_forward(cfg, params, specs, tokens, tok_have):
    """``lm_forward`` on local shards: returns (hidden, metrics, its
    spec)."""
    x, xs = embed_tokens(cfg, params["embed"]["table"], tokens,
                         getattr(torch, cfg.dtype), have=tok_have,
                         table_spec=specs["embed"]["table"])
    x, xs = constrain_spec(x, res_axes(cfg), have=xs)
    rope = rope_tables_for(cfg, x.shape[1], x.device)
    window = cfg.sliding_window
    metrics = {}
    aux, drop = [], []
    for name in ("dense_layers", "layers"):
        if name not in params:
            continue
        moe = cfg.family == "moe" and name == "layers"
        for i in range(_depth(params[name])):
            lyr, lsp = use_params(params[name], specs[name], i)
            if moe:
                x, m = moe_block(cfg, lyr, x, window, rope, xs, lsp)
                aux.append(m["moe_aux"])
                drop.append(m["moe_dropped"])
            else:
                x = dense_block(cfg, lyr, x, window, rope, xs, lsp)
    if aux:
        metrics = {"moe_aux": torch.stack(aux).mean(),
                   "moe_dropped": torch.stack(drop).mean()}
    ln_f, _ = use_params(params["ln_f"], specs["ln_f"])
    return rms_norm(x, ln_f, cfg.norm_eps), metrics, xs


def lm_forward(cfg, params, tokens=None, embeds=None):
    """Returns (final hidden states [B, S_total, d], metrics)."""
    if current_mesh() is not None:
        check_sharded(cfg, embeds)
        tokens, ts = constrain_spec(tokens, (batch_axis(cfg), None),
                                    have=(None, None))
        hidden, metrics, _ = _sharded_forward(
            cfg, params, mesh_param_specs(cfg), tokens, ts)
        return hidden, metrics
    x = _embed_inputs(cfg, params, tokens, embeds)
    x = constrain(x, res_axes(cfg))
    rope = rope_tables_for(cfg, x.shape[1], x.device)
    window = cfg.sliding_window
    fam = cfg.family
    metrics = {}
    if fam == "moe":
        nd = cfg.moe.first_dense_layers
        for i in range(nd):
            x = dense_block(cfg, _layer(params["dense_layers"], i), x,
                            window, rope)
        aux, drop = [], []
        for i in range(cfg.num_layers - nd):
            x, m = moe_block(cfg, _layer(params["layers"], i), x, window,
                             rope)
            aux.append(m["moe_aux"])
            drop.append(m["moe_dropped"])
        # with no MoE layer (depth cut to the leading dense layers) there is
        # no router loss to add; the reference's mean over the empty stack
        # is NaN, and so is its loss (ROADMAP queue 3)
        if aux:
            metrics = {"moe_aux": torch.stack(aux).mean(),
                       "moe_dropped": torch.stack(drop).mean()}
    elif fam == "ssm":
        fwd = mamba.mamba1_forward if cfg.ssm.version == 1 \
            else mamba.mamba2_forward
        for i in range(cfg.num_layers):
            x = x + fwd(cfg, _layer(params["layers"], i), x)
    elif fam == "hybrid":
        g, per, tail = _hybrid_shape(cfg)
        for j in range(g):
            group = _layer(params["groups"], j)
            for i in range(per):
                x = x + mamba.mamba2_forward(cfg, _layer(group, i), x)
            x = dense_block(cfg, params["shared_attn"], x, window, rope)
        for i in range(tail):
            x = x + mamba.mamba2_forward(cfg, _layer(params["tail"], i), x)
    else:
        for i in range(cfg.num_layers):
            x = dense_block(cfg, _layer(params["layers"], i), x, window,
                            rope)
    return rms_norm(x, params["ln_f"], cfg.norm_eps), metrics


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
    Returns (mean nll, {"ce", "z_loss"}), all f32. Under a mesh ``hidden``
    and ``labels`` are local, laid out by ``have`` (batch), ``params`` the
    local shards laid out by ``specs``: the logits are vocab-parallel and
    the sums are psummed over the batch axes, so the loss is the global
    batch's mean on every rank."""
    pv = padded_vocab(cfg)
    B, T, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.float32, device=hidden.device)
    C = _loss_chunk_size(cfg, T)
    tot = hidden.new_zeros((), dtype=torch.float32)
    cnt = hidden.new_zeros((), dtype=torch.float32)
    zsq = hidden.new_zeros((), dtype=torch.float32)
    for s in range(0, T, C):
        y = labels[:, s:s + C].long()
        if have is None:
            logits = lm_logits(cfg, params, hidden[:, s:s + C], pv).float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, y[..., None])[..., 0]
        else:
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
    if have is not None:
        bax = spec_axes(have, 3)[0]
        tot, cnt, zsq = (col.psum(t, bax) for t in (tot, cnt, zsq))
    cnt = torch.clamp_min(cnt, 1.0)
    return tot / cnt, {"ce": tot / cnt, "z_loss": zsq / cnt}


def lm_loss(cfg, params, batch):
    """Next-token loss for decoder-only families. batch: tokens [B,S] and,
    for vlm, embeds [B,F,d] prefix. Under a mesh every rank passes the
    global batch and its local parameter shards; each computes on its own
    rows, and the loss is the global batch's on every rank."""
    tokens = batch["tokens"]
    embeds = batch.get("embeds")
    if current_mesh() is not None:
        check_sharded(cfg, embeds)
        specs = mesh_param_specs(cfg)
        tokens, ts = constrain_spec(tokens, (batch_axis(cfg), None),
                                    have=(None, None))
        hidden, metrics, hs = _sharded_forward(cfg, params, specs, tokens,
                                               ts)
        loss, lm = ce_loss(cfg, params, hidden[:, :-1], tokens[:, 1:],
                           have=hs, specs=specs)
    else:
        hidden, metrics = lm_forward(cfg, params, tokens, embeds)
        if embeds is not None:
            F = embeds.shape[1]
            h = hidden[:, F - 1: F + tokens.shape[1] - 1]
            loss, lm = ce_loss(cfg, params, h, tokens)
        else:
            loss, lm = ce_loss(cfg, params, hidden[:, :-1], tokens[:, 1:])
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


def _attn_prefill(cfg, p, x, max_len, dtype, window, rope):
    """Run one attention block AND emit its primed cache."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla:
        out, (c_kv, k_r) = mla.mla_attention(cfg, p["attn"], h, rope,
                                             return_latents=True)
        cache = mla.mla_prefill_cache(c_kv, k_r, max_len, dtype)
    else:
        out, (k, v) = attn.self_attention(cfg, p["attn"], h, causal=True,
                                          window=window, rope=rope,
                                          return_kv=True)
        cache = attn.prefill_cache(cfg, k, v, max_len, dtype)
    x = x + out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        y, _ = moe_mod.moe_apply(cfg, p["moe"], h)
    else:
        y = mlp_apply(cfg, p["mlp"], h)
    return x + y, cache


def _mamba_prefill(cfg, p, x):
    """Mamba block forward + its cache after the last token."""
    fwd = mamba.mamba1_forward if cfg.ssm.version == 1 \
        else mamba.mamba2_forward
    out, cache = fwd(cfg, p, x, return_cache=True)
    return x + out, cache


def lm_prefill(cfg, params, batch, max_len: int):
    """Consume a prompt; return (primed caches, the last position's logits
    [B, vocab_size]). Caches hold ``max_len`` positions (the window, if
    smaller), in the compute dtype; Mamba states in f32."""
    dtype = getattr(torch, cfg.dtype)
    x = _embed_inputs(cfg, params, batch.get("tokens"), batch.get("embeds"))
    B, S = x.shape[:2]
    dev = x.device
    rope = rope_tables_for(cfg, S, dev)
    window = cfg.sliding_window
    fam = cfg.family
    caches = {}
    if fam in ("dense", "vlm", "moe"):
        spec = attn_cache_spec(cfg, B, max_len, dtype)
        for name in ("dense_layers", "layers"):
            if name not in params:
                continue
            n = _depth(params[name])
            caches[name] = empty_stack(spec, n, dev)
            for i in range(n):
                x, c = _attn_prefill(cfg, _layer(params[name], i), x,
                                     max_len, dtype, window, rope)
                write_layer(caches[name], i, c)
    elif fam == "ssm":
        caches["layers"] = empty_stack(mamba_cache_spec(cfg, B, dtype),
                                       cfg.num_layers, dev)
        for i in range(cfg.num_layers):
            x, c = _mamba_prefill(cfg, _layer(params["layers"], i), x)
            write_layer(caches["layers"], i, c)
    elif fam == "hybrid":
        g, per, tail = _hybrid_shape(cfg)
        mspec = mamba.mamba2_cache_spec(cfg, B, dtype)
        caches["groups"] = empty_stack(stack_cache_spec(mspec, per), g, dev)
        caches["shared_attn"] = empty_stack(
            attn.init_cache_spec(cfg, B, max_len, dtype), g, dev)
        for j in range(g):
            group, gcache = _layer(params["groups"], j), \
                _layer(caches["groups"], j)
            for i in range(per):
                x, c = _mamba_prefill(cfg, _layer(group, i), x)
                write_layer(gcache, i, c)
            x, c = _attn_prefill(cfg, params["shared_attn"], x, max_len,
                                 dtype, window, rope)
            write_layer(caches["shared_attn"], j, c)
        if tail:
            caches["tail"] = empty_stack(mspec, tail, dev)
            for i in range(tail):
                x, c = _mamba_prefill(cfg, _layer(params["tail"], i), x)
                write_layer(caches["tail"], i, c)
    else:
        raise ValueError(fam)
    x = rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    logits = lm_logits(cfg, params, x, padded_vocab(cfg))
    return caches, logits[:, 0, :cfg.vocab_size]


def _attn_decode_block(cfg, p, x, cache, pos, rope):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla:
        out, _ = mla.mla_decode(cfg, p["attn"], h, cache, pos, rope)
    else:
        out, _ = attn.decode_attention(cfg, p["attn"], h, cache, pos, rope)
    x = x + out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        y, _ = moe_mod.moe_apply(cfg, p["moe"], h)
    else:
        y = mlp_apply(cfg, p["mlp"], h)
    return x + y


def _mamba_decode_block(cfg, p, x, cache):
    step = mamba.mamba1_decode if cfg.ssm.version == 1 \
        else mamba.mamba2_decode
    out, _ = step(cfg, p, x, cache)
    return x + out


def lm_decode(cfg, params, caches, tokens, pos: int):
    """One decode step. tokens [B,1]; ``pos`` their position. Returns
    (logits [B, vocab_size], new caches); ``caches`` is not written."""
    x = embed_tokens(cfg, params["embed"]["table"], tokens,
                     getattr(torch, cfg.dtype))
    new = _clone(caches)
    rope = rope_tables_for(cfg, 1, x.device, start=pos)
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        for name in ("dense_layers", "layers"):
            if name not in params:
                continue
            for i in range(_depth(params[name])):
                x = _attn_decode_block(cfg, _layer(params[name], i), x,
                                       _layer(new[name], i), pos, rope)
    elif fam == "ssm":
        for i in range(cfg.num_layers):
            x = _mamba_decode_block(cfg, _layer(params["layers"], i), x,
                                    _layer(new["layers"], i))
    elif fam == "hybrid":
        g, per, tail = _hybrid_shape(cfg)
        for j in range(g):
            group, gcache = _layer(params["groups"], j), \
                _layer(new["groups"], j)
            for i in range(per):
                x = _mamba_decode_block(cfg, _layer(group, i), x,
                                        _layer(gcache, i))
            x = _attn_decode_block(cfg, params["shared_attn"], x,
                                   _layer(new["shared_attn"], j), pos, rope)
        for i in range(tail):
            x = _mamba_decode_block(cfg, _layer(params["tail"], i), x,
                                    _layer(new["tail"], i))
    else:
        raise ValueError(fam)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = lm_logits(cfg, params, x, padded_vocab(cfg))
    return logits[:, 0, :cfg.vocab_size], new
