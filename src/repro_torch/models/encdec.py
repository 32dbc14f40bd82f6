"""Encoder-decoder backbone (SeamlessM4T-class), training path.

The encoder's input is the modality frontend's stub output: precomputed
frame embeddings [B, S_enc, d] (the frontend itself is not modeled, as in
the reference). The decoder is a causal LM with cross-attention to the
encoder's output.

Serving: prefill runs the encoder once and keeps, per decoder layer, a
self-attention cache and the static cross K/V of the encoder's output
(``{"self": {k, v, slot_pos} stacked over the decoder layers, "cross_k",
"cross_v": [L, B, S_enc, KV, hd]}``); a decode step writes the self cache
and reads the cross K/V as they are.

One walk serves every layout, as the decoder-only families' does
(``models/transformer.py``): under a mesh (``parallel.sharding.use_mesh``)
the encoder, the decoder and both attentions run on local shards — batch
rows over the data axes, heads over "model", weights FSDP-gathered layer
by layer — and with no mesh the same code runs on whole tensors. The cross K/V caches are
laid out by ``encdec_cache_axes`` (``("layer", "batch", None, "kv_heads",
None)``): whole over the encoder's sequence, so a decode step's cross
attention needs no combine across ranks; the self-attention cache is the
decoder-only one's (slots over "model"). In training each encoder and
decoder layer is one ``transformer.checkpointed`` layer (``cfg.remat``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (batch_axis, cache_from_spec,
                                       embed_tokens, embedding_spec,
                                       mlp_apply, mlp_spec, norm_spec,
                                       rms_norm, row_parallel,
                                       stack_cache_spec, unembed_spec,
                                       write_layer)
from repro_torch.models.params import stack_spec
from repro_torch.parallel.sharding import (constrain, constrain_spec,
                                           relayout, spec_axes)
from repro_torch.models.transformer import (_clone, _drop_lead, _layer,
                                            _replicated_logits, ce_loss,
                                            checkpointed, mesh_param_specs,
                                            padded_vocab, rope_tables_for,
                                            sub_stack, use_params)


def enc_block_spec(cfg):
    return {
        "ln1": norm_spec(cfg.d_model),
        "attn": attn.attn_spec(cfg),
        "ln2": norm_spec(cfg.d_model),
        "mlp": mlp_spec(cfg, cfg.d_ff),
    }


def dec_block_spec(cfg):
    return {
        "ln1": norm_spec(cfg.d_model),
        "self_attn": attn.attn_spec(cfg),
        "ln2": norm_spec(cfg.d_model),
        "cross_attn": attn.attn_spec(cfg, cross=True),
        "ln3": norm_spec(cfg.d_model),
        "mlp": mlp_spec(cfg, cfg.d_ff),
    }


def encdec_param_spec(cfg):
    pv = padded_vocab(cfg)
    spec = {
        "embed": embedding_spec(cfg, pv),
        "enc_layers": stack_spec(enc_block_spec(cfg), cfg.num_layers),
        "dec_layers": stack_spec(dec_block_spec(cfg), cfg.num_decoder_layers),
        "ln_enc": norm_spec(cfg.d_model),
        "ln_f": norm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = unembed_spec(cfg, pv)
    return spec


def _enc_layer(p, x, *, cfg, sp, rope, have):
    """One encoder block from its local shards: (x,)."""
    p, sp = use_params(p, sp)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.self_attention(cfg, p["attn"], h, causal=False, rope=rope,
                                have=have, specs=sp["attn"])
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return (constrain(x + mlp_apply(cfg, p["mlp"], h, have, sp["mlp"]),
                      ("batch", None, None), have=have),)


def _encode(cfg, params, specs, enc_embeds, have=None):
    """The bidirectional encoder over the frame embeddings (laid out by
    ``have``; None: whole) on local shards, each layer ``checkpointed``:
    returns (encoder output [B, S_enc, d] on local rows, its spec)."""
    x = enc_embeds.to(getattr(torch, cfg.dtype))
    x, xs = constrain_spec(x, ("batch", None, None),
                           have=have or (None, None, None))
    rope = rope_tables_for(cfg, x.shape[1], x.device)
    for i in range(cfg.num_layers):
        lyr, lsp = sub_stack(params["enc_layers"], specs["enc_layers"], i)
        x, = checkpointed(cfg, _enc_layer, lyr, x, sp=lsp, rope=rope,
                          have=xs)
    ln, _ = use_params(params["ln_enc"], specs["ln_enc"])
    return rms_norm(x, ln, cfg.norm_eps), xs


def encode(cfg, params, enc_embeds):
    """Bidirectional encoder over the frame embeddings -> [B, S_enc, d]."""
    return _encode(cfg, params, mesh_param_specs(cfg), enc_embeds)[0]


def _dec_inputs(cfg, params, specs, tokens, have=None):
    tokens, ts = constrain_spec(tokens, (batch_axis(cfg), None),
                                have=have or (None, None))
    x, xs = embed_tokens(cfg, params["embed"]["table"], tokens,
                         getattr(torch, cfg.dtype), have=ts,
                         table_spec=specs["embed"]["table"])
    return tokens, x, xs


def dec_block(cfg, p, x, enc_out, rope=None, have=None, specs=None):
    """One decoder block; ``x`` and ``enc_out`` local rows laid out by
    ``have``, the weights by ``specs`` (both default to whole)."""
    have, specs = have or (None, None, None), specs or {}
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.self_attention(cfg, p["self_attn"], h, causal=True,
                                rope=rope, have=have,
                                specs=specs.get("self_attn"))
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + attn.cross_attention(cfg, p["cross_attn"], h, enc_out, have=have,
                                 specs=specs.get("cross_attn"))
    h = rms_norm(x, p["ln3"], cfg.norm_eps)
    return constrain(x + mlp_apply(cfg, p["mlp"], h, have, specs.get("mlp")),
                     ("batch", None, None), have=have)


def _dec_layer(p, x, enc_out, *, cfg, sp, rope, have):
    """One decoder block from its local shards: (x,). Its cross-attention
    reads ``enc_out`` twice (K and V); through a view of its own the
    layer sums those two cotangents before they reach ``enc_out``, as a
    recomputed layer's backward does, so a step gives the same bits with
    and without ``remat``."""
    p, sp = use_params(p, sp)
    return (dec_block(cfg, p, x, enc_out.view_as(enc_out), rope, have, sp),)


def encdec_loss(cfg, params, batch, batch_specs=None):
    """Next-token loss of the decoder. batch: enc_embeds [B, S_enc, d],
    dec_tokens [B, S_dec]. Under a mesh: local parameter shards and the
    global batch (or its shards laid out by ``batch_specs``)."""
    bs = batch_specs or {}
    specs = mesh_param_specs(cfg)
    enc_out, _ = _encode(cfg, params, specs, batch["enc_embeds"],
                         bs.get("enc_embeds"))
    tokens, x, xs = _dec_inputs(cfg, params, specs, batch["dec_tokens"],
                                bs.get("dec_tokens"))
    rope = rope_tables_for(cfg, x.shape[1], x.device)
    for i in range(cfg.num_decoder_layers):
        lyr, lsp = sub_stack(params["dec_layers"], specs["dec_layers"], i)
        x, = checkpointed(cfg, _dec_layer, lyr, x, enc_out, sp=lsp,
                          rope=rope, have=xs)
    ln_f, _ = use_params(params["ln_f"], specs["ln_f"])
    x = rms_norm(x, ln_f, cfg.norm_eps)
    loss, metrics = ce_loss(cfg, params, x[:, :-1], tokens[:, 1:], have=xs,
                            specs=specs)
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------- prefill / decode ----

def encdec_cache_spec(cfg, batch: int, max_len: int, enc_len: int, dtype):
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim()
    L = cfg.num_decoder_layers
    cross = (torch.Size((L, batch, enc_len, KV, hd)), dtype)
    return {"self": stack_cache_spec(
                attn.init_cache_spec(cfg, batch, max_len, dtype), L),
            "cross_k": cross, "cross_v": cross}


def encdec_cache_axes(cfg):
    """Logical axes of the decoder caches: self-attention K/V per layer and
    the encoder's cross K/V."""
    ax = {k: ("layer",) + v for k, v in attn.cache_logical_axes().items()}
    return {
        "self": ax,
        "cross_k": ("layer", "batch", None, "kv_heads", None),
        "cross_v": ("layer", "batch", None, "kv_heads", None),
    }


def encdec_prefill(cfg, params, specs, batch, bspecs, max_len: int, cspecs,
                   local_spec):
    """Encode the source once; consume the decoder prompt. Returns (this
    rank's cache slices, laid out by ``cspecs``, and the last position's
    logits [B, vocab_size] on every rank); the layouts as
    ``transformer.lm_prefill``'s."""
    dtype = getattr(torch, cfg.dtype)
    enc_out, es = _encode(cfg, params, specs, batch["enc_embeds"],
                          bspecs.get("enc_embeds"))
    _, x, xs = _dec_inputs(cfg, params, specs, batch["dec_tokens"],
                           bspecs.get("dec_tokens"))
    rope = rope_tables_for(cfg, x.shape[1], x.device)
    caches = cache_from_spec(local_spec, x.device)
    one = _drop_lead(cspecs["self"])
    cross = tuple(cspecs["cross_k"])[1:]
    for i in range(cfg.num_decoder_layers):
        lyr, lsp = use_params(params["dec_layers"], specs["dec_layers"], i)
        h = rms_norm(x, lyr["ln1"], cfg.norm_eps)
        out, (k, v, ks) = attn.self_attention(
            cfg, lyr["self_attn"], h, causal=True, rope=rope, return_kv=True,
            have=xs, specs=lsp["self_attn"])
        write_layer(caches["self"], i, attn.prefill_cache(
            cfg, k, v, max_len, dtype, ks, one))
        x = x + out
        h = rms_norm(x, lyr["ln2"], cfg.norm_eps)
        x = x + attn.cross_attention(cfg, lyr["cross_attn"], h, enc_out,
                                     have=xs, specs=lsp["cross_attn"])
        kax = spec_axes(lsp["cross_attn"]["wk"], 3)[1]
        made = (es[0], None, kax or None, None)
        for name, w in (("cross_k", "wk"), ("cross_v", "wv")):
            t = torch.einsum("bsd,dnh->bsnh", enc_out,
                             lyr["cross_attn"][w].to(dtype))
            caches[name][i].copy_(relayout(t, made, cross))
        h = rms_norm(x, lyr["ln3"], cfg.norm_eps)
        x = x + mlp_apply(cfg, lyr["mlp"], h, xs, lsp["mlp"])
    return caches, _replicated_logits(cfg, params, specs, x[:, -1:], xs)


def _cross_decode(cfg, p, sp, x, xs, ck, cv, cspec):
    """One query against this rank's static cross K/V (its rows and KV
    heads, the whole encoder sequence): q made on the local heads and
    all-gathered, the output gathered over the cache's heads and
    projected row-parallel by ``wo``'s heads."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G, hd = H // KV, cfg.resolved_head_dim()
    cb, _, ckx, _ = spec_axes(cspec, 4)
    rows = (cb or None, None, None)
    xb = xs[0]
    x = relayout(x, xs, rows)
    B = x.shape[0]
    hax = spec_axes(sp.get("wq"), 3)[1]
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(x.dtype))
    q = relayout(q, (cb or None, None, hax or None, None),
                 (cb or None, None, None, None)).reshape(B, 1, KV, G, hd)
    kv_loc = ck.shape[2]
    k0 = attn.linear_index(ckx) * kv_loc
    q = q[:, :, k0:k0 + kv_loc]
    scale = 1.0 / np.sqrt(hd)
    s = torch.einsum("bqngh,bknh->bngqk", q.float(), ck.float()) * scale
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bngqk,bknh->bqngh", w, cv.float()).to(x.dtype)
    o = relayout(o, (cb or None, None, ckx or None, None, None),
                 (cb or None, None, None, None, None)).reshape(B, 1, H, hd)
    wo_h = spec_axes(sp.get("wo"), 3)[0]
    o = relayout(o, (cb or None, None, None, None),
                 (cb or None, None, wo_h or None, None))
    out = row_parallel("bsnh,nhd->bsd", o, p["wo"], wo_h, x.dtype)
    return relayout(out, rows, (xb, None, None))


def encdec_decode(cfg, params, specs, caches, cspecs, tokens, tok_have,
                  pos: int):
    """One decoder step on local shards (the layouts as
    ``transformer.lm_decode``'s). Returns (logits [B, vocab_size] on every
    rank, new caches): the self-attention caches are copied and written,
    the cross K/V passed on as they are."""
    _, x, xs = _dec_inputs(cfg, params, specs, tokens, tok_have)
    self_c = _clone(caches["self"])
    rope = rope_tables_for(cfg, 1, x.device, start=pos)
    one = _drop_lead(cspecs["self"])
    cross = tuple(cspecs["cross_k"])[1:]
    for i in range(cfg.num_decoder_layers):
        lyr, lsp = use_params(params["dec_layers"], specs["dec_layers"], i)
        h = rms_norm(x, lyr["ln1"], cfg.norm_eps)
        out, _ = attn.decode_attention(cfg, lyr["self_attn"], h,
                                       _layer(self_c, i), pos, rope,
                                       have=xs, specs=lsp["self_attn"],
                                       cspec=one)
        x = x + out
        h = rms_norm(x, lyr["ln2"], cfg.norm_eps)
        x = x + _cross_decode(cfg, lyr["cross_attn"], lsp["cross_attn"], h,
                              xs, caches["cross_k"][i], caches["cross_v"][i],
                              cross)
        h = rms_norm(x, lyr["ln3"], cfg.norm_eps)
        x = x + mlp_apply(cfg, lyr["mlp"], h, xs, lsp["mlp"])
    return _replicated_logits(cfg, params, specs, x, xs), {
        "self": self_c, "cross_k": caches["cross_k"],
        "cross_v": caches["cross_v"]}
