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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_tokens, embedding_spec,
                                       empty_stack, lm_logits, mlp_apply,
                                       mlp_spec, norm_spec, rms_norm,
                                       stack_cache_spec, unembed_spec,
                                       write_layer)
from repro_torch.models.params import stack_spec
from repro_torch.models.transformer import (_clone, _layer, ce_loss,
                                            padded_vocab, rope_tables_for)


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


def encode(cfg, params, enc_embeds):
    """Bidirectional encoder over the frame embeddings -> [B, S_enc, d]."""
    x = enc_embeds.to(getattr(torch, cfg.dtype))
    rope = rope_tables_for(cfg, x.shape[1], x.device)
    for i in range(cfg.num_layers):
        lyr = _layer(params["enc_layers"], i)
        h = rms_norm(x, lyr["ln1"], cfg.norm_eps)
        x = x + attn.self_attention(cfg, lyr["attn"], h, causal=False,
                                    rope=rope)
        h = rms_norm(x, lyr["ln2"], cfg.norm_eps)
        x = x + mlp_apply(cfg, lyr["mlp"], h)
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


def dec_block(cfg, p, x, enc_out, rope=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.self_attention(cfg, p["self_attn"], h, causal=True,
                                rope=rope)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + attn.cross_attention(cfg, p["cross_attn"], h, enc_out)
    h = rms_norm(x, p["ln3"], cfg.norm_eps)
    return x + mlp_apply(cfg, p["mlp"], h)


def encdec_loss(cfg, params, batch):
    """Next-token loss of the decoder. batch: enc_embeds [B, S_enc, d],
    dec_tokens [B, S_dec]."""
    enc_out = encode(cfg, params, batch["enc_embeds"])
    tokens = batch["dec_tokens"]
    x = embed_tokens(cfg, params["embed"]["table"], tokens,
                     getattr(torch, cfg.dtype))
    rope = rope_tables_for(cfg, x.shape[1], x.device)
    for i in range(cfg.num_decoder_layers):
        x = dec_block(cfg, _layer(params["dec_layers"], i), x, enc_out, rope)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    loss, metrics = ce_loss(cfg, params, x[:, :-1], tokens[:, 1:])
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


def encdec_prefill(cfg, params, batch, max_len: int):
    """Encode the source once; consume the decoder prompt. Returns (caches,
    the last position's logits [B, vocab_size])."""
    dtype = getattr(torch, cfg.dtype)
    enc_out = encode(cfg, params, batch["enc_embeds"])
    x = embed_tokens(cfg, params["embed"]["table"], batch["dec_tokens"],
                     dtype)
    B, S = x.shape[:2]
    rope = rope_tables_for(cfg, S, x.device)
    L = cfg.num_decoder_layers
    self_c = empty_stack(attn.init_cache_spec(cfg, B, max_len, dtype), L,
                         x.device)
    cross_k, cross_v = [], []
    for i in range(L):
        lyr = _layer(params["dec_layers"], i)
        h = rms_norm(x, lyr["ln1"], cfg.norm_eps)
        write_layer(self_c, i, attn.prefill_cache(cfg, lyr["self_attn"], h,
                                                  max_len, dtype, rope))
        x = x + attn.self_attention(cfg, lyr["self_attn"], h, causal=True,
                                    rope=rope)
        h = rms_norm(x, lyr["ln2"], cfg.norm_eps)
        x = x + attn.cross_attention(cfg, lyr["cross_attn"], h, enc_out)
        cross_k.append(torch.einsum("bsd,dnh->bsnh", enc_out,
                                    lyr["cross_attn"]["wk"].to(dtype)))
        cross_v.append(torch.einsum("bsd,dnh->bsnh", enc_out,
                                    lyr["cross_attn"]["wv"].to(dtype)))
        h = rms_norm(x, lyr["ln3"], cfg.norm_eps)
        x = x + mlp_apply(cfg, lyr["mlp"], h)
    x = rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    logits = lm_logits(cfg, params, x, padded_vocab(cfg))
    caches = {"self": self_c, "cross_k": torch.stack(cross_k),
              "cross_v": torch.stack(cross_v)}
    return caches, logits[:, 0, :cfg.vocab_size]


def _cross_decode(cfg, p, x, ck, cv):
    """Single-query cross attention against the static encoder K/V."""
    scale = 1.0 / np.sqrt(cfg.resolved_head_dim())
    q = attn._project_q(cfg, p, x)                       # [B,1,KV,G,hd]
    s = torch.einsum("bqngh,bknh->bngqk", q.float(), ck.float()) * scale
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bngqk,bknh->bqngh", w, cv.float()).to(x.dtype)
    return attn._out_proj(cfg, p, o)


def encdec_decode(cfg, params, caches, tokens, pos: int):
    """One decoder step. Returns (logits [B, vocab_size], new caches): the
    self-attention caches are copied and written, the cross K/V passed on
    as they are."""
    x = embed_tokens(cfg, params["embed"]["table"], tokens,
                     getattr(torch, cfg.dtype))
    self_c = _clone(caches["self"])
    rope = rope_tables_for(cfg, 1, x.device, start=pos)
    for i in range(cfg.num_decoder_layers):
        lyr = _layer(params["dec_layers"], i)
        h = rms_norm(x, lyr["ln1"], cfg.norm_eps)
        out, _ = attn.decode_attention(cfg, lyr["self_attn"], h,
                                       _layer(self_c, i), pos, rope)
        x = x + out
        h = rms_norm(x, lyr["ln2"], cfg.norm_eps)
        x = x + _cross_decode(cfg, lyr["cross_attn"], h,
                              caches["cross_k"][i], caches["cross_v"][i])
        h = rms_norm(x, lyr["ln3"], cfg.norm_eps)
        x = x + mlp_apply(cfg, lyr["mlp"], h)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = lm_logits(cfg, params, x, padded_vocab(cfg))
    return logits[:, 0, :cfg.vocab_size], {
        "self": self_c, "cross_k": caches["cross_k"],
        "cross_v": caches["cross_v"]}
