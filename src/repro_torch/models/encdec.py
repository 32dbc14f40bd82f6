"""Encoder-decoder backbone (SeamlessM4T-class), training path.

The encoder's input is the modality frontend's stub output: precomputed
frame embeddings [B, S_enc, d] (the frontend itself is not modeled, as in
the reference). The decoder is a causal LM with cross-attention to the
encoder's output. Prefill and decode (a self-attention cache plus static
cross K/V) come with the serving slice (ROADMAP queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_tokens, embedding_spec,
                                       mlp_apply, mlp_spec, norm_spec,
                                       rms_norm, unembed_spec)
from repro_torch.models.params import stack_spec
from repro_torch.models.transformer import (_layer, ce_loss, padded_vocab,
                                            rope_tables_for)


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
