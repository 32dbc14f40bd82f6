"""Decoder-only LM assembly for the dense, vlm and moe families.

Layers stay STACKED on a leading axis (``params["layers"][name]`` is
[num_layers, ...]), so parameter paths and shapes equal the reference
package's tree; the forward indexes one layer at a time where the reference
``lax.scan``s. The loss is sequence-chunked so [B,S,vocab] logits never
materialize for large-vocab configs. MLA attention and the ssm / hybrid
families are later slices (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (embed_tokens, embedding_spec,
                                       lm_logits, mlp_apply, mlp_spec,
                                       norm_spec, padded_vocab_size,
                                       rms_norm, rope_tables, unembed_spec)
from repro_torch.models.params import stack_spec


def padded_vocab(cfg) -> int:
    v = cfg.vocab_size
    return v if v < 512 else padded_vocab_size(v, 512)


def _ported_family(cfg):
    if cfg.family not in ("dense", "vlm", "moe") or cfg.mla is not None:
        what = "MLA attention" if cfg.mla is not None \
            else f"family {cfg.family!r}"
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP queue 1, item 4); this "
            "package runs the dense, vlm and moe families")


# ------------------------------------------------------------- blocks -----

def dense_block_spec(cfg):
    return {
        "ln1": norm_spec(cfg.d_model),
        "attn": attn.attn_spec(cfg),
        "ln2": norm_spec(cfg.d_model),
        "mlp": mlp_spec(cfg, cfg.d_ff),
    }


def moe_block_spec(cfg):
    return {
        "ln1": norm_spec(cfg.d_model),
        "attn": attn.attn_spec(cfg),
        "ln2": norm_spec(cfg.d_model),
        "moe": moe_mod.moe_spec(cfg),
    }


def dense_block(cfg, p, x, window=None, rope=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.self_attention(cfg, p["attn"], h, causal=True,
                                window=window, rope=rope)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(cfg, p["mlp"], h)


def moe_block(cfg, p, x, window=None, rope=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.self_attention(cfg, p["attn"], h, causal=True,
                                window=window, rope=rope)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y, metrics = moe_mod.moe_apply(cfg, p["moe"], h)
    return x + y, metrics


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# -------------------------------------------------------------- specs -----

def lm_param_spec(cfg):
    _ported_family(cfg)
    pv = padded_vocab(cfg)
    spec = {"embed": embedding_spec(cfg, pv), "ln_f": norm_spec(cfg.d_model)}
    if not cfg.tie_embeddings:
        spec["unembed"] = unembed_spec(cfg, pv)
    if cfg.family == "moe":
        nd = cfg.moe.first_dense_layers
        if nd:
            spec["dense_layers"] = stack_spec(dense_block_spec(cfg), nd)
        spec["layers"] = stack_spec(moe_block_spec(cfg), cfg.num_layers - nd)
    else:
        spec["layers"] = stack_spec(dense_block_spec(cfg), cfg.num_layers)
    return spec


# ------------------------------------------------------------ forward -----

def lm_forward(cfg, params, tokens=None, embeds=None):
    """Returns (final hidden states [B, S_total, d], metrics)."""
    _ported_family(cfg)
    compute_dtype = getattr(torch, cfg.dtype)
    parts = []
    if embeds is not None:
        parts.append(embeds.to(compute_dtype))
    if tokens is not None:
        parts.append(embed_tokens(cfg, params["embed"]["table"], tokens,
                                  compute_dtype))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    S = x.shape[1]
    rope = rope_tables(S, cfg.resolved_head_dim(), cfg.rope_theta, x.device)
    window = cfg.sliding_window
    metrics = {}
    if cfg.family == "moe":
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
        metrics = {"moe_aux": torch.stack(aux).mean(),
                   "moe_dropped": torch.stack(drop).mean()}
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


def ce_loss(cfg, params, hidden, labels, mask=None):
    """Chunked cross-entropy. hidden [B,T,d] aligned with labels [B,T].
    Returns (mean nll, {"ce", "z_loss"}), all f32."""
    pv = padded_vocab(cfg)
    B, T, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.float32, device=hidden.device)
    C = _loss_chunk_size(cfg, T)
    tot = hidden.new_zeros((), dtype=torch.float32)
    cnt = hidden.new_zeros((), dtype=torch.float32)
    zsq = hidden.new_zeros((), dtype=torch.float32)
    for s in range(0, T, C):
        logits = lm_logits(cfg, params, hidden[:, s:s + C], pv).float()
        lse = torch.logsumexp(logits, dim=-1)
        y = labels[:, s:s + C].long()
        gold = logits.gather(-1, y[..., None])[..., 0]
        m_c = mask[:, s:s + C]
        tot = tot + ((lse - gold) * m_c).sum()
        cnt = cnt + m_c.sum()
        zsq = zsq + (lse.square() * m_c).sum()
    cnt = torch.clamp_min(cnt, 1.0)
    return tot / cnt, {"ce": tot / cnt, "z_loss": zsq / cnt}


def lm_loss(cfg, params, batch):
    """Next-token loss for decoder-only families. batch: tokens [B,S] and,
    for vlm, embeds [B,F,d] prefix."""
    tokens = batch["tokens"]
    embeds = batch.get("embeds")
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
