"""DeepSeek-V3 Multi-head Latent Attention, training path.

The latent down-projections and their norms, then the expanded form: the
latent is projected up to per-head keys and values, and the generic
chunked online softmax of ``models/attention.py`` runs over heads of width
``qk_nope_head_dim + qk_rope_head_dim`` (128 + 64 = 192 at full width), one
head per KV group. The rope key ``k_r`` is shared by every head; values
(128 wide) are zero-padded to the q/k width and sliced after, as in the
reference.

Decode uses the ABSORBED form: the cache holds only the compressed latent
``c_kv`` [B, max_len, kv_lora_rank] and the shared rope key ``k_r`` [B,
max_len, qk_rope_head_dim] (512 + 64 wide at full width, against 2 x 128
heads x 192 for expanded K/V), indexed by position (no ring). W_uk is
folded into the query, the scores run over the latent plus the rope key,
and W_uv is applied to the attended latent.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.attention import NEG_INF, _chunked_sdpa, _mask
from repro_torch.models.layers import (apply_rope, cache_from_spec,
                                       dense_spec, rms_norm)
from repro_torch.models.params import ParamSpec
from repro_torch.parallel.sharding import constrain


def mla_spec(cfg):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    hax = "heads" if cfg.dense_layout == "tp" else None
    return {
        "w_dq": dense_spec((d, m.q_lora_rank), ("embed", None)),
        "q_ln": ParamSpec((m.q_lora_rank,), (None,), init="ones"),
        "w_uq": dense_spec((m.q_lora_rank, H, qk_hd), (None, hax, None),
                           fan_in=m.q_lora_rank),
        "w_dkv": dense_spec((d, m.kv_lora_rank), ("embed", None)),
        "kv_ln": ParamSpec((m.kv_lora_rank,), (None,), init="ones"),
        "w_kr": dense_spec((d, m.qk_rope_head_dim), ("embed", None)),
        "w_uk": dense_spec((m.kv_lora_rank, H, m.qk_nope_head_dim),
                           (None, hax, None), fan_in=m.kv_lora_rank),
        "w_uv": dense_spec((m.kv_lora_rank, H, m.v_head_dim),
                           (None, hax, None), fan_in=m.kv_lora_rank),
        "wo": dense_spec((H, m.v_head_dim, d), (hax, None, "embed"),
                         fan_in=H * m.v_head_dim),
    }


def _latents(cfg, p, x, rope):
    """Shared q / kv latent computation. Returns (q_nope, q_rope, c_kv,
    k_r); ``rope`` holds (cos, sin) tables of width qk_rope_head_dim."""
    m = cfg.mla
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dq"].to(x.dtype)),
                  p["q_ln"], cfg.norm_eps)
    q = torch.einsum("bsr,rnh->bsnh", cq, p["w_uq"].to(x.dtype))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], rope)
    c_kv = rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dkv"].to(x.dtype)),
                    p["kv_ln"], cfg.norm_eps)
    k_r = apply_rope(torch.einsum("bsd,dr->bsr", x, p["w_kr"].to(x.dtype)),
                     rope)
    return q_nope, q_rope, c_kv, k_r


def mla_attention(cfg, p, x, rope, return_latents=False):
    """Training forward: expanded form + chunked softmax, causal.
    ``return_latents`` also returns (c_kv, k_r), which a prefill lays into
    its cache."""
    m = cfg.mla
    H = cfg.num_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    scale = 1.0 / np.sqrt(qk_hd)
    q_nope, q_rope, c_kv, k_r = _latents(cfg, p, x, rope)
    k_nope = torch.einsum("bsr,rnh->bsnh", c_kv, p["w_uk"].to(x.dtype))
    v = torch.einsum("bsr,rnh->bsnh", c_kv, p["w_uv"].to(x.dtype))
    B, S = x.shape[:2]
    # heads as the KV axis (G = 1), so the generic online softmax serves
    q_eff = torch.cat([q_nope, q_rope], dim=-1).reshape(B, S, H, 1, qk_hd)
    k_eff = torch.cat([k_nope, k_r[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    v_pad = F.pad(v, (0, qk_hd - m.v_head_dim))
    # the reference's constraints: under a mesh they raise (next slice)
    q_eff = constrain(q_eff, ("batch", None, "act_heads", None, None))
    k_eff = constrain(k_eff, ("batch", None, "act_heads", None))
    o = _chunked_sdpa(q_eff, k_eff, v_pad, True, None, scale,
                      cfg.attention_chunk,
                      probs_dtype=getattr(torch, cfg.attention_probs_dtype),
                      remat_chunk=cfg.attention_remat_chunk)
    o = o.reshape(B, S, H, qk_hd)[..., :m.v_head_dim]
    out = torch.einsum("bsnh,nhd->bsd", o, p["wo"].to(x.dtype))
    return (out, (c_kv, k_r)) if return_latents else out


# ------------------------------------------------------------- decode -----

def mla_cache_spec(cfg, batch: int, max_len: int, dtype):
    m = cfg.mla
    return {
        "c_kv": (torch.Size((batch, max_len, m.kv_lora_rank)), dtype),
        "k_r": (torch.Size((batch, max_len, m.qk_rope_head_dim)), dtype),
        "slot_pos": (torch.Size((max_len,)), torch.int32),
    }


def mla_cache_axes():
    """Logical axes of one layer's latent cache leaves."""
    return {"c_kv": ("batch", "cache_seq", None),
            "k_r": ("batch", "cache_seq", None),
            "slot_pos": (None,)}


def mla_init_cache(cfg, batch: int, max_len: int, dtype, device):
    return cache_from_spec(mla_cache_spec(cfg, batch, max_len, dtype),
                           device)


def mla_decode(cfg, p, x, cache, pos: int, rope):
    """Absorbed-form one-token decode against the latent cache: writes the
    token's latent and rope key at row ``pos`` of ``cache`` in place;
    ``rope`` is the position's (cos, sin) row. Returns (out [B,1,d],
    cache)."""
    m = cfg.mla
    scale = 1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope, c_kv_new, k_r_new = _latents(cfg, p, x, rope)
    ckv, kr, slot_pos = cache["c_kv"], cache["k_r"], cache["slot_pos"]
    ckv[:, pos] = c_kv_new[:, 0].to(ckv.dtype)
    kr[:, pos] = k_r_new[:, 0].to(kr.dtype)
    slot_pos[pos] = pos
    # absorb W_uk into q: q_abs [B,1,H,r_kv]
    q_abs = torch.einsum("bqnh,rnh->bqnr", q_nope, p["w_uk"].to(x.dtype))
    s = (torch.einsum("bqnr,bkr->bnqk", q_abs.float(), ckv.float())
         + torch.einsum("bqnh,bkh->bnqk", q_rope.float(), kr.float())) \
        * scale
    keep = _mask(torch.full((1,), pos, dtype=torch.int32, device=x.device),
                 slot_pos, True, None)
    w = torch.softmax(s.masked_fill(~keep, NEG_INF), dim=-1)
    ctx = torch.einsum("bnqk,bkr->bqnr", w, ckv.float())
    o = torch.einsum("bqnr,rnh->bqnh", ctx.to(x.dtype),
                     p["w_uv"].to(x.dtype))
    out = torch.einsum("bqnh,nhd->bqd", o, p["wo"].to(x.dtype))
    return out, cache


def mla_prefill_cache(c_kv, k_r, max_len: int, dtype):
    """The prompt's latents and rope keys (as ``mla_attention(...,
    return_latents=True)`` gave them) in rows 0..S-1 of a fresh cache."""
    S = c_kv.shape[1]
    pad = max_len - S
    return {
        "c_kv": F.pad(c_kv, (0, 0, 0, pad)).to(dtype),
        "k_r": F.pad(k_r, (0, 0, 0, pad)).to(dtype),
        "slot_pos": torch.cat([
            torch.arange(S, dtype=torch.int32, device=c_kv.device),
            torch.full((pad,), -1, dtype=torch.int32, device=c_kv.device)]),
    }
