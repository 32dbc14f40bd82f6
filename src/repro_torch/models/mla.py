"""DeepSeek-V3 Multi-head Latent Attention, training path.

The latent down-projections and their norms, then the expanded form: the
latent is projected up to per-head keys and values, and the generic
chunked online softmax of ``models/attention.py`` runs over heads of width
``qk_nope_head_dim + qk_rope_head_dim`` (128 + 64 = 192 at full width), one
head per KV group. The rope key ``k_r`` is shared by every head; values
(128 wide) are zero-padded to the q/k width and sliced after, as in the
reference. The absorbed-form decode and its compressed latent cache come
with the serving slice (ROADMAP queue 1).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.attention import _chunked_sdpa
from repro_torch.models.layers import apply_rope, dense_spec, rms_norm
from repro_torch.models.params import ParamSpec


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


def mla_attention(cfg, p, x, rope):
    """Training forward: expanded form + chunked softmax, causal."""
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
    o = _chunked_sdpa(q_eff, k_eff, v_pad, True, None, scale,
                      cfg.attention_chunk,
                      probs_dtype=getattr(torch, cfg.attention_probs_dtype),
                      remat_chunk=cfg.attention_remat_chunk)
    o = o.reshape(B, S, H, qk_hd)[..., :m.v_head_dim]
    return torch.einsum("bsnh,nhd->bsd", o, p["wo"].to(x.dtype))
