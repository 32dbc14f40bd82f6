"""Self-attention for the dense family: GQA/MQA, sliding window, qk-norm,
and the two softmax paths of the reference package — ``naive`` (one masked
softmax over the full score matrix) and ``chunked`` (online softmax over KV
chunks, O(Sq*chunk) live scores).

Layout conventions (the reference package's):
  q:      [B, S, KV, G, hd]   (G = num_heads // num_kv_heads; KV groups)
  k, v:   [B, S, KV, hd]

Both paths are plain tensor ops, as in the reference package, where they
run outside any Pallas kernel. ``attention_impl="pallas"`` falls through to
the chunked path there and here. Decode, KV caches and cross-attention
arrive with the serving and encoder-decoder slices (ROADMAP queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import apply_rope, dense_spec, rms_norm
from repro_torch.models.params import ParamSpec

NEG_INF = -1e30


def attn_spec(cfg, cross: bool = False):
    d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim())
    hax, kax = (("heads", "kv_heads") if cfg.dense_layout == "tp"
                else (None, None))
    spec = {
        "wq": dense_spec((d, H, hd), ("embed", hax, None)),
        "wk": dense_spec((d, KV, hd), ("embed", kax, None)),
        "wv": dense_spec((d, KV, hd), ("embed", kax, None)),
        "wo": dense_spec((H, hd, d), (hax, None, "embed"), fan_in=H * hd),
    }
    if cfg.qk_norm and not cross:
        spec["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        spec["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    return spec


def _project_q(cfg, p, x):
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(x.dtype))
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    B, S = x.shape[:2]
    return q.reshape(B, S, KV, H // KV, q.shape[-1])


def _project_kv(cfg, p, x):
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"].to(x.dtype))
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def _out_proj(cfg, p, o):
    B, S = o.shape[:2]
    o = o.reshape(B, S, cfg.num_heads, cfg.resolved_head_dim())
    return torch.einsum("bsnh,nhd->bsd", o, p["wo"].to(o.dtype))


def _keep(Sq, Sk, q0, k0, causal, window, device):
    """[Sq, Sk] boolean keep-mask over contiguous positions q0+i / k0+j."""
    qp = q0 + torch.arange(Sq, device=device)[:, None]
    kp = k0 + torch.arange(Sk, device=device)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        keep &= kp <= qp
    if window is not None:
        keep &= (qp - kp) < window
    return keep


def _sdpa(q, k, v, keep, scale):
    """q [B,Sq,KV,G,h], k/v [B,Sk,KV,h], keep [Sq,Sk]."""
    s = torch.einsum("bqngh,bknh->bngqk", q, k).float() * scale
    s = s.masked_fill(~keep, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bngqk,bknh->bqngh", w.to(v.dtype), v)


def _chunked_sdpa(q, k, v, causal, window, scale, chunk,
                  probs_dtype=torch.float32):
    """Online-softmax attention, a loop over KV chunks (the reference
    package's ``lax.scan``). Scores accumulate in f32; ``probs_dtype``
    holds exp(s - m) as there (bf16 is the reference's perf variant)."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    o = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    for start in range(0, Sk, chunk):
        kc = k[:, start:start + chunk]
        vc = v[:, start:start + chunk]
        s = torch.einsum("bqngh,bknh->bngqk", q.float(), kc.float()) * scale
        keep = _keep(Sq, kc.shape[1], 0, start, causal, window, q.device)
        s = s.masked_fill(~keep, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]).to(probs_dtype)
        l = l * corr + p.float().sum(dim=-1)
        pv = torch.einsum("bngqk,bknh->bngqh", p.float(), vc.float())
        o = o * corr[..., None] + pv
        m = m_new
    o = o / torch.clamp_min(l[..., None], 1e-30)
    return o.permute(0, 3, 1, 2, 4).to(q.dtype)          # [B,Sq,KV,G,hd]


def self_attention(cfg, p, x, *, causal=True, window=None, rope=None):
    """Training self-attention over the full sequence. ``rope`` is the
    (cos, sin) table pair computed once per forward."""
    hd = cfg.resolved_head_dim()
    scale = 1.0 / np.sqrt(hd)
    q = apply_rope(_project_q(cfg, p, x), rope)
    k, v = _project_kv(cfg, p, x)
    k = apply_rope(k, rope)
    S = x.shape[1]
    impl = cfg.attention_impl
    if impl == "auto":
        impl = "chunked" if S > 2048 else "naive"
    if impl == "naive":
        o = _sdpa(q, k, v, _keep(S, S, 0, 0, causal, window, x.device),
                  scale)
    else:
        o = _chunked_sdpa(q, k, v, causal, window, scale,
                          cfg.attention_chunk,
                          probs_dtype=getattr(torch,
                                              cfg.attention_probs_dtype))
    return _out_proj(cfg, p, o)
