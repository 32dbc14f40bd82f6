"""Self-attention of the decoder families: GQA/MQA, sliding window, qk-norm,
and the two softmax paths of the reference package — ``naive`` (one masked
softmax over the full score matrix) and ``chunked`` (online softmax over KV
chunks, O(Sq*chunk) live scores).

Layout conventions (the reference package's):
  q:      [B, S, KV, G, hd]   (G = num_heads // num_kv_heads; KV groups)
  k, v:   [B, S, KV, hd]

Both paths are plain tensor ops, as in the reference package, where they
run outside any Pallas kernel. ``attention_impl="pallas"`` falls through to
the chunked path there and here. ``cross_attention`` is the decoder's view
of the encoder (no mask, no rope).

Serving: one layer's KV cache is ``{"k", "v": [B, Smax, KV, hd],
"slot_pos": [Smax]}``, ``slot_pos`` holding the absolute position in each
slot (-1 = empty). With a sliding window, Smax = min(max_len, window) and
the cache is a ring: position p lives in slot p % Smax, which bounds its
memory at any context length. Decode scores in f32 over the cache cast to
f32, as the reference does; the cache itself stays in the compute dtype.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import (apply_rope, cache_from_spec,
                                       dense_spec, recomputed, rms_norm)
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


def _chunk_step(q, kc, vc, o, m, l, start, causal, window, scale,
                probs_dtype):
    """One KV chunk of the online softmax: (o, m, l) -> (o, m, l)."""
    s = torch.einsum("bqngh,bknh->bngqk", q.float(), kc.float()) * scale
    keep = _keep(q.shape[1], kc.shape[1], 0, start, causal, window, q.device)
    s = s.masked_fill(~keep, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None]).to(probs_dtype)
    l = l * corr + p.float().sum(dim=-1)
    pv = torch.einsum("bngqk,bknh->bngqh", p.float(), vc.float())
    return o * corr[..., None] + pv, m_new, l


def _chunked_sdpa(q, k, v, causal, window, scale, chunk,
                  probs_dtype=torch.float32, remat_chunk=False):
    """Online-softmax attention, a loop over KV chunks (the reference
    package's ``lax.scan``). Scores accumulate in f32; ``probs_dtype``
    holds exp(s - m) as there (bf16 is the reference's perf variant).
    ``remat_chunk`` recomputes each chunk's scores and probabilities in
    the backward pass instead of saving them (the reference's
    ``jax.checkpoint`` of the scan body), so only the (o, m, l) carries
    stay live between the passes."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    o = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    for start in range(0, Sk, chunk):
        kw = dict(start=start, causal=causal, window=window, scale=scale,
                  probs_dtype=probs_dtype)
        args = (q, k[:, start:start + chunk], v[:, start:start + chunk],
                o, m, l)
        if remat_chunk:
            o, m, l = recomputed(_chunk_step, *args, **kw)
        else:
            o, m, l = _chunk_step(*args, **kw)
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
                                              cfg.attention_probs_dtype),
                          remat_chunk=cfg.attention_remat_chunk)
    return _out_proj(cfg, p, o)


def cross_attention(cfg, p, x, enc_out):
    """Decoder -> encoder attention (no mask, no rope), training path."""
    scale = 1.0 / np.sqrt(cfg.resolved_head_dim())
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, enc_out)
    keep = torch.ones((x.shape[1], enc_out.shape[1]), dtype=torch.bool,
                      device=x.device)
    return _out_proj(cfg, p, _sdpa(q, k, v, keep, scale))


# ------------------------------------------------------------- decode -----

def _mask(q_pos, k_pos, causal: bool, window):
    """[..., Sq, Sk] boolean keep-mask from absolute positions; a key at
    position -1 (an empty cache slot) is never kept."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    keep = kp >= 0
    if causal:
        keep = keep & (kp <= qp)
    if window is not None:
        keep = keep & ((qp - kp) < window)
    return keep


def _cache_len(cfg, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len


def init_cache_spec(cfg, batch: int, max_len: int, dtype):
    """One layer's KV cache as {name: (torch.Size, dtype)}, window-bounded
    with a sliding window."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim()
    smax = _cache_len(cfg, max_len)
    return {"k": (torch.Size((batch, smax, KV, hd)), dtype),
            "v": (torch.Size((batch, smax, KV, hd)), dtype),
            "slot_pos": (torch.Size((smax,)), torch.int32)}


def cache_logical_axes():
    """Logical axes of one layer's KV cache leaves."""
    return {
        "k": ("batch", "cache_seq", "kv_heads", None),
        "v": ("batch", "cache_seq", "kv_heads", None),
        "slot_pos": (None,),
    }


def init_cache(cfg, batch: int, max_len: int, dtype, device):
    """An empty cache: zeros, every slot at position -1."""
    return cache_from_spec(init_cache_spec(cfg, batch, max_len, dtype),
                           device)


def decode_attention(cfg, p, x, cache, pos: int, rope):
    """One-token decode. x [B,1,d]; ``pos`` the token's position (the same
    across the batch), ``rope`` its (cos, sin) row, made once a step for
    every layer. Writes the token's K/V into slot ``pos % Smax`` of
    ``cache`` in place and attends over the slots the mask keeps. Returns
    (out [B,1,d], cache)."""
    scale = 1.0 / np.sqrt(cfg.resolved_head_dim())
    q = apply_rope(_project_q(cfg, p, x), rope)              # [B,1,KV,G,hd]
    k, v = _project_kv(cfg, p, x)                            # [B,1,KV,hd]
    k = apply_rope(k, rope)
    ck, cv, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    slot = pos % ck.shape[1]
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    slot_pos[slot] = pos
    keep = _mask(torch.full((1,), pos, dtype=torch.int32, device=x.device),
                 slot_pos, True, cfg.sliding_window)         # [1, Smax]
    s = torch.einsum("bqngh,bknh->bngqk", q.float(), ck.float()) * scale
    w = torch.softmax(s.masked_fill(~keep, NEG_INF), dim=-1)
    o = torch.einsum("bngqk,bknh->bqngh", w, cv.float()).to(x.dtype)
    return _out_proj(cfg, p, o), cache


def prefill_cache(cfg, p, x, max_len: int, dtype, rope):
    """K/V of a whole prompt laid into a fresh cache, so decode continues
    at position S. When the prompt fills the cache (S >= Smax) it keeps the
    last Smax positions, each in its ring slot."""
    k, v = _project_kv(cfg, p, x)
    k = apply_rope(k, rope)
    S = x.shape[1]
    smax = _cache_len(cfg, max_len)
    if S >= smax:
        tail_pos = torch.arange(S - smax, S, device=x.device)
        order = torch.argsort(tail_pos % smax)
        ck = k[:, S - smax:][:, order].to(dtype)
        cv = v[:, S - smax:][:, order].to(dtype)
        slot_pos = tail_pos[order]
    else:
        pad = smax - S
        ck = F.pad(k, (0, 0, 0, 0, 0, pad)).to(dtype)
        cv = F.pad(v, (0, 0, 0, 0, 0, pad)).to(dtype)
        slot_pos = torch.cat([torch.arange(S, device=x.device),
                              torch.full((pad,), -1, device=x.device)])
    return {"k": ck, "v": cv, "slot_pos": slot_pos.to(torch.int32)}
