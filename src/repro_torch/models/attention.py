"""Self-attention of the decoder families: GQA/MQA, sliding window, qk-norm,
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


class _RecomputedChunk(torch.autograd.Function):
    """``_chunk_step`` whose backward recomputes the chunk's scores and
    probabilities instead of saving them; only its inputs stay saved.
    (``torch.utils.checkpoint`` does the same but keeps the caller's frames,
    a train step's whole state among them, in a reference cycle until the
    garbage collector runs.)"""

    @staticmethod
    def forward(ctx, kw, *inputs):
        ctx.kw = kw
        ctx.save_for_backward(*inputs)
        return _chunk_step(*inputs, **kw)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
        wrt = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            outs = _chunk_step(*inputs, **ctx.kw)
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
        return (None, *[next(got) if x.requires_grad else None
                        for x in inputs])


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
        if remat_chunk and torch.is_grad_enabled():
            o, m, l = _RecomputedChunk.apply(kw, *args)
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
