"""Self-attention of the decoder families: GQA/MQA, sliding window, qk-norm,
and three softmax paths — the reference package's ``naive`` (one masked
softmax over the full score matrix) and ``chunked`` (online softmax over KV
chunks, O(Sq*chunk) live scores), and ``flash``: ``ops.FlashAttention``,
the hand-written flash kernels forward and backward.

Layout conventions (the reference package's):
  q:      [B, S, KV, G, hd]   (G = num_heads // num_kv_heads; KV groups)
  k, v:   [B, S, KV, hd]

The naive and chunked paths are plain tensor ops, as in the reference
package, where they run outside any Pallas kernel (its
``attention_impl="pallas"`` falls through to the chunked path). Here
``_impl`` sends self-attention to the flash path when the call allows it:
``attention_impl`` "auto" or "pallas", the window None or at least S, the
sequence not sharded, and q a bf16 / f16 CUDA tensor at head dim 64 or 128
(the kernels' inputs), or "pallas" on the CPU, which runs the kernels'
plain versions. Every other call runs the path it ran before: on the CPU
"auto" is the reference's naive / chunked choice bit for bit. The flash
path carries P and dS as a hi + lo pair of 16-bit values, as precise as
float32 probabilities, whatever ``attention_probs_dtype`` says.
``cross_attention`` is the decoder's view of the encoder (no mask, no
rope).

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
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels.flash_attention import route as flash_route
from repro_torch.kernels.ops import FlashAttention
from repro_torch.models.layers import (apply_rope, cache_from_spec,
                                       dense_spec, dot, recomputed,
                                       rms_norm, row_parallel)
from repro_torch.models.params import ParamSpec
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import (constrain, constrain_spec,
                                           global_shape, physical_spec,
                                           relayout, spec_axes)

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
                probs_dtype, q0=0):
    """One KV chunk of the online softmax: (o, m, l) -> (o, m, l); the
    queries sit at positions q0, q0 + 1, ..."""
    s = torch.einsum("bqngh,bknh->bngqk", q.float(), kc.float()) * scale
    keep = _keep(q.shape[1], kc.shape[1], q0, start, causal, window,
                 q.device)
    s = s.masked_fill(~keep, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None]).to(probs_dtype)
    l = l * corr + p.float().sum(dim=-1)
    pv = torch.einsum("bngqk,bknh->bngqh", p.float(), vc.float())
    return o * corr[..., None] + pv, m_new, l


def _chunked_sdpa(q, k, v, causal, window, scale, chunk,
                  probs_dtype=torch.float32, remat_chunk=False, q0=0,
                  seq_have=None):
    """Online-softmax attention, a loop over KV chunks (the reference
    package's ``lax.scan``). Scores accumulate in f32; ``probs_dtype``
    holds exp(s - m) as there (bf16 is the reference's perf variant).
    ``remat_chunk`` recomputes each chunk's scores and probabilities in
    the backward pass instead of saving them (the reference's
    ``jax.checkpoint`` of the scan body), so only the (o, m, l) carries
    stay live between the passes.

    Under a mesh with ``seq_have`` (the layout of the local queries, their
    sequence sharded: sequence parallelism) ``q`` holds the queries at
    positions ``q0`` on and the accumulators take the reference's
    ``seq_mp`` constraints, which they already satisfy."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    o = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    if seq_have is not None:
        b, sq = seq_have[0], seq_have[1]
        o = constrain(o, ("batch", None, None, "seq_mp", None),
                      have=(b, None, None, sq, None))
        m = constrain(m, ("batch", None, None, "seq_mp"),
                      have=(b, None, None, sq))
        l = constrain(l, ("batch", None, None, "seq_mp"),
                      have=(b, None, None, sq))
    for start in range(0, Sk, chunk):
        kw = dict(start=start, causal=causal, window=window, scale=scale,
                  probs_dtype=probs_dtype, q0=q0)
        args = (q, k[:, start:start + chunk], v[:, start:start + chunk],
                o, m, l)
        if remat_chunk:
            o, m, l = recomputed(_chunk_step, *args, **kw)
        else:
            o, m, l = _chunk_step(*args, **kw)
    o = o / torch.clamp_min(l[..., None], 1e-30)
    return o.permute(0, 3, 1, 2, 4).to(q.dtype)          # [B,Sq,KV,G,hd]


def _core(cfg, q, k, v, causal, window, scale, seq_sharded=False):
    """Softmax attention over local q [B,Sq,KV,G,hd] and k, v [B,Sk,KV,hd]:
    the flash, naive or chunked path, as ``_impl`` picks."""
    S = q.shape[1]
    impl = _impl(cfg, S, q, window, seq_sharded)
    if impl == "flash":
        return _flash(q, k, v, causal, scale)
    if impl == "naive":
        return _sdpa(q, k, v, _keep(S, S, 0, 0, causal, window, q.device),
                     scale)
    return _chunked_sdpa(q, k, v, causal, window, scale, cfg.attention_chunk,
                         probs_dtype=getattr(torch, cfg.attention_probs_dtype),
                         remat_chunk=cfg.attention_remat_chunk)


def _impl(cfg, S: int, q=None, window=None, seq_sharded=False) -> str:
    """"flash", "naive" or "chunked" for a self-attention over S positions.
    Without ``q`` (the caller asks which plain path a sharded sequence
    takes) the answer is never "flash"; nor for a fake q (the dry run's
    traces, which have no memory for a kernel to read)."""
    impl = cfg.attention_impl
    if impl in ("auto", "pallas") and q is not None and not seq_sharded \
            and (window is None or window >= S) and not is_fake(q):
        if q.is_cuda:
            if flash_route(q.dtype, q.shape[-1]) == "wgmma":
                return "flash"
        elif impl == "pallas":
            return "flash"
    if impl == "auto":
        impl = "chunked" if S > 2048 else "naive"
    return "naive" if impl == "naive" else "chunked"


def _flash(q, k, v, causal, scale):
    """``FlashAttention`` over q [B,S,KV,G,hd], k, v [B,S,KV,hd]: the
    kernels take [B, H, S, hd] with head h in KV group h // G, which the
    model's layout is through a transpose (the kernels read it by its
    strides, no copy), and o [B,S,KV,G,hd] comes back the same way."""
    B, S, KV, G, hd = q.shape
    qh = q.reshape(B, S, KV * G, hd).transpose(1, 2)
    o = FlashAttention.apply(qh, k.transpose(1, 2), v.transpose(1, 2),
                             causal, scale)
    return o.transpose(1, 2).reshape(B, S, KV, G, hd)


def linear_index(axes) -> int:
    """This rank's block index along the mesh ``axes`` joined (major
    first), as a dim sharded over them is split."""
    idx = 0
    for a in axes:
        idx = idx * col.axis_size(a) + col.axis_index(a)
    return idx


def n_ranks(axes) -> int:
    """The number of ranks of the mesh ``axes`` joined."""
    n = 1
    for a in axes:
        n *= col.axis_size(a)
    return n


def _attention(cfg, p, x, causal, window, rope, have, specs, kv_x=None,
               return_kv=False):
    """``self_attention`` (or, with ``kv_x``, ``cross_attention``) on the
    local tensors: ``x`` laid out by ``have``, the weights by their
    "model" ``specs`` (without a mesh: whole, and every relayout below is
    the identity). q and k (v with k) take the reference's
    constraints — batch over the data axes, the KV groups over "model"
    where ``num_kv_heads`` divides it, replicated where it does not (q's
    heads are then all-gathered first); the output projection is
    row-parallel over the heads "model" shards and the result comes back
    in ``x``'s layout. With the residual's sequence sharded (``seq_shard``)
    the attention sees the whole sequence — projected on the local
    positions and all-gathered where the heads replicate, projected from
    the all-gathered input where they are sharded — and the output's
    partial sums are reduce-scattered back onto it; the chunked path then
    runs the reference's ``seq_mp`` layout instead: each rank its own
    queries against every head's keys."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G, hd = H // KV, cfg.resolved_head_dim()
    xb, sax = have[0], spec_axes(have, 3)[1]
    hax = spec_axes(specs.get("wq"), 3)[1]
    kax = spec_axes(specs.get("wk"), 3)[1]
    whole = []

    def project(src, w, axes):
        """``src`` through ``w`` over the whole sequence: a weight whose
        heads replicate projects the local positions and gathers the
        result, one whose heads are sharded projects the gathered
        sequence (its own heads only)."""
        if not sax or src is not x:
            return dot("bsd,dnh->bsnh", src, w.to(src.dtype))
        if not axes:
            y = dot("bsd,dnh->bsnh", x, w.to(x.dtype))
            return relayout(y, (xb, sax, None, None), (xb, None, None, None))
        if not whole:
            whole.append(relayout(x, have, (xb, None, None)))
        return dot("bsd,dnh->bsnh", whole[0], w.to(x.dtype))

    q = project(x, p["wq"], hax)
    B, S = q.shape[:2]
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    if hax and q.shape[2] % G:       # local heads split a KV group
        q = relayout(q, (xb, None, hax, None), (xb, None, None, None))
        hax = ()
    q = q.reshape(B, S, q.shape[2] // G, G, hd)
    if rope is not None:
        q = apply_rope(q, rope)
    q, qs = constrain_spec(q, ("batch", None, "kv_heads", None, None),
                           have=(xb, None, hax or None, None, None))
    src = x if kv_x is None else kv_x
    k = project(src, p["wk"], kax)
    v = project(src, p["wv"], kax)
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope is not None:
        k = apply_rope(k, rope)
    kv_have = (xb, None, kax or None, None)
    k, ks = constrain_spec(k, ("batch", None, "kv_heads", None),
                           have=kv_have)
    v = relayout(v, kv_have, ks)
    scale = 1.0 / np.sqrt(hd)
    wo_h = spec_axes(specs.get("wo"), 3)[0]
    if kv_x is None and sax and _impl(cfg, S) == "chunked":
        out, os_ = _seq_parallel_core(cfg, p["wo"], wo_h, q, qs, k, v, ks,
                                      causal, window, scale)
        out = relayout(out, os_, have)
        return (out, (k, v, ks)) if return_kv else out
    if kv_x is not None:
        keep = torch.ones((S, k.shape[1]), dtype=torch.bool,
                          device=q.device)
        o = _sdpa(q, k, v, keep, scale)
    else:
        o = _core(cfg, q, k, v, causal, window, scale,
                  seq_sharded=bool(sax))
    o = o.reshape(o.shape[0], S, -1, hd)           # heads laid out as q's KV
    o_have = (qs[0], None, qs[2], None)
    heads = spec_axes(o_have, 4)[2] or wo_h
    o = relayout(o, o_have, (qs[0], None, heads or None, None))
    wo = relayout(p["wo"], (wo_h or None, None, None),
                  (heads or None, None, None))
    scatter = (1, sax) if sax and tuple(heads) == tuple(sax) else None
    out = row_parallel("bsnh,nhd->bsd", o, wo, heads, x.dtype,
                       scatter=scatter)
    out_have = (qs[0], sax or None, None) if scatter else \
        (qs[0], None, None)
    out = relayout(out, out_have, have)
    return (out, (k, v, ks)) if return_kv else out


def _seq_parallel_core(cfg, wo, wo_h, q, qs, k, v, ks, causal, window,
                       scale):
    """The chunked online softmax with the queries' sequence sharded (the
    reference's ``seq_mp`` accumulators): every head's queries of this
    rank's positions against every head's keys and values, and the output
    projection with the whole ``wo``. Returns (out, its spec)."""
    b = qs[0]
    q = relayout(q, qs, (b, None, None, None, None))
    k = relayout(k, ks, (b, None, None, None))
    v = relayout(v, ks, (b, None, None, None))
    B, S, KV, G, hd = q.shape
    want = physical_spec(("batch", None, None, "seq_mp", None),
                         global_shape((B, KV, G, S, hd),
                                      (b, None, None, None, None)))
    sq = spec_axes(want, 5)[3]
    q = relayout(q, (b, None, None, None, None), (b, sq or None, None, None,
                                                  None))
    q0 = linear_index(sq) * q.shape[1]
    o = _chunked_sdpa(q, k, v, causal, window, scale, cfg.attention_chunk,
                      probs_dtype=getattr(torch, cfg.attention_probs_dtype),
                      remat_chunk=cfg.attention_remat_chunk, q0=q0,
                      seq_have=(b, sq or None))
    o = o.reshape(B, q.shape[1], KV * G, hd)
    wo = relayout(wo, (wo_h or None, None, None), (None, None, None))
    out = dot("bsnh,nhd->bsd", o, wo.to(o.dtype))
    return out, (b, sq or None, None)


def self_attention(cfg, p, x, *, causal=True, window=None, rope=None,
                   return_kv=False, have=None, specs=None):
    """Training self-attention over the full sequence. ``rope`` is the
    (cos, sin) table pair computed once per forward. ``return_kv`` also
    returns the roped K/V and their spec, (k, v, spec), which a prefill
    lays into its cache: eager code has no common-subexpression pass to
    share them, as XLA does for the reference. ``have`` / ``specs``: the
    layouts of ``x`` and the weights (default: whole; see
    ``_attention``)."""
    return _attention(cfg, p, x, causal, window, rope,
                      have or (None, None, None), specs or {},
                      return_kv=return_kv)


def cross_attention(cfg, p, x, enc_out, have=None, specs=None):
    """Decoder -> encoder attention (no mask, no rope), training path;
    ``x`` and ``enc_out`` are rows laid out by ``have``."""
    return _attention(cfg, p, x, False, None, None,
                      have or (None, None, None), specs or {}, kv_x=enc_out)


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


def seq_owner(cspec_seq, n_local: int, slot: int):
    """(first slot this rank holds, whether it holds ``slot``) of a cache
    whose sequence (``n_local`` slots a rank) is sharded over the axes
    ``cspec_seq``."""
    lo = linear_index(cspec_seq) * n_local
    return lo, lo <= slot < lo + n_local


def decode_attention(cfg, p, x, cache, pos: int, rope, have=None,
                     specs=None, cspec=None):
    """One-token decode. x [B,1,d]; ``pos`` the token's position (the same
    across the batch), ``rope`` its (cos, sin) row, made once a step for
    every layer. Writes the token's K/V into slot ``pos % Smax`` of the
    cache in place and attends over the slots the mask keeps. Returns
    (out [B,1,d], cache).

    ``x`` is laid out by ``have``, the weights by ``specs`` and ``cache``
    by ``cspec`` (per leaf, the ``cache_shardings`` spec: batch over the
    data axes, the slots over "model" — or over every axis the batch
    leaves — and the KV heads over what is left); all default to whole.
    q, k and v are made on the local heads and all-gathered to every head
    (one token: small). The rank that holds the token's slot writes it;
    each rank scores its own slots, and the softmax is combined across
    the slot axes: the row max ``pmax``ed, the rescaled sums and outputs
    ``psum``med. The output projection is row-parallel over the heads
    "model" shards of ``wo``."""
    have, specs, cspec = have or (None, None, None), specs or {}, cspec or {}
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G, hd = H // KV, cfg.resolved_head_dim()
    cb, csx, ckx, _ = spec_axes(cspec.get("k"), 4)
    xb = have[0]
    x = relayout(x, have, (cb or None, None, None))
    B = x.shape[0]
    hax = spec_axes(specs.get("wq"), 3)[1]
    kax = spec_axes(specs.get("wk"), 3)[1]
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(x.dtype))
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    q = relayout(q, (cb or None, None, hax or None, None),
                 (cb or None, None, None, None))
    q = apply_rope(q.reshape(B, 1, KV, G, hd), rope)
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"].to(x.dtype))
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    k = apply_rope(k, rope)
    kv_have = (cb or None, None, kax or None, None)
    k = relayout(k, kv_have, (cb or None, None, None, None))
    v = relayout(v, kv_have, (cb or None, None, None, None))
    ck, cv, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    n_loc, kv_loc = ck.shape[1], ck.shape[2]
    slot = pos % (n_loc * n_ranks(csx))
    k0 = linear_index(ckx) * kv_loc
    lo, mine = seq_owner(csx, n_loc, slot)
    if mine:
        ck[:, slot - lo] = k[:, 0, k0:k0 + kv_loc].to(ck.dtype)
        cv[:, slot - lo] = v[:, 0, k0:k0 + kv_loc].to(cv.dtype)
    slot_pos[slot] = pos
    ck = constrain(ck, ("batch", "cache_seq", "kv_heads", None),
                   have=cspec.get("k") or (None,) * 4)
    cv = constrain(cv, ("batch", "cache_seq", "kv_heads", None),
                   have=cspec.get("v") or (None,) * 4)
    keep = _mask(torch.full((1,), pos, dtype=torch.int32, device=x.device),
                 slot_pos[lo:lo + n_loc], True, cfg.sliding_window)
    scale = 1.0 / np.sqrt(hd)
    ql = q[:, :, k0:k0 + kv_loc].float()
    s = torch.einsum("bqngh,bknh->bngqk", ql, ck.float()) * scale
    s = s.masked_fill(~keep, NEG_INF)
    m = col.pmax(s.amax(dim=-1), csx)
    e = torch.exp(s - m[..., None])
    den = col.psum(e.sum(dim=-1), csx)                   # [B,n,g,1]
    o = col.psum(torch.einsum("bngqk,bknh->bqngh", e, cv.float()), csx)
    o = (o / den.permute(0, 3, 1, 2)[..., None]).to(x.dtype)
    o = relayout(o, (cb or None, None, ckx or None, None, None),
                 (cb or None, None, None, None, None)).reshape(B, 1, H, hd)
    wo_h = spec_axes(specs.get("wo"), 3)[0]
    o = relayout(o, (cb or None, None, None, None),
                 (cb or None, None, wo_h or None, None))
    out = row_parallel("bsnh,nhd->bsd", o, p["wo"], wo_h, x.dtype)
    return relayout(out, (cb or None, None, None), (xb, None, None)), cache


def slot_positions(S: int, smax: int, device):
    """The position each of a fresh cache's ``smax`` slots holds after an
    ``S``-token prompt (-1 = empty): the last ``smax`` positions, each in
    its ring slot, when the prompt fills the cache."""
    if S >= smax:
        tail = torch.arange(S - smax, S, device=device)
        return tail[torch.argsort(tail % smax)]
    return torch.cat([torch.arange(S, device=device),
                      torch.full((smax - S,), -1, device=device)])


def prefill_cache(cfg, k, v, max_len: int, dtype, ks=None, cspec=None):
    """A whole prompt's K/V (the roped K and V that ``self_attention(...,
    return_kv=True)`` gave, laid out by ``ks``) laid into a fresh cache,
    so decode continues at position S; when the prompt fills the cache
    (S >= Smax) it keeps the last Smax positions, each in its ring slot.
    Returns this rank's slice of the cache laid out by ``cspec`` (its
    slots, its KV heads; ``slot_pos`` is replicated; default: whole):
    only the local slice is written."""
    cspec = cspec or {}
    ks = ks or (None,) * 4
    cb, csx, ckx, _ = spec_axes(cspec.get("k"), 4)
    rows = (cb or None, None, None, None)
    k = relayout(k, ks, rows)
    v = relayout(v, ks, rows)
    smax = _cache_len(cfg, max_len)
    slot_pos = slot_positions(k.shape[1], smax, k.device)
    n_loc = smax // n_ranks(csx)
    lo = linear_index(csx) * n_loc
    local = slot_pos[lo:lo + n_loc]
    held = (local >= 0)[None, :, None, None]
    idx = local.clamp_min(0)
    kv_loc = k.shape[2] // n_ranks(ckx)
    k0 = linear_index(ckx) * kv_loc
    heads = slice(k0, k0 + kv_loc)

    def lay(t):
        # one copy (the gather), the empty slots zeroed in it: a prefill
        # at full depth leaves the card little room for temporaries
        return t[:, idx, heads].to(dtype).masked_fill_(~held, 0)
    return {"k": lay(k), "v": lay(v), "slot_pos": slot_pos.to(torch.int32)}
