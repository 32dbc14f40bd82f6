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

Both run on local tensors, as ``models/attention.py`` does: whole ones
with no mesh installed, shards under ``parallel.sharding.use_mesh``. The
low-rank
down-projections ``w_dq`` / ``w_dkv`` / ``w_kr`` shard only on "embed"
(gathered by the caller), so the latents are whole on every rank; the
up-projections and ``wo`` carry the heads over "model" with
``dense_layout="tp"`` (the reference's ``mla_spec``), so each rank runs
its own heads and the output projection is row-parallel. Decode reads a
latent cache whose slots are sharded (``mla_cache_axes``: batch, then
"cache_seq"); the softmax over the slots is combined across their ranks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.attention import (NEG_INF, _chunked_sdpa, _mask,
                                          linear_index, n_ranks, seq_owner)
from repro_torch.models.layers import (apply_rope, cache_from_spec,
                                       dense_spec, dot, rms_norm,
                                       row_parallel)
from repro_torch.models.params import ParamSpec
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import (constrain, constrain_spec,
                                           relayout, spec_axes)


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
    cq = rms_norm(dot("bsd,dr->bsr", x, p["w_dq"].to(x.dtype)),
                  p["q_ln"], cfg.norm_eps)
    q = dot("bsr,rnh->bsnh", cq, p["w_uq"].to(x.dtype))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], rope)
    c_kv = rms_norm(dot("bsd,dr->bsr", x, p["w_dkv"].to(x.dtype)),
                    p["kv_ln"], cfg.norm_eps)
    k_r = apply_rope(dot("bsd,dr->bsr", x, p["w_kr"].to(x.dtype)), rope)
    return q_nope, q_rope, c_kv, k_r


def mla_attention(cfg, p, x, rope, return_latents=False, have=None,
                  specs=None):
    """Training forward: expanded form + chunked softmax, causal, heads as
    the KV axis (G = 1) so the generic online softmax serves.
    ``return_latents`` also returns (c_kv, k_r), which a prefill lays into
    its cache (the local rows, whole over "model"). ``x`` is laid out by
    ``have`` (a sharded sequence is all-gathered first), the weights by
    their "model" ``specs``; both default to whole."""
    have, specs = have or (None, None, None), specs or {}
    m = cfg.mla
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    xb = have[0]
    rows = (xb, None, None)
    x = relayout(x, have, rows)
    q_nope, q_rope, c_kv, k_r = _latents(cfg, p, x, rope)
    hax = spec_axes(specs.get("w_uq"), 3)[1]
    kax = spec_axes(specs.get("w_uk"), 3)[1]
    vax = spec_axes(specs.get("w_uv"), 3)[1]
    k_nope = dot("bsr,rnh->bsnh", c_kv, p["w_uk"].to(x.dtype))
    v = dot("bsr,rnh->bsnh", c_kv, p["w_uv"].to(x.dtype))
    B, S = x.shape[:2]
    q_eff = torch.cat([q_nope, q_rope], dim=-1)
    q_eff = q_eff.reshape(B, S, q_eff.shape[2], 1, qk_hd)
    q_eff, qs = constrain_spec(q_eff, ("batch", None, "act_heads", None,
                                       None),
                               have=(xb, None, hax or None, None, None))
    Hk = k_nope.shape[2]
    k_eff = torch.cat([k_nope, k_r[:, :, None, :].expand(
        B, S, Hk, m.qk_rope_head_dim)], dim=-1)
    k_eff, ks = constrain_spec(k_eff, ("batch", None, "act_heads", None),
                               have=(xb, None, kax or None, None))
    v_pad = relayout(F.pad(v, (0, qk_hd - m.v_head_dim)),
                     (xb, None, vax or None, None), ks)
    o = _chunked_sdpa(q_eff, k_eff, v_pad, True, None, 1.0 / np.sqrt(qk_hd),
                      cfg.attention_chunk,
                      probs_dtype=getattr(torch, cfg.attention_probs_dtype),
                      remat_chunk=cfg.attention_remat_chunk)
    heads = spec_axes(qs, 5)[2]
    o = o.reshape(B, S, o.shape[2], qk_hd)[..., :m.v_head_dim]
    wo_h = spec_axes(specs.get("wo"), 3)[0]
    o = relayout(o, (xb, None, heads or None, None),
                 (xb, None, wo_h or None, None))
    out = row_parallel("bsnh,nhd->bsd", o, p["wo"], wo_h, x.dtype)
    out = relayout(out, rows, have)
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


def mla_decode(cfg, p, x, cache, pos: int, rope, have=None, specs=None,
               cspec=None):
    """Absorbed-form one-token decode against the latent cache: writes the
    token's latent and rope key at row ``pos`` in place; ``rope`` is the
    position's (cos, sin) row. Returns (out [B,1,d], cache). ``x`` is
    laid out by ``have``, the weights by ``specs``, ``cache`` by
    ``cspec`` (its rows over the slot axes; all default to whole). The
    absorbed query is made on the local heads and all-gathered to every
    head; the rank holding row ``pos`` writes the token's latent; each
    rank scores its own rows and the softmax is combined across the slot
    axes (``pmax`` of the row max, ``psum`` of the rescaled sums and
    latents); W_uv and ``wo`` then run on the local heads, ``wo``
    row-parallel."""
    have, specs, cspec = have or (None, None, None), specs or {}, cspec or {}
    m = cfg.mla
    scale = 1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    cb, csx, _ = spec_axes(cspec.get("c_kv"), 3)
    rows = (cb or None, None, None)
    xb = have[0]
    x = relayout(x, have, rows)
    q_nope, q_rope, c_kv_new, k_r_new = _latents(cfg, p, x, rope)
    hax = spec_axes(specs.get("w_uq"), 3)[1]
    kax = spec_axes(specs.get("w_uk"), 3)[1]
    vax = spec_axes(specs.get("w_uv"), 3)[1]
    if tuple(hax) != tuple(kax):
        q_nope = relayout(q_nope, (cb or None, None, hax or None, None),
                          (cb or None, None, kax or None, None))
    q_abs = torch.einsum("bqnh,rnh->bqnr", q_nope, p["w_uk"].to(x.dtype))
    every = (cb or None, None, None, None)
    q_abs = relayout(q_abs, (cb or None, None, kax or None, None), every)
    q_rope = relayout(q_rope, (cb or None, None, hax or None, None), every)
    ckv, kr, slot_pos = cache["c_kv"], cache["k_r"], cache["slot_pos"]
    n_loc = ckv.shape[1]
    lo, mine = seq_owner(csx, n_loc, pos)
    if mine:
        ckv[:, pos - lo] = c_kv_new[:, 0].to(ckv.dtype)
        kr[:, pos - lo] = k_r_new[:, 0].to(kr.dtype)
    slot_pos[pos] = pos
    ckv = constrain(ckv, ("batch", "cache_seq", None),
                    have=cspec.get("c_kv") or (None,) * 3)
    s = (torch.einsum("bqnr,bkr->bnqk", q_abs.float(), ckv.float())
         + torch.einsum("bqnh,bkh->bnqk", q_rope.float(), kr.float())) \
        * scale
    keep = _mask(torch.full((1,), pos, dtype=torch.int32, device=x.device),
                 slot_pos[lo:lo + n_loc], True, None)
    s = s.masked_fill(~keep, NEG_INF)
    mx = col.pmax(s.amax(dim=-1), csx)
    e = torch.exp(s - mx[..., None])
    den = col.psum(e.sum(dim=-1), csx)                   # [B,H,1]
    ctx = col.psum(torch.einsum("bnqk,bkr->bqnr", e, ckv.float()), csx)
    ctx = ctx / den.permute(0, 2, 1)[..., None]
    ctx = relayout(ctx, every, (cb or None, None, vax or None, None))
    o = torch.einsum("bqnr,rnh->bqnh", ctx.to(x.dtype),
                     p["w_uv"].to(x.dtype))
    wo_h = spec_axes(specs.get("wo"), 3)[0]
    o = relayout(o, (cb or None, None, vax or None, None),
                 (cb or None, None, wo_h or None, None))
    out = row_parallel("bqnh,nhd->bqd", o, p["wo"], wo_h, x.dtype)
    return relayout(out, rows, (xb, None, None)), cache


def mla_prefill_cache(c_kv, k_r, max_len: int, dtype, rows=None,
                      cspec=None):
    """The prompt's latents and rope keys (as ``mla_attention(...,
    return_latents=True)`` gave them: rows laid out by ``rows``, whole over
    "model") in rows 0..S-1 of a fresh cache; returns this rank's rows of
    the cache laid out by ``cspec`` (default: whole)."""
    rows, cspec = rows or (None, None, None), cspec or {}
    cb, csx, _ = spec_axes(cspec.get("c_kv"), 3)
    want = (cb or None, None, None)
    c_kv = relayout(c_kv, rows, want)
    k_r = relayout(k_r, rows, want)
    S = c_kv.shape[1]
    n_loc = max_len // n_ranks(csx)
    lo = linear_index(csx) * n_loc
    n_held = max(0, min(S, lo + n_loc) - lo)

    def lay(t):
        out = t.new_zeros((t.shape[0], n_loc, t.shape[2]), dtype=dtype)
        if n_held:
            out[:, :n_held] = t[:, lo:lo + n_held].to(dtype)
        return out
    slot_pos = torch.cat([
        torch.arange(S, dtype=torch.int32, device=c_kv.device),
        torch.full((max_len - S,), -1, dtype=torch.int32,
                   device=c_kv.device)])
    return {"c_kv": lay(c_kv), "k_r": lay(k_r), "slot_pos": slot_pos}
