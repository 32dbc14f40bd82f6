"""Mamba blocks, training path: v1 (selective scan, Falcon-Mamba) and v2
(SSD, Zamba2).

Both run a CHUNKED scan as the reference does: a loop over sequence chunks
carrying the SSM state, with a prefix scan (v1) or the SSD matmul form (v2)
inside each chunk. Each chunk's backward recomputes the chunk from its
inputs (``layers.recomputed``), so live memory is O(B * chunk * d_inner *
N) for one chunk at a time, not for the whole sequence.

Where the reference calls ``jax.lax.associative_scan``, this package runs
a log-depth Hillis–Steele scan over the chunk axis: log2(chunk) rounds of
shifted elementwise products and sums, each a few launches on the card
where a step-by-step loop would be ``chunk`` rounds. Its summation order
is not XLA's, so outputs agree with the reference to rounding, not bit
for bit. Every op here is a matmul, an elementwise op, a slice or a
concatenation: no atomics and no cuDNN convolution (the depthwise causal
conv is a sum of shifted products, as in the reference), so a step gives
the same bits each time it runs.

Serving: with ``return_cache=True`` a forward also returns the block's
decode cache, ``{"conv": the last conv_dim - 1 inputs of the causal conv
(oldest first), "ssm": the scan state after the last token (f32)}``, both
carried out of the chunk loop as fresh tensors (neither keeps a chunk's
intermediates alive). A decode step is one O(1) update of that state.

The blocks run on local tensors (whole ones with no mesh installed), the
channels of d_inner over "model" where they divide it under a mesh (the
reference's "dinner" / "act_mlp" axes). ``in_proj`` packs several outputs
side by side, so a contiguous "model" block of its columns straddles their
split: it is all-gathered and each output takes its own block of columns
(column-parallel; Mamba1's x and z, Mamba2's z and dt by heads and its
conv input x|B|C by the reference's contiguous "act_mlp" blocks, which
the conv's per-channel weights share). Mamba1's ``x_proj`` contracts over
the channels: row-parallel, psummed before dt / B / C. Mamba2's heads
need the whole B and C, so its conv output is all-gathered over "model"
and each rank keeps its heads' x; the gated norm's mean of squares is
psummed over the heads' ranks. ``out_proj`` is row-parallel. Per-channel
and per-head weights (``conv_*``, ``dt_bias``, ``A_log``, ``D``,
``gate_norm``) stay local. Caches take the layouts of
``mamba*_cache_axes``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.attention import linear_index, n_ranks
from repro_torch.models.layers import (dense_spec, dot, norm_spec,
                                       recomputed, rms_norm, row_parallel)
from repro_torch.models.params import ParamSpec
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import (constrain_spec, global_shape,
                                           physical_spec, relayout,
                                           spec_axes)


# ------------------------------------------------------------ helpers -----

def _causal_conv(x, w, b):
    """Depthwise causal conv along axis 1. x [B,S,C], w [K,C], b [C]."""
    K = w.shape[0]
    out = torch.zeros_like(x)
    for k in range(K):
        shift = K - 1 - k
        xs = x if shift == 0 else F.pad(x, (0, 0, shift, 0))[:, :x.shape[1]]
        out = out + xs * w[k].to(x.dtype)
    return out + b.to(x.dtype)


def _conv_step(x_t, conv_state, w, b):
    """Single-token conv. x_t [B,C]; conv_state [B,K-1,C] (oldest first).
    Returns (out [B,C], the next conv state)."""
    win = torch.cat([conv_state, x_t[:, None]], dim=1)          # [B,K,C]
    out = torch.einsum("bkc,kc->bc", win, w.to(x_t.dtype)) + b.to(x_t.dtype)
    return out, win[:, 1:]


def _conv_tail(pre_conv, K):
    """The last K-1 pre-conv inputs (left zero-padded when S < K-1), as a
    copy: a slice would keep the whole in_proj output alive."""
    S = pre_conv.shape[1]
    if S >= K - 1:
        return pre_conv[:, S - (K - 1):].clone()
    return F.pad(pre_conv, (0, 0, K - 1 - S, 0))


def _pad_chunks(x, q):
    """Zero-pad axis 1 up to a multiple of ``q``. Returns (x, old length)."""
    s = x.shape[1]
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
    return x, s


def _linear_scan(a, b):
    """Inclusive scan along axis 1 of the recurrence h_t = a_t h_{t-1} +
    b_t, as the pairs (prod a, h from zero): the reference's
    ``associative_scan`` with ``(al, bl), (ar, br) -> (al ar, bl ar + br)``,
    in log2(Q) Hillis–Steele rounds."""
    Q, d = a.shape[1], 1
    while d < Q:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def _cumsum(x):
    """Inclusive prefix sum along axis 1 in log2(Q) Hillis–Steele rounds
    (elementwise adds, one order on every run)."""
    Q, d = x.shape[1], 1
    while d < Q:
        x = torch.cat([x[:, :d], x[:, :-d] + x[:, d:]], dim=1)
        d *= 2
    return x


def _chunks(n: int, q: int):
    return [slice(i, i + q) for i in range(0, n, q)]


# ------------------------------------------------------------ Mamba 1 -----

def mamba1_spec(cfg):
    d, s = cfg.d_model, cfg.ssm
    din = s.expand * d
    dtr = s.dt_rank or -(-d // 16)
    return {
        "norm": norm_spec(d),
        "in_proj": dense_spec((d, 2 * din), ("embed", "dinner")),
        "conv_w": ParamSpec((s.conv_dim, din), (None, "dinner"),
                            init="normal", scale=1.0 / np.sqrt(s.conv_dim)),
        "conv_b": ParamSpec((din,), ("dinner",), init="zeros"),
        "x_proj": dense_spec((din, dtr + 2 * s.state_dim), ("dinner", None)),
        "dt_proj": dense_spec((dtr, din), (None, "dinner"), fan_in=dtr),
        "dt_bias": ParamSpec((din,), ("dinner",), init="const", scale=-4.0),
        "A_log": ParamSpec((din, s.state_dim), ("dinner", None),
                           init="const", scale=0.5),
        "D": ParamSpec((din,), ("dinner",), init="ones"),
        "out_proj": dense_spec((din, d), ("dinner", "embed"), fan_in=din),
    }


def _mamba1_chunk(xq, dtq, bq, cq, h, A):
    """One chunk of the selective scan. xq, dtq [B,Q,din]; bq, cq [B,Q,N];
    h [B,din,N]. Returns (y [B,Q,din], the state after the chunk)."""
    a = torch.exp(dtq[..., None] * A)                # [B,Q,din,N], <= 1
    bx = (dtq * xq)[..., None] * bq[:, :, None, :]
    a_cum, b_scan = _linear_scan(a, bx)
    h_t = b_scan + a_cum * h[:, None]
    # a copy, so the carried state does not keep the chunk's h_t alive
    return torch.einsum("bqcn,bqn->bqc", h_t, cq), h_t[:, -1].clone()


def _mamba1_inner(cfg, p, x1, z, return_state=False, dbc=None):
    """Chunked selective scan. x1, z: [B,S,din] (x1 already conv+silu);
    ``dbc`` the x_proj output when the caller made it (row-parallel)."""
    s = cfg.ssm
    B, S, din = x1.shape
    N = s.state_dim
    dtr = s.dt_rank or -(-cfg.d_model // 16)

    if dbc is None:
        dbc = dot("bsc,cr->bsr", x1, p["x_proj"].to(x1.dtype))
    dt = F.softplus(
        dot("bsr,rc->bsc", dbc[..., :dtr],
            p["dt_proj"].to(x1.dtype)).float()
        + p["dt_bias"].float())                              # [B,S,din]
    Bc = dbc[..., dtr:dtr + N].float()                       # [B,S,N]
    Cc = dbc[..., dtr + N:].float()
    A = -torch.exp(p["A_log"].float())                       # [din,N]

    Q = s.chunk
    x32, _ = _pad_chunks(x1.float(), Q)
    dt, _ = _pad_chunks(dt, Q)
    Bc, _ = _pad_chunks(Bc, Q)
    Cc, _ = _pad_chunks(Cc, Q)
    # dt = 0 on padded steps => identity state update (a = 1, bx = 0), so
    # the carried final state is exact
    valid = (torch.arange(x32.shape[1], device=x1.device) < S).float()
    dt = dt * valid[None, :, None]

    h = x32.new_zeros((B, din, N))
    ys = []
    for c in _chunks(x32.shape[1], Q):
        y, h = recomputed(_mamba1_chunk, x32[:, c], dt[:, c], Bc[:, c],
                          Cc[:, c], h, A)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + x1.float() * p["D"].float()
    y = y * F.silu(z.float())
    if return_state:
        return y.to(x1.dtype), h
    return y.to(x1.dtype)


def mamba1_forward(cfg, p, x, return_cache=False, have=None, specs=None):
    """Full-sequence Mamba1 block (norm -> in_proj -> conv -> scan ->
    out_proj); the residual add is the caller's. ``return_cache`` also
    returns (the decode cache after the last token, its specs). ``x`` is
    laid out by ``have`` and ``specs`` holds the weights' "model" specs
    (both default to whole)."""
    return _forward(cfg, p, x, return_cache, have, specs, 1)


def mamba1_cache_spec(cfg, batch: int, dtype):
    s = cfg.ssm
    din = s.expand * cfg.d_model
    return {"conv": (torch.Size((batch, s.conv_dim - 1, din)), dtype),
            "ssm": (torch.Size((batch, din, s.state_dim)), torch.float32)}


def mamba1_cache_axes():
    """Logical axes of one Mamba1 layer's conv and SSM states."""
    return {"conv": ("batch", None, "dinner"), "ssm": ("batch", "dinner", None)}


def mamba1_decode(cfg, p, x, cache, have=None, specs=None, cspec=None):
    """x [B,1,d] -> (out [B,1,d], cache): one O(1) state update, written
    into ``cache`` in place (this rank's slice of it, laid out by
    ``cspec``; default: whole)."""
    return _decode(cfg, p, x, cache, have, specs, cspec, 1)


# ------------------------------------------------------------ Mamba 2 -----

def mamba2_spec(cfg):
    d, s = cfg.d_model, cfg.ssm
    din = s.expand * d
    nh = din // s.head_dim
    N = s.state_dim
    return {
        "norm": norm_spec(d),
        "in_proj": dense_spec((d, 2 * din + 2 * N + nh), ("embed", "dinner")),
        "conv_w": ParamSpec((s.conv_dim, din + 2 * N), (None, "dinner"),
                            init="normal", scale=1.0 / np.sqrt(s.conv_dim)),
        "conv_b": ParamSpec((din + 2 * N,), ("dinner",), init="zeros"),
        "A_log": ParamSpec((nh,), (None,), init="const", scale=0.5),
        "D": ParamSpec((nh,), (None,), init="ones"),
        "dt_bias": ParamSpec((nh,), (None,), init="const", scale=-4.0),
        "gate_norm": ParamSpec((din,), ("dinner",), init="ones"),
        "out_proj": dense_spec((din, d), ("dinner", "embed"), fan_in=din),
    }


def _ssd_chunk(xh, bq, cq, dtq, A, h_prev):
    """One SSD chunk. xh [B,Q,nh,p]; bq, cq [B,Q,N]; dtq [B,Q,nh]; A [nh];
    h_prev [B,nh,p,N]. Returns (y [B,Q,nh,p], h_next).

    The intra-chunk decay exp(cA_t - cA_s) is taken with the exponent
    masked to -inf above the diagonal BEFORE the exp. The reference
    exponentiates the whole Q x Q square and then zeroes the upper half:
    the same forward, but where cA_t - cA_s > 88 the exp overflows to inf
    and its gradient, 0 * inf, is NaN. Masked first, exp gives exactly 0
    there and the gradient 0."""
    dA = dtq * A                                     # [B,Q,nh], <= 0
    cA = _cumsum(dA)                                 # inclusive
    # intra-chunk: W[t,s] = C_t.B_s * exp(cA_t - cA_s) * dt_s   (t >= s)
    scores = torch.einsum("bqn,bsn->bqs", cq, bq)    # [B,Q,Q]
    ldiff = cA[:, :, None, :] - cA[:, None, :, :]    # [B,Q,Q,nh] t,s
    Q = dA.shape[1]
    upper = ~torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))
    L = torch.exp(ldiff.masked_fill(upper[None, :, :, None], -float("inf")))
    W = scores[..., None] * L * dtq[:, None, :, :]   # [B,Q(t),Q(s),nh]
    y_intra = torch.einsum("btsh,bshp->bthp", W, xh)
    # inter-chunk: contribution of the incoming state
    y_inter = torch.einsum("bqn,bhpn->bqhp", cq, h_prev) \
        * torch.exp(cA)[..., None]
    # state update: decay-to-chunk-end factor exp(cA[-1] - cA_s)
    decay_end = torch.exp(cA[:, -1:, :] - cA)        # [B,Q,nh]
    h_next = torch.exp(cA[:, -1])[:, :, None, None] * h_prev + \
        torch.einsum("bsn,bshp,bsh->bhpn", bq, xh, dtq * decay_end)
    return y_intra + y_inter, h_next


def _mamba2_inner(cfg, p, xbc, z, dt_raw, return_state=False, red=()):
    """SSD over the heads of ``dt_raw`` (all of them, or a rank's: then
    ``red`` names the axes the gated norm's mean of squares is summed
    over)."""
    s = cfg.ssm
    N = s.state_dim
    hp = s.head_dim
    nh = dt_raw.shape[-1]
    din = nh * hp
    B, S, _ = xbc.shape

    x = xbc[..., :din]
    Bc = xbc[..., din:din + N].float()
    Cc = xbc[..., din + N:].float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())      # [B,S,nh]
    A = -torch.exp(p["A_log"].float())                           # [nh]

    Q = s.chunk
    xh, _ = _pad_chunks(x.float().reshape(B, S, nh, hp), Q)
    Bc, _ = _pad_chunks(Bc, Q)
    Cc, _ = _pad_chunks(Cc, Q)
    dt, _ = _pad_chunks(dt, Q)
    # dt = 0 on padded steps => exp(0) = 1 decay, zero input: exact state
    valid = (torch.arange(xh.shape[1], device=xbc.device) < S).float()
    dt = dt * valid[None, :, None]

    h = xh.new_zeros((B, nh, hp, N))
    ys = []
    for c in _chunks(xh.shape[1], Q):
        y, h = recomputed(_ssd_chunk, xh[:, c], Bc[:, c], Cc[:, c],
                          dt[:, c], A, h)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + xh[:, :S] * p["D"].float()[:, None]
    y = y.reshape(B, S, din)
    y = y * F.silu(z.float())
    y = _gated_norm(cfg, y, p["gate_norm"], red)
    if return_state:
        return y, h
    return y


def mamba2_forward(cfg, p, x, return_cache=False, have=None, specs=None):
    """Full-sequence Mamba2 block; the residual add is the caller's.
    ``return_cache``, ``have``, ``specs``: as ``mamba1_forward``."""
    return _forward(cfg, p, x, return_cache, have, specs, 2)


def mamba2_cache_spec(cfg, batch: int, dtype):
    s = cfg.ssm
    din = s.expand * cfg.d_model
    nh = din // s.head_dim
    return {"conv": (torch.Size((batch, s.conv_dim - 1,
                                 din + 2 * s.state_dim)), dtype),
            "ssm": (torch.Size((batch, nh, s.head_dim, s.state_dim)),
                    torch.float32)}


def mamba2_cache_axes():
    """Logical axes of one Mamba2 layer's conv and SSM states."""
    return {"conv": ("batch", None, "dinner"),
            "ssm": ("batch", "act_heads", None, None)}


def mamba2_decode(cfg, p, x, cache, have=None, specs=None, cspec=None):
    """x [B,1,d] -> (out [B,1,d], cache): one O(1) SSD state update,
    written into ``cache`` in place (as ``mamba1_decode``)."""
    return _decode(cfg, p, x, cache, have, specs, cspec, 2)


def _gated_norm(cfg, y, gamma, red=()):
    """Mamba2's gated RMSNorm over d_inner in f32; with ``red`` the
    channels are a rank's block and the sum of squares is psummed over
    those axes."""
    if not red:
        return rms_norm(y, gamma, cfg.norm_eps, dtype=torch.float32)
    n = y.shape[-1]
    for a in red:
        n *= col.axis_size(a)
    var = col.psum(y.float().square().sum(dim=-1, keepdim=True), red) / n
    return y.float() * torch.rsqrt(var + cfg.norm_eps) * gamma.float()


# ------------------------------------------------------ the one body -----

def _block(axes, n: int):
    """(start, length) of this rank's block of ``n`` split over ``axes``."""
    size = n // n_ranks(axes)
    return linear_index(axes) * size, size


def _layouts(cfg, version, x_shape, have):
    """(channel axes of the conv input, heads axes): what the reference's
    "act_mlp" constraint and the cache's "act_heads" / "dinner" axes
    resolve to at the global shapes."""
    s = cfg.ssm
    din = s.expand * cfg.d_model
    B, S = global_shape(x_shape, have)[:2]
    width = din if version == 1 else din + 2 * s.state_dim
    cax = spec_axes(physical_spec(("batch", None, "act_mlp"),
                                  (B, S, width)), 3)[2]
    if version == 1:
        return cax, cax
    nh = din // s.head_dim
    hax = spec_axes(physical_spec(("batch", "act_heads", None, None),
                                  (B, nh, s.head_dim, s.state_dim)), 4)[1]
    return cax, hax


def _local_weights(cfg, p, specs, version, cax, hax):
    """The block's weights in the compute layout: ``in_proj`` gathered and
    cut into this rank's columns of each packed output, every per-channel
    (per-head) weight moved to the channel (head) layout."""
    s = cfg.ssm
    din = s.expand * cfg.d_model
    N = s.state_dim
    w_in = relayout(p["in_proj"], specs.get("in_proj"), (None, None))
    out = {"norm": p["norm"]}

    def lay(name, dim, axes):
        w = p[name]
        want = [None] * w.ndim
        want[dim] = axes or None
        out[name] = relayout(w, specs.get(name), tuple(want))

    if version == 1:
        c0, n = _block(cax, din)
        out["in_x"] = w_in[:, c0:c0 + n]
        out["in_z"] = w_in[:, din + c0:din + c0 + n]
        for name, dim in (("conv_w", 1), ("conv_b", 0), ("x_proj", 0),
                          ("dt_proj", 1), ("dt_bias", 0), ("A_log", 0),
                          ("D", 0), ("out_proj", 0)):
            lay(name, dim, cax)
        return out
    nh = din // s.head_dim
    h0, nhl = _block(hax, nh)
    c0, n = h0 * s.head_dim, nhl * s.head_dim
    b0, nb = _block(cax, din + 2 * N)
    out["in_z"] = w_in[:, c0:c0 + n]
    out["in_xbc"] = w_in[:, din + b0:din + b0 + nb]
    out["in_dt"] = w_in[:, 2 * din + 2 * N + h0:2 * din + 2 * N + h0 + nhl]
    for name, dim, axes in (("conv_w", 1, cax), ("conv_b", 0, cax),
                            ("A_log", 0, hax), ("D", 0, hax),
                            ("dt_bias", 0, hax), ("gate_norm", 0, hax),
                            ("out_proj", 0, hax)):
        lay(name, dim, axes)
    out["x_cols"] = (c0, n)
    return out


def _split_heads(cfg, xbc, c0, n):
    """This rank's heads' x and the whole B, C of a gathered conv output
    (the output itself where the rank holds every head)."""
    din = cfg.ssm.expand * cfg.d_model
    N = cfg.ssm.state_dim
    if c0 == 0 and n == din:
        return xbc
    return torch.cat([xbc[..., c0:c0 + n], xbc[..., din:din + 2 * N]],
                     dim=-1)


def _forward(cfg, p, x, return_cache, have, specs, version):
    """A Mamba block's forward on the local tensors (whole without a
    mesh)."""
    have, specs = have or (None, None, None), specs or {}
    xb = have[0]
    rows = (xb, None, None)
    x = relayout(x, have, rows)                  # the whole sequence
    cax, hax = _layouts(cfg, version, x.shape, rows)
    w = _local_weights(cfg, p, specs, version, cax, hax)
    h = rms_norm(x, w["norm"], cfg.norm_eps)
    z = dot("bsd,dc->bsc", h, w["in_z"].to(x.dtype))
    pre = dot("bsd,dc->bsc", h, w["in_x" if version == 1
                                  else "in_xbc"].to(x.dtype))
    pre, ps = constrain_spec(pre, ("batch", None, "act_mlp"),
                             have=(xb, None, cax or None))
    conv = F.silu(_causal_conv(pre, w["conv_w"], w["conv_b"]))
    if version == 1:
        dbc = row_parallel("bsc,cr->bsr", conv, w["x_proj"], cax,
                           conv.dtype)
        res = _mamba1_inner(cfg, w, conv, z, return_state=return_cache,
                            dbc=dbc)
        red = cax
    else:
        dt_raw = dot("bsd,dc->bsc", h, w["in_dt"].to(x.dtype))
        xbc = relayout(conv, ps, rows)
        xbc = _split_heads(cfg, xbc, *w["x_cols"])
        res = _mamba2_inner(cfg, w, xbc, z, dt_raw,
                            return_state=return_cache, red=hax)
        red = hax
    y, hst = res if return_cache else (res, None)
    out = row_parallel("bsc,cd->bsd", y.to(x.dtype), w["out_proj"], red,
                       x.dtype)
    out = relayout(out, rows, have)
    if not return_cache:
        return out
    tail = _conv_tail(pre, cfg.ssm.conv_dim)
    ssm_have = (xb, red or None, None) if version == 1 else \
        (xb, hax or None, None, None)
    return out, ({"conv": tail, "ssm": hst},
                 {"conv": (xb, None, cax or None), "ssm": ssm_have})


def _decode(cfg, p, x, cache, have, specs, cspec, version):
    """One token on the local tensors: the caches' layouts (``cspec``)
    fix the channel and head blocks."""
    have, specs, cspec = have or (None, None, None), specs or {}, cspec or {}
    s = cfg.ssm
    N = s.state_dim
    cb, _, cax = spec_axes(cspec.get("conv"), 3)
    hax = spec_axes(cspec.get("ssm"), cache["ssm"].ndim)[1]
    rows = (cb or None, None, None)
    xb = have[0]
    x = relayout(x, have, rows)
    w = _local_weights(cfg, p, specs, version, cax, hax)
    h = rms_norm(x, w["norm"], cfg.norm_eps)[:, 0]
    z = torch.einsum("bd,dc->bc", h, w["in_z"].to(x.dtype))
    pre = torch.einsum("bd,dc->bc", h, w["in_x" if version == 1
                                         else "in_xbc"].to(x.dtype))
    conv, conv_state = _conv_step(pre, cache["conv"].to(pre.dtype),
                                  w["conv_w"], w["conv_b"])
    conv = F.silu(conv)
    if version == 1:
        dtr = s.dt_rank or -(-cfg.d_model // 16)
        dbc = row_parallel("bc,cr->br", conv, w["x_proj"], cax, conv.dtype)
        dt = F.softplus(
            torch.einsum("br,rc->bc", dbc[..., :dtr],
                         w["dt_proj"].to(conv.dtype)).float()
            + w["dt_bias"].float())
        Bc = dbc[..., dtr:dtr + N].float()
        Cc = dbc[..., dtr + N:].float()
        A = -torch.exp(w["A_log"].float())
        hst = torch.exp(dt[..., None] * A) * cache["ssm"] \
            + (dt * conv.float())[..., None] * Bc[:, None, :]
        y = torch.einsum("bcn,bn->bc", hst, Cc) + conv.float() * \
            w["D"].float()
        y = y * F.silu(z.float())
        red = cax
    else:
        xbc = relayout(conv, (cb or None, cax or None), (cb or None, None))
        c0, n = w["x_cols"]
        nhl = n // s.head_dim
        x1 = xbc[..., c0:c0 + n].float().reshape(-1, nhl, s.head_dim)
        din = s.expand * cfg.d_model
        Bc = xbc[..., din:din + N].float()
        Cc = xbc[..., din + N:din + 2 * N].float()
        dt_raw = torch.einsum("bd,dc->bc", h, w["in_dt"].to(x.dtype))
        dt = F.softplus(dt_raw.float() + w["dt_bias"].float())
        A = -torch.exp(w["A_log"].float())
        hst = torch.exp(dt * A)[:, :, None, None] * cache["ssm"] \
            + torch.einsum("bn,bhp,bh->bhpn", Bc, x1, dt)
        y = torch.einsum("bhpn,bn->bhp", hst, Cc) \
            + x1 * w["D"].float()[:, None]
        y = y.reshape(-1, n) * F.silu(z.float())
        y = _gated_norm(cfg, y, w["gate_norm"], hax)
        red = hax
    out = row_parallel("bc,cd->bd", y.to(x.dtype), w["out_proj"], red,
                       x.dtype)
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(hst)
    return relayout(out[:, None], rows, (xb, None, None)), cache
