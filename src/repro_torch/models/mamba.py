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
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_spec, norm_spec, recomputed,
                                       rms_norm)
from repro_torch.models.params import ParamSpec
from repro_torch.parallel.sharding import constrain


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


def _mamba1_inner(cfg, p, x1, z, return_state=False):
    """Chunked selective scan. x1, z: [B,S,din] (x1 already conv+silu)."""
    s = cfg.ssm
    B, S, din = x1.shape
    N = s.state_dim
    dtr = s.dt_rank or -(-cfg.d_model // 16)

    dbc = torch.einsum("bsc,cr->bsr", x1, p["x_proj"].to(x1.dtype))
    dt = F.softplus(
        torch.einsum("bsr,rc->bsc", dbc[..., :dtr],
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


def mamba1_forward(cfg, p, x, return_cache=False):
    """Full-sequence Mamba1 block (norm -> in_proj -> conv -> scan ->
    out_proj); the residual add is the caller's. ``return_cache`` also
    returns the decode cache after the last token."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    xz = torch.einsum("bsd,dc->bsc", h, p["in_proj"].to(x.dtype))
    din = xz.shape[-1] // 2
    pre_conv, z = xz[..., :din], xz[..., din:]
    # the reference's constraint: under a mesh it raises (next slice)
    pre_conv = constrain(pre_conv, ("batch", None, "act_mlp"))
    x1 = F.silu(_causal_conv(pre_conv, p["conv_w"], p["conv_b"]))
    if return_cache:
        y, hst = _mamba1_inner(cfg, p, x1, z, return_state=True)
        out = torch.einsum("bsc,cd->bsd", y, p["out_proj"].to(x.dtype))
        return out, {"conv": _conv_tail(pre_conv, cfg.ssm.conv_dim),
                     "ssm": hst}
    y = _mamba1_inner(cfg, p, x1, z)
    return torch.einsum("bsc,cd->bsd", y, p["out_proj"].to(x.dtype))


def mamba1_cache_spec(cfg, batch: int, dtype):
    s = cfg.ssm
    din = s.expand * cfg.d_model
    return {"conv": (torch.Size((batch, s.conv_dim - 1, din)), dtype),
            "ssm": (torch.Size((batch, din, s.state_dim)), torch.float32)}


def mamba1_cache_axes():
    """Logical axes of one Mamba1 layer's conv and SSM states."""
    return {"conv": ("batch", None, "dinner"), "ssm": ("batch", "dinner", None)}


def mamba1_decode(cfg, p, x, cache):
    """x [B,1,d] -> (out [B,1,d], cache): one O(1) state update, written
    into ``cache`` in place."""
    s = cfg.ssm
    N = s.state_dim
    dtr = s.dt_rank or -(-cfg.d_model // 16)
    h = rms_norm(x, p["norm"], cfg.norm_eps)[:, 0]               # [B,d]
    xz = torch.einsum("bd,dc->bc", h, p["in_proj"].to(x.dtype))
    din = xz.shape[-1] // 2
    x1, z = xz[..., :din], xz[..., din:]
    x1, conv_state = _conv_step(x1, cache["conv"].to(x1.dtype),
                                p["conv_w"], p["conv_b"])
    x1 = F.silu(x1)
    dbc = torch.einsum("bc,cr->br", x1, p["x_proj"].to(x1.dtype))
    dt = F.softplus(
        torch.einsum("br,rc->bc", dbc[..., :dtr],
                     p["dt_proj"].to(x1.dtype)).float()
        + p["dt_bias"].float())                                  # [B,din]
    Bc = dbc[..., dtr:dtr + N].float()
    Cc = dbc[..., dtr + N:].float()
    A = -torch.exp(p["A_log"].float())
    hst = torch.exp(dt[..., None] * A) * cache["ssm"] \
        + (dt * x1.float())[..., None] * Bc[:, None, :]
    y = torch.einsum("bcn,bn->bc", hst, Cc) + x1.float() * p["D"].float()
    y = y * F.silu(z.float())
    out = torch.einsum("bc,cd->bd", y.to(x.dtype), p["out_proj"].to(x.dtype))
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(hst)
    return out[:, None], cache


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


def _mamba2_split(cfg, zxbcdt):
    s = cfg.ssm
    din = s.expand * cfg.d_model
    N = s.state_dim
    nh = din // s.head_dim
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * N]
    dt = zxbcdt[..., din + din + 2 * N:]
    assert dt.shape[-1] == nh
    return z, xbc, dt


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


def _mamba2_inner(cfg, p, xbc, z, dt_raw, return_state=False):
    s = cfg.ssm
    din = s.expand * cfg.d_model
    N = s.state_dim
    nh = din // s.head_dim
    hp = s.head_dim
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
    y = rms_norm(y, p["gate_norm"], cfg.norm_eps, dtype=torch.float32)
    if return_state:
        return y, h
    return y


def mamba2_forward(cfg, p, x, return_cache=False):
    """Full-sequence Mamba2 block; the residual add is the caller's.
    ``return_cache`` also returns the decode cache after the last token."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    zxbcdt = torch.einsum("bsd,dc->bsc", h, p["in_proj"].to(x.dtype))
    z, pre_conv, dt = _mamba2_split(cfg, zxbcdt)
    # the reference's constraint: under a mesh it raises (next slice)
    pre_conv = constrain(pre_conv, ("batch", None, "act_mlp"))
    xbc = F.silu(_causal_conv(pre_conv, p["conv_w"], p["conv_b"]))
    if return_cache:
        y, hst = _mamba2_inner(cfg, p, xbc, z, dt, return_state=True)
        out = torch.einsum("bsc,cd->bsd", y.to(x.dtype),
                           p["out_proj"].to(x.dtype))
        return out, {"conv": _conv_tail(pre_conv, cfg.ssm.conv_dim),
                     "ssm": hst}
    y = _mamba2_inner(cfg, p, xbc, z, dt)
    return torch.einsum("bsc,cd->bsd", y.to(x.dtype),
                        p["out_proj"].to(x.dtype))


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


def mamba2_decode(cfg, p, x, cache):
    """x [B,1,d] -> (out [B,1,d], cache): one O(1) SSD state update,
    written into ``cache`` in place."""
    s = cfg.ssm
    din = s.expand * cfg.d_model
    N = s.state_dim
    nh = din // s.head_dim
    h = rms_norm(x, p["norm"], cfg.norm_eps)[:, 0]
    zxbcdt = torch.einsum("bd,dc->bc", h, p["in_proj"].to(x.dtype))
    z, xbc, dt_raw = _mamba2_split(cfg, zxbcdt)
    xbc, conv_state = _conv_step(xbc, cache["conv"].to(xbc.dtype),
                                 p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc)
    x1 = xbc[..., :din].float().reshape(-1, nh, s.head_dim)
    Bc = xbc[..., din:din + N].float()
    Cc = xbc[..., din + N:].float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())       # [B,nh]
    A = -torch.exp(p["A_log"].float())
    hst = torch.exp(dt * A)[:, :, None, None] * cache["ssm"] \
        + torch.einsum("bn,bhp,bh->bhpn", Bc, x1, dt)
    y = torch.einsum("bhpn,bn->bhp", hst, Cc) \
        + x1 * p["D"].float()[:, None]
    y = y.reshape(-1, din) * F.silu(z.float())
    y = rms_norm(y, p["gate_norm"], cfg.norm_eps, dtype=torch.float32)
    out = torch.einsum("bc,cd->bd", y.to(x.dtype), p["out_proj"].to(x.dtype))
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(hst)
    return out[:, None], cache
