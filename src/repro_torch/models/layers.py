"""Shared layers: RMSNorm, RoPE, activations, embeddings, spec helpers.

Plain tensor functions mirroring the reference package's layers; the
compute dtype follows the inputs exactly as there (bf16 activations, f32
normalization and rope arithmetic)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec


def dense_spec(shape, axes, fan_in=None, scale=1.0):
    """ParamSpec for a projection with 1/sqrt(fan_in) init."""
    if fan_in is None:
        fan_in = shape[0]
    return ParamSpec(shape, axes, init="normal",
                     scale=scale / max(fan_in, 1) ** 0.5)


def norm_spec(dim):
    return ParamSpec((dim,), (None,), init="ones")


def rms_norm(x, gamma, eps=1e-5, dtype=None):
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * gamma.float()).to(dtype or dt)


def _gelu_tanh(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    if name == "swiglu" or name == "silu":
        return F.silu
    if name == "geglu" or name == "gelu":
        return _gelu_tanh
    if name == "relu2":
        return lambda x: F.relu(x).square()
    if name == "relu":
        return F.relu
    raise ValueError(name)


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


# ------------------------------------------------------------- recompute --

class _Recomputed(torch.autograd.Function):
    """``fn(*inputs, **kw)`` whose backward recomputes ``fn`` instead of
    keeping its intermediates; only its inputs stay saved.
    (``torch.utils.checkpoint`` does the same but keeps the caller's frames,
    a train step's whole state among them, in a reference cycle until the
    garbage collector runs.)"""

    @staticmethod
    def forward(ctx, fn, kw, *inputs):
        ctx.fn, ctx.kw = fn, kw
        ctx.save_for_backward(*inputs)
        return fn(*inputs, **kw)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        wrt = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            outs = ctx.fn(*inputs, **ctx.kw)
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
        return (None, None, *[next(got) if x.requires_grad else None
                              for x in inputs])


def recomputed(fn, *inputs, **kw):
    """``fn(*inputs, **kw)`` (tensors in, a tuple of tensors out), with the
    backward pass recomputing ``fn`` from the saved inputs: the reference's
    ``jax.checkpoint`` of a scan body, one chunk at a time."""
    if torch.is_grad_enabled():
        return _Recomputed.apply(fn, kw, *inputs)
    return fn(*inputs, **kw)


# ---------------------------------------------------------------- RoPE ----

def rope_freqs(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0
                            / head_dim))


def rope_tables(S: int, head_dim: int, theta: float, device):
    """cos/sin tables [S, half] (f32), computed once per forward."""
    freqs = torch.from_numpy(rope_freqs(head_dim, theta)).to(device)
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, tables):
    """x: [B, S, heads..., head_dim]; tables (cos, sin) [S, half]. Rotates
    pairs (x[..., :half], x[..., half:]) — the 'split-half' convention."""
    cos, sin = tables
    for _ in range(x.ndim - 3):                 # align over the head axes
        cos, sin = cos[..., None, :], sin[..., None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------- embedding ----

def embedding_spec(cfg, padded_vocab: int):
    return {
        "table": ParamSpec((padded_vocab, cfg.d_model), ("vocab", "embed"),
                           init="normal", scale=0.02),
    }


def padded_vocab_size(vocab: int, multiple: int = 512) -> int:
    return -(-vocab // multiple) * multiple


def embed_tokens(cfg, table, tokens, compute_dtype):
    # F.embedding, not table[tokens]: the backward of plain indexing adds
    # repeated tokens' rows with atomics on a multithreaded CPU, so a step
    # would not give the same bits twice; embedding's backward sums each
    # row's gradients in one order on the CPU and on the card
    x = F.embedding(tokens.long(), table).to(compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=compute_dtype,
                             device=x.device)
    return x


def lm_logits(cfg, params, x, padded_vocab: int):
    """Final logits. Uses tied embedding transpose or a separate unembed."""
    if cfg.tie_embeddings:
        w = params["embed"]["table"]
        logits = torch.einsum("bsd,vd->bsv", x, w.to(x.dtype))
    else:
        w = params["unembed"]["table"]
        logits = torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    # mask padded vocab entries out of the softmax
    if padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(padded_vocab, device=x.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad_mask, -1e9)
    return logits


def unembed_spec(cfg, padded_vocab: int):
    return {"table": dense_spec((cfg.d_model, padded_vocab),
                                ("embed", "vocab"), fan_in=cfg.d_model)}


# ----------------------------------------------------------------- MLP ----

def mlp_spec(cfg, d_ff: int, d_model=None):
    d = d_model or cfg.d_model
    fax = "mlp" if cfg.dense_layout == "tp" else None
    spec = {
        "wi": dense_spec((d, d_ff), ("embed", fax)),
        "wo": dense_spec((d_ff, d), (fax, "embed"), fan_in=d_ff),
    }
    if is_gated(cfg.ffn_activation):
        spec["wg"] = dense_spec((d, d_ff), ("embed", fax))
    return spec


def mlp_apply(cfg, p, x):
    act = activation(cfg.ffn_activation)
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(x.dtype))
    if is_gated(cfg.ffn_activation):
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(x.dtype))
        h = act(g) * h
    else:
        h = act(h)
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(x.dtype))
