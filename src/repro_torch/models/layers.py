"""Shared layers: RMSNorm, RoPE, activations, embeddings, spec helpers.

Plain tensor functions mirroring the reference package's layers; the
compute dtype follows the inputs exactly as there (bf16 activations, f32
normalization and rope arithmetic).

The same functions run on local tensors under a mesh
(``parallel.sharding.use_mesh``) and on whole ones without: a caller
passes each activation's layout (``have``, a spec; default: whole) and
each weight's remaining spec after its FSDP gather (only "model" entries
are left: ``sharding.model_spec``; default: whole). A weight sharded on "model"
makes its matmul column-parallel (the output stays sharded) or
row-parallel (partial sums in f32, psummed over "model"); the embedding and
the logits are vocab-parallel. The reference's ``constrain`` calls sit at
the same places."""
from __future__ import annotations

import collections
import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.params import ParamSpec
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import (constrain_spec, layout_state,
                                           relayout, spec_axes, use_mesh)


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


# -------------------------------------------------------------- caches --
# A decode cache spec is a nested dict of (torch.Size, dtype) leaves; a
# stack of layers carries a leading layer axis, as the parameters do.

def stack_cache_spec(spec, n: int):
    """``spec`` with a leading layer axis of length ``n``."""
    if isinstance(spec, dict):
        return {k: stack_cache_spec(v, n) for k, v in spec.items()}
    shape, dtype = spec
    return torch.Size((n, *shape)), dtype


def cache_from_spec(spec, device, name: str = ""):
    """An empty cache of ``spec``'s shapes: ``slot_pos`` leaves hold -1 (no
    position), every other leaf zeros."""
    if isinstance(spec, dict):
        return {k: cache_from_spec(v, device, k) for k, v in spec.items()}
    shape, dtype = spec
    return torch.full(shape, -1 if name == "slot_pos" else 0, dtype=dtype,
                      device=device)


def write_layer(stack, i, cache):
    """Copy one layer's ``cache`` into row ``i`` of a stacked cache."""
    for k, v in cache.items():
        stack[k][i].copy_(v)


# ------------------------------------------------------------- recompute --

def batch_free(eq: str) -> bool:
    """Whether the two-operand einsum ``eq`` is a matmul with no batch
    dimension in the sense of jax's ``dot_general``: no letter is held by
    both operands and the output (``bsd,df->bsf`` is one, attention's
    ``bhqd,bhkd->bhqk`` and MoE's ``ecd,edf->ecf`` are not)."""
    ins, out = eq.replace(" ", "").split("->")
    a, b = ins.split(",")
    return not set(a) & set(b) & set(out)


class _Dots(threading.local):
    def __init__(self):
        self.saved = None       # the "dots" recompute running here, if any
        self.replay = False


_DOTS = _Dots()


class _KeepMatmul(TorchDispatchMode):
    """Inside one batch-free ``dot`` of a "dots" recompute (an einsum of
    two operands, which lowers to one ``bmm``): the forward keeps the
    matmul's output; the backward's recompute takes that output back in
    the same order instead of multiplying again. Autograd still records
    the matmul, so its backward is the one a plain call has."""

    def __init__(self, saved, replay):
        super().__init__()
        self.saved, self.replay = saved, replay

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket not in (torch.ops.aten.bmm,
                                       torch.ops.aten.mm):
            return func(*args, **(kwargs or {}))
        if self.replay:
            return self.saved.popleft().detach()
        out = func(*args, **(kwargs or {}))
        self.saved.append(out)
        return out


def dot(eq: str, a, b):
    """``torch.einsum(eq, a, b)``: the models' matmul. Inside a layer
    recomputed under ``remat_policy="dots"`` a batch-free one
    (``batch_free``) is the reference's saveable dot: its output is kept
    from the forward and not computed again by the recompute."""
    if _DOTS.saved is None or not batch_free(eq):
        return torch.einsum(eq, a, b)
    with _KeepMatmul(_DOTS.saved, _DOTS.replay):
        return torch.einsum(eq, a, b)


@contextlib.contextmanager
def _dots_scope(saved, replay: bool):
    """Install ``saved`` (a deque, or None: leave the enclosing scope as
    it is) as the running "dots" recompute's store."""
    prev = (_DOTS.saved, _DOTS.replay)
    if saved is not None:
        _DOTS.saved, _DOTS.replay = saved, replay
    try:
        yield
    finally:
        _DOTS.saved, _DOTS.replay = prev


class _Recomputed(torch.autograd.Function):
    """``fn(*inputs, **kw)`` whose backward recomputes ``fn`` instead of
    keeping its intermediates; only its inputs stay saved (and, with
    ``dots``, the outputs of its batch-free matmuls).
    (``torch.utils.checkpoint`` does the same but keeps the caller's frames,
    a train step's whole state among them, in a reference cycle until the
    garbage collector runs.) The backward reinstalls the forward's mesh:
    on the card it runs on autograd's own thread. An output the recompute
    gives no gradient path (a MoE layer's drop fraction) is left out of
    the backward's ``torch.autograd.grad``."""

    @staticmethod
    def forward(ctx, fn, kw, dots, *inputs):
        ctx.fn, ctx.kw, ctx.layout = fn, kw, layout_state()
        ctx.dots = collections.deque() if dots else None
        ctx.save_for_backward(*inputs)
        with _dots_scope(ctx.dots, replay=False):
            return fn(*inputs, **kw)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[3:])]
        wrt = [x for x in inputs if x.requires_grad]
        with torch.enable_grad(), use_mesh(*ctx.layout):
            with _dots_scope(ctx.dots, replay=True):
                outs = ctx.fn(*inputs, **ctx.kw)
            ctx.dots = None
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                           [g for _, g in pairs],
                                           allow_unused=True))
        return (None, None, None, *[next(got) if x.requires_grad else None
                                    for x in inputs])


def recomputed(fn, *inputs, dots: bool = False, **kw):
    """``fn(*inputs, **kw)`` (tensors in, a tuple of tensors out), with the
    backward pass recomputing ``fn`` from the saved inputs: the reference's
    ``jax.checkpoint`` of a scan body, one chunk at a time, or of a layer
    (``dots``: its policy ``checkpoint_dots_with_no_batch_dims``)."""
    if torch.is_grad_enabled():
        return _Recomputed.apply(fn, kw, dots, *inputs)
    return fn(*inputs, **kw)


# ---------------------------------------------------------------- RoPE ----

def rope_freqs(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0
                            / head_dim))


_FREQS: dict = {}


def _device_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """``rope_freqs`` on ``device``, copied there once per (head_dim,
    theta, device): a copy from pageable host memory waits for the stream,
    which would stall every decode step."""
    key = (head_dim, float(theta), torch.device(device))
    if key not in _FREQS:
        with torch.inference_mode(False):      # a plain tensor, usable anywhere
            _FREQS[key] = torch.from_numpy(
                rope_freqs(head_dim, theta)).to(device)
    return _FREQS[key]


def rope_tables(S: int, head_dim: int, theta: float, device, start: int = 0):
    """cos/sin tables [S, half] (f32) of positions start .. start+S-1,
    computed once per forward (a decode step's one row at its position)."""
    freqs = _device_freqs(head_dim, theta, device)
    ang = torch.arange(start, start + S, dtype=torch.float32,
                       device=device)[:, None] * freqs
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


def batch_axis(cfg) -> str:
    return "batch_dp3" if cfg.dense_layout == "dp" else "batch"


def _vocab_axes(w_spec, vdim: int, x_have) -> tuple:
    """The axes a (gathered) vocab weight stays sharded on for a
    vocab-parallel matmul: none where the batch already uses them."""
    vax = spec_axes(w_spec, 2)[vdim]
    return () if set(vax) & set(spec_axes(x_have, 1)[0]) else vax


def embed_tokens(cfg, table, tokens, compute_dtype, have=None,
                 table_spec=()):
    """Token embeddings: (embeddings, their spec). ``tokens`` is laid out
    by ``have`` (default: whole) and ``table`` by ``table_spec`` (default:
    whole): a vocab-sharded table looks up its own rows (the others are
    zero) and psums over the vocab axes — one nonzero term per token, so
    the sum is exact."""
    # F.embedding, not table[tokens]: the backward of plain indexing adds
    # repeated tokens' rows with atomics on a multithreaded CPU, so a step
    # would not give the same bits twice; embedding's backward sums each
    # row's gradients in one order on the CPU and on the card
    tokens = tokens.long()
    have = have or (None, None)
    vax = _vocab_axes(table_spec, 0, have)
    table = relayout(table, table_spec, (vax or None, None))
    if vax:
        rows = table.shape[0]
        local = tokens - col.axis_index(vax[0]) * rows
        mine = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), table) * mine[..., None]
        x = col.psum(x, vax)
    else:
        x = F.embedding(tokens, table)
    x = x.to(compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=compute_dtype,
                             device=x.device)
    return constrain_spec(x, (batch_axis(cfg), None, None),
                          have=(have[0], None, None))


def lm_logits(cfg, params, x, padded_vocab: int, have=None, specs=None):
    """Final logits: (logits, their spec). Uses tied embedding transpose or
    a separate unembed. ``x`` is laid out by ``have`` (default: whole) and
    ``specs`` holds the parameters' specs (default: whole); the logits are
    vocab-parallel where the weight's vocab dim stays sharded."""
    tied = cfg.tie_embeddings
    w = params["embed"]["table"] if tied else params["unembed"]["table"]
    have = have or (None, None, None)
    v0 = 0
    w_spec = () if specs is None else \
        specs["embed" if tied else "unembed"]["table"]
    vdim = 0 if tied else 1
    vax = _vocab_axes(w_spec, vdim, have)
    keep = [None, None]
    keep[vdim] = vax or None
    w = relayout(w, w_spec, tuple(keep))
    if vax:
        v0 = col.axis_index(vax[0]) * w.shape[vdim]
    if tied:
        logits = torch.einsum("bsd,vd->bsv", x, w.to(x.dtype))
    else:
        logits = torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    # mask padded vocab entries out of the softmax
    if padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(v0, v0 + logits.shape[-1],
                                device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad_mask, -1e9)
    return constrain_spec(logits, (batch_axis(cfg), None, "act_vocab"),
                          have=(have[0], None, vax or None))


def gathered_logits_weight(cfg, params, specs, have):
    """(params, specs) with the logits' weight moved once to the layout
    ``lm_logits`` computes in (FSDP-gathered, its vocab dim left on the
    axes the batch does not use): a loss over several sequence chunks
    then gathers it once, and its gradient is reduce-scattered once."""
    group, vdim = ("embed", 0) if cfg.tie_embeddings else ("unembed", 1)
    w_spec = specs.get(group, {}).get("table")
    keep = [None, None]
    keep[vdim] = _vocab_axes(w_spec, vdim, have) or None
    keep = tuple(keep)
    w = relayout(params[group]["table"], w_spec, keep)
    return ({**params, group: {**params[group], "table": w}},
            {**specs, group: {**specs.get(group, {}), "table": keep}})


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


def row_parallel(eq, h, w, axes, dtype, scatter=None):
    """``einsum(eq, h, w)`` contracting a dim both operands hold sharded
    over ``axes``: partial sums in f32, psummed, then ``dtype`` (one
    rounding, as the unsharded matmul's). ``scatter`` = (dim, axes): the
    sum reduce-scattered over those axes (the same as ``axes``) along
    ``dim`` instead — each rank keeps its block of the sum."""
    if not axes:
        return dot(eq, h, w.to(h.dtype))
    part = dot(eq, h.float(), w.float())
    if scatter is not None:
        dim, sax = scatter
        for a in sax:
            part = col.psum_scatter(part, a, dim)
        return part.to(dtype)
    return col.psum(part, axes).to(dtype)


def mlp_apply(cfg, p, x, have=None, specs=None):
    """The MLP. ``x`` is laid out by ``have`` (default: whole; replicated
    over "model" unless the batch or, with sequence parallelism, the
    sequence uses it) and ``specs`` holds the weights' "model" specs
    (default: whole): column-parallel in over "mlp", row-parallel out; the
    output keeps ``x``'s layout (a sequence-sharded input is all-gathered
    in and its output's partial sums reduce-scattered back)."""
    act = activation(cfg.ffn_activation)
    have = have or (None, None, None)
    specs = specs or {}
    sax = spec_axes(have, 3)[1]
    if sax:           # sequence parallel: the whole sequence in
        x = relayout(x, have, (have[0], None, None))
    h = dot("bsd,df->bsf", x, p["wi"].to(x.dtype))
    if is_gated(cfg.ffn_activation):
        g = dot("bsd,df->bsf", x, p["wg"].to(x.dtype))
        h = act(g) * h
    else:
        h = act(h)
    fax = spec_axes(specs.get("wi"), 2)[1]
    h, hs = constrain_spec(h, (batch_axis(cfg), None, "act_mlp"),
                           have=(have[0], None, fax or None))
    wo_f = spec_axes(specs.get("wo"), 2)[0]
    h = relayout(h, hs, (hs[0], None, wo_f or None))
    scatter = (1, sax) if sax and tuple(wo_f) == tuple(sax) else None
    y = row_parallel("bsf,fd->bsd", h, p["wo"], wo_f, x.dtype,
                     scatter=scatter)
    return relayout(y, (hs[0], sax if scatter else None, None), have)
