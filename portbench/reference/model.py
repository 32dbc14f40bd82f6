"""Plain reference of the decoder LMs the benchmark trains, with its step.

What it computes, from a configuration file's published keys alone:

* the dense block: RMSNorm, grouped-query attention with split-half RoPE
  (causal, and a sliding window where the configuration gives one), RMSNorm,
  SwiGLU MLP, each with its residual;
* Mixtral's sparse block: a softmax router, the top-k experts renormalised,
  each expert's capacity max(ceil(k * T / E * capacity_factor), 4) with the
  choices kept in (token, rank) order and the rest dropped, the Switch
  load-balance loss E * sum_e f_e * P_e on each token's first choice. Given
  the choices of each layer (``routes``), the block follows them in place
  of its own top-k, its gates, drops and router loss taken from them, and
  reads how far they fall short of its own (``moe``'s route gap);
* the next-token cross-entropy over the padded vocabulary (padded entries
  masked), plus the router loss times its coefficient;
* AdamW (b1 0.9, b2 0.95, eps 1e-8, decay 0.1 on leaves of two or more
  dimensions) after global-norm clipping at 1.0, with the warmup-cosine rate
  of peak 3e-4, 100 warmup steps, 10 000 in all.

The parameters are a nested dict in the layout that ``param_layout`` gives:
layers stacked on a leading axis, as the program stores them, so one set of
tensors made by the benchmark feeds both sides. Plain PyTorch in float32
with TF32 off; it imports nothing of the program. ``precision="float8"`` is
the control: every matrix product takes its two operands rounded to
float8 e4m3 (a per-tensor scale), the step a later change could be tempted
to take below the configuration's bfloat16. Each layer and each block of the
loss is recomputed in the backward pass, so the full-size step fits the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.1
PEAK_LR, WARMUP, TOTAL_STEPS, FINAL_FRAC, GRAD_CLIP = 3e-4, 100, 10000, 0.1, 1.0
VOCAB_MULTIPLE = 512
NEG = -1e9                     # the mask value of a padded vocabulary entry
E4M3_MAX = 448.0


def dims(conf: dict) -> dict:
    """The sizes the equations need, from a configuration file's keys."""
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    V = conf["vocab_size"]
    out = {
        "d": d, "H": H, "KV": conf["num_key_value_heads"],
        "hd": conf.get("head_dim") or d // H,
        "f": conf["intermediate_size"], "L": conf["num_hidden_layers"],
        "V": V, "Vp": V if V < VOCAB_MULTIPLE
        else -(-V // VOCAB_MULTIPLE) * VOCAB_MULTIPLE,
        "theta": float(conf["rope_theta"]), "eps": float(conf["rms_norm_eps"]),
        "window": conf.get("sliding_window"),
        "tied": bool(conf["tie_word_embeddings"]),
        "E": conf.get("num_local_experts") or 0,
        "k": conf.get("num_experts_per_tok") or 0,
        "aux_coef": float(conf.get("router_aux_loss_coef") or 0.0),
        "capacity_factor": float(conf["run"].get("capacity_factor", 1.25)),
    }
    if conf["hidden_act"] != "silu":
        raise ValueError(f"only SwiGLU blocks: hidden_act {conf['hidden_act']}")
    return out


def param_layout(conf: dict) -> dict:
    """Nested dict of (shape, init) leaves: init is ("normal", std) or
    ("ones",). Stacked layers lead with the layer axis."""
    m = dims(conf)
    d, H, KV, hd, f, L, Vp = (m[k] for k in ("d", "H", "KV", "hd", "f",
                                             "L", "Vp"))

    def w(shape, fan_in):
        return (tuple(shape), ("normal", 1.0 / math.sqrt(fan_in)))

    def stack(shape, init):
        return ((L,) + tuple(shape), init)

    layer = {
        "ln1": ((d,), ("ones",)), "ln2": ((d,), ("ones",)),
        "attn": {"wq": w((d, H, hd), d), "wk": w((d, KV, hd), d),
                 "wv": w((d, KV, hd), d), "wo": w((H, hd, d), H * hd)},
    }
    if m["E"]:
        E = m["E"]
        layer["moe"] = {"router": w((d, E), d),
                        "experts": {"wi": w((E, d, f), d),
                                    "wg": w((E, d, f), d),
                                    "wo": w((E, f, d), f)}}
    else:
        layer["mlp"] = {"wi": w((d, f), d), "wg": w((d, f), d),
                        "wo": w((f, d), f)}
    out = {"embed": {"table": ((Vp, d), ("normal", 0.02))},
           "ln_f": ((d,), ("ones",)),
           "layers": _map(lambda leaf: stack(*leaf), layer)}
    if not m["tied"]:
        out["unembed"] = {"table": w((d, Vp), d)}
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree, prefix=""):
    """[(path, leaf)] of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def leaf_norms(path: str, x) -> dict:
    """{name: norm tensor} of one leaf; a stacked leaf ("layers/...") by
    layer, "<path>/<i>", and an expert stack by layer and expert,
    "<path>/<i>/<e>", as each layer's and each expert's weight is a tensor
    of its own in the published model."""
    if path.startswith("layers/moe/experts/"):
        n = torch.linalg.vector_norm(x.reshape(x.shape[0], x.shape[1], -1),
                                     dim=2)
        return {f"{path}/{i}/{e}": v for i, row in enumerate(n)
                for e, v in enumerate(row)}
    if path.startswith("layers/"):
        n = torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1)
        return {f"{path}/{i}": v for i, v in enumerate(n)}
    return {path: torch.linalg.vector_norm(x)}


# ---------------------------------------------------------------- numerics --

def _round_e4m3(x):
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in
    float32; the backward pass takes the rounding as the identity."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def mm(eq: str, a, b, precision: str):
    if precision == "float8":
        a, b = _round_e4m3(a), _round_e4m3(b)
    elif precision != "float32":
        raise ValueError(precision)
    return torch.einsum(eq, a, b)


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def rope(x, cos, sin):
    """Split-half rotation of x [B, S, heads, hd] by tables [S, hd / 2]."""
    half = x.shape[-1] // 2
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def rope_tables(S, hd, theta, device):
    freqs = 1.0 / theta ** (torch.arange(0, hd // 2, dtype=torch.float32,
                                         device=device) * 2.0 / hd)
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] * freqs
    return torch.cos(ang), torch.sin(ang)


def attention(m, x, wq, wk, wv, wo, cos, sin, precision, q_block):
    """Causal (windowed) GQA over x [B, S, d], queries in blocks."""
    B, S, _ = x.shape
    H, KV, hd, W = m["H"], m["KV"], m["hd"], m["window"]
    q = rope(mm("bsd,dnh->bsnh", x, wq, precision), cos, sin)
    k = rope(mm("bsd,dnh->bsnh", x, wk, precision), cos, sin)
    v = mm("bsd,dnh->bsnh", x, wv, precision)
    # query head n reads key head n // (H / KV)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for s0 in range(0, S, q_block):
        s1 = min(S, s0 + q_block)
        k0 = 0 if W is None else max(0, s0 - W + 1)
        qp = torch.arange(s0, s1, device=x.device)[:, None]
        kp = torch.arange(k0, s1, device=x.device)[None, :]
        keep = kp <= qp
        if W is not None:
            keep = keep & (qp - kp < W)
        s = mm("bqnh,bknh->bnqk", q[:, s0:s1], k[:, k0:s1], precision) * scale
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        outs.append(mm("bnqk,bknh->bqnh", p, v[:, k0:s1], precision))
    o = torch.cat(outs, dim=1)
    return mm("bsnh,nhd->bsd", o, wo, precision)


def moe(m, x, router, wi, wg, wo, precision, ids=None):
    """Mixtral's sparse block over x [T, d]: (y, router loss, dropped
    share of the choices, its own ranking of the experts [T, E], route
    gap, route miss share). Its choices are ``ids`` [T, k] where given,
    else its own top k; the route gap is the largest over tokens of its own
    top k's probability less that of the choices followed: 0 when they are
    its own as a set, the gap between two ranks where one was swapped; the
    route miss share is the share of tokens whose choices are not its own
    top k as a set."""
    T = x.shape[0]
    E, k = m["E"], m["k"]
    probs = torch.softmax(mm("td,de->te", x, router, precision), dim=-1)
    # the largest first, ties to the lower expert id
    rank = torch.sort(probs.detach(), dim=-1, descending=True,
                      stable=True).indices
    ids = rank[:, :k] if ids is None else ids.to(x.device, torch.long)
    p = probs.detach()
    # each sum over the values sorted, so that one set gives one sum
    gap = (p.gather(-1, rank[:, :k]).sort(-1).values.sum(-1)
           - p.gather(-1, ids).sort(-1).values.sum(-1)).max()
    miss = (rank[:, :k].sort(-1).values != ids.sort(-1).values).any(-1) \
        .float().mean()
    top = probs.gather(-1, ids)
    wts = (top / top.sum(-1, keepdim=True)).reshape(-1)
    first = F.one_hot(ids[:, 0], E).float().mean(0)
    aux = E * (first * probs.mean(0)).sum()
    cap = max(math.ceil(k * T / E * m["capacity_factor"]), 4)
    choice_expert = ids.reshape(-1)          # choice c is token c // k's
    y = x.new_zeros(x.shape)
    dropped = 0
    for e in range(E):
        mine = (choice_expert == e).nonzero().squeeze(1)   # in choice order
        kept = mine[:cap]
        dropped += mine.numel() - kept.numel()
        tok = kept // k
        xe = x[tok]
        h = mm("td,df->tf", xe, wi[e], precision)
        g = mm("td,df->tf", xe, wg[e], precision)
        ye = mm("tf,fd->td", F.silu(g) * h, wo[e], precision)
        y = y.index_add(0, tok, ye * wts[kept][:, None])
    return (y, aux, torch.tensor(dropped / (T * k), device=x.device), rank,
            gap, miss)


def _layer(m, precision, q_block, ids, x, cos, sin, *w):
    """One block: (x, router loss, dropped share), and for a sparse block
    its ranking, route gap and route miss share (``moe``), following
    ``ids`` where given."""
    ln1, ln2, wq, wk, wv, wo = w[:6]
    x = x + attention(m, rms_norm(x, ln1, m["eps"]), wq, wk, wv, wo,
                      cos, sin, precision, q_block)
    h = rms_norm(x, ln2, m["eps"])
    if m["E"]:
        router, ei, eg, eo = w[6:]
        B, S, d = h.shape
        y, aux, drop, *route = moe(m, h.reshape(B * S, d), router, ei, eg,
                                   eo, precision, ids)
        return (x + y.reshape(B, S, d), aux, drop, *route)
    wi, wg, wo2 = w[6:]
    g = mm("bsd,df->bsf", h, wg, precision)
    u = mm("bsd,df->bsf", h, wi, precision)
    y = mm("bsf,fd->bsd", F.silu(g) * u, wo2, precision)
    zero = torch.zeros((), device=x.device)
    return x + y, zero, zero


def _layer_weights(m, p, i):
    lp = p["layers"]
    a = lp["attn"]
    w = [lp["ln1"][i], lp["ln2"][i], a["wq"][i], a["wk"][i], a["wv"][i],
         a["wo"][i]]
    if m["E"]:
        mo = lp["moe"]
        w += [mo["router"][i], mo["experts"]["wi"][i],
              mo["experts"]["wg"][i], mo["experts"]["wo"][i]]
    else:
        w += [lp["mlp"]["wi"][i], lp["mlp"]["wg"][i], lp["mlp"]["wo"][i]]
    return w


def _ce_block(m, precision, h, table, y, tied):
    logits = mm("bsd,vd->bsv" if tied else "bsd,dv->bsv", h, table,
                precision)
    if m["Vp"] != m["V"]:
        pad = torch.arange(m["Vp"], device=h.device) >= m["V"]
        logits = logits.masked_fill(pad, NEG)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, y[..., None].long())[..., 0]
    return (lse - gold).sum()


def loss_fn(conf, params, tokens, precision="float32", q_block=1024,
            loss_block=1024, routes=None):
    """(loss, {"ce", "moe_aux", "moe_dropped", "ranks", "route_gap",
    "route_miss"}) of one batch [B, S]; a sparse model's layer ``i``
    follows the choices ``routes[i]`` [B * S, k] where given (``moe``)."""
    m = dims(conf)
    tokens = tokens.long()
    B, S = tokens.shape
    x = F.embedding(tokens, params["embed"]["table"])
    cos, sin = rope_tables(S, m["hd"], m["theta"], x.device)
    auxs, drops, ranks, gaps, misses = [], [], [], [], []
    for i in range(m["L"]):
        x, aux, drop, *route = checkpoint(
            _layer, m, precision, q_block,
            None if routes is None else routes[i], x, cos, sin,
            *_layer_weights(m, params, i), use_reentrant=False)
        auxs.append(aux)
        drops.append(drop.detach())
        if route:
            ranks.append(route[0])
            gaps.append(route[1])
            misses.append(route[2])
    h = rms_norm(x, params["ln_f"], m["eps"])[:, :-1]
    y = tokens[:, 1:]
    table = params["embed"]["table"] if m["tied"] \
        else params["unembed"]["table"]
    total = h.new_zeros(())
    for s0 in range(0, S - 1, loss_block):
        total = total + checkpoint(
            _ce_block, m, precision, h[:, s0:s0 + loss_block], table,
            y[:, s0:s0 + loss_block], m["tied"], use_reentrant=False)
    ce = total / (B * (S - 1))
    metrics = {"ce": ce.detach()}
    loss = ce
    if m["E"]:
        aux = torch.stack(auxs).mean()
        loss = loss + m["aux_coef"] * aux
        metrics["moe_aux"] = aux.detach()
        metrics["moe_dropped"] = torch.stack(drops).mean()
        metrics["ranks"] = ranks
        metrics["route_gap"] = torch.stack(gaps).max()
        metrics["route_miss"] = torch.stack(misses).max()
    return loss, metrics


# -------------------------------------------------------------- the step --

def learning_rate(step: int) -> float:
    t = step + 1.0
    if t < WARMUP:
        return PEAK_LR * t / WARMUP
    prog = min(max((t - WARMUP) / max(TOTAL_STEPS - WARMUP, 1), 0.0), 1.0)
    return PEAK_LR * (FINAL_FRAC + (1 - FINAL_FRAC) * 0.5
                      * (1 + math.cos(math.pi * prog)))


def train_step(conf, state, step: int, tokens, precision="float32",
               routes=None):
    """One step at 0-based ``step`` on ``state`` = {"params", "mu", "nu"}
    (nested dicts, updated in place), following the MoE choices ``routes``
    where given (``loss_fn``). Returns (loss, metrics, {leaf: the clipped
    gradient's norm}), the leaves as ``leaf_norms`` names them."""
    named = leaves(state["params"])
    ws = [p.detach().requires_grad_(True) for _, p in named]
    tree = _unflatten(state["params"], dict(zip([n for n, _ in named], ws)))
    loss, metrics = loss_fn(conf, tree, tokens, precision, routes=routes)
    grads = list(torch.autograd.grad(loss, ws))
    del tree, ws
    with torch.no_grad():
        gn = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = torch.clamp(GRAD_CLIP / gn.clamp_min(1e-9), max=1.0)
        lr = learning_rate(step)
        c1 = 1.0 - B1 ** (step + 1)
        c2 = 1.0 - B2 ** (step + 1)
        mus, nus = dict(leaves(state["mu"])), dict(leaves(state["nu"]))
        gnorms = {}
        for i, (path, p) in enumerate(named):
            g = grads[i].mul_(scale)
            grads[i] = None
            gnorms.update({k: float(v)
                           for k, v in leaf_norms(path, g).items()})
            m_, v_ = mus[path], nus[path]
            m_.mul_(B1).add_(g, alpha=1 - B1)
            v_.mul_(B2).addcmul_(g, g, value=1 - B2)
            del g
            upd = (m_ / c1) / (torch.sqrt(v_ / c2) + EPS)
            if p.ndim >= 2:
                upd.add_(p, alpha=WEIGHT_DECAY)
            p.sub_(upd, alpha=lr)
            del upd
    metrics["grad_norm"] = gn
    return loss.detach(), metrics, gnorms


def _unflatten(like, by_path, prefix=""):
    if isinstance(like, dict):
        return {k: _unflatten(v, by_path, f"{prefix}/{k}" if prefix else k)
                for k, v in like.items()}
    return by_path[prefix]
