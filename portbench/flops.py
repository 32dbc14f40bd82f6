"""The yardstick of a training step's useful work, and the card's peaks.

Useful FLOPs of one step of a decoder LM, counted from the configuration
alone, whatever implements it and whatever it recomputes:

* 6 x the non-embedding parameters a token activates x the tokens (the
  attention projections, the MLP or the top-k experts and the router, the
  norms);
* 6 x d x vocab x the positions the loss reads (the LM head's matmul, over
  the published vocabulary, not the padded one);
* 12 x B x heads x head_dim x the keys each query sees, per layer (QK^T and
  PV, 2 x head_dim each, forward and twice that backward): S (S + 1) / 2
  causal, W (W + 1) / 2 + (S - W) W under a window W < S.

The embedding lookup is no matmul and is not counted.
"""
from __future__ import annotations

# Dense bf16 tensor-core peak of each card, FLOP/s (NVIDIA's data sheet, SXM,
# without sparsity), by the name torch.cuda.get_device_name() gives.
BF16_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def keys_seen(S: int, window: int | None) -> int:
    """Sum over the S queries of a causal sequence of the keys each sees."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def active_params(m: dict) -> int:
    """Non-embedding parameters one token activates (``reference.model.dims``
    sizes)."""
    d, H, KV, hd, f, L = (m[k] for k in ("d", "H", "KV", "hd", "f", "L"))
    attn = d * H * hd + 2 * d * KV * hd + H * hd * d
    if m["E"]:
        ffn = m["k"] * 3 * d * f + d * m["E"]
    else:
        ffn = 3 * d * f
    return L * (attn + ffn + 2 * d) + d


def step_flops(m: dict, batch: int, seq: int) -> int:
    """Useful FLOPs of one training step on a [batch, seq] batch."""
    body = 6 * active_params(m) * batch * seq
    head = 6 * m["d"] * m["V"] * batch * (seq - 1)
    attn = 12 * batch * m["H"] * m["hd"] * keys_seen(seq, m["window"]) \
        * m["L"]
    return body + head + attn
