"""Serving step builders: prefill and single-token decode, as plain
functions under ``torch.inference_mode()`` (nothing is recorded for
autograd), on the device the parameters live on.

``decode_step`` consumes and re-emits the caches: a ring KV cache under a
sliding window, MLA's latent cache, Mamba1/Mamba2 states, the hybrid's
per-group shared-attention caches and the encoder-decoder's static cross
K/V, per family (``models/api.py``)."""
from __future__ import annotations

import torch

from repro_torch.models import build_model
from repro_torch.train.step import batch_to_device
from repro_torch.utils.pytree import tree_leaves


def params_device(params) -> torch.device:
    return tree_leaves(params)[0].device


def build_prefill_step(cfg, max_len: int):
    model = build_model(cfg)

    @torch.inference_mode()
    def prefill_step(params, batch):
        """(caches, last-position logits); ``batch`` (numpy arrays or
        tensors) is moved to the parameters' device."""
        return model.prefill(params, batch_to_device(
            batch, params_device(params)), max_len)

    return prefill_step


def build_decode_step(cfg):
    model = build_model(cfg)

    @torch.inference_mode()
    def decode_step(params, caches, tokens, pos):
        logits, new_caches = model.decode(params, caches, tokens, pos)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, new_caches

    return decode_step


def greedy_generate(cfg, params, prompt_batch, steps: int, max_len: int):
    """Prefill a prompt batch (numpy arrays or tensors), then
    greedy-decode on the parameters' device: returns the [B, steps] int32 tokens, the first of them
    the argmax of the prefill logits."""
    prefill = build_prefill_step(cfg, max_len)
    decode = build_decode_step(cfg)
    caches, logits = prefill(params, prompt_batch)
    if cfg.family == "audio":
        B, start = prompt_batch["dec_tokens"].shape
    elif cfg.family == "vlm":
        B, start = prompt_batch["tokens"].shape
        start += cfg.frontend_tokens
    else:
        B, start = prompt_batch["tokens"].shape
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(steps - 1):
        tok, _, caches = decode(params, caches, tok, start + i)
        out.append(tok)
    return torch.cat(out, dim=1)
