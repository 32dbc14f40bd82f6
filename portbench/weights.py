"""Initial weights from the seed, made on the device in one random call.

The benchmark makes the weights and hands the same tensors to the program
(as its TrainState) and, made again from the same seed, to the reference.
Every random leaf is a view of one float32 buffer drawn by one
``torch.randn`` on a generator of the device, scaled by its std; norms are
ones. The layout is ``reference.model.param_layout``'s.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.model import leaves, param_layout


def _unflatten(by_path: dict) -> dict:
    out: dict = {}
    for path, x in by_path.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return out


def make_params(conf: dict, seed: int, device) -> dict:
    items = leaves(param_layout(conf))
    n = sum(math.prod(shape) for _, (shape, init) in items
            if init[0] == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
    out, off = {}, 0
    for path, (shape, init) in items:
        if init[0] == "ones":
            out[path] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        size = math.prod(shape)
        out[path] = flat[off:off + size].view(shape).mul_(init[1])
        off += size
    return _unflatten(out)


def zeros_like_params(params: dict) -> dict:
    """Zeros of each leaf's shape, views of one buffer."""
    items = leaves(params)
    ref = items[0][1]
    flat = torch.zeros(sum(p.numel() for _, p in items), dtype=torch.float32,
                       device=ref.device)
    out, off = {}, 0
    for path, p in items:
        out[path] = flat[off:off + p.numel()].view(p.shape)
        off += p.numel()
    return _unflatten(out)
