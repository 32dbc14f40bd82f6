"""Parameter-spec trees: one definition drives init and the leaf layout.

A model builds a nested dict of ParamSpec leaves; ``init_params``
materializes it as a dict of tensors with the same paths and shapes as the
reference package's parameter tree (so checkpoints of the two packages name
and lay out their leaves identically).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                      # logical axis names (len == ndim)
    init: str = "fan_in"             # fan_in | normal | zeros | ones | const
    scale: float = 1.0
    dtype: Optional[str] = None      # override model param_dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _map_specs(fn, tree, path=()):
    """Apply ``fn(path, spec)`` to every ParamSpec of a nested dict."""
    if is_spec(tree):
        return fn(path, tree)
    return {k: _map_specs(fn, v, path + (k,)) for k, v in tree.items()}


def stack_spec(tree, n: int):
    """Prepend a stacked 'layer' dimension of size n to every leaf."""
    return _map_specs(lambda _, s: dataclasses.replace(
        s, shape=(n,) + s.shape, axes=("layer",) + s.axes), tree)


def axes_tree(tree):
    """The nested dict of each parameter's logical axes."""
    return _map_specs(lambda _, s: s.axes, tree)


def shape_tree(tree):
    """The nested dict of each parameter's shape."""
    return _map_specs(lambda _, s: torch.Size(s.shape), tree)


def init_params(tree, seed: int, default_dtype: str, device,
                place=None) -> dict:
    """Materialize params on ``device``. Each leaf draws from its own
    ``torch.Generator`` seeded from (seed, blake2b of the leaf path), so the
    result is independent of tree iteration order and reproducible across
    processes. The draws are not jax.random's: to run both packages from
    the same weights, move them with ``train.state.state_from_numpy``.
    ``place(path, leaf)``, if given, replaces each leaf as soon as it is
    made — a process of a mesh keeps its own slice, and no more than one
    whole leaf is alive at a time."""
    device = torch.device(device)

    def make(path, spec: ParamSpec):
        pstr = "/".join(f"[{k!r}]" for k in path)
        digest = hashlib.blake2b(pstr.encode(), digest_size=4).digest()
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) << 32) | int.from_bytes(digest, "little"))
        dtype = getattr(torch, spec.dtype or default_dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init == "const":
            return torch.full(spec.shape, spec.scale, dtype=dtype,
                              device=device)
        if spec.init == "normal":
            std = spec.scale
        elif spec.init == "fan_in":
            fan_in = spec.shape[0] if len(spec.shape) == 1 \
                else int(np.prod(spec.shape[:-1]))
            if len(spec.shape) >= 3 and spec.axes \
                    and spec.axes[0] in ("layer", "expert"):
                fan_in = int(np.prod(spec.shape[1:-1])) or 1
            std = spec.scale / max(fan_in, 1) ** 0.5
        else:
            raise ValueError(f"unknown init {spec.init!r}")
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        # scaled in place: one f32 buffer per leaf at its peak, not two
        return x.mul_(std).to(dtype)

    if place is None:
        return _map_specs(make, tree)
    return _map_specs(lambda path, spec: place(path, make(path, spec)), tree)
