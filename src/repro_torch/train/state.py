"""TrainState: the *explicit changeset* of one training iteration.

The side-effects of an epoch are exactly the outputs of the functional
train_step — this pytree, with the reference package's leaf paths, shapes
and dtypes (``.params[...]``, ``.mu``, ``.nu``, int32 ``.step``, uint32[2]
``.rng``). Flor's lean checkpointing checkpoints precisely this object.

``state_from_numpy`` / ``state_to_numpy`` move a state between this package
and host numpy trees — the reference package's ``TrainState`` after
``jax.device_get`` has exactly that form — so both packages can run from the
same weights.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.utils.pytree import tree_map


class TrainState(NamedTuple):
    params: Any
    mu: Any
    nu: Any
    step: torch.Tensor         # int32 scalar
    rng: torch.Tensor          # uint32[2] (raw key form)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16 (reference side)
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_from_numpy(np_tree, device) -> TrainState:
    """A host TrainState-shaped tree (numpy leaves, e.g. the reference
    package's state after ``jax.device_get``) -> this package's TrainState
    on ``device``, with identical paths, shapes and dtypes."""
    st = tree_map(lambda a: _to_tensor(a, device), tuple(np_tree))
    return TrainState(*st)


def state_to_numpy(state: TrainState):
    """This package's TrainState -> a TrainState of host numpy arrays
    (bfloat16 leaves come back as their uint16 bit patterns)."""
    def host(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return TrainState(*tree_map(host, tuple(state)))
