"""Logical-axis sharding rules with divisibility fallback, over a
``torch.distributed.DeviceMesh``.

Models annotate params and activations with LOGICAL axis names; this module
resolves them to physical specs against a mesh. Resolution is defensive: a
mesh axis is used at most once per spec, and a logical axis that does not
divide its dimension falls through to the next candidate (ultimately
replication) — kv_heads=8 on a 16-way model axis simply replicates instead
of failing, and a batch of 1 falls back to sequence sharding for
long-context decode. The rules and the fallbacks are the reference
package's (``repro.parallel.sharding``), so both packages resolve a layout
to the same spec.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), a
mesh-axis name, or a tuple of names joined on that dim (major first) — the
entries of a jax ``PartitionSpec``. Its torch form is one placement per mesh
dim (``placements``): ``Shard(d)`` where the axis shards tensor dim ``d``,
else ``Replicate()``. A joined entry becomes ``Shard(d)`` on each of its
axes, which torch splits in mesh order; an entry that joins axes against
mesh order has no torch form and raises.

``place`` is the counterpart of ``jax.make_array_from_callback``: each rank
cuts its own slice of a tensor it holds whole and wraps it as a ``DTensor``
without any collective (gloo has none for CUDA tensors, and ranks that
share one card are gloo ranks).

Physical axes:
  "pod"   — outermost, across pods (multi-pod mesh only)
  "data"  — data parallel / FSDP
  "model" — tensor / expert parallel
"""
from __future__ import annotations

import contextlib
import threading
from collections.abc import Mapping
from typing import Optional, Sequence

import torch

# Candidate physical axes per logical axis, in preference order. Each
# candidate is a tuple of mesh axis names that will be combined on that dim.
# () = replicate.
DEFAULT_RULES: dict[str, list[tuple[str, ...]]] = {
    # --- activations ---
    "batch":     [("pod", "data"), ("data",), ()],
    "batch_dp3": [("pod", "data", "model"), ("data", "model"),
                  ("pod", "data"), ("data",), ()],
    "seq":       [()],                       # sequence usually unsharded in train
    "seq_mp":    [("model",), ()],           # decode KV sequence sharding (SP)
    # long-context B=1 decode: spread cache over every axis we can
    "cache_seq": [("pod", "data", "model"), ("data", "model"), ("model",), ()],
    "act_embed": [()],
    "act_heads": [("model",), ()],
    "act_mlp":   [("model",), ()],
    "act_vocab": [("model",), ()],
    # --- params ---
    "vocab":     [("model",), ()],
    "embed":     [("pod", "data"), ("data",), ()],   # FSDP / ZeRO-3 shard dim
    "heads":     [("model",), ()],
    "kv_heads":  [("model",), ()],
    "mlp":       [("model",), ()],
    "expert":    [("model",), ()],
    "dinner":    [("model",), ()],           # mamba inner dim
    "layer":     [()],
    "stage":     [()],                        # pipeline stages (opt-in)
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict[str, list[tuple[str, ...]]] = DEFAULT_RULES


_CTX = _Ctx()


def axis_rules_for_mesh(mesh, overrides: Optional[dict] = None):
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return rules


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Install mesh + rules for constrain()/param_sharding(). None = no-op
    mode."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = rules or (axis_rules_for_mesh(mesh) if mesh is not None
                           else DEFAULT_RULES)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} in mesh order: a DeviceMesh's ``mesh_dim_names``
    with its shape, or a mesh whose ``shape`` already is such a mapping."""
    if isinstance(mesh.shape, Mapping):
        return {str(a): int(n) for a, n in mesh.shape.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("a DeviceMesh needs mesh_dim_names to resolve "
                         "logical axes")
    return {str(a): int(n) for a, n in zip(names, mesh.shape)}


def _mesh_axis_size(sizes: dict, axes: tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def physical_spec(logical: Sequence[Optional[str]], shape: Sequence[int],
                  mesh=None, rules: Optional[dict] = None) -> tuple:
    """Resolve logical axis names to a spec with divisibility and used-axis
    fallbacks (``()`` without a mesh)."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return ()
    sizes = mesh_axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for name, dim in zip(logical, shape):
        entry: object = None
        if name is not None:
            for cand in rules.get(name, [()]):
                cand = tuple(a for a in cand if a in sizes)
                if not cand:
                    continue
                if any(a in used for a in cand):
                    continue
                if dim % _mesh_axis_size(sizes, cand) != 0:
                    continue
                entry = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        out.append(entry)
    return tuple(out)


def spec_entries(spec) -> Optional[list]:
    """Normalize a spec into a JSON-serializable list: each entry None, a
    mesh-axis name, or a list of names. This is the layout-independent form
    checkpoint manifests record so a restore can re-resolve it on a
    different mesh."""
    if spec is None:
        return None
    out: list = []
    for e in tuple(spec):
        if e is None:
            out.append(None)
        elif isinstance(e, (tuple, list)):
            out.append([str(a) for a in e])
        else:
            out.append(str(e))
    return out


def respec(entries: Optional[Sequence], shape: Sequence[int], mesh) -> tuple:
    """Re-resolve a RECORDED physical spec (``spec_entries`` form) on a
    possibly different mesh, with the same defensive fallbacks as
    ``physical_spec``: axes absent from the new mesh drop out, each mesh
    axis is used at most once, and a combination that does not divide its
    dimension falls back to its longest dividing prefix (ultimately
    replication). This is how an N-process recording reshards onto an
    M-process (or single-process) replay mesh."""
    sizes = mesh_axis_sizes(mesh)
    used: set[str] = set()
    ent = list(entries or [])
    ent += [None] * (len(shape) - len(ent))
    out = []
    for e, dim in zip(ent, shape):
        if e is None:
            axes: tuple[str, ...] = ()
        elif isinstance(e, (tuple, list)):
            axes = tuple(str(a) for a in e)
        else:
            axes = (str(e),)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        while axes and dim % _mesh_axis_size(sizes, axes) != 0:
            axes = axes[:-1]
        used.update(axes)
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return tuple(out)


def _entry_axes(e) -> tuple[str, ...]:
    if e is None:
        return ()
    if isinstance(e, (tuple, list)):
        return tuple(str(a) for a in e)
    return (str(e),)


def placements(spec, mesh) -> tuple:
    """The torch form of ``spec`` on ``mesh``: one placement per mesh dim,
    ``Shard(d)`` for each axis of tensor dim ``d``'s entry, ``Replicate()``
    elsewhere. Raises ValueError for an axis the mesh lacks, an axis used
    twice, or a joined entry against mesh order (torch splits a dim by its
    mesh dims in mesh order, so that layout has no torch form)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for d, e in enumerate(tuple(spec)):
        axes = _entry_axes(e)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec entry {e!r}: {missing} not in mesh "
                             f"axes {names}")
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {e!r} joins mesh axes against "
                             f"mesh order {names}: no torch placement "
                             f"gives that layout")
        for p in pos:
            if isinstance(out[p], Shard):
                raise ValueError(f"mesh axis {names[p]!r} shards two dims "
                                 f"in spec {tuple(spec)!r}")
            out[p] = Shard(d)
    return tuple(out)


def spec_from_placements(pls, ndim: int, mesh) -> tuple:
    """The spec of a placement tuple: per tensor dim, the mesh axes that
    shard it, in mesh order (the inverse of ``placements``)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axis_sizes(mesh))
    per_dim: list[list[str]] = [[] for _ in range(ndim)]
    for name, p in zip(names, pls):
        if isinstance(p, Shard):
            per_dim[p.dim % ndim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p!r} on mesh axis {name!r}: only "
                             f"Shard and Replicate are recorded")
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a))
                 for a in per_dim)


def local_box(shape: Sequence[int], mesh, pls) -> list:
    """This rank's index box ``[[lo, hi), ...]`` of a tensor of global
    ``shape`` laid out by ``pls`` on ``mesh``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    lshape, off = compute_local_shape_and_global_offset(
        torch.Size(shape), mesh, list(pls))
    return [[int(o), int(o) + int(n)] for o, n in zip(off, lshape)]


def _contiguous_stride(shape: Sequence[int]) -> tuple:
    stride, s = [], 1
    for d in reversed(list(shape)):
        stride.append(s)
        s *= int(d)
    return tuple(reversed(stride))


def place(x: torch.Tensor, mesh, spec):
    """``x`` (held whole, the same on every rank) as a DTensor laid out by
    ``spec`` on ``mesh``: this rank's slice, made contiguous (its own
    buffer), wrapped with ``DTensor.from_local`` — no collective runs."""
    from torch.distributed.tensor import DTensor
    pls = placements(spec, mesh)
    box = local_box(x.shape, mesh, pls)
    local = x[tuple(slice(lo, hi) for lo, hi in box)].contiguous()
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=x.shape,
                              stride=_contiguous_stride(x.shape))


class MeshSharding:
    """A spec on a mesh — what a jax ``NamedSharding`` is to the reference
    package. ``placements`` is its torch form; ``place(x, s.mesh, s.spec)``
    lays a tensor out by it. A pytree leaf (not a tuple node), so trees of
    them map one to one onto trees of tensors."""
    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def __repr__(self):
        return f"MeshSharding({mesh_axis_sizes(self.mesh)}, {self.spec})"


def param_sharding(logical, shape, mesh=None) -> Optional[tuple]:
    """Placements of a parameter of ``shape`` with logical axes
    ``logical`` on ``mesh`` (the installed one by default); None without a
    mesh."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return None
    return placements(physical_spec(logical, shape, mesh), mesh)


def constrain(x, logical: Sequence[Optional[str]]):
    """Identity with no mesh installed. Under a mesh this would constrain an
    activation's layout inside sharded model compute, which this package
    does not run yet: it raises instead of computing something else."""
    if _CTX.mesh is None:
        return x
    raise NotImplementedError(
        "constrain under a mesh needs sharded model compute, which the "
        "torch package does not run yet (it records and restores sharded "
        "state; ROADMAP queue 1)")
