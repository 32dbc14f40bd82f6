"""Collectives over one named axis of a ``DeviceMesh``: the counterparts of
the ``jax.lax`` collectives that the reference package calls inside
``shard_map`` and that GSPMD inserts around its sharded model compute —
``all_gather``, ``psum``, ``psum_scatter``, ``pmean``, ``ppermute`` and
``axis_index`` — on LOCAL tensors, over the process group of one mesh dim
(``DeviceMesh.get_group(name)``) of the installed mesh
(``parallel.sharding.use_mesh``).

Gradients. The differentiable ones are ``torch.autograd.Function``s with
their transposes, under one convention: a cotangent is a PARTIAL sum — the
gradient of a value held identically on the ranks of an axis is the sum of
their local cotangents (the convention of a ``shard_map`` run with
``check_vma=False``, whose transpose divides a replicated output's
cotangent over its ranks). So ``all_gather`` transposes to
``psum_scatter`` and back, ``psum`` to ``psum`` (a replicated leaf used as
is — the identity — gets its gradient psummed over the axes it is
replicated on, in ``train/step.py``), ``ppermute`` to the inverse
permutation, and a slice of a replicated value to its zero-padded
cotangent (plain autograd). The sharded train step backpropagates its
replicated loss divided by the number of ranks.

Transport. Processes that share a card are gloo ranks (NCCL refuses two
ranks on one device). ``STAGED`` names the collectives that gloo cannot run
on CUDA tensors in the card's torch: those copy through pinned host
buffers here, the others hand gloo the CUDA tensor. The choice is fixed per
operation, from ``probe`` on the card; there is no fallback at run time. A
card per process swaps NCCL in, in this module only.

Tracing. On fake tensors (``make_fx(..., tracing_mode="fake")`` over a
fake process group, ``launch/mesh.py::make_production_mesh``) every op
takes its functional form from ``torch.distributed._functional_collectives``
instead, so the traced graph holds ``_c10d_functional`` nodes
(``launch/hlo_analysis.py`` counts them): ``all_gather_into_tensor``,
``all_reduce`` (sum, max), ``reduce_scatter_tensor``, and
``all_to_all_single`` for ``ppermute`` (each rank's one send and one
receive as its splits). Nothing runs
and nothing is counted here then.

Every call is counted (calls, bytes of the local input, seconds) per mesh
axis and operation: ``counts()``, ``reset_counts()``.
"""
from __future__ import annotations

import time
import warnings
from collections import defaultdict

import torch
import torch.distributed as dist

OPS = ("all_gather", "psum", "psum_scatter", "ppermute", "pmax")

# gloo on CUDA tensors, learned by ``tools/gloo_cuda_probe.py`` on NVIDIA
# H100 80GB HBM3 with torch 2.11.0+cu128, each op in a fleet of its own:
# gloo's all-gather, all-reduce (sum, max) and reduce-scatter take CUDA
# tensors (bit for bit); its send / recv hands the device pointer to the
# socket and aborts the process (writev: Bad address). True = staged
# through pinned host buffers here.
STAGED = {"all_gather": False, "psum": False, "psum_scatter": False,
          "ppermute": True, "pmax": False}

_STATS: dict = defaultdict(lambda: [0, 0, 0.0])     # (axis, op) -> counts


def reset_counts():
    _STATS.clear()


def counts(by_op: bool = False) -> dict:
    """{axis: {"calls", "bytes", "seconds"}} since the last reset (with
    ``by_op``: {axis: {op: {...}}})."""
    out: dict = {}
    for (axis, op), (n, b, s) in sorted(_STATS.items()):
        if by_op:
            out.setdefault(axis, {})[op] = {"calls": n, "bytes": b,
                                            "seconds": s}
        else:
            c = out.setdefault(axis, {"calls": 0, "bytes": 0, "seconds": 0.0})
            c["calls"] += n
            c["bytes"] += b
            c["seconds"] += s
    return out


def _mesh():
    from repro_torch.parallel.sharding import current_mesh
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("a collective needs a mesh: install one with "
                           "parallel.sharding.use_mesh")
    return mesh


def axis_size(axis: str, mesh=None) -> int:
    from repro_torch.parallel.sharding import mesh_axis_sizes
    return mesh_axis_sizes(mesh or _mesh()).get(axis, 1)


def axis_index(axis: str, mesh=None) -> int:
    """This rank's coordinate along ``axis`` (0 for an axis the mesh
    lacks)."""
    mesh = mesh or _mesh()
    if axis not in (mesh.mesh_dim_names or ()):
        return 0
    return int(mesh.get_local_rank(axis))


def _traced(x) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x)


def _functional(op: str, mesh, x, axis: str, arg=None):
    """The ``_c10d_functional`` form of ``op`` on a fake tensor (a traced
    program: nothing runs)."""
    import torch.distributed._functional_collectives as fc
    group = mesh.get_group(axis)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        if op == "all_gather":
            return fc.all_gather_tensor(x.contiguous(), arg, group)
        if op == "psum":
            return fc.all_reduce(x, "sum", group)
        if op == "pmax":
            return fc.all_reduce(x, "max", group)
        if op == "psum_scatter":
            return fc.reduce_scatter_tensor(x.contiguous(), "sum", arg,
                                            group)
        # this rank's send and receive, as one all-to-all with its splits
        # (a rank no pair sends to gets zeros)
        n, me, rows = axis_size(axis, mesh), axis_index(axis, mesh), \
            x.shape[0]
        send, recv = [0] * n, [0] * n
        for src, d in arg:
            if src == me:
                send[d] = rows
            if d == me:
                recv[src] = rows
        y = fc.all_to_all_single(x.contiguous(), recv, send, group)
        return y if any(recv) else torch.zeros_like(x)


def _run(op: str, axis: str, x: torch.Tensor, fn, mesh=None, arg=None):
    """``fn`` (a gloo call on tensors of one device) on ``x``, staged
    through a pinned host copy where ``STAGED[op]`` says so; counted. On
    a fake tensor, the op's functional form instead."""
    if _traced(x):
        return _functional(op, mesh, x, axis, arg)
    t0 = time.perf_counter()
    if x.is_cuda and STAGED[op]:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        y = fn(host).to(x.device, non_blocking=True)
    else:
        y = fn(x)
    st = _STATS[(axis, op)]
    st[0] += 1
    st[1] += x.numel() * x.element_size()
    st[2] += time.perf_counter() - t0
    return y


# ------------------------------------------------------------ raw ops --
# Each takes the mesh explicitly: an autograd backward runs on another
# thread, where the installed mesh (a thread-local) is not seen.

def _all_gather(mesh, x, axis: str, dim: int):
    n = axis_size(axis, mesh)
    if n == 1:
        return x

    def fn(t):
        t = t.contiguous()
        bufs = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(bufs, t, group=mesh.get_group(axis))
        return torch.cat(bufs, dim)
    return _run("all_gather", axis, x, fn, mesh, dim)


def _psum(mesh, x, axis: str):
    if axis_size(axis, mesh) == 1:
        return x

    def fn(t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=mesh.get_group(axis))
        return t
    return _run("psum", axis, x, fn, mesh)


def _pmax(mesh, x, axis: str):
    if axis_size(axis, mesh) == 1:
        return x

    def fn(t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
        return t
    return _run("pmax", axis, x, fn, mesh)


def _psum_scatter(mesh, x, axis: str, dim: int):
    n = axis_size(axis, mesh)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does "
                         f"not split over {n} ranks of {axis!r}")

    def fn(t):
        parts = [c.contiguous() for c in t.chunk(n, dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=mesh.get_group(axis))
        return out
    return _run("psum_scatter", axis, x, fn, mesh, dim)


def _ppermute(mesh, x, axis: str, perm):
    """Rank ``src`` of ``axis`` sends to rank ``dst`` for each (src, dst)
    of ``perm``; a rank no pair sends to gets zeros (``lax.ppermute``)."""
    me = axis_index(axis, mesh)
    group = mesh.get_group(axis)

    def fn(t):
        t = t.contiguous()
        out = torch.zeros_like(t)
        ops = []
        for src, dst in perm:
            if src == me and dst == me:
                out.copy_(t)
            elif src == me:
                ops.append(dist.P2POp(dist.isend, t,
                                      dist.get_global_rank(group, dst),
                                      group))
            elif dst == me:
                ops.append(dist.P2POp(dist.irecv, out,
                                      dist.get_global_rank(group, src),
                                      group))
        for w in dist.batch_isend_irecv(ops) if ops else ():
            w.wait()
        return out
    return _run("ppermute", axis, x, fn, mesh, perm)


# ------------------------------------------------------ differentiable --

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _all_gather(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(ctx.args[0], g, *ctx.args[1:]), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _psum_scatter(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.args[0], g, *ctx.args[1:]), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _psum(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _psum(ctx.args[0], g, ctx.args[1]), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, perm)
        return _ppermute(mesh, x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm = ctx.args
        inv = tuple((dst, src) for src, dst in perm)
        return _ppermute(mesh, g, axis, inv), None, None, None


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def all_gather(x, axis: str, dim: int = 0):
    """The shards of ``x`` along ``axis`` concatenated on ``dim`` in axis
    order (``lax.all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, _mesh(), axis, dim)


def psum_scatter(x, axis: str, dim: int = 0):
    """The sum of ``x`` over ``axis``, each rank keeping its chunk of
    ``dim`` (``lax.psum_scatter(..., tiled=True)``)."""
    return _PsumScatter.apply(x, _mesh(), axis, dim)


def psum(x, axes):
    """The sum of ``x`` over ``axes`` (a name or a tuple of names); ``x``
    itself over no axis."""
    if not _axes(axes):
        return x
    mesh = _mesh()
    for a in _axes(axes):
        x = _Psum.apply(x, mesh, a)
    return x


def pmean(x, axes):
    n = 1
    for a in _axes(axes):
        n *= axis_size(a)
    return psum(x, axes) / n


def pmax(x, axes):
    """The elementwise max over ``axes``; no gradient (it serves as a
    stop-gradient shift: the vocab-parallel log-sum-exp's max)."""
    if not _axes(axes):
        return x.detach()
    mesh = _mesh()
    x = x.detach()
    for a in _axes(axes):
        x = _pmax(mesh, x, a)
    return x


def ppermute(x, axis: str, perm):
    """``lax.ppermute``: ``perm`` is a sequence of (source, destination)
    coordinates along ``axis``."""
    return _Ppermute.apply(x, _mesh(), axis, tuple(tuple(p) for p in perm))


# --------------------------------------------------------------- probe --

def probe(device, sizes=(1 << 20, 64 << 20), reps: int = 3, ops=OPS,
          direct: bool = False) -> list:
    """Each of ``ops`` on ``device`` tensors of each byte size over every
    axis of the installed mesh, through this module's transport (with
    ``direct``, every op handed to gloo as is, ``STAGED`` ignored: how the
    table was learned — gloo aborts the process on some of them). Inputs
    are integer-valued f32, so every sum is exact: each result must equal,
    bit for bit, the same collective run on CPU copies. Returns one dict
    per (op, axis, size): route, bits equal, GB/s (input bytes over the
    median of ``reps`` calls)."""
    import statistics

    from repro_torch.parallel.sharding import mesh_axis_sizes

    mesh = _mesh()
    out = []
    for axis, n in mesh_axis_sizes(mesh).items():
        if n == 1:
            continue
        me = axis_index(axis)
        ring = tuple((i, (i + 1) % n) for i in range(n))
        cases = {
            "all_gather": lambda t: _all_gather(mesh, t, axis, 0),
            "psum": lambda t: _psum(mesh, t, axis),
            "psum_scatter": lambda t: _psum_scatter(mesh, t, axis, 0),
            "ppermute": lambda t: _ppermute(mesh, t, axis, ring),
            "pmax": lambda t: _pmax(mesh, t, axis),
        }
        for nbytes in sizes:
            numel = nbytes // 4
            gen = torch.Generator().manual_seed(1000 + me)
            x_cpu = torch.randint(-64, 64, (numel,), generator=gen).float()
            x = x_cpu.to(device)
            for op in ops:
                fn = cases[op]
                want = fn(x_cpu)
                saved = STAGED[op]
                if direct:
                    STAGED[op] = False
                try:
                    walls = []
                    for _ in range(reps):
                        t0 = time.perf_counter()
                        got = fn(x)
                        if x.is_cuda:
                            torch.cuda.synchronize(x.device)
                        walls.append(time.perf_counter() - t0)
                finally:
                    STAGED[op] = saved
                out.append({"op": op, "axis": axis, "bytes": numel * 4,
                            "route": "staged" if (x.is_cuda and STAGED[op]
                                                  and not direct)
                            else "direct",
                            "bit_equal": bool(torch.equal(got.cpu(), want)),
                            "gbps": numel * 4 / statistics.median(walls)
                            / 1e9})
    return out
