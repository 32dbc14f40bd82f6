"""AdamW's global norm, clip and update over all leaves of a step as
multi-tensor CUDA kernels (``csrc/adamw.cu``).

Two passes over the leaves: the sum of squares of every gradient (one f64
partial per chunk, summed in a fixed order by a one-block kernel that also
writes the clip scale), then one update pass that reads g, p, m and v and
writes p', m' and v' into new tensors. 32 bytes a parameter in f32, where
the per-leaf torch chain moves ~180. Leaves go in by tables passed as kernel
parameters, at most ``SQ_MAX`` / ``UPD_MAX`` leaves a launch: no copy of
metadata to the card and no sync. A leaf need not be contiguous
(a tied embedding's gradient is the transpose of a contiguous one): the
norm reads a dense gradient's storage as it lies, and the update reads a
non-contiguous leaf through a contiguous copy, 8 more bytes an element of
that leaf for each such input. Every launch counts under
``adamw_sumsq``, ``adamw_finish`` or ``adamw_update`` in
``cuda_build.launches``.

No TPU kernel: the reference package's AdamW is XLA's fused elementwise
ops. The plain version is ``train/optimizer.plain_update``, which the
update reproduces bit for bit given the same clip scale and takes the same
arguments; ``train/optimizer.py`` routes a step to these kernels when its
leaves are real CUDA tensors (``routed``), and there is no other route for
them: a CUDA leaf the kernels cannot take raises ``ValueError``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import cuda_build

CHUNK = 16384                  # elements a block (csrc/adamw.cu)
SQ_MAX = 128                   # leaves a sum-of-squares launch
UPD_MAX = 48                   # leaves an update launch
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F_BF16 = _F_DECAY = 1
_F_ALIGNED = 2

_LP = ctypes.POINTER(ctypes.c_longlong)
_IP = ctypes.POINTER(ctypes.c_int)


def routed(tensors) -> bool:
    """Whether an optimizer step over ``tensors`` runs on these kernels:
    whether any of them is a real (not fake) CUDA tensor. The CPU's tensors
    and the dry run's fake ones take the plain path."""
    from torch._subclasses.fake_tensor import is_fake

    return any(isinstance(t, torch.Tensor) and t.is_cuda and not is_fake(t)
               for t in tensors)


def _check(tensors, what: str):
    """Raises ``ValueError`` unless every tensor is a real CUDA tensor of
    f32 or bf16, all on one device."""
    from torch._subclasses.fake_tensor import is_fake

    devs = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devs) != 1 or not all(
            isinstance(t, torch.Tensor) and t.is_cuda and not is_fake(t)
            and t.dtype in DTYPES for t in tensors):
        raise ValueError(f"the AdamW {what} takes CUDA tensors of f32 or "
                         f"bf16 on one device")


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill its storage span without gaps or
    overlaps in some order of its dims (a transpose of a contiguous tensor,
    as the tied embedding's gradient is): the sum of squares may then read
    that span as it lies."""
    dims = sorted((st, n) for st, n in zip(t.stride(), t.shape) if n != 1)
    want = 1
    for st, n in dims:
        if st != want:
            return False
        want *= n
    return True


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _op(name: str):
    """A host operation named ``name`` around a launch. The profiler records
    it as it records a torch operation (``cpu_op``) and links the kernel to
    it, and so to the program's span around it (``repro_torch.step.
    optimizer``); it links no kernel to a ``record_function`` range (a user
    annotation), so a launch outside every operation would go unattributed.
    Nearly free without a profiler."""
    return torch._C._profiler._RecordFunctionFast(name)


def _blocks(n: int) -> int:
    return -(-n // CHUNK)


def _arrays(ptrs, numels, flags):
    """int64 / int32 arrays for the launchers, kept alive by the caller."""
    return (np.asarray(ptrs, dtype=np.int64), np.asarray(numels, np.int64),
            np.asarray(flags, dtype=np.int32))


def norm_and_scale(grads, max_norm):
    """(gn, scale): the global norm of ``grads`` (a list of CUDA tensors
    of f32 or bf16) as an f32 scalar on the card, and with a ``max_norm``
    the clip scale min(max_norm / max(gn, 1e-9), 1) (else None)."""
    _check(grads, "norm kernels")
    dev = grads[0].device
    live = [g if _dense(g) else g.contiguous() for g in grads if g.numel()]
    partial = torch.empty(sum(_blocks(g.numel()) for g in live),
                          dtype=torch.float64, device=dev)
    gn = torch.empty((), dtype=torch.float32, device=dev)
    scale = torch.empty((), dtype=torch.float32, device=dev) \
        if max_norm else None
    lib = cuda_build.library("adamw")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        off = 0
        for s in range(0, len(live), SQ_MAX):
            grp = live[s:s + SQ_MAX]
            ptrs, numels, flags = _arrays(
                [g.data_ptr() for g in grp], [g.numel() for g in grp],
                [(_F_BF16 if g.dtype == torch.bfloat16 else 0)
                 | (_F_ALIGNED if _aligned(g) else 0) for g in grp])
            with _op("adamw_sumsq"):
                err = lib.adamw_sumsq_launch(
                    len(grp), ptrs.ctypes.data_as(_LP),
                    numels.ctypes.data_as(_LP), flags.ctypes.data_as(_IP),
                    partial.data_ptr() + 8 * off, stream)
            cuda_build.launched(err, "adamw_sumsq")
            off += sum(_blocks(g.numel()) for g in grp)
        with _op("adamw_finish"):
            err = lib.adamw_finish_launch(
                partial.data_ptr(), off, float(max_norm or 0.0),
                gn.data_ptr(),
                scale.data_ptr() if scale is not None else None, stream)
        cuda_build.launched(err, "adamw_finish")
    return gn, scale


def update(grads, params, mu, nu, decay, scale, lr, c1, c2, *, b1, b2, eps,
           weight_decay, moment_dtype):
    """(params', mu', nu'): AdamW over lists of CUDA leaves, each output a
    new tensor. ``decay[i]`` says whether leaf i decays; ``scale`` (an f32
    scalar on the card, or None for no clip), ``lr``, ``c1`` and ``c2``
    (f32 scalars on the card) as in ``train/optimizer.py``; b1, b2, eps and
    weight_decay are rounded to f32 as torch rounds a number multiplying an
    f32 tensor. Leaves are f32 or bf16, a gradient of its parameter's dtype
    and shape, the moments of ``moment_dtype``; a leaf that is not
    contiguous is read through a contiguous copy. Anything else raises
    ``ValueError``: the kernels hand nothing back to the plain path."""
    scalars = [x for x in (scale, lr, c1, c2) if x is not None]
    _check([*grads, *params, *mu, *nu, *scalars], "update kernel")
    if not all(x.dtype == torch.float32 and x.numel() == 1
               for x in scalars) or not all(
            g.dtype == p.dtype and m.dtype == v.dtype == moment_dtype
            and g.shape == p.shape == m.shape == v.shape
            for g, p, m, v in zip(grads, params, mu, nu)):
        raise ValueError("the AdamW update kernel takes f32 scalars, each "
                         "gradient of its parameter's dtype and shape, and "
                         f"moments of {moment_dtype}")
    grads, params, mu, nu = ([x if x.is_contiguous() else x.contiguous()
                              for x in xs] for xs in (grads, params, mu, nu))
    new_p = [torch.empty_like(p) for p in params]
    new_m = [torch.empty_like(m) for m in mu]
    new_v = [torch.empty_like(v) for v in nu]
    dev = params[0].device
    groups: dict = {}
    for i, p in enumerate(params):
        if p.numel():
            groups.setdefault((DTYPES[p.dtype], DTYPES[mu[i].dtype]),
                              []).append(i)
    lib = cuda_build.library("adamw")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for (pcode, mcode), idx in groups.items():
            for s in range(0, len(idx), UPD_MAX):
                grp = idx[s:s + UPD_MAX]
                bufs = [(grads[i], params[i], mu[i], nu[i], new_p[i],
                         new_m[i], new_v[i]) for i in grp]
                ptrs, numels, flags = _arrays(
                    [t.data_ptr() for b in bufs for t in b],
                    [params[i].numel() for i in grp],
                    [(_F_DECAY if decay[i] else 0)
                     | (_F_ALIGNED if _aligned(*b) else 0)
                     for i, b in zip(grp, bufs)])
                with _op("adamw_update"):
                    err = lib.adamw_update_launch(
                        pcode, mcode, len(grp), ptrs.ctypes.data_as(_LP),
                        numels.ctypes.data_as(_LP),
                        flags.ctypes.data_as(_IP),
                        scale.data_ptr() if scale is not None else None,
                        lr.data_ptr(), c1.data_ptr(), c2.data_ptr(), b1,
                        1 - b1, b2, 1 - b2, eps, weight_decay, stream)
                cuda_build.launched(err, "adamw_update")
    return new_p, new_m, new_v
