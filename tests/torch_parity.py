"""Helpers shared by the port's module parity tests: carry a reference
parameter tree across, and hold a port function's output and gradients
against the reference function's on the same numpy inputs.

A parity check runs ``f(params, *xs)`` in both packages and compares the
outputs, then the gradients of ``sum(y * probe)`` (a seeded random probe
per output) with respect to every parameter leaf and every input."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.params import init_params as jax_init_params
from repro_torch.utils.pytree import tree_flatten, tree_unflatten

OUT_RTOL_F32 = 1e-5           # of each output's max |y|
GRAD_RTOL_F32 = 1e-4          # of each gradient leaf's max |g|


def reference_params(spec, seed=1):
    """A reference parameter tree (f32) as numpy leaves."""
    p = jax_init_params(spec, jax.random.PRNGKey(seed), "float32")
    return jax.tree_util.tree_map(np.array, p)


def _outputs(y):
    return list(y) if isinstance(y, (tuple, list)) else [y]


def run_jax(fn, np_params, xs, probes):
    """(outputs, param grads as a leaf list, input grads) of the reference."""
    def scalar(p, *a):
        ys = _outputs(fn(p, *a))
        return sum((y * pr).sum() for y, pr in zip(ys, probes)), ys

    argnums = tuple(range(1 + len(xs)))
    (_, ys), grads = jax.jit(jax.value_and_grad(
        scalar, argnums=argnums, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        *[jnp.asarray(x) for x in xs])
    return ([np.asarray(y) for y in ys],
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads[0])],
            [np.asarray(g) for g in grads[1:]])


def run_torch(fn, np_params, xs, probes):
    """The same for the port's function, on the CPU."""
    leaves, treedef = tree_flatten(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), np_params))
    leaves = [t.requires_grad_(True) for t in leaves]
    txs = [torch.from_numpy(np.array(x)).requires_grad_(True) for x in xs]
    ys = _outputs(fn(tree_unflatten(treedef, leaves), *txs))
    total = sum((y * torch.from_numpy(pr)).sum() for y, pr in zip(ys, probes))
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves + txs, torch.autograd.grad(total, leaves + txs,
                                          allow_unused=True))]
    return ([y.detach().numpy() for y in ys],
            [g.numpy() for g in grads[:len(leaves)]],
            [g.numpy() for g in grads[len(leaves):]])


def max_rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def check_parity(jfn, tfn, np_params, xs, out_shapes, out_rtol=OUT_RTOL_F32,
                 grad_rtol=GRAD_RTOL_F32, seed=7):
    """Runs both and asserts the outputs and every gradient leaf agree.
    Returns the reference's results for further checks."""
    rs = np.random.default_rng(seed)
    probes = [rs.standard_normal(s).astype(np.float32) for s in out_shapes]
    jy, jgp, jgx = run_jax(jfn, np_params, xs, probes)
    ty, tgp, tgx = run_torch(tfn, np_params, xs, probes)
    assert [y.shape for y in ty] == [y.shape for y in jy]
    for y, want in zip(ty, jy):
        assert np.isfinite(y).all()
        assert max_rel(y, want) <= out_rtol
    assert len(tgp) == len(jgp)
    for g, want in zip(tgp + tgx, jgp + jgx):
        assert g.shape == want.shape and np.isfinite(g).all()
        assert max_rel(g, want) <= grad_rtol
    return jy, jgp, jgx
