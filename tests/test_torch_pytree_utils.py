"""The port's ``utils`` exports against the reference's (``repro.utils``)
on the same trees: ``path_str`` over each package's own key paths,
``tree_size``, ``tree_allclose`` and ``cast_floating``."""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils as RU
import repro_torch.utils as U
from repro.utils.pytree import cast_floating as ref_cast_floating
from repro_torch.utils.pytree import cast_floating, tree_flatten_with_path


class Pair(NamedTuple):
    a: object
    b: object


def _tree(rs):
    """A nested tree of numpy leaves: dicts (keys out of order), a list, a
    tuple, a NamedTuple, integer, boolean and float leaves, a scalar."""
    return {"z": [rs.normal(size=(3, 4)).astype(np.float32),
                  (rs.integers(0, 9, size=(5,)).astype(np.int32),
                   np.float32(2.5))],
            "a": Pair(a={"w": rs.normal(size=(2, 3, 2)).astype(np.float32),
                         "mask": rs.integers(0, 2, size=(7,)).astype(bool)},
                      b=rs.normal(size=(6,)).astype(np.float16)),
            "m": {}}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(*(_map(x, fn) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(x, fn) for x in tree)
    return fn(tree)


def _torch(tree):
    return _map(tree, lambda x: torch.from_numpy(np.asarray(x).copy()))


def _jax(tree):
    return _map(tree, jnp.asarray)


def test_path_str_matches_reference():
    tree = _tree(np.random.default_rng(0))
    want = [RU.path_str(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(_jax(tree))[0]]
    got = [U.path_str(p) for p, _ in tree_flatten_with_path(_torch(tree))[0]]
    assert got == want
    assert "a/a/mask" in got and "z/1/0" in got


def test_tree_size_matches_reference():
    tree = _tree(np.random.default_rng(1))
    assert U.tree_size(_torch(tree)) == RU.tree_size(_jax(tree)) == 43
    assert U.tree_size(tree) == RU.tree_size(tree)


@pytest.mark.parametrize("delta,rtol,atol", [
    (0.0, 1e-5, 1e-6), (1e-7, 1e-5, 1e-6), (1e-3, 1e-5, 1e-6),
    (1e-3, 1e-2, 1e-6), (1e-3, 1e-5, 1e-2)])
def test_tree_allclose_matches_reference(delta, rtol, atol):
    rs = np.random.default_rng(2)
    a = _tree(rs)
    b = _map(a, lambda x: x + delta if np.asarray(x).dtype.kind == "f"
             else x)
    want = RU.tree_allclose(_jax(a), _jax(b), rtol=rtol, atol=atol)
    got = U.tree_allclose(_torch(a), _torch(b), rtol=rtol, atol=atol)
    assert got == want


def test_tree_allclose_structure_mismatches_match_reference():
    a = _tree(np.random.default_rng(3))
    fewer = dict(a, z=a["z"][:1])
    reshaped = dict(a, z=[a["z"][0].reshape(4, 3), a["z"][1]])
    for b in (fewer, reshaped):
        assert U.tree_allclose(_torch(a), _torch(b)) is False
        assert RU.tree_allclose(_jax(a), _jax(b)) is False
    bf = {"x": torch.tensor([1.0, 2.0], dtype=torch.bfloat16)}
    assert U.tree_allclose(bf, {"x": torch.tensor([1.0, 2.0])})


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_cast_floating_matches_reference(dtype):
    tree = _tree(np.random.default_rng(4))
    want = jax.tree_util.tree_leaves(ref_cast_floating(_jax(tree),
                                                       jnp.dtype(dtype)))
    got = jax.tree_util.tree_leaves(cast_floating(_torch(tree),
                                                  getattr(torch, dtype)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                       else w)
        g = (g.float() if g.dtype == torch.bfloat16 else g).numpy()
        assert np.array_equal(g, w)
