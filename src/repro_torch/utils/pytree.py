"""Pytree helpers on ``torch.utils._pytree`` with the reference package's
flatten order and leaf paths.

Checkpoints name leaves by path strings and restore maps stored leaves onto a
``like`` tree by flatten order, so both must equal the reference package's
(jax's) exactly: dicts flatten in SORTED key order (torch's own pytree keeps
insertion order), and paths render as ``.params['embed']['table']`` — the
``keystr`` of torch's key classes, which matches jax's for dict
(``['k']``), list/tuple (``[0]``), NamedTuple and dataclass (``.field``)
nodes. ``None`` is an empty node (no leaves); everything else is a leaf.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as tp

keystr = tp.keystr


@dataclasses.dataclass(frozen=True)
class TreeDef:
    kind: str                 # leaf | none | dict | list | tuple | namedtuple | dataclass
    ctx: Any = None           # keys / field names / node type
    children: tuple = ()

    def __str__(self):
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = ", ".join(str(c) for c in self.children)
        return f"{self.kind}({inner})"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _node(x):
    """(kind, ctx, [(key object, child)]) for a node, None for a leaf."""
    if x is None:
        return "none", None, []
    if isinstance(x, dict):
        keys = sorted(x)
        return "dict", (type(x), tuple(keys)), \
            [(tp.MappingKey(k), x[k]) for k in keys]
    if _is_namedtuple(x):
        return "namedtuple", type(x), \
            [(tp.GetAttrKey(f), getattr(x, f)) for f in x._fields]
    if isinstance(x, (list, tuple)):
        return ("list" if isinstance(x, list) else "tuple"), len(x), \
            [(tp.SequenceKey(i), c) for i, c in enumerate(x)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return "dataclass", (type(x), names), \
            [(tp.GetAttrKey(f), getattr(x, f)) for f in names]
    return None


# The recursions below are module functions, not nested closures: a nested
# function that calls itself sits in a reference cycle with its closure,
# which would keep every leaf it saw alive until the garbage collector ran
# (a whole TrainState per train step on the card).

def _flatten(x, path, out: list, is_leaf) -> TreeDef:
    node = None if is_leaf is not None and is_leaf(x) else _node(x)
    if node is None:
        out.append((path, x))
        return TreeDef("leaf")
    kind, ctx, kids = node
    return TreeDef(kind, ctx, tuple(_flatten(c, path + (k,), out, is_leaf)
                                    for k, c in kids))


def tree_flatten_with_path(tree, is_leaf=None) -> tuple[list, TreeDef]:
    """([(key path tuple, leaf), ...], treedef) in the reference order;
    a node for which ``is_leaf`` holds is a leaf (as jax's ``is_leaf``)."""
    out: list = []
    treedef = _flatten(tree, (), out, is_leaf)
    return out, treedef


def tree_flatten(tree, is_leaf=None) -> tuple[list, TreeDef]:
    flat, treedef = tree_flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in flat], treedef


def tree_leaves(tree, is_leaf=None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def _unflatten(td: TreeDef, it):
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    kids = [_unflatten(c, it) for c in td.children]
    if td.kind == "dict":
        typ, keys = td.ctx
        return typ(zip(keys, kids))
    if td.kind == "namedtuple":
        return td.ctx(*kids)
    if td.kind == "list":
        return kids
    if td.kind == "tuple":
        return tuple(kids)
    typ, names = td.ctx
    return typ(**dict(zip(names, kids)))


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, None) is not None:
        raise ValueError("too many leaves for the tree structure")
    return out


_DICT_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|-?\d+)\]")


def _dict_keys(rest: str) -> list:
    """``"['a'][0]"`` -> ``['a', 0]``: a path suffix made only of dict
    keys; ValueError for anything else (an attribute, say)."""
    keys, at = [], 0
    for m in _DICT_KEY.finditer(rest):
        if m.start() != at:
            break
        keys.append(ast.literal_eval(m[1]))
        at = m.end()
    if at != len(rest) or not keys:
        raise ValueError(f"not a path of dict keys: {rest!r}")
    return keys


def _graft(x, path, items: dict, device):
    node = _node(x)
    if node is None:
        v = items.pop(keystr(path))
        return v.to(x.device) if isinstance(x, torch.Tensor) else v
    kind, ctx, kids = node
    if kind == "dict" and not kids:
        pre = keystr(path)
        out = type(x)()
        for p in [p for p in items if p.startswith(pre)]:
            *inner, last = _dict_keys(p[len(pre):])
            d = out
            for k in inner:
                d = d.setdefault(k, {})
            v = items.pop(p)
            d[last] = v.to(device) if device is not None else v
        return out
    vals = [_graft(c, path + (k,), items, device) for k, c in kids]
    if kind == "none":
        return None
    if kind == "dict":
        return ctx[0](zip(ctx[1], vals))
    if kind == "namedtuple":
        return ctx(*vals)
    if kind == "list":
        return vals
    if kind == "tuple":
        return tuple(vals)
    return ctx[0](**dict(zip(ctx[1], vals)))


def tree_graft(like, items: dict, device=None):
    """``like``'s structure filled from ``items`` ({keystr path: tensor}),
    each leaf by its path and on its ``like`` leaf's device, where an EMPTY
    dict of ``like`` takes the nested dicts that ``items`` hold below its
    path, on ``device`` (a script-tier changeset variable first bound to
    ``{}``, checkpointed once its loop filled it). KeyError / ValueError if
    a leaf is missing or one is left over."""
    items = dict(items)
    out = _graft(like, (), items, device)
    if items:
        raise ValueError(f"no place in the tree for {sorted(items)[:3]}")
    return out


def tree_map(fn: Callable, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def path_str(path) -> str:
    """A key path of ``tree_flatten_with_path`` as the reference's
    ``path_str`` renders a jax one: its keys joined by "/" (a dict key,
    a sequence index, an attribute name)."""
    parts = []
    for k in path:
        if isinstance(k, tp.MappingKey):
            parts.append(str(k.key))
        elif isinstance(k, tp.SequenceKey):
            parts.append(str(k.idx))
        elif isinstance(k, tp.GetAttrKey):
            parts.append(str(k.name))
        else:
            parts.append(str(k))
    return "/".join(parts)


def tree_leaves_with_paths(tree):
    """[(keystr path, leaf), ...] in the reference order."""
    flat, _ = tree_flatten_with_path(tree)
    return [(keystr(p), v) for p, v in flat]


def tree_bytes(tree) -> int:
    """Total bytes of all tensor / array leaves."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
    return total


def tree_size(tree) -> int:
    """Total element count of all tensor / array leaves."""
    return sum(int(leaf.numel()) if isinstance(leaf, torch.Tensor)
               else int(leaf.size) for leaf in tree_leaves(tree)
               if hasattr(leaf, "shape"))


def tree_allclose(a, b, rtol=1e-5, atol=1e-6) -> bool:
    """Whether two trees hold leaves of the same count and shapes whose
    values agree within ``rtol`` / ``atol`` (compared in float64, as the
    reference's ``np.allclose``)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x, y = _as_numpy(x), _as_numpy(y)
        if x.shape != y.shape or not np.allclose(
                x.astype(np.float64), y.astype(np.float64), rtol=rtol,
                atol=atol):
            return False
    return True


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def cast_floating(tree, dtype):
    """Cast floating-point tensor leaves to ``dtype``; leave integer and
    boolean leaves (and non-tensors) alone."""
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x, tree)


def block_until_ready(tree):
    """Wait until the card has finished every kernel producing the tree's
    CUDA tensors (the counterpart of jax.block_until_ready), so host
    timing around a block measures the work and not its enqueue."""
    devices = {leaf.device for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    return tree


def tree_digest(tree) -> str:
    """blake2b (16 bytes, hex) over every tensor leaf's bytes in flatten
    order: two trees with the same digest hold the same bits."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for leaf in tree_leaves(tree):
        t = leaf.detach().cpu().contiguous()
        if t.is_floating_point():
            t = t.view({2: torch.int16, 4: torch.int32,
                        8: torch.int64}[t.element_size()])
        h.update(t.numpy().tobytes())
    return h.hexdigest()
