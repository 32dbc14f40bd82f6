"""Cost analysis over a traced aten graph (reference: the reference
package's ``launch/hlo_analysis.py``, which reads XLA's optimized HLO).

For an eager PyTorch program the counterpart of "the optimized HLO" is the
aten graph that actually runs: ``make_fx`` of the step, printed by
``GraphModule.print_readable(print_output=False)`` with its ``"f32[...]"``
shape annotations. ``analyze(text)`` re-derives the roofline inputs from
that text, with the reference's keys:

  * flops       — 2*prod(result)*prod(contracting) per mm, addmm, bmm,
                  baddbmm, mv, dot and convolution
  * bytes       — operands + result per op (every eager op reads its
                  inputs from memory and writes its result: there is no
                  fusion to see through); view and alias ops cost zero, as
                  the reference's ``_ZERO_COST``; a gather reads and writes
                  its result's bytes, an in-place slice write (``copy_``,
                  ``index_put_``, ...) twice its source's
  * collectives — per-kind algorithmic bytes of ``_c10d_functional`` ops
                  (all-reduce 2x result, all-gather 1x result,
                  reduce-scatter 1x operand, all-to-all 1x result); all
                  zero on one card

A trace unrolls every Python loop (the layer stack, attention's KV chunks,
a pipeline's ticks), so each op of each iteration is in the text and the
reference's trip-count logic has nothing to port. Every number is per
device: the traced program is one process's.
"""
from __future__ import annotations

import math
import re

from torch.fx.graph import dtype_abbrs

_DTYPE_BYTES = {abbr: dt.itemsize for dt, abbr in dtype_abbrs.items()}

# `name: "f32[2, 3]" = torch.ops.aten.mm.default(a, b)`, the annotation
# absent for an op that returns a tuple (its getitems carry the shapes)
_NODE_RE = re.compile(
    r'^\s*(?P<name>\w+)(?::\s*"(?P<type>[^"]*)")?\s*=\s*(?P<rhs>.*)$')
_ANNOT_RE = re.compile(r'(\w+):\s*"([^"]*)"')
_SHAPE_RE = re.compile(r"^([a-z]\w*)\[([\d,\s]*)\]")
_OP_RE = re.compile(r"^torch\.ops\.(?P<ns>\w+)\.(?P<op>\w+)\.\w+\((?P<args>.*)\)"
                    r"(?:;.*)?$")
_GETITEM_RE = re.compile(r"^(\w+)\[\d+\](?:;.*)?$")
_IDENT_RE = re.compile(r"\b([A-Za-z_]\w*)\b")
_QUOTED_RE = re.compile(r"'[^']*'|\"[^\"]*\"")

_ZERO_COST = {
    "view", "_unsafe_view", "_reshape_alias", "reshape", "alias", "detach",
    "detach_", "as_strided", "expand", "permute", "select", "slice",
    "squeeze", "unsqueeze", "t", "transpose", "unbind", "split",
    "split_with_sizes", "chunk", "narrow", "diagonal", "unfold",
    "view_as_real", "view_as_complex", "lift_fresh_copy", "empty",
    "empty_like", "empty_strided", "new_empty", "sym_size", "sym_numel",
    "sym_stride", "_assert_tensor_metadata", "wait_tensor",
}
_GATHERS = {"embedding", "index_select", "gather", "index"}
_SLICE_WRITES = {"copy_", "index_put_", "index_copy_", "index_add_",
                 "scatter_", "scatter_add_", "masked_scatter_"}
_MATMULS = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot", "vdot"}
_CONVS = {"convolution", "_convolution"}
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "rsqrt", "sqrt", "pow", "div", "sigmoid", "sin", "cos",
                   "reciprocal", "erf"}
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_C10D = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all"}


def _dims(type_str: str):
    """(dtype abbreviation, dims) of an annotation, or None."""
    m = _SHAPE_RE.match(type_str or "")
    if not m:
        return None
    return m.group(1), [int(d) for d in m.group(2).split(",") if d.strip()]


def _elems_bytes(type_str: str):
    d = _dims(type_str)
    if d is None:
        return 0, 0
    n = math.prod(d[1])
    return n, n * _DTYPE_BYTES.get(d[0], 0)


def _split_args(args: str) -> list:
    """Top-level comma-separated arguments of a call."""
    out, depth, cur = [], 0, []
    for ch in args:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur).strip())
    return out


def _operands(args: list, symbols: dict) -> list:
    """Annotations of the tensor operands among ``args`` (lists of tensors
    included), in order; keyword arguments too."""
    out = []
    for a in args:
        a = a.split("=", 1)[1] if re.match(r"^\w+\s*=", a) else a
        for ident in _IDENT_RE.findall(_QUOTED_RE.sub("", a)):
            if ident in symbols:
                out.append(symbols[ident])
    return out


def parse_graph(text: str) -> list:
    """[(name, annotation or None, namespace, op, args, result
    annotations, operand annotations)] of the graph's calls, in order (a
    tuple-returning call's results are its getitems'); placeholders and
    getitems only feed the symbol table."""
    symbols: dict = {}
    tuples: dict = {}          # tuple-returning call -> its entry index
    calls: list = []
    for line in text.splitlines():
        s = line.strip()
        if not s or s.startswith("#") or s.startswith("class "):
            continue
        if s.startswith("def forward") or (";" in s and "=" not in s):
            for name, ann in _ANNOT_RE.findall(s):
                if name != "self":
                    symbols[name] = ann
            continue
        m = _NODE_RE.match(line)
        if not m:
            continue
        name, ann, rhs = m.group("name"), m.group("type"), m.group("rhs")
        g = _GETITEM_RE.match(rhs)
        if g:
            symbols[name] = ann
            if g.group(1) in tuples:
                calls[tuples[g.group(1)]][5].append(ann)
            continue
        om = _OP_RE.match(rhs)
        if not om:
            if ann is not None:            # a constant attribute
                symbols[name] = ann
            continue
        args = _split_args(om.group("args"))
        entry = (name, ann, om.group("ns"), om.group("op"), args,
                 [], _operands(args, symbols))
        if ann is None:
            tuples[name] = len(calls)
        else:
            symbols[name] = ann
            entry[5].append(ann)
        calls.append(entry)
    return calls


def _matmul_flops(op: str, results: list, operands: list) -> float:
    out = sum(_elems_bytes(r)[0] for r in results)
    lhs = {"addmm": 1, "baddbmm": 1, "addmv": 1}.get(op, 0)
    d = _dims(operands[lhs]) if len(operands) > lhs else None
    k = d[1][0 if op in ("dot", "vdot") else -1] if d and d[1] else 1
    return 2.0 * out * k


def _conv_flops(results: list, operands: list) -> float:
    out = sum(_elems_bytes(r)[0] for r in results[:1])
    w = _dims(operands[1]) if len(operands) > 1 else None
    return 2.0 * out * (math.prod(w[1][1:]) if w else 1)


def analyze(text: str) -> dict:
    out = {"flops": 0.0, "bytes": 0.0, "transcendentals": 0.0,
           "coll": {k: 0.0 for k in _COLLECTIVES},
           "coll_counts": {k: 0.0 for k in _COLLECTIVES},
           "unknown_trip": 0}
    for _, _, ns, op, _, results, operands in parse_graph(text):
        if op in _ZERO_COST:
            continue
        res_bytes = sum(_elems_bytes(r)[1] for r in results)
        opnd_bytes = sum(_elems_bytes(t)[1] for t in operands)
        if ns == "_c10d_functional" and op in _C10D:
            kind = _C10D[op]
            if kind == "all-reduce":
                moved = 2 * res_bytes
            elif kind == "reduce-scatter":
                moved = opnd_bytes
            else:
                moved = res_bytes
            out["coll"][kind] += moved
            out["coll_counts"][kind] += 1
            out["bytes"] += res_bytes + opnd_bytes
            continue
        if op in _MATMULS:
            out["flops"] += _matmul_flops(op, results, operands)
        elif op in _CONVS:
            out["flops"] += _conv_flops(results, operands)
        elif op.rstrip("_") in _TRANSCENDENTAL:
            out["transcendentals"] += sum(_elems_bytes(r)[0]
                                          for r in results)
        if op in _GATHERS:
            out["bytes"] += 2 * res_bytes
        elif op in _SLICE_WRITES:
            out["bytes"] += 2 * sum(_elems_bytes(t)[1] for t in operands[1:])
        else:
            out["bytes"] += res_bytes + opnd_bytes
    out["coll"]["total"] = sum(out["coll"][k] for k in _COLLECTIVES)
    return out


def analyze_graph(gm) -> dict:
    """``analyze`` of a traced ``GraphModule`` (the reference's
    ``analyze_compiled``)."""
    return analyze(gm.print_readable(print_output=False))
