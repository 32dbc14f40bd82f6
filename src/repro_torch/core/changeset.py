"""Static side-effect analysis (paper section 5.2.1, Table 1).

Estimates the changeset of a loop from its AST using the paper's six rules,
in descending precedence:

  rule 0  v1..vn = u1..um  with some vi already in the changeset -> refuse
  rule 1  v1..vn = obj.method(args)       -> {obj, v1..vn}
  rule 2  v1..vn = func(args)             -> {v1..vn}
  rule 3  v1..vn = u1..um                 -> {v1..vn}
  rule 4  obj.method(args)                -> {obj}
  rule 5  func(args)                      -> refuse (unknown side effects)

followed by loop-scoped filtering (variables first bound inside the loop are
dropped) and framework-knowledge augmentation (e.g. "an optimizer in the
changeset implies the model it optimizes changed") which runs at runtime so
isinstance checks can be used.

This is the SCRIPT tier: the functional tier's changeset is simply the
TrainState (state.py). Both tiers share the SkipBlock machinery.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class ChangesetResult:
    ok: bool
    changeset: list[str] = field(default_factory=list)   # ordered, deduped
    refused_reason: Optional[str] = None
    rule_trace: list[tuple[int, str]] = field(default_factory=list)
    loop_scoped: list[str] = field(default_factory=list)


def _root_name(node: ast.AST) -> Optional[str]:
    """obj.method -> 'obj'; pkg.mod.fn -> 'pkg'. None if not name-rooted."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _target_names(t: ast.AST) -> Optional[list[str]]:
    """Flatten assignment targets to plain names; None if non-name targets
    (attribute/subscript assignment -> treat root object as modified)."""
    if isinstance(t, ast.Name):
        return [t.id]
    if isinstance(t, (ast.Tuple, ast.List)):
        out = []
        for e in t.elts:
            sub = _target_names(e)
            if sub is None:
                return None
            out.extend(sub)
        return out
    return None


def analyze_loop(loop: ast.For | ast.While,
                 outer_assigned: Optional[set] = None) -> ChangesetResult:
    """Apply Table 1 to the loop body. `outer_assigned`: names bound before
    the loop in the enclosing scope (for loop-scoped filtering)."""
    changeset: list[str] = []
    bound_in_loop: set[str] = set()
    trace: list[tuple[int, str]] = []

    if isinstance(loop, ast.For):
        tn = _target_names(loop.target)
        if tn:
            bound_in_loop.update(tn)
            for n in tn:
                if n not in changeset:
                    changeset.append(n)
            trace.append((2, f"loop target {tn}"))

    def add(names):
        for n in names:
            if n not in changeset:
                changeset.append(n)

    def visit_stmt(stmt) -> Optional[str]:
        """Returns a refusal reason or None."""
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
                value = stmt.value
            elif isinstance(stmt, ast.AugAssign):
                targets = [stmt.target]
                value = stmt.value
            else:
                targets = [stmt.target] if stmt.value is not None else []
                value = stmt.value
            names: list[str] = []
            for t in targets:
                tn = _target_names(t)
                if tn is None:
                    root = _root_name(t)
                    if root is None:
                        return f"unanalyzable assignment target at line {stmt.lineno}"
                    names.append(root)
                else:
                    names.extend(tn)
            # rule 0 (highest precedence): assignment to a variable already
            # in the changeset — without alias analysis the old value would
            # be missing from the Loop End Checkpoint, so refuse.
            if isinstance(stmt, ast.Assign) and any(n in changeset for n in names):
                trace.append((0, ast.unparse(stmt)))
                return (f"rule 0: reassignment of changed variable "
                        f"{[n for n in names if n in changeset]} at line "
                        f"{stmt.lineno}")
            if isinstance(value, ast.Call):
                if isinstance(value.func, ast.Attribute):
                    obj = _root_name(value.func)
                    trace.append((1, ast.unparse(stmt)))
                    add(([obj] if obj else []) + names)
                else:
                    trace.append((2, ast.unparse(stmt)))
                    add(names)
            else:
                trace.append((3, ast.unparse(stmt)))
                add(names)
            bound_in_loop.update(n for n in names
                                 if n not in (outer_assigned or set()))
            return None
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            if isinstance(call.func, ast.Attribute):
                obj = _root_name(call.func)
                trace.append((4, ast.unparse(stmt)))
                if obj:
                    add([obj])
                return None
            trace.append((5, ast.unparse(stmt)))
            return (f"rule 5: side-effecting call "
                    f"'{ast.unparse(call)[:40]}' at line {stmt.lineno}")
        if isinstance(stmt, (ast.If, ast.With)):
            for s in (stmt.body + getattr(stmt, "orelse", [])):
                r = visit_stmt(s)
                if r:
                    return r
            return None
        if isinstance(stmt, (ast.For, ast.While)):
            # nested loop: fold its (recursive) changeset in
            sub = analyze_loop(stmt, outer_assigned)
            if not sub.ok:
                return sub.refused_reason
            add(sub.changeset)
            return None
        if isinstance(stmt, (ast.Pass, ast.Break, ast.Continue, ast.Expr)):
            return None
        if isinstance(stmt, (ast.Import, ast.ImportFrom, ast.FunctionDef,
                             ast.Return, ast.Raise, ast.Assert, ast.Delete,
                             ast.Global, ast.Nonlocal, ast.Try)):
            return f"unsupported statement {type(stmt).__name__} at line {stmt.lineno}"
        return None

    for stmt in loop.body:
        reason = visit_stmt(stmt)
        if reason:
            return ChangesetResult(ok=False, refused_reason=reason,
                                   rule_trace=trace)

    # loop-scoped filtering: drop names first bound inside the loop
    outer = outer_assigned or set()
    loop_scoped = [n for n in changeset if n in bound_in_loop and n not in outer]
    final = [n for n in changeset if n not in loop_scoped]
    return ChangesetResult(ok=True, changeset=final, rule_trace=trace,
                           loop_scoped=loop_scoped)


def outer_assignments(module: ast.Module, before_line: int) -> set:
    """Names assigned at module scope before a given line (incl. imports and
    for-targets) — the enclosing-scope binding set for loop-scoped filtering."""
    names: set[str] = set()
    for node in module.body:
        if node.lineno >= before_line:
            continue
        if isinstance(node, ast.Assign):
            for t in node.targets:
                tn = _target_names(t)
                if tn:
                    names.update(tn)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            tn = _target_names(node.target)
            if tn:
                names.update(tn)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names.add((a.asname or a.name).split(".")[0])
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.For):
            tn = _target_names(node.target)
            if tn:
                names.update(tn)
    return names


# ---------------------------------------------------------------------------
# Framework-knowledge augmentation (paper: "optimizer implies model").
# Runs at runtime on the actual objects so isinstance-style checks work.
# ---------------------------------------------------------------------------

_AUGMENTERS: list[Callable] = []


def register_augmenter(fn: Callable):
    """fn(name, obj, namespace) -> dict of extra {name: obj} implied changed."""
    _AUGMENTERS.append(fn)
    return fn


def augment_changeset(changeset: list[str], namespace: dict) -> list[str]:
    out = list(changeset)
    for name in list(changeset):
        obj = namespace.get(name)
        if obj is None:
            continue
        for aug in _AUGMENTERS:
            extra = aug(name, obj, namespace) or {}
            for n in extra:
                if n not in out:
                    out.append(n)
    return out


@register_augmenter
def _optimizer_implies_model(name, obj, namespace):
    """If an optimizer-like object is in the changeset, the parameters it
    optimizes changed too (paper's PyTorch fact (a)); likewise an LR
    scheduler implies its optimizer (fact (b))."""
    out = {}
    tracked = getattr(obj, "flor_tracks", None)
    if callable(tracked):
        for tname in tracked():
            if tname in namespace:
                out[tname] = namespace[tname]
    return out
