"""Hindsight probes: which blocks must be re-executed on replay?

Two detection tiers:
  * explicit — the user passes probed={"train"} (or "*") to the ReplaySpec;
    the functional tier's normal path;
  * source diff (the paper's mechanism, section 3.2) — record stores a copy
    of the script; at replay the current file is diffed against it, each
    ADDED line is mapped to its innermost enclosing loop, and that loop is
    marked probed. Deleted/changed non-logging lines are reported as
    suspicious (replay assumes only log statements were added).

Loop identity: a loop whose iterator is a ``flor.loop("name", ...)`` /
``sess.loop("name", ...)`` call is identified by that NAME (shift-proof:
adding lines above it cannot change the id); any other loop falls back to
``L<lineno>`` in the RECORDED source (added lines in the new file are
translated back through the diff's line alignment).

Probes also classify by DEPTH: a line added inside a top-level (main) loop
but outside any nested loop is an OUTER probe — it needs every epoch
restore-visited but no block re-executed; a line inside a nested loop is an
INNER probe — that block re-executes logically. ``replay/plan.py`` turns
this split into exec vs restore segments.
"""
from __future__ import annotations

import ast
import difflib
from dataclasses import dataclass, field


@dataclass
class LoopSpan:
    first: int                   # first source line of the loop statement
    last: int                    # last source line of its body
    name: str | None             # flor.loop("name", ...) when named
    depth: int = 0               # 0 = top-level (main) loop

    def block_id(self, lineno: int | None = None) -> str:
        return self.name if self.name is not None \
            else f"L{lineno if lineno is not None else self.first}"


@dataclass
class ProbeReport:
    probed_blocks: set = field(default_factory=set)  # inner loops: re-execute
    probed_outer: set = field(default_factory=set)   # main loops: restore-visit
    added_lines: list = field(default_factory=list)      # (new_lineno, text)
    suspicious: list = field(default_factory=list)       # non-additive edits

    @property
    def empty(self) -> bool:
        return not (self.probed_blocks or self.probed_outer)


def _flor_loop_name(node: ast.For) -> str | None:
    """The string name of a ``*.loop("name", ...)`` / ``loop("name", ...)``
    iterator call, if the loop has one."""
    it = node.iter
    if not isinstance(it, ast.Call) or not it.args:
        return None
    fn = it.func
    called = fn.attr if isinstance(fn, ast.Attribute) else \
        fn.id if isinstance(fn, ast.Name) else None
    if called != "loop":
        return None
    first = it.args[0]
    if isinstance(first, ast.Constant) and isinstance(first.value, str):
        return first.value
    return None


def loop_spans(src: str) -> list[LoopSpan]:
    """Every for/while loop in `src` with its span, flor name (when the
    iterator is a flor.loop/sess.loop call) and nesting depth."""
    tree = ast.parse(src)
    spans: list[LoopSpan] = []

    def walk(node, depth):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.For, ast.While)):
                name = _flor_loop_name(child) \
                    if isinstance(child, ast.For) else None
                spans.append(LoopSpan(child.lineno,
                                      child.end_lineno or child.lineno,
                                      name, depth))
                walk(child, depth + 1)
            else:
                # functions/classes reset loop depth: a loop inside a helper
                # called from the main loop is not "nested" syntactically
                nd = 0 if isinstance(child, (ast.FunctionDef,
                                             ast.AsyncFunctionDef,
                                             ast.ClassDef)) else depth
                walk(child, nd)

    walk(tree, 0)
    return spans


def _loop_spans(src: str) -> list[tuple[int, int, str]]:
    """Back-compat shape: (first_line, last_line, 'L<first>')."""
    return [(s.first, s.last, f"L{s.first}") for s in loop_spans(src)]


def detect_probes(recorded_src: str, current_src: str) -> ProbeReport:
    """Diff the recorded script against the current one and map every ADDED
    line to its innermost enclosing loop. Named flor loops are reported by
    name; anonymous loops by ``L<lineno>`` in the RECORDED source. Fast
    path: identical sources (or edits with no additions) never parse."""
    report = ProbeReport()
    if recorded_src == current_src:
        return report
    old = recorded_src.splitlines()
    new = current_src.splitlines()
    sm = difflib.SequenceMatcher(a=old, b=new)
    added: list[tuple[int, str]] = []
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "insert":
            for j in range(j1, j2):
                added.append((j + 1, new[j]))
        elif tag == "replace":
            # difflib coalesces an insertion ADJACENT to a changed line into
            # one replace block; split it by line similarity — a new line
            # with a close old counterpart is a CHANGED line (suspicious),
            # one without is an ADDED probe
            pool = list(range(i1, i2))
            for j in range(j1, j2):
                best, best_r = None, 0.0
                for i in pool:
                    r = difflib.SequenceMatcher(a=old[i], b=new[j]).ratio()
                    if r > best_r:
                        best, best_r = i, r
                if best is not None and best_r >= 0.6:
                    pool.remove(best)
                    report.suspicious.append(
                        {"tag": "replace", "old": [old[best]],
                         "new": [new[j]]})
                else:
                    added.append((j + 1, new[j]))
            for i in pool:                     # old lines with no new match
                report.suspicious.append(
                    {"tag": "delete", "old": [old[i]], "new": []})
        elif tag == "delete":
            report.suspicious.append(
                {"tag": tag, "old": old[i1:i2], "new": []})
    report.added_lines = added
    if not added:
        return report

    # map added lines to enclosing loops IN THE NEW source, then translate
    # anonymous loops back to their block id in the OLD source via line
    # alignment (named loops are shift-proof and need no translation)
    new_spans = loop_spans(current_src)
    new_to_old = {}
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            for k in range(i2 - i1):
                new_to_old[j1 + k + 1] = i1 + k + 1
    for lineno, _text in added:
        enclosing = [s for s in new_spans if s.first <= lineno <= s.last]
        if not enclosing:
            continue
        # innermost loop = max first_line
        inner = max(enclosing, key=lambda s: s.first)
        bid = inner.block_id(new_to_old.get(inner.first, inner.first))
        if inner.depth == 0:
            report.probed_outer.add(bid)
        else:
            report.probed_blocks.add(bid)
    return report
