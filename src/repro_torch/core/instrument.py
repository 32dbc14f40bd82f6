"""Auto-instrumentation (paper sections 3.1/4.2, Figs. 4 & 8).

Rewrites a training script's AST onto the SESSION surface so that:
  * the MAIN loop's iterator is wrapped in flor.loop("main_L<line>", ...)
    (Fig. 8's generator, session-surface spelling), and
  * each instrumentable nested loop becomes a named flor.loop inside a
    flor.checkpointing scope holding its statically-estimated changeset —
    captured at the Loop End Checkpoint, physically restored on skip.

A loop qualifies when the Table-1 analysis (core/changeset.py) produces a
changeset (no rule 0/5 refusal). Refused loops are left intact — they are
fully re-executed on replay, exactly the paper's behavior for the main loop.

The transform is purely syntactic:

    with flor.checkpointing(
            **flor.augment({"net": net, "opt": opt}, globals())) as __flor_s:
        for batch in flor.loop("L<line>", <original iterator>):
            try:
                <original body>
            finally:
                __flor_s.update(**flor.augment({"net": net, "opt": opt},
                                               globals()))
    net = __flor_s["net"]; opt = __flor_s["opt"]

(the per-iteration ``update`` keeps the scope tracking live values even
across ``continue``, mirroring the old end-of-block capture; a loop that
exits EARLY — ``break`` or an exception — writes no checkpoint for that
occurrence and warns, so replay re-executes it logically, which is the only
outcome consistent with a partially-run body).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.changeset import analyze_loop, outer_assignments


@dataclass
class InstrumentReport:
    main_loops: list[int] = field(default_factory=list)       # linenos
    instrumented: dict[str, list[str]] = field(default_factory=dict)
    refused: dict[int, str] = field(default_factory=dict)


def _block_id(loop: ast.stmt) -> str:
    return f"L{loop.lineno}"


def _loop_wrap(loop: ast.For, changeset: list[str]) -> list[ast.stmt]:
    bid = _block_id(loop)
    scope_var = f"__flor_scope_{bid}"
    dict_src = "{" + ", ".join(f"{n!r}: {n}" for n in changeset) + "}"
    update = ast.parse(f"{scope_var}.update(**flor.augment({dict_src}, "
                       f"globals()))").body[0]
    # per-iteration capture survives continue/break in the original body
    loop.body = [ast.Try(body=loop.body, handlers=[], orelse=[],
                         finalbody=[update])]
    # lazy iterator (lambda): a skipped replay epoch must not construct the
    # loader / consume a shared iterator — matching the old `if step_into:`
    # guard, which only evaluated the iterator when the block executed
    wrapped_iter = ast.parse(f"flor.loop({bid!r}, lambda: None)",
                             mode="eval").body
    wrapped_iter.args[1].body = loop.iter
    loop.iter = ast.copy_location(wrapped_iter, loop.iter)
    with_stmt = ast.parse(
        f"with flor.checkpointing(**flor.augment({dict_src}, globals())) "
        f"as {scope_var}:\n    pass").body[0]
    with_stmt.body = [loop]
    restores = [ast.parse(f"{n} = {scope_var}[{n!r}]").body[0]
                for n in changeset]
    return [with_stmt] + restores


class _Instrumenter(ast.NodeTransformer):
    def __init__(self, module: ast.Module, report: InstrumentReport):
        self.module = module
        self.report = report
        self._depth = 0

    def visit_For(self, node: ast.For):
        self._depth += 1
        try:
            node = self.generic_visit(node)     # instrument inner loops first
        finally:
            self._depth -= 1
        if self._depth == 0:
            # MAIN loop: wrap iterator in the outer flor.loop (Fig. 8's
            # generator); the loop itself is not skipped (paper: refused /
            # re-executed)
            self.report.main_loops.append(node.lineno)
            wrapped = ast.parse(f"flor.loop('main_L{node.lineno}', None)",
                                mode="eval").body
            wrapped.args[1] = node.iter
            node.iter = ast.copy_location(wrapped, node.iter)
            ast.fix_missing_locations(node)
            return node
        outer = outer_assignments(self.module, node.lineno)
        res = analyze_loop(node, outer_assigned=outer)
        if not res.ok:
            self.report.refused[node.lineno] = res.refused_reason or "?"
            return node
        self.report.instrumented[_block_id(node)] = res.changeset
        stmts = _loop_wrap(node, res.changeset)
        for s in stmts:
            ast.fix_missing_locations(s)
            ast.copy_location(s, node)
        return stmts


def instrument_source(src: str) -> tuple[str, InstrumentReport]:
    """Instrument a training script. Returns (new_source, report)."""
    module = ast.parse(src)
    report = InstrumentReport()
    tr = _Instrumenter(module, report)
    new_body = []
    for stmt in module.body:
        out = tr.visit(stmt)
        if isinstance(out, list):
            new_body.extend(out)
        elif out is not None:
            new_body.append(out)
    module.body = new_body
    header = ast.parse("import repro_torch.flor as flor").body
    module.body = header + module.body
    ast.fix_missing_locations(module)
    return ast.unparse(module), report


def exec_instrumented(path: str, namespace: Optional[dict] = None,
                      run_dir: Optional[str] = None, mode: str = "record",
                      **flor_kw) -> tuple[dict, InstrumentReport]:
    """The script tier's entry point: `import flor` is the only user-visible
    change; this function instruments and runs the file under Flor."""
    import repro_torch.flor as flor
    from repro_torch.core.session import Session, specs_from_kwargs
    with open(path) as f:
        src = f.read()
    new_src, report = instrument_source(src)
    ns = namespace if namespace is not None else {}
    ns.setdefault("__name__", "__main__")
    ns["flor"] = flor
    code = compile(new_src, path + ".flor", "exec")
    if run_dir is None:
        exec(code, ns)
        return ns, report
    record, replay, lineage = specs_from_kwargs(mode, flor_kw)
    with Session(run_dir, mode=mode, record=record, replay=replay,
                 lineage=lineage) as sess:
        if mode == "record":
            # keep a copy of the un-instrumented source for probe detection
            sess.ctx.store.put_meta("source", {"path": path, "src": src})
        exec(code, ns)
    return ns, report
