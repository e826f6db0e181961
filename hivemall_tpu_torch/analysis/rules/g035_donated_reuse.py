"""G035 static-output-kept-across-replays: the loop and cross-module gap.

G005 catches straight-line reads of a graphed callable's output after a
later call, but only when the graphed alias is declared in the same
module (``name = torch.cuda.make_graphed_callables(...)``). Two live
classes escape it:

(a) **outputs kept across replays in a loop**: a graphed call inside a
    loop whose output is kept past the iteration — appended, inserted,
    added or stored into a container, directly or through the name bound
    to it — without ``.clone()``. Every kept entry aliases the same static
    buffer, so after the loop all of them hold the last replay's values.
    The sanctioned carry rebinds the output each pass (``best =
    merge(best, cand)``) and keeps only the last.
(b) **interprocedurally-graphed callees**: ``self._merge =
    self._build_merge()`` where the factory ``return``s
    ``make_graphed_callables(...)`` — or the memo-thunk form
    ``self._step = _step_graph(key, lambda: _build_step())``. G005's
    alias map cannot see these; traceflow resolves them, and this rule
    runs G005's straight-line scan over exactly the resolved-only aliases
    (module-local aliases stay G005's subject — no double findings).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from ..findings import Finding, Severity
from ..modmodel import enclosing_loop, walk_scope
from ..program import ProgramModel
from ..traceflow import module_info
from .g005_donation import _scan_block, graphed_callee, output_bindings

RULE_ID = "G035"

_KEEPING_METHODS = ("append", "appendleft", "extend", "insert", "add")


def _kept(node: ast.AST) -> bool:
    """``node`` (a call or a name) is kept past the iteration: an argument
    of a container's keeping method, or the value stored into a
    subscript."""
    parent = getattr(node, "graftcheck_parent", None)
    if isinstance(parent, (ast.Tuple, ast.List)):
        node, parent = parent, getattr(parent, "graftcheck_parent", None)
    if isinstance(parent, ast.Call) and node in parent.args \
            and isinstance(parent.func, ast.Attribute) \
            and parent.func.attr in _KEEPING_METHODS:
        return True
    return isinstance(parent, ast.Assign) and parent.value is node \
        and any(isinstance(t, ast.Subscript) for t in parent.targets)


def check_program(program: ProgramModel, scanned: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()

    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None:
            continue
        info = module_info(model)
        # module aliases + interprocedurally-resolved ones (pattern a
        # needs both: the kept-output gap exists for either kind)
        graphed: Dict[str, object] = {
            name: wrap for name, wrap in model.jit_aliases.items()
            if wrap.graphed}
        graphed.update(info.graphed)

        def emit(node: ast.AST, msg: str, sev: str) -> None:
            if (path, node.lineno) in seen:
                return
            seen.add((path, node.lineno))
            findings.append(Finding(path, node.lineno, RULE_ID, sev, msg,
                                    model.snippet(node.lineno)))

        if not graphed:
            continue
        for fn in model.functions:
            if model.is_traced(fn):
                continue
            # (a) a graphed output kept past its iteration
            for node in walk_scope(fn):
                if not isinstance(node, ast.Call) \
                        or enclosing_loop(node) is None:
                    continue
                alias = graphed_callee(node, graphed)
                if alias is None:
                    continue
                kept = [node] if _kept(node) else []
                stmt = getattr(node, "graftcheck_parent", None)
                while stmt is not None and not isinstance(stmt, ast.stmt):
                    stmt = getattr(stmt, "graftcheck_parent", None)
                names = {n for n, _a, _e in output_bindings(stmt, graphed)}
                loop = enclosing_loop(node)
                kept += [n for n in ast.walk(loop)
                         if isinstance(n, ast.Name) and n.id in names
                         and isinstance(n.ctx, ast.Load) and _kept(n)]
                for where in kept:
                    emit(where,
                         f"the output of graphed `{alias}` is kept past its "
                         f"loop iteration without `.clone()` — every kept "
                         f"entry aliases the same static graph buffer, so "
                         f"all of them hold the last replay's values; keep "
                         f"`.clone()` of it", Severity.ERROR)
            # (b) straight-line scan over the resolved-only aliases
            if info.graphed:
                _scan_block(model, fn, list(fn.body), info.graphed, emit)
    return findings
