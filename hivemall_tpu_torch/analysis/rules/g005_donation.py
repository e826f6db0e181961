"""G005 static-output-reuse: a graphed callable's output read after a replay.

A graphed callable (``torch.cuda.make_graphed_callables(...)``, or
``torch.compile(..., mode="reduce-overhead")``) hands out its graph's
**static output buffers**: the next call replays the graph into the same
memory. A name bound to an earlier call's output and read after a later
call of the same callable sees the later call's values — the port's form
of the reference's read-after-donate (the buffer belongs to the graph
now). Flagged, straight-line per function body (nested blocks scanned in
statement order): a read of such a name after a later call, whether in a
later statement or to the right of the call in the same one. Rebinding
the name clears it; an output bound through ``.clone()`` (or any call) is
a copy and never tracked.

The reference's (a), a step-shaped jit without ``donate_argnums``, has no
provable torch form: the port's steps update their tables in place, so an
undonated capture keeps no second copy of them.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..findings import Finding, Severity
from ..modmodel import ModuleModel, dotted_name

RULE_ID = "G005"


def check(model: ModuleModel) -> List[Finding]:
    findings: List[Finding] = []

    def emit(node: ast.AST, msg: str, sev: str) -> None:
        findings.append(Finding(model.rel_path, node.lineno, RULE_ID, sev,
                                msg, model.snippet(node.lineno)))

    graphed = {name: wrap for name, wrap in model.jit_aliases.items()
               if wrap.graphed}
    if not graphed:
        return findings
    for fn in model.functions:
        if model.is_traced(fn):
            continue
        _scan_block(model, fn, list(fn.body), graphed, emit)
    return findings


def _assigned_names(stmt: ast.stmt):
    """Every name (re)bound anywhere within `stmt`, including inside
    compound-statement bodies — a rebind on any path clears the output."""
    for node in ast.walk(stmt):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                yield from _target_names(tgt)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            yield from _target_names(node.target)
        elif isinstance(node, ast.For):
            yield from _target_names(node.target)


def _target_names(tgt):
    if isinstance(tgt, ast.Name):
        yield tgt.id
    elif isinstance(tgt, (ast.Tuple, ast.List)):
        for elt in tgt.elts:
            yield from _target_names(elt)
    elif isinstance(tgt, ast.Starred):
        yield from _target_names(tgt.value)


def graphed_callee(call: ast.Call, graphed) -> Optional[str]:
    """The alias name when ``call`` calls a graphed callable."""
    callee = dotted_name(call.func)
    return callee if callee is not None and callee in graphed else None


def output_bindings(stmt: ast.stmt, graphed
                    ) -> List[Tuple[str, str, Tuple[int, int]]]:
    """(name, alias, end of the call) for every name that ``stmt`` binds
    directly to a graphed call's output: ``y = g(x)``, ``a, b = g(x)``,
    ``y = g(x)[0]``, ``a, b = g(x), g(z)``. A call wrapped in another
    (``g(x).clone()``) binds a copy."""
    out: List[Tuple[str, str, Tuple[int, int]]] = []

    def bind(tgt, value) -> None:
        while isinstance(value, ast.Subscript):
            value = value.value
        if isinstance(tgt, (ast.Tuple, ast.List)) \
                and isinstance(value, (ast.Tuple, ast.List)) \
                and len(tgt.elts) == len(value.elts):
            for t, v in zip(tgt.elts, value.elts):
                bind(t, v)
            return
        if isinstance(value, ast.Call):
            alias = graphed_callee(value, graphed)
            if alias is not None:
                out.extend((name, alias, _end(value))
                           for name in _target_names(tgt))

    if isinstance(stmt, ast.Assign):
        for tgt in stmt.targets:
            bind(tgt, stmt.value)
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        bind(stmt.target, stmt.value)
    return out


def _end(node: ast.AST) -> Tuple[int, int]:
    return (getattr(node, "end_lineno", node.lineno),
            getattr(node, "end_col_offset", node.col_offset))


def _scan_block(model, fn, stmts, graphed, emit) -> None:
    """Flag reads of a graphed call's output after a later call of the same
    callable, stopping at reassignment. Straight-line approximation:
    nested blocks are scanned in statement order."""
    live: Dict[str, str] = {}      # name -> alias whose output it holds
    stale: Dict[str, int] = {}     # name -> line of the overwriting call
    for stmt in stmts:
        calls = [(graphed_callee(n, graphed), _end(n))
                 for n in ast.walk(stmt) if isinstance(n, ast.Call)]
        calls = [(a, end) for a, end in calls if a is not None]
        rebound = set(_assigned_names(stmt))
        for node in ast.walk(stmt):
            if not (isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Load)):
                continue
            line = stale.get(node.id)
            if line is None and node.id in live:
                # to the right of a call of the same callable in this one
                at = (node.lineno, node.col_offset)
                later = [end for a, end in calls
                         if a == live[node.id] and end <= at]
                line = later[0][0] if later else None
            if line is None:
                continue
            emit(node, f"`{node.id}` read after the graphed callable "
                       f"`{live.get(node.id, '?')}` replayed again at line "
                       f"{line} — its output is a static graph buffer the "
                       f"later call overwrote; bind `.clone()` of the "
                       f"output to keep it", Severity.ERROR)
            stale.pop(node.id, None)
            live.pop(node.id, None)
        for alias, end in calls:
            for name, held in list(live.items()):
                if held == alias and name not in rebound:
                    stale[name] = end[0]
        for name in rebound:
            live.pop(name, None)
            stale.pop(name, None)
        for name, alias, end in output_bindings(stmt, graphed):
            live[name] = alias
            # `a, b = g(x), g(z)`: g(z) overwrote a's buffer
            later = [e for a, e in calls if a == alias and e > end]
            if later:
                stale[name] = later[0][0]
