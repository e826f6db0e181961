"""G027 future-leak: a handed-out Future that an exception path never resolves.

The serving stack's contract is promise-shaped: ``submit`` hands the
caller a Future and the batcher/cache/coalescing machinery guarantees
someone eventually calls ``set_result`` or ``set_exception`` on it. A
statement that can raise *after* the Future escaped (queued, stored on
self, registered with the cache) and *before* its resolution breaks the
contract silently — the client blocks in ``Future.result()`` forever,
the hung-client bug class.

The rule uses the exception-flow model's Future lifecycle: a direct
``x = Future()`` local that escapes (passed to a call, stored into an
attribute/subscript) is flagged at every statement that can provably
raise out of the owner (explicit ``raise`` or a resolvable callee with a
non-empty raise summary) after the escape, unless the raise is covered
by a handler or ``finally`` that resolves the Future, or a
straight-line resolution already ran. Returning a Future is a hand-off
of the resolution duty, not an escape.

Scope: serving/pipeline/runtime plus ``# graftcheck: failure-path-module``.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ..exceptionflow import get_model, in_exception_scope
from ..findings import Finding, Severity
from ..modmodel import dotted_name, walk_scope
from ..program import ProgramModel

RULE_ID = "G027"

_RESOLVE_TAILS = ("set_result", "set_exception")


def _ancestors(node: ast.AST, fn: ast.AST):
    cur = getattr(node, "graftcheck_parent", None)
    while cur is not None and cur is not fn:
        yield cur
        cur = getattr(cur, "graftcheck_parent", None)


def _escape_line(fn: ast.AST, name: str) -> Optional[int]:
    """First line where the Future named ``name`` leaves the owner's
    hands: passed as an argument, or stored into an attr/subscript."""
    first: Optional[int] = None

    def note(line: int) -> None:
        nonlocal first
        if first is None or line < first:
            first = line

    for node in walk_scope(fn):
        if isinstance(node, ast.Call):
            callee = dotted_name(node.func) or ""
            if callee.split(".", 1)[0] == name:
                continue  # a method ON the future is not an escape
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id == name:
                    note(node.lineno)
        elif isinstance(node, ast.Assign):
            if isinstance(node.value, ast.Name) and node.value.id == name:
                for tgt in node.targets:
                    if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                        note(node.lineno)
    return first


def _resolutions(fn: ast.AST, name: str) -> List[ast.Call]:
    out = []
    for node in walk_scope(fn):
        if isinstance(node, ast.Call):
            d = dotted_name(node.func)
            if d is not None and d.split(".", 1)[0] == name \
                    and d.rsplit(".", 1)[-1] in _RESOLVE_TAILS:
                out.append(node)
    return out


def _linear(node: ast.AST, fn: ast.AST) -> bool:
    """Executed unconditionally on the owner's straight-line path: no
    branch, loop, or handler between the node and the function."""
    return not any(isinstance(a, (ast.If, ast.While, ast.For,
                                  ast.AsyncFor, ast.ExceptHandler))
                   for a in _ancestors(node, fn))


def _subtree_resolves(nodes, name: str) -> bool:
    for root in nodes:
        for node in ast.walk(root):
            if isinstance(node, ast.Call):
                d = dotted_name(node.func)
                if d is not None and d.split(".", 1)[0] == name \
                        and d.rsplit(".", 1)[-1] in _RESOLVE_TAILS:
                    return True
    return False


def _covered(site: ast.AST, fn: ast.AST, name: str) -> bool:
    """A Try around the raising site resolves the Future on unwind —
    in a handler body or a finally block."""
    child = site
    for anc in _ancestors(site, fn):
        if isinstance(anc, ast.Try):
            # `child` is the chain element directly under the Try: an
            # ExceptHandler when the site raises from a handler body (the
            # try's own handlers no longer apply), a body stmt otherwise
            if _subtree_resolves(anc.finalbody, name):
                return True
            if not isinstance(child, ast.ExceptHandler) \
                    and _subtree_resolves(list(anc.handlers), name):
                return True
        child = anc
    return False


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    ef = get_model(program)
    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None or not in_exception_scope(path, model):
            continue
        for fn in model.functions:
            futures = ef.future_locals(fn)
            if not futures:
                continue
            raise_sites: Optional[List[Tuple[str, ast.AST]]] = None
            for name, created in sorted(futures.items()):
                escape = _escape_line(fn, name)
                if escape is None:
                    continue
                if raise_sites is None:
                    raise_sites = list(ef.escaping_raises(path, fn))
                linear_res = [r.lineno for r in _resolutions(fn, name)
                              if _linear(r, fn)]
                seen_lines: Set[int] = set()
                for exc, site in raise_sites:
                    line = site.lineno
                    if line <= escape or line in seen_lines:
                        continue
                    if any(r < line for r in linear_res):
                        continue  # already resolved on this path
                    if _covered(site, fn, name):
                        continue
                    seen_lines.add(line)
                    findings.append(Finding(
                        path, line, RULE_ID, Severity.ERROR,
                        f"Future `{name}` (created line {created.lineno}, "
                        f"handed out line {escape}) can leak: this "
                        f"statement can raise {exc} and unwind past its "
                        f"resolution — the holder blocks in result() "
                        f"forever; resolve it in an except/finally "
                        f"(set_exception) before letting the unwind "
                        f"continue", model.snippet(line)))
    return findings
