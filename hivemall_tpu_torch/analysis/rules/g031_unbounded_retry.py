"""G031 unbounded-retry: a retry loop with no attempt cap or no backoff.

A probe loop that never gives up, generalized: a ``while True:`` loop
whose except handler neither raises, breaks, nor returns retries
*forever* — a persistent failure (bad artifact, dead endpoint) becomes
a 100%-CPU busy spin that also hammers the failing dependency. And a
retry that IS bounded but sleeps nowhere between attempts burns its
whole budget in microseconds, so the bound might as well not exist.

Flagged, in the failure-path scope:

- **no cap**: ``while True`` (or ``while 1``) containing a handler with
  no ``raise``/``break``/``return`` anywhere in its body — nothing ever
  stops the loop on persistent failure;
- **no backoff**: a retry loop (``while True`` with an escaping
  handler, or ``for _ in range(n)`` with a continuing handler) where
  neither the handler nor the loop body sleeps or waits
  (``config.BACKOFF_CALL_TAILS``) before the next attempt.

``cv.wait(timeout)`` counts as backoff — blocking on a condition
variable IS the well-behaved form of waiting. No machine fix: the right
cap and delay are policy, not syntax.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .. import config
from ..exceptionflow import classify_handler, get_model, in_exception_scope
from ..findings import Finding, Severity
from ..modmodel import dotted_name, walk_scope
from ..program import ProgramModel

RULE_ID = "G031"


def _is_while_true(node: ast.While) -> bool:
    return isinstance(node.test, ast.Constant) and bool(node.test.value)


def _is_range_for(node: ast.For) -> bool:
    if not isinstance(node.iter, ast.Call):
        return False
    return (dotted_name(node.iter.func) or "").rsplit(".", 1)[-1] == "range"


def _has_exit(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Break, ast.Return)):
            return True
    return False


def _can_fall_through(handler: ast.ExceptHandler) -> bool:
    """The handler can reach the next loop iteration: an explicit
    ``continue``, or a body that does not end in raise/return/break."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Continue):
            return True
    last = handler.body[-1]
    return not isinstance(last, (ast.Raise, ast.Return, ast.Break))


def _has_backoff(ef, path: str, root: ast.AST) -> bool:
    """A sleep/wait lexically in the loop, or one call deep: a server
    loop whose take-next-item helper blocks on a CV (the batcher shape)
    is paced by that wait even though the wait is not in the loop body."""
    for node in ast.walk(root):
        if not isinstance(node, ast.Call):
            continue
        d = dotted_name(node.func)
        if d is None:
            continue
        if d.rsplit(".", 1)[-1] in config.BACKOFF_CALL_TAILS:
            return True
        got = ef.resolve_callee(path, node, d)
        if got is not None:
            t_model = ef.program.modules.get(got[0])
            if t_model is not None:
                for sub in walk_scope(got[1]):
                    if isinstance(sub, ast.Call):
                        sd = dotted_name(sub.func)
                        if sd is not None and sd.rsplit(".", 1)[-1] in \
                                config.BACKOFF_CALL_TAILS:
                            return True
    return False


def _retry_handlers(loop: ast.AST) -> List[ast.ExceptHandler]:
    """Handlers of Trys directly inside the loop (not nested loops)."""
    out: List[ast.ExceptHandler] = []
    stack = list(loop.body)
    while stack:
        stmt = stack.pop()
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            continue  # inner loop: its own retry structure
        if isinstance(stmt, ast.Try):
            out.extend(stmt.handlers)
            stack.extend(stmt.body + stmt.orelse + stmt.finalbody)
            continue
        for attr in ("body", "orelse"):
            suite = getattr(stmt, attr, None)
            if isinstance(suite, list):
                stack.extend(s for s in suite if isinstance(s, ast.stmt))
    return out


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    ef = get_model(program)
    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None or not in_exception_scope(path, model):
            continue
        for fn in model.functions:
            for node in walk_scope(fn):
                is_spin = isinstance(node, ast.While) \
                    and _is_while_true(node)
                is_capped_for = isinstance(node, ast.For) \
                    and _is_range_for(node)
                if not (is_spin or is_capped_for):
                    continue
                retrying = [h for h in _retry_handlers(node)
                            if _can_fall_through(h)]
                if not retrying:
                    continue  # every handler escapes: not a retry loop
                h = min(retrying, key=lambda h: h.lineno)
                # a handler that DELIVERS the failure (set_exception on a
                # Future, a loud surface) is a serve loop handling per-item
                # errors, not a silent spin — only the backoff arm applies
                uncapped = [r for r in retrying if not _has_exit(r)
                            and not (classify_handler(r).loud
                                     or classify_handler(r).resolves_future)]
                if isinstance(node, ast.While) and uncapped:
                    h = min(uncapped, key=lambda h: h.lineno)
                    findings.append(Finding(
                        path, h.lineno, RULE_ID, Severity.WARNING,
                        "unbounded retry: this handler swallows the "
                        "failure and `while True` re-enters the attempt "
                        "with no cap — a persistent failure retries "
                        "forever; count attempts and raise past a limit",
                        model.snippet(h.lineno)))
                elif not _has_backoff(ef, path, node):
                    findings.append(Finding(
                        path, h.lineno, RULE_ID, Severity.WARNING,
                        "retry without backoff: the loop re-attempts "
                        "immediately after a failure — add a sleep/wait "
                        "between attempts so a failing dependency is not "
                        "hammered at CPU speed",
                        model.snippet(h.lineno)))
    return findings
