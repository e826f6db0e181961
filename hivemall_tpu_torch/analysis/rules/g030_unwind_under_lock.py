"""G030 unsafe-unwind-under-lock: an exception leaves a lock held or state torn.

Two unwind hazards the G012-G016 held-set machinery deliberately does
not model (``_collect`` walks ``Try`` with the same held set — it
assumes every unwind releases):

1. **Manual acquire without finally** — ``X.acquire()`` ... work ...
   ``X.release()`` in the same suite: any statement in between that
   unwinds skips the release and every other thread deadlocks on X
   forever. The with-statement (or ``try/finally``) is the only
   exception-safe shape. Machine fix: wrap the region in
   ``try:``/``finally: X.release()``.

2. **Half-updated state** — inside a ``with <lock>:`` suite, a call
   that provably raises (non-empty raise summary in the exception-flow
   model) *between two writes to self state*: the unwind releases the
   lock with the invariant the lock guards half-applied, and the next
   reader sees torn state. The fix is ordering (compute first, then
   write) or a handler that rolls back — a judgement call, so no
   machine fix.

Scope: serving/pipeline/runtime plus ``# graftcheck: failure-path-module``.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from ..exceptionflow import get_model, in_exception_scope
from ..findings import Finding, Fix, Severity, WrapFinally
from ..modmodel import _FN_TYPES, dotted_name, walk_scope
from ..program import ProgramModel

RULE_ID = "G030"


def _protocol_call(stmt: ast.stmt, tail: str) -> Optional[str]:
    """Receiver dotted prefix when stmt is ``<recv>.<tail>()``."""
    if not (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)):
        return None
    d = dotted_name(stmt.value.func)
    if d is None or not d.endswith("." + tail):
        return None
    return d[:-(len(tail) + 1)]


def _suites(fn: ast.AST) -> Iterator[List[ast.stmt]]:
    """Every statement list in the function scope."""
    yield fn.body
    for node in walk_scope(fn):
        for attr in ("body", "orelse", "finalbody"):
            suite = getattr(node, attr, None)
            if isinstance(suite, list) and suite \
                    and isinstance(suite[0], ast.stmt) \
                    and not isinstance(node, _FN_TYPES + (ast.ClassDef,)):
                yield suite


def _wrap_fix(model, region: List[ast.stmt], release: ast.stmt
              ) -> Optional[Fix]:
    """try/finally wrap when the region lines are contiguous single-suite
    lines right up to a single-line release statement."""
    start = region[0].lineno
    end = release.lineno
    if release.end_lineno != end or region[-1].end_lineno >= end:
        return None
    if region[0].col_offset != release.col_offset:
        return None
    return Fix(wrap=WrapFinally(start=start, release_line=end,
                                release_text=model.snippet(end)))


def _check_manual_acquire(model, path: str, fn: ast.AST,
                          findings: List[Finding]) -> None:
    for suite in _suites(fn):
        for i, stmt in enumerate(suite):
            recv = _protocol_call(stmt, "acquire")
            if recv is None:
                continue
            for j in range(i + 1, len(suite)):
                if _protocol_call(suite[j], "release") == recv:
                    region = suite[i + 1:j]
                    if not region:
                        break
                    findings.append(Finding(
                        path, stmt.lineno, RULE_ID, Severity.ERROR,
                        f"manual `{recv}.acquire()` with the release "
                        f"{suite[j].lineno - stmt.lineno} lines below in "
                        f"the same suite: any unwind in between leaves "
                        f"`{recv}` held forever — use `with {recv}:` or "
                        f"wrap the region in try/finally",
                        model.snippet(stmt.lineno),
                        fix=_wrap_fix(model, region, suite[j])))
                    break


def _self_writes(stmt: ast.stmt) -> bool:
    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        for tgt in targets:
            d = dotted_name(tgt)
            if d is not None and d.startswith("self."):
                return True
            if isinstance(tgt, ast.Subscript):
                d = dotted_name(tgt.value)
                if d is not None and d.startswith("self."):
                    return True
    return False


def _is_lock_ctx(item: ast.withitem) -> bool:
    d = dotted_name(item.context_expr)
    if d is None:
        return False
    tail = d.rsplit(".", 1)[-1]
    return tail.lstrip("_").startswith(("lock", "cv", "cond", "mutex")) \
        or d.startswith(("self._lock", "self._cv"))


def _raising_call(ef, path: str, stmt: ast.stmt) -> Optional[Tuple[str, int]]:
    """(exception, line) when a top-level call in the statement provably
    raises per the interprocedural summaries."""
    for call, dotted in ef._stmt_calls(stmt):
        got = ef.resolve_callee(path, call, dotted)
        if got is None:
            continue
        excs = ef.raises(got[0], got[1], 1)
        if excs:
            return sorted(excs)[0], call.lineno
    return None


def _check_torn_state(ef, model, path: str, fn: ast.AST,
                      findings: List[Finding]) -> None:
    for node in walk_scope(fn):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        if not any(_is_lock_ctx(item) for item in node.items):
            continue
        lock = next(dotted_name(i.context_expr) for i in node.items
                    if _is_lock_ctx(i))
        wrote = False
        for stmt in node.body:
            if isinstance(stmt, ast.Try):
                wrote = False  # guarded region: trust the handler
                continue
            raising = _raising_call(ef, path, stmt) \
                if wrote and not _self_writes(stmt) else None
            if raising is not None and any(
                    _self_writes(later) for later in
                    node.body[node.body.index(stmt) + 1:]):
                exc, line = raising
                findings.append(Finding(
                    path, line, RULE_ID, Severity.ERROR,
                    f"this call can raise {exc} between two writes to "
                    f"self state under `{lock}` — the unwind releases "
                    f"the lock with the guarded invariant half-applied; "
                    f"compute before the first write or roll back in a "
                    f"handler", model.snippet(line)))
                break
            if _self_writes(stmt):
                wrote = True


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    ef = get_model(program)
    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None or not in_exception_scope(path, model):
            continue
        for fn in model.functions:
            _check_manual_acquire(model, path, fn, findings)
            _check_torn_state(ef, model, path, fn, findings)
    return findings
