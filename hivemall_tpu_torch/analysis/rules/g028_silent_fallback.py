"""G028 silent-fallback: an except clause degrades service without a LOUD reason.

The convention — "fall back LOUDLY" — says every
handler that switches to degraded work (stale artifact, skipped eval,
default scores, disabled feature) must surface a *named* reason:
``warnings.warn``, a logging call, a trace instant, a metrics counter,
or the exception value itself stored somewhere a human will read. Until
now only point tests enforced it; a quiet ``except Exception:
use_stale()`` ships a silent data-quality regression.

Flagged: a handler that does real work (not just ``pass`` — that's
G029) but neither re-raises, surfaces loudly (``config.LOUD_CALL_TAILS``
/ ``LOUD_CALL_ROOTS``), resolves a Future (``set_exception`` hands the
reason to the caller), nor uses the bound exception variable. Two idioms are exempt: handlers
catching only API-probe types (``ImportError`` and friends,
``config.PROBE_EXCEPTION_TYPES``) — version probing — and a NARROW
catch whose whole body substitutes one literal default
(``except ValueError: n = 20``) — a total function, not a degradation.

Machine fix: splice ``warn(...)`` ahead of the handler's first simple
statement (plus ``from warnings import warn``), naming the caught
exception when the handler binds one.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .. import config
from ..exceptionflow import classify_handler, in_exception_scope
from ..findings import Edit, Finding, Fix, Severity
from ..modmodel import ModuleModel
from ..program import ProgramModel

RULE_ID = "G028"

_SIMPLE_STMTS = (ast.Expr, ast.Assign, ast.AugAssign, ast.AnnAssign,
                 ast.Return, ast.Delete, ast.Global, ast.Nonlocal)


def _probe_only(info) -> bool:
    return info.names is not None and all(
        n in config.PROBE_EXCEPTION_TYPES for n in info.names)


def _all_constants(value: ast.expr) -> bool:
    # a bare Name counts: `except ValueError: return default` substitutes
    # the already-bound default, the same total-function shape
    if isinstance(value, (ast.Tuple, ast.List)):
        return all(isinstance(e, (ast.Constant, ast.Name))
                   for e in value.elts)
    return isinstance(value, (ast.Constant, ast.Name))


def _constant_default(handler: ast.ExceptHandler) -> bool:
    """A single-statement handler substituting a literal default
    (``except ValueError: n = 20`` / ``return None``): the
    parse-with-default total-function idiom, not a degraded path —
    exempt when the catch is NARROW (a broad catch hiding behind a
    default still deserves a named reason or a rationale)."""
    if len(handler.body) != 1:
        return False
    stmt = handler.body[0]
    if isinstance(stmt, ast.Return):
        return stmt.value is None or _all_constants(stmt.value)
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
        return _all_constants(stmt.value)
    if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        return _all_constants(stmt.value)
    return False


def _warn_fix(model: ModuleModel, handler: ast.ExceptHandler,
              info) -> Optional[Fix]:
    """Prepend a warn() to the handler's first statement when it is a
    single-line simple statement (a compound or multi-line first
    statement can't take a within-line splice)."""
    first = handler.body[0]
    if not isinstance(first, _SIMPLE_STMTS) \
            or first.lineno != getattr(first, "end_lineno", first.lineno):
        return None
    old = model.snippet(first.lineno)
    if not old or old.startswith("warn"):
        return None
    caught = "/".join(info.names) if info.names else "exception"
    if info.exc_var:
        splice = (f"warn(f\"G028 fallback: {caught}: "
                  f"{{{info.exc_var}!r}}\", RuntimeWarning); ")
    else:
        splice = f"warn(\"G028 fallback on {caught}\", RuntimeWarning); "
    return Fix(edits=(Edit(first.lineno, old, splice + old),),
               add_import=("warnings", "warn"))


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None or not in_exception_scope(path, model):
            continue
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            info = classify_handler(node)
            if not info.has_work or info.reraises or info.loud \
                    or info.resolves_future or info.uses_exc \
                    or _probe_only(info):
                continue
            if not info.broad and _constant_default(node):
                continue
            caught = ", ".join(info.names) if info.names else "everything"
            findings.append(Finding(
                path, node.lineno, RULE_ID, Severity.WARNING,
                f"silent fallback: this handler (catching {caught}) "
                f"switches to degraded work without surfacing a reason — "
                f"warn/log/count the failure or store the exception so "
                f"the degradation is diagnosable (repo convention: fall "
                f"back LOUDLY)", model.snippet(node.lineno),
                fix=_warn_fix(model, node, info)))
    return findings
