"""G014 condition-variable misuse: wait outside a loop, notify unheld, re-acquire.

Three provable misuses of the ``threading.Condition`` protocol:

- **wait() not in a predicate loop**: spurious wakeups and notify races
  mean a woken waiter must re-check its predicate; ``if pred:
  cv.wait()`` proceeds on a stale condition. The single-statement form
  carries a machine fix (``--fix`` rewrites the ``if`` to ``while``).
- **notify()/notify_all() without the CV held**: raises RuntimeError at
  run time on the stdlib Condition — but only on the code path that
  reaches it, which a lightly-loaded test may never do.
- **re-acquiring a non-reentrant Lock through a helper**: ``with
  self._lock:`` then ``self._helper()`` whose body takes ``self._lock``
  again self-deadlocks; found through the same context propagation that
  powers the guarded-by inference (analysis/concurrency.py).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..concurrency import get_model
from ..findings import Edit, Finding, Fix, Severity
from ..modmodel import _FN_TYPES
from ..program import ProgramModel

RULE_ID = "G014"


def _enclosing_while(node: ast.AST) -> Optional[ast.While]:
    cur = getattr(node, "graftcheck_parent", None)
    while cur is not None and not isinstance(cur, _FN_TYPES):
        if isinstance(cur, ast.While):
            return cur
        cur = getattr(cur, "graftcheck_parent", None)
    return None


def _wait_loop_fix(call: ast.Call, model) -> Optional[Fix]:
    """``if <pred>:`` directly wrapping a lone ``cv.wait()`` statement
    rewrites to ``while <pred>:`` — a within-line, semantics-preserving
    repair (the predicate is simply re-checked after wakeup)."""
    stmt = getattr(call, "graftcheck_parent", None)
    if not isinstance(stmt, ast.Expr):
        return None
    branch = getattr(stmt, "graftcheck_parent", None)
    if not isinstance(branch, ast.If) or branch.orelse \
            or branch.body != [stmt]:
        return None
    if (branch.test.end_lineno or branch.lineno) != branch.lineno:
        return None  # multi-line test: hand repair
    line = model.snippet(branch.lineno)
    if not line.startswith("if "):
        return None  # elif arms can't become while
    return Fix(edits=(Edit(branch.lineno, "if ", "while "),))


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    cm = get_model(program)
    for (path, _cname), cls in sorted(cm.classes.items()):
        if path not in scanned:
            continue
        model = program.modules[path]
        conds = {name for name, kind in cls.locks.items()
                 if kind == "condition"}

        # (a) wait() outside a predicate loop — structural, per call site
        for mname in sorted(cls.raw):
            for ev in cls.raw[mname].calls:
                parts = ev.dotted.split(".")
                if len(parts) == 3 and parts[0] == "self" \
                        and parts[1] in conds and parts[2] == "wait" \
                        and _enclosing_while(ev.node) is None:
                    findings.append(Finding(
                        path, ev.line, RULE_ID, Severity.ERROR,
                        f"`self.{parts[1]}.wait()` is not inside a "
                        f"`while <predicate>` loop — spurious wakeups and "
                        f"notify races hand control back with the "
                        f"predicate still false; loop until it holds",
                        model.snippet(ev.line),
                        fix=_wait_loop_fix(ev.node, model)))

        # (b) notify()/notify_all() with the CV not held — context-aware
        seen_notify: Set[int] = set()
        for ev in cls.eff_calls:
            parts = ev.dotted.split(".")
            if len(parts) == 3 and parts[0] == "self" \
                    and parts[1] in conds \
                    and parts[2] in ("notify", "notify_all") \
                    and parts[1] not in ev.held \
                    and ev.line not in seen_notify:
                seen_notify.add(ev.line)
                findings.append(Finding(
                    path, ev.line, RULE_ID, Severity.ERROR,
                    f"`self.{parts[1]}.{parts[2]}()` without holding the "
                    f"condition variable — raises RuntimeError on the "
                    f"stdlib Condition, but only on the path that reaches "
                    f"it; wrap in `with self.{parts[1]}:`",
                    model.snippet(ev.line)))

        # (c) non-reentrant lock re-acquired through a helper chain
        for node, lock in sorted(cls.double_acquires,
                                 key=lambda t: t[0].lineno):
            findings.append(Finding(
                path, node.lineno, RULE_ID, Severity.ERROR,
                f"`self.{lock}` (a non-reentrant threading.Lock) is "
                f"re-acquired through this call chain — the thread "
                f"deadlocks on itself; use an RLock or split the locked "
                f"helper out of the locked region",
                model.snippet(node.lineno)))
    return findings
