"""G029 swallowed-exception-in-hot-path: broad except that discards the error.

``except Exception: pass`` (or a bare ``except:``) in the serving /
pipeline / runtime scopes erases the only evidence a failure happened —
no re-raise, no log, no counter, nothing. On the failure-path fronts
(replica death, elastic process loss) these are exactly the sites that
turn a diagnosable crash into a silent wedge. A *narrow* swallow
(``except KeyError: pass`` on a best-effort cache probe) is a
deliberate, reviewable choice and stays legal; swallowing *everything*
needs an inline rationale:

    except Exception:  # graftcheck: disable=G029 (best-effort unlink)
        pass

No machine fix — the repair is a judgement call (re-raise, surface, or
justify), so the rule only forces the judgement to be written down.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..exceptionflow import classify_handler, in_exception_scope
from ..findings import Finding, Severity
from ..program import ProgramModel

RULE_ID = "G029"


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
            if not info.swallow_only or not info.broad:
                continue
            what = "a bare except" if info.bare else \
                f"except {'/'.join(info.names or ())}"
            findings.append(Finding(
                path, node.lineno, RULE_ID, Severity.WARNING,
                f"{what} swallows every failure on the hot path with no "
                f"trace — re-raise, surface the reason, or suppress with "
                f"an inline rationale "
                f"(# graftcheck: disable=G029 (why))",
                model.snippet(node.lineno)))
    return findings
