"""G026 FFI unchecked return: a native status code is dropped on the floor.

The repo ABI returns ``int64_t`` status/count from every fallible
export (negative = refusal/error, else rows processed). A bare
``lib.hm_x(...)`` statement — or an assignment to ``_`` — discards
that code, so a native-side refusal (bad magic, overflow guard,
version check) silently becomes "worked fine" and the caller consumes
garbage output buffers. Only symbols whose declared ``restype`` is an
integer width are checked: ``restype = None`` marks a genuinely
void export (``hm_murmur3_bulk``), and undeclared symbols are G024's
subject, not this rule's.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..ffi import get_ffi
from ..findings import Finding, Severity
from ..program import ProgramModel

RULE_ID = "G026"

_INT_KINDS = ("i8", "i16", "i32", "i64")


def _discards(node: ast.Call) -> bool:
    parent = getattr(node, "graftcheck_parent", None)
    if isinstance(parent, ast.Expr):
        return True
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
        tgt = parent.targets[0]
        return isinstance(tgt, ast.Name) and tgt.id == "_"
    return False


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    ffi = get_ffi(program)
    all_decls = ffi.all_decls()
    for path in sorted(scanned):
        mod = ffi.modules.get(path)
        if mod is None:
            continue
        model = program.modules[path]
        seen = set()
        for fc in mod.calls:
            decl = mod.decls.get(fc.symbol) or all_decls.get(fc.symbol)
            if decl is None or decl.restype_kind not in _INT_KINDS:
                continue
            if not _discards(fc.node):
                continue
            if fc.node.lineno in seen:
                continue
            seen.add(fc.node.lineno)
            findings.append(Finding(
                path, fc.node.lineno, RULE_ID, Severity.ERROR,
                f"status code of native `{fc.symbol}` is discarded — the "
                f"ABI returns a negative value on refusal/error and this "
                f"call treats failure as success; capture the return and "
                f"check it (rc = ...; if rc < 0: raise/fallback)",
                model.snippet(fc.node.lineno)))
    return findings
