"""G023 FFI borrowed buffer: a temporary or view's pointer crosses the ABI with no owner live across the call.

``(a + b).ctypes.data_as(...)`` takes the address of an array that
nothing references once the argument expression is evaluated — CPython
is free to collect it mid-call (and with ``.ctypes.data`` there is not
even a ctypes object keeping it pinned), so the C side reads freed
memory. Slices, ``.T`` and ``transpose()`` results are worse in a
second way: they borrow the parent's buffer with *strides*, while the
ABI assumes dense C order — and when the C side writes through the
pointer, a strided view means it scribbles over unrelated elements of
the parent.

The safe idiom is two steps: bind a validated, C-contiguous copy to a
name (``tmp = np.ascontiguousarray(v, dtype=...)``), pass ``tmp``'s
pointer, and keep ``tmp`` alive past the call. Inline
``np.ascontiguousarray(..., dtype=...)`` in the argument itself is
accepted for ``data_as`` (the returned ctypes pointer keeps the fresh
array alive for the duration of the call).

No autofix: the repair moves an expression onto its own line, which is
a structural edit the within-line fixer does not do.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..ffi import (_match_pointer_expr, get_ffi, pointer_args,
                   scan_native_decls)
from ..findings import Finding, Severity
from ..program import ProgramModel

RULE_ID = "G023"


def _writes_through(symbol: str, index: int, cdecls) -> bool:
    """True when the C signature shows a non-const pointer at this
    positional index (the view-scribble case)."""
    if cdecls is None or index < 0:
        return False
    sig = cdecls.sigs.get(symbol)
    if sig is None or index >= len(sig.params):
        return False
    p = sig.params[index]
    return p.kind == "ptr" and not p.const


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    ffi = get_ffi(program)
    cdecls = scan_native_decls()
    for path in sorted(scanned):
        mod = ffi.modules.get(path)
        if mod is None:
            continue
        model = program.modules[path]
        seen = set()
        for fc in mod.calls:
            for pa in pointer_args(program, path, mod, fc):
                if pa.kind not in ("view", "temp"):
                    continue
                src = ast.get_source_segment(model.source, pa.base) or "?"
                if pa.kind == "view":
                    detail = ("a slice/transpose view — it borrows the "
                              "parent's buffer with strides while the ABI "
                              "assumes dense C order")
                    if _writes_through(fc.symbol, pa.index, cdecls):
                        detail += (", and the C side writes through this "
                                   "parameter, scribbling over unrelated "
                                   "parent elements")
                else:
                    detail = ("an expression temporary with no named "
                              "binding live across the call — the buffer "
                              "can be collected while the C side still "
                              "reads it")
                key = (fc.node.lineno, src)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    path, fc.node.lineno, RULE_ID, Severity.ERROR,
                    f"pointer of `{src}` passed to native `{fc.symbol}` "
                    f"is {detail}; bind a validated copy first "
                    f"(tmp = np.ascontiguousarray({src}, dtype=...)) and "
                    f"pass tmp, keeping it alive past the call",
                    model.snippet(fc.node.lineno)))
        # module-wide: raw addresses stashed from temporaries/views even
        # outside a foreign call (`p = (a+b).ctypes.data_as(...)`), and
        # bare integer addresses (.ctypes.data) taken off non-names —
        # nothing pins the buffer once the expression dies
        _sweep_stashed(program, path, model, mod, seen, findings)
    return findings


def _sweep_stashed(program: ProgramModel, path: str, model, mod,
                   seen: Set, findings: List[Finding]) -> None:
    from ..ffi import base_kind
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Assign):
            continue
        got = _match_pointer_expr(node.value, mod.asp_names,
                                  model.enclosing_function(node))
        if got is None:
            continue
        base, via = got
        fn = model.enclosing_function(node)
        kind = base_kind(program, path, model, fn, base, node.lineno)
        if via == "data" and kind not in ("name", "namedsub"):
            pass  # integer address of a dying buffer: always flag
        elif kind not in ("view", "temp"):
            continue
        src = ast.get_source_segment(model.source, base) or "?"
        key = (node.lineno, src)
        if key in seen:
            continue
        seen.add(key)
        what = ("slice/transpose view" if kind == "view"
                else "expression temporary")
        findings.append(Finding(
            path, node.lineno, RULE_ID, Severity.ERROR,
            f"raw pointer taken from {what} `{src}` and stored — the "
            f"underlying buffer is not owned by the stored pointer and "
            f"can be freed or reflect strided layout by the time it is "
            f"used; bind a validated C-contiguous copy to a name and "
            f"take the pointer from that",
            model.snippet(node.lineno)))
