"""G022 FFI unvalidated pointer: an array's raw pointer crosses the ABI without a dominating dtype+contiguity proof.

``x.ctypes.data_as(...)`` hands the C side a raw address plus *nothing
else* — no dtype, no strides, no length. If ``x`` arrived as float64
where the C signature reads float32, or as a Fortran-ordered or strided
array, the native loop reads (or writes) garbage at full speed: silent
memory corruption, not a traceback. Every pointer that crosses must be
dominated by a proof: ``np.ascontiguousarray(..., dtype=...)``, a fresh
dtype-pinned constructor (``np.zeros(n, dtype)``), an ``.astype`` copy,
the sanctioned ``plan_abi_arrays`` validator (which raises on any
drift), an explicit ``dtype``+``C_CONTIGUOUS`` guard statement, or a
helper whose every return is itself proven.

Fix: when the base's defining assignment is a single-line
``np.asarray(..., dtype=...)``, rewrite it to
``np.ascontiguousarray(..., dtype=...)`` — same dtype pin, adds the
contiguity guarantee. Other cases need a human (add a coercion or a
guard).

Expression temporaries and views are G023's subject; this rule covers
named bindings (and const-keyed subscripts like ``state["w"]``).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..ffi import (get_ffi, name_validated, pointer_args,
                   subscript_validated)
from ..findings import Edit, Finding, Fix, Severity
from ..modmodel import ModuleModel, walk_scope
from ..program import ProgramModel

RULE_ID = "G022"


def _asarray_fix(model: ModuleModel, fn: Optional[ast.AST], name: str,
                 before_line: int) -> Optional[Fix]:
    """When the last defining assignment is a one-line
    ``np.asarray(..., dtype present)``, upgrading it to
    ``np.ascontiguousarray`` is sufficient and safe."""
    if fn is None:
        return None
    best: Optional[ast.Assign] = None
    for node in walk_scope(fn):
        if isinstance(node, ast.Assign) and node.lineno < before_line:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    best = node
    if best is None or best.lineno != getattr(best, "end_lineno",
                                              best.lineno):
        return None
    value = best.value
    if not isinstance(value, ast.Call):
        return None
    from ..modmodel import dotted_name
    callee = dotted_name(value.func) or ""
    if callee not in ("np.asarray", "numpy.asarray"):
        return None
    has_dtype = len(value.args) >= 2 or any(
        kw.arg == "dtype" for kw in value.keywords)
    if not has_dtype:
        return None
    root = callee.rsplit(".", 1)[0]
    return Fix(edits=(Edit(best.lineno, f"{root}.asarray",
                           f"{root}.ascontiguousarray"),))


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    ffi = get_ffi(program)
    for path in sorted(scanned):
        mod = ffi.modules.get(path)
        if mod is None:
            continue
        model = program.modules[path]
        seen = set()
        for fc in mod.calls:
            for pa in pointer_args(program, path, mod, fc):
                if pa.kind == "name":
                    assert isinstance(pa.base, ast.Name)
                    if name_validated(program, path, model, fc.fn,
                                      pa.base.id, fc.node.lineno):
                        continue
                    label = f"`{pa.base.id}`"
                    fix = _asarray_fix(model, fc.fn, pa.base.id,
                                       fc.node.lineno)
                elif pa.kind == "namedsub":
                    if subscript_validated(model, fc.fn, pa.base,
                                           fc.node.lineno):
                        continue
                    src = ast.get_source_segment(model.source, pa.base)
                    label = f"`{src}`"
                    fix = None
                else:
                    continue  # views/temps are G023's subject
                key = (fc.node.lineno, label)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    path, fc.node.lineno, RULE_ID, Severity.ERROR,
                    f"raw pointer of {label} passed to native "
                    f"`{fc.symbol}` without a dominating dtype+"
                    f"C-contiguity validation — a wrong-dtype or strided "
                    f"array here is silent memory corruption on the C "
                    f"side; coerce with np.ascontiguousarray({label[1:-1]}"
                    f", dtype=...) or validate via plan_abi_arrays",
                    model.snippet(fc.node.lineno), fix=fix))
    return findings
