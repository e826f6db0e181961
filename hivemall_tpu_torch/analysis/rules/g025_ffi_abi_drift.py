"""G025 FFI ABI drift: Python ctypes declarations disagree with the exported C signatures or the plan ABI version.

The ctypes bindings and their C sources — ``native/hivemall_native.cpp``
for the host library, the ``extern "C"`` block of
``hivemall_tpu_torch/kernels/csrc/linear_scan.cu`` for the CUDA kernels —
are two hand-maintained copies of one contract. When they drift — an argument
added on one side only, an ``int32_t`` widened to ``int64_t``, a bumped
``HM_PLAN_ABI_VERSION`` without the matching Python
``PLAN_ABI_VERSION`` — every call still "works": ctypes happily
marshals the declared types and the C side reinterprets the bytes.
This rule parses the exported ``hm_*`` definitions (and the version
literal) out of both C sources with a lightweight declaration scanner
and cross-checks, per symbol declared on both sides: arity,
pointer-vs-scalar per argument, int/float width per argument, and the
return width — plus the version literals. Width classes only (``ptr``,
``i8``..``i64``, ``f32``/``f64``): signedness mismatches are benign at
the ABI level and ``c_void_p`` vs a typed pointer is the bindings'
established idiom.

Findings anchor on the Python declaration line (the side you edit to
fix them) and carry the C declaration as a second SARIF location, so CI
annotates both files. A drift on the kernels' binding corrupts device
memory on the ``-pallas`` path, which no CPU test reaches. Symbols present on only one side are skipped —
absence is a link-time/AttributeError problem the loader already
surfaces loudly, not silent drift.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from .. import config
from ..ffi import CSig, PyDecl, describe_kind, get_ffi, scan_native_decls
from ..findings import Finding, Severity
from ..program import ProgramModel

RULE_ID = "G025"


def _py_abi_version(model) -> Optional[Tuple[int, int]]:
    """(value, line) of a module-level ``PLAN_ABI_VERSION = <int>``."""
    for node in model.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == config.FFI_ABI_VERSION_CONSTANT \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int) \
                and not isinstance(node.value.value, bool):
            return node.value.value, node.lineno
    return None


def _pairs(program: ProgramModel, scanned: Set[str], cdecls
           ) -> Iterator[Tuple[str, str, PyDecl, CSig]]:
    """(module, symbol, Python declaration, C definition) for every symbol
    a scanned module declares and a C source defines — what G025
    compares."""
    ffi = get_ffi(program)
    for path in sorted(scanned):
        mod = ffi.modules.get(path)
        if mod is None:
            continue
        for sym in sorted(mod.decls):
            sig = cdecls.sigs.get(sym)
            if sig is not None:  # Python-only symbol: loader surfaces that
                yield path, sym, mod.decls[sym], sig


def compared_symbols(program: ProgramModel, scanned: Set[str]) -> Set[str]:
    """The symbols whose declarations G025 compares in this scan."""
    cdecls = scan_native_decls()
    if cdecls is None:
        return set()
    return {sym for _, sym, _, _ in _pairs(program, scanned, cdecls)}


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    cdecls = scan_native_decls()
    if cdecls is None:
        return []  # no C source reachable: nothing to cross-check
    findings: List[Finding] = []
    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None:
            continue
        got = _py_abi_version(model)
        if got is not None and cdecls.abi_version is not None \
                and got[0] != cdecls.abi_version:
            value, line = got
            findings.append(Finding(
                path, line, RULE_ID, Severity.ERROR,
                f"{config.FFI_ABI_VERSION_CONSTANT} = {value} but the C "
                f"side compiles HM_PLAN_ABI_VERSION = "
                f"{cdecls.abi_version} ({cdecls.display_path}:"
                f"{cdecls.abi_version_line}) — the frozen plan ABI "
                f"changed on one side only; bump both literals in the "
                f"same commit",
                model.snippet(line),
                related=((cdecls.display_path, cdecls.abi_version_line,
                          cdecls.snippet(cdecls.abi_version_line)),)))
    for path, sym, decl, sig in _pairs(program, scanned, cdecls):
        model = program.modules[path]
        rel = ((sig.path, sig.line, sig.text),)
        if decl.argtypes_kinds is not None:
            kinds = decl.argtypes_kinds
            if len(kinds) != len(sig.params):
                findings.append(Finding(
                    path, decl.argtypes_line, RULE_ID, Severity.ERROR,
                    f"`{sym}` declares {len(kinds)} argtypes but the "
                    f"C definition takes {len(sig.params)} parameters "
                    f"({sig.path}:{sig.line}) — every call "
                    f"marshals a mis-sized frame",
                    model.snippet(decl.argtypes_line), related=rel))
            else:
                for i, (pk, cp) in enumerate(zip(kinds, sig.params)):
                    if pk == "other" or cp.kind == "other":
                        continue
                    if pk != cp.kind:
                        findings.append(Finding(
                            path, decl.argtypes_line, RULE_ID,
                            Severity.ERROR,
                            f"`{sym}` argument {i} is declared as "
                            f"{describe_kind(pk)} in Python but the C "
                            f"definition takes {describe_kind(cp.kind)}"
                            f" (`{cp.text}`, {sig.path}:"
                            f"{sig.line}) — the marshalled bytes are "
                            f"reinterpreted at the wrong width",
                            model.snippet(decl.argtypes_line),
                            related=rel))
        if decl.restype_kind is not None \
                and decl.restype_kind != "other" \
                and sig.ret != "other" \
                and decl.restype_kind != sig.ret:
            findings.append(Finding(
                path, decl.restype_line, RULE_ID, Severity.ERROR,
                f"`{sym}` restype is {describe_kind(decl.restype_kind)}"
                f" in Python but the C definition returns "
                f"{describe_kind(sig.ret)} ({sig.path}:"
                f"{sig.line}) — the returned value is truncated or "
                f"reinterpreted",
                model.snippet(decl.restype_line), related=rel))
    return findings
