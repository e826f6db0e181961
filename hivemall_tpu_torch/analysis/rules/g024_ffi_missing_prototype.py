"""G024 FFI missing prototype: a CDLL symbol is invoked without both argtypes and restype declared.

Without ``argtypes`` ctypes guesses the C signature from the Python
values at every call — an ``int`` that should be ``int64_t`` truncates
on 32-bit promotion, a float silently becomes a double — and without
``restype`` every return is assumed ``int`` (32-bit), so a 64-bit
status or count comes back sign-mangled. Both must be declared once at
load time so every later call is type-checked; the declarations are
also what G025 cross-checks against the C source and what G026 uses to
know a status code exists.

Fix: when ``argtypes`` is declared but ``restype`` is missing, a
``restype`` assignment is splicable onto the argtypes line: the width
class of the C definition's return where a C source defines the symbol
(the kernels' launches return ``int``, ``ctypes.c_int``), else
``ctypes.c_int64`` (the host library returns int64 status everywhere).
The reverse is not auto-fixable — argtypes require the real parameter
list.

Second half (extends G013's held-lock machinery): a native call made
while a serving-path lock is held stalls every thread behind it for the
full native runtime — native code never yields the GIL back to waiters
of *our* lock. Flagged in the G013 scope (``serving/``, ``pipeline/``,
``runtime/{metrics,timeseries,slo}*`` or the ``# graftcheck:
serving-module`` marker).
"""

from __future__ import annotations

from typing import List, Set, Tuple

from .. import config
from ..concurrency import get_model, in_g013_scope
from ..ffi import foreign_symbol, get_ffi, scan_native_decls
from ..findings import Edit, Finding, Fix, Severity
from ..program import ProgramModel

RULE_ID = "G024"

# the restype a fix declares for a C return of each width class
_RESTYPE_OF_KIND = {"void": "None", "i8": "ctypes.c_int8",
                    "i16": "ctypes.c_int16", "i32": "ctypes.c_int",
                    "i64": "ctypes.c_int64", "f32": "ctypes.c_float",
                    "f64": "ctypes.c_double", "ptr": "ctypes.c_void_p"}


def _fix_restype(symbol: str, cdecls) -> str:
    sig = cdecls.sigs.get(symbol) if cdecls is not None else None
    return _RESTYPE_OF_KIND.get(sig.ret if sig is not None else "",
                                "ctypes.c_int64")


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    ffi = get_ffi(program)
    all_decls = ffi.all_decls()
    cdecls = scan_native_decls()
    fixed_symbols: Set[str] = set()
    for path in sorted(scanned):
        mod = ffi.modules.get(path)
        if mod is None:
            continue
        model = program.modules[path]
        seen: Set[Tuple[int, str]] = set()
        for fc in sorted(mod.calls, key=lambda c: c.node.lineno):
            decl = mod.decls.get(fc.symbol) or all_decls.get(fc.symbol)
            has_arg = decl is not None and decl.argtypes_node is not None
            has_res = decl is not None and decl.restype_node is not None
            if has_arg and has_res:
                continue
            key = (fc.node.lineno, fc.symbol)
            if key in seen:
                continue
            seen.add(key)
            missing = [n for n, ok in (("argtypes", has_arg),
                                       ("restype", has_res)) if not ok]
            fix = None
            if has_arg and not has_res and decl is not None \
                    and decl.argtypes_src \
                    and fc.symbol not in fixed_symbols:
                # splice `X.restype = <C return>; ` ahead of the
                # existing argtypes assignment target — one edit per
                # symbol (a second identical edit would re-match the old
                # text still present after the first application)
                target = decl.argtypes_src
                base = target[:-len(".argtypes")]
                fix = Fix(edits=(Edit(
                    decl.argtypes_line, target,
                    f"{base}.restype = {_fix_restype(fc.symbol, cdecls)}; "
                    f"{target}"),))
                fixed_symbols.add(fc.symbol)
            findings.append(Finding(
                path, fc.node.lineno, RULE_ID, Severity.ERROR,
                f"native `{fc.symbol}` is called without "
                f"{' or '.join(missing)} declared — ctypes falls back to "
                f"guessing the C signature per call (ints promote to "
                f"32-bit, returns are assumed 32-bit int); declare both "
                f"once at load time",
                model.snippet(fc.node.lineno), fix=fix))
    findings.extend(_under_lock(program, scanned))
    return findings


def _under_lock(program: ProgramModel, scanned: Set[str]) -> List[Finding]:
    """Native calls made while a serving-path lock is held (rides the
    G013 concurrency model: eff_calls carry the held-lock set)."""
    findings: List[Finding] = []
    cm = get_model(program)
    prefixes = tuple(config.FFI_SYMBOL_PREFIXES)
    seen: Set[Tuple[str, int]] = set()

    def sweep(path: str, events) -> None:
        model = program.modules[path]
        for ev in events:
            if not ev.held:
                continue
            sym = foreign_symbol(ev.dotted)
            if sym is None or not sym.startswith(prefixes):
                continue
            key = (path, ev.line)
            if key in seen:
                continue
            seen.add(key)
            locks = sorted(lk.lstrip("@") for lk in ev.held)
            findings.append(Finding(
                path, ev.line, RULE_ID, Severity.ERROR,
                f"native `{sym}` called while holding "
                f"`{'`, `'.join(locks)}` — the full native runtime "
                f"executes under the lock and never yields it, stalling "
                f"every waiting thread; marshal under the lock, call "
                f"after releasing",
                model.snippet(ev.line)))

    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None or not in_g013_scope(path, model):
            continue
        for (c_path, _), cls in sorted(cm.classes.items()):
            if c_path == path:
                sweep(path, cls.eff_calls)
        sweep(path, (ev for f_path, _, ev in cm.fn_calls
                     if f_path == path))
    return findings
