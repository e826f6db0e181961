"""FFI-boundary model: ctypes bindings, foreign calls, pointer provenance,
and the lightweight C declaration scanner.

The port crosses a ctypes ABI in two places: the native host library
(``native/hivemall_native.cpp``, bound by ``hivemall_tpu_torch/native``)
and the CUDA kernels' ``extern "C"`` block
(``hivemall_tpu_torch/kernels/csrc/linear_scan.cu``, bound by
``kernels/linear_scan.py`` on the ``-pallas`` path). A wrong-dtype
pointer, a dropped temporary or a drifted prototype there is silent
memory corruption — on the host or on the card — not a Python traceback.
This module gives the G022-G026 rules, stdlib-only:

- per-module **foreign-call discovery**: every ``ast.Call`` whose dotted
  callee tail carries a native-symbol prefix (``hm_*``), in modules that
  mention ctypes, with the enclosing function attached;
- the **declaration map**: ``lib.hm_x.argtypes = [...]`` /
  ``lib.hm_x.restype = ...`` assignments anywhere in the module, with the
  argtype list statically evaluated (``[c_void_p] * 3 + [...]`` included)
  into width-class kinds (``ptr``/``i8``..``i64``/``f32``/``f64``);
- **pointer-argument extraction**: ``x.ctypes.data_as(...)`` /
  ``x.ctypes.data`` / local ``as_p = lambda a: a.ctypes.data_as(...)``
  aliases, unwrapped through ``IfExp`` branches, classified by base kind
  (named binding, const-keyed subscript, slice/transpose view,
  expression temporary, inline-validated coercion);
- the **validation engine**: whether a pointer base is dominated by a
  dtype+contiguity proof — ``np.ascontiguousarray(..., dtype=...)``,
  fresh dtype-pinned constructors, ``.astype`` copies, a sanctioning
  validator (``plan_abi_arrays``), an explicit
  ``dtype``+``C_CONTIGUOUS`` guard statement, or (interprocedurally) a
  helper whose every return validates;
- the **C declaration scanner**: the exported ``hm_*`` signatures and the
  ``HM_PLAN_ABI_VERSION`` literal parsed out of both C sources — the
  host library's ``.cpp`` and the kernels' ``.cu`` (comment-stripped, newline-preserving, balanced-paren
  parameter split; the ``.cu`` block's ``void* stream``, ``long long``,
  ``int32_t*`` and ``const char*`` kinds included) so G025 can
  cross-check arity/pointer-ness/int-width per argument and the version
  literal — the frozen-ABI contract made machine-checkable.

The port's pointers into the card (``tensor.data_ptr()``) are plain ints
to this model: G022/G023 see only numpy ``.ctypes`` pointers, while G024,
G025 and G026 read every declared symbol of both sources.

Everything dynamic (pointers from opaque helpers, symbols absent from the
C source) is trusted, exactly like the SPMD rules trust dynamic axis
names.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from . import config
from .modmodel import ModuleModel, _FN_TYPES, dotted_name, walk_scope
from .program import ProgramModel, package_root

_MAX_VALIDATION_DEPTH = 3

# ctypes spelling -> ABI width class ("kind"): pointers collapse to "ptr",
# ints/floats to their width; anything else is "other" (never compared).
CTYPES_KIND = {
    "c_void_p": "ptr", "c_char_p": "ptr", "c_wchar_p": "ptr",
    "c_bool": "i8", "c_int8": "i8", "c_uint8": "i8",
    "c_byte": "i8", "c_ubyte": "i8", "c_char": "i8",
    "c_int16": "i16", "c_uint16": "i16", "c_short": "i16", "c_ushort": "i16",
    "c_int32": "i32", "c_uint32": "i32", "c_int": "i32", "c_uint": "i32",
    "c_int64": "i64", "c_uint64": "i64", "c_longlong": "i64",
    "c_ulonglong": "i64", "c_size_t": "i64", "c_ssize_t": "i64",
    "c_float": "f32", "c_double": "f64",
}

# C scalar type -> the same width classes (LP64: long == 64-bit). Keys
# are the type's words joined by one space, without const/signed/...
# qualifiers: ``long long`` (the kernels' feature-table extents) is its
# own key. CUDA's handle types: ``cudaStream_t`` is a pointer typedef,
# ``cudaError_t`` an enum.
C_KIND = {
    "void": "void",
    "bool": "i8", "char": "i8", "int8_t": "i8", "uint8_t": "i8",
    "int16_t": "i16", "uint16_t": "i16", "short": "i16",
    "int32_t": "i32", "uint32_t": "i32", "int": "i32", "unsigned": "i32",
    "int64_t": "i64", "uint64_t": "i64", "size_t": "i64", "ssize_t": "i64",
    "long": "i64", "long long": "i64", "long int": "i64",
    "long long int": "i64", "intptr_t": "i64", "uintptr_t": "i64",
    "float": "f32", "double": "f64",
    "cudaStream_t": "ptr", "cudaError_t": "i32",
}

# words that qualify a C type without naming it
_C_QUALIFIERS = ("const", "volatile", "signed", "unsigned", "struct", "enum",
                 "static", "inline", "extern", "__host__", "__device__")

_KIND_DESC = {"ptr": "a pointer", "void": "void", "i8": "an 8-bit int",
              "i16": "a 16-bit int", "i32": "a 32-bit int",
              "i64": "a 64-bit int", "f32": "a 32-bit float",
              "f64": "a 64-bit float"}


def describe_kind(kind: Optional[str]) -> str:
    return _KIND_DESC.get(kind or "", "an unknown type")


# --------------------------------------------------------------------------
# C declaration scanner
# --------------------------------------------------------------------------

class CParam:
    __slots__ = ("kind", "const", "text")

    def __init__(self, kind: str, const: bool, text: str):
        self.kind = kind
        self.const = const
        self.text = text


class CSig:
    """One exported definition, with the display path and the source line
    of the file it was read from (two C sources feed one CDecls)."""

    __slots__ = ("name", "line", "ret", "params", "path", "text")

    def __init__(self, name: str, line: int, ret: str,
                 params: List[CParam], path: str = "", text: str = ""):
        self.name = name
        self.line = line
        self.ret = ret
        self.params = params
        self.path = path
        self.text = text


class CDecls:
    """What G025 needs from the C side: exported signatures + the plan ABI
    version literal, with display-path and per-item line numbers for the
    cross-file SARIF locations. ``display_path``/``lines`` are those of the
    file holding the version literal; each CSig carries its own file."""

    __slots__ = ("display_path", "lines", "sigs", "abi_version",
                 "abi_version_line")

    def __init__(self, display_path: str, lines: List[str]):
        self.display_path = display_path
        self.lines = lines
        self.sigs: Dict[str, CSig] = {}
        self.abi_version: Optional[int] = None
        self.abi_version_line: int = 0

    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


def _c_source_path(env: str, default: str) -> Optional[str]:
    override = os.environ.get(env)
    if override:
        return override if os.path.isfile(override) else None
    cand = os.path.join(os.path.dirname(package_root()), *default.split("/"))
    return cand if os.path.isfile(cand) else None


def native_cpp_path() -> Optional[str]:
    """Filesystem path of the native host library's C++ source, or None
    when absent. ``GRAFTCHECK_NATIVE_CPP`` overrides the repo-root default
    (the seeded ABI-drift tests point it at a tempdir copy)."""
    return _c_source_path(config.FFI_NATIVE_CPP_ENV,
                          config.FFI_NATIVE_CPP_DEFAULT)


def kernel_cu_path() -> Optional[str]:
    """Filesystem path of the CUDA kernels' source (its ``extern "C"``
    block is the ABI ``kernels/linear_scan.py`` binds), or None when
    absent. ``GRAFTCHECK_KERNEL_CU`` overrides the default."""
    return _c_source_path(config.FFI_KERNEL_CU_ENV,
                          config.FFI_KERNEL_CU_DEFAULT)


def native_c_paths() -> List[str]:
    """Every C source G025 reads — the host library's, then the kernels'
    — skipping absent ones."""
    return [p for p in (native_cpp_path(), kernel_cu_path())
            if p is not None]


def _display_path(path: str) -> str:
    repo = os.path.dirname(package_root())
    ap = os.path.abspath(path)
    if ap.startswith(repo + os.sep):
        return os.path.relpath(ap, repo).replace(os.sep, "/")
    return path.replace(os.sep, "/")


def _strip_comments(text: str) -> str:
    """Blank out ``//`` and ``/* */`` comments and string literals,
    preserving every newline so line numbers survive."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            i += 2
            while i + 1 < n and not (text[i] == "*" and text[i + 1] == "/"):
                if text[i] == "\n":
                    out.append("\n")
                i += 1
            i += 2
        elif c in "\"'":
            quote = c
            i += 1
            while i < n and text[i] != quote:
                if text[i] == "\\":
                    i += 1
                i += 1
            i += 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _c_scalar_kind(toks: List[str]) -> str:
    """Width class of a pointer-free C type, its declarator name (if any)
    trailing: the longest run of leading type words that C_KIND knows
    (``long long D`` -> ``long long``; a bare ``unsigned`` is unsigned
    int), else "other"."""
    words = [t for t in toks if t not in _C_QUALIFIERS]
    if not words:
        return C_KIND["unsigned"] if "unsigned" in toks else "other"
    for n in range(len(words), 0, -1):
        kind = C_KIND.get(" ".join(words[:n]))
        if kind is not None:
            return kind
    return "other"


def _c_param(text: str) -> Optional[CParam]:
    toks = text.replace("*", " * ").split()
    if not toks or toks == ["void"]:
        return None
    if "*" in toks:
        return CParam("ptr", "const" in toks, text.strip())
    return CParam(_c_scalar_kind(toks), "const" in toks, text.strip())


def _split_params(src: str) -> List[str]:
    parts: List[str] = []
    depth, start = 0, 0
    for i, c in enumerate(src):
        if c in "(<[":
            depth += 1
        elif c in ")>]":
            depth -= 1
        elif c == "," and depth == 0:
            parts.append(src[start:i])
            start = i + 1
    parts.append(src[start:])
    return [p for p in parts if p.strip()]


_VERSION_RE = re.compile(r"HM_PLAN_ABI_VERSION\s*=\s*(\d+)")

_CPP_CACHE: Dict[str, Tuple[float, int, Optional[CDecls]]] = {}


def scan_native_decls(path: Optional[str] = None) -> Optional[CDecls]:
    """Parse the exported ``hm_*`` function definitions (and the plan ABI
    version literal) out of one C source, or with no `path` out of every
    source of ``native_c_paths()``, merged (a symbol defined in two keeps
    the first). Definitions only: a matched name must be followed by a
    balanced parameter list and an opening brace, so call sites inside
    other bodies never register. mtime-cached per path; None when no
    source is readable."""
    if path is not None:
        return _scan_c_source(path)
    scanned = [d for d in map(_scan_c_source, native_c_paths())
               if d is not None]
    if not scanned:
        return None
    if len(scanned) == 1:
        return scanned[0]
    home = next((d for d in scanned if d.abi_version is not None),
                scanned[0])
    merged = CDecls(home.display_path, home.lines)
    merged.abi_version = home.abi_version
    merged.abi_version_line = home.abi_version_line
    for d in scanned:
        for name, sig in d.sigs.items():
            merged.sigs.setdefault(name, sig)
    return merged


def _scan_c_source(path: str) -> Optional[CDecls]:
    ap = os.path.abspath(path)
    try:
        st = os.stat(ap)
    except OSError:
        return None
    cached = _CPP_CACHE.get(ap)
    if cached is not None and cached[0] == st.st_mtime \
            and cached[1] == st.st_size:
        return cached[2]
    try:
        with open(ap, "r", encoding="utf-8", errors="replace") as fh:
            text = fh.read()
    except OSError:
        _CPP_CACHE[ap] = (st.st_mtime, st.st_size, None)
        return None
    decls = CDecls(_display_path(path), text.splitlines())
    stripped = _strip_comments(text)
    vm = _VERSION_RE.search(stripped)
    if vm:
        decls.abi_version = int(vm.group(1))
        decls.abi_version_line = stripped[:vm.start()].count("\n") + 1
    prefixes = tuple(config.FFI_SYMBOL_PREFIXES)
    for m in re.finditer(r"\b([A-Za-z_][A-Za-z0-9_]*)\s*\(", stripped):
        name = m.group(1)
        if not name.startswith(prefixes):
            continue
        depth, i = 0, m.end() - 1
        while i < len(stripped):
            if stripped[i] == "(":
                depth += 1
            elif stripped[i] == ")":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        if i >= len(stripped):
            continue
        j = i + 1
        while j < len(stripped) and stripped[j] in " \t\r\n":
            j += 1
        if j >= len(stripped) or stripped[j] != "{":
            continue  # a call site or a bare prototype, not the definition
        head = re.split(r"[;{}()]", stripped[:m.start()])[-1]
        ret_toks = head.replace("*", " * ").split()
        if not ret_toks:
            continue
        ret = "ptr" if "*" in ret_toks else _c_scalar_kind(ret_toks)
        params = []
        for p in _split_params(stripped[m.end():i]):
            cp = _c_param(p)
            if cp is not None:
                params.append(cp)
        line = stripped[:m.start()].count("\n") + 1
        decls.sigs[name] = CSig(name, line, ret, params, decls.display_path,
                                decls.snippet(line))
    _CPP_CACHE[ap] = (st.st_mtime, st.st_size, decls)
    return decls


# --------------------------------------------------------------------------
# Python-side binding model
# --------------------------------------------------------------------------

class PyDecl:
    """argtypes/restype declarations observed for one symbol in one
    module."""

    __slots__ = ("symbol", "argtypes_node", "argtypes_line", "argtypes_src",
                 "argtypes_kinds", "restype_node", "restype_line",
                 "restype_src", "restype_kind")

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.argtypes_node: Optional[ast.Assign] = None
        self.argtypes_line = 0
        self.argtypes_src = ""
        self.argtypes_kinds: Optional[List[str]] = None
        self.restype_node: Optional[ast.Assign] = None
        self.restype_line = 0
        self.restype_src = ""
        self.restype_kind: Optional[str] = None


class ForeignCall:
    """One call crossing the FFI: ``lib.hm_x(...)`` with its enclosing
    function (None at module level)."""

    __slots__ = ("node", "symbol", "fn")

    def __init__(self, node: ast.Call, symbol: str, fn: Optional[ast.AST]):
        self.node = node
        self.symbol = symbol
        self.fn = fn


class PtrArg:
    """One pointer-valued argument of a foreign call: the base array
    expression under ``.ctypes.data_as`` / ``.ctypes.data`` / an ``as_p``
    alias, plus its classification (see base_kind)."""

    __slots__ = ("index", "arg", "base", "via", "kind")

    def __init__(self, index: int, arg: ast.expr, base: ast.expr, via: str,
                 kind: str):
        self.index = index
        self.arg = arg
        self.base = base
        self.via = via
        self.kind = kind


class ModuleFFI:
    __slots__ = ("decls", "calls", "asp_names")

    def __init__(self):
        self.decls: Dict[str, PyDecl] = {}
        self.calls: List[ForeignCall] = []
        # (enclosing fn or None, name) of `as_p = lambda a: a.ctypes...`
        self.asp_names: Set[Tuple[Optional[ast.AST], str]] = set()


class FFIModel:
    __slots__ = ("modules",)

    def __init__(self):
        self.modules: Dict[str, ModuleFFI] = {}

    def all_decls(self) -> Dict[str, PyDecl]:
        out: Dict[str, PyDecl] = {}
        for mod in self.modules.values():
            out.update(mod.decls)
        return out


def foreign_symbol(dotted: Optional[str]) -> Optional[str]:
    """The native symbol name of a dotted callee (``lib.hm_x`` ->
    ``hm_x``), or None when the tail carries no native prefix."""
    if not dotted:
        return None
    tail = dotted.rsplit(".", 1)[-1]
    if tail.startswith(tuple(config.FFI_SYMBOL_PREFIXES)):
        return tail
    return None


def _eval_argtypes(expr: ast.expr) -> Optional[List[str]]:
    """[c_void_p] * 3 + [c_int64, POINTER(c_float)] -> kinds; None when the
    expression is not statically a list."""
    if isinstance(expr, ast.List):
        return [_elt_kind(e) for e in expr.elts]
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left = _eval_argtypes(expr.left)
        right = _eval_argtypes(expr.right)
        if left is not None and right is not None:
            return left + right
        return None
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
        for lst, num in ((expr.left, expr.right), (expr.right, expr.left)):
            kinds = _eval_argtypes(lst)
            if kinds is not None and isinstance(num, ast.Constant) \
                    and isinstance(num.value, int):
                return kinds * num.value
        return None
    return None


def _elt_kind(expr: ast.expr) -> str:
    if isinstance(expr, ast.Call):
        callee = dotted_name(expr.func) or ""
        if callee.rsplit(".", 1)[-1] == "POINTER":
            return "ptr"
        return "other"
    d = dotted_name(expr) or ""
    return CTYPES_KIND.get(d.rsplit(".", 1)[-1], "other")


def _restype_kind(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Constant) and expr.value is None:
        return "void"
    d = dotted_name(expr) or ""
    return CTYPES_KIND.get(d.rsplit(".", 1)[-1])


def _is_asp_lambda(value: ast.expr) -> bool:
    """``lambda a: a.ctypes.data_as(...)`` (optionally behind an IfExp
    None-guard) — the repo's pointer-shorthand idiom."""
    if not isinstance(value, ast.Lambda) or not value.args.args:
        return False
    param = value.args.args[0].arg
    body = value.body
    if isinstance(body, ast.IfExp):
        body = body.body
    got = _match_pointer_expr(body, set(), None)
    return got is not None and isinstance(got[0], ast.Name) \
        and got[0].id == param


def get_ffi(program: ProgramModel) -> FFIModel:
    cached = getattr(program, "_graftcheck_ffi", None)
    if cached is not None:
        return cached
    ffi = FFIModel()
    for path, model in program.modules.items():
        # the ModuleFFI is a pure per-module product: cache it on the
        # ModuleModel (False = scanned, nothing foreign) so repeated
        # in-process scans skip the AST walk entirely
        mod = getattr(model, "_graftcheck_ffi_mod", None)
        if mod is not None:
            if mod is not False:
                ffi.modules[path] = mod
            continue
        mod = _build_module_ffi(model)
        model._graftcheck_ffi_mod = mod if mod is not None else False  # type: ignore[attr-defined]
        if mod is not None:
            ffi.modules[path] = mod
    program._graftcheck_ffi = ffi  # type: ignore[attr-defined]
    return ffi


def _build_module_ffi(model) -> Optional[ModuleFFI]:
    if "ctypes" not in model.source:
        return None
    mod = ModuleFFI()
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and _is_asp_lambda(node.value):
            mod.asp_names.add((model.enclosing_function(node),
                               node.targets[0].id))
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Attribute):
            tgt = node.targets[0]
            if tgt.attr not in ("argtypes", "restype"):
                continue
            sym = None
            if isinstance(tgt.value, ast.Attribute):
                if tgt.value.attr.startswith(
                        tuple(config.FFI_SYMBOL_PREFIXES)):
                    sym = tgt.value.attr
            if sym is None:
                continue
            decl = mod.decls.setdefault(sym, PyDecl(sym))
            src = ast.get_source_segment(model.source, tgt) or ""
            if tgt.attr == "argtypes":
                decl.argtypes_node = node
                decl.argtypes_line = node.lineno
                decl.argtypes_src = src
                decl.argtypes_kinds = _eval_argtypes(node.value)
            else:
                decl.restype_node = node
                decl.restype_line = node.lineno
                decl.restype_src = src
                decl.restype_kind = _restype_kind(node.value)
        elif isinstance(node, ast.Call):
            sym = foreign_symbol(dotted_name(node.func))
            if sym is not None:
                mod.calls.append(ForeignCall(
                    node, sym, model.enclosing_function(node)))
    return mod if (mod.decls or mod.calls) else None


# --------------------------------------------------------------------------
# pointer-argument extraction + base classification
# --------------------------------------------------------------------------

def _match_pointer_expr(expr: ast.expr,
                        asp_names: Set[Tuple[Optional[ast.AST], str]],
                        fn: Optional[ast.AST]
                        ) -> Optional[Tuple[ast.expr, str]]:
    """(base array expr, via) when `expr` produces a raw pointer/address
    from a numpy array; None otherwise."""
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr == "data_as" \
            and isinstance(expr.func.value, ast.Attribute) \
            and expr.func.value.attr == "ctypes":
        return expr.func.value.value, "data_as"
    if isinstance(expr, ast.Attribute) and expr.attr == "data" \
            and isinstance(expr.value, ast.Attribute) \
            and expr.value.attr == "ctypes":
        return expr.value.value, "data"
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
            and len(expr.args) == 1 and not expr.keywords:
        scope: Optional[ast.AST] = fn
        while True:
            if (scope, expr.func.id) in asp_names:
                return expr.args[0], "as_p"
            if scope is None:
                return None
            scope = getattr(scope, "graftcheck_parent", None)
            while scope is not None and not isinstance(scope, _FN_TYPES):
                scope = getattr(scope, "graftcheck_parent", None)
    return None


def _unwrap_ifexp(expr: ast.expr) -> List[ast.expr]:
    if isinstance(expr, ast.IfExp):
        return _unwrap_ifexp(expr.body) + _unwrap_ifexp(expr.orelse)
    return [expr]


def pointer_args(program: ProgramModel, path: str, mod: ModuleFFI,
                 fc: ForeignCall) -> List[PtrArg]:
    model = program.modules[path]
    out: List[PtrArg] = []
    exprs = [(i, a) for i, a in enumerate(fc.node.args)]
    exprs += [(-1, kw.value) for kw in fc.node.keywords]
    for i, arg in exprs:
        for branch in _unwrap_ifexp(arg):
            got = _match_pointer_expr(branch, mod.asp_names, fc.fn)
            if got is None:
                continue
            base, via = got
            kind = base_kind(program, path, model, fc.fn, base,
                             fc.node.lineno)
            out.append(PtrArg(i, arg, base, via, kind))
    return out


def _is_view_expr(expr: ast.expr) -> bool:
    if isinstance(expr, ast.Subscript):
        return any(isinstance(n, ast.Slice) for n in ast.walk(expr.slice))
    if isinstance(expr, ast.Attribute) and expr.attr == "T":
        return True
    if isinstance(expr, ast.Call):
        callee = dotted_name(expr.func) or ""
        return callee.rsplit(".", 1)[-1] in ("transpose", "swapaxes")
    return False


def base_kind(program: ProgramModel, path: str, model: ModuleModel,
              fn: Optional[ast.AST], base: ast.expr, before_line: int
              ) -> str:
    """Classify a pointer base expression:

    - ``name``: a plain named binding (lifetime held; G022 checks its
      validation);
    - ``namedsub``: a const-string-keyed subscript like ``state["w"]``
      (same treatment as a name, matched by source text);
    - ``view``: a slice / ``.T`` / ``transpose`` — non-owning,
      possibly non-contiguous (G023), including a name assigned one;
    - ``inline_ok``: a validated coercion built inline in the call
      argument (``np.ascontiguousarray(x, dtype=...)``) — safe;
    - ``temp``: any other expression temporary (G023).
    """
    if _is_view_expr(base):
        return "view"
    if isinstance(base, ast.Name):
        if fn is not None:
            rhs = _last_assignment(model, fn, base.id, before_line)
            if rhs is not None and _is_view_expr(rhs):
                return "view"
        return "name"
    if isinstance(base, ast.Subscript) and isinstance(base.value, ast.Name) \
            and isinstance(base.slice, ast.Constant) \
            and isinstance(base.slice.value, str):
        return "namedsub"
    if expr_validated(program, path, model, base, fn):
        return "inline_ok"
    return "temp"


def _last_assignment(model: ModuleModel, fn: ast.AST, name: str,
                     before_line: int) -> Optional[ast.expr]:
    found = None
    for node in walk_scope(fn):
        if isinstance(node, ast.Assign) and node.lineno < before_line:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    found = node.value
    return found


# --------------------------------------------------------------------------
# validation engine (G022)
# --------------------------------------------------------------------------

def _dotted_parts(expr: ast.expr) -> Tuple[str, str]:
    """(root, tail) of a callee. The tail falls back to the attribute name
    when the base is not a plain dotted chain (``np.concatenate(x)
    .astype(...)``: dotted_name can't render the call base, but the
    method tail is still ``astype``)."""
    d = dotted_name(expr) or ""
    root, tail = d.split(".", 1)[0], d.rsplit(".", 1)[-1]
    if not tail and isinstance(expr, ast.Attribute):
        tail = expr.attr
    return root, tail


def _has_kwarg(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


def _kwarg_is_false(call: ast.Call, name: str) -> bool:
    for kw in call.keywords:
        if kw.arg == name and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
    return False


def _contains_astype(expr: ast.expr) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr == "astype" and node.args:
            return True
    return False


def expr_validated(program: ProgramModel, path: str, model: ModuleModel,
                   expr: ast.expr, fn: Optional[ast.AST],
                   depth: int = 0) -> bool:
    """Does this expression produce a dtype-pinned, C-contiguous, freshly
    owned (or sanctioned) array?"""
    if depth > _MAX_VALIDATION_DEPTH:
        return False
    if isinstance(expr, ast.IfExp):
        return (expr_validated(program, path, model, expr.body, fn,
                               depth + 1)
                and expr_validated(program, path, model, expr.orelse, fn,
                                   depth + 1))
    if not isinstance(expr, ast.Call):
        return False
    root, tail = _dotted_parts(expr.func)
    if tail in config.FFI_SANCTIONING_VALIDATORS:
        return True
    if tail == "ascontiguousarray":
        if len(expr.args) >= 2 or _has_kwarg(expr, "dtype"):
            return True
        # ascontiguousarray(x.astype(dt, ...)): dtype pinned by the inner
        # astype, contiguity by the wrapper — validated even with
        # copy=False inside (astype always returns the requested dtype)
        return bool(expr.args) and _contains_astype(expr.args[0])
    if tail == "astype" and expr.args:
        # a fresh C-order copy with the requested dtype — unless
        # copy=False allowed the (possibly non-contiguous) original through
        return not _kwarg_is_false(expr, "copy")
    if root in ("np", "numpy"):
        if tail in config.FFI_FRESH_CTORS:
            return len(expr.args) >= 2 or _has_kwarg(expr, "dtype")
        if tail == "full":
            return len(expr.args) >= 3 or _has_kwarg(expr, "dtype")
        if tail == "array":
            return (len(expr.args) >= 2 or _has_kwarg(expr, "dtype")) \
                and not _kwarg_is_false(expr, "copy")
    if "." not in (dotted_name(expr.func) or "."):
        got = program.resolve_fn(path, tail, expr)
        if got is not None:
            return _returns_validated(program, got[0], got[1], None,
                                      depth + 1)
    return False


def _returns_validated(program: ProgramModel, path: str, fn: ast.AST,
                       pos: Optional[int], depth: int) -> bool:
    """Every return of `fn` (at tuple position `pos` when given) is a
    validated expression — the interprocedural hop that lets
    ``offsets`` from ``_pack_bytes()`` count as proven."""
    model = program.modules.get(path)
    if model is None or depth > _MAX_VALIDATION_DEPTH:
        return False
    returns = [n for n in walk_scope(fn) if isinstance(n, ast.Return)]
    if not returns:
        return False
    for ret in returns:
        value = ret.value
        if value is None:
            return False
        if pos is not None:
            if not isinstance(value, ast.Tuple) or pos >= len(value.elts):
                return False
            value = value.elts[pos]
        if isinstance(value, ast.Name):
            if not name_validated(program, path, model, fn, value.id,
                                  ret.lineno, depth + 1):
                return False
        elif not expr_validated(program, path, model, value, fn, depth):
            return False
    return True


def name_validated(program: ProgramModel, path: str, model: ModuleModel,
                   fn: Optional[ast.AST], name: str, before_line: int,
                   depth: int = 0) -> bool:
    """A named binding is validated when some statement before the use
    proves dtype+contiguity: a validating assignment (direct, through an
    IfExp, or unpacked from a sanctioning validator / an all-validating
    helper), or an explicit guard statement that mentions both ``dtype``
    and ``C_CONTIGUOUS`` and the name."""
    if fn is None or depth > _MAX_VALIDATION_DEPTH:
        return False
    for node in walk_scope(fn):
        if not isinstance(node, ast.stmt) or node.lineno >= before_line:
            continue
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    if expr_validated(program, path, model, node.value, fn,
                                      depth):
                        return True
                elif isinstance(tgt, ast.Tuple):
                    for i, elt in enumerate(tgt.elts):
                        if isinstance(elt, ast.Name) and elt.id == name:
                            if _unpack_validated(program, path, model, fn,
                                                 node.value, i, depth):
                                return True
        if _guard_statement_validates(model, node, name):
            return True
    return False


def _unpack_validated(program: ProgramModel, path: str, model: ModuleModel,
                      fn: ast.AST, value: ast.expr, pos: int,
                      depth: int) -> bool:
    if isinstance(value, ast.Tuple) and pos < len(value.elts):
        return expr_validated(program, path, model, value.elts[pos], fn,
                              depth)
    if not isinstance(value, ast.Call):
        return False
    root, tail = _dotted_parts(value.func)
    if tail in config.FFI_SANCTIONING_VALIDATORS:
        return True
    if "." not in (dotted_name(value.func) or "."):
        got = program.resolve_fn(path, tail, value)
        if got is not None:
            return _returns_validated(program, got[0], got[1], pos,
                                      depth + 1)
    return False


def _guard_statement_validates(model: ModuleModel, stmt: ast.stmt,
                               name: str) -> bool:
    """An explicit runtime guard — any statement whose source mentions both
    ``dtype`` and ``C_CONTIGUOUS`` and the name (the
    ``if t.dtype != dt or not t.flags["C_CONTIGUOUS"]: raise`` idiom,
    including table-driven loops over several arrays)."""
    end = getattr(stmt, "end_lineno", stmt.lineno)
    text = "\n".join(model.lines[stmt.lineno - 1:end])
    if "dtype" not in text or "C_CONTIGUOUS" not in text:
        return False
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(stmt))


def subscript_validated(model: ModuleModel, fn: Optional[ast.AST],
                        base: ast.expr, before_line: int) -> bool:
    """``state["w"]`` provenance: a prior subscript-target assignment with
    the same source text whose RHS is a validating expression — matched
    textually because subscript keys have no binding structure."""
    if fn is None:
        return False
    want = ast.get_source_segment(model.source, base)
    if not want:
        return False
    for node in walk_scope(fn):
        if isinstance(node, ast.Assign) and node.lineno < before_line:
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript):
                    src = ast.get_source_segment(model.source, tgt)
                    if src == want:
                        return True
    return False
