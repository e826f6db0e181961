"""G018 weak-scalar/float64-leak: f64 defaults entering the serving path.

The serving tables are f32 (bf16 in the quantized manifests); a request
payload or intermediate staged as float64 doubles host staging bandwidth
and — when it reaches a tensor on the card — the card's memory traffic,
for zero precision the score math ever uses. The provable channels,
scoped to the serving/IO modules (``serving/``, ``io/``, plus
``# graftcheck: serving-module`` opt-ins):

- an explicit float64 dtype: numpy's ``np.float64`` / ``np.double`` or
  torch's ``torch.float64`` / ``torch.double`` — machine-fixable for
  ``np.float64`` and ``torch.float64``: ``--fix`` rewrites the token to
  the float32 of the same library, matching the table dtype;
- ``astype(float)`` / ``dtype=float`` — Python's ``float`` IS float64 —
  and torch's ``.double()``;
- a float64-*by-default* numpy constructor: ``np.zeros/ones/empty``
  without a dtype (and ``np.full`` with a float fill) — the "weak Python
  scalar becomes a wide array" channel; single-line sites carry a fix
  appending ``dtype=np.float32``;
- torch's own channel: ``torch.as_tensor`` / ``from_numpy`` / ``tensor`` /
  ``asarray`` with no ``dtype=`` and no cast after it, of a value the
  dtype-flow model (analysis/dtypeflow.py) proves is a float64 numpy
  value (``np.asarray([0.5, 1.0])``, ``np.linspace(...)``, float64 numpy
  math) — torch keeps a numpy value's dtype, so float64 reaches the card.
  Single-line ``as_tensor`` / ``tensor`` / ``asarray`` sites carry a fix
  appending ``dtype=torch.float32``. A line whose numpy source is already
  a finding reports once.

``torch.*`` constructors default to f32 and are never flagged;
``np.asarray`` without a dtype follows its input and is trusted. The rule
reads the whole-program model for the last channel, so it runs as a
program rule (``check_program``) where the reference's is a module rule;
``check`` keeps the reference's module-level channels.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .. import config
from ..dtypeflow import get_model
from ..findings import Edit, Finding, Fix, Severity
from ..modmodel import ModuleModel, dotted_name
from ..program import ProgramModel

RULE_ID = "G018"

_F64_NAMES = ("np.float64", "numpy.float64", "np.double", "numpy.double",
              "np.float_", "numpy.float_", "torch.float64", "torch.double")
_TOKEN_FIXES = {"np.float64": "np.float32", "torch.float64": "torch.float32"}
_DEFAULT_F64_CTORS = ("zeros", "ones", "empty")
_PINNABLE = ("as_tensor", "tensor", "asarray")  # from_numpy takes no dtype


def _in_scope(model: ModuleModel) -> bool:
    return (model.rel_path.startswith(config.DTYPEFLOW_SERVING_PREFIXES)
            or config.CONCURRENCY_MARKER in model.source)


def _token_fix(model: ModuleModel, lineno: int, old: str, new: str
               ) -> Optional[Fix]:
    line = model.lines[lineno - 1] if 1 <= lineno <= len(model.lines) else ""
    if old in line:
        return Fix(edits=(Edit(lineno, old, new),))
    return None


def _pin_dtype_fix(model: ModuleModel, call: ast.Call,
                   pin: str = "dtype=np.float32") -> Optional[Fix]:
    """Append ``pin`` to a single-line constructor call."""
    if (call.end_lineno or call.lineno) != call.lineno:
        return None
    line = model.lines[call.lineno - 1] if call.lineno <= len(model.lines) \
        else ""
    seg = line[call.col_offset:call.end_col_offset]
    if not seg.endswith(")") or line.count(seg) != 1:
        return None
    return Fix(edits=(Edit(call.lineno, seg, seg[:-1] + f", {pin})"),))


def _has_dtype(call: ast.Call, positional: int) -> bool:
    if any(kw.arg == "dtype" for kw in call.keywords):
        return True
    if any(isinstance(a, ast.Starred) for a in call.args) \
            or any(kw.arg is None for kw in call.keywords):
        return True  # *args / **kwargs may carry the dtype: trusted
    return len(call.args) > positional


def _float_fill(node: ast.expr) -> bool:
    if isinstance(node, ast.UnaryOp):
        node = node.operand
    return isinstance(node, ast.Constant) and isinstance(node.value, float)


def check(model: ModuleModel) -> List[Finding]:
    """The reference's channels, read from one module's syntax (the
    whole rule is ``check_program``)."""
    if not _in_scope(model):
        return []
    findings: List[Finding] = []

    def emit(node: ast.AST, msg: str, fix: Optional[Fix]) -> None:
        findings.append(Finding(model.rel_path, node.lineno, RULE_ID,
                                Severity.ERROR, msg,
                                model.snippet(node.lineno), fix=fix))

    for node in ast.walk(model.tree):
        name = dotted_name(node) if isinstance(node, (ast.Attribute,
                                                      ast.Name)) else None
        if name in _F64_NAMES:
            parent = getattr(node, "graftcheck_parent", None)
            if isinstance(parent, ast.Attribute):
                continue  # attribute inside a longer dotted chain
            fix = _token_fix(model, node.lineno, name, _TOKEN_FIXES[name]) \
                if name in _TOKEN_FIXES else None
            emit(node, f"{name} on the serving path — request payloads and "
                       f"intermediates should match the f32 table dtype "
                       f"(f64 doubles host and device bandwidth for "
                       f"precision the score math never uses); use "
                       f"float32", fix)
            continue
        if not isinstance(node, ast.Call):
            continue
        callee = dotted_name(node.func) or ""
        root, _, tail = callee.rpartition(".")
        method = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if method == "astype" and node.args:
            a = node.args[0]
            if isinstance(a, ast.Name) and a.id == "float":
                emit(node, "astype(float) is float64 on the serving path — "
                           "pin np.float32 (the table dtype)", None)
        elif method == "double" and not node.args and not node.keywords:
            emit(node, ".double() is float64 on the serving path — use "
                       ".float() (the table dtype)", None)
        elif any(kw.arg == "dtype" and isinstance(kw.value, ast.Name)
                 and kw.value.id == "float" for kw in node.keywords):
            emit(node, "dtype=float is float64 on the serving path — pin "
                       "np.float32 (the table dtype)", None)
        elif root in ("np", "numpy") and tail in _DEFAULT_F64_CTORS:
            if not _has_dtype(node, 1):
                emit(node, f"np.{tail} without a dtype allocates float64 — "
                           f"the weak-scalar default leak; pin "
                           f"dtype=np.float32 to match the serving tables",
                     _pin_dtype_fix(model, node))
        elif root in ("np", "numpy") and tail == "full":
            if not _has_dtype(node, 2) and len(node.args) > 1 \
                    and _float_fill(node.args[1]):
                emit(node, "np.full with a Python-float fill allocates "
                           "float64 — pin dtype=np.float32 to match the "
                           "serving tables", _pin_dtype_fix(model, node))
    return findings


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    flow = get_model(program)
    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None or not _in_scope(model):
            continue
        found = check(model)
        seen = {f.line for f in found}
        for fn in model.functions:
            for src in flow.facts(path, fn).host_sources:
                dt = src.source_dt
                if dt is None or dt.weak or dt.lib != "np" \
                        or dt.name != "float64" or src.node.lineno in seen:
                    continue
                seen.add(src.node.lineno)
                callee = dotted_name(src.node.func) or "torch.as_tensor"
                tail = callee.rpartition(".")[2]
                found.append(Finding(
                    path, src.node.lineno, RULE_ID, Severity.ERROR,
                    f"{callee} of a float64 numpy value puts float64 on the "
                    f"card — torch keeps a numpy value's dtype; pin "
                    f"dtype=torch.float32 (the table dtype) or cast the "
                    f"numpy value first",
                    model.snippet(src.node.lineno),
                    fix=_pin_dtype_fix(model, src.node,
                                       "dtype=torch.float32")
                    if tail in _PINNABLE else None))
        findings.extend(found)
    return findings
