"""G003 dtype-drift: float64 and unpinned literals in update math.

The storage policy (models/base.py) stores tables bf16 above 2^24 dims;
rule math deliberately runs f32 and casts once at the table write. Two
drift channels break that silently:

(a) float64 anywhere in the dtype-sensitive packages (ops/, core/,
    models/, kernels/): numpy's ``np.float64`` / ``np.double`` /
    ``np.float_`` and ``astype(float)``, torch's ``torch.float64`` /
    ``torch.double`` and ``.double()`` — f64 propagates through every
    downstream op and doubles the bytes each step moves; on an H100 it
    also runs at a fraction of the f32 rate (error);
(b) bare Python float literals as arithmetic operands inside traced
    functions and inside the update-math modules (ops/eta.py,
    ops/losses.py). Under torch a literal cannot widen a float tensor (a
    Python float is a wrapped number, below every tensor), so what it can
    do in the port is turn an integer tensor into the default float
    (``1.0 + t`` on an int64 step count is float32, on the card) and mix
    with a numpy float64 value as float64 (``0.5 * np.asarray(x)``); pin
    with ``torch.as_tensor(lit, dtype=x.dtype)`` so the expression follows
    the operand's dtype (warning).

Literals passed as *call arguments* (``torch.clamp(x, min=1.0)``) follow
weak promotion against an explicit tensor and are not flagged;
comparison thresholds (``p > -100.0``) are likewise safe. The port has no
traced functions (no ``jit`` wrapper in torch code), so (b) reads the
math modules and ``# graftcheck: dtype-module`` opt-ins only.
"""

from __future__ import annotations

import ast
from typing import List

from .. import config
from ..findings import Finding, Severity
from ..modmodel import ModuleModel, dotted_name, walk_scope

RULE_ID = "G003"

_F64_NAMES = ("np.float64", "numpy.float64", "np.double", "numpy.double",
              "np.float_", "numpy.float_", "torch.float64", "torch.double")


def _in_dtype_modules(model: ModuleModel) -> bool:
    return (model.rel_path.startswith(config.DTYPE_MODULE_PREFIXES)
            or "# graftcheck: dtype-module" in model.source)


def _is_math_module(model: ModuleModel) -> bool:
    return (model.rel_path in config.DTYPE_MATH_MODULES
            or "# graftcheck: dtype-module" in model.source)


def _float_literal_operands(binop: ast.BinOp):
    for side in (binop.left, binop.right):
        node = side
        if isinstance(node, ast.UnaryOp):
            node = node.operand
        if isinstance(node, ast.Constant) and isinstance(node.value, float):
            yield side


def check(model: ModuleModel) -> List[Finding]:
    if not _in_dtype_modules(model):
        return []
    findings: List[Finding] = []

    def emit(node: ast.AST, msg: str, sev: str) -> None:
        findings.append(Finding(model.rel_path, node.lineno, RULE_ID, sev,
                                msg, model.snippet(node.lineno)))

    # (a) float64 anywhere in dtype-sensitive modules
    for node in ast.walk(model.tree):
        name = dotted_name(node) if isinstance(node, (ast.Attribute,
                                                      ast.Name)) else None
        if name in _F64_NAMES:
            # only flag *loads* (np.float64(x), dtype=torch.float64), not
            # the attribute inside a larger dotted chain
            parent = getattr(node, "graftcheck_parent", None)
            if isinstance(parent, ast.Attribute):
                continue
            emit(node, f"{name} in update math — f64 doubles the bytes "
                       f"every step moves and silently upcasts the bf16 "
                       f"storage policy (models/base.py); use "
                       f"float32/bfloat16", Severity.ERROR)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            if node.func.attr == "astype" and node.args:
                a = node.args[0]
                if isinstance(a, ast.Name) and a.id == "float":
                    emit(node, "astype(float) is float64 — pin an explicit "
                               "32-bit (or table) dtype", Severity.ERROR)
            elif node.func.attr == "double" and not node.args \
                    and not node.keywords:
                emit(node, ".double() is float64 — pin an explicit 32-bit "
                           "(or table) dtype", Severity.ERROR)

    # (b) unpinned float literals in arithmetic
    for fn in model.functions:
        scan = model.is_traced(fn) or _is_math_module(model)
        if not scan:
            continue
        for node in walk_scope(fn):
            if not isinstance(node, ast.BinOp):
                continue
            if not isinstance(node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div,
                                        ast.Pow, ast.Mod, ast.FloorDiv)):
                continue
            for lit in _float_literal_operands(node):
                emit(lit, f"bare float literal {ast.unparse(lit)} in update "
                          f"arithmetic — it turns an integer tensor into "
                          f"the default float and mixes with a numpy "
                          f"float64 value as float64; pin with "
                          f"torch.as_tensor(lit, dtype=x.dtype) so the "
                          f"expression follows the operand's dtype",
                     Severity.WARNING)
    return findings
