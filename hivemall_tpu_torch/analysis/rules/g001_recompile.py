"""G001 recompile-hazard: code shapes that break or rebuild a capture.

Three patterns (traceflow.py's docstring maps them from the reference):

(a) Python ``if``/``while`` whose test reads a device value inside a
    capture (a captured def, or a ``with torch.cuda.graph(g):`` block):
    ``bool()`` of a device tensor syncs — a CUDA-graph capture refuses
    it, and torch.compile breaks its graph there. ``is (not) None`` /
    ``isinstance`` / containment tests are pruned: structure is static
    at capture time, and so is a parameter annotated ``str`` / ``bool`` /
    ``int`` / ``float`` (torch.compile guards on its value).
(b) a capture built inside a ``for``/``while`` body
    (``config.CAPTURE_CONSTRUCTORS``: ``CUDAGraph()``,
    ``torch.cuda.graph(``, ``make_graphed_callables(``,
    ``torch.compile(``) — each takes a fresh private memory pool, so
    every iteration adds allocator segments and captures anew.
(c) f-strings over ``.shape`` or device values inside a capture —
    shape-keyed strings fork one capture per shape.

The reference's (d), a non-literal ``static_argnums``, has no torch form:
a capture has no per-value static arguments.
"""

from __future__ import annotations

import ast
from typing import List

from ..findings import Finding, Severity
from ..modmodel import (ModuleModel, dotted_name, enclosing_loop,
                        is_capture_constructor, walk_region, walk_scope)

RULE_ID = "G001"


def _prune_static_tests(test: ast.expr) -> List[ast.expr]:
    """Drop subtrees whose truth is static at capture time, return the
    rest."""
    if isinstance(test, ast.BoolOp):
        out: List[ast.expr] = []
        for v in test.values:
            out.extend(_prune_static_tests(v))
        return out
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _prune_static_tests(test.operand)
    if isinstance(test, ast.Compare):
        # x is None / x is not None — structure checks, static at capture
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return []
        # k in outs.dslots — dict/tuple membership is Python-level structure
        if all(isinstance(op, (ast.In, ast.NotIn)) for op in test.ops):
            return []
    if isinstance(test, ast.Call):
        callee = dotted_name(test.func)
        if callee in ("isinstance", "hasattr", "len", "callable"):
            return []
    return [test]


def _names_in(expr: ast.expr):
    for node in ast.walk(expr):
        if isinstance(node, ast.Name):
            yield node.id


def _has_shape_access(expr: ast.expr) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in ("shape", "dtype",
                                                             "ndim"):
            return True
    return False


def capture_scopes(model: ModuleModel):
    """(def or None, name, nodes, tainted, callables) of every capture in
    the module: each captured def with its parameters as device values
    (its static ones aside), and each ``with torch.cuda.graph(g):`` block
    with the enclosing function's provable device values."""
    for fn in model.functions:
        if model.is_traced(fn):
            tainted, callables = model.taint_function(fn, taint_params=True)
            yield fn, fn.name, walk_scope(fn), tainted, callables
    for region in model.capture_regions:
        fn = model.enclosing_function(region)
        tainted, callables = (model.taint_function(fn) if fn is not None
                              else (set(), set()))
        name = fn.name if fn is not None else "<module>"
        yield fn, name, walk_region(region), tainted, callables


def check(model: ModuleModel) -> List[Finding]:
    findings: List[Finding] = []

    def emit(node: ast.AST, msg: str, sev: str = Severity.ERROR) -> None:
        findings.append(Finding(model.rel_path, node.lineno, RULE_ID, sev,
                                msg, model.snippet(node.lineno)))

    # (a) + (c): per capture
    for _fn, name, nodes, tainted, _callables in capture_scopes(model):
        for node in nodes:
            if isinstance(node, (ast.If, ast.While)):
                for sub in _prune_static_tests(node.test):
                    hot = sorted(n for n in _names_in(sub) if n in tainted)
                    if hot:
                        kind = "while" if isinstance(node, ast.While) else "if"
                        emit(node, f"Python `{kind}` on device value(s) "
                                   f"{', '.join(hot)} inside captured "
                                   f"`{name}` — bool() of a device tensor "
                                   f"syncs: a CUDA-graph capture refuses it "
                                   f"and torch.compile breaks its graph; "
                                   f"use torch.where or hoist the decision "
                                   f"to a static argument")
                        break
            elif isinstance(node, ast.JoinedStr):
                for fv in node.values:
                    if not isinstance(fv, ast.FormattedValue):
                        continue
                    if _has_shape_access(fv.value) or any(
                            n in tainted for n in _names_in(fv.value)):
                        emit(node, f"f-string over a device/shape value "
                                   f"inside captured `{name}` — "
                                   f"shape-keyed strings fork one capture "
                                   f"per shape", Severity.WARNING)
                        break

    # (b): a capture built under a loop (within one function scope — a
    # capture inside a def that is merely *defined* in a loop is built once
    # per call, not per iteration, so the ancestor walk stops at function
    # boundaries)
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Call) and is_capture_constructor(node) \
                and enclosing_loop(node) is not None:
            emit(node, f"{dotted_name(node.func)}(...) built inside a loop "
                       f"— each capture takes a fresh private memory pool, "
                       f"so every iteration adds allocator segments and "
                       f"captures anew; build it once outside the loop")

    return findings
