"""G034 unbucketed-shape-dispatch: novel shapes reaching captures.

A capture replays one graph per input *shape*, and eager torch code pays
for a novel length too: the caching allocator adds segments after warmup
(``alloc_segment_guard(expect_stable=True)`` raises on them). The serving
stack keeps both bounded with the bucket ladder: every request batch is
padded to one of a fixed set of widths (``pad_to_bucket`` picks the width,
``bucket_rows``/``pad_rows_to_multiple`` pad the tensors) before dispatch,
and the warmup sweep runs exactly those shapes. A call site that feeds a
capture or a bucketed dispatch entry point
(``config.BUCKETED_DISPATCH_TAILS``: a servable's ``run_padded``) a
tensor sliced to a *data-dependent* length bypasses the ladder — one fresh
capture, or new segments, per novel length, after warmup said everything
was warm.

Scope: the capture-hot modules (serving dispatch + kernels/ops,
``traceflow.in_traceflow_scope``). Flagged only on proof: the callee is a
known capture alias (``name = torch.compile(...)``), a def captured in its
own module, or a bucketed entry point, and the argument is (or was last
assigned from) a subscript with a non-literal slice bound that is not
routed through a shape canonicalizer (``config.SHAPE_CANONICALIZERS`` — a
bound computed by ``pad_to_bucket`` IS the ladder). Machine fix for the
single-argument shape: ``scorer(batch)`` ->
``scorer(bucket_rows(batch))[:batch.shape[0]]``.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from .. import config
from ..findings import Edit, Finding, Fix, Severity
from ..modmodel import dotted_name, walk_scope
from ..program import ProgramModel
from ..traceflow import in_traceflow_scope

RULE_ID = "G034"


def _routed(expr: Optional[ast.AST]) -> bool:
    if expr is None:
        return False
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            callee = dotted_name(node.func) or ""
            if callee.rsplit(".", 1)[-1] in config.SHAPE_CANONICALIZERS:
                return True
    return False


def _dynamic_bound(program, model, path: str, expr: ast.expr,
                   scope) -> Optional[ast.expr]:
    """The offending non-literal slice bound when ``expr`` (or the value
    its name was last assigned from) is an unrouted dynamic-length slice."""
    node: ast.AST = expr
    if isinstance(node, ast.Name):
        assign = program._find_assignment(model, node.id, scope)
        if assign is None:
            return None
        node = assign
    if not isinstance(node, ast.Subscript) or _routed(node):
        return None
    sl = node.slice
    if not isinstance(sl, ast.Slice):
        return None
    for bound in (sl.lower, sl.upper):
        if bound is None or isinstance(bound, ast.Constant):
            continue
        if _routed(bound):
            continue
        if isinstance(bound, ast.Name):
            # a bound assigned from pad_to_bucket(...) IS bucket-routed
            b_assign = program._find_assignment(model, bound.id, scope)
            if b_assign is not None and _routed(b_assign):
                continue
        return bound
    return None


def _is_jitted_callee(program, model, path: str, call: ast.Call) -> bool:
    callee = dotted_name(call.func)
    if callee is None:
        return False
    if callee in model.jit_aliases \
            or callee.rsplit(".", 1)[-1] in config.BUCKETED_DISPATCH_TAILS:
        return True
    if "." in callee:
        return False
    got = program.resolve_fn(path, callee, call)
    if got is None:
        return False
    t_model = program.modules.get(got[0])
    return t_model is not None and got[1] in t_model.traced


def _bucket_fix(model, call: ast.Call) -> Optional[Fix]:
    """Single-line, single-positional-argument calls get the mechanical
    bucket routing; anything wider is reported for a hand fix."""
    if len(call.args) != 1 or call.keywords \
            or not isinstance(call.args[0], ast.Name):
        return None
    if call.lineno != getattr(call, "end_lineno", call.lineno):
        return None
    old = ast.get_source_segment(model.source, call)
    callee_src = ast.get_source_segment(model.source, call.func)
    arg = call.args[0].id
    if not old or not callee_src or old not in model.lines[call.lineno - 1]:
        return None
    new = f"{callee_src}(bucket_rows({arg}))[:{arg}.shape[0]]"
    return Fix(edits=(Edit(call.lineno, old, new),),
               add_import=("hivemall_tpu_torch.core.batch", "bucket_rows"))


def check_program(program: ProgramModel, scanned: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()

    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None or not in_traceflow_scope(path, model):
            continue
        for fn in model.functions:
            if model.is_traced(fn):
                continue  # shapes inside a capture are already fixed
            for call in walk_scope(fn):
                if not isinstance(call, ast.Call) \
                        or not _is_jitted_callee(program, model, path, call):
                    continue
                for arg in call.args:
                    if isinstance(arg, ast.Starred):
                        break
                    bound = _dynamic_bound(program, model, path, arg, fn)
                    if bound is None:
                        continue
                    if (path, call.lineno) in seen:
                        break
                    seen.add((path, call.lineno))
                    callee = dotted_name(call.func)
                    bound_src = ast.get_source_segment(model.source,
                                                       bound) or "?"
                    findings.append(Finding(
                        path, call.lineno, RULE_ID, Severity.ERROR,
                        f"captured / bucketed `{callee}` fed a slice with "
                        f"data-dependent bound `{bound_src}` — a fresh "
                        f"capture or new allocator segments per novel "
                        f"length, bypassing the warmup sweep; route the "
                        f"batch through the bucket ladder (bucket_rows / "
                        f"pad_to_bucket) first",
                        model.snippet(call.lineno),
                        fix=_bucket_fix(model, call)))
                    break
    return findings
