"""G033 host-branch-on-captured-value: capture errors across call edges.

G001(a) flags ``if``/``while`` on device values *inside* a capture. The
interprocedural gap: a plain helper that branches on (or ``float()``s) its
parameter is fine on its own, but called from a capture with a captured
tensor it syncs during capture — a CUDA-graph capture raises
("operation not permitted when stream is capturing"), torch.compile
breaks its graph there. Flagged:

a traced (captured) function passes a provably device-valued argument to
a resolvable uncaptured callee whose body branches on (``if``/``while``,
after G001's static-test pruning) or host-converts (``bool()`` /
``float()`` / ``int()`` / ``np.asarray()`` / ``.item()`` / ``.cpu()`` /
``.tolist()`` / ``.numpy()``) a value derived from that parameter.
Flagged at the callee's offending line, with the captured call site as a
related location. Tests over ``.shape``/``.dtype``/``.ndim`` are static at
capture time and never flagged.

The reference's (b), a device value at a ``static_argnums`` position, has
no torch form: a capture has no per-value static arguments.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from ..findings import Finding, Severity
from ..modmodel import dotted_name, walk_scope
from ..program import ProgramModel
from .g001_recompile import _has_shape_access, _names_in, _prune_static_tests
from .g002_host_sync import _sync_call_kind

RULE_ID = "G033"


def _seeded_taint(model, fn, seed):
    """The module taint walker, seeded with specific parameters instead of
    all of them — the callee-side view of one call edge."""
    tainted = set(seed)
    callables: Set[str] = set()
    for _ in range(2):
        model._taint_stmts(fn.body, tainted, callables, fn)
    return tainted, callables


def _shape_static_names(fn) -> Set[str]:
    """Names assigned from shape-bearing expressions (``e, k =
    table.shape``, ``n = x.shape[0]``, ``r = len(xs)``) — concrete at
    capture time even when the source tensor is a device value, so
    branching on them never syncs."""
    static: Set[str] = set()
    for node in walk_scope(fn):
        if isinstance(node, ast.Assign):
            value, targets = node.value, node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            value, targets = node.value, [node.target]
        else:
            continue
        if not (_has_shape_access(value) or _has_len_call(value)):
            continue
        for tgt in targets:
            for sub in ast.walk(tgt):
                if isinstance(sub, ast.Name):
                    static.add(sub.id)
    return static


def _has_len_call(expr) -> bool:
    return any(isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
               and sub.func.id == "len" for sub in ast.walk(expr))


def _callee_params(fn) -> List[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args]


def _tainted_params(model, call, fn, tainted, callables) -> List[str]:
    """Callee parameter names receiving provably device-valued caller
    arguments."""
    params = _callee_params(fn)
    offset = 1 if params[:1] == ["self"] else 0
    out: List[str] = []
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            break
        j = i + offset
        if j < len(params) and model.expr_tainted(arg, tainted, callables) \
                and not _has_shape_access(arg):
            out.append(params[j])
    for kw in call.keywords:
        if kw.arg in params \
                and model.expr_tainted(kw.value, tainted, callables) \
                and not _has_shape_access(kw.value):
            out.append(kw.arg)
    return out


def check_program(program: ProgramModel, scanned: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()

    def emit(path: str, line: int, msg: str, related=()) -> None:
        if (path, line) in seen:
            return
        seen.add((path, line))
        model = program.modules[path]
        findings.append(Finding(path, line, RULE_ID, Severity.ERROR, msg,
                                model.snippet(line), related=tuple(related)))

    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None:
            continue

        # captured caller -> uncaptured callee receiving device args
        for fn in model.functions:
            if not model.is_traced(fn):
                continue
            tainted, callables = model.taint_function(fn, taint_params=True)
            for call in walk_scope(fn):
                if not isinstance(call, ast.Call):
                    continue
                callee = dotted_name(call.func)
                if callee is None or "." in callee:
                    continue
                got = program.resolve_fn(path, callee, call)
                if got is None:
                    continue
                t_path, t_fn = got
                t_model = program.modules.get(t_path)
                if t_model is None or t_fn in t_model.traced:
                    continue  # captured callees are G001(a)'s subject
                seeds = _tainted_params(model, call, t_fn, tainted,
                                        callables)
                if not seeds:
                    continue
                related = ((path, call.lineno, model.snippet(call.lineno)),)
                _flag_callee(program, t_path, t_model, t_fn, seeds, callee,
                             fn.name, related, emit)

    return findings


def _flag_callee(program, t_path, t_model, t_fn, seeds, callee, caller_name,
                 related, emit) -> None:
    tainted, callables = _seeded_taint(t_model, t_fn, seeds)
    static = _shape_static_names(t_fn)
    for node in walk_scope(t_fn):
        if isinstance(node, (ast.If, ast.While)):
            for sub in _prune_static_tests(node.test):
                if _has_shape_access(sub):
                    continue  # shapes are static at capture
                hot = sorted(n for n in _names_in(sub)
                             if n in tainted and n not in static)
                if hot:
                    kind = "while" if isinstance(node, ast.While) else "if"
                    emit(t_path, node.lineno,
                         f"`{callee}` branches (`{kind}`) on "
                         f"{', '.join(f'`{h}`' for h in hot)}, a device "
                         f"value when captured `{caller_name}` calls it — "
                         f"bool() syncs during the capture (a CUDA graph "
                         f"raises, torch.compile breaks its graph); use "
                         f"torch.where or keep the branch out of the "
                         f"capture", related=related)
                    break
        elif isinstance(node, ast.Call):
            sync = _sync_call_kind(node)
            if sync is None:
                continue
            kind, arg = sync
            if _has_shape_access(arg):
                continue
            t_names = [n for n in _names_in(arg) if n in tainted]
            if t_names and all(n in static for n in t_names):
                continue  # shape-derived scalars concretize for free
            if t_model.expr_tainted(arg, tainted, callables):
                emit(t_path, node.lineno,
                     f"`{callee}` applies `{kind}` to a device value when "
                     f"captured `{caller_name}` calls it — a host copy "
                     f"during the capture (a CUDA graph raises, "
                     f"torch.compile breaks its graph); return the tensor "
                     f"and convert outside the capture", related=related)
