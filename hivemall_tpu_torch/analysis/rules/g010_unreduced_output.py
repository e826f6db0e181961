"""G010 unreduced-output-escapes: a rank's partial value returned as the
whole.

The reference flags a per-shard value at a ``shard_map`` output declared
replicated (``out_specs=P()``). The port has no such declaration: each
rank is a process, and a function's return is what that rank holds. The
hazard survives in torch's form: a rank slices its own stripe of a table
by ``mesh.index(axis)`` and reduces over it — a dot product, a sum, a
score — which is only its stripe's part of the value. Returned without a
``psum`` / ``pmean`` / ``all_gather_host`` / ``gather_fields`` (or a
``torch.distributed`` reduction) over that axis, every rank holds a
different partial value, and the result depends on the world size: right
on one rank, wrong on two.

The provable pattern is flagged; anything unresolvable is trusted:

- a value *derives from the stripe* when its expression uses
  ``mesh.index(...)`` or a name bound (through local assignments, or in
  an enclosing function for a closure) to one;
- a *partial* value is a sum-like reduction (``torch.sum`` / ``.sum()``,
  ``mean``, ``matmul``, ``@``, ``dot``, ``einsum`` ...) of a value that
  derives from the stripe, or a name bound to one;
- the function returns a partial value, and neither it nor any function
  it reaches through the call graph performs a reducing collective over
  that axis (or over an axis that does not resolve), with every call edge
  resolved: an opaque helper (a module attribute's call, an unresolved
  name, an unresolved ``self`` method) could reduce, so it suppresses the
  claim. Method calls on local values (``x.sum()``, ``st.replace(...)``)
  are taken to be collective-free, as in the reference.

The reference's other pattern — a sharded input passed straight through
to a replicated output — has no torch form: a rank's stripe returned as
itself is that rank's stripe by design (``parallel/sharded.py``
``shard_weights``), since nothing declares it replicated.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .. import config
from ..findings import Finding, Severity
from ..modmodel import dotted_name, walk_scope
from ..program import ProgramModel, collective_tail

RULE_ID = "G010"

_SUM_LIKE = ("sum", "nansum", "mean", "nanmean", "matmul", "mm", "bmm",
             "mv", "dot", "vdot", "inner", "einsum", "tensordot",
             "logsumexp", "norm", "prod", "count_nonzero")
_BENIGN_ROOTS = ("torch", "np", "numpy", "math", "functools", "F")
_BENIGN_BARE = {"len", "range", "tuple", "list", "dict", "zip", "enumerate",
                "sorted", "min", "max", "sum", "abs", "float", "int", "bool",
                "isinstance", "getattr", "print", "partial", "str", "set",
                "divmod", "round", "any", "all", "iter", "next", "map",
                "filter", "reversed", "hasattr", "type", "super"}


def _stripe_sources(node: ast.AST) -> List[ast.Call]:
    """The ``mesh.index(...)`` calls inside an expression."""
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)
            and collective_tail(dotted_name(n.func) or "") == "index"]


def _names(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _assignments(fn: ast.AST):
    """(targets, value) of the assignments in fn's own scope."""
    for node in walk_scope(fn):
        if isinstance(node, ast.Assign):
            yield node.targets, node.value
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                and node.value is not None:
            yield [node.target], node.value


def _propagate(fn: ast.AST, seeded: Set[str], is_seed) -> Set[str]:
    """Names bound (transitively, through local assignments) to a value
    `is_seed` accepts or that uses a name already in the set — two
    passes, so loop-carried values converge."""
    out = set(seeded)
    for _ in range(2):
        for targets, value in _assignments(fn):
            if is_seed(value) or _names(value) & out:
                for tgt in targets:
                    out |= {n.id for n in ast.walk(tgt)
                            if isinstance(n, ast.Name)}
    return out


def _is_partial(expr: ast.AST, stripe: Set[str]) -> bool:
    """A sum-like reduction of a value that derives from the stripe."""
    for node in ast.walk(expr):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            operands = (node.left, node.right)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SUM_LIKE:
            # torch.sum(x) or x.sum(): the receiver counts as an operand
            operands = list(node.args) + [node.func.value]
        else:
            continue
        if any(_stripe_sources(o) or _names(o) & stripe for o in operands):
            return True
    return False


class _Scopes:
    """Stripe-derived names per function, a closure seeing its enclosing
    functions' bindings; None for a function with no ``mesh.index`` call
    in it or around it."""

    def __init__(self, program: ProgramModel, path: str, model):
        self.program = program
        self.path = path
        self.model = model
        self._stripe: Dict[int, Optional[Set[str]]] = {}

    def stripe(self, fn: Optional[ast.AST]) -> Optional[Set[str]]:
        if fn is None:
            return None
        key = id(fn)
        if key not in self._stripe:
            inherited = self.stripe(self.model.enclosing_function(fn))
            own = any(tail == "index" for _, tail, _, _, _ in
                      self.program.summary(self.path, fn).collectives)
            if inherited is None and not own:
                self._stripe[key] = None
            else:
                params = {a.arg for a in fn.args.posonlyargs + fn.args.args
                          + fn.args.kwonlyargs}
                self._stripe[key] = _propagate(
                    fn, (inherited or set()) - params,
                    lambda v: bool(_stripe_sources(v)))
        return self._stripe[key]


def _slice_axes(program: ProgramModel, path: str, fn: ast.AST,
                scopes: _Scopes) -> Set[Optional[str]]:
    """The axes of the ``mesh.index`` calls the stripe comes from (None
    where one does not resolve), in fn and its enclosing functions."""
    out: Set[Optional[str]] = set()
    cur = fn
    while cur is not None:
        summ = program.summary(path, cur)
        for _, tail, kind, value, _ in summ.collectives:
            if tail == "index":
                out.add(program.resolve_axis(path, cur, kind, value, {}))
        cur = scopes.model.enclosing_function(cur)
    return out


def _reduction_scan(program: ProgramModel, path: str, fn: ast.AST,
                    axes: Set[Optional[str]]) -> Tuple[bool, bool]:
    """(reduces over one of `axes` or an unresolved axis, every call edge
    resolved) over fn's transitive call graph."""
    found = False
    resolved = True
    for f_path, f_fn, summ, f_env in program.walk_calls(path, fn, {}):
        for _, tail, kind, value, _ in summ.collectives:
            if tail not in config.REDUCING_COLLECTIVES:
                continue
            axis = program.resolve_axis(f_path, f_fn, kind, value, f_env)
            if axis is None or axis in axes or None in axes:
                found = True
        for call, callee in summ.calls:
            if collective_tail(callee) is not None:
                continue  # counted above
            if program.call_target(f_path, f_fn, call, callee,
                                   f_env) is not None:
                continue  # walked
            root = callee.split(".", 1)[0]
            if "." in callee:
                if root in _BENIGN_ROOTS:
                    continue
                if root != "self" and program.imports(f_path).get(
                        root) is None:
                    continue  # method call on a local value: benign
                resolved = False  # a module's attribute, or self's method
                continue
            if callee not in _BENIGN_BARE:
                resolved = False
    return found, resolved


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None or "index(" not in model.source:
            continue
        scopes = _Scopes(program, path, model)
        for fn in model.functions:
            stripe = scopes.stripe(fn)
            if stripe is None:
                continue
            partial = _propagate(fn, set(),
                                 lambda v: _is_partial(v, stripe))
            rets = [n for n in walk_scope(fn) if isinstance(n, ast.Return)
                    and n.value is not None
                    and (_is_partial(n.value, stripe)
                         or _names(n.value) & partial)]
            if not rets:
                continue
            axes = _slice_axes(program, path, fn, scopes)
            found, resolved = _reduction_scan(program, path, fn, axes)
            if found or not resolved:
                continue
            over = ", ".join(sorted(repr(a) for a in axes if a)) or "its axis"
            for ret in rets:
                findings.append(Finding(
                    path, ret.lineno, RULE_ID, Severity.ERROR,
                    f"`{getattr(fn, 'name', '<fn>')}` returns a reduction "
                    f"over this rank's stripe (mesh.index over {over}) with "
                    f"no psum / pmean / all_gather_host / gather_fields "
                    f"over that axis anywhere in its call graph — each "
                    f"rank returns a different partial value, and the "
                    f"result depends on the world size",
                    model.snippet(ret.lineno)))
    return findings

