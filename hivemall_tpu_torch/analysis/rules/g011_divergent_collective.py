"""G011 collective-under-divergent-control-flow: a psum only some ranks
reach.

Collectives are rendezvous points: every rank of the group must call the
same collective in the same order. A collective reached under control
flow that can *diverge across ranks* deadlocks the others at the
rendezvous (NCCL and gloo wait until their timeout) — and only with more
than one rank, never in single-process tests.

Flagged: a rendezvous collective (``config.RENDEZVOUS_COLLECTIVES``: the
port's ``psum`` / ``pmean`` / ``all_gather_host`` / ``gather_fields`` and
``torch.distributed``'s own) inside an ``if``, ``while`` or conditional
expression whose test diverges, either lexically or through the call
graph (a ``barrier`` two helpers below the branch is still found). A test
diverges when it reads:

- this rank's place: ``mesh.index(...)``, ``mesh.coords[...]``,
  ``dist.get_rank()``, or a local (or a ``self`` attribute, assigned once
  in the class) bound to one;
- this rank's tensor data: ``.item()``, or ``.any()`` / ``.all()`` /
  ``torch.any`` / ``torch.all`` / ``torch.equal`` / ``torch.allclose`` of
  a value — the port's counterpart of the reference's ``lax.cond`` /
  ``switch`` on a per-shard predicate. A value reduced over the ranks
  first (``psum``'s result, or a tensor ``dist.all_reduce`` /
  ``dist.broadcast`` reduced in place) is the same on every rank and does
  not diverge, nor do world-wide facts (``dist.get_world_size()``,
  ``dist.is_initialized()``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .. import config
from ..findings import Finding, Severity
from ..modmodel import _FN_TYPES, dotted_name, walk_scope
from ..program import ProgramModel, collective_tail, mesh_lookup

RULE_ID = "G011"

_TENSOR_TESTS = ("item", "any", "all", "equal", "allclose")
_INPLACE_REDUCING = ("all_reduce", "broadcast")
_HOST_ROOTS = ("np", "numpy", "math", "os", "re", "builtins")


def _rank_source(node: ast.AST) -> bool:
    """This rank's place: ``mesh.index(...)``, ``mesh.coords[...]``,
    ``dist.get_rank()``."""
    if isinstance(node, ast.Call):
        callee = dotted_name(node.func) or ""
        tail = callee.rsplit(".", 1)[-1]
        if collective_tail(callee) == "index":
            return True
        return tail in config.RANK_CALLS \
            and callee[:-len(tail) - 1] in config.DIST_MODULES
    lookup = mesh_lookup(node)
    return lookup is not None and lookup[0] == "coords"


def _has_rank_source(expr: ast.AST) -> bool:
    return any(_rank_source(n) for n in ast.walk(expr))


def _bound_names(fn: ast.AST, pred) -> Set[str]:
    """Local names assigned from an expression `pred` accepts."""
    out: Set[str] = set()
    for node in walk_scope(fn):
        if isinstance(node, ast.Assign) and pred(node.value):
            for tgt in node.targets:
                out |= {n.id for n in ast.walk(tgt)
                        if isinstance(n, ast.Name)}
    return out


def _uniform_names(fn: ast.AST) -> Set[str]:
    """Names holding a value reduced over the ranks: assigned a reducing
    collective's result, or reduced in place by ``dist.all_reduce`` /
    ``dist.broadcast``."""
    def reduced(value: ast.AST) -> bool:
        return isinstance(value, ast.Call) and collective_tail(
            dotted_name(value.func) or "") in config.REDUCING_COLLECTIVES

    out = _bound_names(fn, reduced)
    for node in walk_scope(fn):
        if isinstance(node, ast.Call) and node.args \
                and collective_tail(dotted_name(node.func) or "") \
                in _INPLACE_REDUCING and isinstance(node.args[0], ast.Name):
            out.add(node.args[0].id)
    return out


def _tensor_reads(test: ast.expr) -> List[Set[str]]:
    """The names of each tensor value the test reads."""
    out = []
    for node in ast.walk(test):
        if not isinstance(node, ast.Call):
            continue
        callee = dotted_name(node.func) or ""
        tail = callee.rsplit(".", 1)[-1]
        root = callee.split(".", 1)[0]
        if "." not in callee or tail not in _TENSOR_TESTS \
                or root in _HOST_ROOTS:
            continue
        read = node.args if root == "torch" else [node.func.value]
        names = {n.id for r in read for n in ast.walk(r)
                 if isinstance(n, ast.Name)}
        if names:
            out.append(names)
    return out


class _RankState:
    """Names bound to this rank's place, per function (a closure sees its
    enclosing functions'), and ``self`` attributes bound to it per
    class."""

    def __init__(self, model):
        self.model = model
        self._names: Dict[int, Set[str]] = {}
        self._attrs: Dict[int, Set[str]] = {}

    def names(self, fn: Optional[ast.AST]) -> Set[str]:
        if fn is None:
            return set()
        if id(fn) not in self._names:
            outer = self.names(self.model.enclosing_function(fn))
            self._names[id(fn)] = outer | _bound_names(fn, _has_rank_source)
        return self._names[id(fn)]

    def attrs(self, fn: ast.AST) -> Set[str]:
        cls = fn
        while cls is not None and not isinstance(cls, ast.ClassDef):
            cls = getattr(cls, "graftcheck_parent", None)
        if cls is None:
            return set()
        if id(cls) not in self._attrs:
            seen: Dict[str, List[bool]] = {}
            for m in cls.body:
                if not isinstance(m, _FN_TYPES):
                    continue
                for node in walk_scope(m):
                    if not isinstance(node, ast.Assign):
                        continue
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Attribute) \
                                and isinstance(tgt.value, ast.Name) \
                                and tgt.value.id == "self":
                            seen.setdefault(tgt.attr, []).append(
                                _has_rank_source(node.value))
            self._attrs[id(cls)] = {a for a, v in seen.items()
                                    if v == [True]}
        return self._attrs[id(cls)]


def _divergence(test: ast.expr, fn: ast.AST,
                state: Optional[_RankState]) -> Optional[str]:
    """Why the test may differ between ranks; None when it cannot.
    `state` is None in a module with no rank source at all."""
    if state is not None:
        names = state.names(fn)
        attrs = state.attrs(fn)
        for n in ast.walk(test):
            if _rank_source(n) or isinstance(n, ast.Name) \
                    and n.id in names or isinstance(n, ast.Attribute) \
                    and isinstance(n.value, ast.Name) \
                    and n.value.id == "self" and n.attr in attrs:
                return "a Python branch on this rank's place"
    reads = _tensor_reads(test)
    if reads:
        uniform = _uniform_names(fn)
        if any(not names <= uniform for names in reads):
            return "a Python branch on this rank's own tensor data"
    return None


def _branches(node: ast.AST):
    """The statements or expressions only some ranks may run."""
    if isinstance(node, (ast.If, ast.While)):
        return node.body + node.orelse
    return [node.body, node.orelse]  # IfExp


def _calls_under(body) -> List[ast.Call]:
    """Calls in the branch, not descending into nested defs or lambdas:
    those diverge only if called there, which their call sites cover."""
    out = []
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, _FN_TYPES + (ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Call):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    seen = set()

    def flag(path: str, call: ast.Call, tail: str, why: str) -> None:
        if path not in scanned:
            return
        key = (path, call.lineno, why)
        if key in seen:
            return
        seen.add(key)
        model = program.modules[path]
        findings.append(Finding(
            path, call.lineno, RULE_ID, Severity.ERROR,
            f"collective `{tail}` under rank-divergent control flow "
            f"({why}) — collectives are rendezvous points; the ranks that "
            f"skip the branch leave the others waiting at run time",
            model.snippet(call.lineno)))

    for path, model in program.modules.items():
        src = model.source
        if not any(k in src for k in ("index(", "get_rank", "coords[",
                                      ".item()", ".any(", ".all(",
                                      "torch.equal", "allclose")):
            continue  # cheap pre-filter before the full AST walk
        state = _RankState(model) if any(
            _rank_source(n) for n in ast.walk(model.tree)) else None
        for fn in model.functions:
            for node in walk_scope(fn):
                if not isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    continue
                why = _divergence(node.test, fn, state)
                if why is None:
                    continue
                why = f"{why} at {path}:{node.lineno}"
                for call in _calls_under(_branches(node)):
                    callee = dotted_name(call.func) or ""
                    tail = collective_tail(callee)
                    if tail in config.RENDEZVOUS_COLLECTIVES:
                        flag(path, call, tail, why)
                        continue
                    target = program.call_target(path, fn, call, callee, {})
                    if target is None:
                        continue
                    t_path, t_fn, _ = target
                    env = program.call_env(path, call, t_path, t_fn, {}, fn)
                    for f_path, _, summ, _ in program.walk_calls(
                            t_path, t_fn, env):
                        for c, c_tail, _, _, _ in summ.collectives:
                            if c_tail in config.RENDEZVOUS_COLLECTIVES:
                                flag(f_path, c, c_tail, why)
    return findings
