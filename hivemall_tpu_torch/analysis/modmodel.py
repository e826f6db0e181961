"""Per-module AST model shared by every graftcheck rule.

Builds, once per file:

- parent links + enclosing-scope resolution (``enclosing_function``,
  ``resolve_def``), which the concurrency and FFI models walk;
- the *traced* set: the port's captures (traceflow.py's docstring) —
  defs handed to ``torch.compile`` / ``torch.jit.script`` /
  ``torch.jit.trace`` / ``torch.cuda.make_graphed_callables`` (as a call
  or a decorator) and defs called by name inside a ``with
  torch.cuda.graph(g):`` block — beside the JAX package's
  ``jit``/``vmap``/``scan``-shaped forms, which it keeps; plus every def
  nested in a traced def. The ``with`` blocks themselves are
  ``capture_regions``;
- per-def static parameter names: a literal ``static_argnums`` /
  ``static_argnames``, or an annotation in ``config.STATIC_ANNOTATIONS``
  (torch.compile guards on a ``str`` / ``bool`` / scalar argument, so it
  is a Python constant per capture);
- capture aliases (``jit_aliases``): ``name = torch.compile(fn, ...)``
  (including ``self._step = ...`` and ``return``-ed wrappers, recorded
  under the factory's name), each a ``JitWrap`` that says whether its
  outputs are static graph buffers (``graphed``);
- an intraprocedural *device-value taint* walker: ``torch.*`` results
  (``config.TORCH_HOST_CALLS`` and a ``device="cpu"`` literal aside),
  tensor methods on device values, ``.to(device)`` / ``.cuda()``, calls of
  captures and of step factories (``config.JITTED_FACTORY_RE``), and the
  JAX package's ``jnp.*`` / ``jax.*`` results; ``.cpu()`` / ``.numpy()``
  / ``.item()`` / ``.tolist()``, numpy results and tensor metadata
  (``.shape``, ``.size()``) are host values.

Free (closure) variables are deliberately NOT tainted: at capture time
they are Python constants, so branching on them is capture-safe.
G003, G013 and the dtype-flow rules read ``traced`` too.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from . import config


def dotted_name(node: ast.AST) -> Optional[str]:
    """'jax.lax.psum' for Attribute chains / Names; None otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_child_stmts(node: ast.AST):
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.stmt):
            yield child


_FN_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _call_kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _literal_ints(node: ast.expr) -> Optional[Tuple[int, ...]]:
    """(3,) / 0 / [0, 1] as a tuple of ints; None when not a literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, int):
                out.append(elt.value)
            else:
                return None
        return tuple(out)
    return None


def _literal_strs(node: ast.expr) -> Optional[Tuple[str, ...]]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.append(elt.value)
            else:
                return None
        return tuple(out)
    return None


_JAX_JIT = ("jax.jit", "jit")


def _is_jit_callee(node: ast.expr) -> bool:
    """A capture wrapper of the port or the JAX package's jit."""
    name = dotted_name(node)
    return name in _JAX_JIT or name in config.CAPTURE_WRAPPERS


def _is_partial_jit(call: ast.Call) -> bool:
    """partial(torch.compile, ...) / functools.partial(jax.jit, ...)."""
    name = dotted_name(call.func)
    if name not in ("partial", "functools.partial"):
        return False
    return bool(call.args) and _is_jit_callee(call.args[0])


def is_capture_constructor(call: ast.Call) -> bool:
    """A call that builds a capture (config.CAPTURE_CONSTRUCTORS) or a
    jax.jit wrapper."""
    name = dotted_name(call.func)
    return name in _JAX_JIT or name in config.CAPTURE_CONSTRUCTORS


def _is_capture_context(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(g):`` — its body is captured."""
    expr = item.context_expr
    return isinstance(expr, ast.Call) \
        and dotted_name(expr.func) in config.CAPTURE_CONTEXTS


class JitWrap:
    """One capture wrapper (or jax.jit) site: its static arguments and
    whether its outputs are static graph buffers that the next call
    overwrites (``graphed``: make_graphed_callables, and torch.compile in
    a CUDA-graph mode)."""

    __slots__ = ("call", "static_argnums", "static_argnames", "graphed")

    def __init__(self, call: ast.Call):
        self.call = call
        sn = _call_kwarg(call, "static_argnums")
        self.static_argnums = _literal_ints(sn) if sn is not None else None
        sa = _call_kwarg(call, "static_argnames")
        self.static_argnames = _literal_strs(sa) if sa is not None else None
        name = dotted_name(call.func) or ""
        mode = _call_kwarg(call, "mode")
        self.graphed = name.endswith("make_graphed_callables") or (
            name == "torch.compile" and isinstance(mode, ast.Constant)
            and mode.value in config.GRAPHED_COMPILE_MODES)


class ModuleModel:
    def __init__(self, rel_path: str, source: str, tree: ast.Module):
        self.rel_path = rel_path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree

        # parent links + scope map
        tree.graftcheck_parent = None  # type: ignore[attr-defined]
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                child.graftcheck_parent = node  # type: ignore[attr-defined]

        self.functions: List[ast.AST] = [
            n for n in ast.walk(tree) if isinstance(n, _FN_TYPES)]
        # (scope, name) -> def node; scope is the enclosing def or None
        self._defs_by_scope: Dict[Tuple[Optional[ast.AST], str], ast.AST] = {}
        for fn in self.functions:
            self._defs_by_scope[(self.enclosing_function(fn), fn.name)] = fn

        self.traced: Set[ast.AST] = set()
        self.static_params: Dict[ast.AST, Set[str]] = {}
        # alias ("step", "self._step") -> JitWrap
        self.jit_aliases: Dict[str, JitWrap] = {}
        # `with torch.cuda.graph(g):` blocks
        self.capture_regions: List[ast.With] = []

        self._collect_traced_roots()
        self._propagate_nested_traced()

    # -- scope helpers ------------------------------------------------------

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = getattr(node, "graftcheck_parent", None)
        while cur is not None and not isinstance(cur, _FN_TYPES):
            cur = getattr(cur, "graftcheck_parent", None)
        return cur

    def resolve_def(self, name: str, from_node: ast.AST) -> Optional[ast.AST]:
        scope = self.enclosing_function(from_node)
        while True:
            fn = self._defs_by_scope.get((scope, name))
            if fn is not None:
                return fn
            if scope is None:
                return None
            scope = self.enclosing_function(scope)

    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    # -- traced-function detection ------------------------------------------

    def _mark_traced(self, fn: ast.AST, wrap: Optional[JitWrap]) -> None:
        self.traced.add(fn)
        statics = self.static_params.setdefault(fn, set())
        args = fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if isinstance(a.annotation, ast.Name) \
                    and a.annotation.id in config.STATIC_ANNOTATIONS:
                statics.add(a.arg)
        if wrap is None:
            return
        pos = [a.arg for a in args.posonlyargs + args.args]
        if wrap.static_argnums:
            for i in wrap.static_argnums:
                if 0 <= i < len(pos):
                    statics.add(pos[i])
        if wrap.static_argnames:
            statics.update(wrap.static_argnames)

    def _collect_traced_roots(self) -> None:
        # decorators
        for fn in self.functions:
            for dec in fn.decorator_list:
                if _is_jit_callee(dec):
                    self._mark_traced(fn, None)
                elif isinstance(dec, ast.Call):
                    if _is_jit_callee(dec.func):
                        self._mark_traced(fn, JitWrap(dec))
                    elif _is_partial_jit(dec):
                        self._mark_traced(fn, JitWrap(dec))
        # call sites: torch.compile(name) / make_graphed_callables(name, ..)
        # / jax.jit(name) / jax.vmap(name) / jax.lax.scan(name, ..); and
        # `with torch.cuda.graph(g):` blocks
        for node in ast.walk(self.tree):
            if isinstance(node, ast.With) \
                    and any(_is_capture_context(i) for i in node.items):
                self._mark_region(node)
                continue
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if callee is None:
                continue
            tail = callee.rsplit(".", 1)[-1]
            capture = callee in config.CAPTURE_WRAPPERS
            if not capture and tail not in config.TRACING_TRANSFORMS:
                continue
            fn_arg: Optional[ast.expr] = node.args[0] if node.args else None
            wrap = JitWrap(node) if tail == "jit" or capture else None
            if isinstance(fn_arg, ast.Name):
                fn = self.resolve_def(fn_arg.id, node)
                if fn is not None:
                    self._mark_traced(fn, wrap)
            if wrap is not None:
                self._record_jit_alias(node, wrap)

    def _mark_region(self, region: ast.With) -> None:
        """A ``with torch.cuda.graph(g):`` body runs its host code once, at
        capture: record it, and trace the defs it calls by name."""
        self.capture_regions.append(region)
        for node in walk_region(region):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                fn = self.resolve_def(node.func.id, node)
                if fn is not None:
                    self._mark_traced(fn, None)

    def _record_jit_alias(self, call: ast.Call, wrap: JitWrap) -> None:
        parent = getattr(call, "graftcheck_parent", None)
        if isinstance(parent, ast.Assign) and parent.value is call:
            for tgt in parent.targets:
                name = dotted_name(tgt)
                if name:
                    self.jit_aliases[name] = wrap
        elif isinstance(parent, ast.Return):
            # `return jax.jit(fn, ...)` — the enclosing factory's results
            # are jitted callables; record under the factory's name
            fn = self.enclosing_function(parent)
            if fn is not None:
                self.jit_aliases[fn.name] = wrap

    def _propagate_nested_traced(self) -> None:
        changed = True
        while changed:
            changed = False
            for fn in self.functions:
                if fn in self.traced:
                    continue
                enc = self.enclosing_function(fn)
                if enc is not None and enc in self.traced:
                    self.traced.add(fn)
                    changed = True

    def is_traced(self, fn: ast.AST) -> bool:
        return fn in self.traced

    # -- taint --------------------------------------------------------------

    def taint_function(self, fn: ast.AST, taint_params: bool = False):
        """Best-effort intraprocedural device-value taint for one function.

        Returns (tainted_names, jitted_callables): names currently holding
        device values, and names whose *call* yields device values. Loop
        bodies are walked twice so loop-carried taint converges.
        """
        tainted: Set[str] = set()
        callables: Set[str] = set()
        if taint_params:
            statics = self.static_params.get(fn, set())
            args = fn.args
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                if a.arg != "self" and a.arg not in statics:
                    tainted.add(a.arg)
        for _ in range(2):
            self._taint_stmts(fn.body, tainted, callables, fn)
        return tainted, callables

    def _taint_stmts(self, stmts, tainted, callables, fn) -> None:
        for stmt in stmts:
            if isinstance(stmt, _FN_TYPES + (ast.ClassDef,)):
                continue  # nested scopes analyzed separately
            if isinstance(stmt, ast.Assign):
                self._taint_assign(stmt.targets, stmt.value, tainted,
                                   callables)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                self._taint_assign([stmt.target], stmt.value, tainted,
                                   callables)
            elif isinstance(stmt, ast.AugAssign):
                if (self.expr_tainted(stmt.value, tainted, callables)
                        or self.expr_tainted(stmt.target, tainted, callables)):
                    self._taint_target(stmt.target, tainted, True)
            elif isinstance(stmt, ast.For):
                if self.expr_tainted(stmt.iter, tainted, callables):
                    self._taint_target(stmt.target, tainted, True)
                for _ in range(2):
                    self._taint_stmts(stmt.body, tainted, callables, fn)
                self._taint_stmts(stmt.orelse, tainted, callables, fn)
            elif isinstance(stmt, ast.While):
                for _ in range(2):
                    self._taint_stmts(stmt.body, tainted, callables, fn)
                self._taint_stmts(stmt.orelse, tainted, callables, fn)
            elif isinstance(stmt, ast.If):
                self._taint_stmts(stmt.body, tainted, callables, fn)
                self._taint_stmts(stmt.orelse, tainted, callables, fn)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    if item.optional_vars is not None and self.expr_tainted(
                            item.context_expr, tainted, callables):
                        self._taint_target(item.optional_vars, tainted, True)
                self._taint_stmts(stmt.body, tainted, callables, fn)
            elif isinstance(stmt, ast.Try):
                self._taint_stmts(stmt.body, tainted, callables, fn)
                for h in stmt.handlers:
                    self._taint_stmts(h.body, tainted, callables, fn)
                self._taint_stmts(stmt.orelse, tainted, callables, fn)
                self._taint_stmts(stmt.finalbody, tainted, callables, fn)

    def _taint_assign(self, targets, value, tainted, callables) -> None:
        callee = dotted_name(value.func) if isinstance(value, ast.Call) \
            else None
        if callee is not None:
            tail = callee.rsplit(".", 1)[-1]
            # `step = make_train_step(...)` / `x = torch.compile(f)`:
            # target is a captured CALLABLE, not a device value
            if (config.JITTED_FACTORY_RE.match(tail)
                    or callee in _JAX_JIT
                    or callee in config.CAPTURE_WRAPPERS):
                for tgt in targets:
                    name = dotted_name(tgt)
                    if name:
                        callables.add(name)
                        tainted.discard(name)
                return
        is_tainted = self.expr_tainted(value, tainted, callables)
        for tgt in targets:
            self._taint_target(tgt, tainted, is_tainted)

    def _taint_target(self, tgt, tainted, is_tainted: bool) -> None:
        if isinstance(tgt, ast.Name):
            (tainted.add if is_tainted else tainted.discard)(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._taint_target(elt, tainted, is_tainted)
        elif isinstance(tgt, ast.Starred):
            self._taint_target(tgt.value, tainted, is_tainted)
        # Attribute / Subscript targets: not tracked

    def call_yields_device(self, call: ast.Call, tainted, callables) -> Optional[bool]:
        """True/False when the call's result is known device/host; None when
        unknown (propagate from arguments)."""
        if _cpu_literal(call):
            return False  # device="cpu" / .to("cpu")
        callee = dotted_name(call.func)
        if callee is None:
            # a method of a computed value: `x.cpu().numpy()`, `f(x).sum()`
            if isinstance(call.func, ast.Attribute):
                return self._method_yields_device(call, tainted, callables)
            return None
        tail = callee.rsplit(".", 1)[-1]
        if tail in config.UNTAINT_CALLS \
                or config.HOST_RESULT_NAME_RE.search(tail):
            return False
        if callee.startswith(("jnp.", "jax.numpy.")):
            return True
        if callee.startswith("jax.tree"):
            return None  # host pytrees stay host: propagate from args
        if callee.startswith("jax.") or callee in ("jit", "vmap"):
            return True
        if callee.startswith("torch."):
            if callee in config.TORCH_HOST_CALLS:
                return False
            if callee.startswith(config.TORCH_UNTRACKED_PREFIXES):
                return None
            return True
        if callee in callables or callee in self.jit_aliases:
            return True
        if tail in config.JITTED_ATTR_CALLEES and "." in callee:
            return True  # self._step(...) trainer convention
        if callee.startswith("np.") or callee.startswith("numpy."):
            return False
        # `float(x)` is a host read; `x.float()` a tensor method
        if callee in config.SYNC_CALLS or tail in config.SYNC_METHODS:
            return False
        if "." in callee:
            return self._method_yields_device(call, tainted, callables)
        # call to a def captured in this module
        fn = self.resolve_def(callee, call)
        if fn is not None and fn in self.traced:
            return True
        return None

    def _method_yields_device(self, call: ast.Call, tainted,
                              callables) -> Optional[bool]:
        """A tensor method: metadata reads are host values; ``.to(...)``
        with a device and ``.cuda()`` are device values; any other method
        of a device value is one; else unknown."""
        attr = call.func.attr
        if attr in config.SYNC_METHODS or attr in config.TENSOR_META_METHODS:
            return False
        if attr == "cuda":
            return True
        receiver = self.expr_tainted(call.func.value, tainted, callables)
        if attr == "to":
            moves = [a for a in call.args if not _is_dtype(a)] + [
                kw.value for kw in call.keywords if kw.arg == "device"]
            return True if moves else receiver
        return True if receiver else None

    def expr_tainted(self, expr: ast.expr, tainted, callables) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        if isinstance(expr, ast.Call):
            known = self.call_yields_device(expr, tainted, callables)
            if known is not None:
                return known
            return any(self.expr_tainted(a, tainted, callables)
                       for a in expr.args) or any(
                self.expr_tainted(kw.value, tainted, callables)
                for kw in expr.keywords)
        if isinstance(expr, ast.Attribute):
            if expr.attr in config.TENSOR_META_ATTRS:
                return False
            return self.expr_tainted(expr.value, tainted, callables)
        if isinstance(expr, ast.Subscript):
            return self.expr_tainted(expr.value, tainted, callables)
        if isinstance(expr, ast.BinOp):
            return (self.expr_tainted(expr.left, tainted, callables)
                    or self.expr_tainted(expr.right, tainted, callables))
        if isinstance(expr, ast.UnaryOp):
            return self.expr_tainted(expr.operand, tainted, callables)
        if isinstance(expr, ast.Compare):
            return self.expr_tainted(expr.left, tainted, callables) or any(
                self.expr_tainted(c, tainted, callables)
                for c in expr.comparators)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr_tainted(e, tainted, callables)
                       for e in expr.elts)
        if isinstance(expr, ast.Dict):
            return any(self.expr_tainted(v, tainted, callables)
                       for v in expr.values)
        if isinstance(expr, ast.IfExp):
            return (self.expr_tainted(expr.body, tainted, callables)
                    or self.expr_tainted(expr.orelse, tainted, callables))
        if isinstance(expr, ast.BoolOp):
            return any(self.expr_tainted(v, tainted, callables)
                       for v in expr.values)
        if isinstance(expr, ast.Starred):
            return self.expr_tainted(expr.value, tainted, callables)
        return False


def _cpu_literal(call: ast.Call) -> bool:
    """``device="cpu"`` / ``device=torch.device("cpu")`` / ``.to("cpu")``:
    the result is host data whatever the inputs."""
    values = [kw.value for kw in call.keywords if kw.arg == "device"]
    if isinstance(call.func, ast.Attribute) and call.func.attr == "to":
        values += call.args
    for v in values:
        if isinstance(v, ast.Call) and dotted_name(v.func) == "torch.device" \
                and v.args:
            v = v.args[0]
        if isinstance(v, ast.Constant) and isinstance(v.value, str) \
                and v.value.split(":")[0] == "cpu":
            return True
    return False


def _is_dtype(expr: ast.expr) -> bool:
    """``torch.float32`` / ``dtype=...``-shaped argument of ``.to()``."""
    name = dotted_name(expr)
    return name is not None and name.startswith("torch.") \
        and name != "torch.device"


def walk_region(region: ast.With):
    """Walk a capture block's body, not descending into nested function /
    class definitions (their bodies run when called, not at capture)."""
    stack = list(region.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _FN_TYPES + (ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def walk_scope(fn: ast.AST):
    """Walk a function body WITHOUT descending into nested function/class
    definitions (those are separate trace scopes, analyzed on their own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _FN_TYPES + (ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def enclosing_loop(node: ast.AST):
    """Nearest For/While ancestor within the same function scope (stops at a
    function boundary), else None."""
    cur = getattr(node, "graftcheck_parent", None)
    while cur is not None and not isinstance(cur, _FN_TYPES):
        if isinstance(cur, (ast.For, ast.While)):
            return cur
        cur = getattr(cur, "graftcheck_parent", None)
    return None


def build_model(rel_path: str, source: str) -> ModuleModel:
    tree = ast.parse(source, filename=rel_path)
    return ModuleModel(rel_path, source, tree)
