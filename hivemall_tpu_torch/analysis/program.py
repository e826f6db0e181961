"""Whole-program model: the interprocedural layer over ModuleModel.

The concurrency and FFI rules are program rules: a lock-ordering cycle
spans two classes in two modules, and a ctypes call in one module is
checked against the prototype declared in another. This module provides,
stdlib-only:

- a cross-module **import map** (``from ..native import _load`` resolves
  to the def node in its home module, through relative levels and ``as``
  aliases, including function-local imports);
- a **constant registry** (module-level string constants, resolved through
  import chains);
- per-function **summaries**: outgoing calls, the collective calls with
  their axis and mesh expressions (``config.COLLECTIVE_CALLS``: the port's
  ``psum(x, mesh, axis)`` family, ``mesh.index(axis)`` and
  ``torch.distributed``'s own), a mesh's per-axis lookups
  (``mesh.shape[axis]``, ``.coords``, ``.groups``), and parameter
  defaults;
- def resolution (``resolve_fn``, and ``self.method`` within its class)
  and call-edge environments, with a depth-bounded interprocedural
  **walk**;
- **mesh resolution**, the port's counterpart of the reference's
  ``shard_map`` sites: the mesh a collective receives, traced to its
  ``make_mesh`` / ``make_mesh_2d`` / ``Mesh(...)`` construction, gives the
  axis-name set it binds. The trace follows a local assignment, a
  ``self.<attr>`` assigned once in the class, and parameters across call
  edges (a mesh argument binds the callee's parameter, as a string does).
  A mesh travels in a variable named like one (``config.MESH_RECEIVER_RE``:
  ``mesh``, ``self.mesh``, ``row_mesh``), as in every module of the port;
  an argument named otherwise is not traced as a mesh.

Resolution is deliberately conservative: every rule built on this model
flags only what it can *prove*; anything dynamic is trusted. A name
assigned more than once, or assigned in a function that also takes it as
a parameter, resolves to nothing; an argument passed explicitly that does
not resolve unbinds the parameter's default.

The model is always built with the full ``hivemall_tpu_torch`` package
tree as context (parsed once per process and cached, see modelcache.py),
so single-file and changed-files scans see the same call graph as a full
scan.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Set, Tuple

from . import config
from .modmodel import ModuleModel, _FN_TYPES, dotted_name, walk_scope

MAX_CALL_DEPTH = 8

# env values: ("str", value) for resolved axis-name strings,
#             ("fn", module_path, fn_node, closure_env) for function values,
#             ("mesh", frozenset of axis names) for resolved meshes
StrVal = Tuple[str, str]


# --------------------------------------------------------------------------
# package-tree context cache
# --------------------------------------------------------------------------


def package_root() -> str:
    """Filesystem path of the hivemall_tpu_torch package this analyzer
    lives in."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_package_models() -> Dict[str, ModuleModel]:
    """Every module of the package, through the shared model cache
    (modelcache.py: in-process mtime layer + on-disk sha256 layer).
    Returns {normalized rel_path: ModuleModel}; unparsable files are
    skipped here — the runner reports them when they are in the scanned
    set."""
    from . import modelcache
    root = package_root()
    out: Dict[str, ModuleModel] = {}
    prefix = os.path.basename(root)  # "hivemall_tpu_torch"
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            ap = os.path.join(dirpath, name)
            rel = prefix + "/" + os.path.relpath(ap, root).replace(
                os.sep, "/")
            model = modelcache.cached_model(ap, rel)
            if model is not None:
                out[rel] = model
    modelcache.save()
    return out


def _in_package(dotted: str) -> bool:
    """A dotted module name inside the analyzed package."""
    pkg = os.path.basename(package_root())
    return dotted == pkg or dotted.startswith(pkg + ".")



# --------------------------------------------------------------------------
# collective calls
# --------------------------------------------------------------------------

def collective_tail(callee: str) -> Optional[str]:
    """The ``config.COLLECTIVE_CALLS`` key of a dotted callee, or None: a
    ``torch.distributed`` collective only on the module (``dist.barrier``),
    ``index`` only on a receiver named like a mesh (``mesh.index``)."""
    tail = callee.rsplit(".", 1)[-1]
    sig = config.COLLECTIVE_CALLS.get(tail)
    if sig is None:
        return None
    receiver = callee[:-len(tail) - 1] if "." in callee else ""
    if tail in config.DIST_COLLECTIVES:
        return tail if receiver in config.DIST_MODULES else None
    if sig[1] == config.MESH_RECEIVER:
        return tail if config.MESH_RECEIVER_RE.search(receiver) else None
    return tail


def _positional(call: ast.Call, pos: Optional[int]) -> Optional[ast.expr]:
    if pos is None or pos >= len(call.args) or any(
            isinstance(a, ast.Starred) for a in call.args[:pos + 1]):
        return None
    return call.args[pos]


def collective_axis_expr(call: ast.Call, tail: str) -> Optional[ast.expr]:
    """The axis-name expression of a collective call, from the position
    ``config.COLLECTIVE_CALLS`` gives it (``psum(x, mesh, axis)`` third,
    ``gather_fields(s, names, mesh, axis)`` fourth, ``mesh.index(axis)``
    first); an ``axis_name=`` / ``axis=`` keyword wins. None for the
    ``torch.distributed`` calls, which name a group, not an axis."""
    pos = config.COLLECTIVE_CALLS[tail][0]
    if pos is None:
        return None
    cand = _positional(call, pos)
    for kw in call.keywords:
        if kw.arg in ("axis_name", "axis"):
            cand = kw.value
    return cand


def collective_mesh_expr(call: ast.Call, tail: str) -> Optional[ast.expr]:
    """The mesh expression a collective call receives: its second
    positional (``gather_fields``' third), or the receiver of
    ``mesh.index``; a ``mesh=`` keyword wins."""
    pos = config.COLLECTIVE_CALLS[tail][1]
    if pos is None:
        return None
    if pos == config.MESH_RECEIVER:
        return call.func.value if isinstance(call.func, ast.Attribute) \
            else None
    cand = _positional(call, pos)
    for kw in call.keywords:
        if kw.arg == "mesh":
            cand = kw.value
    return cand


def mesh_lookup(node: ast.AST) -> Optional[Tuple[str, ast.expr, ast.expr]]:
    """(map name, mesh expression, axis expression) of a
    ``mesh.shape[axis]`` / ``mesh.coords[axis]`` / ``mesh.groups[axis]``
    subscript on a receiver named like a mesh; None otherwise."""
    if not isinstance(node, ast.Subscript) \
            or not isinstance(node.value, ast.Attribute) \
            or node.value.attr not in config.MESH_AXIS_MAPS:
        return None
    receiver = dotted_name(node.value.value)
    if receiver is None or not config.MESH_RECEIVER_RE.search(receiver):
        return None
    return node.value.attr, node.value.value, node.slice


def axis_ref(expr: Optional[ast.expr]) -> Tuple[Optional[str],
                                                Optional[str]]:
    """(kind, value) of an axis expression: ("str", literal), ("name",
    identifier to resolve through the env, parameters and constants),
    ("self", attribute assigned in the class), or (None, None)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return "str", expr.value
    if isinstance(expr, ast.Name):
        return "name", expr.id
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self":
        return "self", expr.attr
    return None, None


class FnSummary:
    """What one function does that the collective and interprocedural
    rules care about."""

    __slots__ = ("collectives", "mesh_lookups", "calls", "param_defaults")

    def __init__(self):
        # (call node, collective tail, axis_kind, axis_value, mesh expr):
        #   axis_kind as axis_ref gives it; the mesh expression is None
        #   for torch.distributed's calls
        self.collectives: List[Tuple[ast.Call, str, Optional[str],
                                     Optional[str],
                                     Optional[ast.expr]]] = []
        # (subscript node, map name, axis_kind, axis_value, mesh expr)
        self.mesh_lookups: List[Tuple[ast.Subscript, str, Optional[str],
                                      Optional[str], ast.expr]] = []
        self.calls: List[Tuple[ast.Call, str]] = []  # (node, dotted callee)
        self.param_defaults: Dict[str, ast.expr] = {}


class ProgramModel:
    def __init__(self, scanned: Dict[str, ModuleModel],
                 with_package_context: bool = True):
        self.modules: Dict[str, ModuleModel] = {}
        if with_package_context:
            self.modules.update(_load_package_models())
        self.modules.update(scanned)  # scanned content wins over disk
        self.scanned: Set[str] = set(scanned)
        self._imports: Dict[str, Dict[str, Tuple[Optional[str], str]]] = {}
        self._constants: Dict[str, Dict[str, str]] = {}
        self._summaries: Dict[Tuple[str, int], FnSummary] = {}
        self._mesh_walks: Optional[List[tuple]] = None

    # -- imports / constants ----------------------------------------------

    def imports(self, path: str) -> Dict[str, Tuple[Optional[str], str]]:
        """{local name: (target module rel_path or None, remote name)} from
        every ImportFrom in the module (function-local imports included)."""
        if path in self._imports:
            return self._imports[path]
        out: Dict[str, Tuple[Optional[str], str]] = {}
        model = self.modules.get(path)
        if model is not None:
            pkg_parts = path.split("/")[:-1]  # directory of the module
            for node in ast.walk(model.tree):
                if isinstance(node, ast.Import):
                    # plain `import pkg.mod [as m]`: the bound name is a
                    # MODULE — remote name "" so def/constant lookups fail
                    # cleanly, but rules still see the name as imported
                    # (G010 must treat `m.helper(...)` as opaque, not as a
                    # benign method call on a local value)
                    for alias in node.names:
                        local = (alias.asname or
                                 alias.name.split(".", 1)[0])
                        dotted = alias.name if alias.asname \
                            else alias.name.split(".", 1)[0]
                        target = None
                        if _in_package(dotted):
                            parts = dotted.split(".")
                            for cand in ("/".join(parts) + ".py",
                                         "/".join(parts) + "/__init__.py"):
                                if cand in self.modules:
                                    target = cand
                                    break
                        out[local] = (target, "")
                    continue
                if not isinstance(node, ast.ImportFrom):
                    continue
                target = self._resolve_import_module(node, pkg_parts)
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    out[local] = (target, alias.name)
        self._imports[path] = out
        return out

    def _resolve_import_module(self, node: ast.ImportFrom,
                               pkg_parts: List[str]) -> Optional[str]:
        """Rel_path of the module an ImportFrom pulls from, when it lives
        in the analyzed program; None for external modules (jax, numpy)."""
        if node.level and not pkg_parts:
            return None
        if node.level:
            base = pkg_parts[:len(pkg_parts) - (node.level - 1)] \
                if node.level > 1 else list(pkg_parts)
            if node.level > 1 and len(pkg_parts) < node.level - 1:
                return None
            parts = base + (node.module.split(".") if node.module else [])
        else:
            if not node.module or not _in_package(node.module):
                return None
            parts = node.module.split(".")
        for cand in ("/".join(parts) + ".py",
                     "/".join(parts) + "/__init__.py"):
            if cand in self.modules:
                return cand
        return None

    def constants(self, path: str) -> Dict[str, str]:
        """Module-level ``NAME = "literal"`` string constants."""
        if path in self._constants:
            return self._constants[path]
        out: Dict[str, str] = {}
        model = self.modules.get(path)
        if model is not None:
            for node in model.tree.body:
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, str):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            out[tgt.id] = node.value.value
        self._constants[path] = out
        return out

    def resolve_str(self, path: str, name: str,
                    _seen: Optional[Set[Tuple[str, str]]] = None
                    ) -> Optional[str]:
        """Resolve an identifier to a string literal through module
        constants and import chains."""
        if _seen is None:
            _seen = set()
        if (path, name) in _seen:
            return None
        _seen.add((path, name))
        val = self.constants(path).get(name)
        if val is not None:
            return val
        imp = self.imports(path).get(name)
        if imp is not None and imp[0] is not None:
            return self.resolve_str(imp[0], imp[1], _seen)
        return None

    # -- def resolution ----------------------------------------------------

    def top_level_def(self, path: str, name: str) -> Optional[ast.AST]:
        model = self.modules.get(path)
        if model is None:
            return None
        for node in model.tree.body:
            if isinstance(node, _FN_TYPES) and node.name == name:
                return node
        return None

    def resolve_fn(self, path: str, name: str,
                   from_node: Optional[ast.AST] = None
                   ) -> Optional[Tuple[str, ast.AST]]:
        """(module, def node) for a bare function name: lexical scope in
        the home module first, then the import map."""
        model = self.modules.get(path)
        if model is not None and from_node is not None:
            fn = model.resolve_def(name, from_node)
            if fn is not None:
                return path, fn
        fn = self.top_level_def(path, name)
        if fn is not None:
            return path, fn
        imp = self.imports(path).get(name)
        if imp is not None and imp[0] is not None:
            target = self.top_level_def(imp[0], imp[1])
            if target is not None:
                return imp[0], target
        return None

    def resolve_method(self, path: str, fn: ast.AST, callee: str
                       ) -> Optional[Tuple[str, ast.AST]]:
        """(module, def) of a ``self.<name>(...)`` call made in a method of
        a class that defines ``<name>`` itself."""
        if not callee.startswith("self.") or callee.count(".") != 1:
            return None
        cls = _enclosing_class(fn)
        if cls is None:
            return None
        name = callee.split(".", 1)[1]
        for node in cls.body:
            if isinstance(node, _FN_TYPES) and node.name == name:
                return path, node
        return None

    # -- summaries ---------------------------------------------------------

    def summary(self, path: str, fn: ast.AST) -> FnSummary:
        key = (path, id(fn))
        cached = self._summaries.get(key)
        if cached is not None:
            return cached
        s = FnSummary()
        args = fn.args
        pos = args.posonlyargs + args.args
        for a, d in zip(pos[len(pos) - len(args.defaults):], args.defaults):
            s.param_defaults[a.arg] = d
        for a, d in zip(args.kwonlyargs, args.kw_defaults):
            if d is not None:
                s.param_defaults[a.arg] = d
        for node in walk_scope(fn):
            lookup = mesh_lookup(node)
            if lookup is not None:
                kind, value = axis_ref(lookup[2])
                s.mesh_lookups.append((node, lookup[0], kind, value,
                                       lookup[1]))
                continue
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if callee is None:
                continue
            s.calls.append((node, callee))
            tail = collective_tail(callee)
            if tail is not None:
                kind, value = axis_ref(collective_axis_expr(node, tail))
                s.collectives.append((node, tail, kind, value,
                                      collective_mesh_expr(node, tail)))
        self._summaries[key] = s
        return s

    def param_names(self, fn: ast.AST) -> List[str]:
        a = fn.args
        return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]

    # -- mesh-axes resolution ---------------------------------------------

    def mesh_axes(self, path: str, expr: Optional[ast.expr],
                  scope: Optional[ast.AST],
                  env: Optional[Dict[str, tuple]] = None, depth: int = 0
                  ) -> Optional[Set[str]]:
        """Axis-name set of a mesh expression; None = unknown."""
        if expr is None or depth > 6:
            return None
        env = env or {}
        model = self.modules.get(path)
        if isinstance(expr, ast.Call):
            return self._mesh_axes_of_call(path, expr, scope, env)
        if isinstance(expr, ast.IfExp):
            a = self.mesh_axes(path, expr.body, scope, env, depth + 1)
            b = self.mesh_axes(path, expr.orelse, scope, env, depth + 1)
            return (a | b) if a is not None and b is not None else None
        if isinstance(expr, ast.Name) and model is not None:
            bound = env.get(expr.id)
            if bound is not None:
                return set(bound[1]) if bound[0] == "mesh" else None
            assign = self._unique_assignment(model, expr.id, scope)
            if assign is not None:
                return self.mesh_axes(path, assign, scope, env, depth + 1)
            return None
        if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                          ast.Name) \
                and expr.value.id == "self" and model is not None:
            assign, owner = self._find_self_assignment(scope, expr.attr)
            if assign is not None:
                return self.mesh_axes(path, assign, owner, {}, depth + 1)
        return None

    def _axis_arg(self, path: str, call: ast.Call, kwarg: str,
                  target: Optional[Tuple[str, ast.AST]],
                  scope: Optional[ast.AST], env: Dict[str, tuple]
                  ) -> Tuple[bool, Optional[str]]:
        """Resolve an axis-name argument of a mesh-constructor call:
        explicit kwarg, explicit positional (matched against the
        constructor def's signature), else the def's default. Returns
        (explicitly_passed, value) — an explicit argument that does NOT
        resolve must make the whole mesh unknown, never fall back to the
        default."""
        for kw in call.keywords:
            if kw.arg == kwarg:
                return True, self._str_of(path, kw.value, scope, env)
        if target is not None:
            t_path, t_fn = target
            params = [a.arg for a in
                      t_fn.args.posonlyargs + t_fn.args.args]
            if kwarg in params:
                i = params.index(kwarg)
                if i < len(call.args) and not any(
                        isinstance(a, ast.Starred) for a in call.args):
                    return True, self._str_of(path, call.args[i], scope,
                                              env)
            default = self.summary(t_path, t_fn).param_defaults.get(kwarg)
            if default is not None:
                return False, self._str_of(t_path, default, None, {})
        return False, None

    def _mesh_axes_of_call(self, path: str, call: ast.Call,
                           scope: Optional[ast.AST], env: Dict[str, tuple]
                           ) -> Optional[Set[str]]:
        callee = dotted_name(call.func) or ""
        tail = callee.rsplit(".", 1)[-1]
        if tail == "Mesh":
            # core/collectives.Mesh(axis_names, shape, coords, groups, ...)
            names = call.args[0] if call.args else None
            for kw in call.keywords:
                if kw.arg == "axis_names":
                    names = kw.value
            if names is None:
                return None
            return self._axis_name_set(path, names, scope, env)
        # the registry-default fallbacks below are parallel/mesh.py's
        # make_mesh / make_mesh_2d conventions: they apply only to the
        # exact bare names (a dotted torch...make_mesh or a make_meshgrid
        # must stay unknown, not default to 'workers')
        if tail == "make_mesh_2d" and "." not in callee:
            target = self.resolve_fn(path, callee, call)
            rep_given, rep = self._axis_arg(path, call, "replica_axis",
                                            target, scope, env)
            shd_given, shd = self._axis_arg(path, call, "shard_axis",
                                            target, scope, env)
            if (rep_given and rep is None) or (shd_given and shd is None):
                return None  # explicitly passed but unresolvable: unknown
            return {rep or "workers", shd or "shards"}
        if tail == "make_mesh" and "." not in callee:
            target = self.resolve_fn(path, callee, call)
            given, axis = self._axis_arg(path, call, "axis_name", target,
                                         scope, env)
            if given and axis is None:
                return None  # explicitly passed but unresolvable: unknown
            return {axis or "workers"}  # the stock make_mesh default
        return None

    def _axis_name_set(self, path: str, names: ast.expr,
                       scope: Optional[ast.AST], env: Dict[str, tuple]
                       ) -> Optional[Set[str]]:
        """Axis-name set of an explicit axis_names expression (tuple/list
        of resolvable strings, or a single name); None = unresolvable —
        an explicitly-passed-but-unknown spelling must make the whole
        mesh unknown, never fall back to a default."""
        if isinstance(names, (ast.Tuple, ast.List)):
            out: Set[str] = set()
            for elt in names.elts:
                s = self._str_of(path, elt, scope, env)
                if s is None:
                    return None
                out.add(s)
            return out
        s = self._str_of(path, names, scope, env)
        return {s} if s is not None else None

    def _find_assignment(self, model: ModuleModel, name: str,
                         scope: Optional[ast.AST]) -> Optional[ast.expr]:
        """Last single-target assignment (or param default) giving `name` a
        value, searched in the enclosing function chain then the module
        body (the reference's reading, which G034 keeps)."""
        cur = scope
        while cur is not None:
            found = None
            for node in walk_scope(cur):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id == name:
                    found = node.value
            if found is not None:
                return found
            if isinstance(cur, _FN_TYPES):
                default = self.summary(model.rel_path, cur) \
                    .param_defaults.get(name)
                if default is not None and name in self.param_names(cur):
                    return default
            cur = model.enclosing_function(cur)
        for node in model.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == name:
                return node.value
        return None

    def _unique_assignment(self, model: ModuleModel, name: str,
                         scope: Optional[ast.AST]) -> Optional[ast.expr]:
        """The one assignment (or parameter default) giving `name` its
        value, searched in the enclosing function chain then the module
        body. Two assignments in one scope, or an assignment in a function
        that also takes `name` as a parameter, give None: the value
        depends on the path taken."""
        cur = scope
        while cur is not None:
            found = [node.value for node in walk_scope(cur)
                     if isinstance(node, ast.Assign)
                     and len(node.targets) == 1
                     and isinstance(node.targets[0], ast.Name)
                     and node.targets[0].id == name]
            is_param = isinstance(cur, _FN_TYPES) \
                and name in self.param_names(cur)
            if found:
                return found[0] if len(found) == 1 and not is_param \
                    else None
            if is_param:
                return self.summary(model.rel_path, cur) \
                    .param_defaults.get(name)
            cur = model.enclosing_function(cur)
        found = [node.value for node in model.tree.body
                 if isinstance(node, ast.Assign) and len(node.targets) == 1
                 and isinstance(node.targets[0], ast.Name)
                 and node.targets[0].id == name]
        return found[0] if len(found) == 1 else None

    def _find_self_assignment(self, scope: Optional[ast.AST], attr: str
                              ) -> Tuple[Optional[ast.expr],
                                         Optional[ast.AST]]:
        """rhs of the one ``self.<attr> = ...`` in the enclosing class,
        plus the method it is in; (None, None) when the class assigns it
        more than once or as part of a tuple."""
        cls = _enclosing_class(scope)
        if cls is None:
            return None, None
        found = []
        for m in cls.body:
            if not isinstance(m, _FN_TYPES):
                continue
            for node in walk_scope(m):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target] if isinstance(
                        node, (ast.AugAssign, ast.AnnAssign)) else []
                for tgt in targets:
                    for t in ast.walk(tgt):
                        if isinstance(t, ast.Attribute) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id == "self" and t.attr == attr:
                            found.append((tgt is t and isinstance(
                                node, ast.Assign) and len(node.targets) == 1,
                                getattr(node, "value", None), m))
        if len(found) != 1 or not found[0][0]:
            return None, None
        return found[0][1], found[0][2]

    def _str_of(self, path: str, expr: ast.expr, scope: Optional[ast.AST],
                env: Optional[Dict[str, tuple]] = None) -> Optional[str]:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Name):
            bound = (env or {}).get(expr.id)
            if bound is not None:
                return bound[1] if bound[0] == "str" else None
            return self.resolve_str(path, expr.id)
        return None

    # -- call-edge environments -------------------------------------------

    def call_env(self, caller_path: str, call: ast.Call, callee_path: str,
                 callee: ast.AST, caller_env: Dict[str, tuple],
                 caller_fn: Optional[ast.AST] = None) -> Dict[str, tuple]:
        """Bind the callee's parameters to resolvable caller arguments:
        string literals / constants propagate as ("str", v), names that
        resolve to defs as ("fn", module, def, env), meshes whose
        construction resolves as ("mesh", axis frozenset). Callee defaults
        fill the parameters the call does not pass; an argument passed
        that does not resolve leaves its parameter unbound."""
        params = [a.arg for a in callee.args.posonlyargs + callee.args.args]
        env: Dict[str, tuple] = {}
        summ = self.summary(callee_path, callee)
        for p, d in summ.param_defaults.items():
            v = self._value_of(callee_path, d, {}, None)
            if v is not None:
                env[p] = v
        offset = 1 if params[:1] == ["self"] else 0
        if caller_fn is None:
            model = self.modules.get(caller_path)
            caller_fn = model.enclosing_function(call) if model else None

        def bind(name: str, arg: ast.expr) -> None:
            v = self._value_of(caller_path, arg, caller_env, caller_fn)
            if v is not None:
                env[name] = v
            else:
                env.pop(name, None)

        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            j = i + offset
            if j < len(params):
                bind(params[j], arg)
        for kw in call.keywords:
            if kw.arg is not None:
                bind(kw.arg, kw.value)
        return env

    def _value_of(self, path: str, expr: ast.expr, env: Dict[str, tuple],
                  scope: Optional[ast.AST]) -> Optional[tuple]:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return ("str", expr.value)
        if isinstance(expr, ast.Name):
            if expr.id in env:
                return env[expr.id]
            s = self.resolve_str(path, expr.id)
            if s is not None:
                return ("str", s)
            got = self.resolve_fn(path, expr.id, expr)
            if got is not None:
                return ("fn", got[0], got[1], {})
        if _names_a_mesh(expr):
            axes = self.mesh_axes(path, expr, scope, env)
            if axes is not None:
                return ("mesh", frozenset(axes))
        return None

    # -- interprocedural walk ---------------------------------------------

    def walk_calls(self, path: str, fn: ast.AST, env: Dict[str, tuple],
                   depth: int = 0,
                   _visited: Optional[Set[Tuple[str, int]]] = None
                   ) -> Iterator[Tuple[str, ast.AST, FnSummary,
                                       Dict[str, tuple]]]:
        """Yield (module, def, summary, env) for `fn` and every function
        transitively reachable from it through resolvable call edges
        (bare names, and ``self.method`` within the class), depth-bounded
        and cycle-safe."""
        if _visited is None:
            _visited = set()
        key = (path, id(fn))
        if key in _visited or depth > MAX_CALL_DEPTH:
            return
        _visited.add(key)
        summ = self.summary(path, fn)
        yield path, fn, summ, env
        # defs nested in fn run as part of the same computation (closures
        # handed on, step bodies); their free variables see fn's bindings,
        # so they inherit the env
        model = self.modules.get(path)
        if model is not None:
            for nested in model.functions:
                if model.enclosing_function(nested) is fn:
                    yield from self.walk_calls(path, nested, dict(env),
                                               depth + 1, _visited)
        for call, callee in summ.calls:
            target = self.call_target(path, fn, call, callee, env)
            if target is None:
                continue
            t_path, t_fn, t_closure = target
            t_env = self.call_env(path, call, t_path, t_fn, env, fn)
            merged = dict(t_closure)
            merged.update(t_env)
            yield from self.walk_calls(t_path, t_fn, merged, depth + 1,
                                       _visited)

    def call_target(self, path: str, fn: ast.AST, call: ast.Call,
                    callee: str, env: Dict[str, tuple]
                    ) -> Optional[Tuple[str, ast.AST, Dict[str, tuple]]]:
        """(module, def, closure env) a call resolves to, or None."""
        if "." not in callee:
            bound = env.get(callee)
            if bound is not None and bound[0] == "fn":
                return bound[1], bound[2], dict(bound[3])
            got = self.resolve_fn(path, callee, call)
        else:
            got = self.resolve_method(path, fn, callee)
        return (got[0], got[1], {}) if got is not None else None

    def resolve_axis(self, path: str, fn: ast.AST, kind: Optional[str],
                     value: Optional[str], env: Dict[str, tuple]
                     ) -> Optional[str]:
        """Axis string of a summarized collective or lookup, given the
        walk env."""
        if kind == "str":
            return value
        if kind == "self" and value is not None:
            assign, owner = self._find_self_assignment(fn, value)
            return self._str_of(path, assign, owner) \
                if assign is not None else None
        if kind != "name" or value is None:
            return None
        bound = env.get(value)
        if bound is not None:
            return bound[1] if bound[0] == "str" else None
        if value in self.param_names(fn):
            default = self.summary(path, fn).param_defaults.get(value)
            if default is not None:
                v = self._value_of(path, default, {}, None)
                if v is not None and v[0] == "str":
                    return v[1]
            return None  # unbound dynamic parameter: trusted
        model = self.modules.get(path)
        if model is not None:
            assign = self._unique_assignment(model, value, fn)
            if assign is not None:
                return self._str_of(path, assign, fn, env)
        return self.resolve_str(path, value)

    # -- walks from the meshes' constructions -----------------------------

    def mesh_walks(self) -> List[Tuple[str, ast.AST, FnSummary,
                                       Dict[str, tuple]]]:
        """Every (module, def, summary, env) reached from a function that
        builds a mesh (a ``make_mesh`` / ``make_mesh_2d`` / ``Mesh(...)``
        call), or from a method of a class that stores one on ``self``:
        where a mesh's axis set can be known, and every callee it is
        passed to. G007 and G008 read the collectives and lookups of these
        walks against the mesh each one receives."""
        if self._mesh_walks is not None:
            return self._mesh_walks
        out = []
        for path, model in self.modules.items():
            if "make_mesh" not in model.source \
                    and "Mesh(" not in model.source:
                continue
            builders = {id(fn) for fn in model.functions
                        if any(_builds_mesh(n) for n in walk_scope(fn))}
            holders = set()
            for fn in model.functions:
                if id(fn) in builders:
                    cls = _enclosing_class(fn)
                    if cls is not None:
                        holders.add(id(cls))
            for fn in model.functions:
                cls = _enclosing_class(fn)
                if id(fn) in builders or (cls is not None
                                          and id(cls) in holders):
                    out.extend(self.walk_calls(path, fn, {}))
        self._mesh_walks = out
        return out

    # -- import graph (for --with-callers) --------------------------------

    def importers_of(self, targets: Set[str]) -> Set[str]:
        """Transitive closure of modules importing any of `targets`."""
        out: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for path in self.modules:
                if path in out or path in targets:
                    continue
                deps = {t for t, _ in self.imports(path).values()
                        if t is not None}
                if deps & (targets | out):
                    out.add(path)
                    changed = True
        return out


def _enclosing_class(node: Optional[ast.AST]) -> Optional[ast.ClassDef]:
    """The class whose method (or a def nested in one) `node` is in."""
    cur = node
    while cur is not None and not isinstance(cur, ast.ClassDef):
        cur = getattr(cur, "graftcheck_parent", None)
    return cur


def _builds_mesh(node: ast.AST) -> bool:
    """A ``Mesh(...)`` call, or a bare ``make_mesh`` / ``make_mesh_2d``
    call (parallel/mesh.py's constructors)."""
    if not isinstance(node, ast.Call):
        return False
    callee = dotted_name(node.func) or ""
    tail = callee.rsplit(".", 1)[-1]
    return tail == "Mesh" or (tail in ("make_mesh", "make_mesh_2d")
                              and "." not in callee)


def _names_a_mesh(expr: ast.expr) -> bool:
    """An argument the walk traces as a mesh: a mesh construction, or a
    variable named like a mesh."""
    if isinstance(expr, ast.IfExp):
        return _names_a_mesh(expr.body) or _names_a_mesh(expr.orelse)
    if _builds_mesh(expr):
        return True
    name = dotted_name(expr) if isinstance(expr, (ast.Name, ast.Attribute)) \
        else None
    return name is not None and bool(config.MESH_RECEIVER_RE.search(name))
