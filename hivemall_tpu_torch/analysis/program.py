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
- per-function **summaries**: outgoing calls (and collective calls with
  their axis expression) plus parameter defaults;
- def resolution (``resolve_fn``, ``resolve_callable``) and call-edge
  environments, with a depth-bounded interprocedural **walk**;
- the JAX package's ``shard_map`` site and mesh-axes resolution, kept so
  that the model is the reference's; the port's collectives are
  ``torch.distributed`` calls, which no rule here reads yet.

Resolution is deliberately conservative: every rule built on this model
flags only what it can *prove*; anything dynamic is trusted.

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
#             ("fn", module_path, fn_node, closure_env) for function values
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
# shard_map call sites
# --------------------------------------------------------------------------

class ShardMapSite:
    """One shard_map(...) call: the body/mesh/specs expressions plus the
    module and enclosing function they appear in."""

    __slots__ = ("module", "call", "fn_expr", "mesh_expr", "in_specs_expr",
                 "out_specs_expr")

    def __init__(self, module: str, call: ast.Call):
        self.module = module
        self.call = call
        args = list(call.args)
        self.fn_expr = args[0] if args else None
        kw = {k.arg: k.value for k in call.keywords}
        self.mesh_expr = kw.get("mesh", args[1] if len(args) > 1 else None)
        self.in_specs_expr = kw.get("in_specs",
                                    args[2] if len(args) > 2 else None)
        self.out_specs_expr = kw.get("out_specs",
                                     args[3] if len(args) > 3 else None)


class FnSummary:
    """What one function does that sharding rules care about."""

    __slots__ = ("collectives", "calls", "param_defaults")

    def __init__(self):
        # (call node, collective tail, axis_kind, axis_value)
        #   axis_kind: "str" (resolved literal), "name" (identifier to
        #   resolve through params/constants), None (dynamic)
        self.collectives: List[Tuple[ast.Call, str, Optional[str],
                                     Optional[str]]] = []
        self.calls: List[Tuple[ast.Call, str]] = []  # (node, dotted callee)
        self.param_defaults: Dict[str, ast.expr] = {}


def collective_axis_expr(call: ast.Call, tail: str) -> Optional[ast.expr]:
    """The axis-name expression of a collective call, mirroring G004:
    ``axis_index(axis)`` takes it first, ``psum(x, axis)`` second,
    ``axis_name=``/``axis=`` kwargs win."""
    cand = None
    if tail == "axis_index":
        cand = call.args[0] if call.args else None
    elif len(call.args) >= 2:
        cand = call.args[1]
    for kw in call.keywords:
        if kw.arg in ("axis_name", "axis"):
            cand = kw.value
    return cand


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
        self._sites: Optional[List[ShardMapSite]] = None

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
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if callee is None:
                continue
            s.calls.append((node, callee))
            tail = callee.rsplit(".", 1)[-1]
            if tail in config.COLLECTIVE_CALLS:
                cand = collective_axis_expr(node, tail)
                if isinstance(cand, ast.Constant) \
                        and isinstance(cand.value, str):
                    s.collectives.append((node, tail, "str", cand.value))
                elif isinstance(cand, ast.Name):
                    s.collectives.append((node, tail, "name", cand.id))
                else:
                    s.collectives.append((node, tail, None, None))
        self._summaries[key] = s
        return s

    def param_names(self, fn: ast.AST) -> List[str]:
        a = fn.args
        return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]

    # -- shard_map sites ---------------------------------------------------

    def shard_map_sites(self) -> List[ShardMapSite]:
        if self._sites is None:
            self._sites = []
            for path, model in self.modules.items():
                if "shard_map" not in model.source:  # cheap pre-filter
                    continue
                for node in ast.walk(model.tree):
                    if isinstance(node, ast.Call):
                        callee = dotted_name(node.func) or ""
                        if callee.rsplit(".", 1)[-1] == "shard_map":
                            self._sites.append(ShardMapSite(path, node))
        return self._sites

    # -- mesh-axes resolution ---------------------------------------------

    def mesh_axes(self, path: str, expr: Optional[ast.expr],
                  scope: Optional[ast.AST], depth: int = 0
                  ) -> Optional[Set[str]]:
        """Best-effort axis-name set of a mesh expression; None = unknown."""
        if expr is None or depth > 6:
            return None
        model = self.modules.get(path)
        if isinstance(expr, ast.Call):
            return self._mesh_axes_of_call(path, expr, scope, depth)
        if isinstance(expr, ast.IfExp):
            a = self.mesh_axes(path, expr.body, scope, depth + 1)
            b = self.mesh_axes(path, expr.orelse, scope, depth + 1)
            return (a | b) if a is not None and b is not None else None
        if isinstance(expr, ast.BoolOp) and isinstance(expr.op, ast.Or):
            vals = [self.mesh_axes(path, v, scope, depth + 1)
                    for v in expr.values]
            if all(v is not None for v in vals):
                out: Set[str] = set()
                for v in vals:
                    out |= v  # type: ignore[arg-type]
                return out
            return None
        if isinstance(expr, ast.Name) and model is not None:
            assign = self._find_assignment(model, expr.id, scope)
            if assign is not None:
                return self.mesh_axes(path, assign, scope, depth + 1)
            return None
        if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                          ast.Name) \
                and expr.value.id == "self" and model is not None:
            assign, owner = self._find_self_assignment(model, scope,
                                                       expr.attr)
            if assign is not None:
                return self.mesh_axes(path, assign, owner, depth + 1)
        return None

    def _axis_arg(self, path: str, call: ast.Call, kwarg: str,
                  target: Optional[Tuple[str, ast.AST]],
                  scope: Optional[ast.AST]) -> Tuple[bool, Optional[str]]:
        """Resolve an axis-name argument of a mesh-constructor call:
        explicit kwarg, explicit positional (matched against the
        constructor def's signature), else the def's default. Returns
        (explicitly_passed, value) — an explicit argument that does NOT
        resolve must make the whole mesh unknown, never fall back to the
        default."""
        for kw in call.keywords:
            if kw.arg == kwarg:
                return True, self._str_of(path, kw.value, scope)
        if target is not None:
            t_path, t_fn = target
            params = [a.arg for a in
                      t_fn.args.posonlyargs + t_fn.args.args]
            if kwarg in params:
                i = params.index(kwarg)
                if i < len(call.args) and not any(
                        isinstance(a, ast.Starred) for a in call.args):
                    return True, self._str_of(path, call.args[i], scope)
            default = self.summary(t_path, t_fn).param_defaults.get(kwarg)
            if default is not None:
                return False, self._str_of(t_path, default, None)
        return False, None

    def _mesh_axes_of_call(self, path: str, call: ast.Call,
                           scope: Optional[ast.AST], depth: int
                           ) -> Optional[Set[str]]:
        callee = dotted_name(call.func) or ""
        tail = callee.rsplit(".", 1)[-1]
        if tail == "Mesh":
            names = None
            if len(call.args) >= 2:
                names = call.args[1]
            for kw in call.keywords:
                if kw.arg == "axis_names":
                    names = kw.value
            if names is None:
                return None
            return self._axis_name_set(path, names, scope)
        # the registry-default fallbacks below are the REPO's make_mesh /
        # make_mesh_2d conventions: they apply only to the exact bare
        # names (a dotted jax.make_mesh or a make_meshgrid must stay
        # unknown, not default to 'workers')
        if tail == "make_mesh_2d" and "." not in callee:
            target = self.resolve_fn(path, callee, call)
            rep_given, rep = self._axis_arg(path, call, "replica_axis",
                                            target, scope)
            shd_given, shd = self._axis_arg(path, call, "shard_axis",
                                            target, scope)
            if (rep_given and rep is None) or (shd_given and shd is None):
                return None  # explicitly passed but unresolvable: unknown
            rep = rep or "workers"
            shd = shd or "shards"
            return {rep, shd}
        if tail == "make_mesh" and "." not in callee:
            target = self.resolve_fn(path, callee, call)
            given, axis = self._axis_arg(path, call, "axis_name", target,
                                         scope)
            if given and axis is None:
                return None  # explicitly passed but unresolvable: unknown
            if axis is None:
                axis = "workers"  # the stock make_mesh default
            return {axis}
        if tail == "named_mesh" and ("." not in callee
                                     or "jax_compat" in callee):
            # the serving-mesh helper (runtime/jax_compat.named_mesh):
            # axis_names is the 2nd positional or keyword; its signature
            # default is the serving convention ("batch", "model") — this
            # is what lets G008 validate PartitionSpecs over the sharded
            # SERVING load path (serving/placement.py, serving/sharded.py)
            names = call.args[1] if len(call.args) >= 2 else None
            for kw in call.keywords:
                if kw.arg == "axis_names":
                    names = kw.value
            if names is None:
                return {"batch", "model"}
            return self._axis_name_set(path, names, scope)
        return None

    def _axis_name_set(self, path: str, names: ast.expr,
                       scope: Optional[ast.AST]) -> Optional[Set[str]]:
        """Axis-name set of an explicit axis_names expression (tuple/list
        of resolvable strings, or a single name); None = unresolvable —
        an explicitly-passed-but-unknown spelling must make the whole
        mesh unknown, never fall back to a default."""
        if isinstance(names, (ast.Tuple, ast.List)):
            out: Set[str] = set()
            for elt in names.elts:
                s = self._str_of(path, elt, scope)
                if s is None:
                    return None
                out.add(s)
            return out
        s = self._str_of(path, names, scope)
        return {s} if s is not None else None

    def _find_assignment(self, model: ModuleModel, name: str,
                         scope: Optional[ast.AST]) -> Optional[ast.expr]:
        """Last single-target assignment (or param default) giving `name` a
        value, searched in the enclosing function chain then the module
        body."""
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

    def _find_self_assignment(self, model: ModuleModel,
                              scope: Optional[ast.AST], attr: str
                              ) -> Tuple[Optional[ast.expr],
                                         Optional[ast.AST]]:
        """rhs of ``self.<attr> = ...`` anywhere in the enclosing class
        (searching __init__ first), plus the method it was found in."""
        cls = scope
        while cls is not None and not isinstance(cls, ast.ClassDef):
            cls = getattr(cls, "graftcheck_parent", None)
        if cls is None:
            return None, None
        methods = [n for n in cls.body if isinstance(n, _FN_TYPES)]
        methods.sort(key=lambda m: m.name != "__init__")
        for m in methods:
            for node in walk_scope(m):
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    tgt = node.targets[0]
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id == "self" and tgt.attr == attr:
                        return node.value, m
        return None, None

    def _str_of(self, path: str, expr: ast.expr,
                scope: Optional[ast.AST]) -> Optional[str]:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Name):
            return self.resolve_str(path, expr.id)
        return None

    # -- body resolution ---------------------------------------------------

    def resolve_callable(self, path: str, expr: Optional[ast.expr],
                         env: Optional[Dict[str, tuple]] = None,
                         depth: int = 0
                         ) -> Optional[Tuple[str, ast.AST, Dict[str, tuple]]]:
        """Resolve a callable expression to (module, def, closure_env).

        Handles: bare names; ``partial(f, ...)``; factory calls whose def
        ``return``s a nested def (the ``stripe_score(axis, shard)`` idiom)
        — the factory's resolvable string arguments become the closure env
        of the returned def, so axis names survive one factory hop."""
        env = env or {}
        if expr is None or depth > 4:
            return None
        if isinstance(expr, ast.Name):
            bound = env.get(expr.id)
            if bound is not None and bound[0] == "fn":
                return bound[1], bound[2], bound[3]
            got = self.resolve_fn(path, expr.id, expr)
            if got is not None:
                return got[0], got[1], {}
            return None
        if not isinstance(expr, ast.Call):
            return None
        callee = dotted_name(expr.func)
        if callee in ("partial", "functools.partial") and expr.args:
            return self.resolve_callable(path, expr.args[0], env, depth + 1)
        if callee is None or "." in callee:
            return None
        got = self.resolve_fn(path, callee, expr)
        if got is None:
            return None
        f_path, f_def = got
        f_env = self.call_env(path, expr, f_path, f_def, env)
        # factory: find `return <name>` where <name> is a def nested in it
        f_model = self.modules.get(f_path)
        if f_model is None:
            return None
        for node in walk_scope(f_def):
            if isinstance(node, ast.Return) and node.value is not None:
                inner = self.resolve_callable(f_path, node.value, f_env,
                                              depth + 1)
                if inner is not None:
                    return inner
                if isinstance(node.value, ast.Name):
                    nested = f_model.resolve_def(node.value.id, node)
                    if nested is not None:
                        return f_path, nested, f_env
        return None

    # -- call-edge environments -------------------------------------------

    def call_env(self, caller_path: str, call: ast.Call, callee_path: str,
                 callee: ast.AST, caller_env: Dict[str, tuple]
                 ) -> Dict[str, tuple]:
        """Bind the callee's parameters to resolvable caller arguments:
        string literals / constants propagate as ("str", v); names that
        resolve to defs propagate as ("fn", module, def, env). Unresolvable
        arguments stay unbound; callee defaults fill the rest."""
        params = [a.arg for a in callee.args.posonlyargs + callee.args.args]
        env: Dict[str, tuple] = {}
        summ = self.summary(callee_path, callee)
        for p, d in summ.param_defaults.items():
            v = self._value_of(callee_path, d, {})
            if v is not None:
                env[p] = v
        offset = 1 if params[:1] == ["self"] else 0

        def bind(name: str, arg: ast.expr) -> None:
            v = self._value_of(caller_path, arg, caller_env)
            if v is not None:
                env[name] = v

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

    def _value_of(self, path: str, expr: ast.expr,
                  env: Dict[str, tuple]) -> Optional[tuple]:
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
        return None

    # -- interprocedural walk ---------------------------------------------

    def walk_calls(self, path: str, fn: ast.AST, env: Dict[str, tuple],
                   depth: int = 0,
                   _visited: Optional[Set[Tuple[str, int]]] = None
                   ) -> Iterator[Tuple[str, ast.AST, FnSummary,
                                       Dict[str, tuple]]]:
        """Yield (module, def, summary, env) for `fn` and every function
        transitively reachable from it through resolvable call edges,
        depth-bounded and cycle-safe."""
        if _visited is None:
            _visited = set()
        key = (path, id(fn))
        if key in _visited or depth > MAX_CALL_DEPTH:
            return
        _visited.add(key)
        summ = self.summary(path, fn)
        yield path, fn, summ, env
        # defs nested in fn run as part of the same traced computation
        # (scan bodies, vmapped closures); their free variables see fn's
        # bindings, so they inherit the env
        model = self.modules.get(path)
        if model is not None:
            for nested in model.functions:
                if model.enclosing_function(nested) is fn:
                    yield from self.walk_calls(path, nested, dict(env),
                                               depth + 1, _visited)
        for call, callee in summ.calls:
            target: Optional[Tuple[str, ast.AST, Dict[str, tuple]]] = None
            if "." not in callee:
                bound = env.get(callee)
                if bound is not None and bound[0] == "fn":
                    target = (bound[1], bound[2], dict(bound[3]))
                else:
                    got = self.resolve_fn(path, callee, call)
                    if got is not None:
                        target = (got[0], got[1], {})
            if target is None:
                continue
            t_path, t_fn, t_closure = target
            t_env = self.call_env(path, call, t_path, t_fn, env)
            merged = dict(t_closure)
            merged.update(t_env)
            yield from self.walk_calls(t_path, t_fn, merged, depth + 1,
                                       _visited)

    def resolve_axis(self, path: str, fn: ast.AST, kind: Optional[str],
                     value: Optional[str], env: Dict[str, tuple]
                     ) -> Optional[str]:
        """Axis string of a summarized collective, given the walk env."""
        if kind == "str":
            return value
        if kind != "name" or value is None:
            return None
        bound = env.get(value)
        if bound is not None:
            return bound[1] if bound[0] == "str" else None
        if value in self.param_names(fn):
            default = self.summary(path, fn).param_defaults.get(value)
            if default is not None:
                v = self._value_of(path, default, {})
                if v is not None and v[0] == "str":
                    return v[1]
            return None  # unbound dynamic parameter: trusted
        return self.resolve_str(path, value)

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
