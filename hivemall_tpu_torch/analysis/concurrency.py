"""Concurrency model: guarded-by inference + thread entry points.

The serving path holds background threads (the micro-batcher's worker,
the pipeline's loop, the time-series sampler, the metrics endpoint),
condition variables and hot-swap state; the G012-G016 rules check that
code against a whole-program model, flagging only what they can prove.
This module provides, stdlib-only:

- per-class **lock discovery**: ``self._x = threading.Lock()/RLock()/
  Condition()`` fields with their reentrancy kind, plus module- and
  function-local lock names;
- a statement walker that tracks the **held-lock set** through ``with
  self._lock:`` scopes (and linear ``acquire()``/``release()`` pairs),
  recording every ``self.<field>`` access, call, and lock acquisition
  with the locks held at that point;
- **thread entry points**: ``threading.Thread(target=self._loop)``
  spawn targets and ``do_*`` HTTP-handler methods, closed over the
  intra-class call graph, so accesses can be attributed to "runs on the
  spawned thread" vs "runs on a caller thread";
- **context propagation** through helper calls: a private method called
  only under the lock inherits the caller's held set (depth-bounded via
  the held-set lattice), which is how ``self._bump_locked()`` bodies
  count as guarded and how re-acquiring a non-reentrant lock through a
  helper is detected;
- cross-class **lock-ordering edges**: acquiring ``B._cv`` while holding
  ``A._lock`` (resolved through module-level instances and
  ``self.field = ClassName(...)`` assignments) — cycles in that graph
  are the G016 deadlocks.

Everything dynamic (locks passed as parameters, receivers whose type
cannot be resolved) is trusted.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from . import config
from .modmodel import _FN_TYPES, ModuleModel, dotted_name, walk_scope
from .program import ProgramModel

ClassKey = Tuple[str, str]  # (module rel_path, class name)

_INIT_METHODS = ("__init__", "__new__")


class Access:
    """One ``self.<attr>`` touch with the locks held at that point."""

    __slots__ = ("method", "attr", "write", "line", "held")

    def __init__(self, method: str, attr: str, write: bool, line: int,
                 held: FrozenSet[str]):
        self.method = method
        self.attr = attr
        self.write = write
        self.line = line
        self.held = held


class CallEv:
    """One call with the locks held at the call site."""

    __slots__ = ("method", "node", "dotted", "held", "line")

    def __init__(self, method: str, node: ast.Call, dotted: str,
                 held: FrozenSet[str]):
        self.method = method
        self.node = node
        self.dotted = dotted
        self.held = held
        self.line = node.lineno


class Acquire:
    """One lock acquisition (with-statement or .acquire()) and the locks
    already held when it happens."""

    __slots__ = ("method", "lock", "held", "node")

    def __init__(self, method: str, lock: str, held: FrozenSet[str],
                 node: ast.AST):
        self.method = method
        self.lock = lock
        self.held = held
        self.node = node


class _Events:
    __slots__ = ("accesses", "calls", "acquisitions")

    def __init__(self):
        self.accesses: List[Access] = []
        self.calls: List[CallEv] = []
        self.acquisitions: List[Acquire] = []


class ClassConc:
    """Concurrency summary of one class."""

    __slots__ = ("path", "node", "name", "locks", "methods", "spawn_targets",
                 "thread_side", "thread_entries", "raw", "contexts",
                 "eff_accesses", "eff_calls", "double_acquires")

    def __init__(self, path: str, node: ast.ClassDef):
        self.path = path
        self.node = node
        self.name = node.name
        self.locks: Dict[str, str] = {}  # field -> kind
        self.methods: Dict[str, ast.AST] = {
            n.name: n for n in node.body if isinstance(n, _FN_TYPES)}
        self.spawn_targets: Set[str] = set()
        self.thread_side: Set[str] = set()
        # DIRECT thread entry points only (spawn targets + do_* handlers):
        # the zero-held propagation seeds. thread_side is the CLOSURE over
        # the call graph — right for "which methods run on the worker
        # thread" (G012 cross-thread proof) but wrong as a held-set seed:
        # a helper reached only via `with self._lock:` call sites would be
        # falsely analyzed lock-free (its real contexts flow through the
        # caller's held set).
        self.thread_entries: Set[str] = set()
        self.raw: Dict[str, _Events] = {}
        # method -> {held-at-entry: introducing call node (None for entries)}
        self.contexts: Dict[str, Dict[FrozenSet[str],
                                      Optional[ast.AST]]] = {}
        self.eff_accesses: Dict[str, List[Access]] = {}  # field -> accesses
        self.eff_calls: List[CallEv] = []
        # (site node, lock name) — non-reentrant lock re-acquired
        self.double_acquires: List[Tuple[ast.AST, str]] = []

    @property
    def concurrent(self) -> bool:
        return bool(self.locks or self.spawn_targets or self.thread_side)


class LockEdge:
    """Acquiring `to` while holding `frm` (both (ClassKey, lockname))."""

    __slots__ = ("frm", "to", "site", "path")

    def __init__(self, frm, to, site: ast.AST, path: str):
        self.frm = frm
        self.to = to
        self.site = site
        self.path = path


def _lock_ctor_kind(expr: ast.expr) -> Optional[str]:
    if not isinstance(expr, ast.Call):
        return None
    d = dotted_name(expr.func) or ""
    tail = d.rsplit(".", 1)[-1]
    if tail in config.LOCK_CONSTRUCTOR_KINDS \
            and (d == tail or d.startswith(("threading.",
                                            "multiprocessing."))):
        return config.LOCK_CONSTRUCTOR_KINDS[tail]
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class ConcurrencyModel:
    def __init__(self, program: ProgramModel):
        self.program = program
        self.classes: Dict[ClassKey, ClassConc] = {}
        # (path, enclosing-def name, CallEv) for non-method defs — used by
        # G013 for module-level functions holding local/module locks
        self.fn_calls: List[Tuple[str, str, CallEv]] = []
        self.lock_edges: List[LockEdge] = []
        self._ctor_memo: Dict[Tuple[str, str, str], Optional[str]] = {}
        for path in sorted(program.modules):
            model = program.modules.get(path)
            if model is None:
                continue
            # per-module collection + per-class propagation are pure
            # per-module products — cache them on the ModuleModel, whose
            # lifetime (modelcache's mtime layer) already tracks file changes,
            # so repeated in-process scans (the test suite's _cli runs)
            # pay the walkers once per module version. Only the
            # cross-class lock-ordering edges rebuild per program.
            cached = getattr(model, "_graftcheck_conc", None)
            if cached is None:
                mod_classes: Dict[ClassKey, ClassConc] = {}
                mod_calls: List[Tuple[str, str, CallEv]] = []
                self._build_module(path, model, mod_classes, mod_calls)
                for cls in mod_classes.values():
                    self._propagate(cls)
                cached = (mod_classes, mod_calls)
                model._graftcheck_conc = cached  # type: ignore[attr-defined]
            for key, cls in cached[0].items():
                self.classes.setdefault(key, cls)
            self.fn_calls.extend(cached[1])
        self._build_edges()

    # -- construction ------------------------------------------------------

    def _build_module(self, path: str, model: ModuleModel,
                      out_classes: Dict[ClassKey, ClassConc],
                      out_calls: List[Tuple[str, str, CallEv]]) -> None:
        # cheap pre-filter: nothing lock/thread-shaped, nothing to model
        src = model.source
        if "Lock" not in src and "Condition" not in src \
                and "Thread" not in src and "Semaphore" not in src:
            return
        module_locks = self._module_lock_names(model)
        class_nodes = [n for n in ast.walk(model.tree)
                       if isinstance(n, ast.ClassDef)]
        for cnode in class_nodes:
            cls = ClassConc(path, cnode)
            for m in cls.methods.values():
                for node in walk_scope(m):
                    if isinstance(node, ast.Assign) \
                            and len(node.targets) == 1:
                        attr = _self_attr(node.targets[0])
                        kind = _lock_ctor_kind(node.value)
                        if attr is not None and kind is not None:
                            cls.locks[attr] = kind
                    if isinstance(node, ast.Call):
                        self._note_spawn(cls, node)
            for mname in (n for n in cnode.body if isinstance(n, _FN_TYPES)):
                if mname.name.startswith("do_"):
                    cls.thread_side.add(mname.name)
            for mname, m in cls.methods.items():
                cls.raw[mname] = self._collect(cls, mname, m, model,
                                               module_locks)
            self._close_thread_side(cls)
            out_classes.setdefault((path, cls.name), cls)
        # module-level and nested (non-method) defs: call events only
        for fn in model.functions:
            parent = getattr(fn, "graftcheck_parent", None)
            if isinstance(parent, ast.ClassDef):
                continue  # direct method, covered above
            owner = self._owning_class(fn, path, out_classes)
            ev = self._collect(owner, fn.name, fn, model, module_locks)
            for call in ev.calls:
                out_calls.append((path, fn.name, call))

    def _owning_class(self, fn: ast.AST, path: str,
                      classes: Dict[ClassKey, ClassConc]
                      ) -> Optional[ClassConc]:
        cur = getattr(fn, "graftcheck_parent", None)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return classes.get((path, cur.name))
            cur = getattr(cur, "graftcheck_parent", None)
        return None

    def _module_lock_names(self, model: ModuleModel) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for node in model.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                kind = _lock_ctor_kind(node.value)
                if kind is not None:
                    out["@" + node.targets[0].id] = kind
        return out

    def _note_spawn(self, cls: ClassConc, call: ast.Call) -> None:
        d = dotted_name(call.func) or ""
        if d.rsplit(".", 1)[-1] not in ("Thread", "Timer"):
            return
        for kw in call.keywords:
            if kw.arg == "target":
                attr = _self_attr(kw.value)
                if attr is not None and attr in cls.methods:
                    cls.spawn_targets.add(attr)

    def _close_thread_side(self, cls: ClassConc) -> None:
        cls.thread_entries = set(cls.thread_side) | cls.spawn_targets
        cls.thread_side |= cls.spawn_targets
        changed = True
        while changed:
            changed = False
            for mname in list(cls.thread_side):
                for ev in cls.raw.get(mname, _Events()).calls:
                    parts = ev.dotted.split(".")
                    if parts[0] == "self" and len(parts) == 2 \
                            and parts[1] in cls.methods \
                            and parts[1] not in cls.thread_side:
                        cls.thread_side.add(parts[1])
                        changed = True

    # -- the statement walker ---------------------------------------------

    def _collect(self, cls: Optional[ClassConc], mname: str, fn: ast.AST,
                 model: ModuleModel,
                 module_locks: Dict[str, str]) -> _Events:
        events = _Events()
        name_locks = dict(module_locks)
        # locals assigned a lock constructor anywhere in this def (and its
        # enclosing defs — closures see the outer function's locks)
        scope: Optional[ast.AST] = fn
        while scope is not None:
            for node in walk_scope(scope):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    kind = _lock_ctor_kind(node.value)
                    if kind is not None:
                        name_locks.setdefault(
                            "@" + node.targets[0].id, kind)
            scope = model.enclosing_function(scope)

        def lock_of(expr: ast.expr) -> Optional[str]:
            attr = _self_attr(expr)
            if attr is not None and cls is not None and attr in cls.locks:
                return attr
            if isinstance(expr, ast.Name) and "@" + expr.id in name_locks:
                return "@" + expr.id
            return None

        def record(tree: ast.AST, held: FrozenSet[str]) -> None:
            stack = [tree]
            while stack:
                node = stack.pop()
                if isinstance(node, _FN_TYPES + (ast.Lambda, ast.ClassDef)):
                    continue
                if isinstance(node, ast.Call):
                    d = dotted_name(node.func)
                    if d is not None:
                        events.calls.append(CallEv(mname, node, d, held))
                attr = _self_attr(node)
                if attr is not None and cls is not None \
                        and attr not in cls.locks \
                        and attr not in cls.methods:
                    write = isinstance(node.ctx, (ast.Store, ast.Del))
                    parent = getattr(node, "graftcheck_parent", None)
                    if isinstance(parent, ast.Subscript) \
                            and parent.value is node \
                            and isinstance(parent.ctx,
                                           (ast.Store, ast.Del)):
                        write = True
                    if isinstance(parent, ast.Attribute) \
                            and parent.value is node:
                        gp = getattr(parent, "graftcheck_parent", None)
                        if isinstance(gp, ast.Call) and gp.func is parent \
                                and parent.attr in config.MUTATOR_METHODS:
                            write = True
                    events.accesses.append(
                        Access(mname, attr, write, node.lineno, held))
                stack.extend(ast.iter_child_nodes(node))

        def walk(stmts, held: FrozenSet[str]) -> None:
            held = frozenset(held)
            for stmt in stmts:
                if isinstance(stmt, _FN_TYPES + (ast.ClassDef,)):
                    continue
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    add: List[str] = []
                    for item in stmt.items:
                        lk = lock_of(item.context_expr)
                        if lk is not None:
                            events.acquisitions.append(Acquire(
                                mname, lk, held | frozenset(add),
                                item.context_expr))
                            add.append(lk)
                        else:
                            record(item.context_expr, held | frozenset(add))
                            if item.optional_vars is not None:
                                record(item.optional_vars,
                                       held | frozenset(add))
                    walk(stmt.body, held | frozenset(add))
                    continue
                if isinstance(stmt, ast.Expr) \
                        and isinstance(stmt.value, ast.Call):
                    d = dotted_name(stmt.value.func) or ""
                    if d.endswith(".acquire") or d.endswith(".release"):
                        func = stmt.value.func
                        lk = lock_of(func.value) \
                            if isinstance(func, ast.Attribute) else None
                        if lk is not None:
                            if d.endswith(".acquire"):
                                events.acquisitions.append(Acquire(
                                    mname, lk, held, stmt.value))
                                held = held | {lk}
                            else:
                                held = held - {lk}
                            continue
                if isinstance(stmt, (ast.If, ast.While)):
                    record(stmt.test, held)
                    walk(stmt.body, held)
                    walk(stmt.orelse, held)
                elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                    record(stmt.iter, held)
                    record(stmt.target, held)
                    walk(stmt.body, held)
                    walk(stmt.orelse, held)
                elif isinstance(stmt, ast.Try):
                    walk(stmt.body, held)
                    for h in stmt.handlers:
                        walk(h.body, held)
                    walk(stmt.orelse, held)
                    walk(stmt.finalbody, held)
                else:
                    record(stmt, held)

        walk(fn.body, frozenset())
        return events

    # -- context propagation ----------------------------------------------

    def _propagate(self, cls: ClassConc) -> None:
        callers: Dict[str, List[CallEv]] = {}
        for mname, ev in cls.raw.items():
            for call in ev.calls:
                parts = call.dotted.split(".")
                if parts[0] == "self" and len(parts) == 2 \
                        and parts[1] in cls.methods:
                    callers.setdefault(parts[1], []).append(call)
        entries = set()
        for mname in cls.methods:
            is_dunder = mname.startswith("__") and mname.endswith("__")
            # thread_ENTRIES (direct spawn targets / do_* handlers) seed a
            # zero-held context; thread-side helpers reached only through
            # locked call sites inherit their callers' held sets instead
            # of being falsely seeded lock-free
            if (not mname.startswith("_") or is_dunder
                    or mname in cls.thread_entries
                    or mname not in callers):
                entries.add(mname)
        cls.contexts = {m: {} for m in cls.methods}
        work: List[Tuple[str, FrozenSet[str], Optional[ast.AST]]] = [
            (m, frozenset(), None) for m in sorted(entries)]
        while work:
            mname, ctx, site = work.pop()
            if ctx in cls.contexts[mname]:
                continue
            cls.contexts[mname][ctx] = site
            for call in cls.raw[mname].calls:
                parts = call.dotted.split(".")
                if parts[0] == "self" and len(parts) == 2 \
                        and parts[1] in cls.methods:
                    work.append((parts[1], frozenset(ctx | call.held),
                                 call.node))

        seen_acc: Set[tuple] = set()
        seen_dbl: Set[tuple] = set()
        for mname, contexts in cls.contexts.items():
            ev = cls.raw[mname]
            for ctx, site in sorted(contexts.items(),
                                    key=lambda kv: sorted(kv[0])):
                for a in ev.accesses:
                    eff = frozenset(ctx | a.held)
                    key = (a.method, a.attr, a.write, a.line, eff)
                    if key in seen_acc:
                        continue
                    seen_acc.add(key)
                    cls.eff_accesses.setdefault(a.attr, []).append(
                        Access(a.method, a.attr, a.write, a.line, eff))
                for call in ev.calls:
                    cls.eff_calls.append(CallEv(
                        call.method, call.node, call.dotted,
                        frozenset(ctx | call.held)))
                for acq in ev.acquisitions:
                    before = ctx | acq.held
                    if acq.lock in before \
                            and cls.locks.get(acq.lock) == "lock":
                        # re-acquiring a non-reentrant Lock: report at the
                        # call that carried the lock in (clearer than the
                        # inner with), or locally for with-inside-with
                        at = acq.node if acq.lock in acq.held \
                            else (site or acq.node)
                        key = (at.lineno, acq.lock)
                        if key not in seen_dbl:
                            seen_dbl.add(key)
                            cls.double_acquires.append((at, acq.lock))

    # -- lock-ordering edges -----------------------------------------------

    def _build_edges(self) -> None:
        for (path, cname), cls in sorted(self.classes.items()):
            key = (path, cname)
            lock_names = set(cls.locks)
            # intra-class nesting
            for mname, contexts in cls.contexts.items():
                for ctx in contexts:
                    for acq in cls.raw[mname].acquisitions:
                        if acq.lock not in lock_names:
                            continue
                        for x in sorted((ctx | acq.held) & lock_names):
                            if x != acq.lock:
                                self.lock_edges.append(LockEdge(
                                    (key, x), (key, acq.lock),
                                    acq.node, path))
            # cross-class: a call made while holding one of our locks into
            # a method (of a resolvable instance) that acquires its own
            for call in cls.eff_calls:
                held_self = sorted(call.held & lock_names)
                if not held_self:
                    continue
                target = self._resolve_instance_method(cls, call.dotted)
                if target is None:
                    continue
                t_cls, t_method = target
                for y in self._acquired_locks(t_cls, t_method):
                    for x in held_self:
                        self.lock_edges.append(LockEdge(
                            (key, x), ((t_cls.path, t_cls.name), y),
                            call.node, path))

    def _acquired_locks(self, cls: ClassConc, method: str,
                        depth: int = 0,
                        _seen: Optional[Set[str]] = None) -> List[str]:
        """Self-lock names a method (transitively) acquires."""
        if _seen is None:
            _seen = set()
        if method in _seen or depth > 3:
            return []
        _seen.add(method)
        out: Set[str] = set()
        ev = cls.raw.get(method)
        if ev is None:
            return []
        for acq in ev.acquisitions:
            if acq.lock in cls.locks:
                out.add(acq.lock)
        for call in ev.calls:
            parts = call.dotted.split(".")
            if parts[0] == "self" and len(parts) == 2 \
                    and parts[1] in cls.methods:
                out.update(self._acquired_locks(cls, parts[1], depth + 1,
                                                _seen))
        return sorted(out)

    def _resolve_instance_method(self, cls: ClassConc, dotted: str
                                 ) -> Optional[Tuple[ClassConc, str]]:
        parts = dotted.split(".")
        target_cls: Optional[ClassConc] = None
        method: Optional[str] = None
        if parts[0] == "self" and len(parts) == 3:
            ctor = self._self_field_ctor(cls, parts[1])
            if ctor is not None:
                target_cls = self._resolve_class(cls.path, ctor)
            method = parts[2]
        elif len(parts) == 2:
            ctor = self._module_instance_ctor(cls.path, parts[0])
            if ctor is not None:
                target_cls = self._resolve_class(ctor[0], ctor[1])
            method = parts[1]
        if target_cls is None or method is None \
                or method not in target_cls.methods:
            return None
        return target_cls, method

    def _self_field_ctor(self, cls: ClassConc, field: str) -> Optional[str]:
        key = (cls.path, cls.name, field)
        if key in self._ctor_memo:
            return self._ctor_memo[key]
        got = self._self_field_ctor_uncached(cls, field)
        self._ctor_memo[key] = got
        return got

    def _self_field_ctor_uncached(self, cls: ClassConc,
                                  field: str) -> Optional[str]:
        methods = sorted(cls.methods.values(),
                         key=lambda m: m.name != "__init__")
        for m in methods:
            for node in walk_scope(m):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and _self_attr(node.targets[0]) == field \
                        and isinstance(node.value, ast.Call):
                    d = dotted_name(node.value.func)
                    if d is not None and "." not in d:
                        return d
        return None

    def _module_instance_ctor(self, path: str, name: str,
                              _seen: Optional[Set[Tuple[str, str]]] = None
                              ) -> Optional[Tuple[str, str]]:
        """(module, ctor name) for a module-level ``NAME = Ctor()``,
        following import hops (cycle-safe: circular re-exports resolve
        to None, trusted)."""
        if _seen is None:
            _seen = set()
        if (path, name) in _seen:
            return None
        _seen.add((path, name))
        model = self.program.modules.get(path)
        if model is not None:
            for node in model.tree.body:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id == name \
                        and isinstance(node.value, ast.Call):
                    d = dotted_name(node.value.func)
                    if d is not None and "." not in d:
                        return path, d
        imp = self.program.imports(path).get(name)
        if imp is not None and imp[0] is not None and imp[1]:
            return self._module_instance_ctor(imp[0], imp[1], _seen)
        return None

    def _resolve_class(self, path: str, name: str) -> Optional[ClassConc]:
        got = self.classes.get((path, name))
        if got is not None:
            return got
        imp = self.program.imports(path).get(name)
        if imp is not None and imp[0] is not None:
            return self.classes.get((imp[0], imp[1]))
        return None


def get_model(program: ProgramModel) -> ConcurrencyModel:
    """One ConcurrencyModel per ProgramModel (the runner builds one program
    per scan; all four concurrency rules share the model)."""
    model = getattr(program, "_graftcheck_concurrency", None)
    if model is None:
        model = ConcurrencyModel(program)
        program._graftcheck_concurrency = model
    return model


def in_g013_scope(path: str, model: Optional[ModuleModel]) -> bool:
    """G013 runs on the serving hot path plus opted-in modules."""
    if path.startswith(config.CONCURRENCY_HOT_PREFIXES):
        return True
    return model is not None and config.CONCURRENCY_MARKER in model.source
