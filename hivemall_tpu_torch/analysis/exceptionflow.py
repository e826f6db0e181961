"""Exception-flow model: raise summaries, handler coverage, Future lifecycle.

The port's serving, pipeline and runtime code is failure-path code, and
its failure-path invariants — Futures always resolved, fallbacks always
LOUD with a named reason, locks released on every unwind, retries bounded
and backed off, no quiet fallback to the CPU or a plain version when a
kernel fails — hold by convention and point tests alone unless something
checks them. This module gives the G027-G031 rules something to *prove*
them against, stdlib-only, on top of the whole-program layer
(program.py). The rules are language-level: they read ``try``/``except``,
``raise``, ``Future``, ``while True`` and locks, so they apply to torch
code as written:

- per-function **raised-exception summaries** (``raises``): the exception
  type names a function can provably raise — explicit ``raise X`` (bare
  re-raises resolve to the enclosing handler's caught types, ``with``
  suites propagate, handlers that catch a type subtract it via the
  builtin + local class hierarchy), plus known-raising callees resolved
  through the import map with a depth-bounded walk;
- **try/except coverage**: every handler classified by what it does —
  re-raise / convert, surface the reason LOUDLY (``warnings.warn``,
  logging, a trace instant, a counter), resolve a Future
  (``set_exception``), swallow (pass/continue only), or silently fall
  back to degraded work (``classify_handler``);
- a **Future lifecycle lattice** (created → escaped → resolved): direct
  ``Future()`` locals tracked through their owner function in source
  order, so G027 can prove "this future was handed to a queue/caller and
  a later statement can unwind past its resolution".

Resolution is deliberately conservative, exactly like the SPMD and
concurrency layers: rules flag only what the model can prove (a raise
statement reached through resolvable call edges); dynamic callees and
unresolvable exception expressions are trusted.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from . import config
from .modmodel import _FN_TYPES, ModuleModel, dotted_name, walk_scope
from .program import ProgramModel

MAX_RAISE_DEPTH = 6

# Enough of the builtin exception hierarchy for catch matching: child ->
# parent. Everything here eventually reaches Exception/BaseException.
_BUILTIN_PARENT = {
    "ArithmeticError": "Exception",
    "AssertionError": "Exception",
    "AttributeError": "Exception",
    "BlockingIOError": "OSError",
    "BrokenPipeError": "ConnectionError",
    "BufferError": "Exception",
    "CancelledError": "Exception",
    "ConnectionError": "OSError",
    "ConnectionResetError": "ConnectionError",
    "EOFError": "Exception",
    "Exception": "BaseException",
    "FileExistsError": "OSError",
    "FileNotFoundError": "OSError",
    "FloatingPointError": "ArithmeticError",
    "GeneratorExit": "BaseException",
    "IOError": "OSError",
    "ImportError": "Exception",
    "IndexError": "LookupError",
    "InterruptedError": "OSError",
    "IsADirectoryError": "OSError",
    "KeyError": "LookupError",
    "KeyboardInterrupt": "BaseException",
    "LookupError": "Exception",
    "MemoryError": "Exception",
    "ModuleNotFoundError": "ImportError",
    "NotADirectoryError": "OSError",
    "NotImplementedError": "RuntimeError",
    "OSError": "Exception",
    "OverflowError": "ArithmeticError",
    "PermissionError": "OSError",
    "RecursionError": "RuntimeError",
    "RuntimeError": "Exception",
    "StopAsyncIteration": "Exception",
    "StopIteration": "Exception",
    "SystemExit": "BaseException",
    "TimeoutError": "OSError",
    "TypeError": "Exception",
    "UnicodeDecodeError": "UnicodeError",
    "UnicodeEncodeError": "UnicodeError",
    "UnicodeError": "ValueError",
    "ValueError": "Exception",
    "ZeroDivisionError": "ArithmeticError",
}

_IN_PROGRESS = frozenset({"\x00in-progress"})


def handler_names(handler: ast.ExceptHandler) -> Optional[Tuple[str, ...]]:
    """Caught type name tails of one handler; None = bare ``except:``."""
    t = handler.type
    if t is None:
        return None
    exprs = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
    out = []
    for e in exprs:
        d = dotted_name(e)
        out.append(d.rsplit(".", 1)[-1] if d else "?")
    return tuple(out)


def is_broad(names: Optional[Tuple[str, ...]]) -> bool:
    return names is None or any(n in ("Exception", "BaseException")
                                for n in names)


class HandlerInfo:
    """What one except clause does with what it catches."""

    __slots__ = ("node", "names", "bare", "broad", "exc_var", "uses_exc",
                 "reraises", "loud", "resolves_future", "swallow_only",
                 "has_work")

    def __init__(self, node: ast.ExceptHandler):
        self.node = node
        self.names = handler_names(node)
        self.bare = node.type is None
        self.broad = is_broad(self.names)
        self.exc_var = node.name
        self.uses_exc = False
        self.reraises = False          # any `raise` in the handler body
        self.loud = False              # warn/log/trace/counter surface
        self.resolves_future = False   # set_exception / set_result
        self.swallow_only = True       # body is only pass/continue/...
        self.has_work = False          # body does something real


def classify_handler(node: ast.ExceptHandler) -> HandlerInfo:
    info = HandlerInfo(node)
    for stmt in node.body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Constant):
            continue  # docstring / ellipsis placeholder
        info.swallow_only = False
        info.has_work = True
    for sub in walk_scope(node):
        if isinstance(sub, ast.Raise):
            info.reraises = True
        if isinstance(sub, ast.Name) and info.exc_var is not None \
                and sub.id == info.exc_var:
            info.uses_exc = True
        if isinstance(sub, ast.Call):
            d = dotted_name(sub.func)
            if d is None:
                continue
            tail = d.rsplit(".", 1)[-1]
            root = d.split(".", 1)[0]
            if tail in ("set_exception", "set_result"):
                info.resolves_future = True
            if tail in config.LOUD_CALL_TAILS \
                    or root in config.LOUD_CALL_ROOTS \
                    or root in ("log", "logger"):
                info.loud = True
    return info


class ExceptionModel:
    """Interprocedural exception propagation over one ProgramModel.

    Raise summaries are memoized on the owning ModuleModel objects (the
    package-tree models are shared across scans via modelcache's mtime layer),
    so repeated in-process scans — the test suite's _cli runs, the
    --fix re-scan — pay the summary walk once per module version."""

    def __init__(self, program: ProgramModel):
        self.program = program

    # -- catch matching ----------------------------------------------------

    def catches(self, path: str, guard: Optional[Tuple[str, ...]],
                exc: str) -> bool:
        """Does a handler catching ``guard`` types catch exception type
        ``exc``? Bare handlers and Exception/BaseException catch
        everything; otherwise match the name or its base chain (builtin
        hierarchy + local ``class X(Y)`` defs)."""
        if guard is None:
            return True
        chain = self._base_chain(path, exc)
        return any(g in chain for g in guard)

    def _base_chain(self, path: str, exc: str) -> FrozenSet[str]:
        out = {exc, "Exception", "BaseException"} \
            if exc not in _BUILTIN_PARENT else {exc}
        cur: Optional[str] = exc
        depth = 0
        while cur is not None and depth < 8:
            depth += 1
            parent = _BUILTIN_PARENT.get(cur)
            if parent is None:
                parent = self._local_base(path, cur)
            if parent is None or parent in out:
                break
            out.add(parent)
            cur = parent
        return frozenset(out)

    def _local_base(self, path: str, name: str) -> Optional[str]:
        """First base-class name of a ``class <name>(Base)`` def in the
        module (or its import source)."""
        model = self.program.modules.get(path)
        if model is None:
            return None
        for node in ast.walk(model.tree):
            if isinstance(node, ast.ClassDef) and node.name == name:
                for b in node.bases:
                    d = dotted_name(b)
                    if d is not None:
                        return d.rsplit(".", 1)[-1]
                return None
        imp = self.program.imports(path).get(name)
        if imp is not None and imp[0] is not None:
            return self._local_base(imp[0], imp[1])
        return None

    # -- callee resolution -------------------------------------------------

    def resolve_callee(self, path: str, call: ast.Call, dotted: str
                       ) -> Optional[Tuple[str, ast.AST]]:
        """(module, def) for a call the raise walk can follow: bare names
        (lexical + imports), ``self.helper`` methods of the enclosing
        class, and ``mod.helper`` through a plain module import."""
        parts = dotted.split(".")
        if len(parts) == 1:
            return self.program.resolve_fn(path, dotted, call)
        if len(parts) == 2 and parts[0] == "self":
            cls = getattr(call, "graftcheck_parent", None)
            while cls is not None and not isinstance(cls, ast.ClassDef):
                cls = getattr(cls, "graftcheck_parent", None)
            if cls is not None:
                for m in cls.body:
                    if isinstance(m, _FN_TYPES) and m.name == parts[1]:
                        return path, m
            return None
        if len(parts) == 2:
            imp = self.program.imports(path).get(parts[0])
            if imp is not None and imp[0] is not None:
                got = self.program.top_level_def(imp[0], parts[1])
                if got is not None:
                    return imp[0], got
        return None

    # -- raise summaries ---------------------------------------------------

    def raises(self, path: str, fn: ast.AST, depth: int = 0
               ) -> FrozenSet[str]:
        """Exception type names ``fn`` can provably raise to its caller."""
        model = self.program.modules.get(path)
        if model is None or depth > MAX_RAISE_DEPTH:
            return frozenset()
        memo: Dict[int, FrozenSet[str]] = getattr(
            model, "_graftcheck_raises", None)
        if memo is None:
            memo = {}
            model._graftcheck_raises = memo  # type: ignore[attr-defined]
        cached = memo.get(id(fn))
        if cached is not None:
            return frozenset() if cached is _IN_PROGRESS else cached
        memo[id(fn)] = _IN_PROGRESS  # cycle guard
        out: Set[str] = set()
        for exc, _node in self.escaping_raises(path, fn, depth):
            out.add(exc)
        result = frozenset(out)
        memo[id(fn)] = result
        return result

    def escaping_raises(self, path: str, fn: ast.AST, depth: int = 0
                        ) -> Iterator[Tuple[str, ast.AST]]:
        """(exception name, statement/call node) pairs for every raise
        that escapes ``fn`` — explicit raises plus resolvable raising
        callees, each filtered through the enclosing handlers."""

        def visit(stmts, guards: Tuple[Tuple[Optional[Tuple[str, ...]],
                                             ...], ...],
                  handler_ctx: Optional[Tuple[str, ...]]
                  ) -> Iterator[Tuple[str, ast.AST]]:
            for stmt in stmts:
                if isinstance(stmt, _FN_TYPES + (ast.ClassDef,)):
                    continue
                if isinstance(stmt, ast.Raise):
                    for exc in self._raise_names(path, stmt, handler_ctx):
                        if not self._guarded(path, guards, exc):
                            yield exc, stmt
                    continue
                yield from self._call_raises(path, stmt, guards, depth)
                if isinstance(stmt, ast.Try):
                    body_guards = guards + (tuple(
                        handler_names(h) for h in stmt.handlers),)
                    yield from visit(stmt.body, body_guards, handler_ctx)
                    for h in stmt.handlers:
                        ctx = handler_names(h)
                        yield from visit(h.body, guards,
                                         ctx if ctx is not None
                                         else ("Exception",))
                    # the else clause is NOT protected by this try's
                    # handlers (Python semantics), nor is the finally
                    yield from visit(stmt.orelse, guards, handler_ctx)
                    yield from visit(stmt.finalbody, guards, handler_ctx)
                elif isinstance(stmt, (ast.If, ast.While)):
                    yield from visit(stmt.body, guards, handler_ctx)
                    yield from visit(stmt.orelse, guards, handler_ctx)
                elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                    yield from visit(stmt.body, guards, handler_ctx)
                    yield from visit(stmt.orelse, guards, handler_ctx)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    # a raise inside the suite propagates out of the with
                    yield from visit(stmt.body, guards, handler_ctx)

        yield from visit(fn.body, (), None)

    def _raise_names(self, path: str, stmt: ast.Raise,
                     handler_ctx: Optional[Tuple[str, ...]]) -> List[str]:
        if stmt.exc is None:
            # bare re-raise: the enclosing handler's caught types
            return list(handler_ctx or ("Exception",))
        exc = stmt.exc
        if isinstance(exc, ast.Call):
            exc = exc.func
        d = dotted_name(exc)
        if d is None:
            return []
        name = d.rsplit(".", 1)[-1]
        # `raise self.RECOVERABLE`-style dynamic tuples stay trusted
        return [name] if name[:1].isupper() else []

    def _guarded(self, path: str, guards, exc: str) -> bool:
        return any(self.catches(path, g, exc)
                   for layer in guards for g in layer)

    def _call_raises(self, path: str, stmt: ast.stmt, guards, depth: int
                     ) -> Iterator[Tuple[str, ast.AST]]:
        """Escaping raises contributed by resolvable calls in the
        statement's own expressions (compound bodies are visited by the
        caller with their own guard stacks)."""
        for call, dotted in self._stmt_calls(stmt):
            got = self.resolve_callee(path, call, dotted)
            if got is None:
                continue
            t_path, t_fn = got
            for exc in self.raises(t_path, t_fn, depth + 1):
                if not self._guarded(path, guards, exc):
                    yield exc, call

    def _stmt_calls(self, stmt: ast.stmt
                    ) -> Iterator[Tuple[ast.Call, str]]:
        """Calls in the statement's header/leaf expressions, not in
        nested statement bodies or nested defs."""
        exprs: List[Optional[ast.expr]] = []
        if isinstance(stmt, ast.Try):
            return
        if isinstance(stmt, (ast.If, ast.While)):
            exprs = [stmt.test]
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            exprs = [stmt.iter]
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            exprs = [item.context_expr for item in stmt.items]
        elif isinstance(stmt, ast.Return):
            exprs = [stmt.value]
        elif isinstance(stmt, ast.Expr):
            exprs = [stmt.value]
        elif isinstance(stmt, ast.Assign):
            exprs = [stmt.value]
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            exprs = [stmt.value]
        elif isinstance(stmt, ast.Assert):
            exprs = [stmt.test, stmt.msg]
        for root in exprs:
            if root is None:
                continue
            stack: List[ast.AST] = [root]
            while stack:
                node = stack.pop()
                if isinstance(node, _FN_TYPES + (ast.Lambda,)):
                    continue
                if isinstance(node, ast.Call):
                    d = dotted_name(node.func)
                    if d is not None:
                        yield node, d
                stack.extend(ast.iter_child_nodes(node))

    # -- Future lifecycle --------------------------------------------------

    def future_locals(self, fn: ast.AST) -> Dict[str, ast.stmt]:
        """{name: creating assignment} for direct ``x = Future()`` /
        ``x: Future = Future()`` locals of ``fn`` (its own scope only)."""
        out: Dict[str, ast.stmt] = {}
        for node in walk_scope(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                tgt, value = node.target, node.value
            else:
                continue
            if isinstance(tgt, ast.Name) and isinstance(value, ast.Call):
                d = dotted_name(value.func) or ""
                if d.rsplit(".", 1)[-1] == "Future":
                    out[tgt.id] = node
        return out


def get_model(program: ProgramModel) -> ExceptionModel:
    """One ExceptionModel per ProgramModel (all five G027-G031 rules
    share it; summaries additionally persist on the module models)."""
    model = getattr(program, "_graftcheck_exceptions", None)
    if model is None:
        model = ExceptionModel(program)
        program._graftcheck_exceptions = model  # type: ignore[attr-defined]
    return model


def in_exception_scope(path: str, model: Optional[ModuleModel]) -> bool:
    """G027-G031 run on the failure-path scope (serving / pipeline /
    runtime) plus modules opting in with the failure-path marker (the
    port's kernels, device choice and native host library)."""
    if path.startswith(config.EXCEPTION_HOT_PREFIXES):
        return True
    return model is not None and config.EXCEPTION_MARKER in model.source
