"""Capture / retrace model: the layer behind G032-G036 (and G001's sites).

**The design.** The JAX package's zero-recompile contract rests on jit
wrappers, whose compile cache lives on the wrapper. The port's
counterpart of a jitted function is a **capture**: code whose host Python
runs once and whose device work is replayed —

- the body of ``with torch.cuda.graph(g):`` on a ``torch.cuda.CUDAGraph()``
  (``modmodel.capture_regions``; defs it calls by name are traced);
- the callable handed to ``torch.cuda.make_graphed_callables``;
- a ``torch.compile``, ``torch.jit.script`` or ``torch.jit.trace``
  wrapper, as a decorator or as a call.

A capture's cache is the captured graph for one shape. Its dynamic witness
is ``runtime/metrics.alloc_segment_guard``, not a compile counter: every
capture takes a fresh private memory pool (new allocator segments), and so
does every novel length that reaches eager code after warmup. The torch
forms of the reference's hazards:

- G001 (a) ``if``/``while`` on a tensor inside a capture: ``bool()`` of a
  device tensor syncs — a CUDA-graph capture refuses it, torch.compile
  breaks its graph there; (b) a capture built inside a loop
  (``config.CAPTURE_CONSTRUCTORS``): a private pool, new segments, every
  iteration; (c) shape-keyed strings, unchanged.
- G002 the reference's syncs plus ``.cpu()`` / ``.numpy()`` /
  ``.synchronize()`` in the hot-loop modules' loops; a whole-value
  ``.cpu()`` / ``.tolist()`` is the approved boundary read
  (``jax.device_get``'s part), flagged only per element (``x[i].cpu()``).
- G005 (b) / G035: a graphed callable's outputs are **static buffers**
  (make_graphed_callables returns ``o.detach()`` of them; torch.compile's
  CUDA-graph modes do the same): the next call overwrites them, as the
  next call of a donating jit owns the donated buffer. G005(b) flags a
  read of an output after a later call of the same callable; G035 flags
  a loop that keeps outputs across replays (appended, stored) and runs
  G005's scan over graphed callables resolved through ``self._x =
  self._build_x()`` factories and memo thunks (``ModuleTraceInfo.
  graphed``). ``.clone()`` of the output is the fix.
- G006 the reference's host effects inside a capture, plus torch's host
  RNG (``torch.manual_seed``, a CPU ``torch.Generator``): under a CUDA
  graph or torch.jit.trace they run once, at capture; under torch.compile
  they split the graph (dynamo runs them eagerly between two pieces).
  ``torch.jit.script`` compiles its body instead: its ``print`` runs per
  call, so a G006 finding there is a false positive to suppress.
- G032 the reference's three churn patterns reaching a capture
  constructor, with its sanctioned contexts (module level, decorators,
  ``__init__``, ``make_*``/``build_*``, memo dicts named like
  ``config.TRACEFLOW_MEMO_NAME_RE``, which takes ``GRAPH`` memos). A
  per-call CUDA-graph capture has no cache at all; torch.compile keys its
  cache on the code object and guards on closure cells and ``partial``
  arguments, so a per-call closure over per-call values recompiles until
  ``cache_size_limit`` and then runs eagerly. The eta-expansion fix is
  kept.
- G033 (a) the same call-edge walk from a capture: ``.item()`` /
  ``bool()`` on a captured value raises during a graph capture.
- G034 a data-dependent slice reaching a capture or a bucketed dispatch
  entry point (``config.BUCKETED_DISPATCH_TAILS``, the servables'
  ``run_padded``); the canonicalizers and the machine fix (into the
  port's ``core.batch.bucket_rows``) are the reference's.
- G036 the reference's depth-bounded callee walk (``SYNC_WALK_DEPTH``)
  over the port's blocking tails, ``config.TRACEFLOW_SYNC_CALL_TAILS`` =
  ``config.BLOCKING_DEVICE_TAILS`` (type-blind: its cost is written down
  there).

**Departures** (reference findings on its fixtures that the port does not
report on the torch twins; tests/test_torch_analysis.py TORCH_DEPARTURES):

- G001(d), ``g001_pos`` line 36: torch has no per-value static arguments
  (no ``static_argnums``; a non-tensor argument is guarded by value).
- G005(a), ``g005_pos`` line 9: no provable torch form — the port's
  steps update their tables in place, so an undonated step-shaped capture
  keeps no second copy of them.
- G033(b), ``g033_pos`` line 35: no static positions to receive a
  device value (G001(d)'s reason).

Resolution is conservative, as in every layer before it: the rules flag
only what the model proves; anything dynamic is trusted.

Per-module facts are memoized as ``model._graftcheck_traceflow`` (the
``_graftcheck_*`` prefix is stripped by modelcache before pickling); the
program-level handle follows the exceptionflow/concurrency pattern via
``get_model``/``program._graftcheck_traceflow``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from . import config
from .modmodel import (_FN_TYPES, JitWrap, ModuleModel, dotted_name,
                       enclosing_loop, is_capture_constructor, walk_scope)
from .program import ProgramModel

SYNC_WALK_DEPTH = 3


# --------------------------------------------------------------------------
# capture call-site classification
# --------------------------------------------------------------------------

class JitSite:
    """One capture constructor call (``torch.compile(...)``,
    ``make_graphed_callables(...)``, ``CUDAGraph()``, ``torch.cuda.graph
    (...)``): what identity class the captured expression has, and whether
    the construction context is sanctioned."""

    __slots__ = ("call", "arg_kind", "in_loop", "sanctioned", "eta_target")

    def __init__(self, call: ast.Call):
        self.call = call
        self.in_loop = enclosing_loop(call) is not None
        self.sanctioned = False
        self.arg_kind = "none"          # none|lambda|closure|partial|named
        self.eta_target: Optional[ast.expr] = None


def _eta_target(lam: ast.Lambda) -> Optional[ast.expr]:
    """``lambda x, y: f(x, y)`` -> the ``f`` expression; None when the
    lambda is not a pure eta-expansion (defaults, kwargs, reordered or
    transformed arguments all disqualify)."""
    a = lam.args
    if a.defaults or a.kw_defaults or a.kwonlyargs or a.vararg or a.kwarg:
        return None
    params = [p.arg for p in a.posonlyargs + a.args]
    body = lam.body
    if not isinstance(body, ast.Call) or body.keywords:
        return None
    if not isinstance(body.func, (ast.Name, ast.Attribute)):
        return None
    if isinstance(body.func, ast.Name) and body.func.id in params:
        return None
    if len(body.args) != len(params):
        return None
    for arg, param in zip(body.args, params):
        if not (isinstance(arg, ast.Name) and arg.id == param):
            return None
    return body.func


class ModuleTraceInfo:
    """Per-module capture facts, memoized on the ModuleModel."""

    __slots__ = ("memo_dicts", "memo_helper_fns", "memo_helper_names",
                 "sites", "graphed")

    def __init__(self, model: ModuleModel):
        self.memo_dicts = _memo_dicts(model)
        self.memo_helper_fns: Set[ast.AST] = set()
        self.memo_helper_names: Set[str] = set()
        for fn in model.functions:
            if _touches_memo(fn, self.memo_dicts) or _is_cached(fn):
                self.memo_helper_fns.add(fn)
                self.memo_helper_names.add(fn.name)
        # one tree walk feeds both site classification and graphed-alias
        # resolution — this constructor runs for every module in the
        # program context, so the walk count is the scan's hot dimension
        capture_calls: List[ast.Call] = []
        call_assigns: List[ast.Assign] = []
        for node in ast.walk(model.tree):
            if isinstance(node, ast.Call):
                if is_capture_constructor(node):
                    capture_calls.append(node)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.value, ast.Call):
                call_assigns.append(node)
        self.sites = _collect_sites(model, capture_calls,
                                    self.memo_helper_fns,
                                    self.memo_helper_names)
        self.graphed = _graphed_map(model, call_assigns,
                                    self.memo_helper_names)


def _memo_dicts(model: ModuleModel) -> Set[str]:
    out: Set[str] = set()
    for node in model.tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) \
                        and config.TRACEFLOW_MEMO_NAME_RE.match(tgt.id):
                    out.add(tgt.id)
    return out


def _touches_memo(fn: ast.AST, memo_names: Set[str]) -> bool:
    """A memo helper both reads (get/subscript-load/truth-test/``in``) and
    writes (subscript-store/setdefault/update) a module-level capture
    memo — the get-or-build contract that bounds captures to one per
    key."""
    if not memo_names:
        return False
    reads: Set[str] = set()
    writes: Set[str] = set()
    for node in walk_scope(fn):
        if isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in memo_names:
            bucket = writes if isinstance(node.ctx, ast.Store) else reads
            bucket.add(node.value.id)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in memo_names:
            if node.func.attr in ("setdefault", "update"):
                writes.add(node.func.value.id)
            elif node.func.attr in ("get", "pop"):
                reads.add(node.func.value.id)
        elif isinstance(node, (ast.If, ast.While)):
            for sub in ast.walk(node.test):
                if isinstance(sub, ast.Name) and sub.id in memo_names:
                    reads.add(sub.id)
        elif isinstance(node, ast.Compare):
            for op, comp in zip(node.ops, node.comparators):
                if isinstance(op, (ast.In, ast.NotIn)) \
                        and isinstance(comp, ast.Name) \
                        and comp.id in memo_names:
                    reads.add(comp.id)
    return bool(reads & writes)


def _is_cached(fn: ast.AST) -> bool:
    """``functools.lru_cache`` / ``functools.cache`` decorated functions
    are memo helpers by construction — one return value per distinct key,
    forever — so a capture built inside one is built once per key."""
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(target)
        if name is not None \
                and name.rsplit(".", 1)[-1] in ("lru_cache", "cache"):
            return True
    return False


def local_rebinds(fn: ast.AST) -> Set[str]:
    """Names (re)bound by assignment or loop target inside ``fn``. A local
    binding shadows any same-named def, so a bare call to one of these
    must not be resolved lexically (``scorer = _memo(...)`` inside a
    function beside a module-level ``scorer`` def is the case)."""
    out: Set[str] = set()
    for node in walk_scope(fn):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For)):
            targets = [node.target]
        elif isinstance(node, ast.withitem) and node.optional_vars:
            targets = [node.optional_vars]
        else:
            continue
        for tgt in targets:
            for sub in ast.walk(tgt):
                if isinstance(sub, ast.Name):
                    out.add(sub.id)
    return out


def _is_decorator_of(call: ast.Call, fn: Optional[ast.AST]) -> bool:
    if fn is None:
        return False
    for dec in getattr(fn, "decorator_list", ()):
        for node in ast.walk(dec):
            if node is call:
                return True
    return False


def _context_sanctioned(model: ModuleModel, call: ast.Call,
                        memo_helper_fns: Set[ast.AST],
                        memo_helper_names: Set[str]) -> bool:
    """Construction-once contexts: module level, decorators, __init__,
    make_*/build_* factories, memo helpers (at any enclosing depth), and
    build thunks passed as arguments to a memo-helper call."""
    fn = model.enclosing_function(call)
    if fn is None or _is_decorator_of(call, fn):
        return True
    cur = fn
    while cur is not None:
        if cur.name == "__init__" \
                or config.TRACEFLOW_FACTORY_RE.match(cur.name) \
                or cur in memo_helper_fns:
            return True
        cur = model.enclosing_function(cur)
    # lexically inside an argument of a memo-helper call (the
    # `_scorer_jit(key, lambda: torch.compile(...))` thunk shape)
    node: ast.AST = call
    while node is not None and not isinstance(node, _FN_TYPES):
        parent = getattr(node, "graftcheck_parent", None)
        if isinstance(parent, ast.Call) and parent is not call:
            callee = dotted_name(parent.func)
            if callee is not None \
                    and callee.rsplit(".", 1)[-1] in memo_helper_names:
                return True
        node = parent
    return False


def _collect_sites(model: ModuleModel, capture_calls: List[ast.Call],
                   memo_helper_fns: Set[ast.AST],
                   memo_helper_names: Set[str]) -> List[JitSite]:
    sites: List[JitSite] = []
    for node in capture_calls:
        site = JitSite(node)
        site.sanctioned = _context_sanctioned(model, node, memo_helper_fns,
                                              memo_helper_names)
        fn_arg = node.args[0] if node.args else None
        if fn_arg is None:
            site.arg_kind = "none"
        elif isinstance(fn_arg, ast.Lambda):
            site.arg_kind = "lambda"
            site.eta_target = _eta_target(fn_arg)
        elif isinstance(fn_arg, ast.Call):
            callee = dotted_name(fn_arg.func)
            site.arg_kind = "partial" \
                if callee in ("partial", "functools.partial") else "named"
        elif isinstance(fn_arg, ast.Name):
            target = model.resolve_def(fn_arg.id, node)
            if target is not None \
                    and model.enclosing_function(target) is not None:
                # a nested def is a fresh closure object per enclosing call
                site.arg_kind = "closure"
            else:
                site.arg_kind = "named"
        else:
            site.arg_kind = "named"
        sites.append(site)
    return sites


# --------------------------------------------------------------------------
# interprocedural graphed-callable resolution
# --------------------------------------------------------------------------

def _thunk_factory_name(value: ast.Call,
                        memo_helper_names: Set[str]) -> Optional[str]:
    """``_scorer_graph(key, lambda: self._build_x(...))`` -> "_build_x"
    when the callee is a memo helper and an argument is a build thunk."""
    callee = dotted_name(value.func)
    if callee is None or callee.rsplit(".", 1)[-1] not in memo_helper_names:
        return None
    for arg in list(value.args) + [kw.value for kw in value.keywords]:
        if isinstance(arg, ast.Lambda) and isinstance(arg.body, ast.Call):
            inner = dotted_name(arg.body.func)
            if inner is not None:
                return inner.rsplit(".", 1)[-1]
        elif isinstance(arg, ast.Name):
            return arg.id
    return None


def _graphed_map(model: ModuleModel, call_assigns: List[ast.Assign],
                 memo_helper_names: Set[str]) -> Dict[str, JitWrap]:
    """Graphed callables G005's module-local alias map cannot see:
    ``self.X = <factory>()`` / ``self.X = <memo helper>(key, thunk)``
    where the factory's returned capture (recorded in jit_aliases under
    the factory's name) hands out static output buffers."""
    out: Dict[str, JitWrap] = {}
    for node in call_assigns:
        tgt = node.targets[0]
        tgt_name = dotted_name(tgt)
        if tgt_name is None or tgt_name in model.jit_aliases:
            continue
        value = node.value
        callee = dotted_name(value.func)
        factory = None
        if callee is not None:
            tail = callee.rsplit(".", 1)[-1]
            if tail in memo_helper_names:
                factory = _thunk_factory_name(value, memo_helper_names)
            elif tail in model.jit_aliases:
                factory = tail
        if factory is None:
            continue
        wrap = model.jit_aliases.get(factory)
        if wrap is not None and wrap.graphed:
            out[tgt_name] = wrap
    return out


# --------------------------------------------------------------------------
# memoized accessors
# --------------------------------------------------------------------------

def module_info(model: ModuleModel) -> ModuleTraceInfo:
    info = getattr(model, "_graftcheck_traceflow", None)
    if info is None:
        info = ModuleTraceInfo(model)
        model._graftcheck_traceflow = info  # type: ignore[attr-defined]
    return info


class TraceflowModel:
    """Program-level handle shared by the retrace program rules."""

    def __init__(self, program: ProgramModel):
        self.program = program

    def info(self, path: str) -> Optional[ModuleTraceInfo]:
        model = self.program.modules.get(path)
        return module_info(model) if model is not None else None

    # -- G032c: does a resolvable callee build captures? ------------------

    def jit_site_in(self, path: str, fn: ast.AST) -> Optional[JitSite]:
        """First capture site lexically within ``fn`` (nested defs
        included) — the evidence that calling ``fn`` per iteration builds a
        fresh capture (and private pool) each time."""
        model = self.program.modules.get(path)
        info = self.info(path)
        if model is None or info is None:
            return None
        for site in info.sites:
            cur = model.enclosing_function(site.call)
            while cur is not None:
                if cur is fn:
                    return site
                cur = model.enclosing_function(cur)
        return None

    # -- G036: depth-bounded callee sync summaries ------------------------

    def sync_site(self, path: str, fn: ast.AST, depth: int = 0
                  ) -> Optional[Tuple[str, int, str]]:
        """(module, line, call tail) of the first provable device sync a
        call to ``fn`` performs — a ``config.TRACEFLOW_SYNC_CALL_TAILS``
        call (``.synchronize()`` / ``.item()`` / ``.cpu()``) in its own
        scope or in a resolvable bare callee, depth-bounded. Taint-free by
        design: only calls that block *by name* count."""
        model = self.program.modules.get(path)
        if model is None or depth > SYNC_WALK_DEPTH:
            return None
        memo: Dict[int, object] = getattr(model, "_graftcheck_syncs", None)
        if memo is None:
            memo = {}
            model._graftcheck_syncs = memo  # type: ignore[attr-defined]
        key = id(fn)
        if key in memo:
            cached = memo[key]
            return cached if cached != () else None  # type: ignore[return-value]
        memo[key] = ()  # cycle guard: in-progress reads as "no sync"
        result: Optional[Tuple[str, int, str]] = None
        for node in walk_scope(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if callee is None:
                # `x.float().cpu()`: a method of a computed value
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in config.TRACEFLOW_SYNC_CALL_TAILS:
                    result = (path, node.lineno, node.func.attr)
                    break
                continue
            tail = callee.rsplit(".", 1)[-1]
            if tail in config.TRACEFLOW_SYNC_CALL_TAILS:
                result = (path, node.lineno, tail)
                break
            if "." not in callee:
                got = self.program.resolve_fn(path, callee, node)
                if got is not None:
                    deeper = self.sync_site(got[0], got[1], depth + 1)
                    if deeper is not None:
                        result = deeper
                        break
        memo[key] = result if result is not None else ()
        return result


def get_model(program: ProgramModel) -> TraceflowModel:
    model = getattr(program, "_graftcheck_traceflow", None)
    if model is None:
        model = TraceflowModel(program)
        program._graftcheck_traceflow = model  # type: ignore[attr-defined]
    return model


def in_traceflow_scope(path: str, model: Optional[ModuleModel]) -> bool:
    """G034/G036 sweep the capture-hot scope: the kernel/op layers, the
    serving dispatch modules, and anything opting in with the marker."""
    if path.startswith(config.TRACEFLOW_HOT_PREFIXES) \
            or path in config.TRACEFLOW_HOT_MODULES:
        return True
    return model is not None and config.TRACEFLOW_MARKER in model.source
