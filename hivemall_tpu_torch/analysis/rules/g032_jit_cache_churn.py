"""G032 capture-churn: fresh captures built per call.

A capture's cache is the captured graph: a CUDA-graph capture
(``make_graphed_callables``, ``CUDAGraph`` + ``torch.cuda.graph``) has no
cache beyond its own object and takes a fresh private memory pool each
time it is built; torch.compile keys its cache on the code object and
guards on closure cells and ``partial`` arguments. A module-level def
captured once replays forever; a fresh lambda, closure (nested def), or
``functools.partial`` object reaching a capture constructor on every call
captures anew each call — new segments, a warm-up and a capture, or
guard failures until torch.compile's ``cache_size_limit`` and then eager
runs (the counter blind spot ``alloc_segment_guard`` closes: chip_smoke's
phase retrace runs the planted case and counts its segments).

Three patterns, all skipping the sanctioned construction-once contexts
(module level, decorators, ``__init__``, ``make_*``/``build_*`` factories,
``_SCORER_JIT`` / ``_STEP_GRAPHS``-style memo helpers and their build
thunks — traceflow.py):

(a) ``torch.compile(lambda x: f(x))`` — a pure eta-expansion; the lambda
    adds a fresh identity around a stable function for nothing. Machine
    fix: ``torch.compile(f)``.
(b) a lambda / closure / ``partial`` reaching a capture constructor in a
    per-call context — every call of the enclosing function captures
    anew.
(c) a loop calling a function that builds a capture without a
    recognized memo — one fresh capture (and private pool) per iteration,
    attributed to the caller's line. Captures built lexically inside a
    loop are G001's subject (pattern b there) and are not re-flagged here.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from ..findings import Edit, Finding, Fix, Severity
from ..modmodel import dotted_name, enclosing_loop, walk_scope
from ..program import ProgramModel
from ..traceflow import get_model, local_rebinds, module_info

RULE_ID = "G032"

_KIND_NOUN = {"lambda": "a fresh lambda", "closure": "a fresh closure "
              "(nested def)", "partial": "a fresh functools.partial object"}


def _eta_fix(model, site) -> Fix | None:
    """``torch.compile(lambda x: f(x))`` -> ``torch.compile(f)`` when the
    lambda and its target render on one line (within-line Edit
    vocabulary)."""
    lam = site.call.args[0]
    if lam.lineno != getattr(lam, "end_lineno", lam.lineno):
        return None
    old = ast.get_source_segment(model.source, lam)
    new = ast.get_source_segment(model.source, site.eta_target)
    if not old or not new or old not in model.lines[lam.lineno - 1]:
        return None
    return Fix(edits=(Edit(lam.lineno, old, new),))


def check_program(program: ProgramModel, scanned: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    tf = get_model(program)
    seen: Set[Tuple[str, int]] = set()

    def emit(path: str, line: int, msg: str, fix=None, related=()) -> None:
        if (path, line) in seen:
            return
        seen.add((path, line))
        model = program.modules[path]
        findings.append(Finding(path, line, RULE_ID, Severity.ERROR, msg,
                                model.snippet(line), fix=fix,
                                related=tuple(related)))

    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None:
            continue
        info = module_info(model)

        # (a) + (b): fresh-identity objects reaching a capture per call
        for site in info.sites:
            if site.sanctioned or site.in_loop:  # loops are G001b's subject
                continue
            if site.arg_kind not in _KIND_NOUN:
                continue
            fn = model.enclosing_function(site.call)
            where = f"`{fn.name}`" if fn is not None else "module scope"
            ctor = dotted_name(site.call.func)
            if site.eta_target is not None:
                target = dotted_name(site.eta_target) or "the wrapped fn"
                emit(path, site.call.lineno,
                     f"{ctor} over an eta-expanded lambda in {where} — the "
                     f"lambda is a fresh identity around `{target}` on "
                     f"every call; capture the function directly",
                     fix=_eta_fix(model, site))
            else:
                emit(path, site.call.lineno,
                     f"{ctor} over {_KIND_NOUN[site.arg_kind]} in {where} — "
                     f"a per-call capture never replays its own graph (a "
                     f"fresh private pool, new allocator segments); hoist "
                     f"it to module scope, a make_*/build_* factory called "
                     f"once, or a capture memo dict")

        # (c): loop-driven calls into unmemoized jit constructors
        for fn in model.functions:
            if model.is_traced(fn):
                continue
            rebound = None  # computed on first candidate: most fns loop-free
            for node in walk_scope(fn):
                if not isinstance(node, ast.Call) \
                        or enclosing_loop(node) is None:
                    continue
                callee = dotted_name(node.func)
                if callee is None or "." in callee:
                    continue
                if rebound is None:
                    rebound = local_rebinds(fn)
                if callee in rebound:
                    continue  # a local binding shadows any same-named def
                got = program.resolve_fn(path, callee, node)
                if got is None:
                    continue
                t_path, t_fn = got
                if t_fn is fn:
                    continue
                t_info = tf.info(t_path)
                if t_info is None or t_fn in t_info.memo_helper_fns:
                    continue
                site = tf.jit_site_in(t_path, t_fn)
                if site is None:
                    continue
                t_model = program.modules[t_path]
                emit(path, node.lineno,
                     f"`{callee}()` builds a capture (at "
                     f"{t_path}:{site.call.lineno}) and is called here once "
                     f"per loop iteration — one fresh capture and private "
                     f"pool per iteration; hoist the call out of the loop "
                     f"or memoize the capture in a memo dict",
                     related=((t_path, site.call.lineno,
                               t_model.snippet(site.call.lineno)),))
    return findings
