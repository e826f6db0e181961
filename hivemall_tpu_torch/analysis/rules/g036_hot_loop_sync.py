"""G036 blocking-host-sync-in-hot-loop: the sync your callee performs.

G002 flags ``float(x)`` / ``.item()`` syncs written *directly* inside a
hot loop. The interprocedural gap: the loop body calls a helper, and the
helper blocks — a ``.cpu()``, ``.item()`` or ``.synchronize()`` three
frames down still stalls the launch stream once per iteration, with
nothing at the call site to see.

Scope: the step/dispatch loops — ``config.HOT_LOOP_MODULES`` (G002's
scope) plus the capture-hot serving/kernels scope
(``traceflow.in_traceflow_scope``). For every call inside a loop whose
callee resolves through the program layer, a depth-bounded summary walk
(``traceflow.sync_site``) finds the first provable device sync the callee
performs (``config.TRACEFLOW_SYNC_CALL_TAILS``); the finding lands on the
caller's line with the sync's location related. Taint-free by design —
only calls that block *by name* count, so a ``.cpu()`` of a host tensor
or an ``.item()`` of a numpy scalar counts too (the cost written down at
``config.BLOCKING_DEVICE_TAILS``) — and callees that *declare* themselves
sync boundaries (``config.TRACEFLOW_SYNC_NAME_RE``: fetch/sync/to_host/
...) are the sanctioned whole-value boundary read and never flagged.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from .. import config
from ..findings import Finding, Severity
from ..modmodel import dotted_name, enclosing_loop, walk_scope
from ..program import ProgramModel
from ..traceflow import get_model, in_traceflow_scope, local_rebinds

RULE_ID = "G036"


def _in_scope(path: str, model) -> bool:
    if path in config.HOT_LOOP_MODULES \
            or "# graftcheck: hot-module" in model.source:
        return True
    return in_traceflow_scope(path, model)


def check_program(program: ProgramModel, scanned: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    tf = get_model(program)
    seen: Set[Tuple[str, int]] = set()

    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None or not _in_scope(path, model):
            continue
        for fn in model.functions:
            if model.is_traced(fn):
                continue
            rebound = None  # computed on first candidate: most fns loop-free
            for call in walk_scope(fn):
                if not isinstance(call, ast.Call) \
                        or enclosing_loop(call) is None:
                    continue
                callee = dotted_name(call.func)
                if callee is None or "." in callee:
                    continue
                if rebound is None:
                    rebound = local_rebinds(fn)
                if callee in rebound:
                    continue  # a local binding shadows any same-named def
                tail = callee.rsplit(".", 1)[-1]
                if config.TRACEFLOW_SYNC_NAME_RE.search(tail):
                    continue  # a self-declared sync boundary: the idiom
                got = program.resolve_fn(path, callee, call)
                if got is None:
                    continue
                t_path, t_fn = got
                if t_fn is fn:
                    continue
                if config.TRACEFLOW_SYNC_NAME_RE.search(t_fn.name):
                    continue
                sync = tf.sync_site(t_path, t_fn)
                if sync is None:
                    continue
                if (path, call.lineno) in seen:
                    continue
                seen.add((path, call.lineno))
                s_path, s_line, s_tail = sync
                s_model = program.modules.get(s_path)
                snippet = s_model.snippet(s_line) if s_model else ""
                findings.append(Finding(
                    path, call.lineno, RULE_ID, Severity.ERROR,
                    f"`{callee}()` blocks on the device ({s_tail} at "
                    f"{s_path}:{s_line}) and is called once per hot-loop "
                    f"iteration — the launch stream stalls behind it "
                    f"every pass; batch the read to the loop boundary or "
                    f"rename the helper to declare the sync "
                    f"(*_fetch/*_sync)", model.snippet(call.lineno),
                    related=((s_path, s_line, snippet),)))
    return findings
