"""G002 host-sync-in-hot-loop: implicit device->host reads on the hot path.

Scope: the per-step modules in ``config.HOT_LOOP_MODULES`` (core/engine.py,
parallel/sharded_train.py, parallel/mix.py, models/trees/grow.py, plus the
epoch loop of models/base.py) and any module carrying the
``# graftcheck: hot-module`` marker. Inside those modules the rule flags,
on device values:

- ``float(x)`` / ``int(x)`` / ``bool(x)`` / ``np.asarray(x)`` /
  ``np.array(x)`` / ``x.item()`` / ``x.numpy()`` inside any host-side
  ``for``/``while`` loop — each one waits for the card to catch up,
  stalling the launch stream once per step;
- the same calls anywhere in a method named ``step``/``_step``/``epoch``
  (those receive device state by contract, loop or not);
- a ``.synchronize()`` call (``torch.cuda.synchronize()``, a stream's or
  an event's) inside such a loop;
- ``x[i].cpu()`` / ``x[i].tolist()`` / ``state.field.cpu()`` in a loop —
  per-element copies. One whole-value ``.cpu()`` / ``.tolist()`` per loop
  body is the *approved* batched boundary read (move convergence/metrics
  reads to epoch or level boundaries and fetch everything in one copy).

Device values are identified by the module model's taint walker (torch
results, tensor methods of device values, captured and step-factory
results), so already-fetched host state (``.cpu()`` results, numpy arrays,
``device="cpu"`` tensors) never false-positives.
"""

from __future__ import annotations

import ast
from typing import List

from .. import config
from ..findings import Finding, Severity
from ..modmodel import (ModuleModel, dotted_name, enclosing_loop, walk_scope)

RULE_ID = "G002"


def _is_hot_module(model: ModuleModel) -> bool:
    """Hot-path modules from config, plus any module that opts in with a
    `# graftcheck: hot-module` marker (used by fixtures and future hot
    paths outside the canonical five)."""
    return (model.rel_path in config.HOT_LOOP_MODULES
            or "# graftcheck: hot-module" in model.source)


def _sync_call_kind(call: ast.Call):
    """(kind, arg) when `call` is a sync-inducing read of `arg`, else
    None. ``.cpu()`` / ``.tolist()`` count here (G033: any host copy
    inside a capture raises); G002 lets a whole-value one pass."""
    callee = dotted_name(call.func)
    if callee in config.SYNC_CALLS and len(call.args) >= 1:
        return callee, call.args[0]
    if callee is not None and "." in callee:
        root, tail = callee.split(".", 1)
        if root in ("np", "numpy") and tail in config.SYNC_NP_CALLS \
                and len(call.args) >= 1:
            return callee, call.args[0]
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in config.SYNC_METHODS and not call.args:
        return f".{call.func.attr}()", call.func.value
    return None


def _is_wait(call: ast.Call) -> bool:
    return isinstance(call.func, ast.Attribute) \
        and call.func.attr in config.SYNC_WAIT_TAILS


def check(model: ModuleModel) -> List[Finding]:
    if not _is_hot_module(model):
        return []
    findings: List[Finding] = []

    def emit(node: ast.AST, msg: str) -> None:
        findings.append(Finding(model.rel_path, node.lineno, RULE_ID,
                                Severity.ERROR, msg,
                                model.snippet(node.lineno)))

    for fn in model.functions:
        if model.is_traced(fn):
            continue  # captured code runs once; G006 covers its effects
        hot_fn = bool(config.HOT_FN_RE.match(fn.name))
        tainted, callables = model.taint_function(fn, taint_params=hot_fn)
        for node in walk_scope(fn):
            if not isinstance(node, ast.Call):
                continue
            in_loop = enclosing_loop(node) is not None
            if not in_loop and not hot_fn:
                continue
            where = "hot loop" if in_loop else f"`{fn.name}()`"
            if in_loop and _is_wait(node):
                emit(node, f"`{dotted_name(node.func) or '.synchronize'}()`"
                           f" inside a {where} — waits for the card every "
                           f"pass; synchronize once at the loop boundary")
                continue
            sync = _sync_call_kind(node)
            if sync is None:
                continue
            kind, arg = sync
            if not model.expr_tainted(arg, tainted, callables):
                continue
            if kind.strip(".()") in config.BOUNDARY_READ_METHODS:
                if in_loop and isinstance(arg, (ast.Subscript,
                                                ast.Attribute)):
                    emit(node, f"per-element `{kind}` in a hot loop — copy "
                               f"the whole batch/tuple in ONE `.cpu()` at "
                               f"the loop boundary")
                continue
            emit(node, f"`{kind}` on a device value inside {where} — "
                       f"stalls the launch stream per step; batch the read "
                       f"to an epoch boundary with one whole-value "
                       f"`.cpu()`")
    return findings
