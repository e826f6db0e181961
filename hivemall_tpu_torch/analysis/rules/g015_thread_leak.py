"""G015 thread-leak: a non-daemon thread with no join on any shutdown path.

A ``threading.Thread`` that is neither ``daemon=True`` nor ``join()``ed
anywhere outlives its owner: process exit hangs waiting for it, test
runs accumulate workers, and a serving hot-swap that forgets to join
the old worker leaks one thread per deploy. The repo convention
(metrics/serving servers, the batcher worker) is daemon threads plus an
explicit ``join`` on the close path.

Resolution is conservative: a thread object that escapes the analyzed
scope (returned, yielded, passed as an argument, stored into an
untracked structure) is trusted, as is a dynamic ``daemon=<expr>``.
Joins are recognized directly (``t.join()``, ``self._t.join()``) and
through the collect-then-join idiom (``threads.append(t)`` /
comprehension into ``threads``, then ``for t in threads: t.join()``).

Single-line constructor calls carry a machine fix appending
``daemon=True``.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..findings import Edit, Finding, Fix, Severity
from ..modmodel import _FN_TYPES, ModuleModel, dotted_name, walk_scope

RULE_ID = "G015"


def _daemon_state(call: ast.Call) -> Optional[bool]:
    """True = daemon, False = explicitly/implicitly non-daemon,
    None = dynamic (trusted)."""
    for kw in call.keywords:
        if kw.arg == "daemon":
            if isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
            return None
    return False


def _scope_of(model: ModuleModel, node: ast.AST) -> ast.AST:
    return model.enclosing_function(node) or model.tree


def _joins_name(scope: ast.AST, name: str) -> bool:
    for node in walk_scope(scope):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "join" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == name:
            return True
    return False


def _escapes(scope: ast.AST, name: str, assign: ast.Assign) -> bool:
    """The thread object leaves this scope: returned, yielded, passed as an
    argument, or stored somewhere we don't track."""
    for node in walk_scope(scope):
        if isinstance(node, ast.Name) and node.id == name \
                and isinstance(node.ctx, ast.Load):
            parent = getattr(node, "graftcheck_parent", None)
            if isinstance(parent, ast.Attribute):
                continue  # t.start() / t.join() — method use
            if isinstance(parent, ast.Call) and node in parent.args:
                fn = dotted_name(parent.func) or ""
                if fn.endswith(".append"):
                    continue  # collect-then-join, checked by the caller
                return True
            if isinstance(parent, (ast.Return, ast.Yield, ast.keyword,
                                   ast.Tuple, ast.List, ast.Dict,
                                   ast.Subscript, ast.Starred)):
                return True
            if isinstance(parent, ast.Assign) and parent is not assign:
                return True
    return False


def _collected_list(scope: ast.AST, name: str) -> Optional[str]:
    """List variable `name` is appended to: `L.append(t)` -> "L"."""
    for node in walk_scope(scope):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "append" \
                and isinstance(node.func.value, ast.Name) \
                and any(isinstance(a, ast.Name) and a.id == name
                        for a in node.args):
            return node.func.value.id
    return None


def _list_joined(scope: ast.AST, list_name: str) -> bool:
    """``for t in L: t.join()`` (or join on an element of L)."""
    for node in walk_scope(scope):
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Name) \
                and node.iter.id == list_name \
                and isinstance(node.target, ast.Name):
            if _joins_name(node, node.target.id):
                return True
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "join" \
                and isinstance(node.func.value, ast.Subscript) \
                and isinstance(node.func.value.value, ast.Name) \
                and node.func.value.value.id == list_name:
            return True
    return False


def _self_attr_joined(model: ModuleModel, node: ast.AST, attr: str) -> bool:
    """Any ``self.<attr>.join(`` (or escape of self.<attr>) in the class."""
    cls = getattr(node, "graftcheck_parent", None)
    while cls is not None and not isinstance(cls, ast.ClassDef):
        cls = getattr(cls, "graftcheck_parent", None)
    if cls is None:
        return False
    for n in ast.walk(cls):
        if isinstance(n, ast.Attribute) \
                and isinstance(n.value, ast.Attribute) \
                and isinstance(n.value.value, ast.Name) \
                and n.value.value.id == "self" and n.value.attr == attr \
                and n.attr == "join":
            return True
        # self._t passed somewhere: escapes, trusted
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                and n.value.id == "self" and n.attr == attr \
                and isinstance(n.ctx, ast.Load):
            parent = getattr(n, "graftcheck_parent", None)
            if isinstance(parent, ast.Call) and n in parent.args:
                return True
    return False


def _comprehension_target(call: ast.Call) -> Optional[ast.AST]:
    """The comprehension node the Thread(...) call sits in, if any."""
    cur = getattr(call, "graftcheck_parent", None)
    while cur is not None and not isinstance(cur, _FN_TYPES):
        if isinstance(cur, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return cur
        cur = getattr(cur, "graftcheck_parent", None)
    return None


def _daemon_fix(model: ModuleModel, call: ast.Call) -> Optional[Fix]:
    if call.end_lineno != call.lineno:
        return None  # multi-line constructor: hand repair
    if any(kw.arg == "daemon" for kw in call.keywords):
        return None  # daemon=False/None present: appending would repeat
        # the kwarg (SyntaxError) — the intent needs a human
    segment = ast.get_source_segment(model.source, call)
    if not segment or not segment.endswith(")"):
        return None
    sep = ", " if (call.args or call.keywords) else ""
    return Fix(edits=(Edit(call.lineno, segment,
                           segment[:-1] + f"{sep}daemon=True)"),))


def check(model: ModuleModel) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted_name(node.func) or ""
        if d not in ("threading.Thread", "Thread"):
            continue
        if _daemon_state(node) is not False:
            continue  # daemon, or dynamic (trusted)
        scope = _scope_of(model, node)
        parent = getattr(node, "graftcheck_parent", None)
        joined = False
        trusted = False
        comp = _comprehension_target(node)
        if comp is not None:
            comp_parent = getattr(comp, "graftcheck_parent", None)
            if isinstance(comp_parent, ast.Assign) \
                    and len(comp_parent.targets) == 1 \
                    and isinstance(comp_parent.targets[0], ast.Name):
                joined = _list_joined(scope,
                                      comp_parent.targets[0].id)
            else:
                trusted = True  # comprehension result escapes
        elif isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            tgt = parent.targets[0]
            if isinstance(tgt, ast.Name):
                if _joins_name(scope, tgt.id):
                    joined = True
                elif _escapes(scope, tgt.id, parent):
                    trusted = True
                else:
                    lst = _collected_list(scope, tgt.id)
                    if lst is not None:
                        joined = _list_joined(scope, lst)
            elif isinstance(tgt, ast.Attribute) \
                    and isinstance(tgt.value, ast.Name) \
                    and tgt.value.id == "self":
                joined = _self_attr_joined(model, node, tgt.attr)
            else:
                trusted = True
        elif isinstance(parent, ast.Attribute):
            joined = False  # threading.Thread(...).start(): anonymous leak
        else:
            trusted = True  # passed/returned/stored: escapes this scope
        if joined or trusted:
            continue
        findings.append(Finding(
            model.rel_path, node.lineno, RULE_ID, Severity.WARNING,
            "non-daemon thread is never joined — it outlives its owner, "
            "hangs interpreter exit, and leaks one worker per start; pass "
            "daemon=True or join() it on the shutdown path",
            model.snippet(node.lineno),
            fix=_daemon_fix(model, node)))
    return findings
