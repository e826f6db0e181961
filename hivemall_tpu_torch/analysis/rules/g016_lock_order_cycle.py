"""G016 lock-ordering-cycle: two locks acquired in opposite orders.

Thread 1 holds the registry lock and calls into the batcher (which takes
its CV); thread 2 holds the batcher CV and calls into the registry.
Under contention each holds what the other needs — the classic ABBA
deadlock, invisible in single-threaded tests and fatal under load.

The concurrency model (analysis/concurrency.py) records every
acquisition edge "acquired Y while holding X", intra-class (nested
``with`` scopes, helpers reached through context propagation) and
cross-class (calls into methods of resolvable instances — module-level
singletons like ``REGISTRY`` and ``self.field = ClassName(...)``
fields). A cycle in that graph is reported at every participating
acquisition site in the scanned set; receivers whose type cannot be
resolved are trusted.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from ..concurrency import get_model
from ..findings import Finding, Severity
from ..program import ProgramModel

RULE_ID = "G016"

Node = Tuple[Tuple[str, str], str]  # ((module, class), lock field)


def _sccs(adj: Dict[Node, Set[Node]]) -> List[Set[Node]]:
    """Tarjan strongly-connected components, iterative."""
    index: Dict[Node, int] = {}
    low: Dict[Node, int] = {}
    on_stack: Set[Node] = set()
    stack: List[Node] = []
    out: List[Set[Node]] = []
    counter = [0]

    for root in sorted(adj):
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(adj.get(nxt, ())))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp: Set[Node] = set()
                while True:
                    top = stack.pop()
                    on_stack.discard(top)
                    comp.add(top)
                    if top == node:
                        break
                out.append(comp)
    return out


def _label(node: Node) -> str:
    (_path, cls), lock = node
    return f"{cls}.{lock}"


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    cm = get_model(program)
    adj: Dict[Node, Set[Node]] = {}
    for e in cm.lock_edges:
        if e.frm == e.to:
            continue  # same-lock re-acquisition is G014's subject
        adj.setdefault(e.frm, set()).add(e.to)
        adj.setdefault(e.to, set())
    comp_of: Dict[Node, int] = {}
    comps: List[Set[Node]] = []
    for comp in _sccs(adj):
        if len(comp) > 1:
            for n in comp:
                comp_of[n] = len(comps)
            comps.append(comp)
    if not comps:
        return []
    findings: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for e in sorted(cm.lock_edges,
                    key=lambda e: (e.path, e.site.lineno)):
        if e.frm == e.to or e.frm not in comp_of \
                or comp_of.get(e.to) != comp_of[e.frm]:
            continue
        members = ", ".join(sorted(_label(n)
                                   for n in comps[comp_of[e.frm]]))
        if e.path not in scanned:
            continue
        key = (e.path, e.site.lineno)
        if key in seen:
            continue
        seen.add(key)
        model = program.modules[e.path]
        findings.append(Finding(
            e.path, e.site.lineno, RULE_ID, Severity.ERROR,
            f"lock-ordering cycle: `{_label(e.to)}` is acquired here while "
            f"holding `{_label(e.frm)}`, and the reverse order exists "
            f"elsewhere (cycle: {members}) — under contention each thread "
            f"holds what the other needs (ABBA deadlock); pick one global "
            f"order or release before calling across",
            model.snippet(e.site.lineno)))
    return findings
