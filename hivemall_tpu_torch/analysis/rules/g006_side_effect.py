"""G006 untraced-side-effect: host effects baked into a capture.

A capture's host Python runs ONCE, at capture (a CUDA graph, a
torch.jit.trace); under torch.compile the same calls split the graph,
dynamo running them eagerly between two captured pieces. ``print``,
metrics-counter increments, ``time.*`` reads, ``np.random`` draws,
torch's host RNG (``torch.manual_seed``, a CPU ``torch.Generator``) and
mutation of free (closure) Python state inside a capture execute once per
*capture*, not once per *replay* — the counter silently stops counting,
the print lies, the seed is set once, the mutation races the capture.
Keep per-step effects on the card (write into a device buffer the host
reads at a boundary), or hoist the effect to the host loop.

Flagged inside captures (captured defs and ``with torch.cuda.graph(g):``
blocks):
- calls to ``print`` / ``time.*`` / ``logging.*`` / ``np.random.*`` /
  ``torch.manual_seed`` and friends / a ``torch.Generator`` built without
  a CUDA device / known metrics methods (``.increment()`` /
  ``.set_gauge()`` / ``.record()``);
- assignment to subscripts/attributes of free variables and
  ``.append``/``.update``/``.add`` on free variables (closure mutation);
- ``global`` / ``nonlocal`` declarations.

``jax.debug.*``, the JAX package's sanctioned escape hatch, is never
flagged. ``torch.jit.script`` compiles its body instead of tracing it: its
``print`` runs per call, a false positive to suppress with its reason.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .. import config
from ..findings import Finding, Severity
from ..modmodel import ModuleModel, dotted_name, walk_scope
from .g001_recompile import capture_scopes

RULE_ID = "G006"

_MUTATING_METHODS = ("append", "update", "add", "extend", "insert", "pop",
                     "setdefault", "write")


def _local_names(fn: ast.AST) -> Set[str]:
    names: Set[str] = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs):
        names.add(a.arg)
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    for node in walk_scope(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.For,)) and isinstance(node.target,
                                                         ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.comprehension):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    names.add(n.id)
    return names


def _host_rng(call: ast.Call, callee: str) -> bool:
    """torch's host RNG: seeding it, or a generator not on a CUDA
    device."""
    if callee in config.SIDE_EFFECT_TORCH_RNG:
        return True
    if callee != "torch.Generator":
        return False
    dev = call.args[0] if call.args else next(
        (kw.value for kw in call.keywords if kw.arg == "device"), None)
    return not (isinstance(dev, ast.Constant)
                and str(dev.value).startswith("cuda")) \
        and not isinstance(dev, (ast.Name, ast.Attribute))


def check(model: ModuleModel) -> List[Finding]:
    findings: List[Finding] = []

    def emit(node: ast.AST, msg: str, sev: str = Severity.ERROR) -> None:
        findings.append(Finding(model.rel_path, node.lineno, RULE_ID, sev,
                                msg, model.snippet(node.lineno)))

    for fn, name, nodes, _tainted, _callables in capture_scopes(model):
        locals_ = _local_names(fn) if fn is not None else set()
        where = f"inside captured `{name}`"
        for node in nodes:
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                kw = "global" if isinstance(node, ast.Global) else "nonlocal"
                emit(node, f"`{kw}` mutation {where} runs once per "
                           f"capture, not per replay")
            elif isinstance(node, ast.Call):
                callee = dotted_name(node.func) or ""
                root = callee.split(".", 1)[0]
                if callee.startswith("jax.debug."):
                    continue  # the JAX package's sanctioned escape hatch
                if callee in config.SIDE_EFFECT_CALLS:
                    emit(node, f"`{callee}` {where} fires at capture only "
                               f"(or splits a torch.compile graph) — keep "
                               f"per-step output on the card and print it "
                               f"at a boundary")
                elif root in config.SIDE_EFFECT_ATTR_ROOTS:
                    emit(node, f"`{callee}` {where} reads host state at "
                               f"capture only")
                elif (root in ("np", "numpy") and callee.count(".") > 1
                      and callee.split(".")[1]
                      in config.SIDE_EFFECT_NP_RANDOM) \
                        or _host_rng(node, callee):
                    emit(node, f"`{callee}` {where} draws or seeds the "
                               f"host RNG ONCE, at capture — every replay "
                               f"repeats it; draw on the card with a CUDA "
                               f"generator")
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in config.SIDE_EFFECT_METHODS:
                    emit(node, f"metrics call `.{node.func.attr}()` {where} "
                               f"counts captures, not steps — increment in "
                               f"the host loop")
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _MUTATING_METHODS \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id not in locals_ \
                        and isinstance(getattr(node, "graftcheck_parent",
                                               None), ast.Expr):
                    emit(node, f"mutation of free variable "
                               f"`{node.func.value.id}.{node.func.attr}(...)`"
                               f" {where} happens at capture only")
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    base = tgt
                    while isinstance(base, (ast.Subscript, ast.Attribute)):
                        base = base.value
                    if isinstance(base, ast.Name) and base.id not in locals_ \
                            and not isinstance(tgt, ast.Name):
                        emit(tgt, f"write into free variable `{base.id}` "
                                  f"{where} mutates host state at capture "
                                  f"only")
    return findings
