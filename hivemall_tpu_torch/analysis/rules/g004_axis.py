"""G004 axis-name-mismatch: collective axis literals vs the declared mesh.

``psum(x, mesh, "worker")`` against a mesh whose axis is ``"workers"``
fails only at run time, on the ranks, with a ``KeyError`` from
``mesh.groups`` (core/collectives.py). The mesh axis registry is small and
static — ``parallel/mesh.py`` declares WORKER_AXIS / SHARD_AXIS and every
trainer threads those through — so any *string literal* axis name that is
not a declared axis is a typo.

Declared axes = config.DEFAULT_AXIS_NAMES, plus ``config.MESH_FILE``'s
module-level ``*_AXIS`` string constants (parsed, not imported), plus
literal axis names passed to ``Mesh(...)`` / ``make_mesh*(axis_name=...,
replica_axis=..., shard_axis=...)`` in the module under scan (modules may
build private meshes). The axis argument is found where
``config.COLLECTIVE_CALLS`` puts it (``psum(x, mesh, axis)``,
``gather_fields(state, names, mesh, axis)``, ``mesh.index(axis)``);
``torch.distributed``'s own calls name a group, not an axis. Variable
axis names are trusted — they trace back to the registry by construction.
"""

from __future__ import annotations

import ast
import os
from typing import List, Set

from .. import config
from ..findings import Finding, Severity
from ..modmodel import ModuleModel, dotted_name
from ..program import collective_axis_expr, collective_tail

RULE_ID = "G004"

_AXIS_KWARGS = ("axis_name", "axis_names", "replica_axis", "shard_axis")


_MESH_AXES_CACHE: dict = {}


def _mesh_file_axes() -> Set[str]:
    """Module-level ``*_AXIS`` string constants of config.MESH_FILE, parsed
    (not imported — graftcheck must not pull in torch) and mtime-cached:
    a full-tree scan calls this once per scanned module."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo = os.path.dirname(os.path.dirname(here))
    mesh_py = os.path.join(repo, *config.MESH_FILE.split("/"))
    axes: Set[str] = set()
    try:
        mtime = os.path.getmtime(mesh_py)
        cached = _MESH_AXES_CACHE.get(mesh_py)
        if cached is not None and cached[0] == mtime:
            return cached[1]
        with open(mesh_py, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
    except (OSError, SyntaxError):
        return axes
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant) \
                and isinstance(node.value.value, str) \
                and any(isinstance(t, ast.Name) and t.id.endswith("_AXIS")
                        for t in node.targets):
            axes.add(node.value.value)
    _MESH_AXES_CACHE[mesh_py] = (mtime, axes)
    return axes


def _literal_names(expr: ast.expr):
    """String literals of an axis argument: one, or a tuple / list."""
    elts = expr.elts if isinstance(expr, (ast.Tuple, ast.List)) else [expr]
    for elt in elts:
        if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
            yield elt.value


def _declared_axes(model: ModuleModel) -> Set[str]:
    axes = set(config.DEFAULT_AXIS_NAMES) | _mesh_file_axes()
    for node in ast.walk(model.tree):
        # local string constants named *_AXIS count as declarations
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant) \
                and isinstance(node.value.value, str):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id.endswith("_AXIS"):
                    axes.add(node.value.value)
        if not isinstance(node, ast.Call):
            continue
        callee = dotted_name(node.func) or ""
        tail = callee.rsplit(".", 1)[-1]
        # only mesh CONSTRUCTORS declare axes; axis arguments of
        # collectives are uses and must validate against the declarations
        if tail != "Mesh" and not tail.startswith("make_mesh"):
            continue
        if tail == "Mesh" and node.args:
            # core/collectives.Mesh(axis_names, shape, coords, ...)
            axes.update(_literal_names(node.args[0]))
        for kw in node.keywords:
            if kw.arg in _AXIS_KWARGS:
                axes.update(_literal_names(kw.value))
    return axes


def check(model: ModuleModel) -> List[Finding]:
    if not any(tail + "(" in model.source
               for tail in config.COLLECTIVE_CALLS):
        return []  # cheap pre-filter before the full AST walk
    axes = None
    findings: List[Finding] = []
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        tail = collective_tail(dotted_name(node.func) or "")
        if tail is None:
            continue
        cand = collective_axis_expr(node, tail)
        if not isinstance(cand, ast.Constant) \
                or not isinstance(cand.value, str):
            continue
        if axes is None:
            axes = _declared_axes(model)
        if cand.value not in axes:
            findings.append(Finding(
                model.rel_path, node.lineno, RULE_ID, Severity.ERROR,
                f"collective `{tail}` over axis '{cand.value}' which is not "
                f"a declared mesh axis ({', '.join(sorted(axes))}) — a "
                f"typo'd axis name fails only at run time, on the ranks",
                model.snippet(node.lineno)))
    return findings
