"""G007 collective-axis-not-bound: psum over an axis its mesh lacks.

A collective names a mesh axis; that axis must be bound by the mesh the
call receives, or every rank dies at run time with a ``KeyError`` from
``mesh.groups[axis]`` — or, on a 2-D mesh whose axis names were swapped,
silently reduces over the wrong group. ``psum(x, mesh, SHARD_AXIS)`` over
a 1-D ``make_mesh()`` (which binds only ``workers``) is the canonical
case. The hazard hides *interprocedurally*: the psum usually sits in a
helper (``mix_average`` in ``parallel/mix.py``, the histogram sums in
``models/trees/grow.py``) several calls below the code that builds the
mesh and hands it down.

The reference hangs this on ``shard_map`` sites, which bind a body's axes.
The port has none: its counterpart is the ``mesh`` argument each
collective receives. The rule walks the call graph from every function
that builds a mesh (program.py's ``mesh_walks``: the mesh, like an axis
string, binds the callee's parameter edge by edge) and checks every
collective whose mesh and axis both resolve. Both ends must be provable:
unknown meshes and dynamic axis names are trusted, exactly like G004.
``mesh.index(axis)`` is the mesh's own lookup, not a collective: G008
checks it.
"""

from __future__ import annotations

from typing import List, Set

from ..findings import Finding, Severity
from ..program import ProgramModel

RULE_ID = "G007"


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    seen = set()
    for f_path, f_fn, summ, env in program.mesh_walks():
        if f_path not in scanned:
            continue
        for call, tail, kind, value, mesh_expr in summ.collectives:
            if mesh_expr is None or tail == "index":
                continue
            axis = program.resolve_axis(f_path, f_fn, kind, value, env)
            if axis is None:
                continue
            axes = program.mesh_axes(f_path, mesh_expr, f_fn, env)
            if not axes or axis in axes:
                continue
            key = (f_path, call.lineno, tail, axis)
            if key in seen:
                continue
            seen.add(key)
            model = program.modules[f_path]
            findings.append(Finding(
                f_path, call.lineno, RULE_ID, Severity.ERROR,
                f"collective `{tail}` over axis '{axis}' which the mesh it "
                f"receives does not bind (mesh axes: "
                f"{', '.join(sorted(axes))}) — every rank fails at run time "
                f"looking up the axis' process group",
                model.snippet(call.lineno)))
    return findings
