"""G008 mesh-lookup/mesh mismatch: an axis the resolved mesh does not bind.

The reference flags a ``PartitionSpec`` naming an axis its mesh lacks
(``P(SHARD_AXIS)`` under a 1-D ``make_mesh()``): a placement that cannot
be honored, accepted on some paths and failing at placement time. The
port places nothing by spec. Its counterpart is a rank's lookup of its
own place in the mesh by axis name — ``mesh.index(axis)`` (its stripe),
``mesh.shape[axis]`` (the stripe count), ``mesh.coords[axis]`` and
``mesh.groups[axis]`` — the way ``parallel/sharded.py`` and
``parallel/sharded_train.py`` cut the model into stripes. Naming an axis
the mesh does not bind raises ``KeyError`` only at run time, on the
ranks, and only on a mesh of that shape.

Like G007 the rule reads the walks from every function that builds a
mesh (program.py's ``mesh_walks``) and checks each lookup whose mesh and
axis both resolve; unknown meshes and dynamic axis names are trusted.

The reference's serving case (``g008_serving_*``: specs over the
``(batch, model)`` serving mesh) has no counterpart: the port's serving
grid (serving/placement.py) names no axes.
"""

from __future__ import annotations

from typing import List, Set

from ..findings import Finding, Severity
from ..program import ProgramModel

RULE_ID = "G008"


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    seen = set()
    for f_path, f_fn, summ, env in program.mesh_walks():
        if f_path not in scanned:
            continue
        lookups = [(call, "mesh.index({!r})", kind, value, mesh_expr)
                   for call, tail, kind, value, mesh_expr
                   in summ.collectives if tail == "index"]
        lookups += [(node, f"mesh.{name}[{{!r}}]", kind, value, mesh_expr)
                    for node, name, kind, value, mesh_expr
                    in summ.mesh_lookups]
        for node, what, kind, value, mesh_expr in lookups:
            axis = program.resolve_axis(f_path, f_fn, kind, value, env)
            if axis is None:
                continue
            axes = program.mesh_axes(f_path, mesh_expr, f_fn, env)
            if not axes or axis in axes:
                continue
            key = (f_path, node.lineno, axis)
            if key in seen:
                continue
            seen.add(key)
            model = program.modules[f_path]
            findings.append(Finding(
                f_path, node.lineno, RULE_ID, Severity.ERROR,
                f"mesh lookup `{what.format(axis)}` names an axis the "
                f"mesh does not bind ({', '.join(sorted(axes))}) — it "
                f"raises KeyError at run time, on the ranks",
                model.snippet(node.lineno)))
    return findings
