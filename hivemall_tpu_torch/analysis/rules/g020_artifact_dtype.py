"""G020 dtype-unstable-artifact-round-trip: reloads that don't pin dtype.

The artifact save path widens bf16 tables to f32 at rest (np.savez cannot
round-trip bf16 — serving/artifact._host) and records the training dtype
in the manifest. A load-side ``torch.as_tensor(pack[...])`` WITHOUT a
dtype therefore resurrects the table *wide*: a bf16-trained model
silently serves at 2x the card's memory traffic forever after one
freeze->load cycle, and a future int8 manifest would dequantize at load.
This rule flags exactly that shape, in the artifact/checkpoint modules
(``io/checkpoint.py``, ``serving/artifact.py``, ``serving/engine.py``,
``serving/sharded.py``, plus ``# graftcheck: artifact-io`` opt-ins):

- a name bound from ``np.load(...)`` (assignment or ``with ... as z``) or
  from an ``.arrays`` attribute (the Artifact pack) is a **pack**;
- ``torch.as_tensor(pack[...])`` / ``torch.from_numpy(pack[...])`` /
  ``torch.tensor(pack[...])`` / ``torch.asarray(pack[...])`` with no
  dtype argument and no cast right after it (``.to(dtype)``,
  ``.float()`` ...) is a finding — pin the dtype from the manifest
  (``meta["weights_dtype"]``, see serving/artifact.manifest_dtype) or
  suppress with a rationale where the stored dtype is authoritative.

Host-side ``np`` uses of pack entries are fine (numpy round-trips its own
concrete dtypes bit-exactly); only the host->device rebuild can widen.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .. import config
from ..dtypeflow import TENSOR_FROM_HOST, cast_after
from ..findings import Finding, Severity
from ..modmodel import ModuleModel, dotted_name, walk_scope
from ..program import ProgramModel

RULE_ID = "G020"


def _in_scope(model: ModuleModel) -> bool:
    return (model.rel_path in config.ARTIFACT_IO_MODULES
            or config.ARTIFACT_MARKER in model.source)


def _is_pack_source(expr: ast.expr) -> bool:
    """np.load(...) or <x>.arrays — the two pack producers."""
    if isinstance(expr, ast.Call):
        callee = dotted_name(expr.func) or ""
        if callee.rsplit(".", 1)[-1] == "load" \
                and callee.split(".", 1)[0] in ("np", "numpy"):
            return True
    if isinstance(expr, ast.Attribute) and expr.attr == "arrays":
        return True
    return False


def _pack_names(fn: ast.AST) -> Set[str]:
    packs: Set[str] = set()
    for node in walk_scope(fn):
        if isinstance(node, ast.Assign):
            targets = node.targets
            values = [node.value]
            if len(targets) == 1 and isinstance(targets[0], ast.Tuple) \
                    and isinstance(node.value, ast.Tuple) \
                    and len(targets[0].elts) == len(node.value.elts):
                targets, values = targets[0].elts, node.value.elts
            for tgt, val in zip(targets, values * len(targets)
                                if len(values) == 1 else values):
                if isinstance(tgt, ast.Name) and _is_pack_source(val):
                    packs.add(tgt.id)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None \
                        and isinstance(item.optional_vars, ast.Name) \
                        and _is_pack_source(item.context_expr):
                    packs.add(item.optional_vars.id)
    return packs


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None or not _in_scope(model):
            continue
        for fn in model.functions:
            packs = _pack_names(fn)
            if not packs:
                continue
            for node in walk_scope(fn):
                if not isinstance(node, ast.Call):
                    continue
                callee = dotted_name(node.func) or ""
                root, _, tail = callee.rpartition(".")
                if tail not in TENSOR_FROM_HOST or root != "torch":
                    continue
                args = [a for a in node.args
                        if not isinstance(a, ast.Starred)]
                if len(args) != len(node.args) or not args:
                    continue
                first = args[0]
                if not (isinstance(first, ast.Subscript)
                        and isinstance(first.value, ast.Name)
                        and first.value.id in packs):
                    continue
                if len(args) > 1 or any(kw.arg == "dtype"
                                        for kw in node.keywords) \
                        or cast_after(node):
                    continue  # dtype pinned: stable round-trip
                findings.append(Finding(
                    path, node.lineno, RULE_ID, Severity.WARNING,
                    f"dtype-unstable artifact round-trip: "
                    f"{callee}({ast.unparse(first)}) reloads whatever "
                    f"width the pack holds — the save path widens bf16 to "
                    f"f32 at rest, so a reduced-precision table silently "
                    f"serves wide after one freeze->load; pin the dtype "
                    f"from the manifest (meta['weights_dtype'] via "
                    f"serving/artifact.manifest_dtype)",
                    model.snippet(node.lineno)))
    return findings
