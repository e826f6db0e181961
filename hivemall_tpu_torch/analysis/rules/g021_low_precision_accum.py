"""G021 accumulate-in-low-precision: accumulators narrower than 32 bits.

The one place widening is *required*: a reduction or a scatter-add whose
accumulator dtype equals a bf16/f16 input. Reduced floats carry 8-11
mantissa bits — a 16k-element bf16 sum has absorbed-update error on the
order of the values themselves, and an online-learning scatter-add that
accumulates bf16 *loses* small gradient contributions entirely (the
reference shipped its half-float codec for storage, never for
accumulation). The dtype-flow model proves the operand/table dtype; the
fix is an explicit widened accumulator (``dtype=torch.float32`` on the
reduction, or accumulate f32 and cast once at the table write — the
models/base.py storage policy).

What accumulates where is torch's kernel's choice, not the call's result
dtype: on an H100, ``sum`` / ``nansum`` / ``mean`` / ``cumsum`` / ``prod``
/ ``segment_reduce`` and ``index_put_(..., accumulate=True)`` of a bf16 /
f16 tensor keep their running sum in float32 and round once
(dtypeflow.TORCH_WIDE_ACCUMULATORS, measured by
scripts/torch_accum_probe.py), so they are no finding; ``cumprod``,
``index_add_``, ``scatter_add_`` and ``scatter_reduce_(..., "sum")``
accumulate in the table's own dtype and are. NumPy's reductions of a
16-bit array accumulate in 16 bits and are findings.

Scoped to the dtype-sensitive packages plus the hot-path scopes; unknown
dtypes (parameters, dynamic tables) are trusted, and a reduction that
already passes a wider ``dtype=`` is the sanctioned idiom.
"""

from __future__ import annotations

from typing import List, Set

from .. import config
from ..dtypeflow import get_model, in_hot_scope
from ..findings import Finding, Severity
from ..program import ProgramModel

RULE_ID = "G021"


def _module_in_scope(path: str, source: str) -> bool:
    return (path.startswith(config.DTYPE_MODULE_PREFIXES
                            + config.DTYPEFLOW_HOT_PREFIXES)
            or path in config.DTYPEFLOW_HOT_MODULES
            or "# graftcheck: dtype-module" in source
            or config.HOT_MARKER in source)


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    flow = get_model(program)
    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None:
            continue
        if not (_module_in_scope(path, model.source)
                or any(in_hot_scope(path, model, fn)
                       for fn in model.functions)):
            continue
        seen: Set[int] = set()
        for fn in model.functions:
            facts = flow.facts(path, fn)
            for red in facts.reductions:
                if red.widened or red.operand_dt is None \
                        or not red.operand_dt.reduced_float \
                        or red.node.lineno in seen:
                    continue
                seen.add(red.node.lineno)
                findings.append(Finding(
                    path, red.node.lineno, RULE_ID, Severity.ERROR,
                    f"{red.tail} over a {red.operand_dt.name} operand "
                    f"accumulates in {red.operand_dt.name} — 8-11 mantissa "
                    f"bits absorb small contributions entirely; widen the "
                    f"accumulator (dtype=torch.float32) and cast once at "
                    f"the result write",
                    model.snippet(red.node.lineno)))
            for sc in facts.scatters:
                if sc.widened or sc.table_dt is None \
                        or not sc.table_dt.reduced_float \
                        or sc.node.lineno in seen:
                    continue
                seen.add(sc.node.lineno)
                findings.append(Finding(
                    path, sc.node.lineno, RULE_ID, Severity.ERROR,
                    f"{sc.method} into a {sc.table_dt.name} table "
                    f"accumulates updates in {sc.table_dt.name} — online "
                    f"updates smaller than ~1/256 of the weight vanish; "
                    f"accumulate f32 and cast once at the table write "
                    f"(the models/base.py storage policy)",
                    model.snippet(sc.node.lineno)))
    return findings
