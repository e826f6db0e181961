"""G017 silent-dtype-promotion-in-hot-path: a reduced tensor widens implicitly.

The dequant-free violation: a bf16/f16/int8 tensor meets an f32/f64 operand
in a hot-path scope (ops/, kernels/, the serving score path, traced or
step-shaped functions in the dtype-sensitive packages) and the result
widens — from that op on, every downstream read/write moves 2-4x the
bytes the quantized table was sized for. The dtype-flow model
(analysis/dtypeflow.py) proves both operand dtypes through constructors,
casts, and call-return summaries, and promotes by torch's table where a
tensor takes part: a Python or numpy scalar and a 0-dim tensor of the same
category never widen a tensor there, so only a mix of two dimensioned
operands (or a higher-category 0-dim one) is a finding. Mixes involving
unknown operands are trusted. Intentional widening (an f32 accumulator fed
by a bf16 table) is declared with an explicit ``.to(dtype)`` /
``.float()`` / ``dtype=`` — explicit casts never fire this rule (G019/G021
police those separately). torch's ``matmul`` / ``mm`` / ``dot`` raise on
two dtypes, so a product never promotes silently.
"""

from __future__ import annotations

from typing import List, Set

from ..dtypeflow import get_model, in_hot_scope
from ..findings import Finding, Severity
from ..program import ProgramModel

RULE_ID = "G017"


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    flow = get_model(program)
    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None:
            continue
        seen: Set[int] = set()
        for fn in model.functions:
            if not in_hot_scope(path, model, fn):
                continue
            for site in flow.facts(path, fn).promotions:
                if site.node.lineno in seen:
                    continue
                seen.add(site.node.lineno)
                findings.append(Finding(
                    path, site.node.lineno, RULE_ID, Severity.ERROR,
                    f"silent dtype promotion in hot path: "
                    f"{site.left_dt.name} x {site.right_dt.name} widens to "
                    f"{site.out_dt.name} — every downstream op now moves "
                    f"{site.out_dt.bits // 8} bytes/elt where the reduced "
                    f"table was sized for "
                    f"{min(site.left_dt.bits, site.right_dt.bits) // 8}; "
                    f"cast the wide operand down (or widen explicitly with "
                    f".to(dtype) and a rationale if accumulation requires "
                    f"it)",
                    model.snippet(site.node.lineno)))
    return findings
