"""G019 cast-inside-loop / materializing-dequant: full-tensor casts per step.

Two advisory shapes of the same waste, scoped to the hot-path modules
(analysis/dtypeflow.in_hot_scope). A cast is torch's ``.to(dtype)`` /
``.to(device, dtype)`` / ``.type(torch.X)`` / ``.float()`` / ``.half()`` /
``.bfloat16()`` / ``.double()`` / ``.int()`` / ``.long()`` (and the other
named casts) or numpy's ``astype``; ``.to(device)`` alone moves a tensor
and is no cast.

- **cast-inside-loop**: a cast whose receiver no statement in the
  enclosing Python loop rebinds — the cast re-materializes the same
  tensor every iteration (on the card: one more kernel launch and a full
  read and write of the tensor per step). Hoist it above the loop, or
  reuse a precomputed plan the way ``ops/scatter.py`` builds its
  sort/segment structure once per block and amortizes it over every
  table.
- **materializing dequant**: a cast whose receiver is *provably*
  reduced-precision (bf16/f16) and whose target is f32/f64 — a full
  widened copy of a quantized tensor. The dequant-free serving contract
  wants the cast fused per-tile/per-window inside the consuming loop
  (``q[window].float()``, the ``ops/mxu_scatter.py`` window pattern), not
  a whole-table materialization that erases the bandwidth the
  quantization bought.

Both are warnings: widening can be the right call (an f32 accumulator),
and the fix is structural — suppress with a rationale where the copy is
deliberate.
"""

from __future__ import annotations

from typing import List, Set

from ..dtypeflow import get_model, in_hot_scope
from ..findings import Finding, Severity
from ..program import ProgramModel

RULE_ID = "G019"


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
            for site in flow.facts(path, fn).casts:
                if site.node.lineno in seen:
                    continue
                cast = f".{site.node.func.attr}()"
                if site.loop is not None and site.loop_invariant:
                    seen.add(site.node.lineno)
                    findings.append(Finding(
                        path, site.node.lineno, RULE_ID, Severity.WARNING,
                        f"{cast} of a loop-invariant tensor inside a Python "
                        f"loop — the cast re-materializes the full tensor "
                        f"every iteration; hoist it, or build a reusable "
                        f"plan once per block (ops/scatter.py amortizes its "
                        f"sort/segment plan over every table exactly this "
                        f"way)",
                        model.snippet(site.node.lineno)))
                elif site.receiver_dt is not None \
                        and site.receiver_dt.reduced_float \
                        and site.target_dt is not None \
                        and site.target_dt.wide_float:
                    seen.add(site.node.lineno)
                    findings.append(Finding(
                        path, site.node.lineno, RULE_ID, Severity.WARNING,
                        f"materializing dequant: {cast} to "
                        f"{site.target_dt.name} of a "
                        f"{site.receiver_dt.name} tensor copies the whole "
                        f"table widened — cast per-tile/per-window inside "
                        f"the consuming loop (the ops/mxu_scatter.py "
                        f"window pattern) to keep the bandwidth the "
                        f"reduced dtype bought",
                        model.snippet(site.node.lineno)))
    return findings
