"""The readings a cell's limits are set from, on the seeds given:

- `program`: the gaps of one fit of the program against the plain
  reference (the lower reading is their largest over a dozen seeds or
  more);
- `control`: the gaps of the control, the plain reference with bfloat16
  tables put in the program's place: one step below the float32 the
  configurations state (the port's `-pallas` path turns bf16 tables into
  float32 for its kernel, so it has no lower path of its own). The upper
  reading is its smallest over three seeds or more;
- `fault.<name>`: the gaps of the program with a fault of `faults.py`
  planted in its scan step;
- `witness`: the gaps of the reference replayed in float32 (see
  `reference/linear.py`), with the (pass, row) steps that fired on one side
  only, against the float64 reference: what float32 rounding alone does,
  with no code of the program.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--faults half,altered] \
        [--fault-seeds 1,2,3] [--witness-seeds 1,2] [--device cuda]

Each seed prints one JSON line, with the rows the reference fired in each
pass; the last line gives the largest program reading and the smallest
reading of every other side. A fit here is the window's: the same
trainer, options and rows from the same seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import numpy as np

from . import check, faults, spec, traffic
from .harness import Trainer, reference_tables


def _tables(model) -> tuple:
    return (model.state.weights.double().cpu().numpy(),
            model.state.covars.double().cpu().numpy())


def readings(cell: spec.Cell, seed: int, device: str, program: bool = True,
             control: bool = False, fault_names: List[str] = (),
             witness: bool = False) -> Dict[str, dict]:
    rows = traffic.make_rows(cell.config, seed)
    fired: list = []
    ref_w, ref_cov = reference_tables(cell, rows, "float64", fired)
    out = {"seed": seed, "fired": [int(f.sum()) for f in fired],
           "rows": len(rows)}
    if program:
        w, cov = _tables(Trainer(cell, device).fit(rows))
        out["program"] = check.numbers(w, cov, ref_w, ref_cov)
    if control:
        cw, ccov = reference_tables(cell, rows, "bfloat16")
        out["control"] = check.numbers(cw, ccov, ref_w, ref_cov)
    for name in fault_names:
        with faults.planted(name):
            w, cov = _tables(Trainer(cell, device).fit(rows))
        out[f"fault.{name}"] = check.numbers(w, cov, ref_w, ref_cov)
    if witness:
        wfired: list = []
        ww, wcov = reference_tables(cell, rows, "float32", wfired)
        got = check.numbers(ww, wcov, ref_w, ref_cov)
        apart = np.stack(fired) != np.stack(wfired)
        steps = np.argwhere(apart)
        got["one_sided"] = float(apart.sum())
        got["one_sided_by_pass"] = [int(x) for x in apart.sum(axis=1)]
        got["first_one_sided"] = steps[0].tolist() if len(steps) else None
        out["witness"] = got
    return out


def _csv(text: str) -> List[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--witness-seeds", default="")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    program, controls = _csv(args.seeds), set(_csv(args.control_seeds))
    fault_seeds, witnesses = set(_csv(args.fault_seeds)), \
        set(_csv(args.witness_seeds))
    names = [f for f in args.faults.split(",") if f]
    lines = []
    for seed in dict.fromkeys(program + sorted(controls | fault_seeds
                                               | witnesses)):
        line = readings(cell, seed, args.device, seed in program,
                        seed in controls,
                        names if seed in fault_seeds else (),
                        seed in witnesses)
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"workload": args.workload}
    sides = ["program", "control", "witness"] + [f"fault.{n}" for n in names]
    for side in sides:
        got = [line[side] for line in lines if side in line]
        pick = max if side in ("program", "witness") else min
        if got:
            summary[side] = {k: pick(g[k] for g in got) for k in got[0]
                             if isinstance(got[0][k], float)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
