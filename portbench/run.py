"""Run one cell once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `hivemall_tpu_torch`. It needs as
many CUDA devices as the cell asks for and fails without them; it never
trains on the CPU. Standard output's last line is one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and last `compared`: each number the check compared with its
limit); standard error ends with the same numbers, one a line. A run that
cannot give a result prints none and exits with 1.

The port builds its CUDA kernels into its own
`hivemall_tpu_torch/kernels/_build/`, inside the checkout, so only the
first run in a checkout compiles.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import harness, spec

    try:
        result, lines = harness.run(spec.load(ROOT), args.workload, args.seed,
                                    args.seconds, bool(args.trace),
                                    root=ROOT)
    except Exception:  # the run's boundary: report it, print no result
        traceback.print_exc()
        return 1
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
