"""Time the exact scan's plan kernel on the card, against other sources of
it, in turns.

Builds hivemall_tpu_torch/kernels/csrc/linear_scan.cu (the package's own
build) and each --other copy of that source (say, a parent commit's,
unpacked with `git archive` into a git-ignored directory, or a copy with
the plan CTA's PLAN_TILE_ROWS / PLAN_WARPS edited), all with the
package's nvcc flags and at once. It times each library's
`hm_linear_scan_plan` on chip_smoke.py phase width's block (AROW's depth
8 at D = 2^22, B = 4,096, K = 32) in turns, the list and then the list
reversed (the others, this, this, the others reversed):

- wrapper: the port's wrapper's work a launch (three [B, K] int32
  allocations and the ctypes call), by CUDA events over 20 calls;
- graph: the launch alone replayed as one CUDA graph (chip_smoke.graph_ms);
- kernel: the kernel's own duration by torch.profiler (chip_smoke.kernel_ms);

beside a launch floor: a one-element op's graph, timed as `graph`. Each
library's tables are first held equal to `linear_scan_plan_reference`.

    python3 scripts/time_plan_kernel.py [--other PATH/linear_scan.cu ...]

It prints the card's name and power limit, one line a turn, and as its
last line a JSON object of each source's readings by turn.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hivemall_tpu_torch.kernels import build  # noqa: E402
from hivemall_tpu_torch.kernels.linear_scan import (  # noqa: E402
    _library, linear_scan_plan_reference)

REPS = 20


def other_library(src):
    """The library of a linear_scan.cu, built with the package's nvcc flags
    into the package's build directory."""
    data = open(src, "rb").read()
    key = hashlib.sha256(data + " ".join(build.NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    out = build.BUILD_DIR / f"libplan_other_{key}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        src], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    lib.hm_linear_scan_plan.restype = ctypes.c_int
    lib.hm_linear_scan_plan.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    return lib


def plan_fn(lib, ti, dims, depth):
    """One launch the way the wrapper makes it; returns the tables."""
    b, k = ti.shape

    def run():
        lead, nxt, fwd = (torch.empty_like(ti) for _ in range(3))
        rc = lib.hm_linear_scan_plan(
            ti.data_ptr(), lead.data_ptr(), nxt.data_ptr(), fwd.data_ptr(),
            b, k, dims, depth, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return lead, nxt, fwd

    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another linear_scan.cu (repeatable)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[plan] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; {smi}")
    dims, depth = cs.FULL_DIMS, 8
    idx, _, _ = cs.block(np.random.RandomState(args.seed + 7), 4096, cs.WIDTH,
                         dims)
    ti = torch.from_numpy(idx).cuda()
    with ThreadPoolExecutor(len(args.other) + 1) as pool:
        this = pool.submit(_library)
        built = [pool.submit(other_library, src) for src in args.other]
        libs = {**{src: job.result() for src, job in zip(args.other, built)},
                "this": this.result()}
    want = linear_scan_plan_reference(ti, dims, depth)
    for name, lib in libs.items():
        got = plan_fn(lib, ti, dims, depth)()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), f"{name}: plan differs"
    one = torch.zeros(1, device="cuda")
    order = list(libs) + list(libs)[::-1]
    out = {name: [] for name in libs}
    for turn, name in enumerate(order):
        fn = plan_fn(libs[name], ti, dims, depth)
        r = {"wrapper_ms": cs.cuda_ms(fn, REPS),
             "graph_ms": cs.graph_ms(fn, REPS),
             "kernel_ms": cs.kernel_ms(fn, "linear_scan_plan", REPS)[0],
             "launch_floor_ms": cs.graph_ms(lambda: one.add_(1.0), REPS)}
        out[name].append(r)
        print(f"[plan] turn {turn} {name}: " + ", ".join(
            f"{k} {v:.5f}" if v is not None else f"{k} not measured"
            for k, v in r.items()))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "bound_ms": 1e3 * 4096 * cs.WIDTH * 16
                      / cs.HBM_BYTES_PER_S, **out}))


if __name__ == "__main__":
    main()
