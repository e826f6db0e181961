"""Which torch reductions and scatter-adds accumulate a bf16/f16 operand wide.

graftcheck's G021 (hivemall_tpu_torch/analysis/rules/g021_low_precision_accum.py)
flags an accumulation whose accumulator is a 16-bit float. Whether torch's
kernel for a call keeps its running sum in float32 (its "opmath" type) and
rounds once at the result write, or in the operand's own dtype, is a fact of
the kernel on the device, not of the call's result dtype. This script
measures it: for each call and each 16-bit float it accumulates N seeded
values near 1 and compares the result with the float64 sum of the same
rounded inputs. An error of at most one unit in the last place of the
result means a float32 accumulator ("wide"); more means "reduced".

    python3 scripts/torch_accum_probe.py            # on the card
    python3 scripts/torch_accum_probe.py --device cpu

It prints the card's name and power limit, one JSON line per call and a
summary JSON object as its last line, and writes the same object to
chiprun_out/accum_probe.json.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import torch

N = 16384


def _ulp(value: float, dtype: torch.dtype) -> float:
    mant = {torch.bfloat16: 7, torch.float16: 10}[dtype]
    return 2.0 ** (math.floor(math.log2(abs(value))) - mant)


def _scatter(kind, x):
    idx = torch.zeros(x.numel(), dtype=torch.long, device=x.device)
    table = torch.zeros(1, dtype=x.dtype, device=x.device)
    if kind == "index_add_":
        return table.index_add_(0, idx, x)
    if kind == "scatter_add_":
        return table.scatter_add_(0, idx, x)
    if kind == "index_put_":
        return table.index_put_((idx,), x, accumulate=True)
    return table.scatter_reduce_(0, idx, x, "sum")


CALLS = {
    "sum": (lambda x: x.sum(), "sum"),
    "nansum": (lambda x: x.nansum(), "sum"),
    "mean": (lambda x: x.mean(), "mean"),
    "cumsum": (lambda x: x.cumsum(0)[-1], "sum"),
    "prod": (lambda x: x.prod(), "prod"),
    "cumprod": (lambda x: x.cumprod(0)[-1], "prod"),
    "segment_reduce": (lambda x: torch.segment_reduce(
        x, "sum", lengths=torch.tensor([x.numel()], device=x.device)), "sum"),
    "index_add_": (lambda x: _scatter("index_add_", x), "sum"),
    "scatter_add_": (lambda x: _scatter("scatter_add_", x), "sum"),
    "index_put_": (lambda x: _scatter("index_put_", x), "sum"),
    "scatter_reduce_": (lambda x: _scatter("scatter_reduce_", x), "sum"),
}


def _inputs(kind, dtype, device, gen):
    if kind == "prod":
        n = 1024
        v = 1.0 + 0.01 * torch.randn(n, generator=gen, dtype=torch.float64)
    else:
        n = N
        v = 0.5 + torch.rand(n, generator=gen, dtype=torch.float64)
    return v.to(dtype).to(device)


def probe(device: str):
    out = {}
    for name, (fn, kind) in CALLS.items():
        for dtype in (torch.bfloat16, torch.float16):
            gen = torch.Generator().manual_seed(0)
            x = _inputs(kind, dtype, device, gen)
            exact64 = x.double().cpu()
            exact = {"sum": exact64.sum(), "mean": exact64.mean(),
                     "prod": exact64.prod()}[kind].item()
            got = fn(x)
            if device == "cuda":
                torch.cuda.synchronize()
            got = float(got.reshape(-1)[0].double().item())
            err = abs(got - exact) / _ulp(exact, dtype)
            row = {"call": name, "dtype": str(dtype).split(".")[-1],
                   "device": device, "exact": exact, "got": got,
                   "err_ulps": err, "accumulator": "wide" if err <= 1.0
                   else "reduced"}
            print(json.dumps(row))
            out[f"{name}/{row['dtype']}"] = row["accumulator"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    card = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_accum_probe: no CUDA device (pass --device cpu to "
                  "probe the CPU kernels)", file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(card)
    summary = {"device": args.device, "card": card,
               "torch": torch.__version__, "n": N,
               "accumulators": probe(args.device)}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "accum_probe.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
