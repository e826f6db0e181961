"""Whether the -mxu_scatter backend's AROW step matches the xla step's fired
rows, block by block from a common state, and where it parts.

Both minibatch backends of hivemall_tpu_torch/core/engine.py score a row
from the same gathered weights, so from one state they should fire the
same rows and mark the same features `touched`. This script walks main's
blocks (chip_smoke.main_data: 262,144 CTR rows of 32 hashed ids at 2^22
dims, 64 blocks of 4,096) through AROW's mxu step, one block after
another. At each block it also, from the same state:

- compares the row scores of the two backends' gathers, bit for bit;
- builds the mxu step's stacked update (dw, dcov, the fired-lane
  indicator) and scatters it with ops/mxu_scatter.scatter_add, then holds
  each feature's indicator sum against torch.bincount of its fired lanes
  (an integer count): features whose sum is not their count, features
  with no fired lane whose sum is not 0, and features with no fired lane
  whose dw sum is not 0;
- runs the xla step and compares `touched`.

    python3 scripts/mxu_runsum_probe.py             # on the card
    python3 scripts/mxu_runsum_probe.py --device cpu --dims 16384 --rows 16384

It prints the card's name and power limit and, as its last line, a JSON
object of the totals over the blocks and passes.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from hivemall_tpu_torch.core.engine import (make_batch_update,  # noqa: E402
                                            make_train_fn, row_context)
from hivemall_tpu_torch.core.state import init_linear_state  # noqa: E402
from hivemall_tpu_torch.models.classifier import AROW  # noqa: E402
from hivemall_tpu_torch.ops import mxu_scatter as mxu  # noqa: E402

HYPER = {"r": 0.1}


def probe_block(st, idx, val, y):
    """This block's counts from state `st` (not modified)."""
    d = st.dims
    b, k = idx.shape
    ts = (st.step + 1 + torch.arange(b, device=idx.device)).float()
    ctx, live, _ = row_context((st.weights, st.covars, {}), idx, val, y, ts,
                               True)
    ids = idx.reshape(-1)
    plan = mxu.make_plan(ids, d)
    g = mxu.gather(torch.stack([st.weights, st.covars], -1), plan) \
        .reshape(b, k, 2)
    cov_g = torch.where(~live, 1.0, g[..., 1])
    outs = make_batch_update(AROW, HYPER)(g[..., 0], cov_g, {}, val, y, ts,
                                          {})
    score_mxu = torch.sum(g[..., 0] * val, dim=-1)
    lane_upd = outs.updated.float()[:, None] * torch.ones_like(val)
    dstack = torch.stack([outs.dw, outs.dcov, lane_upd], -1).reshape(b * k, 3)
    sums = mxu.scatter_add(torch.zeros((d, 4), device=idx.device), ids,
                           dstack, plan)
    fired = ((lane_upd > 0) & live).reshape(-1)
    count = torch.bincount(ids[fired], minlength=d)[:d].float()
    none = count == 0
    return {
        "score_rows_differ": int((score_mxu != ctx.score).sum()),
        "fired_rows_differ": int(((score_mxu * y < 1.0)
                                  != (ctx.score * y < 1.0)).sum()),
        "count_not_exact": int((sums[:, 2] != count).sum()),
        "count_spurious": int((none & (sums[:, 2] != 0)).sum()),
        "dw_spurious": int((none & (sums[:, 0] != 0)).sum()),
        "max_abs_spurious_count": float(
            torch.where(none, sums[:, 2].abs(), 0.0).max()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dims", type=int, default=chip_smoke.FULL_DIMS)
    ap.add_argument("--rows", type=int, default=chip_smoke.ROWS)
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(f"[probe] {torch.cuda.get_device_name(0)}; torch "
              f"{torch.__version__}; {smi}")
    chip_smoke.FULL_DIMS, chip_smoke.ROWS = args.dims, args.rows
    _, (idx, val, y), _ = chip_smoke.main_data(0)
    yy = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    steps = {be: make_train_fn(AROW, HYPER, mode="minibatch",
                               update_backend=be, device=dev)
             for be in ("mxu", "xla")}
    tot = {}
    blocks = 0
    touched_blocks = 0
    for p in range(args.passes):
        st = init_linear_state(args.dims, use_covariance=True, device=dev)
        for i in range(len(yy) // 4096):
            s = slice(i * 4096, (i + 1) * 4096)
            ti = torch.from_numpy(idx[s]).long().to(dev)
            tv = torch.from_numpy(val[s]).to(dev)
            ty = torch.from_numpy(yy[s]).to(dev)
            got = probe_block(st, ti, tv, ty)
            for key, v in got.items():
                tot[key] = max(tot.get(key, 0), v) if key.startswith("max") \
                    else tot.get(key, 0) + v
            new = {be: fn(chip_smoke.clone_linear_state(st), ti, tv, ty)[0]
                   for be, fn in steps.items()}
            if not torch.equal(new["mxu"].touched, new["xla"].touched):
                touched_blocks += 1
            blocks += 1
            st = new["mxu"]
        print(f"[probe] pass {p}: {json.dumps(tot)}; blocks whose touched "
              f"differs {touched_blocks} of {blocks}")
    print(json.dumps({"blocks": blocks, "touched_blocks_differ":
                      touched_blocks, **tot}))


if __name__ == "__main__":
    main()
