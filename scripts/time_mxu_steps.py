"""Time the -mxu_scatter steps of AROW, FM and FFM, and scatter_add alone,
against another ops/mxu_scatter.py, in turns.

Each step routes every table access through
hivemall_tpu_torch/ops/mxu_scatter.py; --other names a second copy of
that module (say, a parent commit's, unpacked with `git archive` into a
git-ignored directory). The script loads it beside the package's own and,
turn by turn, puts one or the other in the package's place (the steps
import the module when they run). Turns go other, this, this, other.

At the shapes chip_smoke.py times (phase mxu's AROW step: B = 4,096,
K = 32, D = 2^22 on main's CTR rows; FM k = 5 at the same block; FFM at
phase ffm's shape, 2^20 features, 2^22 V rows, k = 4, 64 fields, one
block of 4,096 rows; scatter_add at the JAX module's bench shape, 2^19
ids over 2^22 rows x 4 columns) each turn gives:

- eager: ms a call by CUDA events (chip_smoke.cuda_ms);
- graph: ms a replay of the call captured as one CUDA graph
  (chip_smoke.graph_ms); "not measured" where the capture fails.

    python3 scripts/time_mxu_steps.py --other PATH/mxu_scatter.py   # card
    python3 scripts/time_mxu_steps.py --device cpu --dims 16384     # rehearse

It prints the card's name and power limit, one line a turn and case, and
as its last line a JSON object of each module's readings by turn.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import hivemall_tpu_torch.ops as ops_pkg  # noqa: E402
from hivemall_tpu_torch.core.engine import make_train_fn  # noqa: E402
from hivemall_tpu_torch.core.state import init_linear_state  # noqa: E402
from hivemall_tpu_torch.models import ffm as FF  # noqa: E402
from hivemall_tpu_torch.models import fm as F  # noqa: E402
from hivemall_tpu_torch.models.classifier import AROW  # noqa: E402
from hivemall_tpu_torch.ops import mxu_scatter as this_mxu  # noqa: E402

MODULE = "hivemall_tpu_torch.ops.mxu_scatter"
REPS = 20


def load_other(path):
    """The module at `path`, loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "hivemall_tpu_torch.ops._mxu_scatter_other", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def use(mod):
    """Put `mod` where the steps import ops.mxu_scatter from."""
    sys.modules[MODULE] = mod
    ops_pkg.mxu_scatter = mod


def cases(dev, dims, seed):
    """name -> a callable that runs one call of the case on `dev`."""
    rng = np.random.RandomState(seed)
    w_true = (rng.randn(dims) * 0.5).astype(np.float32)
    idx, val, y = cs.ctr_rows(rng, 4096, dims, w_true)
    yy = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    ti, tv, ty = (cs.torch_on(a, dev) for a in (idx.astype(np.int64), val,
                                                yy))
    out = {}

    arow = make_train_fn(AROW, {"r": 0.1}, mode="minibatch",
                         update_backend="mxu", device=dev)
    st_a = init_linear_state(dims, use_covariance=True, device=dev)
    out["arow step"] = lambda: arow(st_a, ti, tv, ty)

    fh = F.FMHyper(factors=cs.FM_FACTORS, classification=True)
    kp = fh.padded_factors
    v = np.zeros((dims, kp), np.float32)
    v[:, :cs.FM_FACTORS] = 0.1 * rng.randn(dims, cs.FM_FACTORS)
    fm_step = F.make_fm_step(fh, "minibatch", update_backend="mxu",
                             device=dev)
    st_f = F.fm_state_from_numpy(
        {"w0": np.float32(0.0), "w": np.zeros(dims, np.float32), "v": v,
         "lambda_w0": np.float32(fh.lambda0),
         "lambda_w": np.float32(fh.lambda0),
         "lambda_v": np.array([fh.lambda0] * cs.FM_FACTORS
                              + [0.0] * (kp - cs.FM_FACTORS), np.float32),
         "touched": np.zeros(dims, np.int8), "step": 0}, dev)
    tva = torch.zeros(4096, dtype=torch.float32, device=dev)
    out["fm step"] = lambda: fm_step(st_f, ti, tv, ty, tva)

    bits = max(4, (dims.bit_length() - 1) - 2)  # 2^20 at D = 2^22
    opts = (f"-factor {cs.FFM_K} -feature_hashing {bits} -v_bits "
            f"{dims.bit_length() - 1} -num_fields {cs.FFM_FIELDS}")
    hy = FF.ffm_hyper_from_options(FF._ffm_options().parse(opts, "time"))
    nf = hy.num_features
    f_idx = cs.workload_ids(rng, (cs.FFM_BLOCK, cs.FFM_WIDTH), nf) \
        .astype(np.int64)
    f_fld = rng.randint(0, cs.FFM_FIELDS, nf)[f_idx]
    f_y = np.where(rng.rand(cs.FFM_BLOCK) < 0.5, -1.0, 1.0) \
        .astype(np.float32)
    ffm_step = FF.make_ffm_step(hy, "minibatch", update_backend="mxu",
                                device=dev)
    st_m = FF.ffm_state_from_numpy(
        {"w0": np.float32(0.0), "w": np.zeros(nf, np.float32),
         "z": np.zeros(nf, np.float32), "n": np.zeros(nf, np.float32),
         "v": (0.1 * rng.randn(hy.v_dims, cs.FFM_K)).astype(np.float32),
         "v_gg": rng.uniform(50, 150, hy.v_dims).astype(np.float32),
         "touched": np.zeros(nf, np.int8), "step": 0}, dev)
    f_args = [cs.torch_on(a, dev) for a in (
        f_idx, np.ones(f_idx.shape, np.float32), f_fld.astype(np.int64),
        f_y)]
    out["ffm step"] = lambda: ffm_step(st_m, *f_args)

    n = min(cs.MXU_N, dims // 8)
    ids_np = cs.workload_ids(rng, n, dims).astype(np.int32)
    ids_np[::97] = dims  # pad lanes, as a block's
    ids = torch.from_numpy(ids_np).to(dev)
    table = torch.from_numpy(rng.randn(dims, cs.MXU_C).astype(np.float32)) \
        .to(dev)
    upd = torch.from_numpy(rng.randn(n, cs.MXU_C).astype(np.float32)).to(dev)
    plan = this_mxu.make_plan(ids, dims)
    out["scatter_add"] = lambda: sys.modules[MODULE].scatter_add(
        table, ids, upd, plan)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default=None,
                    help="another ops/mxu_scatter.py")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dims", type=int, default=cs.FULL_DIMS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    smi = None
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(f"[mxu] {torch.cuda.get_device_name(0)}; torch "
              f"{torch.__version__}; {smi}")
    mods = {"this": this_mxu}
    if args.other:
        mods = {"other": load_other(args.other), **mods}
    order = list(mods) + list(mods)[::-1]
    fns = cases(dev, args.dims, args.seed)
    out = {name: [] for name in mods}
    for turn, name in enumerate(order):
        use(mods[name])
        r = {}
        for case, fn in fns.items():
            if on_card:
                eager = cs.cuda_ms(fn, REPS)
                try:
                    graph = cs.graph_ms(fn, REPS)  # graftcheck: disable=G032 (a timing capture of a different call each pass, replayed then dropped)
                except RuntimeError as e:
                    print(f"[mxu] {case}: capture failed: {e}")
                    graph = None
            else:  # a rehearsal: each call runs, nothing is timed
                fn()
                eager = graph = None
            r[case] = {"eager_ms": eager, "graph_ms": graph}
            print(f"[mxu] turn {turn} {name} {case}: " + ", ".join(
                f"{k} {v:.4f}" if v is not None else f"{k} not measured"
                for k, v in r[case].items()))
        out[name].append(r)
    use(this_mxu)
    print(json.dumps({"device": torch.cuda.get_device_name(0) if on_card
                      else "cpu", "smi": smi, **out}))


if __name__ == "__main__":
    main()
