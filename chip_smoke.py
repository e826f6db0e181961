#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hivemall_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught):
1. device  — require CUDA; print the card's name and power limit.
2. build   — build the kernels of kernels/csrc/linear_scan.cu (nvcc, at
             first use) and, alongside in a thread, the native host library
             from native/hivemall_native.cpp (g++); print the build seconds,
             the compiler line, the ptxas report and the scan's look-ahead
             depth by row width.
3. families — the scan (plan kernel + scan kernel) against its plain torch
             version on the card, for every rule form the kernel has (logress
             under each of its four eta schedules), at D=2^14, B=1000, K=32
             with pad and duplicate lanes, from a warm random state.
             Tolerance rtol 1e-4 / atol 1e-5: the kernel sums a row's lanes
             in warp-shuffle order, the plain version in torch's order, and
             1000 sequential rows carry those last-bit differences forward.
4. stress  — forwarding stress blocks at K in {8, 32, 64, 256}: one feature
             repeated at every row distance 1..depth+2, every row identical,
             and head-heavy repeats inside rows; then blocks at K=1024 and
             the widest K the scan takes (shallower depths, down to 0). The
             plan kernel equals its plain version exactly and the scan
             matches the plain version (run on the CPU) as in phase 3.
5. width   — AROW at full width (D=2^22, K=32, B=4096, log-uniform hashed
             ids): plan and scan vs their plain versions, all timed on the
             card, beside each kernel's bound and the row-serial latency
             floor of the unpipelined design (row_chain_floor, same block);
             the scan's timing instance's clock ticks per stage of a row.
6. main    — the user's path: train_arow(..., "-dims 4194304 -pallas
             -block_size 4096") on 262,144 synthetic CTR rows with the
             kernels' launch counts read around the run and the host-staging
             seconds of the same rows timed apart, then the same data with
             -mini_batch 4096; holdout accuracy/logloss, predict and
             model_rows shapes; small -pallas fits of train_arow and
             train_logistic_regr on the card held against the same fits on
             the CPU.
7. serve   — main's -pallas model frozen at f32, bf16 and int8 (block 64),
             loaded, and served by one ServingEngine each on the card
             (max_batch 512, max_width 256: 42 buckets, warmed): table
             bytes, warmup seconds and new allocator segments; scores of
             1/8/64/512/2048-row flat pre-parsed requests against
             model.predict (f32, rtol 1e-6 / atol 1e-7), the CPU engine
             (bf16) and the numpy dequantized table (int8; both rtol 1e-5 /
             atol 1e-6); holdout per precision (f32 equals main's digits);
             p50/p99 host-clock latency of 200 requests of 1/64/512 rows
             with no new allocator segment after warmup; then HTTP: f32
             deployed as ctr v1 behind serve(), 4 clients x 16 POST
             /predict of 64 string rows, a hot swap to int8 v2 mid-run,
             zero failed requests.
7b. cache — main's -pallas model deployed as ctr (f32 v1) in a
             ModelRegistry behind serve() under the JAX package's pinned
             skew workload (scripts/bench_serving.py --skew): 8 keep-alive
             clients, 2,500 POST /predict of 4 string rows drawn Zipf(1.2)
             over the bench's 8,000-row universe (at D = 2^22), a hot swap
             to the int8 artifact as v2 once a quarter has answered, on one
             seeded sequence three times: score cache off, 64 MiB and an
             evicting 128 KiB. Each run: 0 failed requests; every answer within rtol
             1e-6 / atol 1e-7 of its version's engine run uncached; every
             request sent after the swap answered by v2; all answers of one
             (version, row) the same float32 bits (a cached value is its
             leader's); resident bytes, read every 5 ms, within the budget.
             Prints p50 / p99, the hit ratio, the requests answered from the
             cache (sent minus admitted to the batcher), coalesced and
             evicted rows, resident bytes against the budget.
8. fm      — train_fm(..., "-c -dims 4194304 -factor 5 -mini_batch 4096")
             on main's 262,144 rows: seconds and rows/s, host staging timed
             apart, holdout accuracy/logloss (> 0.55), model_rows; the card
             against the CPU from one CPU-made state (a 4096-row minibatch
             block at 2^22 with and without averaging, a 2,048-row scan at
             2^22, a 3,000-row -adareg train_fm at 2^12; rtol 1e-4 / atol
             1e-5, touched exact), with the block step's time and the
             scan's rows/s on the card; the model frozen at f32, bf16 and
             int8 and served as in phase 7 (against model.predict, the CPU
             engine and numpy scoring of the dequantized tables); HTTP: the
             f32 artifact deployed as fm beside main's linear model as ctr,
             4 clients x 4 POST /predict of 64 string rows, zero failed.
             FM runs no hand-written kernel (the JAX FM step is plain XLA).
9. batch   — train_arow(..., "-dims 4194304 -batch 2048") on main's 262,144
             rows: seconds, rows/s and holdout accuracy/logloss (> 0.55)
             beside main's -mini_batch 4096 run, 0 hand-kernel launches; the
             host seconds of row staging, of plan staging
             (stage_block_plans) and of the plans' upload, each timed apart;
             the card against the CPU from one warm state drawn in numpy on
             one 4096-row block at 2^22 (2 chunks) for AROW, AdaGradRDA
             (derive_w), AROWe2 (Welford target stats) and AROW on bf16
             tables (rtol 1e-4 / atol 1e-5, touched exact); one chunk's step
             eager and as one CUDA graph beside its byte bound, with its
             device operations counted by torch.profiler; a two-chunk block
             under torch.cuda.set_sync_debug_mode("error"). The -batch path
             runs no hand-written kernel (the JAX backend is plain XLA).
10. native — the native host library (hivemall_tpu_torch/native/) on main's
             rows at D = 2^22, K = 32: ROWS/32 rows of "id:1" tokens and of
             hashed "f<id>" names parsed by the C parser == the numpy path,
             both timed; train_arow -pallas from ROWS/4 "id:1" string rows
             == the same fit from arrays, bit for bit; train_arow
             -native_scan (seconds, rows/s, holdout beside main's -pallas,
             max |dw| / |dcov| against it, state on the card); train_arow
             -batch 2048 -native_apply beside phase batch's run (plan
             staging timed apart) and one 2-chunk block against the torch
             -batch step on the card (rtol 5e-5 / atol 5e-6, touched exact);
             train_fm -c -factor 5 -eta 0.01 -native_scan beside phase fm's
             run, and on a 1,024-row prefix without repeated ids == the
             exact FM scan on the card (rtol 1e-4 / atol 1e-5); the codec on
             the -native_scan model's ids, native == Python byte for byte;
             pack_rows against hm_pack_block; the library's calls per
             binding (> 0 for the parser, both row loops and the batch
             apply) and 0 kernel launches during the native fits.
11. mf     — matrix factorization at the JAX package's MF bench shape
             (2^20 users x 2^17 items, k = 16, 131,072 log-uniform rating
             rows, ratings 1 + 4 * rand, uniform BPR negatives, 16,384
             held out): train_mf_sgd / train_mf_adagrad / train_bprmf
             -factor 16 -mini_batch 16384 -iter 2 -disable_cv with a small
             -eta0 (the defaults diverge here, shown once): seconds, rows/s,
             init and upload timed apart, holdout RMSE / pairwise accuracy;
             card == CPU on one block per trainer (rtol 2e-5 / atol 1e-6)
             and on the exact scan's first 4,096 rows (rtol 1e-5 / atol
             1e-6), touched and step exact; the SGD step eager, as one CUDA
             graph, its device operations and byte bound; train_mf_sgd's
             model frozen at f32 / bf16 / int8 with an 8-plane LSH index,
             served as /predict pairs against model.predict (f32, rtol 1e-6
             / atol 1e-7), the CPU engine (bf16) and numpy on the
             dequantized tables (int8), p50 / p99, 0 allocator segments.
11b. knn   — item-to-item neighbours over train_mf_sgd's item factors
             (131,072 x 16 f32): euclid_distance_batch and
             cosine_distance_batch of 1,024 item rows against all items on
             the card (one matmul each, TF32 refused), by CUDA events beside
             the byte bound (the 536,870,912-byte output written once plus
             the inputs at 3.35 TB/s); 64 rows within the float32 rounding
             bound of a float64 numpy computation (knn_tolerance), and card
             == the CPU port within twice it.
12. topk   — RetrievalEngine per MF precision over the 131,072 items (k 16,
             block_items 4096, max_batch 8): warmup, p50 / p99 for batches
             of 1 and 8 with queries/s and items scored/s and 0 allocator
             segments after warmup, the blocked merge == the stable argsort
             of score_catalog on the card for 64 queries (ids and f32 bits),
             card == CPU engine, the LSH probe's recall@16, one sweep eager
             / as a CUDA graph / device operations against its bound; the
             same checks over phase fm's 2^22-feature FM catalog
             (block_items 65,536, 8 queries); HTTP: the f32 artifact
             deployed with retrieval={}, 4 clients x 16 POST /topk, 0
             failed, each == the direct engine call. No hand kernel.
13. mc     — multiclass at the JAX package's bench shape (L = 26, D = 2^20,
             64 ids of value 1 a row, 131,072 rows, 16,384 held out):
             train_multiclass_arow -mini_batch 4096 (seconds, rows/s, host
             staging apart, whether its tables stay finite) and
             train_multiclass_pa1 -c 0.001 (holdout accuracy beside
             chance); card == CPU on one 4,096-row block for all nine rules
             and on the exact scan's first 512 rows (AROW, CW); the AROW
             step eager / as a CUDA graph / device ops / byte bound; the
             PA1 model frozen at f32 / bf16 / int8 and served (labels ==
             predict, scores == the CPU engine / numpy, p50 / p99, 0
             allocator segments) and over HTTP beside main's model.
14. ffm    — FFM at the JAX package's bench shape (2^20 features, 2^22 V
             rows, k = 4, 64 fields, 32 tokens; 32,768 rows, cut from
             131,072 for time): train_ffm -mini_batch 4096 unchunked and
             -row_chunk 512 on the first 16,384 rows (seconds, rows/s,
             parse and V draw apart, holdout
             logloss beside the constant's); card == CPU on one -w0 block (both tilings,
             packed V) and the scan's first 512 rows; per tiling the
             step's peak memory, eager / graph time, device ops and byte
             bound; the f32 blob artifact (bytes, freeze / load seconds),
             served == predict, and HTTP beside main's model. Phase fm also
             prints the host seconds of its V draw (JAX's stream).
15. trees  — train_randomforest_classifier -trees 16 (the bench's 32,
             cut for time) at the JAX package's
             forest bench shape (20,000 x 20 uniform rows, the
             XOR-or label of scripts/bench_forest.py) on the card and on the
             CPU: node for node on every tree, OOB errors and opscode text
             identical; -grow batched == per_tree on the card;
             train_gradient_tree_boosting_classifier -trees 16 -iters 16
             -depth 6 -seed 3 on 50,000 rows, twice on the card and once on
             the CPU: trees equal to the CPU's (counted), decision scores
             within rtol 1e-5 / atol 1e-6, the share of equal predictions,
             the two card runs bit-equal (checked: the histograms add each
             bin's lanes in a fixed order); train_randomforest_regr -trees 8 on
             integer-valued targets card == CPU node for node; then -trees
             16 on rows of the UCI Covertype data set's shape (581,012 x 54:
             10 Q + 44 one-hot C columns, 7 classes, drawn from --seed):
             fit seconds with the host binning timed apart, trees/s and
             row-trees/s, holdout accuracy on 65,536 rows beside the OOB
             error, host syncs a tree, peak memory; one level at S = 512
             (hist / split / route, eager and by CUDA events, beside each
             byte bound) and the OOB walk; both models frozen, loaded and
             served on the card (max_batch 512: artifact bytes, freeze /
             load seconds, labels == predict, p50 / p99 at 1 / 64 / 512
             rows, 0 allocator segments after warmup) and the forest over
             HTTP beside main's model (4 clients x 16, 0 failed). No hand
             kernel: the JAX trees reach no pallas_call.
16. pipeline — the continuous training pipeline (pipeline/) on the card at
             the main path's widths: AROW r=0.1 at D = 2^22, width 32,
             DriftStream batches of 4,096 (a concept phase every 131,072
             events). Run 1: 64 batches on the pipeline's worker thread
             (freeze every 65,536 events, checkpoint every 32,768, every
             8th batch to a 16,384-row holdout, a label-flip window over
             the middle freeze cycle) while 4 clients POST /predict of 64
             string rows to the same registry (max_batch 64): at least 3
             gated publishes, 2 of them hot swaps, the flip window refused
             for regression, 0 failed requests; freshness p50 / p99, the
             mean ms of the pipeline's spans, artifact and checkpoint bytes,
             the worker's rows/s, /predict p50 / p99, serving's allocator
             segments, peak memory. Run 2: 32 batches under a seeded fault
             plan (crash_mid_write, corrupt, transient_step; a checkpoint
             every 4 batches): 2 restarts, the .prev fallback fired, the
             final checkpoint at batch 32 with no lost step. Run 3: 32
             batches (cut from 48 for time) on the card and on the CPU (one checkpoint, last):
             the same gate decisions, final w / cov at rtol 1e-4 / atol
             1e-5, touched equal. No hand kernel: the pipeline trains
             in minibatch mode and reaches no pallas_call.
17. parallel — data-parallel and feature-sharded training
             (hivemall_tpu_torch/parallel/) on main's first 16 blocks
             (AROW, D = 2^22, K = 32, B = 4,096; labels +-1). (a) A world
             of one under NCCL in this process: MixTrainer (argminKLD,
             mix_every 8) and ShardedTrainer (minibatch) against the
             single-device step. (b) A world of two over gloo, both ranks
             spawned on the one card (NCCL refuses two ranks on one
             device): MixTrainer, 8 blocks a replica and one mix, against
             the argminKLD of the replicas trained alone computed in plain
             torch on the card; ShardedTrainer, 2 stripes of 2^21, 8
             minibatch blocks and a 256-row scan prefix, against the
             single-device model; Sharded2DTrainer at 1 x 2 (against the
             single-device model) and 2 x 1 (against MixTrainer);
             FMShardedTrainer (k = 5, 2 blocks from a warm state),
             MCShardedTrainer (AROW at mc's shape, one block from a warm
             state, the features of near-tie rows left out; 2 timed
             blocks) and FFMShardedTrainer (ffm's shape, one block,
             unchunked and -row_chunk 512) against their single-device
             steps; train_gbt_data_parallel on the bench GBT's rows (4
             rounds): card == the same ranks on the CPU, and against the
             single-device GBT predictions agree on 98% of rows. All at
             rtol 1e-4 / atol 1e-5, integer leaves exact. Per trainer:
             step ms (CUDA events), rows/s, collectives and bytes a step,
             ms a step inside them, peak memory per rank; the mixed
             model's holdout logloss beside the single-device one. No hand
             kernel: hivemall_tpu/parallel reaches no pallas_call.
Prints a kernels JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import subprocess
import sys
import time

import numpy as np

RTOL, ATOL = 1e-4, 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
FULL_DIMS = 1 << 22
WIDTH = 32
ROWS = 262144  # rows the main path trains on


def workload_ids(rng, shape, dims):
    """Log-uniform (head-heavy) id frequency, placed by a fixed permutation
    of the hashed space — the id distribution of the repo's CTR benchmark
    (hivemall_tpu/runtime/benchmark.py::make_workload_ids)."""
    perm = np.random.RandomState(12345).permutation(dims).astype(np.int32)
    u = rng.random_sample(shape)
    ids = np.exp(u * np.log(float(dims))).astype(np.int64) % dims
    return perm[ids]


def logress_cases():
    """(tag, rule, hyper) of logress under each eta schedule; `simple`'s
    total_steps falls inside the families block's t range."""
    from hivemall_tpu_torch.models import regression as R
    from hivemall_tpu_torch.ops import eta as E

    ests = (E.fixed(0.1), E.simple(0.1, 1500), E.invscaling(0.1, 0.1),
            E.EtaEstimator("adjusting", eta0=0.3))
    return [(f"logress/{e.kind}", R._make_logress_rule(e), R.logress_hyper(e))
            for e in ests]


def rule_cases():
    """(rule, hyper, is_binary) for every rule form the kernel has but
    logress (see logress_cases)."""
    from hivemall_tpu_torch.models import classifier as C
    from hivemall_tpu_torch.models import regression as R

    pa_regr = {"c": 1.0, "epsilon": 0.01}
    return [
        (C.PERCEPTRON, {}, True), (C.PA, {}, True), (C.PA1, {"c": 1.0}, True),
        (C.PA2, {"c": 1.0}, True), (C.CW, {"phi": 1.0}, True),
        (C.AROW, {"r": 0.1}, True), (C.AROWH, {"r": 0.1, "c": 1.0}, True),
        (C.SCW1, {"phi": 1.0, "c": 1.0}, True),
        (C.SCW2, {"phi": 1.0, "c": 1.0}, True),
        (C.ADAGRAD_RDA, {"eta": 0.1, "lambda": 1e-6, "scale": 100.0}, True),
        (R.ADAGRAD_REGR, {"eta": 1.0, "eps": 1.0, "scale": 100.0}, False),
        (R.ADADELTA_REGR, {"rho": 0.95, "eps": 1e-6, "scale": 100.0}, False),
        (R.PA1_REGR, pa_regr, False), (R.PA1A_REGR, pa_regr, False),
        (R.PA2_REGR, pa_regr, False), (R.PA2A_REGR, pa_regr, False),
        (R.AROW_REGR, {"r": 0.1}, False),
        (R.AROWE_REGR, {"r": 0.1, "epsilon": 0.01}, False),
        (R.AROWE2_REGR, {"r": 0.1, "epsilon": 0.01}, False),
    ]


def block(rng, b, k, dims):
    """A block with pad lanes (every 3rd row ends in two) and duplicate
    lanes (every 4th row repeats its first id; head-heavy ids repeat too)."""
    idx = workload_ids(rng, (b, k), dims).astype(np.int32)
    val = rng.randn(b, k).astype(np.float32)
    idx[::4, 1] = idx[::4, 0]
    idx[::3, -2:] = dims
    val[::3, -2:] = 0.0
    y = np.sign(rng.randn(b)).astype(np.float32)
    y[y == 0] = 1.0
    return idx, val, y


def warm_state(rng, rule, dims, device):
    from hivemall_tpu_torch.core.state import linear_state_from_numpy

    d = {
        "weights": (0.1 * rng.randn(dims)).astype(np.float32),
        "covars": rng.uniform(0.5, 1.5, dims).astype(np.float32)
        if rule.use_covariance else None,
        "slots": {},
        "touched": (rng.rand(dims) < 0.5).astype(np.int8),
        "step": 1000,
        "globals": {g: v for g, v in (("n", 10.0), ("mean", 0.1), ("m2", 2.0))
                    if g in rule.global_names},
    }
    for s in rule.slot_names:
        d["slots"][s] = (rng.randn(dims) if s == "sum_grad"
                         else rng.uniform(0, 1, dims)).astype(np.float32)
    return linear_state_from_numpy(d, device=device)


def compare(tag, got, ref, got_loss, ref_loss):
    """Assert kernel == plain version within tolerance; return max |err|."""
    from hivemall_tpu_torch.core.state import linear_state_to_numpy

    a, b = linear_state_to_numpy(got), linear_state_to_numpy(ref)
    pairs = [("weights", a["weights"], b["weights"]),
             ("loss", got_loss.cpu().numpy(), ref_loss.cpu().numpy())]
    if a["covars"] is not None:
        pairs.append(("covars", a["covars"], b["covars"]))
    pairs += [(f"slot {s}", a["slots"][s], b["slots"][s]) for s in b["slots"]]
    pairs += [(f"global {g}", a["globals"][g], b["globals"][g])
              for g in b["globals"]]
    err = 0.0
    for name, x, y in pairs:
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{tag}: {name}")
        err = max(err, float(np.max(np.abs(x - y))) if x.size else 0.0)
    assert np.array_equal(a["touched"], b["touched"]), f"{tag}: touched"
    assert a["step"] == b["step"], f"{tag}: step"
    return err


def cuda_ms(fn, reps):
    """Mean ms of fn() over reps, by CUDA events, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean ms of one replay of fn()'s launches captured as a CUDA graph,
    by CUDA events: the device's time for them without the host's cost of
    issuing each (warmed on a side stream first, as capture requires)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def chain_floor_ms(ti, tv, dims, reps):
    """ms per block of the library's row_chain_floor kernel on this block
    (a scratch w table): the scan's per-row dependent chain alone."""
    import torch

    from hivemall_tpu_torch.kernels.linear_scan import _library

    lib = _library()
    b, k = ti.shape
    w = torch.zeros(dims, dtype=torch.float32, device=ti.device)
    out = torch.empty(b, dtype=torch.float32, device=ti.device)
    stream = torch.cuda.current_stream(ti.device).cuda_stream

    def run():
        rc = lib.hm_row_chain_floor(ti.data_ptr(), tv.data_ptr(),
                                    out.data_ptr(), w.data_ptr(), b, k, dims,
                                    stream)
        assert rc == 0, lib.hm_cuda_error_string(rc).decode()

    ms = cuda_ms(run, reps)
    assert torch.isfinite(out).all(), "row_chain_floor: non-finite sums"
    return ms


def phase_build():
    """Build the CUDA kernels (nvcc) and, alongside them in a thread, the
    native host library (g++). Returns the native build's (compiler line,
    library path, seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    from hivemall_tpu_torch import native
    from hivemall_tpu_torch.kernels import build, linear_scan
    from hivemall_tpu_torch.native import build as native_build

    def build_native():
        t = time.perf_counter()
        path = native.library_path()
        return path, time.perf_counter() - t

    with ThreadPoolExecutor(1) as pool:
        native_job = pool.submit(build_native)
        t0 = time.perf_counter()
        lib = linear_scan._library()
        secs = time.perf_counter() - t0
        native_path, native_secs = native_job.result()
    cxx = native_build.compiler_identity(native_build.compiler())
    print(f"[build] linear_scan.cu built and loaded in {secs:.2f} s; the "
          f"native host library ({native_build.SOURCE.name}, "
          f"{' '.join(native_build.CXX_FLAGS)}) in {native_secs:.2f} s "
          f"alongside: {cxx}")
    log = build.build_logs.get("linear_scan", "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", log))
    print(f"[build] ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} "
          f"registers a thread, {spills} bytes of spills")
    arow = linear_scan.KERNEL_FORMS["arow"][0]
    print("[build] scan look-ahead (AROW) by row width: " + ", ".join(
        f"K={k}: {lib.hm_linear_scan_depth(arow, k)}"
        for k in (8, 32, 256, 1024, 2048, lib.hm_linear_scan_max_k())))
    return cxx, native_path, native_secs


def check_plan(tag, ti, dims, depth):
    """The plan kernel == its plain version, exactly; returns the plan."""
    import torch

    from hivemall_tpu_torch.kernels.linear_scan import (
        linear_scan_plan, linear_scan_plan_reference)

    got = linear_scan_plan(ti, dims, depth)
    want = linear_scan_plan_reference(ti, dims, depth)
    for name, g, w in zip(("lead", "next", "fwd"), got, want):
        assert torch.equal(g, w), f"{tag}: plan {name} differs"
    return got


def check_scan(tag, rule, hyper, idx, val, y, dims, seed, dev, ref_dev=None):
    """Plan + scan kernels vs the plain version (on `ref_dev`, default the
    card) on one block from a warm state; returns max |err|."""
    import torch

    from hivemall_tpu_torch.kernels.linear_scan import (
        linear_scan, linear_scan_reference, scan_depth)

    ti, tv, ty = (torch.from_numpy(a).to(dev) for a in (idx, val, y))
    check_plan(tag, ti, dims, scan_depth(rule, idx.shape[1]))
    st_k = warm_state(np.random.RandomState(seed), rule, dims, dev)
    ref_dev = ref_dev or dev
    st_r = warm_state(np.random.RandomState(seed), rule, dims, ref_dev)
    got, got_loss = linear_scan(rule, hyper, st_k, ti, tv, ty)
    torch.cuda.synchronize()
    ref, ref_loss = linear_scan_reference(
        rule, hyper, st_r, *(t.to(ref_dev) for t in (ti, tv, ty)))
    return compare(tag, got, ref, got_loss, ref_loss)


def phase_families(seed, dev):
    import torch

    from hivemall_tpu_torch.kernels.linear_scan import linear_scan

    dims, b, k = 1 << 14, 1000, WIDTH
    err = 0.0
    cases = [(r.name, r, h, binary) for r, h, binary in rule_cases()]
    cases += [(tag, r, h, False) for tag, r, h in logress_cases()]
    for i, (tag, rule, hyper, binary) in enumerate(cases):
        rng = np.random.RandomState(seed + i)
        idx, val, y = block(rng, b, k, dims)
        if not binary:
            y = (0.3 * rng.randn(b)).astype(np.float32)
        e = check_scan(tag, rule, hyper, idx, val, y, dims, seed + 100 + i,
                       dev)
        err = max(err, e)
        print(f"[families] {tag:20s} kernel == plain  max|err| {e:.3g}")
    # the row chain with tables resident in L1/L2: AROW at D=2^14
    rule, hyper, _ = rule_cases()[5]
    rng = np.random.RandomState(seed)
    idx, val, y = block(rng, b, k, dims)
    ti, tv, ty = (torch.from_numpy(a).to(dev) for a in (idx, val, y))
    st = warm_state(rng, rule, dims, dev)
    ms = cuda_ms(lambda: linear_scan(rule, hyper, st, ti, tv, ty), 10)
    print(f"[families] arow plan + scan kernels at D=2^14 B={b} K={k}: "
          f"{ms:.4f} ms/block = {1e3 * ms / b:.4f} us/row")
    return err


def stress_blocks(rng, b, k, dims, depth):
    """(name, idx) forwarding stress blocks: one feature at every row
    distance 1..depth+2 (lane 0, else hashed ids), every row identical, and
    head-heavy repeats inside rows (ids drawn from a few hot features)."""
    idx = workload_ids(rng, (b, k), dims).astype(np.int32)
    hot = int(idx[0, 0])
    r = 0
    for dist in range(1, depth + 3):
        r += dist
        idx[r % b, 0] = hot
    same = np.repeat(idx[1:2], b, 0)
    head = workload_ids(rng, (b, k), 4 * k).astype(np.int32)
    return [("distances", idx), ("same", same), ("head", head)]


def phase_stress(seed, dev):
    """The plain version runs on the CPU here: its index_add_ sums a
    feature's lanes in lane order there, as the kernel does, while on the
    card it adds them with atomics in no set order — which the head-heavy
    blocks (hundreds of large deltas per feature) would turn into
    differences of cancellation, not of the kernel."""
    from hivemall_tpu_torch.kernels.linear_scan import _library, scan_depth

    dims, b = 1 << 14, 256
    err = 0.0
    # cov (arow), two slots and derive_w (adagrad_rda), one slot
    # (adagrad_regr); adadelta_regr is left to phase families: at K=256 it
    # turns the row sums' order (warp shuffles vs torch) into differences
    # past the tolerance, in the unpipelined kernel's arithmetic too
    picks = [c for c in rule_cases() if c[0].name in
             ("arow", "adagrad_rda", "adagrad_regr")]
    for k in (8, 32, 64, 256):
        for rule, hyper, binary in picks:
            rng = np.random.RandomState(seed + k)
            depth = scan_depth(rule, k)
            val = (0.5 * rng.randn(b, k)).astype(np.float32)
            y = (np.sign(rng.randn(b)) if binary
                 else 0.3 * rng.randn(b)).astype(np.float32)
            for name, idx in stress_blocks(rng, b, k, dims, depth):
                e = check_scan(f"stress K={k} {rule.name} {name}", rule,
                               hyper, idx, val, y, dims, seed + 200 + k, dev,
                               ref_dev="cpu")
                err = max(err, e)
            print(f"[stress] K={k:3d} depth {depth} {rule.name:14s} "
                  f"distances/same/head: plan exact, kernel == plain")
    # the widest rows the scan takes run at a shallower depth, down to 0
    lib_max = _library().hm_linear_scan_max_k()
    for k in (1024, lib_max):
        for rule, hyper, binary in picks[:2]:
            rng = np.random.RandomState(seed + k)
            idx, val, y = block(rng, 8, k, dims)
            e = check_scan(f"wide K={k} {rule.name}", rule, hyper, idx, val,
                           y, dims, seed + 300, dev, ref_dev="cpu")
            err = max(err, e)
            print(f"[stress] K={k} depth {scan_depth(rule, k)} {rule.name}: "
                  f"plan exact, kernel == plain")
    return err


def bytes_per_block(idx, dims, n_tables):
    """Least bytes one block moves: idx+val+y read, loss written, each
    distinct live feature's table entries read once and written once."""
    b, k = idx.shape
    live = idx[(idx >= 0) & (idx < dims)]
    uniq = np.unique(live).size
    return b * k * 8 + b * 8 + uniq * n_tables * 4 * 2, uniq


def plan_compares(lead, nxt, fwd, depth):
    """Integer compares the plan kernel makes on this block (each lane's
    scans stop at their first match): the leader scan, the next-lane scan
    and the forwarding scan over earlier rows."""
    b, k = lead.shape
    lane = np.arange(k)[None, :]
    row = np.arange(b)[:, None]
    live = lead >= 0
    lead_n = np.where(lead < lane, lead + 1, lane)
    next_n = np.where(nxt >= 0, nxt - lane, k - 1 - lane)
    dist, src = fwd >> 16, fwd & 0xFFFF
    fwd_n = np.where(fwd >= 0, (dist - 1) * k + src + 1,
                     np.minimum(depth, row) * k)
    return int(np.sum(np.where(live, lead_n + next_n + fwd_n, 0)))


def phase_width(seed, dev):
    import torch

    from hivemall_tpu_torch.kernels.linear_scan import (
        _library, linear_scan, linear_scan_plan, linear_scan_plan_reference,
        linear_scan_reference, scan_depth)

    rule, hyper, _ = rule_cases()[5]  # AROW
    b = 4096
    depth = scan_depth(rule, WIDTH)
    rng = np.random.RandomState(seed + 7)
    idx, val, y = block(rng, b, WIDTH, FULL_DIMS)
    ti, tv, ty = (torch.from_numpy(a).to(dev) for a in (idx, val, y))
    plan = check_plan("arow@2^22", ti, FULL_DIMS, depth)
    st_k = warm_state(np.random.RandomState(seed + 8), rule, FULL_DIMS, dev)
    st_r = warm_state(np.random.RandomState(seed + 8), rule, FULL_DIMS, dev)
    got, got_loss = linear_scan(rule, hyper, st_k, ti, tv, ty)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, ref_loss = linear_scan_reference(rule, hyper, st_r, ti, tv, ty)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = compare("arow@2^22", got, ref, got_loss, ref_loss)

    # the scan kernel alone on the block's plan, on a scratch state
    # (launches keep training it)
    st_t = warm_state(np.random.RandomState(seed + 9), rule, FULL_DIMS, dev)
    ms = cuda_ms(lambda: linear_scan(rule, hyper, st_t, ti, tv, ty, plan=plan),
                 20)
    nbytes, uniq = bytes_per_block(idx, FULL_DIMS, n_tables=2)
    flops = b * WIDTH * 12
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    floor_ms = chain_floor_ms(ti, tv, FULL_DIMS, 20)
    print(f"[width] arow D=2^22 B={b} K={WIDTH} depth {depth}: scan kernel "
          f"{ms:.4f} ms/block ({1e3 * ms / b:.4f} us/row, "
          f"{b / ms * 1e3:.0f} rows/s), plain {plain_ms:.1f} ms/block, bound "
          f"{bound_ms:.6f} ms ({nbytes} B, {uniq} distinct ids), max|err| "
          f"{err:.3g}")
    print(f"[width] row-serial latency floor of the unpipelined design "
          f"(row_chain_floor, same block): {floor_ms:.4f} ms/block "
          f"({1e3 * floor_ms / b:.4f} us/row); the scan takes "
          f"{ms / floor_ms:.3f}x it")

    # the plan kernel: time, plain version's time, bound
    plan_ms = cuda_ms(lambda: linear_scan_plan(ti, FULL_DIMS, depth), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    linear_scan_plan_reference(ti, FULL_DIMS, depth)
    torch.cuda.synchronize()
    plan_plain_ms = 1e3 * (time.perf_counter() - t0)
    lead, nxt, fwd = (t.cpu().numpy() for t in plan)
    compares = plan_compares(lead, nxt, fwd, depth)
    plan_bytes = b * WIDTH * 4 * 4  # idx read, three tables written
    plan_bound = 1e3 * max(plan_bytes / HBM_BYTES_PER_S, compares / FP32_FLOPS)
    plan_by = ("bytes" if plan_bytes / HBM_BYTES_PER_S >= compares / FP32_FLOPS
               else "operations")
    print(f"[width] plan kernel: {plan_ms:.4f} ms/block, plain "
          f"{plan_plain_ms:.2f} ms, bound {plan_bound:.6f} ms by {plan_by} "
          f"({plan_bytes} B, {compares} compares)")

    # the scan's timing instance: clock ticks of each stage of a row
    lib = _library()
    stages = lib.hm_linear_scan_stage_names().decode().split(",")
    cycles = torch.zeros(len(stages), dtype=torch.int64, device=dev)
    st_c = warm_state(np.random.RandomState(seed + 9), rule, FULL_DIMS, dev)
    linear_scan(rule, hyper, st_c, ti, tv, ty, plan=plan, stage_cycles=cycles)
    torch.cuda.synchronize()
    per_row = {n: round(float(c) / b, 1)
               for n, c in zip(stages, cycles.cpu().tolist())}
    print(f"[width] scan clock ticks per row by stage (lane 0, timing "
          f"instance): {json.dumps(per_row)}; total "
          f"{sum(per_row.values()):.1f}")
    scan = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "latency_floor_ms": floor_ms, "err": err}
    plan_k = {"ms": plan_ms, "plain_ms": plan_plain_ms, "bound_ms": plan_bound,
              "bound_by": plan_by}
    return scan, plan_k


def stage_rows_secs(feats, y, dims, block_size):
    """Host seconds to stage and pack these rows into blocks, the fit's
    host work before each block's copy to the card (`_stage_rows` and
    `iter_blocks`)."""
    from hivemall_tpu_torch.core.batch import iter_blocks, pad_to_bucket
    from hivemall_tpu_torch.models.base import _stage_rows

    t0 = time.perf_counter()
    idx_rows, val_rows = _stage_rows(feats, dims)
    width = pad_to_bucket(max(len(r) for r in idx_rows))
    for _ in iter_blocks(idx_rows, val_rows, y, dims, block_size, width):
        pass
    return time.perf_counter() - t0


def ctr_rows(rng, n, dims, w_true):
    """Synthetic CTR rows: 32 hashed ids of value 1.0, label from a hidden
    linear model (logistic noise)."""
    idx = workload_ids(rng, (n, WIDTH), dims)
    logit = w_true[idx].sum(axis=1)
    y = (logit + rng.logistic(size=n) > 0).astype(np.float32)
    return idx, np.ones((n, WIDTH), np.float32), y


def log_loss_acc(score, y):
    """(accuracy, logloss) of margin scores against 0/1 labels."""
    p = 1.0 / (1.0 + np.exp(-np.clip(score, -30, 30)))
    acc = float(np.mean((score > 0) == (y > 0)))
    ll = float(-np.mean(y * np.log(np.clip(p, 1e-7, 1)) +
                        (1 - y) * np.log(np.clip(1 - p, 1e-7, 1))))
    return acc, ll


def holdout(model, idx, val, y):
    score = model.predict((list(idx), list(val)))
    assert score.shape == (len(y),) and np.all(np.isfinite(score)), \
        "predict: bad scores"
    return log_loss_acc(score, y)


def main_data(seed):
    """The main path's data: the hidden model, ROWS training rows and
    32,768 held-out rows of synthetic CTR (phases main and fm)."""
    rng = np.random.RandomState(seed + 11)
    w_true = (rng.randn(FULL_DIMS) * 0.5).astype(np.float32)
    train = ctr_rows(rng, ROWS, FULL_DIMS, w_true)
    return w_true, train, ctr_rows(rng, 32768, FULL_DIMS, w_true)


def phase_main(seed, dev, data):
    import torch

    from hivemall_tpu_torch.kernels.linear_scan import LAUNCHES
    from hivemall_tpu_torch.models.classifier import train_arow
    from hivemall_tpu_torch.models.regression import train_logistic_regr

    w_true, (idx, val, y), (h_idx, h_val, h_y) = data
    feats = (list(idx), list(val))
    out = {}
    staging = stage_rows_secs(feats, y, FULL_DIMS, 4096)
    for name, opts in (("pallas", "-dims 4194304 -pallas -block_size 4096"),
                       ("mini_batch", "-dims 4194304 -mini_batch 4096")):
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = train_arow(feats, y, opts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        acc, ll = holdout(model, h_idx, h_val, h_y)
        feats_out, w_out, c_out = model.model_rows()
        assert feats_out.shape == w_out.shape == c_out.shape, "model_rows"
        assert np.all(np.isfinite(w_out)) and np.all(c_out > 0), "model_rows"
        print(f"[main] train_arow {opts}: {ROWS} rows in {secs:.3f} s = "
              f"{ROWS / secs:.0f} rows/s; holdout acc {acc:.4f} logloss "
              f"{ll:.4f}; kernel launches {launches}; model_rows "
              f"{feats_out.shape[0]}")
        out[name] = (launches, acc, ll, secs)
        if name == "pallas":
            served = (model, (h_idx, h_val, h_y), (acc, ll))
    print(f"[main] host staging of the same {ROWS} rows (_stage_rows + "
          f"iter_blocks, timed apart): {staging:.3f} s")
    assert all(n > 0 for n in out["pallas"][0].values()), \
        "the -pallas run skipped a kernel"
    assert not any(out["mini_batch"][0].values())
    for name, (_, acc, _, _) in out.items():
        assert acc > 0.55, f"{name}: holdout accuracy {acc} is near chance"

    # a small -pallas fit on the card against the same fit on the CPU
    rng = np.random.RandomState(seed + 12)
    s_idx, _, s_y = ctr_rows(rng, 3000, 1 << 12, w_true[:1 << 12])
    small = (list(s_idx), list(rng.randn(3000, WIDTH).astype(np.float32)))
    m_gpu = train_arow(small, s_y, "-dims 4096 -pallas -block_size 1024")
    m_cpu = train_arow(small, s_y, "-dims 4096 -pallas -block_size 1024",
                       device="cpu")
    np.testing.assert_allclose(m_gpu.state.weights.cpu().numpy(),
                               m_cpu.state.weights.numpy(), rtol=RTOL,
                               atol=ATOL, err_msg="small fit: weights")
    np.testing.assert_allclose(m_gpu.state.covars.cpu().numpy(),
                               m_cpu.state.covars.numpy(), rtol=RTOL,
                               atol=ATOL, err_msg="small fit: covars")
    print("[main] small train_arow -pallas fit: card == CPU")

    # logress, the repo's default regressor, through the kernel on the card
    s_t = (rng.rand(3000) < 0.3).astype(np.float32)
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    opts = "-dims 4096 -pallas -block_size 1024 -eta0 0.5"
    m_gpu = train_logistic_regr(small, s_t, opts)
    torch.cuda.synchronize()
    launched = LAUNCHES["linear_scan"]
    assert launched > 0, "train_logistic_regr -pallas launched no kernel"
    m_cpu = train_logistic_regr(small, s_t, opts, device="cpu")
    np.testing.assert_allclose(m_gpu.state.weights.cpu().numpy(),
                               m_cpu.state.weights.numpy(), rtol=RTOL,
                               atol=ATOL, err_msg="logress fit: weights")
    print(f"[main] small train_logistic_regr -pallas fit: {launched} scan "
          f"launches; card == CPU")
    return out["pallas"][0], out["mini_batch"][1:], served, \
        out["pallas"][1:]


SERVE_SIZES = (1, 8, 64, 512, 2048)  # request rows; 2048 chunks at 512
LATENCY_SIZES = (1, 64, 512)
LATENCY_REQUESTS = 200


def flat_rows(idx, val, s, n):
    """Rows [s, s+n) of a [N, K] block in the engine's flat pre-parsed
    request form (flat ids, flat values, row lengths)."""
    k = idx.shape[1]
    return (idx[s:s + n].ravel(), val[s:s + n].ravel(),
            np.full(n, k, np.int64))


def percentile_ms(secs, q):
    return 1e3 * float(np.percentile(np.asarray(secs), q))


def serve_http(paths, rows, want, dev):
    """Deploy f32 as ctr v1, serve it on 127.0.0.1:0, run 4 client threads
    x 16 POST /predict of 64 string rows each, hot-swap to the int8
    artifact as v2 while they run; every answer must be whole and match
    its version's engine scores. Returns (answers by version, seconds)."""
    import threading
    import urllib.request

    from hivemall_tpu_torch.serving import ModelRegistry, serve

    registry = ModelRegistry(max_batch=512, max_delay_ms=2.0, device=dev,
                             engine_kwargs={"max_batch": 512,
                                            "max_width": 256})
    server = serve(registry, host="127.0.0.1", port=0)
    port = server.server_address[1]
    answers, errors = [], []
    answered, swapped = threading.Event(), threading.Event()

    def client(c):
        for i in range(16):
            if i == 8:  # the second half of every client's requests waits
                swapped.wait(timeout=300)  # for v2 to be published
            s = (c * 16 + i) * 64 % (len(rows) - 64)
            body = json.dumps({"model": "ctr",
                               "instances": rows[s:s + 64]}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=body,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    answers.append((s, json.loads(r.read())))
            except Exception as e:  # collected and asserted below
                errors.append(repr(e))
            answered.set()

    try:
        registry.deploy("ctr", paths["float32"], version="1")
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        # the hot swap, once v1 has answered: v2 loads and warms while the
        # clients' first halves run against v1
        assert answered.wait(timeout=120), "no /predict answered"
        registry.deploy("ctr", paths["int8"], version="2")
        swapped.set()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "an HTTP client hung"
        secs = time.perf_counter() - t0
        models = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/models", timeout=60).read())["models"]
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=60).read().decode()
    finally:
        server.shutdown()
        server.server_close()
        registry.shutdown()
    assert not errors, f"failed requests: {errors[:3]}"
    assert len(answers) == 64, f"{len(answers)} of 64 requests answered"
    by_version = {}
    for s, out in answers:
        dtype = {"1": "float32", "2": "int8"}[out["version"]]
        np.testing.assert_allclose(
            np.asarray(out["predictions"], np.float32), want[dtype][s:s + 64],
            rtol=1e-6, atol=1e-7, err_msg=f"/predict v{out['version']}")
        by_version[out["version"]] = by_version.get(out["version"], 0) + 1
    assert set(by_version) == {"1", "2"}, f"versions served: {by_version}"
    assert [(m["name"], m["version"], m["weights_dtype"]) for m in models] \
        == [("ctr", "2", "int8")], f"/models: {models}"
    assert "hivemall_tpu_serving_ctr_rows" in metrics, "/metrics: no ctr"
    return by_version, secs


PRECISIONS = (("float32", None), ("bfloat16", "bf16"), ("int8", "int8"))
SERVE_TOL = {"float32": (1e-6, 1e-7), "bfloat16": (1e-5, 1e-6),
             "int8": (1e-5, 1e-6)}


def frozen_engines(model, tmp, name, label, tag, dev):
    """Freeze ``model`` at f32, bf16 and int8 (block 64) under ``tmp``,
    load each and warm one engine ``<tag>_<dtype>`` on ``dev`` (max_batch
    512, max_width 256: 42 buckets); print the seconds, table bytes and
    new allocator segments of each. Returns (paths, artifacts, engines) by
    dtype."""
    import torch

    from hivemall_tpu_torch.serving import ServingEngine, freeze, load

    paths, arts, engines = {}, {}, {}
    for dtype, q in PRECISIONS:
        paths[dtype] = f"{tmp}/{name}_{dtype}"
        t0 = time.perf_counter()
        freeze(model, paths[dtype], name=name, quantize=q,
               quant_block_rows=64 if q == "int8" else None)
        t1 = time.perf_counter()
        arts[dtype] = load(paths[dtype])
        t2 = time.perf_counter()
        eng = ServingEngine(arts[dtype], name=f"{tag}_{dtype}", max_batch=512,
                            max_width=256, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        segs = eng.warmup()
        t4 = time.perf_counter()
        assert eng.weights_dtype == dtype
        assert len(eng.warmed_buckets) == 42
        print(f"[{label}] {dtype}: freeze {t1 - t0:.3f} s, load "
              f"{t2 - t1:.3f} s, to the card {t3 - t2:.3f} s; "
              f"table_bytes {eng.table_bytes}; warmup of "
              f"{len(eng.warmed_buckets)} buckets (batch "
              f"{eng.batch_buckets()} x width {eng.width_buckets()}) "
              f"{t4 - t3:.3f} s, {segs} new allocator segments")
        engines[dtype] = eng
    return paths, arts, engines


def check_served(label, engines, want, h_idx, h_val, h_y):
    """Scores of every engine at SERVE_SIZES rows against its precision's
    reference (SERVE_TOL); prints the largest |diff| and the holdout.
    Returns {dtype: (acc, logloss)}."""
    out = {}
    for dtype, eng in engines.items():
        rtol, atol = SERVE_TOL[dtype]
        errs = []
        for n in SERVE_SIZES:
            got = eng.predict(flat_rows(h_idx, h_val, 0, n))
            assert got.shape == (n,) and np.all(np.isfinite(got))
            ref = want[dtype][:n]
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                       err_msg=f"{label} {dtype} at {n} rows")
            errs.append(float(np.max(np.abs(got - ref))))
        full = eng.predict(flat_rows(h_idx, h_val, 0, len(h_y)))
        out[dtype] = log_loss_acc(full, h_y)
        print(f"[{label}] {dtype}: served == reference at "
              f"{list(SERVE_SIZES)} rows (rtol {rtol:g}, atol {atol:g}), "
              f"largest |diff| {max(errs):.3g}; holdout of {len(h_y)} rows "
              f"acc {out[dtype][0]:.4f} logloss {out[dtype][1]:.4f}")
    return out


def latency_report(label, tag, engines, h_idx, h_val):
    """p50/p99 host-clock latency of LATENCY_REQUESTS one-at-a-time
    requests per size and precision, the tracer's stage means, and no new
    allocator segment after warmup."""
    from hivemall_tpu_torch.runtime.metrics import REGISTRY
    from hivemall_tpu_torch.runtime.tracing import TRACER

    rng = np.random.RandomState(5)
    for dtype, eng in engines.items():
        counter = REGISTRY.counter(
            "allocator", f"new_segments.serving.{tag}_{dtype}")
        before = counter.value
        line, stages = [], []
        for n in LATENCY_SIZES:
            TRACER.clear()
            secs = []
            for s in rng.randint(0, len(h_idx) - n, size=LATENCY_REQUESTS):
                req = flat_rows(h_idx, h_val, int(s), n)
                t0 = time.perf_counter()
                eng.predict(req)
                secs.append(time.perf_counter() - t0)
            line.append(f"{n} rows p50 {percentile_ms(secs, 50):.4f} / "
                        f"p99 {percentile_ms(secs, 99):.4f} ms")
            br = TRACER.stage_breakdown()
            stages.append(f"{n} rows " + ", ".join(
                f"{k[7:]} {br[k]['mean_ms']:.4f}" for k in
                ("engine.bucket", "engine.pad", "engine.dispatch",
                 "engine.block")))
        assert counter.value == before, \
            f"{label} {dtype}: {counter.value - before} allocator segments " \
            f"after warmup"
        print(f"[{label}] {dtype} latency over {LATENCY_REQUESTS} requests "
              f"each: " + "; ".join(line) + "; new allocator segments "
              f"after warmup: 0")
        print(f"[{label}] {dtype} mean ms by stage (tracer spans): "
              + "; ".join(stages))


def string_rows(h_idx, h_val, n):
    """The first n held-out rows as "id:value" strings (the HTTP form)."""
    return [[f"{i}:{v:g}" for i, v in zip(r, vr)]
            for r, vr in zip(h_idx[:n].tolist(), h_val[:n].tolist())]


def phase_serve(served, dev, smi):
    """Freeze main's -pallas model at f32, bf16 and int8, load each, serve
    each from a bucketed engine on ``dev`` and over HTTP with a hot swap;
    hold the scores against model.predict, the CPU engine and the numpy
    dequantized table."""
    import tempfile

    from hivemall_tpu_torch.io.checkpoint import dequantize_int8
    from hivemall_tpu_torch.runtime.metrics import alloc_segment_guard
    from hivemall_tpu_torch.serving import ServingEngine

    model, (h_idx, h_val, h_y), main_holdout = served
    h_idx = np.ascontiguousarray(h_idx, np.int64)
    h_val = np.ascontiguousarray(h_val, np.float32)
    live = model.predict((list(h_idx), list(h_val)))
    print(f"[serve] card: {smi}")
    with tempfile.TemporaryDirectory(prefix="hivemall_serve_") as tmp:
        paths, arts, engines = frozen_engines(model, tmp, "ctr", "serve",
                                              "smoke", dev)
        cpu = ServingEngine(arts["bfloat16"], name="smoke_bf16_cpu",
                            max_batch=512, max_width=256, device="cpu")
        w = dequantize_int8(arts["int8"].arrays["weight"],
                            arts["int8"].arrays["weight__scale"], 64)
        want = {"float32": live,
                "bfloat16": cpu.predict(flat_rows(h_idx, h_val, 0, 2048)),
                "int8": np.sum(w[h_idx] * h_val, axis=1, dtype=np.float32)}
        expect = {"float32": 4 * FULL_DIMS, "bfloat16": 2 * FULL_DIMS,
                  "int8": FULL_DIMS + 4 * (FULL_DIMS // 64)}
        for dtype, eng in engines.items():
            assert eng.table_bytes == expect[dtype], \
                f"{dtype}: table_bytes {eng.table_bytes}"

        # scores at each request size, against each precision's reference
        acc, ll = check_served("serve", engines, want, h_idx, h_val,
                               h_y)["float32"]
        assert f"{acc:.4f} {ll:.4f}" == \
            f"{main_holdout[0]:.4f} {main_holdout[1]:.4f}", \
            "f32 serving moved main's holdout digits"

        # latency: one request at a time, host clock around predict, which
        # ends in the .cpu() copy of the scores
        latency_report("serve", "smoke", engines, h_idx, h_val)
        t0 = time.perf_counter()
        for _ in range(1000):
            with alloc_segment_guard("smoke_guard_cost", dev):
                pass
        print(f"[serve] alloc_segment_guard enter+exit: "
              f"{1e3 * (time.perf_counter() - t0):.4f} us each (1000 on the "
              f"host clock)")

        # HTTP: strings of the held-out rows, scored against the engines
        rows = string_rows(h_idx, h_val, 4096)
        ref = {d: engines[d].predict(flat_rows(h_idx, h_val, 0, 4096))
               for d in ("float32", "int8")}
        by_version, secs = serve_http(paths, rows, ref, dev)
        print(f"[serve] HTTP: 4 clients x 16 POST /predict of 64 string rows "
              f"in {secs:.3f} s with a hot swap f32 v1 -> int8 v2 mid-run: "
              f"0 failed, answers by version {by_version}; /models names v2 "
              f"int8; /metrics carries serving.ctr.*")


# the reference's pinned skew workload (scripts/bench_serving.py --skew:
# the Zipf exponent at :2356, the full-size universe, request width,
# concurrency, requests a trial and budget at :2466-2478)
CACHE_ZIPF = 1.2
CACHE_UNIVERSE = 8000  # distinct rows the Zipf mass spreads over
CACHE_K = 4  # rows a request
CACHE_CLIENTS = 8
CACHE_REQUESTS = 2500  # a run; the second half waits for v2
CACHE_BUDGETS = (("off", None), ("64 MiB", 64 << 20), ("128 KiB", 128 << 10))


def cache_universe(seed):
    """The bench's row universe (scripts/bench_serving.py:1872-1876) at
    D = FULL_DIMS: 4-13 "id:value" features a row, values to 3 places."""
    rng = np.random.RandomState(seed + 17)
    return [[f"{rng.randint(FULL_DIMS)}:{rng.rand():.3f}"
             for _ in range(rng.randint(4, 14))]
            for _ in range(CACHE_UNIVERSE)]


def cache_requests(seed):
    """[CACHE_REQUESTS, CACHE_K] universe rows, drawn i.i.d. with p(rank r)
    ~ r^-CACHE_ZIPF, as the bench's _zipf_probs / _zipf_stream draw them
    (scripts/bench_serving.py:1711-1727)."""
    p = np.arange(1, CACHE_UNIVERSE + 1, dtype=np.float64) ** -CACHE_ZIPF
    rng = np.random.RandomState(seed + 100)
    return rng.choice(CACHE_UNIVERSE, size=(CACHE_REQUESTS, CACHE_K),
                      p=p / p.sum())


def cache_run(paths, requests, rows, budget, dev):
    """One run of the seeded traffic: a registry on ``dev`` with ``budget``
    bytes of score cache (None: off) serves f32 as ctr v1 behind serve();
    CACHE_CLIENTS keep-alive clients take the requests in order from one
    queue (the bench's closed loop) and POST /predict; once a quarter have
    answered, the int8 artifact is deployed as v2, and the second half of
    the requests waits for it. A monitor reads the cache's resident bytes
    every 5 ms. Returns what the run saw."""
    import http.client
    import threading
    import urllib.request

    from hivemall_tpu_torch.runtime.metrics import REGISTRY
    from hivemall_tpu_torch.serving import ModelRegistry, serve

    registry = ModelRegistry(max_batch=64, max_delay_ms=1.0, device=dev,
                             score_cache_bytes=budget,
                             engine_kwargs={"max_batch": 64,
                                            "max_width": 32})
    server = serve(registry, host="127.0.0.1", port=0)
    port = server.server_address[1]
    accepted = REGISTRY.counter("serving", "ctr.batcher.accepted")
    out = {"answers": [], "secs": [], "errors": [], "peak": 0}
    lock = threading.Lock()
    queue = iter(enumerate(requests))
    answered = [0]
    quarter, swapped, done = (threading.Event(), threading.Event(),
                              threading.Event())

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            while True:
                with lock:
                    i, ids = next(queue, (None, None))
                if ids is None:
                    return
                if i >= CACHE_REQUESTS // 2:
                    swapped.wait(timeout=300)
                after = swapped.is_set()  # sent after deploy(v2) returned
                body = json.dumps({"model": "ctr",
                                   "instances": [rows[r] for r in ids]})
                t0 = time.perf_counter()
                try:
                    conn.request("POST", "/predict", body,
                                 {"Content-Type": "application/json"})
                    r = conn.getresponse()
                    data = r.read()
                    dt = time.perf_counter() - t0
                    if r.status != 200:
                        out["errors"].append(f"HTTP {r.status}: {data[:200]!r}")
                    else:
                        ans = json.loads(data)
                        with lock:
                            out["secs"].append(dt)
                            out["answers"].append(
                                (ids, ans["version"], ans["predictions"],
                                 after))
                except Exception as e:  # collected and asserted below
                    out["errors"].append(repr(e))
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=120)
                with lock:
                    answered[0] += 1
                    if answered[0] >= CACHE_REQUESTS // 4:
                        quarter.set()
        finally:
            conn.close()

    def monitor():
        while not done.wait(0.005):
            entry = registry.get("ctr")
            if entry is not None and entry.cache is not None:
                out["peak"] = max(out["peak"],
                                  entry.cache.stats()["resident_bytes"])

    threads = [threading.Thread(target=client)
               for _ in range(CACHE_CLIENTS)]
    mon = threading.Thread(target=monitor)
    try:
        out["entries"] = [registry.deploy("ctr", paths["float32"],
                                          version="1")]
        base = accepted.value
        # the cache's counters are process-wide (serving.ctr.cache.*):
        # this run's are the change over it
        cache = out["entries"][0].cache
        before = cache.stats() if cache is not None else None
        mon.start()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        assert quarter.wait(timeout=300), "a quarter of the requests hung"
        out["entries"].append(registry.deploy("ctr", paths["int8"],
                                              version="2"))
        swapped.set()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "an HTTP client hung"
        out["wall"] = time.perf_counter() - t0
        out["admitted"] = accepted.value - base
        done.set()
        mon.join(timeout=60)
        out["models"] = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/models", timeout=60).read())["models"]
        out["stats"] = None
        if cache is not None:
            st = cache.stats()
            for key in ("hit_rows", "miss_rows", "coalesced_rows",
                        "evicted_entries"):
                st[key] -= before[key]
            st["hit_ratio"] = round(
                st["hit_rows"] / (st["hit_rows"] + st["miss_rows"]), 4)
            out["stats"] = st
    finally:
        swapped.set()
        done.set()
        server.shutdown()
        server.server_close()
        registry.shutdown()
    return out


def cache_checks(tag, run, ref, budget):
    """0 failed; every answer within SERVE_TOL["float32"] of its version's
    uncached engine scores; a request sent after the swap answered by v2;
    every answer of one (version, row) the same float32 bits; resident
    bytes within the budget. Returns the distinct (version, row) count."""
    assert not run["errors"], f"{tag}: failed requests {run['errors'][:3]}"
    assert len(run["answers"]) == CACHE_REQUESTS, \
        f"{tag}: {len(run['answers'])} answers"
    rtol, atol = SERVE_TOL["float32"]
    bits = {}
    for ids, version, preds, after in run["answers"]:
        got = np.asarray(preds, np.float32)
        assert got.shape == ids.shape and np.all(np.isfinite(got))
        assert version == "2" or not after, \
            f"{tag}: a request sent after the swap answered by v{version}"
        np.testing.assert_allclose(got, ref[version][ids], rtol=rtol,
                                   atol=atol, err_msg=f"{tag} v{version}")
        for r, g in zip(ids.tolist(), got.view(np.uint32).tolist()):
            bits.setdefault((version, r), set()).add(g)
    versions = {v for v, _ in bits}
    assert versions == {"1", "2"}, f"{tag}: versions served {versions}"
    split = sum(len(b) > 1 for b in bits.values())
    assert split == 0, f"{tag}: {split} (version, row) pairs answered " \
        f"with different float32 bits"
    model = run["models"][0]
    if budget is None:
        assert model["cache"] == {"enabled": False}
    else:
        st = run["stats"]
        assert model["cache"]["enabled"]
        assert model["cache"]["budget_bytes"] == budget
        assert run["peak"] <= budget and st["resident_bytes"] <= budget, \
            f"{tag}: resident bytes {run['peak']} over the budget {budget}"
        assert st["inflight_keys"] == 0
    return len(bits)


def phase_cache(seed, dev, smi, served):
    """Main's -pallas model as ctr (f32 v1, int8 v2) behind serve() under
    the reference's pinned skew workload (Zipf(1.2) over the bench's 8,000
    rows, 4 rows a request, 8 clients), with the score cache off, at 64 MiB
    and at an evicting 128 KiB, on one seeded request sequence."""
    import tempfile

    from hivemall_tpu_torch.serving import freeze

    model = served[0]
    universe = cache_universe(seed)
    requests = cache_requests(seed)
    used = np.unique(requests)
    rows = {int(r): universe[r] for r in used}
    print(f"[cache] card: {smi}; {CACHE_CLIENTS} clients, "
          f"{CACHE_REQUESTS} POST /predict of {CACHE_K} rows drawn "
          f"Zipf({CACHE_ZIPF}) over the bench's {CACHE_UNIVERSE} rows "
          f"({len(used)} distinct; scripts/bench_serving.py --skew); hot "
          f"swap f32 v1 -> int8 v2 after a quarter")
    result = {}
    with tempfile.TemporaryDirectory(prefix="hivemall_cache_") as tmp:
        paths = {}
        for dtype, q in (("float32", None), ("int8", "int8")):
            paths[dtype] = f"{tmp}/ctr_{dtype}"
            freeze(model, paths[dtype], name="ctr", quantize=q,
                   quant_block_rows=64 if q == "int8" else None)
        for label, budget in CACHE_BUDGETS:
            run = cache_run(paths, requests, rows, budget, dev)
            # each version's engine, uncached, over every requested row
            ref = {}
            for e in run["entries"]:
                ref[e.version] = np.full(CACHE_UNIVERSE, np.nan, np.float32)
                ref[e.version][used] = e.engine.predict(
                    [universe[r] for r in used])
            pairs = cache_checks(f"cache {label}", run, ref, budget)
            line = (f"[cache] {label}: {CACHE_REQUESTS} requests in "
                    f"{run['wall']:.3f} s, 0 failed, /predict p50 "
                    f"{percentile_ms(run['secs'], 50):.4f} / p99 "
                    f"{percentile_ms(run['secs'], 99):.4f} ms; "
                    f"{run['admitted']} requests admitted to the batcher, "
                    f"{CACHE_REQUESTS - run['admitted']} answered from the "
                    f"cache; {pairs} (version, row) pairs, each answered "
                    f"with one float32 value == its version's uncached "
                    f"engine (rtol 1e-6, atol 1e-7)")
            st = run["stats"]
            if st is not None:
                line += (f"; hit ratio {st['hit_ratio']} ({st['hit_rows']} "
                         f"hit / {st['miss_rows']} miss rows), "
                         f"{st['coalesced_rows']} coalesced rows, "
                         f"{st['evicted_entries']} evicted, "
                         f"{st['entries']} entries, resident "
                         f"{st['resident_bytes']} B (peak {run['peak']}) of "
                         f"{budget} B")
            print(line)
            result[label] = run
    on, off = result["64 MiB"], result["off"]
    assert off["admitted"] == CACHE_REQUESTS
    assert on["admitted"] < off["admitted"], "the cache answered nothing"


FM_FACTORS = 5
FM_SCAN_ROWS = 2048


def fm_compare(tag, got, ref):
    """FM state on the card == the same run on the CPU (RTOL/ATOL on the
    float fields, touched and step exact); returns max |err|."""
    from hivemall_tpu_torch.models.fm import fm_state_to_numpy

    a, b = fm_state_to_numpy(got), fm_state_to_numpy(ref)
    err = 0.0
    for k in ("w0", "w", "v", "lambda_w0", "lambda_w", "lambda_v"):
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{tag}: {k}")
        err = max(err, float(np.max(np.abs(a[k] - b[k]))))
    assert np.array_equal(a["touched"], b["touched"]), f"{tag}: touched"
    assert a["step"] == b["step"], f"{tag}: step"
    return err


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fm_card_vs_cpu(seed, dev, data):
    """From one state made on the CPU: a minibatch block of 4096 rows at
    D = FULL_DIMS (averaged and not), a scan of FM_SCAN_ROWS rows at
    D = FULL_DIMS, and a small -adareg train_fm scan at D = 2^12, each on
    ``dev`` and on the CPU. Returns the card's ms per minibatch block,
    eager and replayed as a CUDA graph (None off the card)."""
    from hivemall_tpu_torch.models import fm as F

    w_true, (idx, val, y), _ = data
    hyper = F.FMHyper(factors=FM_FACTORS, classification=True)
    host = F.fm_state_to_numpy(
        F.init_fm_state(FULL_DIMS, hyper, device="cpu"))
    yy = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    block_ms = None
    b = 4096
    for avg in (True, False):
        args = (idx[:b], val[:b], yy[:b], np.zeros(b, np.float32))
        out = []
        for d in (dev, "cpu"):
            step = F.make_fm_step(hyper, "minibatch", mini_batch_average=avg,
                                  device=d)
            out.append(step(F.fm_state_from_numpy(host, d), *args)[0])
        e = fm_compare(f"fm block avg={avg}", *out)
        if avg and dev.type == "cuda":  # the train path's step, timed
            step = F.make_fm_step(hyper, "minibatch", device=dev)
            st = F.fm_state_from_numpy(host, dev)
            ti, tv, ty, tva = (torch_on(a, dev) for a in args)

            def run():
                step(st, ti, tv, ty, tva)

            block_ms = (cuda_ms(run, 20), graph_ms(run, 20))
        print(f"[fm] minibatch block B={b} D={FULL_DIMS} "
              f"mini_batch_average={avg}: card == CPU, max|err| {e:.3g}")

    n = FM_SCAN_ROWS
    args = (idx[:n], val[:n], yy[:n], np.zeros(n, np.float32))
    out, secs = [], None
    for d in (dev, "cpu"):
        step = F.make_fm_step(hyper, "scan", device=d)
        st = F.fm_state_from_numpy(host, d)
        sync(dev)
        t0 = time.perf_counter()
        out.append(step(st, *args)[0])
        sync(dev)
        secs = secs or time.perf_counter() - t0
    e = fm_compare("fm scan", *out)
    print(f"[fm] scan of {n} rows D={FULL_DIMS}: card == CPU, max|err| "
          f"{e:.3g}; on the card {secs:.3f} s = {n / secs:.0f} rows/s "
          f"(plain torch ops, some 40 launches a row)")

    rng = np.random.RandomState(seed + 13)
    s_idx, _, s_y = ctr_rows(rng, 3000, 1 << 12, w_true[:1 << 12])
    small = (list(s_idx), list(rng.randn(3000, WIDTH).astype(np.float32)))
    opts = f"-c -dims 4096 -factor {FM_FACTORS} -adareg"
    m = [F.train_fm(small, s_y, opts, device=d) for d in (dev, "cpu")]
    e = fm_compare("fm adareg", m[0].state, m[1].state)
    moved = np.abs(F.fm_state_to_numpy(m[1].state)["lambda_v"][:FM_FACTORS]
                   - hyper.lambda0).max()
    assert moved > 0, "-adareg left the lambdas where they started"
    print(f"[fm] train_fm {opts} on 3000 rows: card == CPU, max|err| "
          f"{e:.3g}; lambda_v moved up to {moved:.3g}")
    return block_ms


def fm_scorer_ms(state, h_idx, h_val, dev):
    """The f32 scorer's launches for a 1-row request (batch bucket 8) and
    a 512-row one at width 32, eager and replayed as a CUDA graph."""
    from hivemall_tpu_torch.models.fm import _fm_scores

    out = []
    for b in (8, 512):
        ti, tv = torch_on(h_idx[:b], dev), torch_on(h_val[:b], dev)

        def run():
            _fm_scores(state, ti, tv)

        out.append(f"batch {b}: {cuda_ms(run, 50):.4f} eager, "
                   f"{graph_ms(run, 50):.4f} as one CUDA graph")
    print("[fm] f32 scorer on the card, ms per call (CUDA events): "
          + "; ".join(out))


def torch_on(a, dev):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def http_beside_ctr(linear_model, name, family, path, rows, want, dev,
                    per_client, max_width=256, ctr_rows=None):
    """The artifact at ``path`` deployed as ``name`` beside main's linear
    model as "ctr" in one registry behind serve(); 4 clients x
    ``per_client`` POST /predict of 64 string rows for ``name`` (and one
    of ``ctr_rows``, default ``rows``, for ctr), each answer held against
    ``want``, the direct engine's answers per row (scores at rtol 1e-6 /
    atol 1e-7, labels exactly). Returns seconds."""
    import threading
    import urllib.request

    from hivemall_tpu_torch.serving import ModelRegistry, serve

    registry = ModelRegistry(max_batch=512, max_delay_ms=2.0, device=dev,
                             engine_kwargs={"max_batch": 512,
                                            "max_width": max_width})
    server = serve(registry, host="127.0.0.1", port=0)
    port = server.server_address[1]
    answers, errors = [], []

    def post(model, s, batch=rows):
        body = json.dumps({"model": model,
                           "instances": batch[s:s + 64]}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def client(c):
        for i in range(per_client):
            s = (c * per_client + i) * 64
            try:
                answers.append((s, post(name, s)))
            except Exception as e:  # collected and asserted below
                errors.append(repr(e))

    try:
        registry.deploy("ctr", linear_model, version="1")
        registry.deploy(name, path, version="1")
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "an HTTP client hung"
        secs = time.perf_counter() - t0
        ctr = post("ctr", 0, rows if ctr_rows is None else ctr_rows)
        models = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/models", timeout=60).read())["models"]
    finally:
        server.shutdown()
        server.server_close()
        registry.shutdown()
    assert not errors, f"failed requests: {errors[:3]}"
    assert len(answers) == 4 * per_client, \
        f"{len(answers)} of {4 * per_client} requests answered"
    for s, out in answers:
        assert out["model"] == name
        if isinstance(want, np.ndarray):
            np.testing.assert_allclose(
                np.asarray(out["predictions"], np.float32), want[s:s + 64],
                rtol=1e-6, atol=1e-7, err_msg=f"/predict {name}")
        else:
            assert out["predictions"] == list(want[s:s + 64]), \
                f"/predict {name}: labels differ from the engine's"
    assert len(ctr["predictions"]) == 64 and ctr["model"] == "ctr"
    assert sorted((m["name"], m["family"]) for m in models) == \
        sorted([("ctr", "linear"), (name, family)]), f"/models: {models}"
    return secs


def phase_fm(seed, dev, smi, data, linear_model):
    """FM on the main path's rows: train_fm at D = FULL_DIMS, k = 5,
    -mini_batch 4096; the card against the CPU from one state; the model
    frozen and served at f32, bf16 and int8; /predict over HTTP beside
    main's linear model. Returns the train's (acc, logloss, seconds)."""
    import tempfile

    from hivemall_tpu_torch.io.checkpoint import dequantize_int8
    from hivemall_tpu_torch.models.fm import FMHyper, init_fm_state, train_fm
    from hivemall_tpu_torch.serving import ServingEngine

    _, (idx, val, y), (h_idx, h_val, h_y) = data
    h_idx = np.ascontiguousarray(h_idx, np.int64)
    h_val = np.ascontiguousarray(h_val, np.float32)
    print(f"[fm] card: {smi}")
    feats = (list(idx), list(val))
    opts = f"-c -dims {FULL_DIMS} -factor {FM_FACTORS} -mini_batch 4096"
    staging = stage_rows_secs(feats, y, FULL_DIMS, 4096)
    _, init_secs = timed(lambda: init_fm_state(
        FULL_DIMS, FMHyper(factors=FM_FACTORS, classification=True),
        device=dev), dev)
    sync(dev)
    t0 = time.perf_counter()
    model = train_fm(feats, y, opts, device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    acc, ll = holdout(model, h_idx, h_val, h_y)
    w0, f_out, w_out, v_out = model.model_rows()
    assert f_out.shape[0] == w_out.shape[0] == v_out.shape[0], "model_rows"
    assert v_out.shape[1] == FM_FACTORS, "model_rows: V lanes"
    assert np.isfinite(w0) and np.all(np.isfinite(w_out)) \
        and np.all(np.isfinite(v_out)), "model_rows: not finite"
    assert not model.state.v[:, FM_FACTORS:].any(), "V pad lanes moved"
    print(f"[fm] train_fm {opts}: {len(y)} rows in {secs:.3f} s = "
          f"{len(y) / secs:.0f} rows/s; host staging of the same rows "
          f"(timed apart) {staging:.3f} s; the init (timed apart: V drawn "
          f"on the host as JAX draws it, {FULL_DIMS} x {FM_FACTORS}, then "
          f"uploaded) {init_secs:.3f} s; holdout acc {acc:.4f} logloss "
          f"{ll:.4f}; model_rows {f_out.shape[0]} (finite, V pad lanes 0)")
    assert acc > 0.55, f"fm: holdout accuracy {acc} is near chance"

    block_ms = fm_card_vs_cpu(seed, dev, data)
    if block_ms is not None:
        print(f"[fm] minibatch step (the train path's, B=4096, K={WIDTH}, "
              f"D={FULL_DIMS}) on the card: {block_ms[0]:.4f} ms/block = "
              f"{4096 / block_ms[0] * 1e3:.0f} rows/s eager; the same "
              f"launches replayed as one CUDA graph (their host cost "
              f"removed): {block_ms[1]:.4f} ms/block")

    live = model.predict((list(h_idx), list(h_val)))
    with tempfile.TemporaryDirectory(prefix="hivemall_fm_") as tmp:
        paths, arts, engines = frozen_engines(model, tmp, "fm", "fm",
                                              "smoke_fm", dev)
        cpu = ServingEngine(arts["bfloat16"], name="smoke_fm_bf16_cpu",
                            max_batch=512, max_width=256, device="cpu")
        a = arts["int8"].arrays
        w = dequantize_int8(a["w"], a["w__scale"], 64).astype(np.float64)
        v = dequantize_int8(a["v"], a["v__scale"], 64).astype(np.float64)
        ri, rv = h_idx[:2048], h_val[:2048].astype(np.float64)
        vx = v[ri] * rv[..., None]
        q8 = float(a["w0"]) + np.sum(w[ri] * rv, axis=1) + 0.5 * np.sum(
            vx.sum(1) ** 2 - (vx * vx).sum(1), axis=1)
        want = {"float32": live,
                "bfloat16": cpu.predict(flat_rows(h_idx, h_val, 0, 2048)),
                "int8": q8}
        kp = model.hyper.padded_factors
        nb = FULL_DIMS // 64
        expect = {"float32": 4 * FULL_DIMS * (1 + kp),
                  "bfloat16": 2 * FULL_DIMS * (1 + kp),
                  "int8": FULL_DIMS * (1 + kp) + 4 * nb * (1 + kp)}
        for dtype, eng in engines.items():
            assert eng.table_bytes == expect[dtype], \
                f"fm {dtype}: table_bytes {eng.table_bytes}"
        served = check_served("fm", engines, want, h_idx, h_val, h_y)
        assert f"{served['float32'][0]:.4f} {served['float32'][1]:.4f}" \
            == f"{acc:.4f} {ll:.4f}", "f32 serving moved train_fm's holdout"
        latency_report("fm", "smoke_fm", engines, h_idx, h_val)
        if dev.type == "cuda":
            fm_scorer_ms(engines["float32"].servable.state, h_idx, h_val, dev)
        http_secs = http_beside_ctr(
            linear_model, "fm", "fm", paths["float32"],
            string_rows(h_idx, h_val, 1024),
            engines["float32"].predict(flat_rows(h_idx, h_val, 0, 1024)),
            dev, 4)
    print(f"[fm] HTTP: 4 clients x 4 POST /predict of 64 string rows for fm "
          f"in {http_secs:.3f} s beside the linear model ctr: 0 failed, "
          f"answers == the fm f32 engine")
    return (acc, ll, secs), model


BATCH = 2048  # -batch B of phase batch (2 chunks per 4096-row block)


@contextlib.contextmanager
def gc_clock():
    """Yields [seconds, collections] that Python's garbage collector spends
    inside the block (gc.callbacks), filled in as the block runs."""
    total = [0.0, 0]
    start = [0.0]

    def hook(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            total[0] += time.perf_counter() - start[0]
            total[1] += 1

    gc.callbacks.append(hook)
    try:
        yield total
    finally:
        gc.callbacks.remove(hook)


def stage_plans_secs(feats, y, dims, block_size, batch, dev):
    """Host seconds to build the -batch plans of these rows (the fit's
    `stage_block_plans`, once per block) and seconds to upload them to
    ``dev`` (`upload_block_plans`, ending in a synchronize), each timed
    apart from the row staging that precedes them."""
    from hivemall_tpu_torch.core.batch import iter_blocks, pad_to_bucket
    from hivemall_tpu_torch.core.batch_update import (stage_block_plans,
                                                      upload_block_plans)
    from hivemall_tpu_torch.models.base import _stage_rows

    idx_rows, val_rows = _stage_rows(feats, dims)
    width = pad_to_bucket(max(len(r) for r in idx_rows))
    blocks = [b.indices for b in iter_blocks(idx_rows, val_rows, y, dims,
                                             block_size, width)]
    t0 = time.perf_counter()
    plans = [stage_block_plans(ix, batch, dims) for ix in blocks]
    t1 = time.perf_counter()
    for p in plans:
        upload_block_plans(p, dims, dev)
    sync(dev)
    t2 = time.perf_counter()
    nbytes = sum(a.nbytes for p in plans for part in p if part is not None
                 for a in part)
    return t1 - t0, t2 - t1, nbytes, plans[0]


def batch_chunk_bytes(plan, dims, width, table_bytes):
    """Least bytes one chunk of the batch step moves on the card: the lanes'
    values and the rows' labels read, the plan read as the card holds it
    (int64: order and lane_seg per lane, rep/starts/ends per slot), each
    live unique slot's table entries read once and written once
    (``table_bytes`` a slot over all tables), the loss written."""
    n = plan.order.shape[-1]
    u = plan.rep.shape[-1]
    live = int(np.sum(plan.rep < dims))
    return (n * 4 + (n // width) * 4 + (2 * n + 3 * u) * 8
            + live * table_bytes * 2 + 4), live


def on_grid(t):
    """``t`` rounded to multiples of 2^-6 below 2 in magnitude: 7
    significant bits, exact in bf16, so on rows of value 1.0 every score
    and variance is an exact f32 sum in any order of addition."""
    return (t.clamp(-1.9, 1.9) * 64.0).round() / 64.0


def batch_card_vs_cpu(seed, dev):
    """One 4096-row block at D = FULL_DIMS (2 chunks of BATCH rows, pad and
    duplicate lanes) through the batch step on ``dev`` and on the CPU from
    one CPU-made warm state, for AROW, AdaGradRDA (derive_w), AROWe2 (the
    Welford target stats) and AROW on bf16 tables. Returns max |err|."""
    import torch

    from hivemall_tpu_torch.core.batch_update import (make_batch_train_step,
                                                      stage_block_plans)
    from hivemall_tpu_torch.models import classifier as C
    from hivemall_tpu_torch.models import regression as R

    rng = np.random.RandomState(seed + 21)
    idx, val, y = block(rng, 4096, WIDTH, FULL_DIMS)
    plans = stage_block_plans(idx, BATCH, FULL_DIMS)
    assert plans.main.order.shape[0] == 2 and plans.tail is None
    ones = np.where(idx < FULL_DIMS, 1.0, 0.0).astype(np.float32)
    cases = [
        ("arow", C.AROW, {"r": 0.1}, val, y, None),
        ("adagrad_rda", C.ADAGRAD_RDA,
         {"eta": 0.1, "lambda": 1e-6, "scale": 100.0}, val, y, None),
        ("arowe2_regr", R.AROWE2_REGR, {"r": 0.1, "epsilon": 0.01}, val,
         (0.3 * rng.randn(4096)).astype(np.float32), None),
        ("arow bf16", C.AROW, {"r": 0.1}, ones, y, torch.bfloat16),
    ]
    err = 0.0
    for i, (tag, rule, hyper, v, yy, dtype) in enumerate(cases):
        out = []
        for d in (dev, torch.device("cpu")):
            # the same numpy draw on both devices
            st = warm_state(np.random.RandomState(seed + 30 + i), rule,
                            FULL_DIMS, d)
            if dtype is not None:
                st = st.replace(weights=on_grid(st.weights).to(dtype),
                                covars=on_grid(st.covars).to(dtype))
            step = make_batch_train_step(rule, hyper, BATCH, device=d)
            out.append(step(st, idx, v, yy, plans))
            sync(dev)
        (got, got_loss), (ref, ref_loss) = out
        if dtype is not None:
            assert got.weights.dtype == ref.weights.dtype == dtype
        e = compare(f"batch {tag}", got, ref, got_loss, ref_loss)
        err = max(err, e)
        print(f"[batch] {tag}: one 4096-row block, D={FULL_DIMS}, B={BATCH} "
              f"(2 chunks): card == CPU, max|err| {e:.3g}, touched exact")
    return err


def batch_chunk_timing(seed, dev):
    """One chunk's step (AROW, BATCH rows, D = FULL_DIMS) from its uploaded
    plan: ms eager and replayed as one CUDA graph, device operations per
    chunk (torch.profiler), the chunk's byte bound; then a two-chunk block
    under torch.cuda.set_sync_debug_mode("error")."""
    import torch

    from hivemall_tpu_torch.core.batch_update import (make_batch_train_step,
                                                      stage_block_plans,
                                                      upload_block_plans)
    from hivemall_tpu_torch.models import classifier as C

    rng = np.random.RandomState(seed + 22)
    idx, val, y = block(rng, 4096, WIDTH, FULL_DIMS)
    hyper = {"r": 0.1}
    step = make_batch_train_step(C.AROW, hyper, BATCH, device=dev)
    ti, tv, ty = (torch_on(a, dev) for a in (idx, val, y))
    plans = stage_block_plans(idx[:BATCH], BATCH, FULL_DIMS)
    dplans = upload_block_plans(plans, FULL_DIMS, dev)
    st = warm_state(np.random.RandomState(seed + 23), C.AROW, FULL_DIMS, dev)
    rows = (ti[:BATCH], tv[:BATCH], ty[:BATCH])

    def run():
        step(st, *rows, dplans)

    eager = cuda_ms(run, 50)
    graph = graph_ms(run, 50)
    nbytes, live = batch_chunk_bytes(plans.main, FULL_DIMS, WIDTH,
                                     table_bytes=4 + 4 + 1)
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ops = sum(1 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[batch] one chunk's step (AROW, B={BATCH}, K={WIDTH}, "
          f"D={FULL_DIMS}, {plans.main.rep.shape[-1]} slots, {live} live): "
          f"{eager:.4f} ms eager, {graph:.4f} ms as one CUDA graph; "
          f"{ops if ops else 'not measured'} device operations (kernels, "
          f"copies, fills; torch.profiler); bound {bound:.6f} ms by bytes "
          f"({nbytes} B at {HBM_BYTES_PER_S:.3g} B/s)")

    # the chunk loop never waits on the device: a two-chunk block from an
    # uploaded plan runs with every synchronizing call an error
    both = upload_block_plans(stage_block_plans(idx, BATCH, FULL_DIMS),
                              FULL_DIMS, dev)
    st2 = warm_state(np.random.RandomState(seed + 24), C.AROW, FULL_DIMS,
                     dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st2, loss = step(st2, ti, tv, ty, both)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(loss).item() and torch.isfinite(st2.weights).all()
    print("[batch] a two-chunk block ran under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync in the "
          "chunk loop")
    return {"eager_ms": eager, "graph_ms": graph, "ops": ops,
            "bound_ms": bound, "bytes": nbytes}


def phase_batch(seed, dev, data, main_mini):
    """The -batch B backend on the main path's rows: train_arow -batch 2048
    at D = FULL_DIMS beside main's -mini_batch 4096 run, plan staging
    timed apart; the card against the CPU on one block for four rule
    forms; one chunk timed eager and as a CUDA graph beside its bound, and
    the chunk loop under sync-debug "error". Returns the -batch 2048 run's
    (acc, logloss, seconds)."""
    from hivemall_tpu_torch.kernels.linear_scan import LAUNCHES
    from hivemall_tpu_torch.models.classifier import train_arow

    _, (idx, val, y), (h_idx, h_val, h_y) = data
    feats = (list(idx), list(val))
    opts = f"-dims {FULL_DIMS} -batch {BATCH}"
    rows_secs = stage_rows_secs(feats, y, FULL_DIMS, 4096)
    plan_secs, upload_secs, plan_bytes, plans0 = stage_plans_secs(
        feats, y, FULL_DIMS, 4096, BATCH, dev)
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    sync(dev)
    with gc_clock() as gc_secs:
        t0 = time.perf_counter()
        model = train_arow(feats, y, opts, device=dev)
        sync(dev)
        secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    acc, ll = holdout(model, h_idx, h_val, h_y)
    f_out, w_out, c_out = model.model_rows()
    assert f_out.shape == w_out.shape == c_out.shape, "model_rows"
    assert np.all(np.isfinite(w_out)) and np.all(c_out > 0), "model_rows"
    m_acc, m_ll, m_secs = main_mini
    print(f"[batch] train_arow {opts}: {ROWS} rows in {secs:.3f} s = "
          f"{ROWS / secs:.0f} rows/s; holdout acc {acc:.4f} logloss "
          f"{ll:.4f}; model_rows {f_out.shape[0]}; kernel launches "
          f"{launches} | main's -mini_batch 4096: {m_secs:.3f} s = "
          f"{ROWS / m_secs:.0f} rows/s, acc {m_acc:.4f} logloss {m_ll:.4f}")
    print(f"[batch] of which Python's garbage collector: {gc_secs[1]} "
          f"collections, {gc_secs[0]:.3f} s ({len(gc.get_objects())} objects "
          f"tracked after the run)")
    print(f"[batch] staging of the same rows, timed apart: rows "
          f"(_stage_rows + iter_blocks) {rows_secs:.3f} s; plans "
          f"(stage_block_plans, {ROWS // 4096} blocks of "
          f"{plans0.main.order.shape[0]} chunks, U bucket "
          f"{plans0.slot_bucket} in block 0) {plan_secs:.3f} s on the host, "
          f"{plan_bytes} B; upload {upload_secs:.3f} s")
    assert not any(launches.values()), \
        f"-batch launched a hand kernel: {launches}"
    assert acc > 0.55, f"batch: holdout accuracy {acc} is near chance"
    batch_card_vs_cpu(seed, dev)
    if dev.type == "cuda":
        batch_chunk_timing(seed, dev)
    return acc, ll, secs


NATIVE_TOL = (5e-5, 5e-6)  # native apply vs the -batch step (the reference's)
AROW_PREFIX_ROWS = 8192
# the JAX package's own -native_scan vs engine-scan parity tolerance
AROW_PREFIX_TOL = (RTOL, ATOL)
FM_PREFIX_ROWS = 1024
# train_fm -native_scan needs a fixed -eta; the reference's default eta0 of
# 0.05, held fixed, overshoots on these rows of 32 ones (the exact FM scan
# and the C loop alike, tried at 2^14 dims), so the phase runs 0.01
FM_NATIVE_ETA = 0.01
FM_PREFIX_TOL = (RTOL, ATOL)


def timed(fn, dev):
    """(fn(), host seconds of the call ending in a synchronize)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def native_parse_check(idx, dims):
    """String rows from main's ids: ROWS // 4 rows of "id:1" tokens (65,536
    at full size) and ROWS // 32 (8,192) rows of hashed "f<id>" names.
    ROWS // 32 rows of each form parse through the C parser and through the
    numpy path, exactly equal, both timed. Returns the "id:1" rows."""
    from hivemall_tpu_torch import native
    from hivemall_tpu_torch.utils.feature import (parse_features_batch,
                                                  parse_features_numpy)

    n_int, n_hash = ROWS // 4, ROWS // 32
    int_rows = [[f"{i}:1" for i in r] for r in idx[:n_int].tolist()]
    hashed = [[f"f{i}" for i in r]
              for r in idx[n_int:n_int + n_hash].tolist()]
    for tag, rows in (('"id:1"', int_rows[:n_hash]), ('"f<id>"', hashed)):
        calls = native.CALLS["parse_features_bulk"]
        t0 = time.perf_counter()
        ni, nv = parse_features_batch(rows, dims)
        t1 = time.perf_counter()
        pi, pv = parse_features_numpy(rows, dims)
        t2 = time.perf_counter()
        assert native.CALLS["parse_features_bulk"] == calls + 1, \
            f"{tag}: the C parser declined the rows"
        assert all(np.array_equal(a, b) for a, b in zip(ni, pi)) and \
            all(np.array_equal(a, b) for a, b in zip(nv, pv)), \
            f"{tag}: C parser != numpy path"
        print(f"[native] parse {len(rows)} rows x {WIDTH} {tag} tokens: C "
              f"parser {t1 - t0:.3f} s, numpy path {t2 - t1:.3f} s "
              f"({(t2 - t1) / (t1 - t0):.2f}x); equal array for array")
    return int_rows


def rows_without_a_repeat(idx):
    """Row numbers of idx [N, K] whose K ids are all distinct."""
    srt = np.sort(idx, axis=1)
    return np.flatnonzero((np.diff(srt, axis=1) != 0).all(axis=1))


def native_arow_prefix(idx, val, y, dev):
    """train_arow -native_scan against -pallas (the CUDA scan kernel) on
    the first AROW_PREFIX_ROWS rows of main's data with no id repeated
    within a row: w / cov at AROW_PREFIX_TOL. A repeated id is a pinned
    deviation (the C loop updates a row's lanes in place one after
    another; the kernel computes every lane's update from the row's one
    gather and adds them). `touched` is held exactly against the features
    whose covariance the scan moved: the C loop marks the features of rows
    that updated, as engine scan mode does, while -pallas, as in the JAX
    package, marks every feature it read. Returns max |err|."""
    import torch

    from hivemall_tpu_torch.models.classifier import train_arow

    ok = rows_without_a_repeat(idx)
    rows = ok[:AROW_PREFIX_ROWS]
    feats = (list(idx[rows]), list(val[rows]))
    opts = f"-dims {FULL_DIMS}"
    nat, nat_secs = timed(
        lambda: train_arow(feats, y[rows], opts + " -native_scan",
                           device=dev), dev)
    scan, scan_secs = timed(
        lambda: train_arow(feats, y[rows], opts + " -pallas -block_size "
                           "4096", device=dev), dev)
    rtol, atol = AROW_PREFIX_TOL
    err = 0.0
    for f in ("weights", "covars"):
        a = getattr(nat.state, f).cpu().numpy()
        b = getattr(scan.state, f).cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"arow prefix: {f}")
        err = max(err, float(np.max(np.abs(a - b))))
    updated = scan.state.covars != 1
    assert torch.equal(nat.state.touched.bool(), updated), \
        "arow prefix: touched != the features the scan updated"
    seen_only = int((scan.state.touched.bool() & ~updated).sum())
    print(f"[native] train_arow {opts} on a {len(rows)}-row prefix (rows "
          f"without a repeated id; {len(ok)} of {len(idx)} qualify): "
          f"-native_scan {nat_secs:.3f} s == -pallas on {dev.type} "
          f"{scan_secs:.3f} s, max|err| {err:.3g} over w and cov (rtol "
          f"{rtol} / atol {atol}: lane sums in another order); touched "
          f"exact against the features the scan updated ({seen_only} more "
          f"were read and never updated, which -pallas marks touched)")
    return err


def native_fm_prefix(idx, val, y, dev):
    """train_fm -native_scan against the port's exact FM scan on the card
    from the same state (the same -seed), on the first FM_PREFIX_ROWS rows
    of main's data with no id repeated within a row (a repeated id is the
    reference's pinned deviation). Returns max |err| over w0, w and V."""
    from hivemall_tpu_torch.models.fm import fm_state_to_numpy, train_fm

    ok = rows_without_a_repeat(idx)
    rows = ok[:FM_PREFIX_ROWS]
    feats = (list(idx[rows]), list(val[rows]))
    opts = f"-c -dims {FULL_DIMS} -factor {FM_FACTORS} -eta {FM_NATIVE_ETA}"
    nat, nat_secs = timed(
        lambda: train_fm(feats, y[rows], opts + " -native_scan", device=dev),
        dev)
    scan, scan_secs = timed(
        lambda: train_fm(feats, y[rows], opts, device=dev), dev)
    a, b = fm_state_to_numpy(nat.state), fm_state_to_numpy(scan.state)
    rtol, atol = FM_PREFIX_TOL
    err = 0.0
    for k in ("w0", "w", "v"):
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=f"fm prefix: {k}")
        err = max(err, float(np.max(np.abs(a[k] - b[k]))))
    assert np.array_equal(a["touched"], b["touched"]), "fm prefix: touched"
    print(f"[native] train_fm {opts} on a {len(rows)}-row prefix (rows "
          f"without a repeated id; {len(ok)} of {len(idx)} qualify): "
          f"-native_scan {nat_secs:.3f} s == the exact FM scan on "
          f"{dev.type} {scan_secs:.3f} s, max|err| {err:.3g} (rtol {rtol} "
          f"/ atol {atol}: the C loop sums a row's score in float64, the "
          f"scan in float32), touched exact")
    return err


def native_block_check(seed, dev):
    """One 4096-row block at D = FULL_DIMS (2 chunks of BATCH rows, pad and
    duplicate lanes) through the native apply on host tables and through
    the torch -batch step on ``dev``, from one warm state: AROW at
    NATIVE_TOL, touched exact. Returns max |err| and both seconds."""
    from hivemall_tpu_torch.core.batch_update import (make_batch_train_step,
                                                      stage_block_plans)
    from hivemall_tpu_torch.core.native_batch import (init_native_tables,
                                                      make_native_batch_step)
    from hivemall_tpu_torch.core.state import init_linear_state
    from hivemall_tpu_torch.models import classifier as C

    rng = np.random.RandomState(seed + 41)
    idx, val, y = block(rng, 4096, WIDTH, FULL_DIMS)
    plans = stage_block_plans(idx, BATCH, FULL_DIMS)
    assert plans.main.order.shape[0] == 2 and plans.tail is None
    w0 = (0.1 * rng.randn(FULL_DIMS) * (rng.rand(FULL_DIMS) < 0.5)) \
        .astype(np.float32)
    c0 = rng.uniform(0.5, 1.5, FULL_DIMS).astype(np.float32)
    hyper = {"r": 0.1}
    tables = init_native_tables(FULL_DIMS, True, w0, c0)
    nstep = make_native_batch_step(C.AROW, hyper)
    t0 = time.perf_counter()
    loss = nstep(tables, val, y, plans)
    native_secs = time.perf_counter() - t0
    st = init_linear_state(FULL_DIMS, use_covariance=True,
                           initial_weights=w0, initial_covars=c0, device=dev)
    tstep = make_batch_train_step(C.AROW, hyper, BATCH, device=dev)
    (st, tloss), torch_secs = timed(lambda: tstep(st, idx, val, y, plans),
                                    dev)
    rtol, atol = NATIVE_TOL
    err = 0.0
    for name, got, want in (("weights", tables["w"], st.weights),
                            ("covars", tables["cov"], st.covars)):
        want = want.cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=f"native block: {name}")
        err = max(err, float(np.max(np.abs(got - want))))
    assert np.array_equal(tables["touched"], st.touched.cpu().numpy()), \
        "native block: touched"
    assert abs(loss - float(tloss)) <= 1e-4 * max(1.0, abs(loss)), \
        f"native block: loss {loss} vs {float(tloss)}"
    return err, native_secs, torch_secs


def native_codec_check(feats):
    """The codec on a model's ids (the delta stream encode_sparse_model
    writes): the native zigzag-LEB128 encode and decode against the
    per-value Python path, byte for byte. Returns the stream's bytes."""
    from hivemall_tpu_torch.utils.codec import (leb128_decode, leb128_encode,
                                                zigzag_decode, zigzag_encode,
                                                zigzag_leb128_decode_array,
                                                zigzag_leb128_encode_array)

    deltas = np.diff(np.sort(feats), prepend=0)
    t0 = time.perf_counter()
    blob = zigzag_leb128_encode_array(deltas)
    back = zigzag_leb128_decode_array(blob, len(deltas))
    t1 = time.perf_counter()
    py = bytearray()
    for v in deltas.tolist():
        leb128_encode(zigzag_encode(v), py)
    pos, py_back = 0, []
    for _ in range(len(deltas)):
        u, pos = leb128_decode(py, pos)
        py_back.append(zigzag_decode(u))
    t2 = time.perf_counter()
    assert blob == bytes(py), "codec: native bytes != Python bytes"
    assert back == py_back == deltas.tolist(), "codec: decode"
    print(f"[native] codec on the -native_scan model's {len(deltas)} ids: "
          f"native encode + decode {t1 - t0:.3f} s, Python {t2 - t1:.3f} s; "
          f"{len(blob)} bytes, byte-equal")
    return len(blob)


def native_pack_timing(idx, val, y):
    """core/batch.pack_rows (numpy) against the library's hm_pack_block
    with offsets from one cumsum, on main's rows as one block at WIDTH:
    equal outputs; both timed (the marshalling timed with the C call and
    apart). hm_pack_block is bound here only for this measurement: the
    port packs with pack_rows."""
    import ctypes

    from hivemall_tpu_torch import native
    from hivemall_tpu_torch.core.batch import pack_rows

    idx_rows, val_rows = list(idx), list(val)
    t0 = time.perf_counter()
    blk = pack_rows(idx_rows, val_rows, y, FULL_DIMS, width=WIDTH)
    t1 = time.perf_counter()
    fn = native._load().hm_pack_block
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 \
        + [ctypes.c_void_p] * 3
    n = len(idx_rows)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, idx_rows), np.int64, n), out=offsets[1:])
    flat_i = np.concatenate(idx_rows).astype(np.int64)
    flat_v = np.concatenate(val_rows).astype(np.float32)
    out_i = np.empty((n, WIDTH), np.int32)
    out_v = np.empty((n, WIDTH), np.float32)
    out_n = np.empty(n, np.int32)
    t2 = time.perf_counter()
    fn(*(a.ctypes.data_as(ctypes.c_void_p) for a in (flat_i, flat_v,
                                                    offsets)),
       n, WIDTH, FULL_DIMS,
       *(a.ctypes.data_as(ctypes.c_void_p) for a in (out_i, out_v, out_n)))
    t3 = time.perf_counter()
    assert np.array_equal(out_i, blk.indices) and \
        np.array_equal(out_v, blk.values) and np.array_equal(out_n, blk.nnz), \
        "hm_pack_block != pack_rows"
    print(f"[native] pack {n} rows at K={WIDTH}: pack_rows (numpy) "
          f"{t1 - t0:.3f} s; hm_pack_block with cumsum offsets "
          f"{t3 - t1:.3f} s, of which the C call {t3 - t2:.3f} s; equal "
          f"outputs")


def phase_native(seed, dev, data, built, pallas_run, fm_run, batch_run):
    """The native host library on the main path's rows: string parsing
    (C parser vs numpy, then a -pallas fit from string rows == the same fit
    from arrays), train_arow -native_scan beside main's -pallas with a
    prefix without repeated ids held against -pallas, train_arow
    -batch 2048 -native_apply beside phase batch's -batch 2048 with one
    block held against the torch step, train_fm -native_scan beside phase
    fm's run with a prefix held against the exact FM scan, the codec, and
    pack_rows against hm_pack_block. The native fits run on the host and
    launch no CUDA kernel; their models land on ``dev``."""
    import torch

    from hivemall_tpu_torch import native
    from hivemall_tpu_torch.kernels.linear_scan import LAUNCHES
    from hivemall_tpu_torch.models.classifier import train_arow
    from hivemall_tpu_torch.models.fm import train_fm

    cxx, path, build_secs = built
    print(f"[native] library {path}: {cxx}; built at first use in "
          f"{build_secs:.2f} s")
    _, (idx, val, y), (h_idx, h_val, h_y) = data
    feats = (list(idx), list(val))
    for key in native.CALLS:
        native.CALLS[key] = 0

    int_rows = native_parse_check(idx, FULL_DIMS)
    n_str = len(int_rows)
    opts = f"-dims {FULL_DIMS} -pallas -block_size 4096"
    m_str, str_secs = timed(
        lambda: train_arow(int_rows, y[:n_str], opts, device=dev), dev)
    m_arr, arr_secs = timed(
        lambda: train_arow((feats[0][:n_str], feats[1][:n_str]), y[:n_str],
                           opts, device=dev), dev)
    for f in ("weights", "covars", "touched"):
        assert torch.equal(getattr(m_str.state, f), getattr(m_arr.state, f)), \
            f"string rows: {f} differs from the array fit"
    print(f"[native] train_arow {opts} on {n_str} string rows "
          f"{str_secs:.3f} s == the same fit from arrays {arr_secs:.3f} s, "
          f"bit for bit")

    pallas, p_acc, p_ll, p_secs = pallas_run
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    opts = f"-dims {FULL_DIMS} -native_scan"
    model, secs = timed(lambda: train_arow(feats, y, opts, device=dev), dev)
    launched = dict(LAUNCHES)
    assert model.state.weights.device.type == dev.type, "state not on dev"
    acc, ll = holdout(model, h_idx, h_val, h_y)
    dw = float((model.state.weights - pallas.state.weights).abs().max())
    dc = float((model.state.covars - pallas.state.covars).abs().max())
    print(f"[native] train_arow {opts}: {ROWS} rows in {secs:.3f} s = "
          f"{ROWS / secs:.0f} rows/s; holdout acc {acc:.4f} logloss "
          f"{ll:.4f}; state on {model.state.weights.device}; against main's "
          f"-pallas ({p_secs:.3f} s = {ROWS / p_secs:.0f} rows/s, acc "
          f"{p_acc:.4f} logloss {p_ll:.4f}): max|dw| {dw:.3g}, max|dcov| "
          f"{dc:.3g} (rows repeating an id within the row: "
          f"{ROWS - len(rows_without_a_repeat(idx))} of {ROWS}); kernel "
          f"launches {launched}")
    assert not any(launched.values()), f"-native_scan launched {launched}"
    assert abs(acc - p_acc) <= 0.01, "-native_scan holdout moved from -pallas"
    native_codec_check(model.model_rows()[0])
    del model
    native_arow_prefix(idx, val, y, dev)

    b_acc, b_ll, b_secs = batch_run
    plan_secs, _, _, _ = stage_plans_secs(feats, y, FULL_DIMS, 4096, BATCH,
                                          dev)
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    opts = f"-dims {FULL_DIMS} -batch {BATCH} -native_apply"
    model, secs = timed(lambda: train_arow(feats, y, opts, device=dev), dev)
    launched = dict(LAUNCHES)
    assert model.state.weights.device.type == dev.type, "state not on dev"
    acc, ll = holdout(model, h_idx, h_val, h_y)
    print(f"[native] train_arow {opts}: {ROWS} rows in {secs:.3f} s = "
          f"{ROWS / secs:.0f} rows/s (plan staging of the same rows, timed "
          f"apart: {plan_secs:.3f} s); holdout acc {acc:.4f} logloss "
          f"{ll:.4f} | phase batch's -batch {BATCH}: {b_secs:.3f} s, acc "
          f"{b_acc:.4f} logloss {b_ll:.4f}; kernel launches {launched}")
    assert not any(launched.values()), f"-native_apply launched {launched}"
    assert abs(acc - b_acc) <= 0.01, "-native_apply holdout moved from -batch"
    del model
    err, n_secs, t_secs = native_block_check(seed, dev)
    print(f"[native] one 4096-row block, D={FULL_DIMS}, B={BATCH} (2 "
          f"chunks), AROW from a warm state: native apply {n_secs:.4f} s on "
          f"the host == the torch -batch step on {dev.type} {t_secs:.4f} s, "
          f"max|err| {err:.3g} (rtol {NATIVE_TOL[0]} / atol "
          f"{NATIVE_TOL[1]}), touched exact")

    f_acc, f_ll, f_secs = fm_run
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    opts = (f"-c -dims {FULL_DIMS} -factor {FM_FACTORS} -eta {FM_NATIVE_ETA} "
            "-native_scan")
    model, secs = timed(lambda: train_fm(feats, y, opts, device=dev), dev)
    launched = dict(LAUNCHES)
    assert model.state.w.device.type == dev.type, "FM state not on dev"
    assert not model.state.v[:, FM_FACTORS:].any(), "V pad lanes moved"
    acc, ll = holdout(model, h_idx, h_val, h_y)
    print(f"[native] train_fm {opts}: {ROWS} rows in {secs:.3f} s = "
          f"{ROWS / secs:.0f} rows/s; holdout acc {acc:.4f} logloss "
          f"{ll:.4f} | phase fm's -mini_batch 4096: {f_secs:.3f} s, acc "
          f"{f_acc:.4f} logloss {f_ll:.4f}; kernel launches {launched}")
    assert not any(launched.values()), f"-native_scan launched {launched}"
    assert acc > 0.55, f"fm -native_scan: holdout accuracy {acc}"
    del model
    native_fm_prefix(idx, val, y, dev)

    native_pack_timing(idx, val, y)
    calls = dict(native.CALLS)
    print(f"[native] calls into the library during the phase: {calls}")
    for key in ("parse_features_bulk", "arow_reference_rowloop",
                "fm_reference_rowloop", "batch_apply_block"):
        assert calls[key] > 0, f"{key} was never called"


MF_USERS = 1 << 20  # the JAX package's MF bench shape (scripts/bench_mf.py)
MF_ITEMS = 1 << 17
MF_K = 16
MF_BATCH = 16384
MF_ROWS = 8 * MF_BATCH
MF_HOLDOUT = 16384
MF_SCAN_ROWS = 4096
MF_TOL = (2e-5, 1e-6)  # a minibatch step, card against CPU
MF_SCAN_TOL = (1e-5, 1e-6)
# the default rates (0.2 SGD, 1.0 AdaGrad, 0.3 BPR) diverge at this shape:
# a -mini_batch block sums every duplicate id's delta (the reference's
# .at[].add), and the head user of the log-uniform ids holds ~7% of a
# 16,384-row block; phase mf runs the defaults once to show it
MF_RUNS = (("train_mf_sgd", 0.001), ("train_mf_adagrad", 0.002),
           ("train_bprmf", 0.05))


def mf_data(seed):
    """MF_ROWS training and MF_HOLDOUT held-out rows (users, items,
    ratings, negatives) at the JAX package's MF bench shape: users and
    items log-uniform (workload_ids), ratings 1 + 4 * rand, BPR negatives
    uniform over the items; the last training row pins both table
    sizes."""
    rng = np.random.RandomState(seed + 31)
    n = MF_ROWS + MF_HOLDOUT
    u = workload_ids(rng, n, MF_USERS).astype(np.int64)
    i = workload_ids(rng, n, MF_ITEMS).astype(np.int64)
    r = (1.0 + 4.0 * rng.rand(n)).astype(np.float32)
    j = rng.randint(0, MF_ITEMS, n).astype(np.int64)
    u[MF_ROWS - 1], i[MF_ROWS - 1] = MF_USERS - 1, MF_ITEMS - 1
    return ([c[:MF_ROWS] for c in (u, i, r, j)],
            [c[MF_ROWS:] for c in (u, i, r, j)])


def mf_compare(tag, got, ref, tol):
    """MF state on the card == the same step on the CPU (floats at tol,
    touched and step exact); returns max |err|."""
    from hivemall_tpu_torch.models.mf import mf_state_to_numpy

    (gs, gl), (rs, rl) = got, ref
    a, b = mf_state_to_numpy(gs), mf_state_to_numpy(rs)
    err = abs(float(gl) - float(rl))
    np.testing.assert_allclose(float(gl), float(rl), rtol=tol[0],
                               atol=tol[1], err_msg=f"{tag}: loss")
    for k in ("P", "Q", "Bu", "Bi", "mu", "P_gg", "Q_gg"):
        if b[k] is None:
            continue
        np.testing.assert_allclose(a[k], b[k], rtol=tol[0], atol=tol[1],
                                   err_msg=f"{tag}: {k}")
        err = max(err, float(np.max(np.abs(a[k] - b[k]))))
    for k in ("touched_u", "touched_i"):
        assert np.array_equal(a[k], b[k]), f"{tag}: {k}"
    assert a["step"] == b["step"], f"{tag}: step"
    return err


def device_ops(fn):
    """Device operations (kernels, copies, fills) one call of fn()
    launches, by torch.profiler; 0 when it records none."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def mf_hypers(kind, eta0):
    from hivemall_tpu_torch.models import mf as M
    from hivemall_tpu_torch.ops.eta import EtaEstimator

    eta = EtaEstimator("invscaling", eta0, power_t=0.1)
    if kind == "bpr":
        return M.BPRHyper(factor=MF_K, eta=eta), M.MFHyper(factor=MF_K)
    h = M.MFHyper(factor=MF_K, eta=eta, adagrad=kind == "adagrad")
    return h, h


def mf_card_vs_cpu(dev, train):
    """From one CPU-made state per trainer: one full-width -mini_batch
    block (MF_BATCH rows, 2^20 x 2^17, k = 16) on the card and on the CPU;
    the SGD step timed eager and as one CUDA graph with its device
    operations and byte bound; the exact scan of MF_SCAN_ROWS rows on
    both."""
    import torch

    from hivemall_tpu_torch.models import mf as M

    u, i, r, j = (c[:MF_BATCH] for c in train)
    for kind, (_, eta0) in zip(("sgd", "adagrad", "bpr"), MF_RUNS):
        hyper, init_h = mf_hypers(kind, eta0)
        make = M.make_bpr_step if kind == "bpr" else M.make_mf_step
        third = j if kind == "bpr" else r
        host = M.mf_state_to_numpy(
            M.init_mf_state(MF_USERS, MF_ITEMS, init_h, device="cpu"))
        out = [make(hyper, "minibatch", device=d)(
            M.mf_state_from_numpy(host, d), u, i, third)
            for d in (dev, "cpu")]
        e = mf_compare(f"mf {kind} block", *out, MF_TOL)
        print(f"[mf] {kind} -mini_batch block of {MF_BATCH} rows from one "
              f"state: card == CPU, max|err| {e:.3g} (rtol {MF_TOL[0]:g} / "
              f"atol {MF_TOL[1]:g}), touched and step exact")
        if kind != "sgd" or dev.type != "cuda":
            continue
        step = make(hyper, "minibatch", device=dev)
        st = M.mf_state_from_numpy(host, dev)
        cols = (torch_on(u, dev), torch_on(i, dev), torch_on(r, dev))

        def run():
            step(st, *cols)

        eager, graph, ops = cuda_ms(run, 20), graph_ms(run, 20), \
            device_ops(run)
        nu, ni = len(np.unique(u)), len(np.unique(i))
        # ids and ratings read once; each unique user's and item's row,
        # bias and touched byte read and written once
        nbytes = MF_BATCH * (8 + 8 + 4) + 2 * (nu + ni) * (4 * MF_K + 4) \
            + nu + ni
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        print(f"[mf] sgd minibatch step (B={MF_BATCH}, k={MF_K}, "
              f"{nu} users / {ni} items unique): {eager:.4f} ms eager = "
              f"{MF_BATCH / eager * 1e3:.0f} rows/s, {graph:.4f} ms as one "
              f"CUDA graph; {ops if ops else 'not measured'} device "
              f"operations; bound {bound:.6f} ms by bytes ({nbytes} B)")

    hyper, _ = mf_hypers("sgd", MF_RUNS[0][1])
    host = M.mf_state_to_numpy(
        M.init_mf_state(MF_USERS, MF_ITEMS, hyper, device="cpu"))
    n = MF_SCAN_ROWS
    out, secs = [], None
    for d in (dev, "cpu"):
        step = M.make_mf_step(hyper, "scan", device=d)
        st = M.mf_state_from_numpy(host, d)
        sync(dev)
        t0 = time.perf_counter()
        out.append(step(st, train[0][:n], train[1][:n], train[2][:n]))
        sync(dev)
        secs = secs or time.perf_counter() - t0
    e = mf_compare("mf sgd scan", *out, MF_SCAN_TOL)
    print(f"[mf] exact scan (-mini_batch 1) of the first {n} rows: card == "
          f"CPU, max|err| {e:.3g} (rtol {MF_SCAN_TOL[0]:g} / atol "
          f"{MF_SCAN_TOL[1]:g}); on the card {secs:.3f} s = {n / secs:.0f} "
          f"rows/s (plain torch ops, some 25 launches a row)")


def holdout_rmse(model, held):
    u, i, r, _ = held
    p = model.predict(u, i)
    with np.errstate(over="ignore", invalid="ignore"):  # a diverged model
        return float(np.sqrt(np.mean((p - r) ** 2)))


def mf_pairs(held, n):
    return [[int(a), int(b)] for a, b in zip(held[0][:n], held[1][:n])]


def phase_mf(seed, dev, smi, train, held):
    """MF at the JAX package's bench shape: the three trainers with
    -mini_batch 16384 (seconds, rows/s, init and upload timed apart,
    holdout quality), the default rates' divergence, card == CPU on one
    block per trainer and on the exact scan's prefix, then train_mf_sgd's
    model frozen at f32 / bf16 / int8 with an LSH index, loaded and served
    as /predict pairs. Returns (model, artifacts by dtype)."""
    import tempfile

    import torch

    from hivemall_tpu_torch.io.checkpoint import dequantize_int8
    from hivemall_tpu_torch.models import mf as M
    from hivemall_tpu_torch.serving import ServingEngine, freeze, load
    from hivemall_tpu_torch.utils import jax_prng

    print(f"[mf] card: {smi}; {MF_USERS} users x {MF_ITEMS} items, k = "
          f"{MF_K}, {MF_ROWS} training rows ({len(np.unique(train[0]))} "
          f"users, {len(np.unique(train[1]))} items seen), {MF_HOLDOUT} "
          f"held out")
    models = {}
    base = float(np.sqrt(np.mean((held[2] - train[2].mean()) ** 2)))
    for (name, eta0), kind in zip(MF_RUNS, ("sgd", "adagrad", "bpr")):
        opts = (f"-factor {MF_K} -mini_batch {MF_BATCH} -iter 2 -disable_cv "
                f"-eta0 {eta0}")
        _, init_h = mf_hypers(kind, eta0)
        jax_prng.clear_cache()  # time the draw itself; the fit reuses it
        _, init_secs = timed(lambda: M.init_mf_state(
            MF_USERS, MF_ITEMS, init_h, device=dev), dev)
        _, up_secs = timed(lambda: [torch_on(c, dev) for c in train], dev)
        fn = getattr(M, name)
        cols = (train[0], train[1], train[3] if kind == "bpr" else train[2])
        model, secs = timed(lambda: fn(*cols, opts, device=dev), dev)
        assert model.state.P.device.type == dev.type, "state not on dev"
        assert torch.isfinite(model.state.P).all() \
            and torch.isfinite(model.state.Q).all(), f"{name}: not finite"
        if kind == "bpr":
            acc = float(np.mean(model.predict_bpr(held[0], held[1])
                                > model.predict_bpr(held[0], held[3])))
            quality = (f"held-out triples ranked positive over negative "
                       f"{acc:.4f}")
            assert acc > 0.6, f"bpr: pairwise accuracy {acc}"
        else:
            init_model = M.TrainedMFModel(
                M.init_mf_state(MF_USERS, MF_ITEMS, init_h, device=dev),
                use_bias=True)
            rmse, rmse0 = holdout_rmse(model, held), \
                holdout_rmse(init_model, held)
            quality = (f"holdout RMSE {rmse:.4f} (the initial model "
                       f"{rmse0:.4f}, the training mean {base:.4f}: the "
                       f"ratings are uniform noise)")
            assert np.isfinite(rmse) and rmse < rmse0, f"{name}: {rmse}"
        rows = 2 * MF_ROWS
        print(f"[mf] {name} {opts}: {rows} rows (2 epochs) in {secs:.3f} s "
              f"= {rows / secs:.0f} rows/s; of which, timed apart, the "
              f"init draw on the CPU and upload {init_secs:.3f} s and the "
              f"columns' upload {up_secs:.3f} s; {quality}")
        models[kind] = model
    default, d_secs = timed(lambda: M.train_mf_sgd(
        train[0], train[1], train[2],
        f"-factor {MF_K} -mini_batch {MF_BATCH} -iter 2 -disable_cv",
        device=dev), dev)
    print(f"[mf] train_mf_sgd at the default -eta0 0.2: {d_secs:.3f} s, "
          f"holdout RMSE {holdout_rmse(default, held):.4g}, finite P: "
          f"{bool(torch.isfinite(default.state.P).all())} (a block sums "
          f"every duplicate's delta, as the reference does; the JAX "
          f"package diverges the same way)")
    del default

    mf_card_vs_cpu(dev, train)

    model = models["sgd"]
    pairs = mf_pairs(held, 2048)
    pu, pi = held[0][:2048], held[1][:2048]
    arts, engines = {}, {}
    with tempfile.TemporaryDirectory(prefix="hivemall_mf_") as tmp:
        for dtype, q in PRECISIONS:
            path = f"{tmp}/mf_{dtype}"
            t0 = time.perf_counter()
            freeze(model, path, name="mf", quantize=q,
                   quant_block_rows=64 if q == "int8" else None,
                   retrieval_index={"planes": 8, "seed": 0})
            t1 = time.perf_counter()
            arts[dtype] = load(path)
            t2 = time.perf_counter()
            eng = ServingEngine(arts[dtype], name=f"smoke_mf_{dtype}",
                                max_batch=512, device=dev)
            segs = eng.warmup()
            assert eng.weights_dtype == dtype
            print(f"[mf] {dtype}: freeze {t1 - t0:.3f} s (LSH index of 8 "
                  f"planes included), load {t2 - t1:.3f} s; table_bytes "
                  f"{eng.table_bytes}; warmup of {len(eng.warmed_buckets)} "
                  f"buckets, {segs} new allocator segments")
            engines[dtype] = eng
    cpu = ServingEngine(arts["bfloat16"], name="smoke_mf_bf16_cpu",
                        max_batch=512, device="cpu")
    a = arts["int8"].arrays
    pq = dequantize_int8(a["P"], a["P__scale"], 64)[pu]
    qq = dequantize_int8(a["Q"], a["Q__scale"], 64)[pi]
    q8 = np.sum(pq * qq, axis=-1) + np.float32(a["mu"]) + a["Bu"][pu] \
        + a["Bi"][pi]
    want = {"float32": model.predict(pu, pi), "bfloat16": cpu.predict(pairs),
            "int8": q8}
    nu, ni = MF_USERS, MF_ITEMS
    expect = {"float32": 4 * (nu + ni) * (MF_K + 1),
              "bfloat16": 2 * (nu + ni) * MF_K + 4 * (nu + ni),
              "int8": (nu + ni) * MF_K + 4 * (nu + ni) // 64 * MF_K
              + 4 * (nu + ni)}
    for dtype, eng in engines.items():
        assert eng.table_bytes == expect[dtype], \
            f"mf {dtype}: table_bytes {eng.table_bytes}"
        rtol, atol = SERVE_TOL[dtype]
        got = eng.predict(pairs)
        np.testing.assert_allclose(got, want[dtype], rtol=rtol, atol=atol,
                                   err_msg=f"mf /predict {dtype}")
        counter = f"new_segments.serving.smoke_mf_{dtype}"
        from hivemall_tpu_torch.runtime.metrics import REGISTRY

        before = REGISTRY.counter("allocator", counter).value
        lat = []
        for n in (1, 512):
            secs = []
            for s in range(0, 100 * 8, 8):
                t0 = time.perf_counter()
                eng.predict(pairs[s:s + n])
                secs.append(time.perf_counter() - t0)
            lat.append(f"{n} pairs p50 {percentile_ms(secs, 50):.4f} / p99 "
                       f"{percentile_ms(secs, 99):.4f} ms")
        assert REGISTRY.counter("allocator", counter).value == before, \
            f"mf {dtype}: allocator segments after warmup"
        print(f"[mf] /predict pairs {dtype}: 2048 held-out pairs == "
              f"reference (rtol {rtol:g}, atol {atol:g}), largest |diff| "
              f"{float(np.max(np.abs(got - want[dtype]))):.3g}; " +
              "; ".join(lat) + " (100 requests each); 0 new allocator "
              "segments after warmup")
    return model, arts


KNN_QUERIES = 1024  # item rows asked for their neighbours
KNN_CHECK = 64  # rows held against float64 and against the CPU port
KNN_REPS = 20
UNIT_ROUNDOFF = 2.0 ** -24  # float32


def knn_tolerance(kind, a, b, d64):
    """The float32 rounding bound of a batch distance against float64, per
    element. euclid: |a|^2 + |b|^2 - 2 a.b in float32 from float32 inputs
    rounds D + 3 times against terms no larger than (|a| + |b|)^2, so
    E = (D + 3) u (|a| + |b|)^2 bounds the squared distance's error; the
    clamp and root turn it into min(sqrt(E), E / d) plus u d for the root.
    cosine: 1 - a^.b^ of normalized rows is off by at most (2 D + 8) u."""
    u, D = UNIT_ROUNDOFF, a.shape[1]
    if kind == "cosine":
        return np.full(d64.shape, (2 * D + 8) * u)
    na = np.linalg.norm(a.astype(np.float64), axis=1)[:, None]
    nb = np.linalg.norm(b.astype(np.float64), axis=1)[None, :]
    E = (D + 3) * u * (na + nb) ** 2
    with np.errstate(divide="ignore"):
        return np.minimum(np.sqrt(E), E / d64) + u * d64


def knn_float64(kind, a, b):
    """The distances in float64 numpy (the expansion, whose own rounding,
    ~1e-16 relative, is far below the float32 bound)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    if kind == "cosine":
        an = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
        bn = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-12)
        return 1.0 - an @ bn.T
    sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * a @ b.T
    return np.sqrt(np.maximum(sq, 0.0))


def phase_knn(seed, dev, smi, mf_model):
    """Item-to-item neighbours over phase mf's train_mf_sgd item factors:
    euclid_distance_batch and cosine_distance_batch of KNN_QUERIES item
    rows against all of Q on the card, timed by CUDA events beside the
    byte bound; KNN_CHECK rows against float64 and against the CPU port."""
    import torch

    from hivemall_tpu_torch.knn.distance import (cosine_distance_batch,
                                                 euclid_distance_batch)

    Q = mf_model.state.Q
    assert Q.device.type == dev.type and Q.dtype == torch.float32
    m, k = Q.shape
    rng = np.random.RandomState(seed + 81)
    rows = rng.choice(m, KNN_QUERIES, replace=False)
    A = Q[torch.from_numpy(rows).to(dev)]
    out_bytes = KNN_QUERIES * m * 4
    in_bytes = (m + KNN_QUERIES) * k * 4
    bound_ms = 1e3 * max((out_bytes + in_bytes) / HBM_BYTES_PER_S,
                         2 * KNN_QUERIES * m * k / FP32_FLOPS)
    a_np, q_np = A[:KNN_CHECK].cpu().numpy(), Q.cpu().numpy()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            euclid_distance_batch(A[:2], Q[:2])
            raise AssertionError("knn ran with TF32 on")
        except RuntimeError as e:
            assert "allow_tf32" in str(e)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[knn] card: {smi}; {KNN_QUERIES} item rows x the {m} x {k} "
          f"float32 item factors of train_mf_sgd"
          + ("; refuses to run with TF32 on" if dev.type == "cuda" else ""))
    for kind, fn in (("euclid", euclid_distance_batch),
                     ("cosine", cosine_distance_batch)):
        calls = 0

        def run():
            nonlocal calls
            calls += 1
            return fn(A, Q, device=dev)

        d = run()
        assert d.shape == (KNN_QUERIES, m) and d.device.type == dev.type
        assert bool(torch.isfinite(d).all())
        # the timings run only on the card
        ms = cuda_ms(run, KNN_REPS) if dev.type == "cuda" else float("nan")
        got = d[:KNN_CHECK].cpu().numpy().astype(np.float64)
        ref = knn_float64(kind, a_np, q_np)
        tol = knn_tolerance(kind, a_np, q_np, ref)
        err = np.abs(got - ref)
        assert np.all(err <= tol), \
            f"knn {kind}: {int(np.sum(err > tol))} elements past the bound"
        cpu = fn(a_np, q_np, device="cpu").numpy().astype(np.float64)
        assert np.all(np.abs(got - cpu) <= 2 * tol), f"knn {kind}: card != CPU"
        if kind == "euclid":
            self_d = got[np.arange(KNN_CHECK), rows[:KNN_CHECK]]
            assert np.all(self_d <= tol[np.arange(KNN_CHECK),
                                        rows[:KNN_CHECK]])
        print(f"[knn] {kind}_distance_batch [{KNN_QUERIES}, {k}] x [{m}, "
              f"{k}]: {ms:.4f} ms by CUDA events (mean of {KNN_REPS}) "
              f"against a bound of {bound_ms:.4f} ms ({out_bytes} output "
              f"bytes + {in_bytes} input bytes at 3.35 TB/s; "
              f"{bound_ms / ms:.3f} of it); {KNN_CHECK} rows vs float64: "
              f"max |diff| {err.max():.3g}, within the float32 bound "
              f"(max {tol.max():.3g}); card == CPU port within twice it; "
              f"{calls} calls")
        del d


TOPK_K = 16
TOPK_BLOCK = 4096
TOPK_QUERIES = 64
TOPK_LAT_REQUESTS = 100
FM_TOPK_BLOCK = 65536


def same_ranking(tag, got, want, rtol=1e-5, atol=1e-6):
    """Two engines' top-K lists: scores at rtol / atol, ids equal at every
    rank whose neighbouring scores differ by more than that."""
    for g, w in zip(got, want):
        gs, ws = np.asarray(g["scores"]), np.asarray(w["scores"])
        np.testing.assert_allclose(gs, ws, rtol=rtol, atol=atol,
                                   err_msg=f"{tag}: scores")
        tol = atol + rtol * np.abs(ws)
        gap = np.abs(np.diff(ws))
        for p in range(len(ws)):
            left = p == 0 or gap[p - 1] > tol[p]
            right = p == len(ws) - 1 or gap[p] > tol[p]
            if left and right:
                assert g["items"][p] == w["items"][p], f"{tag}: rank {p}"


def argsort_parity(tag, eng, queries, k):
    """Blocked merge == stable descending argsort of score_catalog, ids and
    f32 score bits, on the engine's device."""
    res = eng.topk(queries, probe=False)
    scores = eng.score_catalog(queries)
    assert scores.shape == (len(queries), eng.n_items)
    assert np.all(np.isfinite(scores)), f"{tag}: non-finite scores"
    for row, out in zip(scores, res):
        order = np.argsort(-row, kind="stable")[:k]
        assert np.array_equal(np.asarray(out["items"], np.int64), order), \
            f"{tag}: ids differ from the stable argsort"
        assert np.asarray(out["scores"], np.float32).tobytes() \
            == row[order].tobytes(), f"{tag}: score bits differ"
    return res


def topk_latency(eng, queries, n_req):
    """p50 / p99 host-clock ms of n_req topk calls per batch size (1, 8),
    each ending in the results' copy to the host."""
    out = {}
    for b in (1, 8):
        secs = []
        for s in range(n_req):
            qs = [queries[(s * b + t) % len(queries)] for t in range(b)]
            t0 = time.perf_counter()
            eng.topk(qs)
            secs.append(time.perf_counter() - t0)
        out[b] = (percentile_ms(secs, 50), percentile_ms(secs, 99),
                  b / float(np.mean(secs)))
    return out


def sweep_timing(eng, b, dev):
    """One exact sweep of the catalog for b queries on the device: ms eager
    and as one CUDA graph, device operations per block, and its bound."""
    import torch

    cat = eng._catalog
    q = torch.randn(b, cat.vec.shape[1], device=dev)
    bs = torch.zeros(b, device=dev)

    def run():
        cat.sweep(q, bs)

    eager, graph, ops = cuda_ms(run, 10), graph_ms(run, 10), device_ops(run)
    nbytes = cat.table_bytes + b * (cat.vec.shape[1] + 1) * 4
    flops = 2 * b * cat.n_pad * cat.vec.shape[1]
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    return {"ms": eager, "graph_ms": graph, "ops": ops, "bound_ms": bound,
            "bytes": nbytes, "blocks": cat.n_steps}


def topk_engine_checks(tag, eng, cpu, queries, dev, n_par):
    """Warm the card engine; latency (allocator pinned); argsort parity on
    the card; card against the CPU engine. Returns the latency dict."""
    from hivemall_tpu_torch.runtime.metrics import REGISTRY

    t0 = time.perf_counter()
    segs = eng.warmup()
    sync(dev)
    warm = time.perf_counter() - t0
    counter = REGISTRY.counter("allocator",
                               f"new_segments.serving.{eng.name}.topk")
    before = counter.value
    lat = topk_latency(eng, queries, TOPK_LAT_REQUESTS)
    argsort_parity(tag, eng, queries[:n_par], eng.k)
    got = eng.topk(queries[:n_par])
    assert counter.value == before, \
        f"{tag}: {counter.value - before} allocator segments after warmup"
    same_ranking(f"{tag} card vs CPU", got, cpu.topk(queries[:n_par]))
    print(f"[topk] {tag}: warmup {warm:.3f} s, {segs} new allocator "
          f"segments; table_bytes {eng.table_bytes()}; blocked merge == "
          f"stable argsort of score_catalog on the card for {n_par} "
          f"queries (ids and f32 bits); card == CPU engine (rtol 1e-5 / "
          f"atol 1e-6, ids where neighbours differ by more); " + "; ".join(
              f"batch {b}: p50 {p50:.4f} / p99 {p99:.4f} ms, {qps:.0f} "
              f"queries/s = {qps * eng.n_items:.4g} items scored/s"
              for b, (p50, p99, qps) in lat.items())
          + f" ({TOPK_LAT_REQUESTS} requests each); 0 new allocator "
          f"segments after warmup")
    return lat


def topk_http(art, queries, dev):
    """The f32 MF artifact deployed with retrieval={} behind serve(); 4
    clients x 16 POST /topk of one query each and one POST /predict of 64
    pairs; every answer against the direct engine call. Returns seconds."""
    import threading
    import urllib.request

    from hivemall_tpu_torch.serving import ModelRegistry, serve

    registry = ModelRegistry(max_batch=512, max_delay_ms=2.0, device=dev)
    server = serve(registry, host="127.0.0.1", port=0)
    port = server.server_address[1]
    answers, errors = [], []

    def post(route, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{route}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def client(c):
        for s in range(16):
            q = queries[(c * 16 + s) % len(queries)]
            try:
                answers.append((q, post("/topk", {"model": "rec",
                                                  "queries": [q]})))
            except Exception as e:  # collected and asserted below
                errors.append(repr(e))

    try:
        entry = registry.deploy("rec", art, version="1", retrieval={})
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "an HTTP client hung"
        secs = time.perf_counter() - t0
        pairs = [[q, q % MF_ITEMS] for q in queries[:64]]
        preds = post("/predict", {"model": "rec", "instances": pairs})
        direct = {q: entry.retrieval_engine.topk([q])[0] for q, _ in answers}
        served = entry.engine.predict(pairs)
        models = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/models", timeout=60).read())["models"]
    finally:
        server.shutdown()
        server.server_close()
        registry.shutdown()
    assert not errors, f"failed requests: {errors[:3]}"
    assert len(answers) == 64, f"{len(answers)} of 64 requests answered"
    for q, out in answers:
        assert out["k"] == TOPK_K and len(out["results"]) == 1
        same_ranking("/topk vs the engine", out["results"],
                     [direct[q]])
    np.testing.assert_array_equal(np.asarray(preds["predictions"],
                                             np.float32), served)
    assert models[0]["retrieval"]["enabled"] is True \
        and models[0]["retrieval"]["catalog_items"] == MF_ITEMS, models
    return secs


def phase_topk(seed, dev, smi, held, mf_arts, fm_model, fm_rows):
    """Top-K retrieval on the card: the 131,072-item MF catalog at f32,
    bf16 and int8 (k 16, block_items 4096, max_batch 8) with the LSH probe's
    recall, the 2^22-item FM catalog of phase fm's model (block_items
    65,536), one sweep timed against its bound, and /topk over HTTP."""
    import torch

    from hivemall_tpu_torch.runtime.metrics import REGISTRY
    from hivemall_tpu_torch.serving import RetrievalEngine

    print(f"[topk] card: {smi}; torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"float32_matmul_precision = "
          f"{torch.get_float32_matmul_precision()}")
    queries = [int(x) for x in held[0][:TOPK_QUERIES]]
    # the probe's expected union, 1 + planes buckets of ~n / 2^planes
    # items, doubled for bucket skew (the reference bench's sizing)
    cand_cap = 2 * MF_ITEMS * 9 // 256
    geom = dict(k=TOPK_K, block_items=TOPK_BLOCK, max_batch=8,
                candidate_cap=cand_cap)
    for dtype, art in mf_arts.items():
        eng = RetrievalEngine(art, name=f"smoke_topk_{dtype}", device=dev,
                              **geom)
        cpu = RetrievalEngine(art, name=f"smoke_topk_{dtype}_cpu",
                              device="cpu", **geom)
        topk_engine_checks(f"MF {dtype}", eng, cpu, queries, dev,
                           TOPK_QUERIES)
        p0, f0, c0 = (REGISTRY.counter("retrieval",
                                       f"{eng.name}.{x}").value
                      for x in ("probed", "fallback", "candidates"))
        probed = eng.topk(queries, probe=True)
        exact = eng.topk(queries, probe=False)
        recall = float(np.mean([len(set(p["items"]) & set(e["items"]))
                                / TOPK_K for p, e in zip(probed, exact)]))
        n_p, n_f, n_c = (REGISTRY.counter("retrieval",
                                          f"{eng.name}.{x}").value - v
                         for x, v in (("probed", p0), ("fallback", f0),
                                      ("candidates", c0)))
        frac = n_c / max(1, n_p) / eng.n_items
        print(f"[topk] MF {dtype} probe=True on {TOPK_QUERIES} queries "
              f"(8 planes, candidate_cap {eng.candidate_cap}): recall@"
              f"{TOPK_K} against exact {recall:.4f}, {n_p} probed, {n_f} "
              f"fell back, candidates {frac:.4f} of the catalog per probed "
              f"query")
        if dtype == "float32" and dev.type == "cuda":
            for b in (1, 8):
                t = sweep_timing(eng, b, dev)
                print(f"[topk] one exact sweep of the f32 MF catalog for "
                      f"{b} queries ({t['blocks']} blocks of {TOPK_BLOCK}): "
                      f"{t['ms']:.4f} ms eager, {t['graph_ms']:.4f} ms as "
                      f"one CUDA graph; {t['ops']} device operations = "
                      f"{t['ops'] / t['blocks']:.1f} a block; bound "
                      f"{t['bound_ms']:.6f} ms ({t['bytes']} B read once)")
        del eng, cpu

    fm_queries = fm_rows[:8]
    eng = RetrievalEngine(fm_model, name="smoke_topk_fm", k=TOPK_K,
                          block_items=FM_TOPK_BLOCK, max_batch=8, device=dev)
    cpu = RetrievalEngine(fm_model, name="smoke_topk_fm_cpu", k=TOPK_K,
                          block_items=FM_TOPK_BLOCK, max_batch=8,
                          device="cpu")
    assert eng.n_items == FULL_DIMS
    topk_engine_checks("FM f32 (2^22 features, k 5 in 8 lanes)", eng, cpu,
                       fm_queries, dev, 8)
    del eng, cpu

    secs = topk_http(mf_arts["float32"], queries, dev)
    print(f"[topk] HTTP: 4 clients x 16 POST /topk of one query in "
          f"{secs:.3f} s: 0 failed, every ranking == the direct engine "
          f"call; one POST /predict of 64 pairs == the engine")



MC_LABELS = 26  # the JAX package's multiclass bench shape (scripts/bench_mc.py)
MC_DIMS = 1 << 20
MC_WIDTH = 64
MC_ROWS = 131072
MC_HOLDOUT = 16384
MC_BLOCK = 4096
MC_SCAN_ROWS = 512  # cut from 2,048 for the smoke's time
MC_PA1_C = 0.001  # the served model's aggressiveness cap
MC_RULE_HYPER = {"mc_pa1": {"c": 1.0}, "mc_pa2": {"c": 1.0},
                 "mc_cw": {"phi": 1.0}, "mc_arow": {"r": 0.1},
                 "mc_arowh": {"r": 0.1, "c": 1.0},
                 "mc_scw1": {"phi": 1.0, "c": 1.0},
                 "mc_scw2": {"phi": 1.0, "c": 1.0}}


def mc_data(seed):
    """MC_ROWS training and MC_HOLDOUT held-out rows at the JAX package's
    multiclass bench shape: 64 ids of value 1.0 a row over 2^20 dims, each
    log-uniform over the hashed space (workload_ids). Labels from a planted
    teacher: a row's label is drawn uniformly; half its ids are drawn over
    the space every label shares (the head each row carries), the other
    half over its label's own copy of it, the shared placement shifted by
    a seeded offset per label (the label's topic words)."""
    rng = np.random.RandomState(seed + 41)
    n = MC_ROWS + MC_HOLDOUT
    y = rng.randint(0, MC_LABELS, n).astype(np.int64)
    shared = workload_ids(rng, (n, MC_WIDTH // 2), MC_DIMS)
    offset = rng.randint(0, MC_DIMS, MC_LABELS)
    topic = (workload_ids(rng, (n, MC_WIDTH // 2), MC_DIMS).astype(np.int64)
             + offset[y][:, None]) % MC_DIMS
    idx = np.concatenate([shared.astype(np.int64), topic], axis=1)
    val = np.ones((n, MC_WIDTH), np.float32)
    return ((idx[:MC_ROWS], val[:MC_ROWS], y[:MC_ROWS]),
            (idx[MC_ROWS:], val[MC_ROWS:], y[MC_ROWS:]))


def mc_compare(tag, got, ref):
    """Multiclass state on the card == the same step on the CPU (RTOL /
    ATOL on weights and covariances, touched and step exact); returns
    max |err|."""
    from hivemall_tpu_torch.models.multiclass import mc_state_to_numpy

    (gs, gl), (rs, rl) = got, ref
    a, b = mc_state_to_numpy(gs), mc_state_to_numpy(rs)
    np.testing.assert_allclose(float(gl), float(rl), rtol=RTOL, atol=ATOL,
                               err_msg=f"{tag}: loss")
    err = abs(float(gl) - float(rl))
    for k in ("weights", "covars"):
        if b[k] is None:
            continue
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{tag}: {k}")
        err = max(err, float(np.max(np.abs(a[k] - b[k]))))
    assert np.array_equal(a["touched"], b["touched"]), f"{tag}: touched"
    assert a["step"] == b["step"], f"{tag}: step"
    return err


def mc_rules():
    from hivemall_tpu_torch.models import multiclass as MC

    return [r for r in vars(MC).values() if isinstance(r, MC.MCRule)]


def mc_step_bytes(idx, y, missed):
    """Bytes one minibatch step must move: ids, values and labels read
    once; the weights and covariances of every label at each unique
    feature read once (the [L, B, K] gathers); and the weight, covariance
    and touched entries of the unique (correct row, feature) and (missed
    row, feature) pairs read and written once."""
    u_feat = len(np.unique(idx))
    pairs = np.unique(np.concatenate([(y[:, None] * MC_DIMS + idx).ravel(),
                                      (missed[:, None] * MC_DIMS
                                       + idx).ravel()]))
    return (idx.size * (8 + 4) + len(y) * 8 + u_feat * MC_LABELS * 8
            + 2 * len(pairs) * (4 + 4 + 1)), u_feat, len(pairs)


def mc_card_vs_cpu(dev, train):
    """From one warm state drawn in numpy (covariances in [0.5, 1]): one
    MC_BLOCK-row minibatch block at full width for each of the nine rules,
    and the exact scan of the first MC_SCAN_ROWS rows for AROW and CW, on
    the card and on the CPU; the AROW step timed eager and as one CUDA
    graph with its device operations and byte bound."""
    import torch

    from hivemall_tpu_torch.models import multiclass as MC

    idx, val, y = (c[:MC_BLOCK] for c in train)
    rng = np.random.RandomState(17)
    host = {"weights": (0.1 * rng.randn(MC_LABELS, MC_DIMS))
            .astype(np.float32),
            "covars": rng.uniform(0.5, 1.0, (MC_LABELS, MC_DIMS))
            .astype(np.float32),
            "touched": (rng.rand(MC_LABELS, MC_DIMS) < 0.3).astype(np.int8),
            "step": 1000}
    errs = []
    for rule in mc_rules():
        d0 = dict(host, covars=host["covars"] if rule.use_covariance
                  else None)
        hyper = MC_RULE_HYPER.get(rule.name, {})
        out = [MC.make_mc_train_step(rule, hyper, "minibatch", device=d)(
            MC.mc_state_from_numpy(d0, d), idx, val, y)
            for d in (dev, "cpu")]
        errs.append(f"{rule.name} {mc_compare(rule.name, *out):.3g}")
        del out
    print(f"[mc] one -mini_batch block of {MC_BLOCK} rows at L = "
          f"{MC_LABELS}, D = {MC_DIMS}, K = {MC_WIDTH} from one warm state, "
          f"card == CPU (rtol {RTOL:g} / atol {ATOL:g}, touched and step "
          f"exact) for all nine rules, max|err|: " + ", ".join(errs))

    for name in ("mc_arow", "mc_cw"):
        rule = [r for r in mc_rules() if r.name == name][0]
        hyper = MC_RULE_HYPER[name]
        n = MC_SCAN_ROWS
        out, secs = [], None
        for d in (dev, "cpu"):
            step = MC.make_mc_train_step(rule, hyper, "scan", device=d)
            st = MC.mc_state_from_numpy(host, d)
            res, t = timed(lambda: step(st, train[0][:n], train[1][:n],
                                        train[2][:n]), dev)
            out.append(res)
            secs = secs or t
        e = mc_compare(f"{name} scan", *out)
        print(f"[mc] {name} exact scan (-mini_batch 1) of the first {n} "
              f"rows: card == CPU, max|err| {e:.3g}; on the card "
              f"{secs:.3f} s = {n / secs:.0f} rows/s (plain torch ops, one "
              f"row's launches after another)")

    if dev.type != "cuda":
        return None
    rule = [r for r in mc_rules() if r.name == "mc_arow"][0]
    step = MC.make_mc_train_step(rule, {"r": 0.1}, "minibatch", device=dev)
    st = MC.mc_state_from_numpy(host, dev)
    ti, tv, ty = (torch_on(a, dev) for a in (idx, val, y))
    scores = MC._mc_scores(st.weights, ti, tv)
    missed = torch.argmax(scores.scatter(1, ty[:, None], MC.NEG_INF),
                          dim=1).cpu().numpy()

    def run():
        step(st, ti, tv, ty)

    eager, graph, ops = cuda_ms(run, 20), graph_ms(run, 20), device_ops(run)
    nbytes, u_feat, n_pairs = mc_step_bytes(idx, y, missed)
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    print(f"[mc] AROW minibatch step (the train path's, B={MC_BLOCK}, "
          f"K={MC_WIDTH}, L={MC_LABELS}, D={MC_DIMS}; {u_feat} unique "
          f"features, {n_pairs} unique (row, feature) pairs updated): "
          f"{eager:.4f} ms eager = {MC_BLOCK / eager * 1e3:.0f} rows/s, "
          f"{graph:.4f} ms as one CUDA graph; "
          f"{ops if ops else 'not measured'} device operations; bound "
          f"{bound:.6f} ms by bytes ({nbytes} B)")
    return {"ms": eager, "graph_ms": graph, "ops": ops, "bound_ms": bound}


def mc_raw_scores(eng, idx, val, n):
    """The engine's [n, L] per-label scores of the first n rows (one
    padded bucket), on the host."""
    raw = eng.servable.run_padded(flat_rows(idx, val, 0, n), n, 256)
    return raw.detach().cpu().numpy()[:n]


def phase_mc(seed, dev, smi, linear_model):
    """Multiclass at the JAX package's bench shape: train_multiclass_arow
    -mini_batch 4096 (seconds, rows/s, host staging apart, whether its
    tables stay finite, holdout accuracy) and train_multiclass_pa1 -c
    MC_PA1_C with the same options (holdout accuracy, asserted well above
    chance), card == CPU per rule on one block and on the scan's prefix,
    the step timed, then the PA1 model frozen at f32 / bf16 / int8,
    served, and /predict over HTTP beside main's linear model. Returns the
    PA1 model's (accuracy, seconds) and the step timing."""
    import tempfile

    import torch

    from hivemall_tpu_torch.io.checkpoint import dequantize_int8
    from hivemall_tpu_torch.models.multiclass import (
        train_multiclass_arow, train_multiclass_pa1)
    from hivemall_tpu_torch.serving import ServingEngine

    train, (h_idx, h_val, h_y) = mc_data(seed)
    idx, val, y = train
    counts = np.bincount(y, minlength=MC_LABELS)
    majority = float(counts.max() / len(y))
    print(f"[mc] card: {smi}; L = {MC_LABELS} labels x D = {MC_DIMS}, "
          f"{MC_WIDTH} log-uniform ids a row, {MC_ROWS} training rows "
          f"({int(np.count_nonzero(counts))} labels present, the largest "
          f"{majority:.4f} of the rows), {MC_HOLDOUT} held out")
    feats = (list(idx), list(val))
    hold = (list(h_idx), list(h_val))
    opts = f"-dims {MC_DIMS} -mini_batch {MC_BLOCK}"
    staging = stage_rows_secs(feats, y.astype(np.float32), MC_DIMS, MC_BLOCK)
    arow, secs = timed(lambda: train_multiclass_arow(feats, y, opts,
                                                     device=dev), dev)
    assert arow.state.weights.device.type == dev.type, "state not on dev"
    finite = bool(torch.isfinite(arow.state.weights).all()
                  and torch.isfinite(arow.state.covars).all())
    cov_min = float(torch.nan_to_num(arow.state.covars, nan=0.0).min())
    acc = float(np.mean(np.asarray(arow.predict(hold)) == h_y)) \
        if finite else float("nan")
    print(f"[mc] train_multiclass_arow {opts}: {MC_ROWS} rows in "
          f"{secs:.3f} s = {MC_ROWS / secs:.0f} rows/s; host staging of the "
          f"same rows (timed apart) {staging:.3f} s; tables finite: "
          f"{finite}, smallest covariance {cov_min:.4g}, holdout accuracy "
          f"{acc:.4f} (chance {1 / MC_LABELS:.4f}). A block sums every "
          f"duplicate lane's covariance delta, as the JAX package's "
          f".at[].add does, so a head feature's covariance goes negative "
          f"within the first block at this shape in both packages")
    p_opts = f"{opts} -c {MC_PA1_C}"
    model, p_secs = timed(lambda: train_multiclass_pa1(
        feats, y, p_opts, device=dev), dev)
    assert torch.isfinite(model.state.weights).all(), "mc: not finite"
    pred = model.predict(hold)
    p_acc = float(np.mean(np.asarray(pred) == h_y))
    rows = model.model_rows()
    assert len(rows) == 3 and len(rows[0]) == len(rows[1]) > 0, "model_rows"
    print(f"[mc] train_multiclass_pa1 {p_opts}: {MC_ROWS} rows in "
          f"{p_secs:.3f} s = {MC_ROWS / p_secs:.0f} rows/s; holdout "
          f"accuracy {p_acc:.4f} (chance {1 / MC_LABELS:.4f}, the largest "
          f"label {majority:.4f}); model_rows {len(rows[0])} (label, "
          f"feature) entries; largest |weight| "
          f"{float(model.state.weights.abs().max()):.4g}; this model is the "
          f"one served below (PA1's capped step keeps each summed update "
          f"small)")
    assert p_acc > 2.0 / MC_LABELS and p_acc > majority, \
        f"mc: holdout accuracy {p_acc} is near chance"

    timing = mc_card_vs_cpu(dev, train)

    n = 512
    with tempfile.TemporaryDirectory(prefix="hivemall_mc_") as tmp:
        paths, arts, engines = frozen_engines(model, tmp, "mc", "mc",
                                              "smoke_mc", dev)
        cpu = ServingEngine(arts["bfloat16"], name="smoke_mc_bf16_cpu",
                            max_batch=512, max_width=256, device="cpu")
        a = arts["int8"].arrays
        W = dequantize_int8(a["weights"], a["weights__scale"], 64, axis=1)
        q8 = np.sum(W[:, h_idx[:n]].astype(np.float64) * h_val[:n],
                    axis=-1).T
        want = {"bfloat16": mc_raw_scores(cpu, h_idx, h_val, n),
                "int8": q8}
        nb = MC_DIMS // 64
        expect = {"float32": 4 * MC_LABELS * MC_DIMS,
                  "bfloat16": 2 * MC_LABELS * MC_DIMS,
                  "int8": MC_LABELS * MC_DIMS + 4 * MC_LABELS * nb}
        live = model.predict(hold)
        for dtype, eng in engines.items():
            assert eng.table_bytes == expect[dtype], \
                f"mc {dtype}: table_bytes {eng.table_bytes}"
            served = eng.predict(flat_rows(h_idx, h_val, 0, len(h_y)))
            h_acc = float(np.mean(np.asarray(served) == h_y))
            if dtype == "float32":
                assert list(served) == list(live), \
                    "mc f32: served labels != model.predict"
                line = "labels == model.predict on every held-out row"
            else:
                got = mc_raw_scores(eng, h_idx, h_val, n)
                np.testing.assert_allclose(got, want[dtype], rtol=1e-5,
                                           atol=1e-6,
                                           err_msg=f"mc {dtype} scores")
                line = (f"{n} rows' per-label scores == "
                        f"{'the CPU engine' if dtype == 'bfloat16' else 'numpy on the dequantized table'}"
                        f" (rtol 1e-5 / atol 1e-6), largest |diff| "
                        f"{float(np.max(np.abs(got - want[dtype]))):.3g}")
            print(f"[mc] {dtype}: {line}; holdout accuracy {h_acc:.4f}")
        latency_report("mc", "smoke_mc", engines, h_idx, h_val)
        rows = string_rows(h_idx, h_val, 4096)
        ref = engines["float32"].predict(flat_rows(h_idx, h_val, 0, 4096))
        http_secs = http_beside_ctr(linear_model, "mc", "multiclass",
                                    paths["float32"], rows, ref, dev, 16)
    print(f"[mc] HTTP: 4 clients x 16 POST /predict of 64 string rows for "
          f"mc in {http_secs:.3f} s beside the linear model ctr: 0 failed, "
          f"every answer == the f32 engine's labels")
    return p_acc, p_secs, timing


FFM_FEATURE_BITS = 20  # the JAX package's FFM bench shape (bench_ffm.py)
FFM_V_BITS = 22
FFM_K = 4
FFM_FIELDS = 64
FFM_WIDTH = 32
FFM_ROWS = 32768  # cut from 131,072 for the smoke's time
FFM_HOLDOUT = 16384
FFM_BLOCK = 4096
FFM_CHUNK = 512
FFM_CHUNK_ROWS = 16384  # the -row_chunk train: cut from 131,072 for time
FFM_SCAN_ROWS = 512  # cut from 1,024 for the smoke's time
FFM_TEACHER_RANK = 2
FFM_TEACHER_HEAD = 1024
FFM_LAT_REQUESTS = 20


def ffm_data(seed):
    """FFM_ROWS training and FFM_HOLDOUT held-out rows of "field:idx:1"
    strings at the JAX package's FFM bench shape: 32 log-uniform ids a row
    over 2^20 features (workload_ids), each feature in one field of 64
    drawn uniformly (a CTR log's layout: an id belongs to its column).
    Labels from
    a planted field-aware teacher over the FFM_TEACHER_HEAD most frequent
    features (half the lanes): such a feature carries a scalar c and a
    weight a, a field pair (p, q) a weight M[p, q] of rank
    FFM_TEACHER_RANK, and a row scores sum_{i<j} M[f_i, f_j] c_i c_j +
    sum_i a_i over its head lanes; the label is the score's side of the
    median. Returns (training rows, labels), (held-out rows, labels)."""
    rng = np.random.RandomState(seed + 51)
    n, d = FFM_ROWS + FFM_HOLDOUT, 1 << FFM_FEATURE_BITS
    idx = workload_ids(rng, (n, FFM_WIDTH), d).astype(np.int64)
    # each feature belongs to one field, the fields uniform over 64
    fld = rng.randint(0, FFM_FIELDS, d)[idx]
    # a feature's frequency rank: workload_ids places rank r at perm[r]
    rank = np.empty(d, np.int64)
    rank[np.random.RandomState(12345).permutation(d)] = np.arange(d)
    head = rank < FFM_TEACHER_HEAD
    u = rng.randn(FFM_FIELDS, FFM_TEACHER_RANK)
    M = u @ u.T
    c = np.where(head, rng.randn(d), 0.0)
    a = np.where(head, 0.3 * rng.randn(d), 0.0)
    score = np.empty(n)
    for s in range(0, n, 4096):
        f, cc = fld[s:s + 4096], c[idx[s:s + 4096]]
        mb = M[f[:, :, None], f[:, None, :]]
        score[s:s + 4096] = 0.5 * (
            np.einsum("bi,bij,bj->b", cc, mb, cc)
            - np.einsum("bi,bii->b", cc * cc, mb)) \
            + a[idx[s:s + 4096]].sum(axis=1)
    y = np.where(score > np.median(score), 1.0, -1.0).astype(np.float32)
    rows = [[f"{p}:{i}:1" for p, i in zip(fr, ir)]
            for fr, ir in zip(fld.tolist(), idx.tolist())]
    return (rows[:FFM_ROWS], y[:FFM_ROWS]), (rows[FFM_ROWS:], y[FFM_ROWS:])


def ffm_compare(tag, got, ref):
    """FFM state on the card == the same step on the CPU (RTOL / ATOL on
    every float table, touched and step exact); returns max |err|."""
    from hivemall_tpu_torch.models.ffm import ffm_state_to_numpy

    (gs, gl), (rs, rl) = got, ref
    a, b = ffm_state_to_numpy(gs), ffm_state_to_numpy(rs)
    np.testing.assert_allclose(float(gl), float(rl), rtol=RTOL, atol=ATOL,
                               err_msg=f"{tag}: loss")
    err = abs(float(gl) - float(rl))
    for k in ("w0", "w", "z", "n", "v", "v_gg"):
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{tag}: {k}")
        err = max(err, float(np.max(np.abs(a[k] - b[k]))))
    assert np.array_equal(a["touched"], b["touched"]), f"{tag}: touched"
    assert a["step"] == b["step"], f"{tag}: step"
    return err


def ffm_step_bytes(idx, fld, hyper):
    """Bytes one minibatch step must move: ids, values and fields read
    once, labels once; the V row and AdaGrad entry of every unique pair
    key read and written once; w, z, n and touched of every unique feature
    read and written once."""
    from hivemall_tpu_torch.models.ffm import _row_pair_keys

    keys = _row_pair_keys(idx, fld.astype(np.int64), hyper.v_dims)
    u_keys = len(np.unique(keys))
    u_feat = len(np.unique(idx[idx < hyper.num_features]))
    return (idx.size * (8 + 4 + 8) + idx.shape[0] * 4
            + 2 * u_keys * (hyper.factors + 1) * 4
            + 2 * u_feat * (3 * 4 + 1)), u_keys, u_feat


def ffm_card_vs_cpu(dev, hyper, staged):
    """From one warm state (V the seeded draw, AdaGrad accumulators of
    keys already seen): one FFM_BLOCK-row block
    with -w0, unchunked and with -row_chunk FFM_CHUNK, V packed, and the
    exact scan of the first FFM_SCAN_ROWS rows, each on the card and on
    the CPU; then per variant on the card the step's peak allocated
    memory, its time eager and as one CUDA graph, device operations and
    byte bound."""
    import dataclasses

    import torch

    from hivemall_tpu_torch.models import ffm as FF

    hyper = dataclasses.replace(hyper, global_bias=True)
    rng = np.random.RandomState(23)
    d = hyper.num_features
    host = {"w0": np.float32(0.1),
            "w": (0.1 * rng.randn(d)).astype(np.float32),
            "z": (0.2 * rng.randn(d)).astype(np.float32),
            "n": rng.uniform(0, 1, d).astype(np.float32),
            "v": FF.initial_v(hyper),
            # accumulators of keys already seen: from a zero one, V's
            # first AdaGrad rate is eta0_V / sqrt(eps) = 1, which makes the
            # scan's rows chaotic in float order (V runs away)
            "v_gg": rng.uniform(50, 150, hyper.v_dims).astype(np.float32),
            "touched": (rng.rand(d) < 0.3).astype(np.int8), "step": 1000}
    blk = tuple(a[:FFM_BLOCK] for a in staged)
    for chunk in (None, FFM_CHUNK):
        out = [FF.make_ffm_step(hyper, "minibatch", row_chunk=chunk,
                                pack_v=True, device=dv)(
            FF.ffm_state_from_numpy(host, dv), *blk) for dv in (dev, "cpu")]
        e = ffm_compare(f"ffm block row_chunk={chunk}", *out)
        del out
        print(f"[ffm] -mini_batch block of {FFM_BLOCK} rows with -w0, "
              f"row_chunk {chunk}, V packed: card == CPU (rtol {RTOL:g} / "
              f"atol {ATOL:g}, touched and step exact), max|err| {e:.3g}")
    n = FFM_SCAN_ROWS
    out, secs = [], None
    for dv in (dev, "cpu"):
        step = FF.make_ffm_step(hyper, "scan", device=dv)
        st = FF.ffm_state_from_numpy(host, dv)
        res, t = timed(lambda: step(st, *(a[:n] for a in staged)), dev)
        out.append(res)
        secs = secs or t
    e = ffm_compare("ffm scan", *out)
    del out
    print(f"[ffm] exact scan (-mini_batch 1) of the first {n} rows with "
          f"-w0: card == CPU, max|err| {e:.3g}; on the card {secs:.3f} s = "
          f"{n / secs:.0f} rows/s (plain torch ops, one row's launches "
          f"after another)")
    if dev.type != "cuda":
        return {}
    nbytes, u_keys, u_feat = ffm_step_bytes(blk[0].astype(np.int64), blk[2],
                                            hyper)
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    timing = {}
    for chunk in (None, FFM_CHUNK):
        step = FF.make_ffm_step(hyper, "minibatch", row_chunk=chunk,
                                device=dev)
        st = FF.ffm_state_from_numpy(host, dev)
        args = [torch_on(a, dev) for a in blk]
        args[0], args[2] = args[0].long(), args[2].long()
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        step(st, *args)
        sync(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base

        def run():
            step(st, *args)

        timing[chunk] = (cuda_ms(run, 10), graph_ms(run, 10),
                         device_ops(run), peak)
        eager, graph, ops, _ = timing[chunk]
        print(f"[ffm] minibatch step row_chunk={chunk} (B={FFM_BLOCK}, "
              f"K={FFM_WIDTH}, k={FFM_K}, {u_keys} unique pair keys, "
              f"{u_feat} unique features): peak allocated memory of one "
              f"step {peak / 2 ** 20:.1f} MiB above the state; {eager:.4f} "
              f"ms eager = {FFM_BLOCK / eager * 1e3:.0f} rows/s, "
              f"{graph:.4f} ms as one CUDA graph; "
              f"{ops if ops else 'not measured'} device operations; bound "
              f"{bound:.6f} ms by bytes ({nbytes} B)")
    return {"bound_ms": bound, "timing": timing}


def phase_ffm(seed, dev, smi, linear_model):
    """FFM at the JAX package's bench shape: train_ffm -mini_batch 4096,
    unchunked and with -row_chunk 512 on FFM_CHUNK_ROWS rows (seconds, rows/s, parse and staging
    apart, the V draw apart, holdout logloss beside the constant
    predictor's, the largest |V|), card == CPU on one block and on the
    scan's prefix, the step timed, then the model frozen at f32 (its
    blob), loaded, served and answered over HTTP beside main's linear
    model. Returns the unchunked train's (logloss, seconds) and the step
    timing."""
    import tempfile

    import torch

    from hivemall_tpu_torch.models import ffm as FF
    from hivemall_tpu_torch.serving import ServingEngine, freeze, load
    from hivemall_tpu_torch.utils import jax_prng

    (rows, y), (h_rows, h_y) = ffm_data(seed)
    opts = (f"-factor {FFM_K} -feature_hashing {FFM_FEATURE_BITS} -v_bits "
            f"{FFM_V_BITS} -num_fields {FFM_FIELDS} -mini_batch {FFM_BLOCK}")
    hyper = FF.ffm_hyper_from_options(FF._ffm_options().parse(opts, "smoke"))
    print(f"[ffm] card: {smi}; 2^{FFM_FEATURE_BITS} features, 2^"
          f"{FFM_V_BITS} V rows x k = {FFM_K}, {FFM_FIELDS} fields, "
          f"{FFM_WIDTH} tokens a row, {FFM_ROWS} training rows, "
          f"{FFM_HOLDOUT} held out")
    jax_prng.clear_cache()
    _, draw_secs = timed(lambda: FF.initial_v(hyper), dev)
    staged, parse_secs = timed(
        lambda: FF._stage_ffm_rows(rows, y, hyper), dev)
    p1 = float(np.mean(y > 0))
    hy01 = (h_y > 0).astype(np.float32)
    const_ll = float(-np.mean(hy01 * np.log(p1)
                              + (1 - hy01) * np.log(1 - p1)))
    out = {}
    for chunk in (None, FFM_CHUNK):
        o = opts + (f" -row_chunk {chunk}" if chunk else "")
        n = FFM_CHUNK_ROWS if chunk else FFM_ROWS
        model, secs = timed(
            lambda: FF.train_ffm(rows[:n], y[:n], o, device=dev), dev)
        assert model.state.v.device.type == dev.type, "state not on dev"
        assert torch.isfinite(model.state.v).all() \
            and torch.isfinite(model.state.w).all(), "ffm: not finite"
        p = model.predict(h_rows)
        assert p.shape == (FFM_HOLDOUT,) and np.all(np.isfinite(p))
        acc, ll = log_loss_acc(p, hy01)
        feats, w, _ = model.model_rows()
        out[chunk] = (model, ll, secs)
        print(f"[ffm] train_ffm {o}: {n} rows in {secs:.3f} s = "
              f"{n / secs:.0f} rows/s; timed apart in calls of their "
              f"own, the rows' parse and staging {parse_secs:.3f} s and the "
              f"V draw on the host ({hyper.v_dims} x {FFM_K}, JAX's stream) "
              f"{draw_secs:.3f} s; holdout logloss {ll:.4f} (the constant "
              f"predictor's {const_ll:.4f}), accuracy {acc:.4f}; largest "
              f"|V| {float(model.state.v.abs().max()):.4g}; model_rows "
              f"{len(feats)} features")
    print("[ffm] (a -mini_batch block sums every duplicate pair key's V "
          "step, each at AdaGrad's first rate eta0_V / sqrt(eps) = 1 from a "
          "zero accumulator, as the JAX package's .at[].add does; a head "
          "feature's keys take thousands of steps in one block, and V grows "
          "to ~4e5 in both packages at this shape)")
    model, ll, secs = out[None]
    del out

    timing = ffm_card_vs_cpu(dev, hyper, staged[:4])

    with tempfile.TemporaryDirectory(prefix="hivemall_ffm_") as tmp:
        path = f"{tmp}/ffm_float32"
        _, f_secs = timed(lambda: freeze(model, path, name="ffm"), dev)
        art, l_secs = timed(lambda: load(path), dev)
        eng = ServingEngine(art, name="smoke_ffm", max_batch=512,
                            max_width=64, device=dev)
        sync(dev)
        segs = eng.warmup()
        n = 2048
        got = eng.predict(h_rows[:n])
        want = model.predict(h_rows[:n])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg="ffm served != model.predict")
        print(f"[ffm] float32 artifact: blob {art.arrays['blob'].size} B, "
              f"freeze {f_secs:.3f} s, load {l_secs:.3f} s; table_bytes "
              f"{eng.table_bytes}; warmup of {len(eng.warmed_buckets)} "
              f"buckets, {segs} new allocator segments; {n} held-out rows "
              f"served == model.predict (rtol 1e-6 / atol 1e-7), largest "
              f"|diff| {float(np.max(np.abs(got - want))):.3g}")
        from hivemall_tpu_torch.runtime.metrics import REGISTRY

        counter = REGISTRY.counter("allocator",
                                   "new_segments.serving.smoke_ffm")
        before = counter.value
        lat = []
        for m in (1, 64, 512):
            secs_l = []
            for s in range(0, FFM_LAT_REQUESTS * 8, 8):
                t0 = time.perf_counter()
                eng.predict(h_rows[s:s + m])
                secs_l.append(time.perf_counter() - t0)
            lat.append(f"{m} rows p50 {percentile_ms(secs_l, 50):.4f} / p99 "
                       f"{percentile_ms(secs_l, 99):.4f} ms")
        assert counter.value == before, "ffm: allocator segments after warmup"
        print(f"[ffm] latency over {FFM_LAT_REQUESTS} requests each (string "
              f"rows parsed on the host): " + "; ".join(lat)
              + "; 0 new allocator segments after warmup")
        ref = eng.predict(h_rows[:1024])
        http_secs = http_beside_ctr(
            linear_model, "ffm", "ffm", path, h_rows[:1024], ref, dev, 4,
            max_width=64, ctr_rows=[[t.split(":", 1)[1] for t in r]
                                    for r in h_rows[:64]])
    print(f"[ffm] HTTP: 4 clients x 4 POST /predict of 64 FFM string rows "
          f"in {http_secs:.3f} s beside the linear model ctr: 0 failed, "
          f"answers == the ffm engine")
    return ll, secs, timing


TREE_ROWS = 20000  # the JAX package's forest bench shape (bench_forest.py)
TREE_FEATURES = 20
TREE_TREES = 16  # cut from the bench's 32 for the smoke's time
GBT_ROWS = 50000  # ... and its GBT bench shape
GBT_OPTS = "-trees 16 -iters 16 -depth 6 -seed 3"
GBT_TOL = (1e-5, 1e-6)
REGR_TREES = 8
COVER_ROWS = 581012  # the UCI Covertype data set's shape: 10 quantitative
COVER_Q = 10  # columns, 4 wilderness and 40 soil one-hot columns, 7 classes
COVER_WILDERNESS = 4
COVER_SOIL = 40
COVER_CLASSES = 7
COVER_HOLDOUT = 1 << 16
COVER_TREES = 16  # cut from 32 for the smoke's time
COVER_S = 512  # the widest frontier at the default 512 leaves
TREE_LAT_REQUESTS = 100


def bench_rows(rng, n, f):
    """scripts/bench_forest.py's rows: uniform features, the label
    (x0 > .5) XOR (x1 > .5) OR (x2 > .8)."""
    X = rng.rand(n, f)
    y = ((X[:, 0] > 0.5) ^ (X[:, 1] > 0.5) | (X[:, 2] > 0.8)).astype(int)
    return X, y


def cover_data(seed):
    """Rows of the Covertype data set's shape, drawn from ``seed``: ten
    integer-valued quantitative columns in the data set's ranges (elevation,
    aspect, slope, hydrology / road / fire distances, three hillshades),
    one-hot wilderness (4) and soil (40) columns, and 7 cover classes from
    elevation bands moved by wilderness, slope, water distance and soil
    group, 5% of labels redrawn. Returns ((X, y) train, (X, y) held out)."""
    rng = np.random.RandomState(seed + 54)
    n = COVER_ROWS + COVER_HOLDOUT

    def col(draw, lo, hi):
        return np.clip(np.round(draw), lo, hi)

    q = [col(rng.normal(2960, 280, n), 1859, 3858),
         rng.randint(0, 361, n).astype(np.float64),
         col(rng.gamma(3.0, 4.7, n), 0, 66),
         col(rng.exponential(270, n), 0, 1397),
         col(rng.normal(46, 58, n), -173, 601),
         col(rng.exponential(2350, n), 0, 7117),
         col(rng.normal(212, 27, n), 0, 254),
         col(rng.normal(223, 20, n), 0, 254),
         col(rng.normal(143, 38, n), 0, 254),
         col(rng.exponential(1980, n), 0, 7173)]
    wild = rng.choice(COVER_WILDERNESS, n, p=[0.45, 0.05, 0.44, 0.06])
    soil = rng.randint(0, COVER_SOIL, n)
    X = np.zeros((n, COVER_Q + COVER_WILDERNESS + COVER_SOIL))
    X[:, :COVER_Q] = np.stack(q, 1)
    X[np.arange(n), COVER_Q + wild] = 1.0
    X[np.arange(n), COVER_Q + COVER_WILDERNESS + soil] = 1.0
    score = (q[0] + 60.0 * (wild == 2) - 80.0 * (wild == 3)
             + 4.0 * (q[2] - 14.0) - 0.05 * q[3] + 30.0 * (soil % 7 == 0))
    y = np.digitize(score, [2450, 2650, 2850, 3000, 3150, 3300])
    noise = rng.rand(n) < 0.05
    y[noise] = rng.randint(0, COVER_CLASSES, int(noise.sum()))
    return ((X[:COVER_ROWS], y[:COVER_ROWS]),
            (X[COVER_ROWS:], y[COVER_ROWS:]))


def same_trees(got, want, values=True):
    """Two lists of TreeArrays equal node for node: the structure exact,
    and with ``values`` the leaf values and class counts exact too."""
    if len(got) != len(want):
        return False
    keys = ("feature", "threshold_bin", "nominal", "left", "right") + (
        ("leaf_value",) if values else ())
    for a, b in zip(got, want):
        if a.n_nodes != b.n_nodes or not all(
                np.array_equal(getattr(a, k), getattr(b, k)) for k in keys):
            return False
        if values and ((a.leaf_dist is None) != (b.leaf_dist is None) or (
                a.leaf_dist is not None
                and not np.array_equal(a.leaf_dist, b.leaf_dist))):
            return False
    return True


def same_forest(got, want):
    """Trees node for node, and the OOB counts and exported text equal."""
    return same_trees([t.tree for t in got.trees],
                      [t.tree for t in want.trees]) and all(
        (a.oob_errors, a.oob_tests, a.model)
        == (b.oob_errors, b.oob_tests, b.model)
        for a, b in zip(got.trees, want.trees))


def forest_line(f):
    nodes = sum(t.tree.n_nodes for t in f.trees)
    depth = max(t.tree.max_depth_used for t in f.trees)
    oob = sum(t.oob_errors for t in f.trees) / max(
        1, sum(t.oob_tests for t in f.trees))
    return nodes, depth, oob


def host_ms(fn, dev, reps):
    """Mean host-clock ms of fn() ending in a synchronize, after one
    warm-up call: what a level pays eager, the host's issue cost
    included."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return 1e3 * (time.perf_counter() - t0) / reps


def tree_level_timing(Xb, y, w, n_bins, nominal, dev):
    """One grow_tree level of the Covertype-shaped fit at the widest
    frontier (S = COVER_S, a tenth of the rows settled): the histogram
    scatter (hoisted lane offsets and weights, as grow_tree builds them
    once per tree), the split search and the routing step, each eager on
    the host clock and by CUDA events, beside its byte bound. Bounds count
    each input read once and each output written once: the scatter reads
    the binned rows, labels, weights and slots and writes the histogram;
    the split reads the histogram and writes S rows; routing needs one bin
    a row, its slot and its next slot. Returns {name: (eager, events,
    bound_ms, bytes)}."""
    import torch

    from hivemall_tpu_torch.models.trees import grow as TG

    N, F = Xb.shape
    S, C = COVER_S, COVER_CLASSES
    rng = np.random.RandomState(3)
    Xbt = torch.from_numpy(Xb).to(dev)
    yt = torch.from_numpy(y.astype(np.int32)).to(dev)
    wt = torch.from_numpy(w).to(dev)
    a = rng.randint(0, S, N).astype(np.int32)
    a[rng.rand(N) < 0.1] = -1
    at = torch.from_numpy(a).to(dev)
    offsets = TG._lane_offsets(Xbt, n_bins, C, yt)
    values = (TG._lanes(wt, F),)
    block = F * n_bins * C
    hist = TG._scatter_hist(offsets, at, S, block, values)[0].reshape(
        S, F, n_bins, C)
    nomt = torch.from_numpy(nominal).to(dev)
    feat_ok = torch.from_numpy(TG._feature_subspace(
        S, S, F, int(np.ceil(np.sqrt(F))), rng)).to(dev)
    feat = rng.randint(0, F, S).astype(np.int32)
    tabs = TG._route_tables(
        feat, rng.randint(0, n_bins, S).astype(np.int32), nominal[feat],
        rng.randint(0, 2 * S, S).astype(np.int32),
        rng.randint(0, 2 * S, S).astype(np.int32), rng.rand(S) < 0.2, dev)
    hist_bytes = S * F * n_bins * C * 4
    steps = {
        "hist": (lambda: TG._scatter_hist(offsets, at, S, block, values),
                 N * F * 4 + 3 * N * 4 + hist_bytes),
        "split": (lambda: TG._best_split_classification(
            hist, nomt, feat_ok, "gini", 1.0),
            hist_bytes + S * F + F + S * (3 + C) * 4),
        "route": (lambda: TG._route(Xbt, at, *tabs), 3 * N * 4 + 6 * S * 4),
    }
    out = {}
    for name, (fn, nbytes) in steps.items():
        out[name] = (host_ms(fn, dev, 5), cuda_ms(fn, 5),
                     1e3 * nbytes / HBM_BYTES_PER_S, nbytes)
    out["split_ops"] = device_ops(steps["split"][0])
    return out


def tree_serving(name, model, X, dev, tmp):
    """Freeze ``model`` under ``tmp``, load it, warm one engine on ``dev``
    (max_batch 512), hold its labels against ``model.predict`` on 4,096
    rows, and time TREE_LAT_REQUESTS requests of 1 / 64 / 512 rows with no
    new allocator segment after warmup. Returns (path, engine)."""
    import os

    from hivemall_tpu_torch.runtime.metrics import REGISTRY
    from hivemall_tpu_torch.serving import ServingEngine, freeze, load

    path = f"{tmp}/{name}"
    t0 = time.perf_counter()
    freeze(model, path, name=name)
    t1 = time.perf_counter()
    art = load(path)
    t2 = time.perf_counter()
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    tag = f"smoke_{name}"
    eng = ServingEngine(art, name=tag, max_batch=512, device=dev)
    segs = eng.warmup()
    n = 4096
    served = eng.predict(X[:n])
    assert np.array_equal(served, model.predict(X[:n])), \
        f"trees {name}: served labels != predict"
    counter = REGISTRY.counter("allocator", f"new_segments.serving.{tag}")
    before = counter.value
    rng = np.random.RandomState(6)
    lat = []
    for m in (1, 64, 512):
        secs = []
        for s in rng.randint(0, len(X) - m, size=TREE_LAT_REQUESTS):
            t = time.perf_counter()
            eng.predict(X[s:s + m])
            secs.append(time.perf_counter() - t)
        lat.append(f"{m} rows p50 {percentile_ms(secs, 50):.4f} / p99 "
                   f"{percentile_ms(secs, 99):.4f} ms")
    assert counter.value == before, \
        f"trees {name}: {counter.value - before} allocator segments"
    print(f"[trees] serve {name}: artifact {nbytes} B, freeze {t1 - t0:.3f} "
          f"s, load {t2 - t1:.3f} s; table_bytes {eng.table_bytes} on the "
          f"card; warmup of {len(eng.warmed_buckets)} buckets, {segs} new "
          f"allocator segments; labels == predict on {n} rows; latency over "
          f"{TREE_LAT_REQUESTS} requests each: " + "; ".join(lat)
          + "; 0 new allocator segments after warmup")
    return path, eng


def phase_trees(seed, dev, smi, linear_model, ctr_rows):
    """Random forests and GBT: the bench forest card == CPU and batched ==
    per_tree node for node, the bench GBT card against the CPU and against
    itself, an integer-target regression forest card == CPU, a forest
    fit at the Covertype data set's shape with its per-level timing, then
    both models frozen, served and over HTTP beside main's linear model."""
    import tempfile

    import torch

    from hivemall_tpu_torch.models.trees import binning as TB
    from hivemall_tpu_torch.models.trees import forest as TF
    from hivemall_tpu_torch.models.trees import grow as TG

    cpu = torch.device("cpu")
    rng = np.random.RandomState(seed)
    print(f"[trees] card: {smi}")
    X, y = bench_rows(rng, TREE_ROWS, TREE_FEATURES)
    opts = f"-trees {TREE_TREES} -seed 1"
    card, secs = timed(lambda: TF.train_randomforest_classifier(
        X, y, opts, device=dev), dev)
    ref, cpu_secs = timed(lambda: TF.train_randomforest_classifier(
        X, y, opts, device=cpu), cpu)
    assert same_forest(card, ref), "trees: bench forest card != CPU"
    batched, b_secs = timed(lambda: TF.train_randomforest_classifier(
        X, y, opts + " -grow batched", device=dev), dev)
    assert same_forest(batched, card), "trees: batched != per_tree"
    nodes, depth, oob = forest_line(card)
    print(f"[trees] train_randomforest_classifier {opts} on {TREE_ROWS} x "
          f"{TREE_FEATURES} (bench_forest.py's rows; depth 16, 512 leaves "
          f"by default): card {secs:.3f} s, CPU {cpu_secs:.3f} s, -grow "
          f"batched on the card {b_secs:.3f} s; {nodes} nodes, depth "
          f"{depth}, OOB error {oob:.4f}; card == CPU node for node on every "
          f"tree with OOB errors and opscode text identical; batched == "
          f"per_tree node for node")

    Xg, yg = bench_rows(rng, GBT_ROWS, TREE_FEATURES)
    g1, g_secs = timed(lambda: TF.train_gradient_tree_boosting_classifier(
        Xg, yg, GBT_OPTS, device=dev), dev)
    g2, _ = timed(lambda: TF.train_gradient_tree_boosting_classifier(
        Xg, yg, GBT_OPTS, device=dev), dev)
    gc, gc_secs = timed(lambda: TF.train_gradient_tree_boosting_classifier(
        Xg, yg, GBT_OPTS, device=cpu), cpu)
    s1, s2, sc = (g.decision_function(Xg) for g in (g1, g2, gc))
    flat = [[t for r in g.trees for t in r] for g in (g1, g2, gc)]
    same_rounds = sum(same_trees([a], [b]) for a, b in zip(flat[0], flat[2]))
    same_shape = sum(same_trees([a], [b], values=False)
                     for a, b in zip(flat[0], flat[2]))
    runs_equal = same_trees(flat[0], flat[1]) and np.array_equal(s1, s2)
    close = bool(np.allclose(s1, sc, rtol=GBT_TOL[0], atol=GBT_TOL[1]))
    share = float(np.mean(g1.predict(Xg) == gc.predict(Xg)))
    acc = float(np.mean(g1.predict(Xg) == yg))
    print(f"[trees] train_gradient_tree_boosting_classifier {GBT_OPTS} on "
          f"{GBT_ROWS} x {TREE_FEATURES}: card {g_secs:.3f} s, CPU "
          f"{gc_secs:.3f} s; training accuracy {acc:.4f}; card vs CPU: "
          f"{same_rounds} of {len(flat[0])} trees equal node for node "
          f"({same_shape} in structure), "
          f"decision scores within rtol {GBT_TOL[0]:g} / atol "
          f"{GBT_TOL[1]:g}: {close} (largest |diff| "
          f"{float(np.max(np.abs(s1 - sc))):.3g}), equal predictions "
          f"{share:.6f}; two card runs bit-equal: {runs_equal} (largest "
          f"|diff| {float(np.max(np.abs(s1 - s2))):.3g}; every histogram "
          f"bin adds its lanes in lane order, on both devices)")
    assert runs_equal, "trees: two card runs of the bench GBT differ"

    yr = (np.floor(4 * X[:, 0]) - np.floor(2 * X[:, 3])
          + (X[:, 2] > 0.8)).astype(np.float32)
    r_opts = f"-trees {REGR_TREES} -seed 2"
    rc, r_secs = timed(lambda: TF.train_randomforest_regr(
        X, yr, r_opts, device=dev), dev)
    rcpu, rc_secs = timed(lambda: TF.train_randomforest_regr(
        X, yr, r_opts, device=cpu), cpu)
    assert same_forest(rc, rcpu), "trees: regression forest card != CPU"
    print(f"[trees] train_randomforest_regr {r_opts} on the same rows, "
          f"integer-valued targets (f32 sums exact): card {r_secs:.3f} s, "
          f"CPU {rc_secs:.3f} s; card == CPU node for node, OOB squared "
          f"errors identical")

    t0 = time.perf_counter()
    (Xc, yc), (Xh, yh) = cover_data(seed)
    gen = time.perf_counter() - t0
    attrs = ["Q"] * COVER_Q + ["C"] * (COVER_WILDERNESS + COVER_SOIL)
    t0 = time.perf_counter()
    bins = TB.make_bins(Xc, attrs)
    Xbc = TB.bin_data(Xc, bins)
    bin_secs = time.perf_counter() - t0
    n_bins = max(b.n_bins for b in bins)
    c_opts = f"-trees {COVER_TREES} -seed {seed + 7} -attrs {','.join(attrs)}"
    on_card = dev.type == "cuda"  # a CPU rehearsal skips the device timings
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    syncs = dict(TG.SYNCS)
    forest, fit = timed(lambda: TF.train_randomforest_classifier(
        Xc, yc, c_opts, device=dev), dev)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    grow_syncs = TG.SYNCS["grow"] - syncs["grow"]
    walk_syncs = TG.SYNCS["walk"] - syncs["walk"]
    nodes, depth, oob = forest_line(forest)
    t0 = time.perf_counter()
    h_acc = float(np.mean(forest.predict(Xh) == yh))
    pred_secs = time.perf_counter() - t0
    majority = float(np.bincount(yc, minlength=COVER_CLASSES).max()
                     / len(yc))
    F = Xc.shape[1]
    print(f"[trees] Covertype-shaped data: {COVER_ROWS} rows x {F} columns "
          f"({COVER_Q} Q, {COVER_WILDERNESS + COVER_SOIL} C), "
          f"{COVER_CLASSES} classes (the largest {majority:.4f}), "
          f"{COVER_HOLDOUT} held out; drawn in {gen:.3f} s; host binning "
          f"(make_bins + bin_data, timed apart) {bin_secs:.3f} s, {n_bins} "
          f"bins")
    print(f"[trees] train_randomforest_classifier -trees {COVER_TREES} "
          f"(depth 16, 512 leaves, {int(np.ceil(np.sqrt(F)))} candidate "
          f"features a node): fit {fit:.3f} s, of which host binning about "
          f"{bin_secs:.3f} s; {COVER_TREES / fit:.3f} trees/s, "
          f"{COVER_ROWS * COVER_TREES / fit:.4g} row-trees/s; {nodes} "
          f"nodes, depth {depth}; OOB error {oob:.4f}, holdout accuracy "
          f"{h_acc:.4f} on {COVER_HOLDOUT} rows (predict {pred_secs:.3f} "
          f"s); host syncs {grow_syncs / COVER_TREES:.2f} a tree in growth "
          f"(one a level) + {walk_syncs} for the OOB walk; peak device "
          f"memory {peak / 2 ** 20:.1f} MiB")
    assert h_acc > majority, f"trees: Covertype holdout accuracy {h_acc}"

    w = np.bincount(np.random.RandomState(1).randint(0, COVER_ROWS,
                                                     COVER_ROWS),
                    minlength=COVER_ROWS).astype(np.float32)
    if on_card:
        tree_device_timing(forest, Xbc, yc, w, n_bins, attrs, dev)

    with tempfile.TemporaryDirectory(prefix="hivemall_trees_") as tmp:
        f_path, f_eng = tree_serving("forest", forest, Xh, dev, tmp)
        tree_serving("gbt", g1, Xg, dev, tmp)
        rows = Xh[:1024].tolist()
        want = f_eng.predict(Xh[:1024]).tolist()
        http_secs = http_beside_ctr(linear_model, "forest", "forest", f_path,
                                    rows, want, dev, 16, ctr_rows=ctr_rows)
    print(f"[trees] HTTP: 4 clients x 16 POST /predict of 64 raw Covertype "
          f"rows for forest in {http_secs:.3f} s beside the linear model ctr: "
          f"0 failed, every answer == the engine's labels")


def tree_device_timing(forest, Xbc, yc, w, n_bins, attrs, dev):
    """Phase trees' device timings of the Covertype-shaped fit: one level
    (tree_level_timing) and the OOB walk of every tree over every row."""
    import torch

    from hivemall_tpu_torch.models.trees import grow as TG

    F = Xbc.shape[1]
    lv = tree_level_timing(Xbc, yc, w, n_bins, np.array(
        [a == "C" for a in attrs]), dev)
    print(f"[trees] one level at S = {COVER_S} ({COVER_S} x {F} x {n_bins} x "
          f"{COVER_CLASSES} f32 histogram, {COVER_ROWS * F} lanes "
          f"scattered): " + "; ".join(
              f"{k} {lv[k][0]:.4f} ms eager / {lv[k][1]:.4f} ms by CUDA "
              f"events, bound {lv[k][2]:.6f} ms ({lv[k][3]} B at "
              f"{HBM_BYTES_PER_S:.3g} B/s)" for k in ("hist", "split",
                                                     "route"))
          + f"; the split search launches {lv['split_ops']} device "
          f"operations")
    stacked = TG.stack_trees([t.tree for t in forest.trees], dev)
    Xbt = torch.from_numpy(Xbc).to(dev)
    walk_ms = cuda_ms(lambda: TG.predict_forest_binned(stacked, Xbt), 3)
    walk_bytes = Xbc.nbytes + COVER_TREES * COVER_ROWS * 4 + sum(
        v.numel() * v.element_size() for v in stacked.values()
        if torch.is_tensor(v))
    print(f"[trees] the OOB walk ({COVER_TREES} trees x {COVER_ROWS} rows, "
          f"{stacked['depth']} steps): {walk_ms:.4f} ms by CUDA events, "
          f"bound {1e3 * walk_bytes / HBM_BYTES_PER_S:.6f} ms ({walk_bytes} "
          f"B)")


PIPE_DIMS = 1 << 22  # bench.py:35's headline shape: 2^22 dims, 32 nnz
PIPE_WIDTH = 32
PIPE_BATCH = 4096
PIPE_BATCHES = 64  # run 1: 262,144 events (cut from 128 for time)
PIPE_DRIFT = 131072  # events per concept phase
PIPE_FREEZE = 65536  # events per freeze -> gate -> publish cycle
PIPE_CKPT = 32768  # events per elastic checkpoint
PIPE_HOLDOUT_ROWS = 16384
PIPE_FAULT_BATCHES = 32  # run 2
PIPE_FAULT_CKPT = 4 * 4096  # run 2: a write every 4 batches
PIPE_PARITY_BATCHES = 32  # run 3: two freeze cycles (cut from 48 for time)
PIPE_CLIENTS = 4
PIPE_REQUEST_ROWS = 64
PIPE_SPANS = ("pipeline.train", "pipeline.freeze", "pipeline.gate",
              "pipeline.publish", "pipeline.revert", "pipeline.checkpoint")


def pipe_config(root, **kw):
    from hivemall_tpu_torch.models.classifier import AROW
    from hivemall_tpu_torch.pipeline import PipelineConfig

    base = dict(artifact_root=root, dims=PIPE_DIMS, rule=AROW,
                hyper={"r": 0.1}, name="ctr", width=PIPE_WIDTH,
                freeze_every_events=PIPE_FREEZE,
                checkpoint_every_events=PIPE_CKPT, holdout_every=8,
                holdout_capacity_rows=PIPE_HOLDOUT_ROWS,
                gate_engine_kwargs={"max_batch": 256,
                                    "max_width": PIPE_WIDTH})
    base.update(kw)
    return PipelineConfig(**base)


def pipe_registry(dev):
    from hivemall_tpu_torch.serving import ModelRegistry

    return ModelRegistry(max_batch=64, max_delay_ms=2.0, device=dev,
                         engine_kwargs={"max_width": PIPE_WIDTH})


def pipe_stream(seed, n_batches, flip=True):
    """The run's DriftStream; with ``flip`` the label-flip window covers
    the freeze cycle in the middle of the run, aligned to the cadence
    (scripts/bench_pipeline.py:127-129). Returns (stream, flip window)."""
    from hivemall_tpu_torch.dataset.lr_datagen import DriftStream

    window = None
    if flip:
        cycle = max(2, (n_batches * PIPE_BATCH // PIPE_FREEZE) // 2)
        window = (cycle * PIPE_FREEZE, (cycle + 1) * PIPE_FREEZE)
    return DriftStream(PIPE_DIMS, batch=PIPE_BATCH, width=PIPE_WIDTH,
                       seed=seed, drift_every=PIPE_DRIFT,
                       label_flip_events=window), window


def pipe_traffic(port, pool, stop, out):
    """One client: POST /predict of 64 string rows from ``pool`` until
    ``stop``. A 404 before the first publish is "not serving yet"; any
    other failure is a failed request."""
    import urllib.error
    import urllib.request

    i = 0
    while not stop.is_set():
        body = json.dumps({"model": "ctr",
                           "instances": pool[i % len(pool)]}).encode()
        i += 1
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=body,
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                ans = json.loads(r.read())
            assert len(ans["predictions"]) == PIPE_REQUEST_ROWS
            out["secs"].append(time.perf_counter() - t0)
            out["versions"].add(ans["version"])
        except urllib.error.HTTPError as e:
            if e.code == 404 and not out["versions"]:
                out["not_serving"] += 1
                stop.wait(0.05)
            else:
                out["failed"].append(f"HTTP {e.code}: {e.read()[:200]!r}")
        except Exception as e:  # collected and asserted by the caller
            out["failed"].append(repr(e))


def pipe_run_live(seed, dev, tmp):
    """Run 1: the pipeline on the card for PIPE_BATCHES batches on a worker
    thread while PIPE_CLIENTS clients POST /predict to the same registry.
    Returns the numbers phase pipeline prints and checks."""
    import os
    import threading

    import torch

    from hivemall_tpu_torch.pipeline import ContinuousPipeline
    from hivemall_tpu_torch.runtime.metrics import REGISTRY
    from hivemall_tpu_torch.runtime.tracing import TRACER
    from hivemall_tpu_torch.serving import serve

    stream, flip = pipe_stream(seed, PIPE_BATCHES)
    rng = np.random.RandomState(seed + 91)
    pool = [[[f"{int(i)}:{v:.3f}" for i, v in zip(
        rng.randint(0, PIPE_DIMS, PIPE_WIDTH), rng.rand(PIPE_WIDTH))]
        for _ in range(PIPE_REQUEST_ROWS)] for _ in range(64)]
    registry = pipe_registry(dev)
    server = serve(registry, host="127.0.0.1", port=0)
    root = os.path.join(tmp, "live")
    pipe = ContinuousPipeline(registry, stream.block, pipe_config(root),
                              holdout_stream_fn=stream.clean_block,
                              device=dev)
    seg = REGISTRY.counter("allocator", "new_segments.serving.ctr")
    swaps = REGISTRY.counter("serving", "registry.swaps")
    seg0, swaps0 = seg.value, swaps.value
    traffic = {"secs": [], "versions": set(), "failed": [], "not_serving": 0}
    stop = threading.Event()
    clients = [threading.Thread(target=pipe_traffic,
                                args=(server.server_address[1], pool, stop,
                                      traffic))
               for _ in range(PIPE_CLIENTS)]
    TRACER.clear()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        for c in clients:
            c.start()
        t0 = time.perf_counter()
        pipe.start(PIPE_BATCHES)
        finished = pipe.join(timeout=900)
        wall = time.perf_counter() - t0
        stop.set()
        for c in clients:
            c.join(timeout=300)
            assert not c.is_alive(), "a /predict client hung"
    finally:
        stop.set()
        pipe.stop()
        server.shutdown()
        server.server_close()
        registry.shutdown()
    assert finished, "pipeline run 1 did not finish"
    st = pipe.status()
    assert st["fatal"] is None, f"pipeline run 1: {st['fatal']}"
    stages = TRACER.stage_breakdown()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    arts = [os.path.join(root, f"ctr-v{d['version']}")
            for d in st["decisions"] if d["reason"] != "artifact_corrupt"]
    art_bytes = [sum(os.path.getsize(os.path.join(a, f))
                     for f in os.listdir(a)) for a in arts
                 if os.path.isdir(a)]
    ckpt_bytes = os.path.getsize(pipe.cfg.checkpoint_path)
    return dict(status=st, flip=flip, wall=wall, traffic=traffic,
                stages=stages, peak=peak, art_bytes=art_bytes,
                ckpt_bytes=ckpt_bytes, segments=seg.value - seg0,
                swaps=swaps.value - swaps0,
                freshness=pipe.freshness_percentiles())


def pipe_run_faults(seed, dev, tmp):
    """Run 2: PIPE_FAULT_BATCHES batches under a seeded fault plan composed
    as tests/test_pipeline.py composes it (crash_mid_write at write 3,
    corrupt at write 5, transient_step at step 17; a write every 4
    batches, a freeze every 16). Returns (status, fired kinds, fallback warnings, manifest,
    seconds)."""
    import os
    import warnings

    from hivemall_tpu_torch.io.checkpoint import load_elastic
    from hivemall_tpu_torch.pipeline import ContinuousPipeline
    from hivemall_tpu_torch.runtime import faults

    stream, _ = pipe_stream(seed, PIPE_FAULT_BATCHES, flip=False)
    registry = pipe_registry(dev)
    root = os.path.join(tmp, "faults")
    pipe = ContinuousPipeline(
        registry, stream.block,
        pipe_config(root, checkpoint_every_events=PIPE_FAULT_CKPT,
                    freeze_every_events=4 * PIPE_FAULT_CKPT),
        holdout_stream_fn=stream.clean_block, device=dev)
    plan = faults.FaultPlan(seed=seed + 3, faults=(
        faults.Fault("crash_mid_write", at_write=3),
        faults.Fault("corrupt", at_write=5),
        faults.Fault("transient_step", at_step=17)))
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with faults.inject(plan) as injector:
                st = pipe.run(PIPE_FAULT_BATCHES)
    finally:
        registry.shutdown()
    secs = time.perf_counter() - t0
    _, manifest = load_elastic(pipe.cfg.checkpoint_path)
    fallbacks = sum("falling back" in str(w.message) for w in caught)
    return st, sorted(f["kind"] for f in injector.fired), fallbacks, \
        manifest, secs


def pipe_run_parity(seed, dev, tmp, tag):
    """Run 3 on one device: PIPE_PARITY_BATCHES batches, no traffic, one
    checkpoint, at the end.
    Returns (status, final checkpoint arrays, seconds)."""
    import os

    from hivemall_tpu_torch.io.checkpoint import load_elastic
    from hivemall_tpu_torch.pipeline import ContinuousPipeline

    stream, _ = pipe_stream(seed, PIPE_PARITY_BATCHES, flip=False)
    registry = pipe_registry(dev)
    pipe = ContinuousPipeline(registry, stream.block,
                              pipe_config(os.path.join(tmp, tag),
                                          checkpoint_every_events=(
                                              PIPE_PARITY_BATCHES
                                              * PIPE_BATCH)),
                              holdout_stream_fn=stream.clean_block,
                              device=dev)
    t0 = time.perf_counter()
    try:
        st = pipe.run(PIPE_PARITY_BATCHES)
    finally:
        registry.shutdown()
    arrays, _ = load_elastic(pipe.cfg.checkpoint_path)
    return st, arrays, time.perf_counter() - t0


def phase_pipeline(seed, dev, smi):
    """The continuous training pipeline (hivemall_tpu_torch/pipeline/) on
    the card at the main path's widths: run 1 under live /predict traffic
    (gated publishes, hot swaps, a refused poisoned cycle, 0 failed
    requests, freshness), run 2 under a seeded fault plan (self-healing,
    no lost work), run 3 card against CPU (the same gate decisions, the
    final tables within the smoke's tolerance)."""
    import tempfile

    import torch

    print(f"[pipeline] card: {smi}")
    with tempfile.TemporaryDirectory(prefix="hivemall_pipeline_") as tmp:
        live = pipe_run_live(seed, dev, tmp)
        st, tr = live["status"], live["traffic"]
        decisions = st["decisions"]
        published = [d for d in decisions if d["published"]]
        hot_swaps = [d for d in published if d["reason"] != "first_publish"]
        refused = [d for d in decisions if d["reason"] == "regression"]
        flip_end = live["flip"][1] - 1
        print(f"[pipeline] run 1: AROW r=0.1 at D = {PIPE_DIMS}, width "
              f"{PIPE_WIDTH}, {PIPE_BATCHES} batches of {PIPE_BATCH} "
              f"(DriftStream seed {seed}, a concept phase every "
              f"{PIPE_DRIFT} events, label flip on events {live['flip']}); "
              f"freeze every {PIPE_FREEZE} events, checkpoint every "
              f"{PIPE_CKPT}, holdout every 8th batch into "
              f"{PIPE_HOLDOUT_ROWS} rows; {PIPE_CLIENTS} clients POST "
              f"/predict of {PIPE_REQUEST_ROWS} string rows throughout: "
              f"wall {live['wall']:.3f} s")
        print("[pipeline] run 1 lineage: " + "; ".join(
            f"v{d['version']} {d['reason']}"
            + (f" (cand {d['candidate_logloss']:.4f}"
               + (f" vs live {d['incumbent_logloss']:.4f}"
                  if d.get("incumbent_logloss") is not None else "") + ")"
               if d.get("candidate_logloss") is not None else "")
            for d in decisions))
        lat = tr["secs"]
        means = {k: live["stages"].get(k, {}).get("mean_ms")
                 for k in PIPE_SPANS}
        counts = {k: live["stages"].get(k, {}).get("count", 0)
                  for k in PIPE_SPANS}
        fresh = live["freshness"]
        print(f"[pipeline] run 1: {len(published)} gated publishes "
              f"({len(hot_swaps)} hot swaps of a serving version, registry "
              f"swaps {live['swaps']}), {len(refused)} refused for "
              f"regression, {st['rollbacks']} rollbacks; freshness p50 "
              f"{fresh['p50']:.3f} s / p99 {fresh['p99']:.3f} s over "
              f"{st['freshness_events']} events; mean ms by span: "
              + ", ".join(f"{k.split('.')[1]} {means[k]:.3f} (x{counts[k]})"
                          if means[k] is not None else
                          f"{k.split('.')[1]} none" for k in PIPE_SPANS))
        print(f"[pipeline] run 1: worker trained {st['trained_rows']} rows, "
              f"{st['trained_rows'] / live['wall']:.0f} rows/s over the "
              f"run's wall clock; artifacts {live['art_bytes']} B each, "
              f"freeze {means['pipeline.freeze']:.3f} ms mean; checkpoint "
              f"{live['ckpt_bytes']} B, {means['pipeline.checkpoint']:.3f} "
              f"ms mean ({st['checkpoints_written']} written); /predict: "
              f"{len(lat)} answered, p50 {percentile_ms(lat, 50):.4f} / "
              f"p99 {percentile_ms(lat, 99):.4f} ms, "
              f"{len(tr['failed'])} failed, {tr['not_serving']} 404s before "
              f"the first publish, versions served "
              f"{sorted(tr['versions'], key=int)}; serving's new allocator "
              f"segments during the run {live['segments']} (per device: the "
              f"trainer's segments count there too); peak device memory "
              f"{live['peak'] / 2 ** 20:.1f} MiB")
        assert len(published) >= 3, f"pipeline: {len(published)} publishes"
        assert len(hot_swaps) >= 2, f"pipeline: {len(hot_swaps)} hot swaps"
        assert any(d.get("trained_through_event") == flip_end
                   for d in refused), \
            f"pipeline: the flip window was not refused: {decisions}"
        assert not tr["failed"], f"pipeline: failed requests {tr['failed'][:3]}"
        assert lat, "pipeline: no /predict answered"
        assert st["freshness_events"] == st["events"] \
            == PIPE_BATCHES * PIPE_BATCH

        st2, fired, fallbacks, manifest, secs2 = pipe_run_faults(seed, dev,
                                                                 tmp)
        trained = sum(PIPE_BATCH for i in range(PIPE_FAULT_BATCHES)
                      if i % 8 != 1)
        print(f"[pipeline] run 2 (faults {fired}, {PIPE_FAULT_BATCHES} "
              f"batches, a checkpoint every {PIPE_FAULT_CKPT} events): "
              f"{secs2:.3f} s; restarts {st2['restarts']} "
              f"({st2['restart_causes']}), replayed batches "
              f"{st2['replayed_batches']}, .prev fallbacks {fallbacks}; "
              f"final checkpoint block_step {manifest['block_step']}, step "
              f"{manifest['step']} (an uninterrupted run: {trained}), "
              f"publishes {st2['publishes']}")
        assert fired == ["corrupt", "crash_mid_write", "transient_step"]
        assert st2["fatal"] is None and st2["restarts"] == 2
        assert fallbacks >= 1, "pipeline: the .prev fallback never fired"
        assert manifest["block_step"] == PIPE_FAULT_BATCHES
        assert manifest["step"] == trained
        assert manifest["events"] == PIPE_FAULT_BATCHES * PIPE_BATCH

        card, ca, c_secs = pipe_run_parity(seed, dev, tmp, "card")
        cpu, pa, p_secs = pipe_run_parity(seed, torch.device("cpu"), tmp,
                                          "cpu")

    def lineage(rep):
        return [(d["version"], d["published"], d["reason"])
                for d in rep["decisions"]]

    err = {k: float(np.max(np.abs(ca[k] - pa[k]))) for k in ("weights",
                                                             "covars")}
    print(f"[pipeline] run 3 ({PIPE_PARITY_BATCHES} batches, "
          f"{PIPE_PARITY_BATCHES * PIPE_BATCH} events): card {c_secs:.3f} "
          f"s, CPU {p_secs:.3f} s; decisions card {lineage(card)}, CPU "
          f"{lineage(cpu)}; final w / cov largest |diff| {err['weights']:.3g}"
          f" / {err['covars']:.3g} (rtol {RTOL:g} / atol {ATOL:g}), touched "
          f"equal")
    assert lineage(card) == lineage(cpu), "pipeline: card decisions != CPU"
    for k in ("weights", "covars"):
        np.testing.assert_allclose(ca[k], pa[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"pipeline run 3 {k}")
    np.testing.assert_array_equal(ca["touched"], pa["touched"])
    assert int(ca["step"]) == int(pa["step"])


PAR_BLOCK = 4096  # rows a block: the main path's -mini_batch 4096
PAR_BLOCKS = 16  # main's first 16 blocks (65,536 rows): 8 a rank at world 2
PAR_MIX_EVERY = 8
PAR_SCAN_ROWS = 256  # the sharded scan's prefix: one all_reduce a row
PAR_FM_BLOCKS = 2
PAR_MC_BLOCKS = 2
PAR_FFM_ROWS = 4096  # one FFM block, unchunked and -row_chunk 512
PAR_GBT_OPTS = "-trees 4 -iters 4 -depth 6 -seed 3"
PAR_TIMEOUT = 400  # seconds the world of two may take


def par_config(dev):
    """The sizes the spawned ranks run at (they import this module afresh,
    so a CPU rehearsal's smaller sizes travel as arguments)."""
    return {"device": str(dev), "dims": FULL_DIMS, "block": PAR_BLOCK,
            "blocks": PAR_BLOCKS, "mix_every": PAR_MIX_EVERY,
            "scan_rows": PAR_SCAN_ROWS, "fm_blocks": PAR_FM_BLOCKS,
            "mc_blocks": PAR_MC_BLOCKS, "mc_dims": MC_DIMS,
            "mc_labels": MC_LABELS, "mc_width": MC_WIDTH,
            "ffm_rows": PAR_FFM_ROWS, "ffm_chunk": FFM_CHUNK,
            "ffm_feature_bits": FFM_FEATURE_BITS, "ffm_v_bits": FFM_V_BITS,
            "gbt_rows": GBT_ROWS, "gbt_opts": PAR_GBT_OPTS,
            "features": TREE_FEATURES}


def par_clock(dev):
    """(start, stop): stop() returns ms since start(), by CUDA events on the
    card and the host clock on the CPU."""
    import torch

    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)

        def stop():
            b.record()
            b.synchronize()
            return a.elapsed_time(b)

        return a.record, stop
    t = []
    return (lambda: t.append(time.perf_counter()),
            lambda: (time.perf_counter() - t[-1]) * 1e3)


def par_run(mesh, dev, fn, steps, rows):
    """Run ``fn()`` (``steps`` train steps over ``rows`` rows) with the
    mesh's collectives timed; returns (fn's result, a report dict)."""
    import torch

    sync(dev)
    base = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    mesh.stats.reset()
    mesh.stats.timed = True
    start, stop = par_clock(dev)
    start()
    out = fn()
    ms = stop()
    mesh.stats.timed = False
    state = out[0] if isinstance(out, tuple) else out
    return out, {
        "step_ms": ms / steps, "rows_per_s": rows / (ms / 1e3),
        "collectives_per_step": mesh.stats.calls / steps,
        "bytes_per_step": mesh.stats.bytes / steps,
        "collective_ms_per_step": mesh.stats.ms() / steps,
        "peak_mib": (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
        if dev.type == "cuda" else None,
        "state_mib": par_state_mib(state)}


def par_state_mib(state):
    """MiB of the tensors a trained state holds on this rank (a replica's
    whole tables, a stripe's share of them); None for a fitted model
    whose trees live on the host."""
    import dataclasses

    import torch

    if not dataclasses.is_dataclass(state):
        return None
    total = 0
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        for t in (v.values() if isinstance(v, dict) else [v]):
            if torch.is_tensor(t):
                total += t.numel() * t.element_size()
    return total / 2 ** 20 if total else None


def par_line(tag, r, extra=""):
    peak = "not measured (CPU)" if r["peak_mib"] is None \
        else f"{r['peak_mib']:.1f} MiB above the state"
    if r["state_mib"] is not None:
        peak += f", state {r['state_mib']:.1f} MiB"
    print(f"[parallel] {tag}: step {r['step_ms']:.3f} ms, "
          f"{r['rows_per_s']:.0f} rows/s, {r['collectives_per_step']:.2f} "
          f"collectives / {r['bytes_per_step']:.0f} bytes a step, "
          f"{r['collective_ms_per_step']:.3f} ms a step inside them, peak "
          f"{peak}{extra}", flush=True)


def par_close(tag, got, want, ints=()):
    """Float fields within the card rule (RTOL / ATOL), ``ints`` exact;
    returns max |err|."""
    err = 0.0
    for k, a in want.items():
        b = np.asarray(got[k])
        if k in ints:
            assert np.array_equal(b, a), f"{tag}: {k}"
            continue
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{tag}: {k}")
        err = max(err, float(np.max(np.abs(b - a))) if a.size else 0.0)
    return err


def par_linear_fields(st):
    from hivemall_tpu_torch.core.state import linear_state_to_numpy

    h = linear_state_to_numpy(st)
    return {"weights": h["weights"], "covars": h["covars"],
            "touched": h["touched"]}


def par_holdout_ll(w, held):
    h_idx, h_val, h_y = held
    return log_loss_acc((np.asarray(w)[h_idx] * h_val).sum(axis=1), h_y)[1]


def par_blocks(cfg, idx, val, y):
    """The first cfg["blocks"] blocks of main's rows, labels as +-1."""
    n, b = cfg["blocks"], cfg["block"]
    shape = (n, b) + idx.shape[1:]
    return (idx[:n * b].reshape(shape), val[:n * b].reshape(shape),
            np.where(y[:n * b] > 0, 1.0, -1.0).astype(np.float32)
            .reshape(n, b))


def par_train_alone(rule, hyper, dims, dev, blocks, mode="minibatch",
                    track=False, state=None):
    from hivemall_tpu_torch.core.engine import DELTA_SLOT, make_train_fn
    from hivemall_tpu_torch.core.state import init_linear_state

    fn = make_train_fn(rule, hyper, mode=mode, track_deltas=track,
                       device=dev)
    st = state or init_linear_state(
        dims, use_covariance=rule.use_covariance,
        slot_names=(DELTA_SLOT,) if track else (), device=dev)
    for i in range(blocks[0].shape[0]):
        st, _ = fn(st, *(b[i] for b in blocks))
    return st


def par_warm_up(mesh, dev, blocks):
    """One block of the engine's minibatch step and one small all_reduce,
    so the timed runs pay neither first-use kernel setup nor the
    communicator's creation (NCCL builds it at the first collective)."""
    import torch

    from hivemall_tpu_torch.models.classifier import AROW
    from hivemall_tpu_torch.parallel.mesh import psum

    par_train_alone(AROW, {"r": 0.1}, 1 << 10, dev,
                    tuple(a[:1] for a in blocks))
    psum(torch.ones(4, device=dev), mesh, mesh.axis_names[0])
    sync(dev)


def par_bound_ms(blocks, dims, mix_every=None):
    """The AROW step's byte bound, ms a block at HBM_BYTES_PER_S: each
    block's ids, values and labels read, each distinct live feature's
    float32 weight and covariance and int8 touched entries read and
    written once; with ``mix_every``, also each live feature's float32
    delta count (the mix trainer tracks it every step), and each mix's
    weights, covariances and delta counts read and written once, spread
    over its blocks."""
    n = blocks[0].shape[0]
    per_feature = (3 if mix_every else 2) * 4 + 1
    total = 0
    for i in range(n):
        idx = blocks[0][i]
        b, k = idx.shape
        uniq = np.unique(idx[(idx >= 0) & (idx < dims)]).size
        total += b * k * 8 + b * 8 + uniq * per_feature * 2
    if mix_every:
        total += (n // mix_every) * 3 * dims * 4 * 2
    return total / n / HBM_BYTES_PER_S * 1e3, total // n


def par_world_one(cfg, dev, blocks, held):
    """World size 1 in this process (NCCL on the card): MixTrainer
    (argminKLD, mix_every 8) and ShardedTrainer (minibatch) over main's
    blocks at full width, each held against the single-device trainer."""
    import torch.distributed as dist

    from hivemall_tpu_torch.models.classifier import AROW
    from hivemall_tpu_torch.parallel import (MixConfig, MixTrainer,
                                             ShardedTrainer, make_mesh)
    from hivemall_tpu_torch.parallel.mesh import init_distributed

    init_distributed("nccl" if dev.type == "cuda" else "gloo", dev)
    try:
        backend = dist.get_backend()
        mesh = make_mesh(device=dev)
        par_warm_up(mesh, dev, blocks)
        dims, n = cfg["dims"], blocks[0].shape[0]
        rows = n * cfg["block"]
        ref = par_train_alone(AROW, {"r": 0.1}, dims, dev, blocks)
        want = par_linear_fields(ref)
        ref_ll = par_holdout_ll(want["weights"], held)
        tr = MixTrainer(AROW, {"r": 0.1}, dims, mesh,
                        MixConfig(mix_every=cfg["mix_every"]))
        st = tr.init()
        (st, _), rep = par_run(mesh, dev, lambda: tr.step(st, *blocks), n,
                               rows)
        got = par_linear_fields(tr.final_state(st))
        err = par_close("world 1 mix", got, want, ints=("touched",))
        par_line(f"world 1 ({backend}) MixTrainer argmin_kld mix_every "
                 f"{cfg['mix_every']}, {n} blocks of {cfg['block']} at "
                 f"D = {dims}", rep,
                 f"; == single-device (max |err| {err:.3g}); holdout "
                 f"logloss {par_holdout_ll(got['weights'], held):.4f} "
                 f"(single-device {ref_ll:.4f}); step byte bound "
                 "%.6f ms (%d B)" % par_bound_ms(blocks, dims,
                                                 cfg["mix_every"]))
        tr = ShardedTrainer(AROW, {"r": 0.1}, dims, mesh)
        st = tr.init()

        def steps():
            s = st
            for i in range(n):
                s, _ = tr.step(s, *(b[i] for b in blocks))
            return s

        st, rep = par_run(mesh, dev, steps, n, rows)
        err = par_close("world 1 sharded", par_linear_fields(
            tr.final_state(st)), want, ints=("touched",))
        par_line(f"world 1 ({backend}) ShardedTrainer minibatch, 1 stripe "
                 f"of {tr.stripe}", rep,
                 f"; == single-device (max |err| {err:.3g}); step byte "
                 "bound %.6f ms (%d B)" % par_bound_ms(blocks, dims))
    finally:
        dist.destroy_process_group()


def par_fm(cfg, dev, mesh, rank, blocks):
    """FMShardedTrainer at k = 5, 2 stripes of D/2, from one warm state,
    against the single-device FM step."""
    from hivemall_tpu_torch.models.fm import (FMHyper, fm_state_from_numpy,
                                              fm_state_to_numpy,
                                              make_fm_step)
    from hivemall_tpu_torch.parallel import FMShardedTrainer

    dims, hyper = cfg["dims"], FMHyper(factors=FM_FACTORS,
                                       classification=True)
    rng = np.random.RandomState(7)
    v = np.zeros((dims, hyper.padded_factors), np.float32)
    v[:, :FM_FACTORS] = 0.1 * rng.randn(dims, FM_FACTORS)
    kp = hyper.padded_factors
    warm = {"w0": np.float32(0.0), "w": np.zeros(dims, np.float32), "v": v,
            "lambda_w0": np.float32(hyper.lambda0),
            "lambda_w": np.float32(hyper.lambda0),
            "lambda_v": np.array([hyper.lambda0] * FM_FACTORS
                                 + [0.0] * (kp - FM_FACTORS), np.float32),
            "touched": np.zeros(dims, np.int8), "step": 0}
    n = cfg["fm_blocks"]
    tr = FMShardedTrainer(hyper, dims, mesh)
    st = tr.init(from_state=warm)

    def steps():
        s = st
        for i in range(n):
            s, _ = tr.step(s, *(b[i] for b in blocks))
        return s

    st, rep = par_run(mesh, dev, steps, n, n * cfg["block"])
    got = fm_state_to_numpy(tr.final_state(st))
    if rank == 0:
        step = make_fm_step(hyper, device=dev)
        ref = fm_state_from_numpy(warm, device=dev)
        for i in range(n):
            ref, _ = step(ref, blocks[0][i], blocks[1][i], blocks[2][i],
                          np.zeros(cfg["block"], np.float32))
        want = fm_state_to_numpy(ref)
        err = par_close("fm sharded", got, {k: want[k] for k in (
            "w0", "w", "v", "touched")}, ints=("touched",))
        par_line(f"FMShardedTrainer k = {FM_FACTORS}, 2 stripes of "
                 f"{tr.stripe}", rep,
                 f"; == single-device (max |err| {err:.3g})")


def par_mc(cfg, dev, mesh, rank):
    """MCShardedTrainer (AROW) at the mc phase's shape, 2 stripes, from one
    warm random state: one block against the single-device step, then
    cfg["mc_blocks"] timed blocks. The missed label is an argmax over
    per-label scores that the stripes sum in another order, so a row
    whose top two other labels (or whose margin and the hinge) lie within
    rounding of each other may take the other branch: the features of
    such near-tie rows are counted and left out of the comparison, every
    other entry within RTOL / ATOL, touched exact."""
    import torch

    from hivemall_tpu_torch.models.multiclass import (
        MC_AROW, _mc_scores, make_mc_train_step, mc_state_from_numpy,
        mc_state_to_numpy)
    from hivemall_tpu_torch.parallel import MCShardedTrainer

    rng = np.random.RandomState(41)
    n, b, L, D = cfg["mc_blocks"], cfg["block"], cfg["mc_labels"], \
        cfg["mc_dims"]
    idx = workload_ids(rng, (n + 1, b, cfg["mc_width"]), D).astype(np.int64)
    val = np.ones(idx.shape, np.float32)
    lab = rng.randint(0, L, (n + 1, b)).astype(np.int64)
    gen = np.random.default_rng(42)
    warm = {"weights": 0.1 * gen.standard_normal((L, D), np.float32),
            "covars": gen.uniform(0.5, 1.5, (L, D)).astype(np.float32),
            "touched": np.zeros((L, D), np.int8), "step": 0}
    tr = MCShardedTrainer(MC_AROW, {"r": 0.1}, L, D, mesh)
    st = tr.init()
    lo = mesh.index("workers") * tr.stripe
    for name in ("weights", "covars"):
        getattr(st, name).copy_(torch.from_numpy(
            warm[name][:, lo:lo + tr.stripe]))
    st, _ = tr.step(st, idx[0], val[0], lab[0])
    got = mc_state_to_numpy(tr.final_state(st))

    def steps():
        s = st
        for i in range(1, n + 1):
            s, _ = tr.step(s, idx[i], val[i], lab[i])
        return s

    st, rep = par_run(mesh, dev, steps, n, n * b)
    if rank != 0:
        return
    ref = mc_state_from_numpy(warm, device=dev)
    scores = _mc_scores(ref.weights, idx[0], val[0]).cpu().numpy()  # [B, L]
    rows = np.arange(b)
    correct = scores[rows, lab[0]]
    scores[rows, lab[0]] = -np.inf
    top2 = np.sort(scores, axis=1)[:, -2:]
    tie = 1e-4 * (1.0 + np.abs(top2[:, 1]) + np.abs(correct))
    near = (top2[:, 1] - top2[:, 0] <= tie) | (
        np.abs(1.0 - (correct - top2[:, 1])) <= tie)
    masked = np.unique(idx[0][near])
    keep = np.ones(D, bool)
    keep[masked] = False
    ref, _ = make_mc_train_step(MC_AROW, {"r": 0.1}, "minibatch",
                                device=dev)(ref, idx[0], val[0], lab[0])
    want = mc_state_to_numpy(ref)
    assert np.all(np.isfinite(want["weights"])), "mc: non-finite"
    err = par_close("mc sharded", {k: got[k][:, keep] for k in (
        "weights", "covars", "touched")}, {k: want[k][:, keep] for k in (
            "weights", "covars", "touched")}, ints=("touched",))
    par_line(f"MCShardedTrainer AROW L = {L}, 2 stripes of {tr.stripe}",
             rep, f"; one block from a warm state == single-device (max "
             f"|err| {err:.3g}) outside the {masked.size} features of "
             f"{int(near.sum())} near-tie rows")


def par_ffm(cfg, dev, mesh, rank):
    """FFMShardedTrainer at the ffm phase's shape from one warm state,
    unchunked and -row_chunk, against the single-device FFM step."""
    from hivemall_tpu_torch.models.ffm import (FFMHyper, ffm_state_from_numpy,
                                               ffm_state_to_numpy,
                                               make_ffm_step)
    from hivemall_tpu_torch.parallel import FFMShardedTrainer

    nf, dv = 1 << cfg["ffm_feature_bits"], 1 << cfg["ffm_v_bits"]
    hyper = FFMHyper(factors=FFM_K, num_features=nf, v_dims=dv,
                     num_fields=FFM_FIELDS)
    rng = np.random.RandomState(51)
    b = cfg["ffm_rows"]
    idx = workload_ids(rng, (b, FFM_WIDTH), nf).astype(np.int64)
    fld = rng.randint(0, FFM_FIELDS, nf)[idx]
    val = np.ones(idx.shape, np.float32)
    lab = np.where(rng.rand(b) < 0.5, 1.0, -1.0).astype(np.float32)
    warm = {"w0": np.float32(0.0), "w": np.zeros(nf, np.float32),
            "z": np.zeros(nf, np.float32), "n": np.zeros(nf, np.float32),
            "v": (0.1 * rng.randn(dv, FFM_K)).astype(np.float32),
            "v_gg": np.zeros(dv, np.float32),
            "touched": np.zeros(nf, np.int8), "step": 0}
    want = None
    if rank == 0:
        ref, _ = make_ffm_step(hyper, "minibatch", device=dev)(
            ffm_state_from_numpy(warm, device=dev), idx, val, fld, lab)
        want = ffm_state_to_numpy(ref)
    for chunk in (None, cfg["ffm_chunk"]):
        tr = FFMShardedTrainer(hyper, mesh, row_chunk=chunk)
        st = tr.init(from_state=warm)
        (st, _), rep = par_run(mesh, dev,
                               lambda: tr.step(st, idx, val, fld, lab), 1, b)
        got = ffm_state_to_numpy(tr.final_state(st))
        if rank == 0:
            err = par_close(f"ffm sharded chunk {chunk}", got, {
                k: want[k] for k in ("w", "z", "n", "v", "v_gg", "touched")},
                ints=("touched",))
            par_line(f"FFMShardedTrainer row_chunk {chunk}, stripes of "
                     f"{tr.stripe_w} / {tr.stripe_v}", rep,
                     f"; == single-device (max |err| {err:.3g})")


def par_gbt(cfg, dev, mesh, rank):
    """train_gbt_data_parallel on the bench GBT's rows (a few rounds). The
    ranks' partial histograms add in lane order on the card and on the
    CPU alike (models/trees/grow.py), so the same two ranks growing on the
    CPU must give the card's trees: decision scores within GBT_TOL, trees
    counted node for node. Against the single-device trainer the partials'
    sum is another float order, and a near-tie split gain may go the
    other way in a later level, as in the JAX package's data-parallel
    GBT: predictions must agree on 98% of the rows and training accuracy
    within 0.02 (the rules of its tests/test_forest_shard.py)."""
    from hivemall_tpu_torch.models.trees import (
        train_gradient_tree_boosting_classifier)
    from hivemall_tpu_torch.parallel import make_mesh
    from hivemall_tpu_torch.parallel.forest_shard import (
        train_gbt_data_parallel)

    X, y = bench_rows(np.random.RandomState(33), cfg["gbt_rows"],
                      cfg["features"])
    opts = cfg["gbt_opts"]
    n_trees = int(opts.split()[1])
    got, rep = par_run(mesh, dev, lambda: train_gbt_data_parallel(
        X, y, opts, mesh), n_trees, cfg["gbt_rows"] * n_trees)
    host = train_gbt_data_parallel(X, y, opts, make_mesh(device="cpu"))
    if rank != 0:
        return
    d_got = got.decision_function(X)
    d_host = host.decision_function(X)
    np.testing.assert_allclose(d_got, d_host, rtol=GBT_TOL[0],
                               atol=GBT_TOL[1],
                               err_msg="gbt data-parallel: card vs CPU")
    same = sum(same_trees(a, b) for a, b in zip(got.trees, host.trees))
    start, stop = par_clock(dev)
    start()
    want = train_gradient_tree_boosting_classifier(X, y, opts, device=dev)
    alone_ms = stop() / n_trees
    p_got, p_want = got.predict(X), want.predict(X)
    agree = float(np.mean(p_got == p_want))
    acc_got, acc_want = float(np.mean(p_got == y)), float(np.mean(p_want == y))
    assert agree > 0.98, f"gbt data-parallel: agrees on {agree:.4f} of rows"
    assert abs(acc_got - acc_want) < 0.02, (acc_got, acc_want)
    d_want = want.decision_function(X)
    par_line(f"train_gbt_data_parallel {opts} on {cfg['gbt_rows']} x "
             f"{cfg['features']} (a step = a tree)", rep,
             f"; single device {alone_ms:.3f} ms a tree (run after it); "
             f"card == the same 2 ranks on the CPU (max |err| "
             f"{float(np.max(np.abs(d_got - d_host))):.3g}, {same} of "
             f"{n_trees} trees node for node); against single-device: "
             f"predictions agree on {agree:.4f} of rows, accuracy "
             f"{acc_got:.4f} / {acc_want:.4f}, max |decision diff| "
             f"{float(np.max(np.abs(d_got - d_want))):.3g}")


def parallel_rank(rank, n, tmp, cfg):
    """One rank of phase parallel's world of two (gloo; both ranks on the
    one card): every trainer of the slice, held as the docstring says."""
    import os

    import torch

    from hivemall_tpu_torch.core.engine import DELTA_SLOT
    from hivemall_tpu_torch.models.classifier import AROW
    from hivemall_tpu_torch.parallel import (MixConfig, MixTrainer,
                                             Sharded2DTrainer, ShardedTrainer,
                                             make_mesh, make_mesh_2d)
    from hivemall_tpu_torch.parallel.mesh import all_gather_host

    dev = torch.device(cfg["device"])
    with np.load(os.path.join(tmp, "data.npz")) as z:
        d = {k: z[k] for k in z.files}
    blocks = (d["idx"], d["val"], d["lab"])
    held = (d["h_idx"], d["h_val"], d["h_y"])
    dims, k, b = cfg["dims"], cfg["blocks"] // n, cfg["block"]
    mine = tuple(a[rank * k:(rank + 1) * k] for a in blocks)
    first = tuple(a[:k] for a in blocks)
    mesh = make_mesh(device=dev)
    par_warm_up(mesh, dev, blocks)

    # MixTrainer over 2 replicas vs the manual argminKLD of the replicas
    # trained alone (plain torch on the card)
    tr = MixTrainer(AROW, {"r": 0.1}, dims, mesh,
                    MixConfig(mix_every=k))
    st = tr.init()
    (st, _), rep = par_run(mesh, dev, lambda: tr.step(st, *mine), k, k * b)
    alone = par_train_alone(AROW, {"r": 0.1}, dims, dev, mine, track=True)

    def both(x):
        return torch.from_numpy(all_gather_host(x, mesh, "workers")).to(dev)

    w, cov, dl = (both(alone.weights), both(alone.covars),
                  both(alone.slots[DELTA_SLOT]))
    total, inv = dl.sum(0), 1.0 / cov
    manual = {"weights": torch.where(total > 0, (w * inv).sum(0) / inv.sum(0),
                                     alone.weights),
              "covars": torch.where(total > 0, 1.0 / inv.sum(0),
                                    alone.covars)}
    err = par_close("mix vs manual", {k_: v.cpu().numpy() for k_, v in (
        ("weights", st.weights), ("covars", st.covars))},
        {k_: v.cpu().numpy() for k_, v in manual.items()})
    mixed = par_linear_fields(tr.final_state(st))
    ref = par_train_alone(AROW, {"r": 0.1}, dims, dev, blocks) \
        if rank == 0 else None
    peaks = all_gather_host(float(rep["peak_mib"] or 0.0), mesh, "workers")
    if rank == 0:
        par_line(f"world 2 (gloo, both ranks on one card) MixTrainer "
                 f"argmin_kld, {k} blocks a replica, one mix", rep,
                 f" (rank peaks {peaks.round(1).tolist()} MiB); == manual "
                 f"argminKLD of the replicas trained alone (max |err| "
                 f"{err:.3g}); holdout logloss "
                 f"{par_holdout_ll(mixed['weights'], held):.4f} "
                 f"(single-device on both replicas' rows "
                 f"{par_holdout_ll(par_linear_fields(ref)['weights'], held):.4f})")

    # ShardedTrainer: 2 stripes, minibatch, then a scan prefix
    want = None
    if rank == 0:
        ref = par_train_alone(AROW, {"r": 0.1}, dims, dev, first)
        ref = par_train_alone(AROW, {"r": 0.1}, dims, dev, tuple(
            a[0, :cfg["scan_rows"]][None] for a in blocks), mode="scan",
            state=ref)
        want = par_linear_fields(ref)
    tr = ShardedTrainer(AROW, {"r": 0.1}, dims, mesh)
    scan = ShardedTrainer(AROW, {"r": 0.1}, dims, mesh, mode="scan")
    st = tr.init()

    def steps():
        s = st
        for i in range(k):
            s, _ = tr.step(s, *(a[i] for a in first))
        return s

    st, rep = par_run(mesh, dev, steps, k, k * b)
    srows = cfg["scan_rows"]
    st, rep_scan = par_run(mesh, dev, lambda: scan.step(
        st, *(a[0, :srows] for a in blocks))[0], srows, srows)
    got = par_linear_fields(tr.final_state(st))
    peaks = all_gather_host(float(rep["peak_mib"] or 0.0), mesh, "workers")
    if rank == 0:
        err = par_close("sharded", got, want, ints=("touched",))
        par_line(f"world 2 ShardedTrainer minibatch, 2 stripes of "
                 f"{tr.stripe}", rep,
                 f" (rank peaks {peaks.round(1).tolist()} MiB)")
        par_line(f"world 2 ShardedTrainer scan prefix of {srows} rows (a "
                 f"step = a row)", rep_scan,
                 f"; both == single-device (max |err| {err:.3g})")

    # Sharded2DTrainer at 1 x 2 (== single-device) and 2 x 1 (== MixTrainer)
    for r_, s_ in ((1, 2), (2, 1)):
        mesh2 = make_mesh_2d(r_, s_, device=dev)
        try:
            t2 = Sharded2DTrainer(AROW, {"r": 0.1}, dims, mesh2,
                                  config=MixConfig(mix_every=k))
            data = first if r_ == 1 else mine
            (st2, _), rep = par_run(mesh2, dev, lambda: t2.step(
                t2.init(), *data), k, k * b * r_)
            got = par_linear_fields(t2.final_state(st2))
        finally:
            mesh2.destroy()
        if rank == 0:
            base = par_linear_fields(par_train_alone(
                AROW, {"r": 0.1}, dims, dev, first)) if r_ == 1 else mixed
            err = par_close(f"2d {r_}x{s_}", got, base, ints=("touched",))
            par_line(f"world 2 Sharded2DTrainer {r_} x {s_}", rep,
                     f"; == {'single-device' if r_ == 1 else 'MixTrainer'} "
                     f"(max |err| {err:.3g})")

    par_fm(cfg, dev, mesh, rank, blocks)
    par_mc(cfg, dev, mesh, rank)
    par_ffm(cfg, dev, mesh, rank)
    par_gbt(cfg, dev, mesh, rank)


def phase_parallel(seed, dev, smi, data):
    """Data-parallel and feature-sharded training (hivemall_tpu_torch/
    parallel/): (a) a world of one in this process (NCCL on the card), (b)
    a spawned world of two over gloo with both ranks on the one card."""
    import os
    import shutil
    import tempfile

    import chip_smoke
    from hivemall_tpu_torch.parallel.mesh import spawn

    _, (idx, val, y), (h_idx, h_val, h_y) = data
    cfg = par_config(dev)
    blocks = par_blocks(cfg, idx, val, y)
    held = (h_idx, h_val, h_y)
    print(f"[parallel] card: {smi}")
    t0 = time.perf_counter()
    par_world_one(cfg, dev, blocks, held)
    t1 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="hivemall_parallel_")
    try:
        np.savez(os.path.join(tmp, "data.npz"), idx=blocks[0],
                 val=blocks[1], lab=blocks[2], h_idx=h_idx, h_val=h_val,
                 h_y=h_y)
        spawn(chip_smoke.parallel_rank, 2, (tmp, cfg),
              init_file=os.path.join(tmp, "rendezvous"), backend="gloo",
              device=cfg["device"], timeout=PAR_TIMEOUT)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[parallel] world 1 took {t1 - t0:.1f} s, world 2 (spawn "
          f"included) {time.perf_counter() - t1:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import hivemall_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}; {smi}")
    t_start = time.perf_counter()
    built = phase_build()
    err = phase_families(args.seed, dev)
    err = max(err, phase_stress(args.seed, dev))
    scan, plan = phase_width(args.seed, dev)
    data = main_data(args.seed)
    launches, main_mini, served, pallas_run = phase_main(args.seed, dev,
                                                         data)
    from hivemall_tpu_torch.kernels.linear_scan import LAUNCHES

    for key in LAUNCHES:
        LAUNCHES[key] = 0
    phase_serve(served, dev, smi)
    print(f"[serve] kernel launches during the serve phase: "
          f"{dict(LAUNCHES)} (serving runs no hand-written kernel)")
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t_cache = time.perf_counter()
    phase_cache(args.seed, dev, smi, served)
    print(f"[cache] phase took {time.perf_counter() - t_cache:.1f} s; kernel "
          f"launches during it: {dict(LAUNCHES)} (the score cache is host "
          f"Python in both packages)")
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t_fm = time.perf_counter()
    fm_run, fm_model = phase_fm(args.seed, dev, smi, data, served[0])
    print(f"[fm] phase took {time.perf_counter() - t_fm:.1f} s; kernel "
          f"launches during it: {dict(LAUNCHES)} (the FM path reaches no "
          f"pallas_call in the JAX package and runs plain torch ops here)")
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t_batch = time.perf_counter()
    batch_run = phase_batch(args.seed, dev, data, main_mini)
    print(f"[batch] phase took {time.perf_counter() - t_batch:.1f} s; kernel "
          f"launches during it: {dict(LAUNCHES)} (the -batch path reaches no "
          f"pallas_call in the JAX package and runs plain torch ops here)")
    t_native = time.perf_counter()
    phase_native(args.seed, dev, data, built, (served[0],) + pallas_run,
                 fm_run, batch_run)
    print(f"[native] phase took {time.perf_counter() - t_native:.1f} s (the "
          f"native host library reaches no pallas_call in the JAX package "
          f"and adds no CUDA kernel)")
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t_mf = time.perf_counter()
    mf_train, mf_held = mf_data(args.seed)
    mf_model, mf_arts = phase_mf(args.seed, dev, smi, mf_train, mf_held)
    print(f"[mf] phase took {time.perf_counter() - t_mf:.1f} s; kernel "
          f"launches during it: {dict(LAUNCHES)} (the MF path reaches no "
          f"pallas_call in the JAX package and runs plain torch ops here)")
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t_knn = time.perf_counter()
    phase_knn(args.seed, dev, smi, mf_model)
    del mf_model
    print(f"[knn] phase took {time.perf_counter() - t_knn:.1f} s; kernel "
          f"launches during it: {dict(LAUNCHES)} (the batch distances are "
          f"matmuls outside any pallas_call in the JAX package)")
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t_topk = time.perf_counter()
    phase_topk(args.seed, dev, smi, mf_held, mf_arts, fm_model,
               string_rows(data[2][0], data[2][1], 8))
    print(f"[topk] phase took {time.perf_counter() - t_topk:.1f} s; kernel "
          f"launches during it: {dict(LAUNCHES)} (retrieval reaches no "
          f"pallas_call in the JAX package and runs plain torch ops here)")
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t_mc = time.perf_counter()
    phase_mc(args.seed, dev, smi, served[0])
    print(f"[mc] phase took {time.perf_counter() - t_mc:.1f} s; kernel "
          f"launches during it: {dict(LAUNCHES)} (the multiclass path "
          f"reaches no pallas_call in the JAX package and runs plain torch "
          f"ops here)")
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t_ffm = time.perf_counter()
    phase_ffm(args.seed, dev, smi, served[0])
    print(f"[ffm] phase took {time.perf_counter() - t_ffm:.1f} s; kernel "
          f"launches during it: {dict(LAUNCHES)} (the FFM path reaches no "
          f"pallas_call in the JAX package and runs plain torch ops here)")
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t_trees = time.perf_counter()
    phase_trees(args.seed, dev, smi, served[0],
                string_rows(data[2][0], data[2][1], 64))
    print(f"[trees] phase took {time.perf_counter() - t_trees:.1f} s; kernel "
          f"launches during it: {dict(LAUNCHES)} (the trees reach no "
          f"pallas_call in the JAX package and run plain torch ops here)")
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t_pipe = time.perf_counter()
    phase_pipeline(args.seed, dev, smi)
    print(f"[pipeline] phase took {time.perf_counter() - t_pipe:.1f} s; "
          f"kernel launches during it: {dict(LAUNCHES)} (the pipeline "
          f"trains through make_train_step in minibatch mode and reaches no "
          f"pallas_call in the JAX package)")
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t_par = time.perf_counter()
    phase_parallel(args.seed, dev, smi, data)
    print(f"[parallel] phase took {time.perf_counter() - t_par:.1f} s; "
          f"kernel launches during it: {dict(LAUNCHES)} (hivemall_tpu/"
          f"parallel reaches no pallas_call: its collectives are XLA psums "
          f"and its steps the engine's XLA ops, plain torch here)")
    source = "hivemall_tpu_torch/kernels/csrc/linear_scan.cu"
    replaces = "hivemall_tpu/kernels/linear_scan.py:44"
    kernels = [
        {"name": "linear_scan", "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches["linear_scan"],
         "max_abs_err": max(err, scan["err"]), "ms": scan["ms"],
         "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "latency_floor_ms": scan["latency_floor_ms"]},
        {"name": "linear_scan_plan", "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches["linear_scan_plan"],
         "max_abs_err": 0.0, "ms": plan["ms"], "plain_ms": plan["plain_ms"],
         "bound_ms": plan["bound_ms"], "bound_by": plan["bound_by"],
         "library_ms": None},
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
