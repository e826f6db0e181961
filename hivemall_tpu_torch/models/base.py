"""Shared trainer driver for the linear-learner family.

Mirrors LearnerBaseUDTF + BinaryOnlineClassifierUDTF / RegressionBaseUDTF
(ref: core/.../hivemall/LearnerBaseUDTF.java:61-343,
BinaryOnlineClassifierUDTF.java:51-298, regression/RegressionBaseUDTF.java:58-295):
option parsing, model creation, the training loop, and model emission — with
rows staged into fixed-shape FeatureBlocks on the host and the update rules
run on the device (core/engine.py, kernels/linear_scan.py).

Execution modes:
- default (`-mini_batch 1`): scan mode — per-row sequential semantics,
  reference-exact.
- `-pallas` with scan mode: the same exact scan as ONE kernel launch per
  block — the CUDA kernel on the card (kernels/csrc/linear_scan.cu), its
  plain torch version on the CPU. The flag keeps the JAX package's name.
- `-mini_batch B` > 1: minibatch mode — the reference's accumulate-then-
  apply-average semantics; with `-mxu_scatter`, over ops/mxu_scatter.py's
  sorted-id gather / scatter-add (core/engine.py update_backend="mxu").
- `-batch B`: the same minibatch semantics through host-staged dedup plans
  (core/batch_update.py): one compact write per unique feature of each
  B-row chunk.
- `-native_scan` (AROW) and `-batch B -native_apply`: host loops of the
  native C++ library over numpy tables (native/, core/native_batch.py), the
  JAX package's path for workers without an accelerator; the trained state
  is then placed on the device like every other backend's.
- `-iters N` + `-cv_rate`: multi-epoch with convergence checking.

Training runs on the CUDA device unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..constants import DEFAULT_NUM_FEATURES
from ..core.batch import iter_blocks, pad_to_bucket, shuffle_rows
from ..core.batch_update import (make_batch_train_step, stage_block_plans,
                                 upload_block_plans)
from ..core.engine import Rule, make_predict, make_train_fn
from ..core.state import LinearState, init_linear_state, model_rows
from ..device import DeviceLike, resolve_device
from ..ops.convergence import ConversionState
from ..runtime.metrics import REGISTRY
from ..utils.feature import parse_features_batch
from ..utils.options import CommandLine, Options

def base_options() -> Options:
    """Options shared by all linear learners (ref: LearnerBaseUDTF.java:85-103)."""
    o = Options()
    o.add("dense", "densemodel", False, "Use dense model or not (always dense)")
    o.add("dims", "feature_dimensions", True,
          "The dimension of model [default: 2^24 hashed space]", default=None, type=int)
    o.add("disable_halffloat", None, False, "(accepted for parity; fp32/bf16 storage)")
    o.add("loadmodel", None, True,
          "Warm-start from a saved model-rows table (ref: LearnerBaseUDTF.java:215-333)")
    # MIX client options accepted for signature parity
    # (ref: LearnerBaseUDTF.java:92-103)
    o.add("mix", "mix_servers", True, "(parity) MIX server list")
    o.add("mix_session", "mix_session_name", True, "(parity) MIX session name")
    o.add("mix_threshold", None, True, "(parity) MIX push threshold", type=int)
    o.add("mix_cancel", "enable_mix_canceling", False, "(parity) no-op")
    o.add("ssl", None, False, "(parity) TLS handled by the deployment, not the library")
    o.add("mini_batch", "mini_batch_size", True,
          "Mini batch size [default: 1 = exact per-row scan]", default=1, type=int)
    o.add("iters", "iterations", True, "Number of epochs [default: 1]", default=1, type=int)
    o.add("disable_cv", "disable_cvtest", False, "Disable convergence check")
    o.add("cv_rate", "convergence_rate", True, "Convergence rate [default: 0.005]",
          default=0.005, type=float)
    o.add("block_size", None, True, "Rows per staged device block [default: 4096]",
          default=4096, type=int)
    o.add("shuffle", None, False, "Shuffle rows between epochs")
    o.add("seed", None, True, "Shuffle seed", default=31, type=int)
    o.add("pallas", None, False,
          "Run exact scan mode as one kernel launch per block "
          "(kernels/linear_scan.py: the CUDA kernel on the card)")
    o.add("native_scan", None, False,
          "Run exact scan epochs through the native C row loop — the "
          "host path for workers without an accelerator (train_arow: any "
          "options; train_fm: -classification with a fixed -eta)")
    o.add("mxu_scatter", None, False,
          "Route -mini_batch table updates through the sorted-id "
          "gather/scatter (ops/mxu_scatter.py): one packed gather and one "
          "stacked scatter-add a block, without float atomics; ignored in "
          "exact scan mode, as in the JAX package")
    o.add("batch", "batch_backend", True,
          "Segment-sum batched backend: apply minibatches of B rows "
          "through one host-staged dedup plan (core/batch_update.py) — "
          "same mini-batch semantics as -mini_batch B, one compact write "
          "per unique feature of each chunk", type=int)
    o.add("native_apply", None, False,
          "With -batch B: apply the staged dedup plans through one "
          "vectorized C++ pass per block (core/native_batch.py) over host "
          "f32 tables — same mini-batch semantics; falls back LOUDLY to "
          "the -batch path when the rule or the table dtype has no native "
          "form")
    return o


ArrayRows = Tuple[List[np.ndarray], List[np.ndarray]]
FeatureRows = Union[Sequence[Sequence[str]], ArrayRows]


def _stage_rows(features: FeatureRows, dims: int) -> ArrayRows:
    if isinstance(features, tuple) and len(features) == 2:
        idx_rows = [np.asarray(r, dtype=np.int64) % dims for r in features[0]]
        val_rows = [np.asarray(v, dtype=np.float32) for v in features[1]]
        return idx_rows, val_rows
    return parse_features_batch(features, dims)


@dataclass
class TrainedLinearModel:
    """A fitted model: its device state and rule."""

    state: LinearState
    rule: Rule
    dims: int
    block_width: int

    def predict(self, features: FeatureRows, return_variance: bool = False):
        """Batched scoring on the state's device; numpy results."""
        idx_rows, val_rows = _stage_rows(features, self.dims)
        n = len(idx_rows)
        width = pad_to_bucket(max((len(r) for r in idx_rows), default=1))
        want_var = return_variance and self.rule.use_covariance
        predict = make_predict(use_covariance=want_var)
        # keep per-block outputs on the device; ONE transfer at the end
        scores, variances = [], []
        for block in iter_blocks(idx_rows, val_rows, np.zeros(n), self.dims,
                                 4096, width):
            out = predict(self.state, block.indices, block.values)
            if want_var:
                scores.append(out[0])
                variances.append(out[1])
            else:
                scores.append(out)
        if not scores:
            empty = np.zeros(0, np.float32)
            return (empty, empty) if want_var else empty
        score = torch.cat(scores).cpu().numpy()[:n]
        if want_var:
            return score, torch.cat(variances).cpu().numpy()[:n]
        return score

    def model_rows(self, filter_zero: bool = False):
        return model_rows(self.state, filter_zero)


def _host_f32(x) -> Optional[np.ndarray]:
    """A warm-start table (numpy or tensor, bf16 included) as host f32."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _fit_native_scan(rule, hyper, cl, dims, idx_rows, val_rows, labels,
                     width, block_size, initial_weights, initial_covars,
                     dev) -> TrainedLinearModel:
    """`-native_scan`: exact sequential AROW epochs through the C row loop
    (native/hivemall_native.cpp::hm_arow_reference_rowloop) on host numpy
    tables, the JAX package's host path for workers without an
    accelerator. Semantics = engine scan mode (per-row sequential,
    AROWClassifierUDTF.java:99-150); the epoch 'loss' for -iters
    convergence is the margin-violation count. The trained state is
    placed on `dev`."""
    from .. import native

    if rule.name != "arow":
        raise ValueError(
            "-native_scan supports train_arow only (the C row loop "
            f"implements AROW's closed form); {rule.name} has no native "
            "path — drop the flag")
    initial_weights = _host_f32(initial_weights)
    # one extra sentinel slot: block padding uses index == dims with value
    # 0, so pad lanes read/write the sentinel and touch no real feature
    st = {
        "w": np.zeros(dims + 1, np.float32),
        "cov": np.ones(dims + 1, np.float32),
        "clocks": np.zeros(dims + 1, np.int16),
        "deltas": np.zeros(dims + 1, np.int8),
    }
    if initial_weights is not None:
        st["w"][:dims] = initial_weights
    if initial_covars is not None:
        st["cov"][:dims] = _host_f32(initial_covars)
    r = hyper.get("r", 0.1)
    # zero-row probe: builds and loads the library (raising if it cannot)
    # and allocates the touch flags without touching the state
    native.arow_reference_rowloop(
        np.zeros((0, 1), np.int32), np.zeros((0, 1), np.float32),
        np.zeros(0, np.float32), dims + 1, r=r, state=st,
        track_touched=True)

    iters = cl.get_int("iters", 1)
    n = len(idx_rows)
    conv = ConversionState(not cl.has("disable_cv"),
                           cl.get_float("cv_rate", 0.005))
    row_counter = REGISTRY.counter("hivemall", f"{rule.name}.examples")
    iter_counter = REGISTRY.counter("hivemall", f"{rule.name}.iterations")
    for it in range(max(1, iters)):
        if cl.has("shuffle") and it > 0:
            idx_rows, val_rows, labels = shuffle_rows(
                idx_rows, val_rows, labels, cl.get_int("seed", 31) + it)
        epoch_violations = 0
        for block in iter_blocks(idx_rows, val_rows, labels, dims,
                                 block_size, width):
            epoch_violations += native.arow_reference_rowloop(
                block.indices, block.values, block.labels, dims + 1,
                r=r, state=st, track_touched=True)
            row_counter.increment(block.batch_size)
        iter_counter.increment()
        conv.incr_loss(float(epoch_violations))
        if iters > 1 and conv.is_converged(n):
            break

    state = init_linear_state(dims, use_covariance=True,
                              initial_weights=st["w"][:dims],
                              initial_covars=st["cov"][:dims], device=dev)
    # the C loop's monotone touch flags OR the warm-start mask — the
    # engine's semantics (init seeds touched from initial_weights != 0 and
    # updates only raise it); the wrap-prone clocks/deltas never feed
    # model emission
    touched = st["touch"][:dims] != 0
    if initial_weights is not None:
        touched |= initial_weights != 0
    state = state.replace(
        touched=torch.from_numpy(touched.astype(np.int8)).to(dev),
        step=n * (it + 1))
    return TrainedLinearModel(state=state, rule=rule, dims=dims,
                              block_width=width)


def _fit_native_batch(rule, hyper, cl, dims, idx_rows, val_rows, labels,
                      width, block_size, batch_b, initial_weights,
                      initial_covars, dev) -> TrainedLinearModel:
    """`-batch B -native_apply`: the staged-plan batch backend executed by
    one native C++ pass per block (core/native_batch.py). Plans are built
    on the host exactly as for `-batch` and reused across epochs (cleared
    when -shuffle re-deals the rows); the tables stay host f32 and become a
    LinearState on `dev` at the end."""
    from ..core.native_batch import (init_native_tables,
                                     make_native_batch_step,
                                     native_tables_to_state)

    step = make_native_batch_step(rule, hyper)
    tables = init_native_tables(dims, rule.use_covariance,
                                _host_f32(initial_weights),
                                _host_f32(initial_covars))
    iters = cl.get_int("iters", 1)
    n = len(idx_rows)
    conv = ConversionState(not cl.has("disable_cv"),
                           cl.get_float("cv_rate", 0.005))
    row_counter = REGISTRY.counter("hivemall", f"{rule.name}.examples")
    iter_counter = REGISTRY.counter("hivemall", f"{rule.name}.iterations")
    plan_cache: list = []
    for it in range(max(1, iters)):
        if cl.has("shuffle") and it > 0:
            idx_rows, val_rows, labels = shuffle_rows(
                idx_rows, val_rows, labels, cl.get_int("seed", 31) + it)
            plan_cache = []
        epoch_loss = 0.0
        for bi, block in enumerate(iter_blocks(idx_rows, val_rows, labels,
                                               dims, block_size, width)):
            if bi >= len(plan_cache):
                plan_cache.append(
                    stage_block_plans(block.indices, batch_b, dims))
            epoch_loss += step(tables, block.values, block.labels,
                               plan_cache[bi])
            row_counter.increment(block.batch_size)
        iter_counter.increment()
        conv.incr_loss(epoch_loss)
        if iters > 1 and conv.is_converged(n):
            break
    state = native_tables_to_state(tables, rule, n * (it + 1), device=dev)
    return TrainedLinearModel(state=state, rule=rule, dims=dims,
                              block_width=width)


def fit_linear(
    rule: Rule,
    hyper: dict,
    cl: CommandLine,
    features: FeatureRows,
    labels: Sequence[float],
    label_map: Callable[[np.ndarray], np.ndarray] = None,
    initial_weights: Optional[np.ndarray] = None,
    initial_covars: Optional[np.ndarray] = None,
    default_dims: int = DEFAULT_NUM_FEATURES,
    device: DeviceLike = None,
) -> TrainedLinearModel:
    """The generic fit loop used by every classifier/regressor `train_*`."""
    dev = resolve_device(device)
    dims = cl.get_int("dims") or default_dims
    mini_batch = cl.get_int("mini_batch", 1)
    iters = cl.get_int("iters", 1)
    block_size = cl.get_int("block_size", 4096)
    labels = np.asarray(labels, dtype=np.float32)
    if label_map is not None:
        labels = label_map(labels)

    if cl.has("loadmodel") and initial_weights is None:
        from ..io.checkpoint import dense_from_rows, load_model_rows

        feats0, w0, c0 = load_model_rows(cl.get("loadmodel"))
        initial_weights, initial_covars = dense_from_rows(dims, feats0, w0, c0)

    idx_rows, val_rows = _stage_rows(features, dims)
    n = len(idx_rows)
    if n == 0:
        raise ValueError("no training rows")
    width = pad_to_bucket(max((len(r) for r in idx_rows), default=1))

    batch_b = cl.get_int("batch", 0) if cl.has("batch") else 0
    mode = "minibatch" if mini_batch > 1 else "scan"
    if cl.has("batch"):
        if batch_b < 1:
            raise ValueError(f"-batch must be >= 1: {batch_b}")
        if mini_batch > 1:
            raise ValueError("-batch IS the mini-batch backend; drop "
                             "-mini_batch (its size becomes -batch's B)")
        if cl.has("native_scan") or cl.has("pallas") \
                or cl.has("mxu_scatter"):
            raise ValueError("-batch does not compose with -native_scan/"
                             "-pallas/-mxu_scatter; pick one execution "
                             "backend (docs/execution_backends.md)")
        mode = "batch"
    if cl.has("native_apply") and mode != "batch":
        # -native_apply is a modifier of the batch backend, not a backend
        # of its own
        raise ValueError("-native_apply rides the -batch backend; add "
                         "-batch B (docs/execution_backends.md)")
    if mode == "minibatch":
        block_size = mini_batch
    if mode == "batch":
        # a staged block holds whole minibatches: round the block up to a
        # multiple of B (only the dataset's last block stages a tail chunk)
        block_size = -(-max(block_size, batch_b) // batch_b) * batch_b
    if cl.has("native_scan"):
        if mode != "scan":
            raise ValueError("-native_scan is the exact per-row path; "
                             "drop -mini_batch or drop -native_scan")
        return _fit_native_scan(rule, hyper, cl, dims, idx_rows, val_rows,
                                labels, width, block_size, initial_weights,
                                initial_covars, dev)
    # SpaceEfficientDenseModel analog: above 2^24 dims the reference switches
    # to half-float storage unless -disable_halffloat
    # (ref: LearnerBaseUDTF.java:172-175); here that is bf16.
    dtype = torch.float32
    if dims > (1 << 24) and not cl.has("disable_halffloat"):
        dtype = torch.bfloat16
    if mode == "batch" and cl.has("native_apply"):
        from ..core.native_batch import native_batch_unsupported_reason

        reason = native_batch_unsupported_reason(
            rule, table_dtype_is_f32=dtype == torch.float32)
        if reason is None:
            return _fit_native_batch(rule, hyper, cl, dims, idx_rows,
                                     val_rows, labels, width, block_size,
                                     batch_b, initial_weights,
                                     initial_covars, dev)
        # loud fallback, never silent: the -batch path has the same
        # semantics, so training proceeds — but the caller asked for the
        # native pass and learns why they did not get it
        import warnings

        warnings.warn(f"-native_apply unavailable ({reason}); falling "
                      "back to the -batch backend", stacklevel=2)
    if mode == "batch":
        step = make_batch_train_step(rule, hyper, batch_size=batch_b,
                                     device=dev)
    elif cl.has("pallas") and mode == "scan":
        from ..kernels.linear_scan import make_pallas_scan_step

        step = make_pallas_scan_step(rule, hyper, device=dev)
    else:
        # the mxu backend runs only in minibatch mode; in scan mode the
        # flag is ignored, as in the JAX package
        backend = "mxu" if (cl.has("mxu_scatter") and mode == "minibatch") \
            else "xla"
        step = make_train_fn(rule, hyper, mode=mode, update_backend=backend,
                             device=dev)
    state = init_linear_state(
        dims,
        use_covariance=rule.use_covariance,
        slot_names=rule.slot_names,
        global_names=rule.global_names,
        dtype=dtype,
        initial_weights=initial_weights,
        initial_covars=initial_covars,
        device=dev,
    )

    conv = ConversionState(not cl.has("disable_cv"), cl.get_float("cv_rate", 0.005))
    # progress counters, the Hadoop Reporter/Counter analog
    # (ref: UDTFWithOptions.java:59-88, FM iteration counter :529-543)
    iter_counter = REGISTRY.counter("hivemall", f"{rule.name}.iterations")
    row_counter = REGISTRY.counter("hivemall", f"{rule.name}.examples")
    # -batch: plans are a pure function of each block's indices, so they
    # are staged on the host and uploaded once, then replayed every epoch
    # (cleared when -shuffle re-deals the rows)
    plan_cache: list = []
    for it in range(max(1, iters)):
        if cl.has("shuffle") and it > 0:
            idx_rows, val_rows, labels = shuffle_rows(
                idx_rows, val_rows, labels, cl.get_int("seed", 31) + it)
            plan_cache = []
        # losses stay on the device through the epoch; ONE transfer at the
        # epoch boundary feeds the convergence check
        epoch_losses = []
        for bi, block in enumerate(iter_blocks(idx_rows, val_rows, labels,
                                               dims, block_size, width)):
            args = [state] + [
                torch.from_numpy(a).to(dev, non_blocking=True)
                for a in (block.indices, block.values, block.labels)]
            if mode == "batch":
                if bi >= len(plan_cache):
                    plan_cache.append(upload_block_plans(
                        stage_block_plans(block.indices, batch_b, dims),
                        dims, dev))
                args.append(plan_cache[bi])
            state, loss = step(*args)
            epoch_losses.append(loss)
            row_counter.increment(block.batch_size)
        iter_counter.increment()
        epoch_loss = float(torch.stack(epoch_losses).sum().cpu())
        conv.incr_loss(epoch_loss)
        if iters > 1 and conv.is_converged(n):
            break
    return TrainedLinearModel(state=state, rule=rule, dims=dims, block_width=width)


def binary_label_map(labels: np.ndarray) -> np.ndarray:
    """int labels -> {-1, +1} (ref: BinaryOnlineClassifierUDTF train: y = label > 0 ? 1 : -1)."""
    return np.where(labels > 0, 1.0, -1.0).astype(np.float32)
