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
  apply-average semantics.
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
from ..core.engine import Rule, make_predict, make_train_fn
from ..core.state import LinearState, init_linear_state, model_rows
from ..device import DeviceLike, resolve_device
from ..ops.convergence import ConversionState
from ..utils.feature import parse_features_batch
from ..utils.options import CommandLine, Options

# execution flags of the JAX package whose backends are later slices of the
# port: refused by name rather than quietly run as something else
_LATER_SLICE_FLAGS = {
    "native_scan": "the native C row loop (-native_scan)",
    "batch": "the staged-plan batched backend (-batch, core/batch_update.py)",
    "native_apply": "the native batched apply (-native_apply)",
    "mxu_scatter": "the sorted-window gather/scatter (-mxu_scatter, "
                   "ops/mxu_scatter.py)",
}


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
    o.add("native_scan", None, False, "(later slice of the port)")
    o.add("mxu_scatter", None, False, "(later slice of the port)")
    o.add("batch", "batch_backend", True, "(later slice of the port)", type=int)
    o.add("native_apply", None, False, "(later slice of the port)")
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
    for flag, what in _LATER_SLICE_FLAGS.items():
        if cl.has(flag):
            raise ValueError(f"-{flag}: {what} is a later slice of the torch "
                             f"port (hivemall_tpu_torch); drop the flag")
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

    mode = "minibatch" if mini_batch > 1 else "scan"
    if mode == "minibatch":
        block_size = mini_batch
    if cl.has("pallas") and mode == "scan":
        from ..kernels.linear_scan import make_pallas_scan_step

        step = make_pallas_scan_step(rule, hyper, device=dev)
    else:
        step = make_train_fn(rule, hyper, mode=mode, device=dev)
    # SpaceEfficientDenseModel analog: above 2^24 dims the reference switches
    # to half-float storage unless -disable_halffloat
    # (ref: LearnerBaseUDTF.java:172-175); here that is bf16.
    dtype = torch.float32
    if dims > (1 << 24) and not cl.has("disable_halffloat"):
        dtype = torch.bfloat16
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
    for it in range(max(1, iters)):
        if cl.has("shuffle") and it > 0:
            idx_rows, val_rows, labels = shuffle_rows(
                idx_rows, val_rows, labels, cl.get_int("seed", 31) + it)
        # losses stay on the device through the epoch; ONE transfer at the
        # epoch boundary feeds the convergence check
        epoch_losses = []
        for block in iter_blocks(idx_rows, val_rows, labels, dims, block_size,
                                 width):
            state, loss = step(
                state,
                torch.from_numpy(block.indices).to(dev, non_blocking=True),
                torch.from_numpy(block.values).to(dev, non_blocking=True),
                torch.from_numpy(block.labels).to(dev, non_blocking=True))
            epoch_losses.append(loss)
        conv.incr_loss(float(torch.stack(epoch_losses).sum()))
        if iters > 1 and conv.is_converged(n):
            break
    return TrainedLinearModel(state=state, rule=rule, dims=dims, block_width=width)


def binary_label_map(labels: np.ndarray) -> np.ndarray:
    """int labels -> {-1, +1} (ref: BinaryOnlineClassifierUDTF train: y = label > 0 ? 1 : -1)."""
    return np.where(labels > 0, 1.0, -1.0).astype(np.float32)
