"""The native batched-apply execution backend (`-batch B -native_apply`).

The port of `hivemall_tpu/core/native_batch.py`. It hands the `-batch`
backend's host-built `StagedDedupPlan`s, verbatim (the frozen ABI of
ops/scatter.py::plan_abi_arrays: host int32, C-contiguous), to one C++ pass
per block (native/hivemall_native.cpp::hm_batch_apply_block): gather the
unique rows from host f32 tables, evaluate the rule's batch closed form,
segment-reduce the B*K lanes, and scatter-add back. The tables are numpy on
the host during the fit; `native_tables_to_state` puts the result on the
requested device. No device tensor crosses the C ABI.

Semantics are the batch backend's (the engine's minibatch accumulate-then-
apply, count-averaged): float tables equal up to reduction order, `touched`
exact. Supported rules are the native closed forms: perceptron, CW, AROW,
AROWh (native.BATCH_APPLY_RULES). Another rule or bf16 table storage falls
back loudly to the port's own `-batch` path (models/base.py warns with the
reason). A library that cannot be built is not such a case: it raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import native
from ..device import DeviceLike
from .batch_update import BlockPlans
from .engine import Rule
from .state import init_linear_state

# rule capabilities the native pass implements; anything beyond
# (optimizer slots, derive_w recomputation, scalar globals, DELTA_SLOT
# tracking) has no native form and falls back to the -batch path
_NATIVE_RULE_NAMES = frozenset(native.BATCH_APPLY_RULES)


def native_batch_unsupported_reason(rule: Rule,
                                    table_dtype_is_f32: bool = True,
                                    track_deltas: bool = False
                                    ) -> Optional[str]:
    """Why `-native_apply` cannot serve this configuration, or None when
    it can. The reason string is what models/base.py puts in its fallback
    warning — a mismatch is always reported, never swallowed."""
    if rule.name not in _NATIVE_RULE_NAMES:
        return (f"rule {rule.name!r} has no native batch closed form "
                f"(supported: {sorted(_NATIVE_RULE_NAMES)})")
    if rule.slot_names or rule.derive_w is not None or rule.global_names \
            or rule.pre_batch is not None or rule.pre_row is not None:
        return (f"rule {rule.name!r} carries optimizer slots/globals the "
                "native pass does not implement")
    if track_deltas:
        return "DELTA_SLOT tracking has no native form"
    if not table_dtype_is_f32:
        return ("bf16 table storage (dims > 2^24 without "
                "-disable_halffloat) has no native form; tables must be "
                "f32")
    return None


def init_native_tables(dims: int, use_covariance: bool,
                       initial_weights: Optional[np.ndarray] = None,
                       initial_covars: Optional[np.ndarray] = None) -> dict:
    """Host f32 tables the native pass mutates in place — the LinearState
    analog (weights 0, covars 1, touched 0; warm starts seed touched from
    nonzero weights like init_linear_state)."""
    t = {
        "w": (np.ascontiguousarray(initial_weights, np.float32).copy()
              if initial_weights is not None
              else np.zeros(dims, np.float32)),
        "cov": None,
        "touched": np.zeros(dims, np.int8),
    }
    if initial_weights is not None:
        t["touched"][np.asarray(initial_weights) != 0] = 1
    if use_covariance:
        t["cov"] = (np.ascontiguousarray(initial_covars, np.float32).copy()
                    if initial_covars is not None
                    else np.ones(dims, np.float32))
    return t


def make_native_batch_step(rule: Rule, hyper: dict,
                           mini_batch_average: bool = True):
    """`step(tables, values, labels, plans) -> loss_sum` applying one
    staged block through the native pass. `plans` is the block's
    stage_block_plans output (host plans: the ABI refuses device tensors);
    `tables` is init_native_tables' dict, mutated in place. Raises
    RuntimeError for a configuration without a native form (callers decide
    support first through native_batch_unsupported_reason) and when the
    library cannot be built."""
    reason = native_batch_unsupported_reason(rule)
    if reason is not None:
        raise RuntimeError(f"-native_apply unavailable: {reason}")
    native.library_path()  # build at first use, before the first block

    def step(tables: dict, values, labels, plans: BlockPlans) -> float:
        return native.batch_apply_block(
            rule.name, hyper, values, labels, plans.main, plans.tail,
            tables["w"].shape[0], tables["w"], tables["cov"],
            tables["touched"], mini_batch_average=mini_batch_average)

    return step


def native_tables_to_state(tables: dict, rule: Rule, n_examples: int,
                           device: DeviceLike = None):
    """The host tables as the port's LinearState on `device` (the
    fit_linear return convention: model emission reads touched, serving
    freezes weights)."""
    state = init_linear_state(
        tables["w"].shape[0], use_covariance=rule.use_covariance,
        initial_weights=tables["w"], initial_covars=tables["cov"],
        device=device)
    return state.replace(
        touched=state.touched.new_tensor(tables["touched"]),
        step=int(n_examples))
