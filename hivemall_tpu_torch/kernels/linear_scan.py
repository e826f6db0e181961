"""Exact-scan backend for the linear-learner engine: CUDA kernels for the
card and their plain torch versions.

Counterpart of hivemall_tpu/kernels/linear_scan.py (the Pallas kernel
`_make_kernel`, run through `pallas_scan_raw`). One call replays one block's
rows sequentially through a Rule — the reference's per-row semantics
(ref: BinaryOnlineClassifierUDTF.java:111-247):

- `linear_scan(rule, hyper, state, indices, values, labels)` is the wrapper.
  On CUDA tensors it launches two kernels of `csrc/linear_scan.cu` (built
  with nvcc at first use, see kernels/build.py): the block's plan
  (`linear_scan_plan`), then the scan, which reads the plan to forward table
  values between nearby rows and to fold repeated lanes. It raises on what
  the kernels do not take. On CPU tensors it runs `linear_scan_reference`.
  There is no fallback from a kernel to its plain version.
- `linear_scan_reference` is the plain version of the scan: a per-row torch
  loop that calls the rule's torch `update` exactly as the Pallas body
  traces it — gather every lane first (dead lanes read 0, covariance 1.0),
  then add each lane's delta (repeated features sum), or for a derive_w rule
  set w with the last repeating lane winning.
- `linear_scan_plan_reference` is the plain version of the plan.

Both scans update the state's tables IN PLACE (the Pallas kernel aliases its
tables in->out; here the input state's tensors are the output's) and return
(new_state, per_row_losses). `touched` marks every live lane of every row,
as the Pallas path does (hivemall_tpu/kernels/linear_scan.py:293) — unlike
the engine's scan mode, which marks only rows where the rule fired.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.engine import Rule, RowContext, live_lanes, set_last_lane_wins
from ..core.state import LinearState
from ..device import DeviceLike, resolve_device

_SOURCE = Path(__file__).resolve().parent / "csrc" / "linear_scan.cu"


def _kernel_forms() -> Dict[str, Tuple[int, Tuple[str, ...]]]:
    """rule name -> (kernel rule id, hyperparameter keys in the kernel's
    order), read from the HM_RULE_FORMS table of the kernel's source."""
    rows = re.findall(r'^\s*X\((\w+), "(\w+)", "([\w,]*)"\)',
                      _SOURCE.read_text(), re.M)
    return {name: (i, tuple(k for k in keys.split(",") if k))
            for i, (_, name, keys) in enumerate(rows)}


def _eta_schedules() -> Dict[str, int]:
    """eta schedule kind -> its code in the kernel's logress form, read from
    the HM_ETA_SCHEDULES table of the kernel's source."""
    rows = re.findall(r'^\s*X\((\w+), "(\w+)"\)', _SOURCE.read_text(), re.M)
    return {name: i for i, (_, name) in enumerate(rows)}


KERNEL_FORMS = _kernel_forms()
ETA_SCHEDULES = _eta_schedules()
# a plan's fwd entry is (delta << FWD_SHIFT) | lane, or -1
FWD_SHIFT = 16

# kernel launches by this process; chip_smoke.py zeroes and reads it to show
# that a run went through the kernels
LAUNCHES = {"linear_scan": 0, "linear_scan_plan": 0}

_lib = None


def _library():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("linear_scan")
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        for fn, args in (
                ("hm_linear_scan", [i, p, i] + [p] * 12 + [i, i, ll, i, i, p]),
                ("hm_linear_scan_stage_cycles",
                 [p, i] + [p] * 9 + [i, i, ll, i, i, p, p]),
                ("hm_linear_scan_plan", [p] * 4 + [i, i, ll, i, p]),
                ("hm_linear_scan_depth", [i, i]),
                ("hm_linear_scan_max_k", []),
                ("hm_row_chain_floor", [p] * 4 + [i, i, ll, p])):
            getattr(lib, fn).restype = i
            getattr(lib, fn).argtypes = args
        for fn, args in (("hm_cuda_error_string", [i]),
                         ("hm_linear_scan_stage_names", [])):
            getattr(lib, fn).restype = ctypes.c_char_p
            getattr(lib, fn).argtypes = args
        _lib = lib
    return _lib


def _check(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.hm_cuda_error_string(rc).decode()} ({rc})")


def _tables(rule: Rule, state: LinearState):
    """The state's f32 tables in the kernel's order: w, cov, slots by
    sorted name. Non-f32 tables (bf16 storage) become f32 copies, as the
    Pallas path returns f32 tables."""
    slot_names = tuple(sorted(rule.slot_names))
    w = state.weights.float().contiguous()
    cov = state.covars.float().contiguous() if rule.use_covariance else None
    slots = {s: state.slots[s].float().contiguous() for s in slot_names}
    return w, cov, slots, slot_names


def _finish(rule, state, indices, w, cov, slots, globals_):
    """New state around the updated tables; `touched` marks every live lane
    of every row (one scatter outside the scan, as on the TPU)."""
    b = indices.shape[0]
    live, _ = live_lanes(indices, state.dims)
    sink = torch.where(live, indices, torch.full_like(indices, state.dims))
    hit = torch.zeros(state.dims + 1, dtype=torch.int8, device=indices.device)
    hit[sink.reshape(-1)] = 1
    touched = torch.maximum(state.touched, hit[:state.dims])
    new_slots = dict(state.slots)
    new_slots.update(slots)
    return state.replace(weights=w, covars=cov if rule.use_covariance
                         else state.covars, slots=new_slots, touched=touched,
                         globals=globals_, step=state.step + b)


def linear_scan_reference(rule: Rule, hyper: dict, state: LinearState,
                          indices: torch.Tensor, values: torch.Tensor,
                          labels: torch.Tensor):
    """The plain torch version of the kernel (see the module docstring)."""
    d = state.dims
    w, cov, slots, slot_names = _tables(rule, state)
    gl = dict(state.globals)
    losses = []
    for b in range(indices.shape[0]):
        y = labels[b]
        t = torch.tensor(float(state.step + b + 1), device=w.device)
        if rule.pre_row is not None:
            gl = rule.pre_row(dict(gl), y)
        live, sidx = live_lanes(indices[b], d)
        livef = live.float()
        val = values[b] * livef
        wk = w[sidx] * livef
        ck = None
        variance = torch.zeros((), device=w.device)
        if rule.use_covariance:
            ck = torch.where(live, cov[sidx], 1.0)
            variance = torch.sum(ck * val * val)
        sl = {s: slots[s][sidx] * livef for s in slot_names}
        ctx = RowContext(wk, ck, sl, val, y, torch.sum(wk * val),
                         torch.sum(val * val), variance, t, gl)
        out = rule.update(ctx, hyper)
        lidx = sidx[live]
        if rule.derive_w is not None:
            sl_new = {n: ctx.slots[n] + out.dslots.get(n, 0.0) for n in sl}
            w_new = rule.derive_w(sl_new, t, hyper)
            set_last_lane_wins(w, sidx, live & out.updated, w_new)
        else:
            w.index_add_(0, lidx, out.dw[live])
        if rule.use_covariance and out.dcov is not None:
            cov.index_add_(0, lidx, out.dcov[live])
        for s in slot_names:
            if s in out.dslots:
                slots[s].index_add_(0, lidx, out.dslots[s][live])
        losses.append(out.loss)
    loss = torch.stack(losses) if losses else torch.zeros(0, device=w.device)
    return _finish(rule, state, indices, w, cov, slots, gl), loss


def linear_scan_plan_reference(indices: torch.Tensor, dims: int, depth: int):
    """The plain torch version of the plan kernel: int32 [B, K] tables
    (lead, next, fwd) of one block.

    lead[b, k]: the first lane of row b holding lane k's feature, -1 on a
    dead lane. next[b, k]: the next lane of row b holding it, -1 if none.
    fwd[b, k]: (delta << FWD_SHIFT) | lane for the latest earlier row b-delta
    (1 <= delta <= depth) holding the feature and that row's first lane of
    it; -1 if no row within depth does (and on a dead lane)."""
    idx = indices.long()
    b, k = idx.shape
    live = (idx >= 0) & (idx < dims)
    lanes = torch.arange(k, device=idx.device)
    same = ((idx[:, :, None] == idx[:, None, :]) & live[:, :, None]
            & live[:, None, :])
    lead = torch.where(live, same.to(torch.uint8).argmax(2), -1)
    after = same & (lanes[None, None, :] > lanes[None, :, None])
    nxt = torch.where(after.any(2), after.to(torch.uint8).argmax(2), -1)
    fwd = torch.full_like(idx, -1)
    for d in range(min(depth, b - 1), 0, -1):  # nearer rows overwrite
        hit = (idx[d:, :, None] == idx[:-d, None, :]) & live[d:, :, None]
        entry = (d << FWD_SHIFT) | hit.to(torch.uint8).argmax(2)
        fwd[d:] = torch.where(hit.any(2), entry, fwd[d:])
    return tuple(t.to(torch.int32) for t in (lead, nxt, fwd))


def linear_scan_plan(indices: torch.Tensor, dims: int, depth: int):
    """The block's plan (see `linear_scan_plan_reference`): the plan kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    if indices.device.type == "cpu":
        return linear_scan_plan_reference(indices, dims, depth)
    if indices.device.type != "cuda" or indices.dim() != 2:
        raise ValueError(f"linear_scan_plan takes a 2-d cuda or cpu tensor, "
                         f"not {tuple(indices.shape)} on {indices.device}")
    lib = _library()
    idx32 = indices.to(torch.int32).contiguous()
    lead, nxt, fwd = (torch.empty_like(idx32) for _ in range(3))
    b, k = idx32.shape
    _check(lib, lib.hm_linear_scan_plan(
        idx32.data_ptr(), lead.data_ptr(), nxt.data_ptr(), fwd.data_ptr(), b,
        k, dims, depth, torch.cuda.current_stream(indices.device).cuda_stream),
        "linear_scan_plan")
    LAUNCHES["linear_scan_plan"] += 1
    return lead, nxt, fwd


def scan_depth(rule: Rule, k: int) -> int:
    """Rows of look-ahead the CUDA scan runs `rule` with at row width k (the
    plan's forwarding depth); -1 if k is wider than the kernel takes."""
    return _library().hm_linear_scan_depth(KERNEL_FORMS[rule.name][0], k)


def _hyper_values(keys, hyper) -> np.ndarray:
    """The kernel's h[] from a hyper dict; logress's schedule kind becomes
    its code."""
    vals = [float(ETA_SCHEDULES[hyper[key]] if key == "schedule"
                  else hyper[key]) for key in keys]
    return np.asarray(vals or [0.0], dtype=np.float32)


def linear_scan(rule: Rule, hyper: dict, state: LinearState,
                indices: torch.Tensor, values: torch.Tensor,
                labels: torch.Tensor, plan=None,
                stage_cycles: torch.Tensor = None):
    """Run one block through the exact scan: the CUDA kernels on CUDA
    tensors, `linear_scan_reference` on CPU tensors. Updates the state's
    tables in place; returns (new_state, per_row_losses [B]).

    `plan` (lead, next, fwd) skips the plan kernel for a block whose plan
    was built already, at `scan_depth(rule, K)`. `stage_cycles` (a CUDA
    int64 tensor, one entry per stage named by hm_linear_scan_stage_names(),
    AROW only) runs the scan's timing instance instead, which writes the
    clock ticks of each stage of a row summed over the block into it; it is
    for measurement, not training."""
    dev = state.weights.device
    if dev.type == "cpu":
        return linear_scan_reference(rule, hyper, state, indices, values,
                                     labels)
    if dev.type != "cuda":
        raise ValueError(f"linear_scan runs on cuda or cpu tensors, not {dev}")
    form = KERNEL_FORMS.get(rule.name)
    if form is None:
        raise ValueError(
            f"rule {rule.name!r} has no form in the CUDA scan kernel "
            f"(kernels/csrc/linear_scan.cu); drop -pallas to train it with "
            f"the engine")
    rule_id, keys = form
    if indices.dim() != 2 or values.shape != indices.shape \
            or labels.shape != indices.shape[:1]:
        raise ValueError(f"bad block shapes: indices {tuple(indices.shape)}, "
                         f"values {tuple(values.shape)}, labels "
                         f"{tuple(labels.shape)}")
    b, k = indices.shape
    lib = _library()
    depth = scan_depth(rule, k)
    if depth < 0:
        raise ValueError(f"row width {k} exceeds the kernel's "
                         f"{lib.hm_linear_scan_max_k()} lanes (shared memory)")
    d = state.dims
    if d >= 2 ** 31:
        raise ValueError(f"dims {d} exceeds the kernel's int32 feature ids")
    for name, x in (("indices", indices), ("values", values),
                    ("labels", labels)):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, state on {dev}")
    idx32 = indices.to(torch.int32).contiguous()
    val32 = values.to(torch.float32).contiguous()
    y32 = labels.to(torch.float32).contiguous()
    if plan is None:
        plan = linear_scan_plan(idx32, d, depth)
    elif any(t.dtype != torch.int32 or t.shape != idx32.shape
             or t.device != dev or not t.is_contiguous() for t in plan):
        raise ValueError("plan: three contiguous int32 tensors shaped like "
                         "indices, on the state's device")
    lead, nxt, fwd = plan
    w, cov, slots, slot_names = _tables(rule, state)
    global_names = tuple(sorted(rule.global_names))
    gvec = (torch.stack([state.globals[g].float() for g in global_names])
            .contiguous() if global_names else None)
    losses = torch.empty(b, dtype=torch.float32, device=dev)
    hyper_arr = _hyper_values(keys, hyper)
    s = [slots[n] for n in slot_names] + [None, None]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(x):
        return None if x is None else x.data_ptr()

    block = (ptr(idx32), ptr(val32), ptr(y32), ptr(lead), ptr(nxt), ptr(fwd),
             ptr(losses))
    if stage_cycles is None:
        rc = lib.hm_linear_scan(
            rule_id, hyper_arr.ctypes.data, len(keys), *block, ptr(w),
            ptr(cov), ptr(s[0]), ptr(s[1]), ptr(gvec), b, k, d,
            int(state.step), depth, stream)
    else:
        if rule.name != "arow" or stage_cycles.dtype != torch.int64 \
                or stage_cycles.device != dev \
                or stage_cycles.numel() != len(
                    lib.hm_linear_scan_stage_names().split(b",")):
            raise ValueError("stage_cycles: the timing instance is AROW's and "
                             "takes an int64 tensor of one entry per stage "
                             "on the card")
        rc = lib.hm_linear_scan_stage_cycles(
            hyper_arr.ctypes.data, len(keys), *block, ptr(w), ptr(cov), b, k,
            d, int(state.step), depth, ptr(stage_cycles), stream)
    _check(lib, rc, "linear_scan")
    LAUNCHES["linear_scan"] += 1
    globals_ = ({g: gvec[i] for i, g in enumerate(global_names)}
                if global_names else dict(state.globals))
    return _finish(rule, state, indices, w, cov, slots, globals_), losses


def make_pallas_scan_step(rule: Rule, hyper: dict, device: DeviceLike = None):
    """step(state, indices, values, labels) -> (state, loss_sum), API-equal
    to core.engine.make_train_fn(mode='scan'); `fit_linear -pallas`
    routes here. The name is the JAX package's; on the card the step is the
    CUDA kernel."""
    dev = resolve_device(device)

    def step(state: LinearState, indices, values, labels):
        indices = torch.as_tensor(indices, device=dev)
        values = torch.as_tensor(values, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        new_state, losses = linear_scan(rule, hyper, state, indices, values,
                                        labels)
        return new_state, torch.sum(losses)

    return step
