"""Duplicate-free scatters: sort -> segment-reduce -> unique-index write.

The port of `hivemall_tpu/ops/scatter.py`. A duplicated scatter-add
`table[idx] += upd` becomes a sort of `idx`, one sum per distinct index and
one write per distinct index. Two forms:

- the **jit-built plan** (`DedupPlan`, `make_dedup_plan`, `segment_totals`,
  `dedup_*`): the sort runs on the device, the slot axis keeps N entries;
- the **staged plan** (`StagedDedupPlan`): built on the host in numpy when a
  block is staged (`build_staged_plan`, `pad_plan`, `plan_slot_bucket`,
  `plan_abi_arrays` — copies of the JAX package's planners, array for
  array equal to its plans), uploaded once and replayed every epoch by the
  `-batch B` backend (core/batch_update.py) through the `staged_*` ops.

`scatter_rows_flat` is FM's row scatter-add. The JAX function scatters
through the flat [E*k] scalar view because that form ran 2x faster on the
TPU, and falls back to the row form where E*k overflows an int32 index.
Neither concern exists here (torch indexes in int64), so the port keeps the
semantics and drops the trick: one `index_add_` of rows.

Dropped slots. JAX writes with `mode="drop"`: a slot whose id is out of
range (the padding protocol's id == dims, and the plans' pad slots past
it) is skipped. torch has no drop mode, and an out-of-range index on CUDA
is a device-side assert. A plan's `rep` is strictly ascending, so its live
slots are a PREFIX: `live` = the count of ids below dims. Every op takes
that count as a host int and indexes `rep[:live]`: no mask, no sync. Given
none, an op reckons it from `rep` itself — a device-to-host copy, so the
batch backend's chunk loop always passes the count it reckoned at upload.

The ops write the table IN PLACE and return it (the engine's contract:
the table passed in is consumed).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


def _live_rep(plan, dims: int, live: Optional[int]) -> torch.Tensor:
    """The live prefix of the plan's ascending slot ids (those < dims), as
    int64; `live` is its length when the caller knows it."""
    if live is None:
        live = int((plan.rep < dims).sum())
    return plan.rep[:live].long()


# --------------------------------------------------------------------------
# The jit-built plan: the sort runs on the device, one slot per lane.
# --------------------------------------------------------------------------


class DedupPlan(NamedTuple):
    """Reusable sort/segment structure for one block of scatter indices."""

    order: torch.Tensor  # [N] int64 — permutation sorting the flat indices
    seg: torch.Tensor  # [N] int64 — segment id of each sorted element
    rep: torch.Tensor  # [N] — ascending slot -> feature index; empty slots
    # get distinct out-of-range values (dims + slot)


def make_dedup_plan(idx_flat: torch.Tensor, dims: int) -> DedupPlan:
    """`idx_flat` [N] integer ids; out-of-range ids (the padding protocol's
    idx == dims) sort to the tail and land in dropped slots."""
    n = idx_flat.shape[0]
    order = torch.argsort(idx_flat, stable=True)
    si = idx_flat[order]
    head = torch.ones(n, dtype=torch.bool, device=si.device)
    head[1:] = si[1:] != si[:-1]
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    # every lane of a segment carries the same id, so which write lands
    # does not matter; slots past the last segment keep dims + slot
    rep = dims + torch.arange(n, dtype=si.dtype, device=si.device)
    rep.scatter_(0, seg, si)
    return DedupPlan(order=order, seg=seg, rep=rep)


def segment_totals(plan: DedupPlan, upd_flat: torch.Tensor) -> torch.Tensor:
    """Per-slot sums of `upd_flat` ([N] or [N, k]) under the plan."""
    src = upd_flat[plan.order]
    return torch.zeros_like(src).index_add_(0, plan.seg, src)


def dedup_scatter_add(table: torch.Tensor, plan: DedupPlan,
                      upd_flat: torch.Tensor,
                      denom: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """`table[idx] += upd` with duplicates pre-reduced; `denom` [N]
    (per-slot counts) divides the sums first — the mini-batch averaged
    application."""
    sums = segment_totals(plan, upd_flat)
    if denom is not None:
        d = torch.clamp(denom, min=1.0)
        sums = sums / (d[:, None] if sums.dim() == 2 else d)
    r = _live_rep(plan, table.shape[0], None)
    return table.index_add_(0, r, sums[:r.shape[0]].to(table.dtype))


def dedup_counts(plan: DedupPlan, fired_flat: torch.Tensor) -> torch.Tensor:
    """Per-slot update counts (float) — the FloatAccumulator denominator."""
    return segment_totals(plan, fired_flat)


def dedup_touch_max(table: torch.Tensor, plan: DedupPlan,
                    fired_flat: torch.Tensor) -> torch.Tensor:
    """`touched[idx] = max(touched[idx], fired)` via the plan (int8)."""
    return staged_touch_max(table, plan, segment_totals(plan, fired_flat))


def dedup_scatter_set_uniform(table: torch.Tensor, plan: DedupPlan,
                              val_flat: torch.Tensor,
                              keep_flat: torch.Tensor) -> torch.Tensor:
    """`table[idx] = val` where duplicate lanes of a feature carry the SAME
    value (the engine's derive_w contract). `keep_flat` [N] bool keeps the
    old table value where no lane fired."""
    vs = val_flat[plan.order]
    ks = keep_flat[plan.order] > 0
    # all kept lanes of a slot agree, so their max is the value; lanes not
    # kept are pushed to -inf (the identity of max: empty slots read it)
    picked = torch.full_like(vs, float("-inf")).scatter_reduce_(
        0, plan.seg, torch.where(ks, vs, float("-inf")), "amax")
    fired = segment_totals(plan, keep_flat.to(vs.dtype)) > 0
    return staged_scatter_set(table, plan, picked, fired)


# --------------------------------------------------------------------------
# Staged plans: the sort moved to staging time (host numpy), the slot axis
# compacted to the U unique ids. Planners are copies of the JAX package's;
# their plans are equal to its plans array for array (int32, the stable
# argsort, pad slots at pad_base + arange with starts == ends == N).
# --------------------------------------------------------------------------


class StagedDedupPlan(NamedTuple):
    """Host-built sort/segment structure for one chunk of B rows.

    All arrays are int32 numpy at build time; they become device tensors
    when staged. `N = B*K` flat lanes, `U` = bucketed unique-slot count.
    """

    order: np.ndarray  # [N] int32 — permutation sorting the flat ids
    lane_seg: np.ndarray  # [N] int32 — slot id of each ORIGINAL lane
    rep: np.ndarray  # [U] int32 — ascending unique feature ids; pad slots
    # get distinct out-of-range ids
    starts: np.ndarray  # [U] int32 — inclusive start in sorted order
    ends: np.ndarray  # [U] int32 — exclusive end (== start on pads)


def plan_slot_bucket(n_unique: int, min_slots: int = 256) -> int:
    """Round a unique-slot count up to 8 buckets per octave (<= 12.5%
    slot waste, a bounded number of distinct shapes)."""
    n = max(int(n_unique), 1)
    if n <= min_slots:
        return min_slots
    step = max(1 << (max(n.bit_length() - 1, 3) - 3), min_slots // 8)
    return -(-n // step) * step


def build_staged_plan(idx_flat, dims: int, slots: Optional[int] = None
                      ) -> StagedDedupPlan:
    """Numpy plan builder (staging time, host side).

    `idx_flat` [N] — a chunk's flat feature ids; the padding protocol's
    out-of-range ids (== dims) sort to the tail and become dropped slots.
    `slots` pins the U bucket (callers stacking several chunks pass the
    max bucket over the chunks).
    """
    flat = np.asarray(idx_flat, dtype=np.int64).reshape(-1)
    n = flat.shape[0]
    order = np.argsort(flat, kind="stable")
    si = flat[order]
    head = np.empty(n, np.bool_)
    head[0] = True
    np.not_equal(si[1:], si[:-1], out=head[1:])
    lane_seg = np.empty(n, np.int32)
    lane_seg[order] = (np.cumsum(head) - 1).astype(np.int32)
    # every segment gets a slot, INCLUDING the pad-id segment (ids >= dims):
    # its rep is out of range so the table ops drop it, but its lanes still
    # broadcast a well-defined fill value and its counts never leak into a
    # live feature's denominator
    uniq = si[head]
    n_seg = uniq.shape[0]
    ends_all = np.append(np.flatnonzero(head[1:]) + 1, n).astype(np.int32)
    u = slots if slots is not None else plan_slot_bucket(n_seg)
    if n_seg > u:
        raise ValueError(f"plan bucket {u} < {n_seg} unique ids")
    # unused tail slots take distinct ascending out-of-range ids past any
    # real segment's, so `rep` stays strictly ascending
    pad_base = max(int(uniq[-1]) + 1 if n_seg else dims, dims)
    rep = np.concatenate([
        uniq.astype(np.int64),
        pad_base + np.arange(u - n_seg, dtype=np.int64)])
    starts = np.zeros(u, np.int32)
    ends = np.zeros(u, np.int32)
    starts[1:n_seg] = ends_all[: n_seg - 1]
    ends[:n_seg] = ends_all
    starts[n_seg:] = n
    ends[n_seg:] = n
    return StagedDedupPlan(order=order.astype(np.int32), lane_seg=lane_seg,
                           rep=rep.astype(np.int32), starts=starts,
                           ends=ends)


# Plan ABI (frozen, v1) — the layout the JAX package's native batch apply
# (native/hivemall_native.cpp::hm_batch_apply_block) reads, and the one a
# fused sorted-segment kernel of the port is to consume:
#
#   field     dtype  shape            meaning
#   order     int32  [N] / [nb, N]    permutation sorting the flat lane ids
#   lane_seg  int32  [N] / [nb, N]    slot id of each ORIGINAL lane
#   rep       int32  [U] / [nb, U]    ascending unique feature ids; pads
#                                     carry distinct ids >= dims (dropped)
#   starts    int32  [U] / [nb, U]    inclusive start in sorted lane order
#   ends      int32  [U] / [nb, U]    exclusive end (== start on pads)
#
# All arrays C-contiguous host numpy; N = chunk_rows * width. The stacked
# form is BlockPlans.main: chunk c lives at flat offset c*N / c*U.

PLAN_ABI_VERSION = 1


def plan_abi_arrays(plan: StagedDedupPlan, stacked: bool = False):
    """Validate `plan` against the frozen ABI above and return its arrays as
    host numpy in field order. Raises TypeError/ValueError on any dtype,
    contiguity or rank violation — a plan that came back from the device or
    was built with the wrong dtype must fail here, before native code reads
    its buffers."""
    ndim = 2 if stacked else 1
    out = []
    for f in StagedDedupPlan._fields:
        a = getattr(plan, f)
        if not isinstance(a, np.ndarray):
            raise TypeError(
                f"plan.{f} is {type(a).__name__}, not host numpy — the "
                "native ABI takes staging-time plans (device plans have "
                "no stable host buffer)")
        if a.dtype != np.int32:
            raise TypeError(f"plan.{f} dtype {a.dtype} != int32 (ABI v"
                            f"{PLAN_ABI_VERSION})")
        if a.ndim != ndim:
            raise ValueError(f"plan.{f} rank {a.ndim} != {ndim} "
                             f"({'stacked' if stacked else 'single-chunk'} "
                             "form)")
        if not a.flags["C_CONTIGUOUS"]:
            raise ValueError(f"plan.{f} is not C-contiguous (ABI v"
                             f"{PLAN_ABI_VERSION})")
        out.append(a)
    return tuple(out)


def pad_plan(plan: StagedDedupPlan, slots: int, dims: int
             ) -> StagedDedupPlan:
    """Widen a host-built plan to a larger U bucket (chunks stacked together
    share one shape). Extra slots are empty drops: distinct ascending
    out-of-range reps, start == end == N."""
    u0 = plan.rep.shape[0]
    if slots == u0:
        return plan
    if slots < u0:
        raise ValueError(f"cannot shrink plan bucket {u0} -> {slots}")
    n = plan.order.shape[0]
    extra = slots - u0
    pad_base = max(int(plan.rep[-1]) + 1, dims)
    rep = np.concatenate([
        np.asarray(plan.rep, np.int64),
        pad_base + np.arange(extra, dtype=np.int64)]).astype(np.int32)
    fill = np.full(extra, n, np.int32)
    return StagedDedupPlan(
        order=plan.order, lane_seg=plan.lane_seg, rep=rep,
        starts=np.concatenate([plan.starts, fill]),
        ends=np.concatenate([plan.ends, fill]))


def staged_plan_to_device(plan: StagedDedupPlan, device) -> StagedDedupPlan:
    """The plan's arrays as int64 tensors on `device`: each int32 array is
    copied as it is and widened there (half the bytes over the bus)."""
    return StagedDedupPlan(*(torch.from_numpy(np.ascontiguousarray(a))
                             .to(device).long() for a in plan))


def staged_gather(table: torch.Tensor, plan: StagedDedupPlan,
                  fill: float = 0.0, live: Optional[int] = None
                  ) -> torch.Tensor:
    """[U] — each unique feature's row read ONCE (ascending ids, so the
    table walk is sequential); dropped slots read `fill`."""
    got = table[_live_rep(plan, table.shape[0], live)]
    return torch.cat([got, got.new_full((plan.rep.shape[0] - got.shape[0],),
                                        fill)])


def broadcast_lanes(uniq_vals: torch.Tensor,
                    plan: StagedDedupPlan) -> torch.Tensor:
    """[N] — unique-slot values fanned back out to the original lanes."""
    return uniq_vals[plan.lane_seg]


def staged_segment_totals(plan: StagedDedupPlan,
                          cols: torch.Tensor) -> torch.Tensor:
    """Per-slot sums of `cols` ([N] or [N, k], lane-ordered) — one permute,
    one chunk-local prefix sum and two boundary gathers; no scatter.

    The prefix runs in float64 and the totals come back in `cols`' dtype.
    In f32, the JAX package's choice (the TPU has no f64), a prefix over a
    65,536-lane chunk of same-signed columns (AROW's covariance deltas,
    AdaGrad's squared gradients at 1e4 a lane) reaches 1e3-1e9, where one
    ulp is as large as a slot's own sum; the difference of two such
    prefixes then depends on the scan's order. In f64 every total is
    exact to its f32 rounding on any device, and the 0/1 count column is
    exact as it is in f32.

    The prefix runs along the last axis of a [k, N] view: a column-major
    `cols` (a transposed [k, N] stack, as the batch backend passes) costs
    no copy to get there.
    """
    n = cols.shape[0]
    rows = cols.reshape(n, -1).t().double()[:, plan.order]  # [k, N]
    csum = torch.nn.functional.pad(torch.cumsum(rows, dim=1), (1, 0))
    out = (csum[:, plan.ends] - csum[:, plan.starts]).to(cols.dtype)
    return out.t().reshape((plan.ends.shape[0],) + tuple(cols.shape[1:]))


def staged_scatter_add(table: torch.Tensor, plan: StagedDedupPlan,
                       sums: torch.Tensor,
                       denom: Optional[torch.Tensor] = None,
                       live: Optional[int] = None) -> torch.Tensor:
    """Apply per-slot sums [U] (pre-reduced, optionally count-averaged):
    `table[rep] += sums`, one lane per unique live slot. The sums are cast
    to the table's dtype BEFORE the add, as in the JAX batch backend (its
    minibatch engine adds in f32 and casts after; on bf16 tables the two
    differ in the last bit)."""
    if denom is not None:
        sums = sums / torch.clamp(denom, min=1.0)
    r = _live_rep(plan, table.shape[0], live)
    return table.index_add_(0, r, sums[:r.shape[0]].to(table.dtype))


def staged_scatter_set(table: torch.Tensor, plan: StagedDedupPlan,
                       vals: torch.Tensor, keep: torch.Tensor,
                       live: Optional[int] = None) -> torch.Tensor:
    """`table[rep] = vals` where `keep` [U] (bool), else the slot keeps its
    value — the derive_w write, one lane per unique slot. The live slots'
    ids are distinct, so no two writes race."""
    r = _live_rep(plan, table.shape[0], live)
    n = r.shape[0]
    out = torch.where(keep[:n], vals[:n].to(table.dtype), table[r])
    return table.index_copy_(0, r, out)


def staged_touch_max(table: torch.Tensor, plan: StagedDedupPlan,
                     counts: torch.Tensor,
                     live: Optional[int] = None) -> torch.Tensor:
    """`touched[rep] = max(touched[rep], counts > 0)` — int8, U lanes."""
    r = _live_rep(plan, table.shape[0], live)
    hit = (counts[:r.shape[0]] > 0).to(table.dtype)
    return table.index_copy_(0, r, torch.maximum(table[r], hit))


def scatter_rows_flat(table: torch.Tensor, keys: torch.Tensor,
                      upd: torch.Tensor) -> torch.Tensor:
    """Add ``upd[..., :kl]`` into the first ``kl`` lanes of the rows
    ``keys`` of an ``[E, k]`` table, IN PLACE, and return the table.

    ``keys`` is ``[...]`` and ``upd`` is ``[..., kl]`` with ``kl <= k``;
    repeated keys accumulate. Keys outside ``[0, E)`` are dropped (the JAX
    ``mode="drop"``): their rows are redirected to row 0 and their values
    to -0.0, which leaves every float unchanged (x + -0.0 == x, signed
    zeros included), so a dead lane costs no device sync and writes
    nothing. The lanes past ``kl`` receive -0.0 the same way.
    """
    e, k = table.shape
    kl = upd.shape[-1]
    live = (keys >= 0) & (keys < e)
    sidx = torch.where(live, keys, torch.zeros_like(keys)).reshape(-1)
    neg0 = torch.full((), -0.0, dtype=table.dtype, device=table.device)
    rows = torch.where(live[..., None], upd.to(table.dtype), neg0) \
        .reshape(-1, kl)
    if kl != k:
        rows = torch.cat([rows, neg0.expand(rows.shape[0], k - kl)], dim=1)
    return table.index_add_(0, sidx, rows)
