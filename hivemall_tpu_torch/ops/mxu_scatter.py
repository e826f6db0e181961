"""Sorted-id gather / scatter-add over a block's model-table traffic — the
port of `hivemall_tpu/ops/mxu_scatter.py` (the `-mxu_scatter` backend).

The JAX module sorts a block's flat feature ids once and re-expresses
XLA's scalar gather / scatter as one-hot matmuls over windows of a
``[R, 128]`` view of the table: the TPU's matrix unit standing in for its
slow scalar gather engine. A GPU has a fast gather, and those matmuls
would cost N * W * 128 multiply-adds for what is an index copy, so the
port keeps the module's observable contract and its sorted structure, not
its matmuls:

- `make_plan` sorts the ids once, stably (`torch.sort(stable=True)`):
  ``sid`` / ``spos`` are the JAX plan's arrays, value for value. Invalid
  ids (negative or >= E) become the sentinel E and sort to the tail; the
  sorted ids pad to a multiple of ``chunk`` with E, and the positions pad
  with distinct values >= n.
- `gather` reads the table in sorted id order (each id's rows adjacent)
  and un-sorts by position: exactly ``table[ids]``, 0.0 for invalid ids.
- `scatter_add` lines the updates up in the plan's order, sums each run
  of equal ids in float64 (`segment_reduce`s over the runs, each run
  added on its own in slot order), then writes ONCE per unique id:
  ``table[id] + run sum``, rounded to float32 once. Invalid ids are
  dropped. No float atomics and no prefix sum, so two runs on the card
  are bit-equal, a run of zeros adds exactly 0, and the card adds in the
  CPU's order. Every shape is fixed by the block, so a step built on
  these ops has no host sync and captures as one CUDA graph.

Invalid ids deviate from wraparound indexing ON PURPOSE, as in the JAX
module: the engine's padding protocol only produces ids in [0, dims], so
wrapping a negative id would turn a caller bug into silent corruption of
entry E-1. ``window_rows`` and ``precision`` are accepted and validated
for the JAX signature; no path here depends on them (gather and the
float64 sums are exact for any setting). This module uses no matmul, so
TF32 cannot touch it. Its hand-written kernel is a later change.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

LANES = 128
PRECISION = "highest"
_PRECISIONS = ("high", "highest")


def _resolve_precision(precision) -> str:
    """The JAX names of the matmul precision: None (the default,
    "highest"), "high" or "highest"."""
    if precision is None:
        return PRECISION
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be None, 'high' or 'highest': "
                         f"{precision!r}")
    return precision


class WindowPlan(NamedTuple):
    """One block's sorted-id structure, shared by gathers and scatters.

    Invalid ids — negative OR >= n_entries — are mapped to the sentinel
    `n_entries` (gather fills 0.0, scatter drops)."""

    sid: torch.Tensor       # [Np] int32 sorted ids; invalid ids -> E (tail)
    spos: torch.Tensor      # [Np] int32 original position of each sorted slot
    n: int                  # original (unpadded) id count
    n_entries: int          # E: table entry count the plan was built for
    chunk: int              # C: sorted ids per window


def _pad_to(x: torch.Tensor, m: int, fill) -> torch.Tensor:
    n = x.shape[0]
    if n % m == 0:
        return x
    return torch.cat([x, x.new_full((m - n % m,) + tuple(x.shape[1:]),
                                    fill)])


def _masked_ids(ids_flat, n_entries: int) -> torch.Tensor:
    ids = torch.as_tensor(ids_flat).reshape(-1).long()
    return torch.where((ids >= 0) & (ids < n_entries), ids,
                       torch.full_like(ids, n_entries))


def make_plan(ids_flat, n_entries: int, *, chunk: int = 1024) -> WindowPlan:
    """Sort the block's flat ids once. `ids_flat` [N] (any int tensor on
    the device the tables live on); anything outside [0, n_entries) is
    mapped to the sentinel `n_entries` (sorts to the tail, gathers 0,
    scatters dropped)."""
    ids = _masked_ids(ids_flat, n_entries)
    n = ids.shape[0]
    sid, spos = torch.sort(ids, stable=True)
    sid = _pad_to(sid.to(torch.int32), chunk, n_entries)
    spos = spos.to(torch.int32)
    if spos.shape[0] != sid.shape[0]:
        # pad positions with DISTINCT values >= n, so an un-sort by
        # position sends pad slots past the real ones
        spos = torch.cat([spos, torch.arange(
            n, sid.shape[0], dtype=torch.int32, device=spos.device)])
    return WindowPlan(sid=sid, spos=spos, n=n, n_entries=n_entries,
                      chunk=chunk)


def pad_cols(n: int) -> int:
    """Smallest power-of-two column count >= n — THE lane-protocol helper:
    tables fed to gather/scatter_add must have power-of-two columns
    (_table_geometry)."""
    c = 1
    while c < n:
        c *= 2
    return c


def _table_geometry(n_entries: int, cols: int, window_rows: int):
    """(entries per 128-lane row, rows) of the JAX module's table view; its
    ValueError is the lane protocol's refusal."""
    if cols & (cols - 1) or cols > LANES:
        raise ValueError(f"cols must be a power of two <= {LANES}: {cols}")
    ipr = LANES // cols
    rows = max((n_entries + ipr - 1) // ipr, window_rows)
    return ipr, rows


def _check(table: torch.Tensor, plan: WindowPlan,
           window_rows: Optional[int], precision):
    """The JAX module's argument checks: the plan's E, the power-of-two
    columns, the window and the precision."""
    t2 = table[:, None] if table.dim() == 1 else table
    e, c = t2.shape
    if e != plan.n_entries:
        raise ValueError(f"plan built for E={plan.n_entries}, table has {e}")
    if window_rows is not None and (isinstance(window_rows, bool)
                                    or not isinstance(window_rows, int)
                                    or window_rows < 0):
        raise ValueError(f"window_rows must be None or a non-negative int: "
                         f"{window_rows!r}")
    _table_geometry(e, c, window_rows or 128)
    _resolve_precision(precision)
    return t2, e, c


def gather(table: torch.Tensor, plan: WindowPlan,
           window_rows: Optional[int] = None,
           precision=None) -> torch.Tensor:
    """``table[ids]`` with 0.0 for invalid ids, over the plan's ids,
    returned in ORIGINAL id order. `table` is [E] or [E, c] (c a power of
    two <= 128); the result is [N] or [N, c] float32, exact."""
    squeeze = table.dim() == 1
    t2, e, c = _check(table, plan, window_rows, precision)
    sid = plan.sid.long()
    valid = sid < e
    rows = t2[torch.where(valid, sid, torch.zeros_like(sid))].float()
    rows = torch.where(valid[:, None], rows,
                       torch.zeros((), device=rows.device))
    out = torch.empty_like(rows)
    out[plan.spos.long()] = rows  # un-sort: spos is a permutation
    out = out[: plan.n]
    return out[:, 0] if squeeze else out


RUN_CHUNK = 128  # slots of a run that one first-level partial sum adds


def _offsets(seg: torch.Tensor, first: torch.Tensor, tail) -> torch.Tensor:
    """The [len(seg) + 1] offsets of segments numbered `seg` (ascending)
    whose first element is `first`; the segments past the last are empty
    at `tail` (an int, or a 0-d tensor on seg's device). Every element of
    a segment writes the same offset, so the scatter is deterministic; no
    host sync and no host-to-device copy, so a CUDA graph captures it."""
    m = seg.shape[0] + 1
    out = tail.expand(m).clone() if torch.is_tensor(tail) else \
        torch.full((m,), tail, dtype=seg.dtype, device=seg.device)
    return out.scatter_(0, seg, first)


def _run_sums(sid: torch.Tensor, su: torch.Tensor) -> torch.Tensor:
    """Each sorted slot's run total [N, kl]: the sum of `su` over the run
    of equal ids it belongs to, in float64, in two `segment_reduce`s (on
    CUDA a thread a segment and column, adding in slot order from 0.0, as
    on the CPU): partial sums of at most RUN_CHUNK slots of a run, then
    each run's partials. A run is summed on its own, so a run of zeros
    sums to 0 exactly, two card runs are bit-equal and the card adds as
    the CPU does; the two levels keep a head id's run (~20,000 slots at
    the bench shape) off one thread's serial loop. The difference of a
    prefix sum at a run's ends would be none of these: a parallel scan
    associates the two ends' sums differently (on the card a run of zeros
    came to +-1.5e-11, counting as updated a feature no lane updated).
    Fixed shapes, no host sync."""
    n, kl = su.shape
    if n == 0:
        return su.double()  # graftcheck: disable=G003 (float64 run sums: two card runs are bit-equal)
    i = torch.arange(n, device=sid.device)
    first = torch.searchsorted(sid, sid, side="left")
    lag = (i - first) % RUN_CHUNK
    seg = torch.cumsum(lag == 0, 0) - 1  # each slot's partial
    part = torch.segment_reduce(
        su.double(), "sum", offsets=_offsets(seg, i - lag, n), axis=0,  # graftcheck: disable=G003 (float64 run sums: two card runs are bit-equal)
        unsafe=True, initial=0.0)
    run = torch.cumsum(i == first, 0) - 1
    tot = torch.segment_reduce(
        part, "sum", offsets=_offsets(run, seg[first], seg[-1] + 1), axis=0,
        unsafe=True, initial=0.0)
    return tot[run]


def scatter_add(table: torch.Tensor, ids_flat, upd: torch.Tensor,
                plan: WindowPlan, window_rows: Optional[int] = None,
                precision=None) -> torch.Tensor:
    """``table.at[ids].add(upd, mode="drop")``: returns the updated table
    in its original shape and dtype (the input is not modified). `table`
    [E] or [E, c]; `upd` [N] or [N, kl] with kl <= c in ORIGINAL id order
    (missing columns scatter nothing — the padded-lane protocol of
    scatter_rows_flat). `ids_flat` must be the ids the plan was built
    from: the updates are put in the plan's sorted order, each run of
    equal ids summed in float64 and added once, rounded to float32 once
    (module docstring). Sum order within a duplicated id differs from
    XLA's scatter (both are unspecified); values match to f32 tolerance."""
    squeeze = table.dim() == 1
    t2, e, c = _check(table, plan, window_rows, precision)
    u2 = upd[:, None] if upd.dim() == 1 else upd
    kl = u2.shape[-1]
    if kl > c:
        raise ValueError(f"{kl} update columns for a table of {c}")
    n = torch.as_tensor(ids_flat).numel()
    if n != plan.n or u2.shape[0] != plan.n:
        raise ValueError(f"plan built for {plan.n} ids; got {n} ids and "
                         f"{u2.shape[0]} update rows")
    sid = plan.sid[: plan.n].long()
    su = u2[plan.spos[: plan.n].long()]            # [N, kl] sorted order
    tot = _run_sums(sid, su)                       # [N, kl] float64
    valid = sid < e
    # every slot of a run writes its id's same new value (so the repeated
    # writes agree and the write is deterministic); invalid slots write a
    # scratch entry E that is dropped
    out = torch.cat([t2.float(), t2.new_zeros((1, c), dtype=torch.float32)])
    target = torch.where(valid, sid, torch.full_like(sid, e))
    new = (out[target, :kl].double() + tot).float()  # graftcheck: disable=G003 (float64 run sums: two card runs are bit-equal)
    out[target[:, None], torch.arange(kl, device=out.device)] = new
    out = out[:e].to(table.dtype)
    return out[:, 0] if squeeze else out
