"""Row scatter-add for tables whose rows carry lanes (FM's [D, k] V table).

The port of `hivemall_tpu/ops/scatter.py::scatter_rows_flat`. The JAX
function scatters through the flat [E*k] scalar view because that form ran
2x faster on the TPU, and falls back to the row form where E*k overflows
an int32 index. Neither concern exists here (torch indexes in int64), so
the port keeps the semantics and drops the trick: one `index_add_` of
rows. The staged-plan ops of that module (`staged_*`) belong to the
batched backend, a later slice of the port.
"""

from __future__ import annotations

import torch


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
