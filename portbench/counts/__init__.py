"""The work the inputs need: bytes and FLOPs of one block, computed from the
block's ids alone, so that a kernel that fuses or replaces today's reads the
same work.

A block is ``ids`` [B, K] with pad lanes at ``dims`` (out of range). A lane
is live when 0 <= id < dims. Every input byte is counted read once and every
output byte written once, whatever a kernel reads again:

- `scan_block`: one exact-scan block of a covariance learner: the live
  lanes' ids and values (4 + 4 bytes), each row's label (4); each distinct
  live id's w and cov read and written once (2 x 2 x 4); each distinct live
  id's touched flag (1) and each row's loss (4) written once.
- `plan_block`: the scan's plan: the block's ids read once (4 a lane, pad
  lanes included: the plan reads the whole block to find them) and three
  int32 plan arrays of the block's shape written once.

FLOPs count a live lane's score and variance terms (2 + 3) and its two
table updates (3 + 3), and each row's closed form (`ROW_FLOPS`, by rule);
at these sizes the bytes bind by far.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LANE_FLOPS = 11
# operations of a row's closed form from its score and variance
ROW_FLOPS = {"arow": 8, "scw1": 40}
TABLE_BYTES = 4  # float32 w and cov
TABLES = 2


@dataclass(frozen=True)
class Work:
    bytes: int
    flops: int

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops)

    def __mul__(self, n: int) -> "Work":
        return Work(self.bytes * n, self.flops * n)


ZERO = Work(0, 0)


def _lanes(ids: np.ndarray, dims: int):
    live = (ids >= 0) & (ids < dims)
    return int(live.sum()), int(np.unique(ids[live]).size)


def scan_block(ids: np.ndarray, dims: int, rule: str) -> Work:
    rows = ids.shape[0]
    lanes, distinct = _lanes(ids, dims)
    nbytes = (8 * lanes + 4 * rows
              + distinct * TABLES * TABLE_BYTES * 2
              + distinct + 4 * rows)
    return Work(nbytes, LANE_FLOPS * lanes + ROW_FLOPS[rule] * rows)


def staged_width(max_len: int) -> int:
    """The lanes a row takes in a staged block: the longest row's length
    rounded up to a power of two, at least 8 (the block shape the port's
    kernels are handed)."""
    width = 8
    while width < max_len:
        width <<= 1
    return width


def plan_block(ids: np.ndarray) -> Work:
    """`ids` at the staged width (`staged_width`)."""
    return Work(4 * ids.size + 3 * 4 * ids.size, 0)


def per_block(padded_ids: np.ndarray, block_rows: int, count, *args) -> Work:
    """`count(block, *args)` summed over the consecutive blocks of
    `block_rows` rows (the last may be shorter)."""
    total = ZERO
    for start in range(0, padded_ids.shape[0], block_rows):
        total = total + count(padded_ids[start:start + block_rows], *args)
    return total
