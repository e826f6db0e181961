"""The count functions against hand counts on a tiny block with repeated
ids and pad lanes."""

import numpy as np

from portbench import counts

DIMS = 100
# 3 rows x 4 lanes; pad lanes carry DIMS. Live lanes: 4 + 2 + 3 = 9;
# distinct live ids: {1, 2, 3, 7, 9} = 5 (1 repeats in row 0 and row 2,
# 7 twice in row 1)
BLOCK = np.array([[1, 2, 1, 3],
                  [7, 7, DIMS, DIMS],
                  [9, 1, 2, DIMS]], np.int64)


def test_scan_block_by_hand():
    work = counts.scan_block(BLOCK, DIMS, "arow")
    lanes, rows, distinct = 9, 3, 5
    want_bytes = (lanes * (4 + 4) + rows * 4      # ids, values, labels
                  + distinct * 2 * 4 * 2          # w, cov read and written
                  + distinct * 1 + rows * 4)      # touched, losses
    assert work.bytes == want_bytes == 181
    assert work.flops == 11 * lanes + 8 * rows == 123


def test_plan_block_by_hand():
    # ids read once, three int32 arrays of the block's shape written once,
    # pad lanes included
    assert counts.plan_block(BLOCK).bytes == 12 * 4 + 3 * 12 * 4 == 192
    assert counts.plan_block(BLOCK).flops == 0


def test_per_block_sums_consecutive_blocks():
    total = counts.per_block(BLOCK, 2, counts.scan_block, DIMS, "arow")
    first = counts.scan_block(BLOCK[:2], DIMS, "arow")
    last = counts.scan_block(BLOCK[2:], DIMS, "arow")
    assert total == first + last
    # an id counted in both blocks is read and written once in each
    assert total.bytes > counts.scan_block(BLOCK, DIMS, "arow").bytes
    assert first * 2 == first + first


def test_staged_width():
    assert [counts.staged_width(k) for k in (1, 8, 9, 33, 64)] == \
        [8, 8, 16, 64, 64]
