"""Feature blocks: the batch format for all hashed-feature learners.

The reference processes one Hive row at a time (`process(Object[])`,
BinaryOnlineClassifierUDTF.java:111). Rows are staged as fixed-shape padded
blocks, packed on the host in numpy and moved to the device per block:

    indices [B, K] int32  — hashed feature ids, padded with `dims` (out of range)
    values  [B, K] f32    — feature values, padded with 0
    labels  [B]    f32    — ±1 for classifiers, y for regressors

A pad lane carries an OUT-OF-RANGE index (== dims). torch has no fill/drop
indexing modes, so the port's gathers and scatters mask lanes by
``0 <= idx < dims`` (core/engine.py, kernels/linear_scan.py). K is bucketed
to powers of two, as in the JAX package, so both see the same shapes.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch


class FeatureBlock(NamedTuple):
    indices: np.ndarray  # [B, K] int32
    values: np.ndarray  # [B, K] float32
    labels: np.ndarray  # [B] float32
    nnz: np.ndarray  # [B] int32 — true row lengths

    @property
    def batch_size(self) -> int:
        return self.indices.shape[0]

    @property
    def width(self) -> int:
        return self.indices.shape[1]


def pad_to_bucket(k: int, min_width: int = 8) -> int:
    """Round row width up to a power of two >= min_width."""
    w = min_width
    while w < k:
        w <<= 1
    return w


def bucket_rows(x, min_rows: int = 8):
    """Pad an array's leading (row) axis up to the bucket ladder
    (``pad_to_bucket``), so a variable-length batch reaches a per-shape
    path (a captured CUDA graph, a warmed bucket) in one of few shapes.
    Pad rows are zeros; callers slice the result back to the true row
    count. Takes a numpy array (the JAX package's contract) or a tensor,
    and returns the same kind."""
    n = x.shape[0]
    b = pad_to_bucket(max(n, 1), min_width=min_rows)
    if b == n:
        return x
    pad_shape = (b - n,) + tuple(x.shape[1:])
    if torch.is_tensor(x):
        return torch.cat([x, x.new_zeros(pad_shape)])
    return np.concatenate([np.asarray(x), np.zeros(pad_shape, x.dtype)])


def pack_rows(
    idx_rows: Sequence[np.ndarray],
    val_rows: Sequence[np.ndarray],
    labels: Sequence[float],
    dims: int,
    width: Optional[int] = None,
    batch_size: Optional[int] = None,
) -> FeatureBlock:
    """Pack variable-length hashed rows into one padded FeatureBlock.

    Rows longer than `width` are truncated (callers should pick width >= max
    nnz; `pad_to_bucket(max_nnz)` is the default). If `batch_size` is given,
    the block is padded with empty rows up to it (their labels are 0 and all
    lanes are pad lanes, so they are no-ops in every learner).
    """
    n = len(idx_rows)
    lens = np.fromiter((len(r) for r in idx_rows), dtype=np.int64, count=n)
    if width is None:
        width = pad_to_bucket(int(lens.max()) if n else 1)
    b = batch_size if batch_size is not None else n
    indices = np.full((b, width), dims, dtype=np.int32)
    values = np.zeros((b, width), dtype=np.float32)
    labs = np.zeros((b,), dtype=np.float32)
    nnz = np.minimum(lens, width).astype(np.int32)
    if n:
        labs[:n] = np.asarray(labels, dtype=np.float32)[:n]
        if lens.max() <= width:
            # every row fits: one scatter of the concatenated rows into the
            # live lanes (row-major order matches the concatenation)
            live = np.arange(width)[None, :] < lens[:, None]
            indices[:n][live] = np.concatenate(idx_rows).astype(np.int32)
            values[:n][live] = np.concatenate(val_rows).astype(np.float32)
        else:
            for i in range(n):
                k = nnz[i]
                indices[i, :k] = idx_rows[i][:k]
                values[i, :k] = val_rows[i][:k]
    out_nnz = np.zeros((b,), dtype=np.int32)
    out_nnz[:n] = nnz
    return FeatureBlock(indices, values, labs, out_nnz)


def iter_blocks(
    idx_rows: Sequence[np.ndarray],
    val_rows: Sequence[np.ndarray],
    labels: Sequence[float],
    dims: int,
    batch_size: int,
    width: Optional[int] = None,
):
    """Yield fixed-shape FeatureBlocks over a dataset.

    The final partial block is emitted at its true size rather than padded
    with fake rows — fake rows would corrupt global scalars (running target
    stats) and the example counter `t`.
    """
    n = len(idx_rows)
    if width is None:
        max_nnz = max((len(r) for r in idx_rows), default=1)
        width = pad_to_bucket(max_nnz)
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        yield pack_rows(idx_rows[start:end], val_rows[start:end],
                        labels[start:end], dims, width=width,
                        batch_size=end - start)


def pad_rows_to_multiple(indices: torch.Tensor, values: torch.Tensor,
                         labels: torch.Tensor, multiple: int, dims: int):
    """Pad a staged block's rows up to a multiple of `multiple` with
    sentinel rows (every lane the pad index ``dims``, value 0, label 0).
    Sentinel rows are dead weight only: code that carries global scalars or
    the example counter must mask them by the true row count."""
    b, k = indices.shape
    b_pad = (b + multiple - 1) // multiple * multiple
    if b_pad == b:
        return indices, values, labels
    pad = b_pad - b
    return (
        torch.cat([indices, indices.new_full((pad, k), dims)]),
        torch.cat([values, values.new_zeros((pad, k))]),
        torch.cat([labels, labels.new_zeros((pad,))]),
    )


def shuffle_rows(
    idx_rows: List[np.ndarray],
    val_rows: List[np.ndarray],
    labels: np.ndarray,
    seed: int,
):
    """Host-side shuffle between epochs (the reference's rand_amplify /
    epoch-replay analog, ref: ftvec/amplify/RandomAmplifierUDTF.java:43-66).
    Same RandomState permutation as the JAX package, so both see one order."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(idx_rows))
    return (
        [idx_rows[i] for i in perm],
        [val_rows[i] for i in perm],
        np.asarray(labels)[perm],
    )
