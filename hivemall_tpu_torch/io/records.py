"""Sharded binary record files — the input pipeline and epoch replay; the
port of `hivemall_tpu/io/records.py`.

The reference replays epochs by spilling every training row to a NIO
positioned temp file and re-reading it in close()
(ref: utils/io/NioStatefullSegment.java:29-68, fm/FactorizationMachineUDTF.java:291-332,
mf/OnlineMatrixFactorizationUDTF.java:92-203). Here rows are written once
to N binary shards; epochs iterate shards with shard-order and in-shard
shuffling and yield fixed-shape FeatureBlocks, optionally prefetched to
the device ahead of the consumer.

Record format (little-endian), per row:
    u8  nnz | varint delta-coded feature ids | f32[nnz] values | f32 label
Shard file: magic "HMTR1" + u64 row count + rows.

The format is the JAX package's byte for byte, so shards written by either
package read back in the other. Encoding and decoding run in the native
host library (`native.encode_records` / `decode_records`, which raise when
the library cannot be built); `encode_rows_python` / `decode_body_python`
are the plain versions, kept for the tests to hold the native codec
against. `RecordDataset` gives the JAX package's shard order, row
permutation and blocks for the same seed and epoch.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.batch import FeatureBlock, iter_blocks, pad_to_bucket
from ..device import DeviceLike, resolve_device
from ..utils.codec import leb128_decode, leb128_encode

MAGIC = b"HMTR1"
_HEADER = len(MAGIC) + 8  # magic + u64 row count


def encode_rows_python(idx_rows: Sequence[np.ndarray],
                       val_rows: Sequence[np.ndarray],
                       labels: Sequence[float]) -> bytes:
    """The plain HMTR1 encoder: each row sorted by id (stable: equal ids
    keep their input order, as the native encoder's stable_sort does)."""
    out = bytearray()
    for idx, val, lab in zip(idx_rows, val_rows, labels):
        idx = np.asarray(idx, np.int64)
        order = np.argsort(idx, kind="stable")
        idx = idx[order]
        val = np.asarray(val, np.float32)[order]
        if len(idx) > 255:
            raise ValueError("row nnz > 255 unsupported by record format")
        out.append(len(idx))
        prev = 0
        for i in idx:
            leb128_encode(int(i) - prev, out)
            prev = int(i)
        out.extend(val.tobytes())
        out.extend(struct.pack("<f", float(lab)))
    return bytes(out)


def decode_body_python(data: bytes, n: int, pos: int = 0
                       ) -> Tuple[List[np.ndarray], List[np.ndarray],
                                  np.ndarray]:
    """The plain HMTR1 decoder of `n` rows starting at `pos` (the JAX
    package's fallback decoder, statement for statement)."""
    idx_rows: List[np.ndarray] = []
    val_rows: List[np.ndarray] = []
    labels = np.empty(n, np.float32)
    for r in range(n):
        nnz = data[pos]
        pos += 1
        idx = np.empty(nnz, np.int64)
        prev = 0
        for k in range(nnz):
            d, pos = leb128_decode(data, pos)
            prev += d
            idx[k] = prev
        val = np.frombuffer(data, np.float32, count=nnz, offset=pos).copy()
        pos += 4 * nnz
        (labels[r],) = struct.unpack_from("<f", data, pos)
        pos += 4
        idx_rows.append(idx)
        val_rows.append(val)
    return idx_rows, val_rows, labels


def write_records(prefix: str, idx_rows: Sequence[np.ndarray],
                  val_rows: Sequence[np.ndarray], labels: Sequence[float],
                  num_shards: int = 1) -> List[str]:
    """Round-robin rows into `num_shards` files `prefix-{i:05d}.hmtr`
    (row r goes to shard r % num_shards), encoded by the native library."""
    from .. import native

    paths = [f"{prefix}-{i:05d}.hmtr" for i in range(num_shards)]
    labels = np.asarray(labels, np.float32)
    for s, p in enumerate(paths):
        rows = range(s, len(idx_rows), num_shards)
        body = native.encode_records([idx_rows[r] for r in rows],
                                     [val_rows[r] for r in rows],
                                     labels[s::num_shards])
        with open(p, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<Q", len(rows)))
            f.write(body)
    return paths


def read_shard(path: str) -> Tuple[List[np.ndarray], List[np.ndarray],
                                   np.ndarray]:
    """(idx_rows int64, val_rows f32, labels f32) of one shard, decoded by
    the native library."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(MAGIC)] != MAGIC:
        raise ValueError(f"{path}: bad magic")
    (n,) = struct.unpack_from("<Q", data, len(MAGIC))
    from .. import native

    offsets, indices, values, labels = native.decode_records(
        data[_HEADER:], n)
    bounds = offsets.tolist()
    idx_rows = [indices[a:b] for a, b in zip(bounds, bounds[1:])]
    val_rows = [values[a:b] for a, b in zip(bounds, bounds[1:])]
    return idx_rows, val_rows, labels


class RecordDataset:
    """Epoch iterator over record shards with shuffling + fixed-shape blocks.

    Epoch e draws from ``RandomState(seed + e)``: the shard order, then per
    shard a row permutation (with ``shuffle``), as the JAX package does, so
    both yield the same blocks in the same order. The width is resolved
    once, from the first shard read, unless given.

    With ``device_prefetch`` the blocks come as tensors on ``device``
    (None: the CUDA device, raising without one; ``"cpu"`` on the CPU).
    On CUDA each block's arrays are copied from pinned host memory,
    ``non_blocking``, on a side stream; the block is handed out only after
    the next block's copy has been queued, and an event makes the
    consumer's stream wait for its own copy — so block i+1's copy overlaps
    block i's step (the double-buffering the reference's synchronous disk
    replay lacked). Without it the blocks are the host numpy arrays."""

    def __init__(self, paths: Sequence[str], dims: int, batch_size: int,
                 width: Optional[int] = None, shuffle: bool = True,
                 seed: int = 31, device_prefetch: bool = True,
                 device: DeviceLike = None):
        self.paths = list(paths)
        self.dims = dims
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.device_prefetch = device_prefetch
        self.device = resolve_device(device)
        self._width = width
        self._epoch = 0

    def _resolve_width(self, idx_rows) -> int:
        if self._width is None:
            self._width = pad_to_bucket(max((len(r) for r in idx_rows),
                                            default=1))
        return self._width

    def _host_blocks(self, rng, order) -> Iterator[FeatureBlock]:
        for s in order:
            idx_rows, val_rows, labels = read_shard(self.paths[s])
            if self.shuffle:
                perm = rng.permutation(len(idx_rows))
                idx_rows = [idx_rows[i] for i in perm]
                val_rows = [val_rows[i] for i in perm]
                labels = labels[perm]
            width = self._resolve_width(idx_rows)
            yield from iter_blocks(idx_rows, val_rows, labels, self.dims,
                                   self.batch_size, width)

    def blocks(self) -> Iterator[FeatureBlock]:
        rng = np.random.RandomState(self.seed + self._epoch)
        self._epoch += 1
        order = rng.permutation(len(self.paths)) if self.shuffle else \
            np.arange(len(self.paths))
        host = self._host_blocks(rng, order)
        if not self.device_prefetch:
            yield from host
        elif self.device.type == "cuda":
            yield from _prefetch_cuda(host, self.device)
        else:
            for blk in host:
                yield FeatureBlock(*(torch.from_numpy(a) for a in blk))


def _prefetch_cuda(host: Iterator[FeatureBlock], dev: torch.device
                   ) -> Iterator[FeatureBlock]:
    """Copy each host block to `dev` on a side stream, one block ahead of
    the consumer (see RecordDataset)."""
    side = torch.cuda.Stream(dev)
    pending = None
    for blk in host:
        pinned = [torch.from_numpy(a).pin_memory() for a in blk]
        with torch.cuda.stream(side):
            staged = [t.to(dev, non_blocking=True) for t in pinned]
            done = torch.cuda.Event()
            done.record(side)
        if pending is not None:
            yield _hand_over(*pending, dev)
        pending = (staged, done)
    if pending is not None:
        yield _hand_over(*pending, dev)


def _hand_over(staged, done, dev) -> FeatureBlock:
    """Order the block's copy before the consumer's use of it, and tell
    the allocator the side stream's tensors are used on the consumer's."""
    cur = torch.cuda.current_stream(dev)
    cur.wait_event(done)
    for t in staged:
        t.record_stream(cur)
    return FeatureBlock(*staged)
