"""MurmurHash3 x86_32 — bit-identical to the reference implementation.

The reference hashes feature-name strings (UTF-8) with seed 0x9747b28c and maps
them into a 2^24 feature space with Java signed floor-mod semantics
(ref: core/.../utils/hashing/MurmurHash3.java:26-35, ftvec/hashing/MurmurHash3UDF.java:31).

Bit-compatibility matters: feature spaces must match between any host
preprocessing (including existing Hivemall-produced models) and our TPU
kernels, so the same string must land in the same slot.

A vectorized numpy path (`murmurhash3_bytes_batch`) handles bulk host-side
hashing. (The JAX package can also route this loop through its native
library; the port keeps the numpy path only.)
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

DEFAULT_NUM_FEATURES = 1 << 24  # 2^24 (ref: MurmurHash3.java:27)
DEFAULT_SEED = 0x9747B28C

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    x &= _M32
    return ((x << r) | (x >> (32 - r))) & _M32


def murmurhash3_x86_32(data: bytes | str, seed: int = DEFAULT_SEED) -> int:
    """MurmurHash3_x86_32 over UTF-8 bytes. Returns a signed 32-bit int,
    matching Java's return type (ref: MurmurHash3.java:57-144)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    n = len(data)
    h1 = seed & _M32
    nblocks = n >> 2
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 4 : i * 4 + 4], "little")
        k1 = (k1 * _C1) & _M32
        k1 = _rotl32(k1, 15)
        k1 = (k1 * _C2) & _M32
        h1 ^= k1
        h1 = _rotl32(h1, 13)
        h1 = (h1 * 5 + 0xE6546B64) & _M32
    # tail
    tail = data[nblocks * 4 :]
    k1 = 0
    for i, b in enumerate(tail):
        k1 |= b << (8 * i)
    if tail:
        k1 = (k1 * _C1) & _M32
        k1 = _rotl32(k1, 15)
        k1 = (k1 * _C2) & _M32
        h1 ^= k1
    # finalization
    h1 ^= n
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _M32
    h1 ^= h1 >> 16
    # to Java signed int
    return h1 - (1 << 32) if h1 >= (1 << 31) else h1


def mhash(data: bytes | str, num_features: int = DEFAULT_NUM_FEATURES) -> int:
    """The `mhash(word)` SQL function: murmur3 folded into [0, num_features)
    with Java `%`-then-fixup semantics, which equals Python floor-mod on the
    *signed* hash (ref: MurmurHash3.java:32-46)."""
    return murmurhash3_x86_32(data) % num_features


def murmurhash3_bytes_batch(
    strings: Sequence[bytes | str],
    num_features: int = DEFAULT_NUM_FEATURES,
    seed: int = DEFAULT_SEED,
) -> np.ndarray:
    """Hash many strings; numpy-vectorized across the block loop.

    All inputs are processed in lockstep over their 4-byte blocks (padded with
    a done-mask), which vectorizes the hot path for bulk feature hashing.
    Returns int64 indices in [0, num_features).
    """
    bss: List[bytes] = [s.encode("utf-8") if isinstance(s, str) else s for s in strings]
    if not bss:
        return np.zeros((0,), dtype=np.int64)
    lens = np.array([len(b) for b in bss], dtype=np.int64)
    maxlen = int(lens.max())
    padded = int(-(-max(maxlen, 1) // 4) * 4)
    buf = np.zeros((len(bss), padded), dtype=np.uint8)
    for i, b in enumerate(bss):
        buf[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    words = buf.view("<u4").astype(np.uint64)  # [N, padded//4]

    h1 = np.full(len(bss), seed, dtype=np.uint64)
    nblocks = lens >> 2
    for j in range(words.shape[1]):
        active = nblocks > j
        k1 = words[:, j]
        k1 = (k1 * _C1) & _M32
        k1 = ((k1 << 15) | (k1 >> 17)) & _M32
        k1 = (k1 * _C2) & _M32
        h1x = h1 ^ k1
        h1x = ((h1x << 13) | (h1x >> 19)) & _M32
        h1x = (h1x * 5 + 0xE6546B64) & _M32
        h1 = np.where(active, h1x, h1)
    # tails: k1 = remaining bytes little-endian
    tail_len = lens & 3
    tail_start = (nblocks * 4).astype(np.int64)
    k1 = np.zeros(len(bss), dtype=np.uint64)
    for i in range(3):
        has = tail_len > i
        idx = np.minimum(tail_start + i, padded - 1)
        byte = buf[np.arange(len(bss)), idx].astype(np.uint64)
        k1 = np.where(has, k1 | (byte << np.uint64(8 * i)), k1)
    has_tail = tail_len > 0
    k1 = (k1 * _C1) & _M32
    k1 = ((k1 << 15) | (k1 >> 17)) & _M32
    k1 = (k1 * _C2) & _M32
    h1 = np.where(has_tail, h1 ^ k1, h1)
    # finalization
    h1 ^= lens.astype(np.uint64)
    h1 &= _M32
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _M32
    h1 ^= h1 >> 16
    signed = h1.astype(np.int64)
    signed = np.where(signed >= (1 << 31), signed - (1 << 32), signed)
    return np.mod(signed, num_features)
