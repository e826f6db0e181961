"""MurmurHash3 x86_32 — bit-identical to the reference implementation.

The reference hashes feature-name strings (UTF-8) with seed 0x9747b28c and maps
them into a 2^24 feature space with Java signed floor-mod semantics
(ref: core/.../utils/hashing/MurmurHash3.java:26-35, ftvec/hashing/MurmurHash3UDF.java:31).

Bit-compatibility matters: feature spaces must match between any host
preprocessing (including existing Hivemall-produced models) and our TPU
kernels, so the same string must land in the same slot.

Bulk host-side hashing (`murmurhash3_bytes_batch`) runs through the native
host library's `hm_murmur3_bulk`, as in the JAX package.
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
    """Hash many strings into int64 indices in [0, num_features) through
    the native library (`hm_murmur3_bulk`)."""
    from .. import native

    bss: List[bytes] = [s.encode("utf-8") if isinstance(s, str) else s for s in strings]
    return native.murmur3_bulk(bss, num_features, seed)
