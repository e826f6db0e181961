"""Locality-sensitive hashing (ref: knn/lsh/*.java) — a numpy copy of the
JAX package's `knn/lsh.py`: the same seeded hash family and draws."""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np

from ..utils.feature import parse_feature
from ..utils.hashing import murmurhash3_x86_32

_MAX_INT = 2147483647


def _hash_funcs(num_hashes: int, seed: int = 0x9747B28C):
    """Family of murmur-based hash functions, one per minhash
    (ref: utils/hashing/HashFunctionFactory.java)."""
    seeds = []
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    for _ in range(num_hashes):
        seeds.append(int(rng.randint(0, _MAX_INT)))
    return seeds


def minhash(item, features: Sequence[str], num_hashes: int = 5,
            num_keygroups: int = 2) -> Iterator[Tuple[int, object]]:
    """`minhash(item, features)` UDTF — emit (clusterId, item) pairs, one per
    hash, where clusterId packs the num_keygroups smallest weighted hash
    values (ref: knn/lsh/MinHashUDTF.java:55-170; options -hashes 5 -keygroups 2)."""
    parsed = [parse_feature(f) for f in features]
    seeds = _hash_funcs(num_hashes)
    for s in seeds:
        hashes = []
        for name, w in parsed:
            h = abs(murmurhash3_x86_32(str(name), s))
            # weighted hash: larger weight -> smaller effective value
            hv = h / max(w, 1e-9) if w > 0 else float(h) * (1.0 - w + 1.0)
            hashes.append((hv, h))
        hashes.sort()
        k = min(num_keygroups, len(hashes))
        cluster = 0
        for _, h in hashes[:k]:
            cluster = (cluster * 31 + h) & 0x7FFFFFFF
        yield cluster, item


def minhashes(features: Sequence[str], num_hashes: int = 5,
              num_keygroups: int = 2) -> List[int]:
    """`minhashes(features)` UDF — the cluster ids as an array
    (ref: knn/lsh/MinHashesUDF.java)."""
    return [c for c, _ in minhash(None, features, num_hashes, num_keygroups)]


def bbit_minhash(features: Sequence[Union[str, int]], num_hashes: int = 128,
                 b: int = 1) -> int:
    """`bbit_minhash(features)` — pack the lowest b bits of each of k minhash
    values into one integer signature (ref: knn/lsh/bBitMinHashUDF.java:36)."""
    names = [str(parse_feature(str(f))[0]) for f in features]
    seeds = _hash_funcs(num_hashes)
    sig = 0
    mask = (1 << b) - 1
    for i, s in enumerate(seeds):
        mh = min((abs(murmurhash3_x86_32(n, s)) for n in names), default=0)
        sig |= (mh & mask) << (i * b)
    return sig
