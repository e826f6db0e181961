"""Bitset UDFs (ref: hivemall/tools/bits/*.java)."""

from __future__ import annotations

from typing import Iterable, List


def to_bits(indexes: Iterable[int]) -> List[int]:
    """Index list -> packed int64 words (ref: tools/bits/ToBitsUDF.java)."""
    words: List[int] = []
    for i in indexes:
        i = int(i)
        if i < 0:
            raise ValueError(f"negative index {i}")
        w = i >> 6
        while len(words) <= w:
            words.append(0)
        words[w] |= 1 << (i & 63)
    return words


def unbits(words: Iterable[int]) -> List[int]:
    """Packed words -> index list (ref: tools/bits/UnBitsUDF.java)."""
    out: List[int] = []
    for w_idx, w in enumerate(words):
        w = int(w)
        for b in range(64):
            if w & (1 << b):
                out.append(w_idx * 64 + b)
    return out


def bits_or(*bitsets: Iterable[int]) -> List[int]:
    """OR of packed bitsets (ref: tools/bits/BitsORUDF.java)."""
    out: List[int] = []
    for bs in bitsets:
        if bs is None:
            continue
        bs = list(bs)
        while len(out) < len(bs):
            out.append(0)
        for i, w in enumerate(bs):
            out[i] |= int(w)
    return out


def bits_collect(index_groups: Iterable[int]) -> List[int]:
    """Aggregate indexes into one bitset (ref: tools/bits/BitsCollectUDAF.java)."""
    return to_bits(index_groups)
