"""Similarity UDFs (ref: knn/similarity/*.java) — a copy of the JAX
package's `knn/similarity.py`."""

from __future__ import annotations

import math

import numpy as np


def _to_map(v):
    from .distance import _to_map as f

    return f(v)


def cosine_similarity(a, b) -> float:
    """(ref: knn/similarity/CosineSimilarityUDF.java:39)."""
    ma, mb = _to_map(a), _to_map(b)
    dot = sum(v * mb.get(k, 0.0) for k, v in ma.items())
    na = math.sqrt(sum(v * v for v in ma.values()))
    nb = math.sqrt(sum(v * v for v in mb.values()))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(dot / (na * nb))


def angular_similarity(a, b) -> float:
    """1 - acos(cos)/pi (ref: knn/similarity/AngularSimilarityUDF.java:21)."""
    cos = min(1.0, max(-1.0, cosine_similarity(a, b)))
    return float(1.0 - math.acos(cos) / math.pi)


def euclid_similarity(a, b) -> float:
    """1/(1 + euclid_distance) (ref: knn/similarity/EuclidSimilarity.java:37)."""
    from .distance import euclid_distance

    return float(1.0 / (1.0 + euclid_distance(a, b)))


def jaccard_similarity(a, b, k: int = 128) -> float:
    """On b-bit minhash signatures: matching bits scaled to [-1, 1] then
    clipped (ref: knn/similarity/JaccardIndexUDF.java / bBitMinHash usage);
    on sets/feature lists: |A∩B| / |A∪B|."""
    if isinstance(a, (int, np.integer)) and isinstance(b, (int, np.integer)):
        matched = k - popcount_xor(int(a), int(b), k)
        sim = 2.0 * matched / k - 1.0
        return float(max(0.0, sim))
    sa = set(a if not isinstance(a, dict) else a.keys())
    sb = set(b if not isinstance(b, dict) else b.keys())
    union = len(sa | sb)
    if union == 0:
        return 0.0
    return float(len(sa & sb) / union)


def popcount_xor(a: int, b: int, k: int) -> int:
    mask = (1 << k) - 1
    return bin((a ^ b) & mask).count("1")


def distance2similarity(d: float) -> float:
    """1/(1 + d) (ref: knn/similarity/Distance2SimilarityUDF.java:36)."""
    return float(1.0 / (1.0 + d))
