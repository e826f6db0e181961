"""Distance UDFs (ref: knn/distance/*.java) — the port of the JAX
package's `knn/distance.py`.

Scalar/sparse-string variants mirror the reference UDF surface (host
Python, a copy of the JAX package's); `*_batch` variants take dense
[N, D] x [M, D] matrices and compute each distance matrix with one
``torch.matmul`` on the device, in the JAX package's form and in float32:
TF32 would round the product's inputs to 10 mantissa bits, so they refuse
to run on the card while ``torch.backends.cuda.matmul.allow_tf32`` is on.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.feature import parse_feature

VecLike = Union[Sequence[str], Dict[Union[int, str], float]]


def _to_map(v: VecLike) -> Dict:
    if isinstance(v, dict):
        return v
    out = {}
    for fv in v:
        name, val = parse_feature(fv)
        out[name] = out.get(name, 0.0) + val
    return out


def popcnt(x: Union[int, Sequence[int]]) -> int:
    """popcnt(bigint|array<bigint>) (ref: knn/distance/PopcountUDF.java)."""
    if isinstance(x, (list, tuple, np.ndarray)):
        return int(sum(bin(int(v) & 0xFFFFFFFFFFFFFFFF).count("1") for v in x))
    return bin(int(x) & 0xFFFFFFFFFFFFFFFF).count("1")


def hamming_distance(a: Union[int, Sequence[int]], b: Union[int, Sequence[int]]) -> int:
    """popcnt(a xor b) (ref: knn/distance/HammingDistanceUDF.java)."""
    if isinstance(a, (list, tuple, np.ndarray)):
        return int(sum(popcnt(int(x) ^ int(y)) for x, y in zip(a, b)))
    return popcnt(int(a) ^ int(b))


def kld(mu1: float, sigma1: float, mu2: float, sigma2: float) -> float:
    """KL divergence between two 1-D gaussians (ref: knn/distance/KLDivergenceUDF.java)."""
    return float(0.5 * (math.log(sigma2 / sigma1) + (sigma1 + (mu1 - mu2) ** 2) / sigma2
                        - 1.0))


def euclid_distance(a: VecLike, b: VecLike) -> float:
    ma, mb = _to_map(a), _to_map(b)
    keys = set(ma) | set(mb)
    return float(math.sqrt(sum((ma.get(k, 0.0) - mb.get(k, 0.0)) ** 2 for k in keys)))


def manhattan_distance(a: VecLike, b: VecLike) -> float:
    ma, mb = _to_map(a), _to_map(b)
    keys = set(ma) | set(mb)
    return float(sum(abs(ma.get(k, 0.0) - mb.get(k, 0.0)) for k in keys))


def minkowski_distance(a: VecLike, b: VecLike, p: float) -> float:
    ma, mb = _to_map(a), _to_map(b)
    keys = set(ma) | set(mb)
    return float(sum(abs(ma.get(k, 0.0) - mb.get(k, 0.0)) ** p for k in keys) ** (1.0 / p))


def cosine_distance(a: VecLike, b: VecLike) -> float:
    """1 - cosine_similarity (ref: knn/distance/CosineDistanceUDF.java:40)."""
    from .similarity import cosine_similarity

    return 1.0 - cosine_similarity(a, b)


def angular_distance(a: VecLike, b: VecLike) -> float:
    """acos(cos_sim)/pi (ref: knn/distance/AngularDistanceUDF.java)."""
    from .similarity import cosine_similarity

    cos = min(1.0, max(-1.0, cosine_similarity(a, b)))
    return float(math.acos(cos) / math.pi)


def jaccard_distance(a: Union[int, Sequence], b: Union[int, Sequence],
                     k: int = 128) -> float:
    """1 - jaccard (ref: knn/distance/JaccardDistanceUDF.java: on b-bit minhash
    signatures, union approximated via k-bit blocks)."""
    from .similarity import jaccard_similarity

    return 1.0 - jaccard_similarity(a, b, k)


# ---- dense batch distances (one matmul each, on the device) ----

def _dense_f32(x, device: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x, np.float32))
    t = t.to(device=device, dtype=torch.float32)
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "knn batch distances compute in float32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (TF32 rounds "
            "the product's inputs and breaks parity with the reference)")
    return t


def euclid_distance_batch(A, B, device: DeviceLike = None) -> torch.Tensor:
    """Pairwise distances for [N, D] x [M, D] via one matmul: the
    expansion |a|^2 + |b|^2 - 2 a.b, clamped at 0, then sqrt. Returns an
    [N, M] float32 tensor on ``device`` (None: the CUDA device)."""
    dev = resolve_device(device)
    A, B = _dense_f32(A, dev), _dense_f32(B, dev)
    sq = torch.sum(A * A, 1)[:, None] + torch.sum(B * B, 1)[None, :]
    # the doubling is exact, so sq - 2 (A @ B.T) is the reference's form;
    # in place, the [N, M] result is the only full-size temporary besides
    # the product itself
    sq.sub_(torch.matmul(A, B.T), alpha=2.0)
    return sq.clamp_(min=0.0).sqrt_()


def cosine_distance_batch(A, B, device: DeviceLike = None) -> torch.Tensor:
    """1 - cosine similarity for [N, D] x [M, D] via one matmul of the
    row-normalized matrices (norms clamped at 1e-12). Returns an [N, M]
    float32 tensor on ``device`` (None: the CUDA device)."""
    dev = resolve_device(device)
    A, B = _dense_f32(A, dev), _dense_f32(B, dev)
    An = A / torch.clamp(torch.linalg.vector_norm(A, dim=1, keepdim=True),
                         min=1e-12)
    Bn = B / torch.clamp(torch.linalg.vector_norm(B, dim=1, keepdim=True),
                         min=1e-12)
    # 1 - x as (-x) + 1: the negation is exact
    return torch.matmul(An, Bn.T).neg_().add_(1.0)
