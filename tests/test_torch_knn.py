"""The port's kNN package (hivemall_tpu_torch/knn/) against the JAX
package's, on the CPU: the scalar and sparse-string distances and
similarities and the LSH family exactly, and the dense batch distances
within a tolerance derived from float32 rounding.

Batch tolerance. Both packages compute |a|^2 + |b|^2 - 2 a.b in float32
from float32 inputs. Each of the D-term sums and the two additions rounds
with unit roundoff u = 2^-24 against terms no larger than (|a| + |b|)^2,
so the squared distance is off from the float64 value by at most
E = (D + 3) u (|a| + |b|)^2. Through the clamp and the square root that
moves the distance by at most min(sqrt(E), E / d) (d the float64
distance), plus u d for the root's own rounding. The cosine distance is
1 - a^.b^ of row-normalized vectors: the norms and divisions put a
relative (D / 2 + 2) u on each normalized entry, the dot adds D u and the
subtraction 2 u, so |error| <= (2 D + 8) u. The port and the JAX package
each stay within these of float64, so they stay within twice of each
other."""

import numpy as np
import pytest
import torch

from hivemall_tpu.knn import distance as JD
from hivemall_tpu.knn import lsh as JL
from hivemall_tpu.knn import similarity as JSim
from hivemall_tpu_torch.knn import distance as TD
from hivemall_tpu_torch.knn import lsh as TL
from hivemall_tpu_torch.knn import similarity as TSim

U = 2.0 ** -24


def euclid_tol(A, B):
    """Elementwise bound on |float32 result - float64 distance|."""
    a = np.linalg.norm(A.astype(np.float64), axis=1)[:, None]
    b = np.linalg.norm(B.astype(np.float64), axis=1)[None, :]
    E = (A.shape[1] + 3) * U * (a + b) ** 2
    d = euclid64(A, B)
    with np.errstate(divide="ignore"):
        return np.minimum(np.sqrt(E), E / d) + U * d


def cosine_tol(D):
    return (2 * D + 8) * U


def euclid64(A, B):
    A, B = A.astype(np.float64), B.astype(np.float64)
    return np.sqrt(((A[:, None, :] - B[None, :, :]) ** 2).sum(-1))


def cosine64(A, B):
    A, B = A.astype(np.float64), B.astype(np.float64)
    An = A / np.maximum(np.linalg.norm(A, axis=1, keepdims=True), 1e-12)
    Bn = B / np.maximum(np.linalg.norm(B, axis=1, keepdims=True), 1e-12)
    return 1.0 - An @ Bn.T


def _pair(D, seed):
    rng = np.random.RandomState(seed)
    A = (rng.randn(48, D) * rng.uniform(0.1, 3.0, (48, 1))).astype(np.float32)
    B = (rng.randn(80, D) * rng.uniform(0.1, 3.0, (80, 1))).astype(np.float32)
    B[5] = A[3]          # a zero distance
    B[6] = 2.0 * A[4]    # a zero cosine distance
    B[7] = 0.0           # a zero row: the clamped norm
    return A, B


@pytest.mark.parametrize("D", [16, 128])
def test_euclid_distance_batch_within_rounding_bound(D):
    A, B = _pair(D, D)
    got = TD.euclid_distance_batch(A, B, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == (48, 80) and got.device.type == "cpu"
    got = got.numpy()
    want = np.asarray(JD.euclid_distance_batch(A, B))
    tol = euclid_tol(A, B)
    assert np.all(np.abs(got - euclid64(A, B)) <= tol)
    assert np.all(np.abs(want - euclid64(A, B)) <= tol)
    assert np.all(np.abs(got - want) <= 2 * tol)


@pytest.mark.parametrize("D", [16, 128])
def test_cosine_distance_batch_within_rounding_bound(D):
    A, B = _pair(D, D + 1)
    got = TD.cosine_distance_batch(torch.from_numpy(A), B,
                                   device="cpu").numpy()
    want = np.asarray(JD.cosine_distance_batch(A, B))
    ref = cosine64(A, B)
    assert got.shape == (48, 80)
    assert np.max(np.abs(got - ref)) <= cosine_tol(D)
    assert np.max(np.abs(want - ref)) <= cosine_tol(D)
    assert np.max(np.abs(got - want)) <= 2 * cosine_tol(D)
    assert got[:, 7].tolist() == [1.0] * 48  # a zero row is distance 1


def test_batch_distances_need_a_device_or_cpu_by_name():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    A = np.ones((2, 4), np.float32)
    for fn in (TD.euclid_distance_batch, TD.cosine_distance_batch):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(A, A)


def _sparse_vectors(seed):
    rng = np.random.RandomState(seed)
    vecs = []
    for _ in range(12):
        n = int(rng.randint(0, 6))
        names = [f"f{int(x)}" if rng.rand() < 0.5 else str(int(x))
                 for x in rng.randint(0, 10, n)]
        vecs.append([f"{nm}:{rng.randn():.4f}" if rng.rand() < 0.8 else nm
                     for nm in names])
    vecs.append({1: 0.5, "x": -2.0})
    vecs.append({})
    return vecs


SCALAR_PAIRS = ("euclid_distance", "manhattan_distance", "cosine_distance",
                "angular_distance")
SIMILARITIES = ("cosine_similarity", "angular_similarity",
                "euclid_similarity", "jaccard_similarity")


@pytest.mark.parametrize("fn", SCALAR_PAIRS + SIMILARITIES)
def test_scalar_distances_and_similarities_equal_jax(fn):
    vecs = _sparse_vectors(3)
    mod_t = TD if fn in SCALAR_PAIRS else TSim
    mod_j = JD if fn in SCALAR_PAIRS else JSim
    for a in vecs:
        for b in vecs:
            assert getattr(mod_t, fn)(a, b) == getattr(mod_j, fn)(a, b)


def test_bit_and_gaussian_distances_equal_jax():
    rng = np.random.RandomState(9)
    ints = [int(x) for x in rng.randint(-2 ** 62, 2 ** 62, size=20,
                                        dtype=np.int64)]
    arrs = [rng.randint(0, 2 ** 31, size=4).tolist() for _ in range(6)]
    for x in ints + arrs:
        assert TD.popcnt(x) == JD.popcnt(x)
    for a, b in zip(ints, ints[1:]):
        assert TD.hamming_distance(a, b) == JD.hamming_distance(a, b)
        for k in (8, 64, 128):
            assert TD.jaccard_distance(a, b, k) == \
                JD.jaccard_distance(a, b, k)
            assert TSim.jaccard_similarity(a, b, k) == \
                JSim.jaccard_similarity(a, b, k)
    for a, b in zip(arrs, arrs[1:]):
        assert TD.hamming_distance(a, b) == JD.hamming_distance(a, b)
    vecs = _sparse_vectors(4)
    for a, b in zip(vecs, vecs[1:]):
        for p in (1.0, 2.0, 3.5):
            assert TD.minkowski_distance(a, b, p) == \
                JD.minkowski_distance(a, b, p)
    for mu1, s1, mu2, s2 in rng.uniform(0.1, 3.0, size=(10, 4)):
        assert TD.kld(mu1, s1, mu2, s2) == JD.kld(mu1, s1, mu2, s2)
    for d in (0.0, 0.5, 3.0):
        assert TSim.distance2similarity(d) == JSim.distance2similarity(d)


@pytest.mark.parametrize("hashes,groups", [(5, 2), (3, 1), (8, 3)])
def test_minhash_family_equals_jax(hashes, groups):
    rng = np.random.RandomState(hashes)
    for _ in range(10):
        feats = [f"f{int(x)}:{rng.uniform(-1, 2):.3f}"
                 for x in rng.randint(0, 50, int(rng.randint(1, 8)))]
        assert list(TL.minhash("item", feats, hashes, groups)) == \
            list(JL.minhash("item", feats, hashes, groups))
        assert TL.minhashes(feats, hashes, groups) == \
            JL.minhashes(feats, hashes, groups)
        for k, b in ((128, 1), (32, 2), (16, 4)):
            assert TL.bbit_minhash(feats, k, b) == \
                JL.bbit_minhash(feats, k, b)
    assert TL.bbit_minhash([], 16, 1) == JL.bbit_minhash([], 16, 1)
    assert TL._hash_funcs(16) == JL._hash_funcs(16)
