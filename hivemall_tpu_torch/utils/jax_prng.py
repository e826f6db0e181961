"""JAX's default random stream, reproduced in numpy.

``normal(seed, shape)`` equals ``jax.random.normal(jax.random.PRNGKey(seed),
shape, jnp.float32)`` as JAX 0.9 computes it on the CPU with its default
settings (threefry2x32, ``jax_threefry_partitionable`` on); ``split``,
``uniform`` and ``normal`` also take a key that ``split`` made. The JAX
package draws its FM and FFM factor tables this way (``init_fm_state``,
``init_ffm_state``) and MF's P and Q from the two halves of a split
(``init_mf_state``), and an FFM model blob stores only the V rows that
differ from that draw, so the port needs the same numbers to read and
write those blobs and to start a model where the JAX package starts it.

The stream, step by step (``jax/_src/prng.py``, ``jax/_src/random.py``):

- the key of an integer seed is ``(seed >> 32, seed & 0xFFFFFFFF)`` as
  uint32;
- element ``i`` of the flattened shape hashes the counter pair
  ``(i >> 32, i & 0xFFFFFFFF)`` with threefry2x32 (20 rounds) and XORs the
  two output words (``_threefry_random_bits_partitionable``);
- ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2),
  subtracts 1, and maps [0, 1) onto [nextafter(-1, 0), 1);
- ``normal`` is ``sqrt(2) * erf_inv(u)``.

The integer part and the uniform are bit-exact (uint32 arithmetic in
numpy). ``erf_inv`` is XLA's single-precision Giles polynomial over
``w = -log1p(-u * u)``; XLA's CPU code contracts each multiply-add of its
polynomials into one fused multiply-add and computes log1p through the
Cephes rational form (small arguments) or its own Cephes ``log`` of
``1 + x``. This module evaluates the same expressions in the same order, a
fused multiply-add taken as one float64 product and sum rounded once to
float32. tests/test_torch_jax_prng.py holds the result within 1 ulp of
``jax.random.normal`` (the room a double rounding in that emulated fused
multiply-add leaves) over 3 x 2^22 draws.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence, Tuple, Union

import numpy as np

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 20  # elements drawn at a time: bounds the float64 temporaries

# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): w < 5 and
# w >= 5 branches, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p for |x| < sqrt(2) - 1: x - x^2/2 + x^3 * N(x) / D(x) (Cephes)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# Cephes logf, as XLA's CPU code evaluates log
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375

_F = np.float32


Key = Tuple[int, int]
SeedOrKey = Union[int, Key]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` as its two uint32 words."""
    s = int(seed)
    return ((s >> 32) & _M32, s & _M32)


def _key(seed: SeedOrKey) -> Key:
    """An integer seed's key, or a key (two words) as given."""
    if isinstance(seed, tuple):
        return (int(seed[0]) & _M32, int(seed[1]) & _M32)
    return prng_key(seed)


def split(key: SeedOrKey, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)`` with ``jax_threefry_partitionable``
    on (``_threefry_split_foldlike``): new key i is the threefry2x32 hash
    of the counter pair (i >> 32, i & 0xFFFFFFFF) under ``key``, both
    output words kept. ``key`` may be an integer seed (its PRNGKey)."""
    k1, k2 = _key(key)
    i = np.arange(num, dtype=np.uint64)
    x0, x1 = _threefry2x32(np.uint32(k1), np.uint32(k2),
                           (i >> np.uint64(32)).astype(np.uint32),
                           (i & np.uint64(_M32)).astype(np.uint32))
    return [(int(a), int(b)) for a, b in zip(x0, x1)]


def threefry_bits(seed: SeedOrKey,
                  shape: Union[int, Sequence[int]]) -> np.ndarray:
    """uint32 ``jax.random.bits(key, shape)`` for ``key`` an integer seed's
    PRNGKey or a key from `split`: one word per element, element i hashing
    the counter pair (i >> 32, i & 0xFFFFFFFF)."""
    shape = _shape(shape)
    n = int(np.prod(shape, dtype=np.int64))
    out = np.empty(n, np.uint32)
    k1, k2 = (np.uint32(w) for w in _key(seed))
    for lo in range(0, n, _CHUNK):
        i = np.arange(lo, min(lo + _CHUNK, n), dtype=np.uint64)
        x0, x1 = _threefry2x32(k1, k2, (i >> np.uint64(32)).astype(np.uint32),
                               (i & np.uint64(_M32)).astype(np.uint32))
        out[lo:lo + len(i)] = x0 ^ x1
    return out.reshape(shape)


def _threefry2x32(k1, k2, x0, x1):
    """The 20-round threefry2x32 hash of counter words (x0, x1), uint32
    arithmetic wrapping mod 2^32 (``_threefry2x32_lowering``)."""
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for r in range(5):
            for rot in _ROTATIONS[r % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(rot)) | (x1 >> np.uint32(32 - rot))
                x1 = x0 ^ x1
            x0 = x0 + ks[(r + 1) % 3]
            x1 = x1 + ks[(r + 2) % 3] + np.uint32(r + 1)
    return x0, x1


def uniform(seed: SeedOrKey, shape, minval: float,
            maxval: float) -> np.ndarray:
    """float32 ``jax.random.uniform(key, shape, float32, minval, maxval)``
    (``seed``: an integer seed or a key from `split`), a fresh array each
    call (the last draws are kept, `_cached`)."""
    shape = _shape(shape)
    return _cached(("uniform", _key(seed), shape, float(minval),
                    float(maxval)),
                   lambda: _uniform_from_bits(threefry_bits(seed, shape),
                                              minval, maxval))


def _uniform_from_bits(bits, minval, maxval):
    lo, hi = _F(minval), _F(maxval)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(_F) - _F(1)
    return np.maximum(lo, floats * (hi - lo) + lo)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product of two float32 is
    exact in float64)."""
    return (np.asarray(a, np.float64) * b + c).astype(_F)


def _horner(x, coeffs):
    """XLA's EvaluatePolynomial, each step one fused multiply-add."""
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _F(c))
    return p


def _xla_log(x):
    """float32 natural log as XLA's CPU code computes it (Cephes logf:
    frexp, one sqrt(1/2) fold, a degree-8 polynomial)."""
    x = np.maximum(x, _F(1.17549435e-38))
    m, e = np.frexp(x)
    m, e = m.astype(_F), e.astype(_F)
    fold = m < _F(0.707106781186547524)
    t = m - _F(1)
    e = e - np.where(fold, _F(1), _F(0))
    t = t + np.where(fold, m, _F(0))
    t2 = t * t
    t3 = t2 * t
    y = _fma(_fma(_F(_LOG_P[0]), t, _F(_LOG_P[1])), t, _F(_LOG_P[2]))
    y1 = _fma(_fma(_F(_LOG_P[3]), t, _F(_LOG_P[4])), t, _F(_LOG_P[5]))
    y2 = _fma(_fma(_F(_LOG_P[6]), t, _F(_LOG_P[7])), t, _F(_LOG_P[8]))
    y = _fma(y, t3, y1)
    y = _fma(y, t3, y2)
    y = _fma(y, t3, e * _F(_LOG_Q1))
    t = _fma(t2, _F(-0.5), t)
    t = t + y
    return _fma(e, _F(_LOG_Q2), t)


def _xla_log1p(x):
    """float32 log1p as XLA computes it: the Cephes rational form where
    |x| < sqrt(2) - 1, else log(1 + x)."""
    x2 = x * x
    small = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + _fma(_F(-0.5), x2, (x * x2) * small)
    return np.where(np.abs(x) < _F(0.41421356237309504880), small,
                    _xla_log(x + _F(1)))


def erf_inv(x: np.ndarray) -> np.ndarray:
    """float32 ``jax.lax.erf_inv`` (XLA's ErfInv32) on x in (-1, 1)."""
    x = np.asarray(x, _F)
    w = -_xla_log1p(-(x * x))
    lt = w < _F(5)
    ww = np.where(lt, w - _F(2.5), np.sqrt(w) - _F(3))
    p = np.where(lt, _F(_ERFINV_LT5[0]), _F(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, ww, np.where(lt, _F(a), _F(b)))
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == _F(1), x * _F(np.inf), p * x)


_CACHE: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
# FM's and FFM's V, MF's P and Q of the same run
_CACHE_ENTRIES = 4


def clear_cache() -> None:
    """Forget the draws `normal` and `uniform` keep."""
    _CACHE.clear()


def _cached(key: tuple, draw) -> np.ndarray:
    """A fresh copy of the draw ``key`` names: the last _CACHE_ENTRIES
    draws are kept (a 2^22 x 4 table takes seconds to draw on the host,
    and a model's init, blob write and blob read each need it), so a
    repeat costs one copy."""
    if key in _CACHE:
        _CACHE.move_to_end(key)
        return _CACHE[key].copy()
    out = draw()
    _CACHE[key] = out
    while len(_CACHE) > _CACHE_ENTRIES:
        _CACHE.popitem(last=False)
    return out.copy()


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, (int, np.integer)) else tuple(shape)


def normal(seed: SeedOrKey, shape: Union[int, Sequence[int]]) -> np.ndarray:
    """float32 ``jax.random.normal(key, shape)`` (``seed``: an integer
    seed's PRNGKey or a key from `split`), a fresh array each call (the
    last draws are kept, `_cached`)."""
    shape = _shape(shape)
    return _cached(("normal", _key(seed), shape),
                   lambda: _draw_normal(seed, shape))


def _draw_normal(seed, shape):
    bits = threefry_bits(seed, shape)
    flat = bits.reshape(-1)
    out = np.empty(flat.shape, _F)
    lo = np.nextafter(_F(-1), _F(0))
    sqrt2 = _F(np.sqrt(2))
    for s in range(0, flat.size, _CHUNK):
        u = _uniform_from_bits(flat[s:s + _CHUNK], lo, 1.0)
        out[s:s + _CHUNK] = sqrt2 * erf_inv(u)
    return out.reshape(bits.shape)
