"""Math substrate (ref: utils/math/{MathUtils,Primes,StatsUtils}.java)."""

from __future__ import annotations

import math


def bits_required(x: int) -> int:
    """Number of bits to represent x (ref: MathUtils.bitsRequired)."""
    return max(1, int(x).bit_length())


def modulo_power_of_two(x: int, power_of_two: int) -> int:
    """x & (2^k - 1) with two's-complement semantics for negative x
    (ref: MathUtils.moduloPowerOfTwo)."""
    return x & (power_of_two - 1)


def is_power_of_two(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def next_power_of_two(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n % 2 == 0:
        return n == 2
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def next_prime(n: int) -> int:
    """Smallest prime >= n (ref: utils/math/Primes.java, used to size hash
    tables)."""
    if n <= 2:
        return 2
    c = n if n % 2 else n + 1
    while not is_prime(c):
        c += 2
    return c


def inverse_erf(x: float) -> float:
    """erf^-1 via the Giles series refinement (ref: MathUtils.inverseErf)."""
    a = 0.147
    ln1mx2 = math.log(max(1e-300, 1.0 - x * x))
    t1 = 2.0 / (math.pi * a) + ln1mx2 / 2.0
    v = math.copysign(math.sqrt(math.sqrt(t1 * t1 - ln1mx2 / a) - t1), x)
    # two Newton refinements: f(v) = erf(v) - x
    for _ in range(2):
        err = math.erf(v) - x
        v -= err * math.sqrt(math.pi) / 2.0 * math.exp(v * v)
    return v


def probit(p: float, bound: float = 5.0) -> float:
    """probit(p) = sqrt(2) erfinv(2p - 1), clamped (ref: StatsUtils.java:35-60)."""
    if p < 0 or p > 1:
        raise ValueError("p must be in [0,1]")
    if p == 0:
        return -bound
    if p == 1:
        return bound
    v = math.sqrt(2.0) * inverse_erf(2.0 * p - 1.0)
    return max(-bound, min(bound, v))


def sigmoid(x: float) -> float:
    return 1.0 / (1.0 + math.exp(-x))


def close_to_zero(x: float, eps: float = 1e-9) -> bool:
    return abs(x) <= eps
