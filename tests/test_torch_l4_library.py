"""The port's feature-engineering and evaluation library against the JAX
package's on the same seeded numpy inputs: `Quantifier` and the quantify /
quantified_features paths, the scaling functions (rescale, zscore,
l2_normalize) and the binary-response ranking measures. Floats at rtol
1e-6, everything else exact."""

import numpy as np
import pytest

from hivemall_tpu import ftvec as jftvec
from hivemall_tpu.evaluation import binary_responses as jbr
from hivemall_tpu_torch import ftvec as tftvec
from hivemall_tpu_torch.evaluation import binary_responses as tbr


def _columns(seed, n=200):
    """Rows mixing numbers, strings, bools and NULLs in four columns."""
    rng = np.random.RandomState(seed)
    cats = ["red", "green", "blue", "x", True, False]
    rows = []
    for _ in range(n):
        rows.append((float(rng.randn()),
                     cats[rng.randint(len(cats))],
                     int(rng.randint(5)) if rng.rand() < 0.7
                     else f"s{rng.randint(4)}",
                     None if rng.rand() < 0.1 else cats[rng.randint(3)]))
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantifier_equals_jax(seed):
    rows = _columns(seed)
    tq, jq = tftvec.Quantifier(), jftvec.Quantifier()
    for row in rows:
        assert tftvec.quantified_features(tq, *row[:3]) == \
            jftvec.quantified_features(jq, *row[:3])
    assert tq.maps == jq.maps
    # quantify over the whole table at once, with and without a quantifier
    assert tftvec.quantify(None, *rows[0]) == jftvec.quantify(None, *rows[0])
    tq2, jq2 = tftvec.Quantifier(), jftvec.Quantifier()
    for row in rows[:50]:
        assert tftvec.quantify(tq2, *row) == jftvec.quantify(jq2, *row)


@pytest.mark.parametrize("seed", [3, 4])
def test_scaling_functions_equal_jax(seed):
    rng = np.random.RandomState(seed)
    vals = rng.randn(100) * 5
    lo, hi = float(vals.min()), float(vals.max())
    mean, std = float(vals.mean()), float(vals.std())
    for v in vals:
        v = float(v)
        for fn, args in (("rescale", (lo, hi)), ("rescale", (v, v)),
                         ("zscore", (mean, std)), ("zscore", (mean, 0.0))):
            got = getattr(tftvec, fn)(v, *args)
            want = getattr(jftvec, fn)(v, *args)
            assert got == pytest.approx(want, rel=1e-6, abs=0.0)
            assert getattr(tftvec, fn)(f"f{seed}:{v}", *args) == \
                getattr(jftvec, fn)(f"f{seed}:{v}", *args)
    for _ in range(20):
        fv = [f"{k}:{x}" for k, x in enumerate(rng.randn(rng.randint(1, 9)))]
        assert tftvec.l2_normalize(fv) == jftvec.l2_normalize(fv)
    assert tftvec.l2_normalize(["a", "b:0"]) == jftvec.l2_normalize(
        ["a", "b:0"])
    assert tftvec.l2_normalize(None) is jftvec.l2_normalize(None) is None
    with pytest.raises(ValueError):
        tftvec.rescale("nocolon", 0.0, 1.0)


MEASURES = ["precision_at", "recall_at", "hitrate", "mrr",
            "average_precision"]


@pytest.mark.parametrize("measure", MEASURES)
def test_binary_responses_equal_jax(measure):
    rng = np.random.RandomState(7)
    for _ in range(100):
        ranked = list(rng.permutation(30)[:rng.randint(0, 15)])
        truth = list(rng.choice(30, size=rng.randint(0, 6), replace=False))
        for k in (None, 1, 3, 10):
            got = getattr(tbr, measure)(ranked, truth, k)
            want = getattr(jbr, measure)(ranked, truth, k)
            assert got == pytest.approx(want, rel=1e-6, abs=0.0), \
                (measure, ranked, truth, k)


def test_evaluation_exports_equal_jax():
    import hivemall_tpu.evaluation as je
    import hivemall_tpu_torch.evaluation as te

    names = {n for n in dir(je) if not n.startswith("_")} - {
        "binary_responses", "metrics"}
    assert names <= set(dir(te))
    for n in MEASURES:
        assert getattr(te, n) is getattr(tbr, n)


UTIL_CASES = {
    "bits_required": [(0,), (1,), (255,), (1 << 40,)],
    "modulo_power_of_two": [(13, 8), (-13, 8), (1 << 33, 1 << 10)],
    "is_power_of_two": [(0,), (1,), (96,), (1 << 20,)],
    "next_power_of_two": [(0,), (3,), (1024,), (1025,)],
    "is_prime": [(1,), (2,), (97,), (100,), (7919,)],
    "next_prime": [(0,), (14,), (7920,), (1 << 20,)],
    "inverse_erf": [(-0.9,), (0.0,), (0.3,), (0.999,)],
    "probit": [(0.01,), (0.5,), (0.975,), (1e-9, 3.0)],
    "sigmoid": [(-3.0,), (0.0,), (12.5,)],
    "close_to_zero": [(1e-12,), (1e-3,), (1e-5, 1e-4)],
}
CODEC_CASES = {
    "half_float_bits": [(1.5,), (-0.0,), (65504.0,), (1e-8,)],
    "bits_to_half_float": [(0x3E00,), (0x8000,), (0x7BFF,), (1,)],
    "vbyte_encode": [([0, 1, 127, 128, 300, 1 << 40],)],
    "vbyte_decode": [(bytes([0, 1, 127, 128, 1, 172, 2]), 5)],
}


@pytest.mark.parametrize("module,name", [("math", n) for n in UTIL_CASES]
                         + [("codec", n) for n in CODEC_CASES])
def test_utils_equal_jax(module, name):
    """utils/math.py (a copy) and the codec helpers the registry's host
    library needs, against the JAX package's."""
    import importlib

    tmod = importlib.import_module(f"hivemall_tpu_torch.utils.{module}")
    jmod = importlib.import_module(f"hivemall_tpu.utils.{module}")
    for args in {**UTIL_CASES, **CODEC_CASES}[name]:
        got, want = getattr(tmod, name)(*args), getattr(jmod, name)(*args)
        assert type(got) is type(want), (name, args)
        if isinstance(want, float):
            assert got == pytest.approx(want, rel=1e-6, abs=0.0), (name, args)
        else:
            assert got == want, (name, args)
