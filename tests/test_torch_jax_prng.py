"""The port's numpy copy of JAX's default random stream
(hivemall_tpu_torch/utils/jax_prng.py) against JAX itself, and the factor
tables the port's FM and FFM draw with it.

The threefry bits and the uniform floats must be equal bit for bit. The
normal draw is held to within ULP_BOUND units in the last place of
`jax.random.normal`: the port evaluates XLA's float32 erf_inv (and the
log1p and log it calls) in the same order, each fused multiply-add as one
float64 product and sum rounded once, which a double rounding can move by
one ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hivemall_tpu_torch.utils import jax_prng as P

ULP_BOUND = 1
SEEDS = (0, 31, (1 << 31) - 1)
SHAPES = ((7,), (3, 5), (1001,), (1 << 20, 4))


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    # float order as integers: negative floats count down from 0
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_threefry_bits_equal_jax(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                      jnp.uint32))
    np.testing.assert_array_equal(P.threefry_bits(seed, shape), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_equals_jax(seed):
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (4099,),
                                         jnp.float32, lo, 1.0))
    assert P.uniform(seed, (4099,), lo, 1.0).tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normal_within_bound_of_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))
    got = P.normal(seed, shape)
    assert got.shape == want.shape and got.dtype == np.float32
    assert int(ulps(got, want).max()) <= ULP_BOUND


def test_erf_inv_within_bound_of_jax():
    """Both branches of the polynomial (w < 5 and w >= 5), both branches
    of log1p, and the ends of the uniform's range."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.concatenate([
        np.linspace(lo, 1 - 2 ** -24, 200001, dtype=np.float32),
        np.float32([lo, 0.0, -0.0, 1e-30, -0.6435, 0.6436, 0.99999,
                    -0.99999994]),
        (1 - np.logspace(-7, -1, 5001)).astype(np.float32)])
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(u)))
    assert int(ulps(P.erf_inv(u), want).max()) <= ULP_BOUND


def test_init_tables_equal_jax():
    """init_fm_state's and init_ffm_state's V are JAX's draw (pad lanes
    of FM's V zero)."""
    from hivemall_tpu.models import ffm as JFF
    from hivemall_tpu.models import fm as JFM
    from hivemall_tpu_torch.models import ffm as TFF
    from hivemall_tpu_torch.models import fm as TFM

    for k, seed, sigma in ((5, 31, 0.1), (4, 7, 0.25), (8, 2, 0.05)):
        jv = np.asarray(JFM.init_fm_state(
            4096, JFM.FMHyper(factors=k, seed=seed, sigma=sigma)).v)
        tv = TFM.init_fm_state(4096, TFM.FMHyper(factors=k, seed=seed,
                                                 sigma=sigma),
                               device="cpu").v.numpy()
        assert tv.shape == jv.shape
        assert int(ulps(tv, jv).max()) <= ULP_BOUND
    common = dict(factors=4, num_features=1 << 10, v_dims=1 << 16, seed=11,
                  sigma=0.2)
    js = JFF.init_ffm_state(JFF.FFMHyper(**common))
    ts = TFF.init_ffm_state(TFF.FFMHyper(**common), device="cpu")
    assert int(ulps(ts.v.numpy(), np.asarray(js.v)).max()) <= ULP_BOUND
    for name in ("w", "z", "n", "v_gg", "touched"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_equals_jax(seed):
    """split(PRNGKey(seed), num) with jax_threefry_partitionable on, and a
    split of a split key (both words kept)."""
    for num in (2, 3, 5):
        want = np.asarray(jax.random.key_data(jax.random.split(
            jax.random.PRNGKey(seed), num)))
        assert np.asarray(P.split(seed, num), np.uint32).tolist() \
            == want.tolist()
    k = P.split(seed)[1]
    want = np.asarray(jax.random.split(jax.random.split(
        jax.random.PRNGKey(seed))[1]))
    assert np.asarray(P.split(k), np.uint32).tolist() == want.tolist()
    np.testing.assert_array_equal(
        P.threefry_bits(k, (9,)),
        np.asarray(jax.random.bits(jax.random.split(
            jax.random.PRNGKey(seed))[1], (9,), jnp.uint32)))


@pytest.mark.parametrize("rankinit", ["random", "gaussian"])
def test_init_mf_state_equals_jax(rankinit):
    """init_mf_state's P and Q are JAX's draw from the two halves of
    split(PRNGKey(seed)), with the reference's maxval / min_init_stddev
    scaling: the uniform bit for bit, the normal within ULP_BOUND."""
    from hivemall_tpu.models import mf as JM
    from hivemall_tpu_torch.models import mf as TM

    for seed, k, maxval, std in ((31, 10, 1.0, 0.1), (5, 16, 0.5, 0.25)):
        js = JM.init_mf_state(1000, 3001, JM.MFHyper(
            factor=k, rankinit=rankinit, maxval=maxval,
            min_init_stddev=std, seed=seed))
        ts = TM.init_mf_state(1000, 3001, TM.MFHyper(
            factor=k, rankinit=rankinit, maxval=maxval,
            min_init_stddev=std, seed=seed), device="cpu")
        for got, want in ((ts.P, js.P), (ts.Q, js.Q)):
            got, want = got.numpy(), np.asarray(want)
            assert got.shape == want.shape and got.dtype == np.float32
            bound = 0 if rankinit == "random" else ULP_BOUND
            assert int(ulps(got, want).max()) <= bound
