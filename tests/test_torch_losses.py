"""The port's loss functions (hivemall_tpu_torch/ops/losses.py) against the
JAX package's (hivemall_tpu/ops/losses.py) on the same seeded inputs, on
the CPU. Tolerances: rtol 1e-6 in float32 (element-wise math, the same
formulas); in bfloat16 two units in the last place (rtol 2^-7), since XLA
and torch may round a bf16 expression's intermediates at different steps;
result dtypes equal exactly. The model is tests/test_substrate.py
(TestLosses), whose reference branch values are checked here too."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivemall_tpu.ops import losses as JL
from hivemall_tpu_torch.ops import losses as TL

F32_RTOL = 1e-6
BF16_RTOL = 2.0 ** -7
PAIRS = ("SquaredLoss", "LogLoss", "HingeLoss", "SquaredHingeLoss",
         "QuantileLoss", "EpsilonInsensitiveLoss")


def _inputs(seed, binary):
    rng = np.random.RandomState(seed)
    p = (rng.randn(257) * 4).astype(np.float32)
    p[:5] = (0.0, 1.0, -1.0, 30.0, -30.0)  # the branch points
    if binary:
        y = np.where(rng.rand(257) < 0.5, -1.0, 1.0).astype(np.float32)
    else:
        y = (rng.randn(257) * 2).astype(np.float32)
        y[:5] = p[:5]  # e == 0 and the quantile / epsilon edges
        y[5:8] = p[5:8] + np.float32(0.1)
    return p, y


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("name", PAIRS)
@pytest.mark.parametrize("kind", ["f32", "bf16", "int_labels"])
def test_loss_pairs_match_jax(name, kind):
    tf, jf = getattr(TL, name), getattr(JL, name)
    assert tf.name == jf.name and tf.is_binary == jf.is_binary
    p, y = _inputs(3, jf.is_binary)
    if kind == "f32":
        tp, ty, jp, jy, rtol = (torch.from_numpy(p), torch.from_numpy(y),
                                jnp.asarray(p), jnp.asarray(y), F32_RTOL)
    elif kind == "bf16":
        tp = torch.from_numpy(p).bfloat16()
        ty = torch.from_numpy(y).bfloat16()
        jp, jy = jnp.asarray(p, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
        rtol = BF16_RTOL
    else:  # float predictions, int labels: the default-float pin
        yi = np.round(y).astype(np.int32)
        tp, ty, jp, jy, rtol = (torch.from_numpy(p), torch.from_numpy(yi),
                                jnp.asarray(p), jnp.asarray(yi), F32_RTOL)
    for fn in ("loss", "dloss"):
        got = getattr(tf, fn)(tp, ty)
        want = getattr(jf, fn)(jp, jy)
        assert _dtype_name(got) == str(want.dtype), (name, kind, fn)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), rtol=rtol,
            atol=rtol * 1e-3, err_msg=f"{name} {kind} {fn}")


@pytest.mark.parametrize("kind", ["f32", "bf16", "int_target"])
def test_logistic_loss_matches_jax(kind):
    rng = np.random.RandomState(5)
    pred = (rng.randn(300) * 60).astype(np.float32)
    pred[:4] = (-100.0, -100.5, -99.5, 0.0)  # the predicted > -100 branch
    target = rng.rand(300).astype(np.float32)
    if kind == "f32":
        tt, tp = torch.from_numpy(target), torch.from_numpy(pred)
        jt, jp, rtol = jnp.asarray(target), jnp.asarray(pred), F32_RTOL
    elif kind == "bf16":
        tt = torch.from_numpy(target).bfloat16()
        tp = torch.from_numpy(pred).bfloat16()
        jt = jnp.asarray(target, jnp.bfloat16)
        jp = jnp.asarray(pred, jnp.bfloat16)
        rtol = BF16_RTOL
    else:
        ti = (target > 0.5).astype(np.int32)
        tt, tp = torch.from_numpy(ti), torch.from_numpy(pred)
        jt, jp, rtol = jnp.asarray(ti), jnp.asarray(pred), F32_RTOL
    got = TL.logistic_loss(tt, tp)
    want = JL.logistic_loss(jt, jp)
    assert _dtype_name(got) == str(want.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=rtol * 1e-3)
    # below -100 the target comes back as it is
    assert float(got[1]) == float(tt[1])


@pytest.mark.parametrize("like,want", [
    (torch.zeros(3), torch.float32), (torch.zeros(3).bfloat16(),
                                      torch.bfloat16),
    (torch.zeros(3, dtype=torch.float64), torch.float64),
    (torch.zeros(3, dtype=torch.int32), torch.float32),
    (torch.zeros(3, dtype=torch.int64), torch.float32), (2.5, torch.float32),
    (3, torch.float32)])
def test_pin_follows_the_operand(like, want):
    """`_pin`'s rule: a float operand's dtype, else the default float — as
    the JAX package's `_pin` maps the same operands."""
    got = TL._pin(1.0, like)
    assert got.dtype == want and got.dim() == 0 and float(got) == 1.0
    if not torch.is_tensor(like):
        jwant = JL._pin(1.0, like)
        assert str(jwant.dtype) == _dtype_name(got)
    elif like.dtype != torch.float64:  # JAX without x64 has no float64
        # nor int64: its int operand is int32, pinned the same way
        jlike = jnp.zeros(3, "int32" if like.dtype == torch.int64
                          else _dtype_name(like))
        assert str(JL._pin(1.0, jlike).dtype) == _dtype_name(got)


def test_pin_keeps_bf16_updates_bf16():
    """A bf16 expression stays bf16 through every pinned literal."""
    p = torch.linspace(-2, 2, 9).bfloat16()
    y = torch.ones(9).bfloat16()
    for f in (TL.SquaredLoss, TL.SquaredHingeLoss, TL.QuantileLoss,
              TL.LogLoss):
        assert f.loss(p, y).dtype == torch.bfloat16, f.name
        assert f.dloss(p, y).dtype == torch.bfloat16, f.name


def test_reference_branch_values():
    """The reference's branch values (LossFunctions.java LogLoss: exp(-z)
    for z > 18, -z for z < -18), hinge, squared, quantile and epsilon, as
    tests/test_substrate.py pins them for the JAX package."""
    f = TL.LogLoss
    assert float(f.loss(20.0, 1.0)) == pytest.approx(math.exp(-20.0),
                                                     rel=1e-6)
    assert float(f.loss(-20.0, 1.0)) == pytest.approx(20.0, rel=1e-5)
    assert float(f.loss(0.0, 1.0)) == pytest.approx(math.log(2.0), rel=1e-6)
    assert float(f.dloss(0.0, 1.0)) == pytest.approx(-0.5, rel=1e-6)
    assert float(TL.HingeLoss.loss(0.5, 1.0)) == 0.5
    assert float(TL.HingeLoss.loss(2.0, 1.0)) == 0.0
    assert float(TL.HingeLoss.dloss(0.5, 1.0)) == -1.0
    assert float(TL.HingeLoss.dloss(2.0, 1.0)) == 0.0
    assert float(TL.SquaredLoss.loss(3.0, 1.0)) == 2.0
    assert float(TL.SquaredLoss.dloss(3.0, 1.0)) == 2.0
    assert float(TL.QuantileLoss.loss(0.0, 1.0)) == 0.5
    assert float(TL.QuantileLoss.dloss(0.0, 1.0)) == -0.5
    f = TL.EpsilonInsensitiveLoss
    assert float(f.loss(0.0, 0.05)) == 0.0
    assert float(f.loss(0.0, 0.5)) == pytest.approx(0.4, rel=1e-6)
    assert float(f.dloss(0.0, 0.5)) == -1.0


def test_registry_is_case_insensitive_and_refuses_unknown():
    for name in PAIRS:
        assert TL.get_loss_function(name.upper()) is getattr(TL, name)
        assert TL.get_loss_function(name.lower()) is getattr(TL, name)
    with pytest.raises(ValueError, match="Unsupported loss type: nope"):
        TL.get_loss_function("nope")
    with pytest.raises(ValueError, match="Unsupported loss type: nope"):
        JL.get_loss_function("nope")
