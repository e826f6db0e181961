"""Shared helpers for the torch-port parity tests (tests/test_torch_*.py):
the port's rules by name, numpy carriers of a state between the JAX package
and the port, and the state comparison at the reference's tolerances."""

import jax
import jax.numpy as jnp
import numpy as np

from hivemall_tpu.core.state import init_linear_state as jax_init_state
from hivemall_tpu.models import fm as JFM
from hivemall_tpu.ops import eta as JEta
from hivemall_tpu_torch.core.state import linear_state_to_numpy
from hivemall_tpu_torch.models import classifier as TC
from hivemall_tpu_torch.models import fm as TFM
from hivemall_tpu_torch.models import regression as TR
from hivemall_tpu_torch.ops import eta as TEta

RTOL, ATOL = 1e-5, 1e-6
PORT_RULES = {r.name: r for mod in (TC, TR) for r in vars(mod).values()
              if isinstance(r, type(TC.AROW))}


def jax_state_numpy(st):
    """The JAX state's fields as writable numpy copies."""
    return {
        "weights": np.array(st.weights, np.float32),
        "covars": None if st.covars is None else np.array(st.covars,
                                                          np.float32),
        "slots": {k: np.array(v) for k, v in st.slots.items()},
        "touched": np.array(st.touched),
        "step": np.int32(st.step),
        "globals": {k: np.array(v) for k, v in st.globals.items()},
    }


def warm_numpy(rule, dims, seed):
    """A warm state as numpy fields: random tables, globals and step."""
    rng = np.random.RandomState(seed)
    return {
        "weights": (0.1 * rng.randn(dims)).astype(np.float32),
        "covars": rng.uniform(0.5, 1.5, dims).astype(np.float32)
        if rule.use_covariance else None,
        "slots": {s: (rng.randn(dims) if s == "sum_grad"
                      else rng.uniform(0, 1, dims)).astype(np.float32)
                  for s in rule.slot_names},
        "touched": (rng.rand(dims) < 0.3).astype(np.int8),
        "step": np.int32(500),
        "globals": {g: np.float32(v) for g, v in
                    (("n", 7.0), ("mean", 0.05), ("m2", 1.5))
                    if g in rule.global_names},
    }


def jax_state_from_numpy(d):
    st = jax_init_state(d["weights"].shape[0],
                        use_covariance=d["covars"] is not None,
                        slot_names=tuple(d["slots"]),
                        global_names=tuple(d["globals"]))
    return st.replace(
        weights=jnp.asarray(d["weights"]),
        covars=None if d["covars"] is None else jnp.asarray(d["covars"]),
        slots={k: jnp.asarray(v) for k, v in d["slots"].items()},
        touched=jnp.asarray(d["touched"]),
        step=jnp.asarray(d["step"], jnp.int32),
        globals={k: jnp.asarray(v, jnp.float32)
                 for k, v in d["globals"].items()})


def assert_states_match(got, want, got_loss, want_loss):
    a, b = linear_state_to_numpy(got), want
    np.testing.assert_allclose(a["weights"], b["weights"], rtol=RTOL, atol=ATOL)
    if b["covars"] is not None:
        np.testing.assert_allclose(a["covars"], b["covars"], rtol=RTOL,
                                   atol=ATOL)
    for s in b["slots"]:
        np.testing.assert_allclose(a["slots"][s], b["slots"][s], rtol=RTOL,
                                   atol=ATOL)
    for g in b["globals"]:
        np.testing.assert_allclose(a["globals"][g], b["globals"][g],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(a["touched"], b["touched"])
    assert int(a["step"]) == int(b["step"])
    np.testing.assert_allclose(np.asarray(got_loss), np.asarray(want_loss),
                               rtol=RTOL, atol=ATOL)


# --- serving-slice helpers (tests/test_torch_{checkpoint,artifact,serving}.py)

def bf16_values(x):
    """f32 values that bf16 represents exactly (x rounded to bf16), so one
    numpy array seeds a bf16 table in both packages without a rounding."""
    import torch

    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16) \
        .float().numpy()


def carried_models(rule_name="arow", dims=512, seed=0, bf16=False):
    """(jax_model, port_model): one warm random linear state carried into
    both packages' TrainedLinearModel (the port's on the CPU). With
    ``bf16`` both hold their tables at bf16 — the dtype fit_linear picks
    above 2^24 dims — from values bf16 represents exactly."""
    import torch

    from hivemall_tpu.models import classifier as JC
    from hivemall_tpu.models import regression as JR
    from hivemall_tpu.models.base import TrainedLinearModel as JModel
    from hivemall_tpu_torch.core.state import linear_state_from_numpy
    from hivemall_tpu_torch.models.base import TrainedLinearModel as TModel

    port_rule = PORT_RULES[rule_name]
    jax_rule = {r.name: r for mod in (JC, JR) for r in vars(mod).values()
                if isinstance(r, type(JC.AROW))}[rule_name]
    d = warm_numpy(port_rule, dims, seed)
    if bf16:
        d["weights"] = bf16_values(d["weights"])
        if d["covars"] is not None:
            d["covars"] = bf16_values(d["covars"])
    js = jax_state_from_numpy(d)
    ts = linear_state_from_numpy(d, device="cpu")
    if bf16:
        js = js.replace(weights=js.weights.astype(jnp.bfloat16),
                        covars=None if js.covars is None
                        else js.covars.astype(jnp.bfloat16))
        ts = ts.replace(weights=ts.weights.to(torch.bfloat16),
                        covars=None if ts.covars is None
                        else ts.covars.to(torch.bfloat16))
    return (JModel(state=js, rule=jax_rule, dims=dims, block_width=8),
            TModel(state=ts, rule=port_rule, dims=dims, block_width=8))


def request_rows(dims, n=40, k=12, seed=1):
    """Scoring rows as "id:value" strings, ragged (1..k features), with ids
    past ``dims`` so hashing (mod dims) applies."""
    rng = np.random.RandomState(seed)
    return [[f"{int(i)}:{float(v):.4f}"
             for i, v in zip(rng.randint(0, 2 * dims, size=m),
                             rng.randn(m))]
            for m in rng.randint(1, k + 1, size=n)]


# --- FM helpers (tests/test_torch_fm.py, tests/test_torch_fm_serving.py) ----

def fm_hypers(factors=5, classification=True,
              eta=("invscaling", 0.05, 0.1), **kw):
    """(JAX FMHyper, port FMHyper) with the same fields."""
    kind, eta0, extra = eta
    ek = {"total_steps": float(extra)} if kind == "simple" else (
        {"power_t": extra} if kind == "invscaling" else {})
    common = dict(factors=factors, classification=classification, **kw)
    return (JFM.FMHyper(eta=JEta.EtaEstimator(kind, eta0, **ek), **common),
            TFM.FMHyper(eta=TEta.EtaEstimator(kind, eta0, **ek), **common))


def warm_fm_numpy(dims, hyper, seed=0):
    """A warm FM state as numpy fields (pad lanes of V and lambda_v 0)."""
    rng = np.random.RandomState(seed)
    k, kp = hyper.factors, hyper.padded_factors
    v = np.zeros((dims, kp), np.float32)
    v[:, :k] = 0.2 * rng.randn(dims, k)
    return {
        "w0": np.float32(0.3),
        "w": (0.2 * rng.randn(dims)).astype(np.float32),
        "v": v,
        "lambda_w0": np.float32(0.01),
        "lambda_w": np.float32(0.02),
        "lambda_v": np.array([0.01 + 0.002 * f for f in range(k)]
                             + [0.0] * (kp - k), np.float32),
        "touched": (rng.rand(dims) < 0.3).astype(np.int8),
        "step": np.int32(500),
    }


def jax_fm_state(d):
    return JFM.FMState(
        w0=jnp.asarray(d["w0"], jnp.float32), w=jnp.asarray(d["w"]),
        v=jnp.asarray(d["v"]), lambda_w0=jnp.asarray(d["lambda_w0"]),
        lambda_w=jnp.asarray(d["lambda_w"]),
        lambda_v=jnp.asarray(d["lambda_v"]),
        touched=jnp.asarray(d["touched"]),
        step=jnp.asarray(d["step"], jnp.int32))


def jax_fm_numpy(st):
    h = jax.device_get(st)
    return {k: np.array(getattr(h, k)) for k in
            ("w0", "w", "v", "lambda_w0", "lambda_w", "lambda_v", "touched",
             "step")}


def assert_fm_match(got, want, rtol=RTOL, atol=ATOL):
    """Port state (FMState) against JAX's fields (numpy dict)."""
    a = TFM.fm_state_to_numpy(got)
    for k in ("w0", "w", "v", "lambda_w0", "lambda_w", "lambda_v"):
        np.testing.assert_allclose(a[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    np.testing.assert_array_equal(a["touched"], want["touched"])
    assert int(a["step"]) == int(want["step"])


def carried_fm_models(dims=384, factors=5, seed=4, classification=True):
    """(jax_model, port_model): one warm FM state carried into both
    packages' TrainedFMModel (the port's on the CPU)."""
    jh, th = fm_hypers(factors, classification)
    d = warm_fm_numpy(dims, th, seed=seed)
    return (JFM.TrainedFMModel(state=jax_fm_state(d), hyper=jh, dims=dims),
            TFM.TrainedFMModel(state=TFM.fm_state_from_numpy(d, "cpu"),
                               hyper=th, dims=dims))


# --- MF helpers (tests/test_torch_mf.py, tests/test_torch_retrieval.py) -----

MF_FIELDS = ("P", "Q", "Bu", "Bi", "mu", "P_gg", "Q_gg")


def warm_mf_numpy(n_users, n_items, k, adagrad=False, seed=0):
    """A warm MF state as numpy fields: random tables and biases, positive
    AdaGrad accumulators (None without AdaGrad), random touched masks."""
    rng = np.random.RandomState(seed)
    return {
        "P": (0.3 * rng.randn(n_users, k)).astype(np.float32),
        "Q": (0.3 * rng.randn(n_items, k)).astype(np.float32),
        "Bu": (0.1 * rng.randn(n_users)).astype(np.float32),
        "Bi": (0.1 * rng.randn(n_items)).astype(np.float32),
        "mu": np.float32(0.4),
        "P_gg": rng.uniform(0, 2, (n_users, k)).astype(np.float32)
        if adagrad else None,
        "Q_gg": rng.uniform(0, 2, (n_items, k)).astype(np.float32)
        if adagrad else None,
        "touched_u": (rng.rand(n_users) < 0.3).astype(np.int8),
        "touched_i": (rng.rand(n_items) < 0.3).astype(np.int8),
        "step": np.int32(500),
    }


def jax_mf_state(d):
    from hivemall_tpu.models import mf as JM

    def arr(x):
        return None if x is None else jnp.asarray(x)

    return JM.MFState(
        P=arr(d["P"]), Q=arr(d["Q"]), Bu=arr(d["Bu"]), Bi=arr(d["Bi"]),
        mu=jnp.asarray(d["mu"], jnp.float32), P_gg=arr(d["P_gg"]),
        Q_gg=arr(d["Q_gg"]), touched_u=jnp.asarray(d["touched_u"]),
        touched_i=jnp.asarray(d["touched_i"]),
        step=jnp.asarray(d["step"], jnp.int32))


def jax_mf_numpy(st):
    h = jax.device_get(st)
    out = {k: None if getattr(h, k) is None else np.array(getattr(h, k))
           for k in MF_FIELDS + ("touched_u", "touched_i")}
    out["step"] = np.int32(h.step)
    return out


def assert_mf_match(got, want, rtol=RTOL, atol=ATOL):
    """Port state (MFState) against JAX's fields (numpy dict): floats at
    rtol/atol, touched and step exact."""
    from hivemall_tpu_torch.models.mf import mf_state_to_numpy

    a = mf_state_to_numpy(got)
    for k in MF_FIELDS:
        if want[k] is None:
            assert a[k] is None, k
            continue
        np.testing.assert_allclose(a[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    for k in ("touched_u", "touched_i"):
        np.testing.assert_array_equal(a[k], want[k], err_msg=k)
    assert int(a["step"]) == int(want["step"])


def carried_mf_models(n_users=30, n_items=90, k=4, seed=0, use_bias=True):
    """(jax_model, port_model): one warm MF state carried into both
    packages' TrainedMFModel (the port's on the CPU)."""
    from hivemall_tpu.models import mf as JM
    from hivemall_tpu_torch.models import mf as TM

    d = warm_mf_numpy(n_users, n_items, k, seed=seed)
    return (JM.TrainedMFModel(state=jax_mf_state(d), use_bias=use_bias),
            TM.TrainedMFModel(state=TM.mf_state_from_numpy(d, "cpu"),
                              use_bias=use_bias))
