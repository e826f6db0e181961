"""Shared helpers for the torch-port parity tests (tests/test_torch_*.py):
the port's rules by name, numpy carriers of a state between the JAX package
and the port, and the state comparison at the reference's tolerances."""

import jax
import jax.numpy as jnp
import numpy as np

from hivemall_tpu.core.state import init_linear_state as jax_init_state
from hivemall_tpu.models import classifier as JCls
from hivemall_tpu.models import fm as JFM
from hivemall_tpu.models import regression as JReg
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


# --- multiclass helpers (tests/test_torch_multiclass.py, _mc_serving.py) ----

MC_RULES = ("mc_perceptron", "mc_pa", "mc_pa1", "mc_pa2", "mc_cw", "mc_arow",
            "mc_arowh", "mc_scw1", "mc_scw2")
MC_HYPER = {"mc_pa1": {"c": 1.0}, "mc_pa2": {"c": 0.5},
            "mc_cw": {"phi": 1.0}, "mc_arow": {"r": 0.1},
            "mc_arowh": {"r": 0.1, "c": 1.0},
            "mc_scw1": {"phi": 1.0, "c": 1.0},
            "mc_scw2": {"phi": 1.0, "c": 1.0}}


def mc_rules(name):
    """(JAX MCRule, port MCRule) of one rule name."""
    from hivemall_tpu.models import multiclass as JMC
    from hivemall_tpu_torch.models import multiclass as TMC

    def by_name(mod):
        return {r.name: r for r in vars(mod).values()
                if isinstance(r, mod.MCRule)}[name]

    return by_name(JMC), by_name(TMC)


def warm_mc_numpy(num_labels, dims, use_cov, seed=0, tie=False):
    """A warm multiclass state as numpy fields: random weights,
    covariances in [0.5, 1.5] (None without covariance), random touched.
    With ``tie`` (and L >= 3) label rows 1 and 2 are equal, so every row
    whose label is neither scores them equal: the missed label is decided
    by the tie."""
    rng = np.random.RandomState(seed)
    w = (0.1 * rng.randn(num_labels, dims)).astype(np.float32)
    c = rng.uniform(0.5, 1.5, (num_labels, dims)).astype(np.float32) \
        if use_cov else None
    if tie and num_labels >= 3:
        w[2] = w[1]
        if c is not None:
            c[2] = c[1]
    return {"weights": w, "covars": c,
            "touched": (rng.rand(num_labels, dims) < 0.3).astype(np.int8),
            "step": np.int32(500)}


def jax_mc_state(d):
    from hivemall_tpu.models.multiclass import MulticlassState

    return MulticlassState(
        weights=jnp.asarray(d["weights"]),
        covars=None if d["covars"] is None else jnp.asarray(d["covars"]),
        touched=jnp.asarray(d["touched"]),
        step=jnp.asarray(d["step"], jnp.int32))


def jax_mc_numpy(st):
    h = jax.device_get(st)
    return {"weights": np.array(h.weights),
            "covars": None if h.covars is None else np.array(h.covars),
            "touched": np.array(h.touched), "step": np.int32(h.step)}


def assert_mc_match(got, want, rtol=RTOL, atol=ATOL):
    """Port state (MulticlassState) against JAX's fields (numpy dict)."""
    from hivemall_tpu_torch.models.multiclass import mc_state_to_numpy

    a = mc_state_to_numpy(got)
    np.testing.assert_allclose(a["weights"], want["weights"], rtol=rtol,
                               atol=atol, err_msg="weights")
    if want["covars"] is None:
        assert a["covars"] is None
    else:
        np.testing.assert_allclose(a["covars"], want["covars"], rtol=rtol,
                                   atol=atol, err_msg="covars")
    np.testing.assert_array_equal(a["touched"], want["touched"])
    assert int(a["step"]) == int(want["step"])


def carried_mc_models(num_labels=5, dims=256, use_cov=True, seed=2):
    """(jax_model, port_model): one warm multiclass state carried into both
    packages' TrainedMulticlassModel (the port's on the CPU), labels the
    strings "c0".. plus one int."""
    from hivemall_tpu.models import multiclass as JMC
    from hivemall_tpu_torch.models import multiclass as TMC

    d = warm_mc_numpy(num_labels, dims, use_cov, seed=seed)
    vocab = [f"c{i}" for i in range(num_labels - 1)] + [7]
    return (JMC.TrainedMulticlassModel(state=jax_mc_state(d),
                                       label_vocab=vocab, dims=dims),
            TMC.TrainedMulticlassModel(
                state=TMC.mc_state_from_numpy(d, "cpu"), label_vocab=vocab,
                dims=dims))


# --- FFM helpers (tests/test_torch_ffm.py, tests/test_torch_ffm_serving.py) -

FFM_FIELDS = ("w0", "w", "z", "n", "v", "v_gg", "touched", "step")


def ffm_hypers(**kw):
    """(JAX FFMHyper, port FFMHyper) with the same fields; small tables by
    default (2^10 features, 2^12 V rows, 8 fields, k = 4)."""
    from hivemall_tpu.models import ffm as JFF
    from hivemall_tpu_torch.models import ffm as TFF

    eta = kw.pop("eta", ("invscaling", 0.2, 0.1))
    kind, eta0, extra = eta
    ek = {"total_steps": float(extra)} if kind == "simple" else (
        {"power_t": extra} if kind == "invscaling" else {})
    common = dict(factors=4, num_features=1 << 10, v_dims=1 << 12,
                  num_fields=8, seed=3)
    common.update(kw)
    return (JFF.FFMHyper(eta=JEta.EtaEstimator(kind, eta0, **ek), **common),
            TFF.FFMHyper(eta=TEta.EtaEstimator(kind, eta0, **ek), **common))


def warm_ffm_numpy(hyper, seed=0):
    """A warm FFM state as numpy fields: random w / z, positive n and V
    accumulators, a random V and touched mask, w0 0.2."""
    rng = np.random.RandomState(seed)
    d, dv, k = hyper.num_features, hyper.v_dims, hyper.factors
    return {
        "w0": np.float32(0.2),
        "w": (0.2 * rng.randn(d)).astype(np.float32),
        "z": (0.3 * rng.randn(d)).astype(np.float32),
        "n": rng.uniform(0, 2, d).astype(np.float32),
        "v": (0.2 * rng.randn(dv, k)).astype(np.float32),
        "v_gg": rng.uniform(0, 2, dv).astype(np.float32),
        "touched": (rng.rand(d) < 0.3).astype(np.int8),
        "step": np.int32(500),
    }


def jax_ffm_state(d):
    from hivemall_tpu.models.ffm import FFMState

    return FFMState(**{k: jnp.asarray(d[k]) for k in FFM_FIELDS[:-1]},
                    step=jnp.asarray(d["step"], jnp.int32))


def jax_ffm_numpy(st):
    h = jax.device_get(st)
    return {k: np.array(getattr(h, k)) for k in FFM_FIELDS}


def assert_ffm_match(got, want, rtol=RTOL, atol=ATOL):
    """Port state (FFMState) against JAX's fields (numpy dict): floats at
    rtol/atol, touched and step exact."""
    from hivemall_tpu_torch.models.ffm import ffm_state_to_numpy

    a = ffm_state_to_numpy(got)
    for k in FFM_FIELDS[:6]:
        np.testing.assert_allclose(a[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    np.testing.assert_array_equal(a["touched"], want["touched"])
    assert int(a["step"]) == int(want["step"])


def ffm_rows(n=400, n_fields=4, per_field=6, seed=5, extra=0):
    """CTR-style "field:idx:1" rows, one active feature per field (plus
    ``extra`` random tokens), labels from a planted field-aware teacher
    (the JAX package's tests/test_ffm.py generator)."""
    rng = np.random.RandomState(seed)
    V = rng.randn(n_fields * per_field, n_fields, 3) * 0.5
    rows, ys = [], []
    for _ in range(n):
        active = [f * per_field + rng.randint(per_field)
                  for f in range(n_fields)]
        s = 0.0
        for a in range(n_fields):
            for b in range(a + 1, n_fields):
                s += float(np.dot(V[active[a], b], V[active[b], a]))
        row = [f"{f}:{active[f]}:1" for f in range(n_fields)]
        row += [f"{rng.randint(n_fields)}:{rng.randint(200)}:"
                f"{rng.rand():.3f}" for _ in range(extra)]
        rows.append(row)
        ys.append(np.sign(s) if s != 0 else 1.0)
    return rows, np.asarray(ys, np.float32)


TREE_INT_FIELDS = ("feature", "threshold_bin", "nominal", "left", "right")


def assert_trees_equal(got, want, rtol=1e-6):
    """Two TreeArrays node for node: structure and leaf_dist exact,
    leaf_value at ``rtol``, the importance at ``rtol`` when both have one."""
    assert got.n_nodes == want.n_nodes
    for k in TREE_INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    if want.leaf_dist is None:
        assert got.leaf_dist is None
    else:
        np.testing.assert_array_equal(got.leaf_dist, want.leaf_dist)
    np.testing.assert_allclose(got.leaf_value, want.leaf_value, rtol=rtol)
    if got.importance is not None and want.importance is not None:
        np.testing.assert_allclose(got.importance, want.importance,
                                   rtol=rtol)


def tree_data(n=400, f=5, seed=7):
    """Uniform rows, an axis-aligned label with an interaction, and two
    integer-valued regression targets (f32 histogram sums stay exact)."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    y = ((X[:, 0] > 0.4) & (X[:, 3 % f] < 0.6)).astype(int)
    yr = (np.floor(4 * X[:, 1]) - np.floor(2 * X[:, 4 % f])).astype(
        np.float32)
    return X, y, yr


# --- multi-rank helpers (tests/test_torch_{mix,sharded_train,
# parallel_families,forest_shard}.py) ---------------------------------------

JAX_RULES = {r.name: r for mod in (JCls, JReg) for r in vars(mod).values()
             if isinstance(r, type(JCls.AROW))}
RANK_TIMEOUT = 300  # seconds a spawned world may run before it is killed


def _flat(res: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in res.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflat(flat) -> dict:
    out: dict = {}
    for key in flat.files:
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = flat[key]
    return out


def rank_scenarios(rank: int, n: int, out_dir: str, module: str,
                   names) -> None:
    """The spawned side of `run_ranks`: run each named scenario function of
    ``module`` as ``fn(rank, n) -> dict`` (of numpy arrays, numbers or
    nested dicts of them) on this rank; rank 0 saves each result as
    ``<name>.npz`` or its traceback as ``<name>.err``. A scenario that
    raises on every rank does not stop the next one."""
    import importlib
    import traceback
    from pathlib import Path

    mod = importlib.import_module(module)
    for name in names:
        try:
            res = getattr(mod, name)(rank, n)
        except Exception:  # recorded and re-raised by `scenario` below
            if rank == 0:
                (Path(out_dir) / f"{name}.err").write_text(
                    traceback.format_exc())
            continue
        if rank == 0:
            np.savez(Path(out_dir) / f"{name}.npz", **_flat(res or {}))


def run_ranks(module: str, names, n: int, tmp_path,
              timeout: float = RANK_TIMEOUT) -> dict:
    """Run the scenarios ``names`` of test module ``module`` in ``n`` gloo
    ranks on the CPU: spawned processes (one thread each) joined through a
    ``file://`` rendezvous in ``tmp_path``, all killed past ``timeout``
    seconds (hivemall_tpu_torch.parallel.mesh.spawn). Returns {name: result
    dict, or the traceback text of a scenario that raised}."""
    from hivemall_tpu_torch.parallel.mesh import spawn

    out = tmp_path / f"world{n}"
    out.mkdir()
    spawn(rank_scenarios, n, (str(out), module, list(names)),
          init_file=str(tmp_path / f"rendezvous{n}"), device="cpu",
          threads=1,
          timeout=timeout)
    results = {}
    for name in names:
        err = out / f"{name}.err"
        if err.exists():
            results[name] = err.read_text()
        else:
            with np.load(out / f"{name}.npz") as z:
                results[name] = _unflat(z)
    return results


def scenario(results: dict, name: str) -> dict:
    """One scenario's result; its rank-0 traceback fails the test."""
    res = results[name]
    if isinstance(res, str):
        raise AssertionError(f"scenario {name} raised on the ranks:\n{res}")
    return res


def one_rank_mesh():
    """A context manager: a torch.distributed world of this process alone
    (gloo, in-memory store) and its 1-D mesh on the CPU, destroyed after."""
    import contextlib

    import torch.distributed as dist

    from hivemall_tpu_torch.parallel.mesh import init_distributed, make_mesh

    @contextlib.contextmanager
    def ctx():
        init_distributed("gloo", "cpu")
        try:
            yield make_mesh(device="cpu")
        finally:
            dist.destroy_process_group()

    return ctx()


# JAX's replicated [n_dev, ...] state <-> the port's per-rank states, and
# JAX's padded, striped state <-> the port's stripes

def replicas_to_jax(per_rank):
    """The port's per-rank host states (numpy field dicts, rank order) as
    one JAX-layout dict with a leading [n_dev] axis on every field."""
    def stack(vals):
        if isinstance(vals[0], dict):
            return {k: stack([v[k] for v in vals]) for k in vals[0]}
        return None if vals[0] is None else np.stack(
            [np.asarray(v) for v in vals])

    return stack(list(per_rank))


def jax_replica(host, r):
    """Replica ``r`` of a JAX replicated host state's fields (a numpy field
    dict with a leading [n_dev] axis)."""
    return {k: (jax_replica(v, r) if isinstance(v, dict)
                else None if v is None else np.asarray(v)[r])
            for k, v in host.items()}


def stripes_to_padded(stripes, axis: int = 0):
    """The port's per-rank [stripe] tables (rank order) as the JAX padded
    [stripe * n] table (a striped leaf of its state)."""
    return np.concatenate([np.asarray(s) for s in stripes], axis=axis)


def padded_to_stripes(table, n: int, axis: int = 0):
    """A JAX padded [stripe * n] table cut into the port's n stripes."""
    return np.split(np.asarray(table), n, axis=axis)


def jax_linear_numpy(st) -> dict:
    """A JAX LinearState (replicated or not) as numpy fields, the layout
    of the port's linear_state_to_numpy."""
    h = jax.device_get(st)
    return {"weights": np.asarray(h.weights, np.float32),
            "covars": None if h.covars is None
            else np.asarray(h.covars, np.float32),
            "slots": {k: np.asarray(v) for k, v in h.slots.items()},
            "touched": np.asarray(h.touched), "step": np.asarray(h.step),
            "globals": {k: np.asarray(v) for k, v in h.globals.items()}}


def assert_linear_host_match(got: dict, want: dict, rtol=RTOL, atol=ATOL,
                             slots=True):
    """Two linear states' numpy fields: floats within rtol / atol, touched
    and step exact (a slot is compared where both have it)."""
    np.testing.assert_allclose(got["weights"], want["weights"], rtol=rtol,
                               atol=atol, err_msg="weights")
    if want["covars"] is None:
        assert got.get("covars") is None
    else:
        np.testing.assert_allclose(got["covars"], want["covars"], rtol=rtol,
                                   atol=atol, err_msg="covars")
    np.testing.assert_array_equal(got["touched"], want["touched"])
    np.testing.assert_array_equal(np.asarray(got["step"]).astype(np.int64),
                                  np.asarray(want["step"]).astype(np.int64))
    if slots:
        for k in set(got.get("slots", {})) & set(want["slots"]):
            np.testing.assert_allclose(got["slots"][k], want["slots"][k],
                                       rtol=rtol, atol=atol, err_msg=k)
    for k in want.get("globals", {}):
        np.testing.assert_allclose(got["globals"][k], want["globals"][k],
                                   rtol=rtol, atol=atol, err_msg=k)
