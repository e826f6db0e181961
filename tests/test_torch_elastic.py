"""The port's elastic checkpoints (hivemall_tpu_torch/io/checkpoint.py,
save_elastic / load_elastic), fault plans (runtime/faults.py) and
``make_train_step`` (core/engine.py) against the JAX package's, on the
CPU.

Pinned: checkpoints round-trip between the packages in both directions
with equal digests; the ``.prev`` fallback on truncated and corrupted
files; ``NotElasticCheckpoint`` on a save_linear_state file; seeded fault
plans equal to JAX's and firing at the same seams; the minibatch step
equal to JAX's for AROW, PA1 and AdaGradRDA (rtol 1e-5 / atol 1e-6,
``touched`` and ``step`` exact; AdaGradRDA against JAX's mxu backend, the
rule the port shares, tests/test_torch_engine.py). None of the JAX
functions used here is red on this tree (tests/test_faults.py and
tests/test_pipeline.py, which exercise them, pass on it)."""

import os
import warnings

import numpy as np
import pytest

from hivemall_tpu.core import engine as JE
from hivemall_tpu.io import checkpoint as JC
from hivemall_tpu.runtime import faults as JF
from hivemall_tpu_torch.core import engine as TE
from hivemall_tpu_torch.core.state import linear_state_from_numpy
from hivemall_tpu_torch.io import checkpoint as TC
from hivemall_tpu_torch.runtime import faults as TF

from pallas_cases import generic_rules, make_block_data
from torch_cases import (PORT_RULES, assert_states_match,
                         jax_state_from_numpy, jax_state_numpy, warm_numpy)

RULES = ("pa1", "arow", "adagrad_rda")


def _rule(name):
    jrule, hyper, _ = next(c for c in generic_rules() if c[0].name == name)
    return jrule, PORT_RULES[name], hyper


def _payload(name, seed=0, dims=256):
    """A warm state's npz payload, packed by each package from the same
    numpy fields: (port arrays, JAX arrays)."""
    jrule, rule, _ = _rule(name)
    d = warm_numpy(rule, dims, seed)
    return (TC.pack_linear_state(linear_state_from_numpy(d, "cpu")),
            JC.pack_linear_state(jax_state_from_numpy(d)))


@pytest.mark.parametrize("name", RULES)
def test_packs_and_digests_equal_jax(name):
    ta, ja = _payload(name)
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and ta[k].shape == ja[k].shape, k
        np.testing.assert_array_equal(ta[k], ja[k])
    assert TC.elastic_digest(ta) == JC.elastic_digest(ja)
    assert TC.elastic_digest(ja) == JC.elastic_digest(ja)
    ja2 = dict(ja, step=np.asarray(np.int32(1)))
    assert TC.elastic_digest(ja2) != TC.elastic_digest(ja)


@pytest.mark.parametrize("name", RULES)
def test_jax_writes_port_loads_and_port_writes_jax_loads(name, tmp_path):
    ta, ja = _payload(name, seed=3)
    manifest = {"family": "pipeline_linear", "dims": 256, "step": 500}
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jm = JC.save_elastic(jpath, ja, manifest)
    tm = TC.save_elastic(tpath, ta, manifest)
    assert jm == tm  # digest and format_version stamped alike
    for path in (jpath, tpath):
        a1, m1 = TC.load_elastic(path)
        a2, m2 = JC.load_elastic(path)
        assert m1 == m2 == jm
        for k in a2:
            np.testing.assert_array_equal(a1[k], a2[k])
    # the loaded payload unpacks into a port state equal to the JAX one
    arrays, _ = TC.load_elastic(jpath)
    st = TC.unpack_linear_state(arrays, device="cpu")
    jst = JC.unpack_linear_state(JC.load_elastic(tpath)[0])
    assert_states_match(st, jax_state_numpy(jst), 0.0, 0.0)


def _rot(path, how):
    size = os.path.getsize(path)
    if how == "truncate":
        with open(path, "r+b") as fh:
            fh.truncate(size // 2)
        return
    with open(path, "r+b") as fh:
        fh.seek(size // 2)
        b = fh.read(1)
        fh.seek(size // 2)
        fh.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("how", ["truncate", "corrupt"])
def test_prev_fallback_on_a_rotted_newest(how, tmp_path):
    ta, _ = _payload("arow")
    path = str(tmp_path / "ck.npz")
    TC.save_elastic(path, ta, {"block_step": 1})
    ta2 = dict(ta, weights=ta["weights"] + np.float32(1))
    TC.save_elastic(path, ta2, {"block_step": 2})
    assert os.path.exists(path + TC.PREV_SUFFIX)
    _rot(path, how)
    with pytest.raises(TC.CheckpointCorrupt):
        TC.load_elastic(path, fallback=False)
    with pytest.warns(RuntimeWarning, match="falling back"):
        arrays, manifest = TC.load_elastic(path)
    assert manifest["block_step"] == 1
    np.testing.assert_array_equal(arrays["weights"], ta["weights"])
    # the JAX loader makes the same choice on the port's files
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert JC.load_elastic(path)[1] == manifest


def test_not_elastic_checkpoint_on_a_linear_state_file(tmp_path):
    _, rule, _ = _rule("arow")
    st = linear_state_from_numpy(warm_numpy(rule, 64, 1), "cpu")
    path = str(tmp_path / "plain.npz")
    TC.save_linear_state(path, st)
    with open(path + TC.PREV_SUFFIX, "wb") as fh:
        fh.write(b"never read")
    with pytest.raises(TC.NotElasticCheckpoint):
        TC.load_elastic(path)  # a format, not a rot: no fallback
    with pytest.raises(JC.NotElasticCheckpoint):
        JC.load_elastic(path)
    with pytest.raises(FileNotFoundError):
        TC.load_elastic(str(tmp_path / "missing.npz"))


def test_crash_mid_write_keeps_the_previous_checkpoint(tmp_path):
    """A planned crash between the payload write and the rename leaves the
    last good checkpoint loadable, through the port's seams."""
    ta, _ = _payload("arow")
    path = str(tmp_path / "ck.npz")
    plan = TF.FaultPlan(seed=1, faults=(TF.Fault("crash_mid_write",
                                                 at_write=2),))
    with TF.inject(plan) as inj:
        TC.save_elastic(path, ta, {"block_step": 1})
        with pytest.raises(TF.CrashMidWrite):
            TC.save_elastic(path, ta, {"block_step": 2})
    assert [f["kind"] for f in inj.fired] == ["crash_mid_write"]
    assert TC.load_elastic(path)[1]["block_step"] == 1
    assert TC.crash_point.__module__ == TC.__name__  # hooks restored


@pytest.mark.parametrize("args", [
    dict(seed=0, n_steps=40, kinds=("device_loss",)),
    dict(seed=5, n_steps=200, kinds=("transient_step", "crash_mid_write",
                                     "corrupt", "truncate"), n_faults=6,
         checkpoint_every=4, max_lost=3),
    dict(seed=123, n_steps=9, kinds=("corrupt", "device_loss"),
         n_faults=3, checkpoint_every=1),
], ids=["default", "mixed", "short"])
def test_fault_plan_generate_equals_jax(args):
    t, j = TF.FaultPlan.generate(**args), JF.FaultPlan.generate(**args)
    assert t.seed == j.seed
    assert [(f.kind, f.at_step, f.at_write, f.n_lost) for f in t.faults] \
        == [(f.kind, f.at_step, f.at_write, f.n_lost) for f in j.faults]


@pytest.mark.parametrize("kind", ["corrupt", "truncate"])
def test_injected_rot_is_the_same_bytes_as_jax(kind, tmp_path):
    """The same plan rots the same file at the same offset in both
    packages (the offset is seeded from the plan, never the clock)."""
    ta, ja = _payload("arow")
    out = {}
    for name, mod, ck, arrays in (("t", TF, TC, ta), ("j", JF, JC, ja)):
        path = str(tmp_path / f"{name}.npz")
        plan = mod.FaultPlan(seed=17, faults=(mod.Fault(kind, at_write=2),))
        with mod.inject(plan) as inj:
            ck.save_elastic(path, arrays, {"n": 1})
            ck.save_elastic(path, arrays, {"n": 2})
        with open(path, "rb") as fh:
            out[name] = (fh.read(), [dict(f, path=None) for f in inj.fired])
    assert out["t"] == out["j"]


@pytest.mark.parametrize("name", RULES)
def test_make_train_step_minibatch_equals_jax(name):
    jrule, rule, hyper = _rule(name)
    idx, val, y = make_block_data(B=48, K=8, D=256, seed=4)
    d = warm_numpy(rule, 256, 2)
    backend = "mxu" if rule.derive_w is not None else "xla"
    jstep = JE.make_train_step(jrule, hyper, mode="minibatch",
                               donate=False, update_backend=backend)
    tstep = TE.make_train_step(rule, hyper, mode="minibatch", device="cpu")
    js, ts = jax_state_from_numpy(d), linear_state_from_numpy(d, "cpu")
    for b in range(3):
        sl = slice(16 * b, 16 * (b + 1))
        js, jloss = jstep(js, idx[sl], val[sl], y[sl])
        ts, tloss = tstep(ts, idx[sl], val[sl], y[sl])
        assert_states_match(ts, jax_state_numpy(js), float(tloss),
                            float(jloss))
