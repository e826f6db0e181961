"""The port's elastic recovery (hivemall_tpu_torch/runtime/recovery.py)
against the JAX package's (hivemall_tpu/runtime/recovery.py), on the CPU.

``run_elastic`` runs in this process for one device (a world of one) and
as a supervisor of spawned gloo ranks for more (tests/torch_recovery_cases
.py holds what the ranks import). The counterparts of tests/test_faults.py
's run_elastic tests — device loss 4 -> 2 (exact step count 12 x 16,
lost_steps 2, accuracy > 0.7, the report equal to the JAX run's and the
model within the sharded reference tolerance rtol 2e-5 / atol 1e-6 of
it), a transient error on the same topology, give-up after max_restarts
with the crash bundle, SIGTERM checkpointing before exit, a crash between
the payload write and the rename, the missing-block_step warning and the
trace — run at one device and at several ranks. The round trips of
tests/test_elastic_recovery.py run every family in a world of 4 and resume
at 2 (the linear sharded N -> N resume bit-identical to the uninterrupted
run, every resume-then-collapse bit-identical to the checkpoint), and the
elastic files cross between the packages in both directions. The
multi-process failure-then-restart scenario closes the file."""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch.distributed as dist

from hivemall_tpu.models.classifier import AROW as JAROW
from hivemall_tpu.parallel.mesh import make_mesh as jmake_mesh
from hivemall_tpu.runtime import faults as JF
from hivemall_tpu.runtime.recovery import checkpoint as jcheckpoint
from hivemall_tpu.runtime.recovery import elastic_resume as jresume
from hivemall_tpu.runtime.recovery import run_elastic as jrun_elastic
from hivemall_tpu_torch.io.checkpoint import load_elastic
from hivemall_tpu_torch.runtime import faults
from hivemall_tpu_torch.runtime import recovery
from hivemall_tpu_torch.runtime.recovery import (checkpoint, elastic_resume,
                                                 peek_manifest, run_elastic)

import torch_recovery_cases as cases
from torch_cases import run_ranks, scenario

TOL = dict(rtol=2e-5, atol=1e-6)  # the sharded reference tolerance
CPU = "cpu"


@pytest.fixture(autouse=True)
def no_world_left():
    """run_elastic's world of one (and the supervisor's final rebuild)
    stay for the returned trainer's collectives: destroyed after each
    test."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_factory(path):
    def make(devices):
        return jresume(JAROW, {"r": 0.1}, cases.DIMS, path,
                       mesh=jmake_mesh(devices=list(devices)),
                       family="sharded")
    return make


def _report_core(rep):
    return {k: v for k, v in rep.items() if k != "recovery_s"}


# --- run_elastic: the scenarios of tests/test_faults.py ----------------------


def test_run_elastic_device_loss_resumes_on_survivors(tmp_path):
    """4 gloo ranks; a seeded device loss at step 6 ends the attempt; the
    supervisor respawns 2, which re-stripe the step-4 checkpoint and
    replay steps 4-5: the exact step count, the JAX run's report, and a
    model within the sharded tolerance of the JAX run's."""
    path = str(tmp_path / "ck.npz")
    plan = faults.FaultPlan(seed=3, faults=(
        faults.Fault("device_loss", at_step=6, n_lost=2),))
    with faults.inject(plan) as injector:
        trainer, state, report = run_elastic(
            cases.factory(path), cases.data, 12, path, checkpoint_every=4,
            devices=[CPU] * 4)
    assert [f["kind"] for f in injector.fired] == ["device_loss"]
    assert report["restarts"] == 1
    assert report["initial_devices"] == 4 and report["final_devices"] == 2
    assert report["lost_steps"] == 2
    assert report["recovery_s"] > 0
    final = trainer.final_state(state)
    assert int(final.step) == 12 * 16
    assert cases.accuracy(final.weights.numpy()) > 0.7

    jpath = str(tmp_path / "jck.npz")
    jplan = JF.FaultPlan(seed=3, faults=(
        JF.Fault("device_loss", at_step=6, n_lost=2),))
    with JF.inject(jplan):
        jt, js, jrep = jrun_elastic(
            _jax_factory(jpath), lambda t, i: cases.blk(i), 12, jpath,
            checkpoint_every=4, devices=list(jax.devices())[:4])
    assert _report_core(report) == _report_core(jrep)
    jfinal = jt.final_state(js)
    np.testing.assert_allclose(final.weights.numpy(),
                               np.asarray(jfinal.weights), **TOL)
    np.testing.assert_allclose(final.covars.numpy(),
                               np.asarray(jfinal.covars), **TOL)
    assert peek_manifest(path)["block_step"] == 12


@pytest.mark.parametrize("n", [1, 2])
def test_run_elastic_transient_error_retries_same_topology(tmp_path, n):
    path = str(tmp_path / "ck.npz")
    plan = faults.FaultPlan(seed=4, faults=(
        faults.Fault("transient_step", at_step=5),))
    with faults.inject(plan):
        trainer, state, report = run_elastic(
            cases.factory(path), cases.data, 8, path, checkpoint_every=4,
            devices=[CPU] * n)
    assert report["restarts"] == 1
    assert report["final_devices"] == report["initial_devices"] == n
    assert report["causes"] == [{"type": "TransientStepError", "step": 5,
                                 "devices": n}]
    assert report["lost_steps"] == 1
    assert int(trainer.final_state(state).step) == 8 * 16


@pytest.mark.parametrize("n", [1, 2])
def test_run_elastic_gives_up_after_max_restarts(tmp_path, n):
    from hivemall_tpu_torch.runtime.debug_bundle import SECTIONS

    path = str(tmp_path / "ck.npz")
    plan = faults.FaultPlan(seed=5, faults=tuple(
        faults.Fault("transient_step", at_step=2) for _ in range(4)))
    with faults.inject(plan) as injector:
        with pytest.raises(faults.TransientStepError):
            run_elastic(cases.factory(path), cases.data, 8, path,
                        checkpoint_every=4, max_restarts=2,
                        devices=[CPU] * n)
    assert len(injector.fired) == 3  # one per attempt, none twice
    crash_path = path + ".crash_bundle.json"
    assert os.path.exists(crash_path), "give-up must write a crash bundle"
    with open(crash_path, encoding="utf-8") as fh:
        bundle = json.load(fh, parse_constant=lambda s: pytest.fail(
            f"crash bundle is not strict JSON: emitted {s}"))
    assert all(s in bundle for s in SECTIONS)
    assert "gave up" in bundle["reason"]
    assert "TransientStepError" in bundle["reason"]


def test_crash_mid_write_preserves_previous_checkpoint(tmp_path):
    """Kill the writer between the payload write and the rename: the prior
    checkpoint survives byte-valid and resume proceeds from it."""
    path = str(tmp_path / "ck.npz")
    trainer, state = cases.make_sharded(path, [CPU])
    state, _ = trainer.step(state, *cases.blk(0))
    checkpoint(trainer, state, path, block_step=1)
    good = trainer.final_state(state)
    good_manifest = load_elastic(path)[1]
    state, _ = trainer.step(state, *cases.blk(1))
    plan = faults.FaultPlan(seed=6, faults=(
        faults.Fault("crash_mid_write", at_write=1),))
    with faults.inject(plan):
        with pytest.raises(faults.CrashMidWrite):
            checkpoint(trainer, state, path, block_step=2)
    assert load_elastic(path)[1] == good_manifest
    t2, s2 = elastic_resume(trainer.rule, {"r": 0.1}, cases.DIMS, path,
                            mesh=trainer.mesh, family="sharded")
    np.testing.assert_array_equal(t2.final_state(s2).weights.numpy(),
                                  good.weights.numpy())


def test_crash_mid_write_in_a_rank_restarts_the_world(tmp_path):
    """A crash on rank 0's checkpoint write leaves rank 1 in the barrier;
    the attempt ends (spawn's join terminates it), the supervisor
    respawns, and the run finishes with every example counted once."""
    path = str(tmp_path / "ck.npz")
    plan = faults.FaultPlan(seed=6, faults=(
        faults.Fault("crash_mid_write", at_write=2),))
    with faults.inject(plan) as injector:
        trainer, state, report = run_elastic(
            cases.factory(path), cases.data, 12, path, checkpoint_every=4,
            devices=[CPU] * 2)
    assert [f["kind"] for f in injector.fired] == ["crash_mid_write"]
    assert report["restarts"] == 1
    assert report["causes"][0]["type"] == "CrashMidWrite"
    assert report["lost_steps"] == 4  # steps 4-7 replayed from step 4
    assert report["checkpoints_written"] == 3
    assert int(trainer.final_state(state).step) == 12 * 16
    assert not os.path.exists(path + ".crash_bundle.json")


@pytest.mark.parametrize("rot", ["corrupt", "truncate"])
def test_rotted_checkpoint_falls_back_loudly(tmp_path, rot):
    path = str(tmp_path / "ck.npz")
    trainer, state = cases.make_sharded(path, [CPU])
    state, _ = trainer.step(state, *cases.blk(0))
    checkpoint(trainer, state, path, block_step=1)
    first = trainer.final_state(state)
    state, _ = trainer.step(state, *cases.blk(1))
    plan = faults.FaultPlan(seed=7, faults=(faults.Fault(rot, at_write=1),))
    with faults.inject(plan) as injector:
        checkpoint(trainer, state, path, block_step=2)
    assert [f["kind"] for f in injector.fired] == [rot]
    with pytest.warns(RuntimeWarning, match="falling back"):
        t2, s2 = elastic_resume(trainer.rule, {"r": 0.1}, cases.DIMS, path,
                                mesh=trainer.mesh, family="sharded")
    np.testing.assert_array_equal(t2.final_state(s2).weights.numpy(),
                                  first.weights.numpy())


def test_corrupt_elastic_over_legacy_prev_falls_back(tmp_path):
    from hivemall_tpu_torch.io.checkpoint import save_linear_state

    path = str(tmp_path / "ck.npz")
    trainer, state = cases.make_sharded(path, [CPU])
    state, _ = trainer.step(state, *cases.blk(0))
    legacy = trainer.final_state(state)
    save_linear_state(path, legacy)
    state, _ = trainer.step(state, *cases.blk(1))
    checkpoint(trainer, state, path)  # rotates the legacy file to .prev
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)
    with pytest.warns(RuntimeWarning, match="falling back"):
        t2, s2 = elastic_resume(trainer.rule, {"r": 0.1}, cases.DIMS, path,
                                mesh=trainer.mesh, family="sharded")
    np.testing.assert_array_equal(t2.final_state(s2).weights.numpy(),
                                  legacy.weights.numpy())


def test_run_elastic_warns_when_checkpoint_lacks_block_step(tmp_path):
    path = str(tmp_path / "ck.npz")
    trainer, state = cases.make_sharded(path, [CPU])
    state, _ = trainer.step(state, *cases.blk(0))
    checkpoint(trainer, state, path)  # manual loop: no block_step
    with pytest.warns(RuntimeWarning, match="no block_step"):
        run_elastic(cases.factory(path), cases.data, 2, path,
                    checkpoint_every=2, devices=[CPU])


def test_fault_instants_land_in_the_recovery_trace(tmp_path):
    from hivemall_tpu_torch.runtime import tracing
    from hivemall_tpu_torch.runtime.tracing import Tracer

    tracer = Tracer(sample_rate=1.0)
    path = str(tmp_path / "ck.npz")
    plan = faults.FaultPlan(seed=9, faults=(
        faults.Fault("device_loss", at_step=5, n_lost=1),))
    saved = (recovery.TRACER, tracing.TRACER, faults.TRACER)
    recovery.TRACER = faults.TRACER = tracer
    try:
        with faults.inject(plan):
            run_elastic(cases.factory(path), cases.data, 8, path,
                        checkpoint_every=4, devices=[CPU])
    finally:
        recovery.TRACER, tracing.TRACER, faults.TRACER = saved
    run_trace = tracer.traces()[-1]
    names = [s["name"] for s in run_trace["spans"]]
    assert run_trace["root"] == "recovery.run_elastic"
    assert names.count("recovery.restore") == 2  # cold start + restart
    assert names.count("train.step") == 8 + 1  # step 4 ran twice
    events = [e.get("name") for s in run_trace["spans"]
              for e in s.get("events", [])]
    assert "fault.injected" in events and "recovery.restart" in events


@pytest.mark.parametrize("n", [1, 2])
def test_run_elastic_sigterm_checkpoints_before_exit(tmp_path, n):
    """SIGTERM mid-run checkpoints the completed step at once and returns
    with the preemption recorded; a fresh run resumes from that step. At
    one device the signal is raised in-process from the data stream, as
    in the JAX test; with ranks, rank 0 sends it to the supervisor, which
    raises the flag every rank reads."""
    path = str(tmp_path / "ck.npz")
    handler_before = signal.getsignal(signal.SIGTERM)

    def data_fn(trainer, i):
        if i == 5:
            signal.raise_signal(signal.SIGTERM)
        return cases.blk(i)

    trainer, state, report = run_elastic(
        cases.factory(path), data_fn if n == 1 else cases.sigterm_data, 12,
        path, checkpoint_every=100, devices=[CPU] * n)
    assert report["preempted"] is True
    assert report["preempted_at_step"] == 6
    assert report["restarts"] == 0
    assert report["checkpoints_written"] == 1
    assert peek_manifest(path)["block_step"] == 6
    assert signal.getsignal(signal.SIGTERM) is handler_before
    assert int(trainer.final_state(state).step) == 6 * 16
    if dist.is_initialized():
        dist.destroy_process_group()

    trainer, state, report2 = run_elastic(
        cases.factory(path), cases.data, 12, path, checkpoint_every=100,
        devices=[CPU] * n)
    assert report2["preempted"] is False
    assert "preempted_at_step" not in report2
    assert peek_manifest(path)["block_step"] == 12
    assert int(trainer.final_state(state).step) == 12 * 16


def test_manifest_matches_jax(tmp_path):
    """One world of one writes a sharded checkpoint; the JAX package's
    manifest for the same run on one device has the same keys and values
    (the digest aside: the payloads differ in the last bits)."""
    path, jpath = str(tmp_path / "ck.npz"), str(tmp_path / "jck.npz")
    trainer, state = cases.make_sharded(path, [CPU])
    state, _ = trainer.step(state, *cases.blk(0))
    got = checkpoint(trainer, state, path, block_step=1)
    jt, js = _jax_factory(jpath)(list(jax.devices())[:1])
    js, _ = jt.step(js, *cases.blk(0))
    want = jcheckpoint(jt, js, jpath, block_step=1)
    assert got == load_elastic(path)[1]
    assert {k: v for k, v in got.items() if k != "digest"} == \
        {k: v for k, v in want.items() if k != "digest"}
    assert got["n_shards"] == 1 and got["step"] == 16
    json.dumps(got)


# --- the round trips of tests/test_elastic_recovery.py ------------------------


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """JAX writes two checkpoints; a world of 4 runs every family and
    writes its checkpoints; the JAX package resumes the port's; a world of
    2 resumes every checkpoint."""
    from hivemall_tpu.models.fm import FMHyper as JFMHyper

    root = tmp_path_factory.mktemp("elastic_worlds")
    ck = root / "ck"
    ck.mkdir()
    jax_out = {}
    t, s = jresume(JAROW, {"r": 0.1}, cases.LIN_DIMS, str(ck / "jax_lin.npz"),
                   mesh=jmake_mesh(4), family="sharded")
    for b in cases.row_blocks(cases.LIN_DIMS, cases.lin_w(), 0, 6):
        s, _ = t.step(s, *b)
    jcheckpoint(t, s, str(ck / "jax_lin.npz"), block_step=6)
    jax_out["lin"] = jax.device_get(t.final_state(s))
    hyper = JFMHyper(factors=4, classification=True)
    t, s = jresume(None, hyper, cases.FM_DIMS, str(ck / "jax_fm.npz"),
                   mesh=jmake_mesh(4), family="fm_sharded")
    for b in cases.fm_blocks(0, 5):
        s, _ = t.step(s, *b)
    jcheckpoint(t, s, str(ck / "jax_fm.npz"), block_step=5)
    jax_out["fm"] = jax.device_get(t.final_state(s))

    saved = os.environ.get("HM_RECOVERY_DIR")
    os.environ["HM_RECOVERY_DIR"] = str(ck)
    try:
        w4 = run_ranks("torch_recovery_cases", ["sc_write"], 4,
                       root)
        # the JAX package resumes the port's files
        for name, fam, dims, h in (
                ("lin", "sharded", cases.LIN_DIMS, {"r": 0.1}),
                ("fm", "fm_sharded", cases.FM_DIMS, hyper)):
            t, s = jresume(JAROW if fam == "sharded" else None, h, dims,
                           str(ck / f"{name}.npz"), mesh=jmake_mesh(2),
                           family=fam)
            jax_out[f"port_{name}"] = jax.device_get(t.final_state(s))
        w2 = run_ranks("torch_recovery_cases", ["sc_resume"], 2, root)
    finally:
        if saved is None:
            del os.environ["HM_RECOVERY_DIR"]
        else:
            os.environ["HM_RECOVERY_DIR"] = saved
    return scenario(w4, "sc_write"), scenario(w2, "sc_resume"), jax_out


def _eq(a, b, keys):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _holdout_logloss(weights, n=4096, seed=97):
    from hivemall_tpu_torch.evaluation.metrics import logloss

    w_true = cases.lin_w()
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, cases.LIN_DIMS, size=(n, 8))
    val = rng.rand(n, 8).astype(np.float32)
    y = (np.sum(w_true[idx] * val, axis=-1) > 0).astype(float)
    s = np.sum(np.asarray(weights, np.float32)[idx] * val, axis=-1)
    return logloss(1.0 / (1.0 + np.exp(-s)), y)


def test_sharded_round_trip_linear_bit_identical(worlds):
    """dims 259 (stripes of 65 at 4 ranks, 130 at 2): resume-then-collapse
    is bit-identical to the checkpoint at the same and at the smaller
    world; the N -> N continuation is bit-identical to the uninterrupted
    run; the N -> M continuation lands within logloss tolerance."""
    w4, w2, _ = worlds
    ck = w4["lin_ck"]
    assert int(ck["step"]) == int(w4["lin_manifest_step"]) == 6 * 16
    for back in (w4["lin_back"], w2["lin_back"]):
        _eq(back, ck, ("weights", "covars", "step", "touched"))
    _eq(w4["lin_nn"], w4["lin_full"], ("weights", "covars", "step"))
    assert int(w2["lin_cont"]["step"]) == int(w4["lin_full"]["step"]) \
        == 10 * 16
    full_ll = _holdout_logloss(w4["lin_full"]["weights"])
    assert abs(_holdout_logloss(w2["lin_cont"]["weights"]) - full_ll) < 0.02


def test_fm_sharded_round_trip(worlds):
    w4, w2, _ = worlds
    _eq(w2["fm_back"], w4["fm_ck"], ("w", "v", "step"))
    assert int(w2["fm_cont"]["step"]) == int(w4["fm_full"]["step"])
    np.testing.assert_allclose(w2["fm_cont"]["w"], w4["fm_full"]["w"],
                               rtol=5e-3, atol=5e-4)


def test_ffm_sharded_round_trip(worlds):
    w4, w2, _ = worlds
    _eq(w2["ffm_back"], w4["ffm_ck"], ("w", "v", "z", "step"))
    assert int(w2["ffm_cont"]["step"]) == int(w4["ffm_full"]["step"])
    np.testing.assert_allclose(w2["ffm_cont"]["w"], w4["ffm_full"]["w"],
                               rtol=5e-3, atol=5e-4)


def test_sharded_2d_elastic_resume(worlds):
    """(2 x 2) -> (2 x 1): resume + collapse is the identity on the step
    counter and the sum-kind slot; new work adds exactly once."""
    w4, w2, _ = worlds
    base, again, fin = w4["d2_base"], w2["d2_again"], w2["d2_fin"]
    assert int(base["step"]) == 2 * 4 * 16
    assert int(again["step"]) == int(base["step"])
    np.testing.assert_allclose(again["slots"]["sum_sqgrad"],
                               base["slots"]["sum_sqgrad"], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(again["weights"], base["weights"], rtol=1e-6)
    assert int(fin["step"]) == int(base["step"]) + 2 * 2 * 16
    assert np.all(fin["slots"]["sum_sqgrad"]
                  >= base["slots"]["sum_sqgrad"] - 1e-7)


@pytest.mark.parametrize("name", ["adagrad_regr", "pa1a_regr"])
def test_mix_resume_preserves_additive_statistics(worlds, name):
    """4 replicas -> 2: resume-then-collapse is the identity on the step
    counter, the sum-kind slot and the Welford globals; new work adds
    once."""
    w4, w2, _ = worlds
    base, again = w4[f"mix_{name}_base"], w2[f"mix_{name}_again"]
    fin = w2[f"mix_{name}_fin"]
    assert int(again["step"]) == int(base["step"]) == 4 * 2 * 16
    if name == "adagrad_regr":
        np.testing.assert_allclose(again["slots"]["sum_sqgrad"],
                                   base["slots"]["sum_sqgrad"], rtol=1e-6,
                                   atol=1e-7)
    else:
        for g, rel in (("n", 1e-6), ("mean", 1e-5), ("m2", 1e-4)):
            assert float(again["globals"][g]) == pytest.approx(
                float(base["globals"][g]), rel=rel)
        assert float(fin["globals"]["n"]) == pytest.approx(
            float(base["globals"]["n"]) + 2 * 2 * 16)
    assert int(fin["step"]) == int(base["step"]) + 2 * 2 * 16


def test_cross_family_refusal_and_linear_interop(worlds):
    w4, w2, _ = worlds
    assert "fm_sharded" in str(w2["fm_as_linear"])
    _eq(w2["mix_as_sharded"], w4["mix_adagrad_regr_base"],
        ("weights", "step"))


def test_elastic_files_cross_between_packages(worlds):
    """A JAX-written checkpoint resumes in the port at 4 and 2 ranks, and
    the port's resume in the JAX package at 2 devices, every collapse
    bit-identical to the writer's model."""
    w4, w2, jax_out = worlds
    jl, jf = jax_out["lin"], jax_out["fm"]
    for back in (w4["jax_lin_back"], w2["jax_lin_back"]):
        for k in ("weights", "covars", "touched"):
            np.testing.assert_array_equal(back[k], np.asarray(getattr(jl, k)))
        assert int(back["step"]) == int(jl.step)
    for k in ("w", "v", "touched"):
        np.testing.assert_array_equal(w2["jax_fm_back"][k],
                                      np.asarray(getattr(jf, k)))
    pl, pf = jax_out["port_lin"], jax_out["port_fm"]
    for k in ("weights", "covars", "touched"):
        np.testing.assert_array_equal(np.asarray(getattr(pl, k)),
                                      w4["lin_ck"][k])
    for k in ("w", "v", "touched"):
        np.testing.assert_array_equal(np.asarray(getattr(pf, k)),
                                      w4["fm_ck"][k])


def test_multiprocess_failure_then_elastic_restart(tmp_path):
    """A 2-rank job checkpoints its mixed model and dies with exit code 7;
    the caller sees the failure and resumes in this process (a world of
    one) from the checkpoint, which carries the trained model and keeps
    training."""
    from hivemall_tpu_torch.parallel import MixConfig
    from hivemall_tpu_torch.parallel.mesh import spawn
    from hivemall_tpu_torch.runtime.recovery import make_elastic_mesh

    ckpt = str(tmp_path / "ckpt.npz")
    with pytest.raises(Exception, match="exit code 7|exitcode 7|7"):
        spawn(cases.failing_job, 2, (ckpt,),
              init_file=str(tmp_path / "rendezvous"), device=CPU, threads=1,
              timeout=300)
    assert os.path.exists(ckpt)
    dims = cases.FAIL_DIMS
    trainer, state = elastic_resume(
        cases.AROW, {"r": 0.1}, dims, ckpt, mesh=make_elastic_mesh([CPU]),
        config=MixConfig(mix_every=2))
    rng = np.random.RandomState(21)
    w_true = rng.randn(dims)

    def acc(weights):
        r = np.random.RandomState(99)
        idx = r.randint(0, dims, size=(2000, 8))
        val = r.rand(2000, 8).astype(np.float32)
        y = np.sign(np.sum(w_true[idx] * val, axis=-1))
        return float(np.mean(np.sign(np.sum(
            np.asarray(weights)[idx] * val, axis=-1)) == y))

    acc0 = acc(trainer.final_state(state).weights.numpy())
    assert acc0 > 0.75, acc0
    rng.randint(0, dims, size=(2, 8, 16, 8))  # the job's blocks, skipped
    rng.rand(2, 8, 16, 8)
    idx = rng.randint(0, dims, size=(4, 16, 8)).astype(np.int32)
    val = rng.rand(4, 16, 8).astype(np.float32)
    lab = np.sign(np.sum(w_true[idx] * val, axis=-1)).astype(np.float32)
    state, loss = trainer.step(state, idx, val, lab)
    acc1 = acc(trainer.final_state(state).weights.numpy())
    assert np.isfinite(float(loss))
    assert acc1 >= acc0 - 0.02, (acc0, acc1)
