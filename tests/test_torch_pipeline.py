"""The port's continuous-training pipeline (hivemall_tpu_torch/pipeline/)
against the JAX package's (hivemall_tpu/pipeline/), on the CPU
(``device="cpu"``).

Pinned:

- a port counterpart of each test of tests/test_pipeline.py, at its size:
  the drift stream, the holdout and gate units, lineage on /models,
  regression refusal, rollback, chaos self-healing with zero lost work,
  rotted artifacts refused, resume, version burning, trusted holdout,
  name-scoped checkpoints, quantized publish, amplify, the worker thread
  and the give-up crash bundle;
- parity: the same DriftStream seed and PipelineConfig run synchronously
  through JAX's ``ContinuousPipeline.run`` and the port's give the same
  lineage (version, published, reason), the same status counters (batches,
  events, trained and replayed rows, restarts and their causes) and gate
  metrics within rtol 1e-5; the final checkpoints' w / cov agree within
  rtol 2e-5 / atol 1e-6 (the reference's minibatch tolerance,
  tests/test_batch_update.py:177-183) with ``touched`` exact — with and
  without a seeded fault plan;
- aliasing: a later training step that rewrites the state in place
  changes neither the revert snapshot nor a frozen artifact.

The numpy copies the pipeline runs on — DriftStream's blocks and holdouts,
rand_amplify's order, auc / logloss / sigmoid — equal the JAX package's.
None of the JAX functions used here is red on this tree
(tests/test_pipeline.py passes on it).
"""

import json
import os
import time
import warnings

import numpy as np
import pytest
import torch

from hivemall_tpu_torch.dataset.lr_datagen import DriftStream

DIMS = 2048
PARITY_RTOL = (2e-5, 1e-6)  # final w / cov: the reference's minibatch pin
GATE_RTOL = 1e-5


def _stream(tmp_seed=7, **kw):
    kw.setdefault("drift_every", 10**9)
    return DriftStream(DIMS, batch=64, width=8, seed=tmp_seed, **kw)


def _cfg(root, **kw):
    from hivemall_tpu_torch.models.classifier import AROW
    from hivemall_tpu_torch.pipeline import PipelineConfig

    base = dict(artifact_root=str(root), dims=DIMS, rule=AROW,
                hyper={"r": 0.1}, name="ctr", freeze_every_events=512,
                checkpoint_every_events=256, min_holdout_rows=64)
    base.update(kw)
    return PipelineConfig(**base)


def _registry():
    from hivemall_tpu_torch.serving.server import ModelRegistry

    return ModelRegistry(max_batch=64, max_delay_ms=1.0,
                         engine_kwargs={"max_width": 32}, device="cpu")


def _pipeline(reg, stream_fn, cfg, **kw):
    from hivemall_tpu_torch.pipeline import ContinuousPipeline

    return ContinuousPipeline(reg, stream_fn, cfg, device="cpu", **kw)


# --- the stream ----------------------------------------------------------


def test_drift_stream_is_deterministic_and_replayable():
    a, b = _stream(), _stream()
    for i in (0, 3, 17):
        for x, y in zip(a.block(i), b.block(i)):
            np.testing.assert_array_equal(x, y)
    i5 = a.block(9) and a.block(5)
    np.testing.assert_array_equal(i5[0], b.block(5)[0])


def test_drift_stream_rotates_piecewise():
    s = DriftStream(DIMS, batch=32, width=8, seed=3, drift_every=256,
                    drift_angle=0.5)
    w0, w1 = s.w_true(0), s.w_true(1)
    assert s.phase_of(255) == 0 and s.phase_of(256) == 1
    np.testing.assert_array_equal(s.w_true(0), w0)
    cos = float(np.dot(w0, w1) / (np.linalg.norm(w0) * np.linalg.norm(w1)))
    assert abs(cos - np.cos(0.5)) < 1e-4
    idx, val, lab = s.clean_block(0)
    agree0 = np.mean(np.sign(np.sum(w0[idx] * val, axis=-1)) == lab)
    idx9, val9, lab9 = s.clean_block(48)
    m9 = np.sum(w0[idx9] * val9, axis=-1)
    assert agree0 > 0.8 > np.mean(np.sign(m9) == lab9) + 0.1


def test_label_flip_window_poisons_training_labels_only():
    s = DriftStream(DIMS, batch=32, width=8, seed=3,
                    label_flip_events=(32, 64))
    ci, cv, cl = s.clean_block(1)
    pi, pv, pl = s.block(1)
    np.testing.assert_array_equal(ci, pi)
    np.testing.assert_array_equal(cl, -pl)
    np.testing.assert_array_equal(s.block(0)[2], s.clean_block(0)[2])


# --- holdout + gate units ------------------------------------------------


def test_rolling_holdout_routes_and_bounds():
    from hivemall_tpu_torch.pipeline import RollingHoldout

    h = RollingHoldout(capacity_rows=64, every=4)
    assert not h.routes_here(0)
    assert h.routes_here(1) and not h.routes_here(2) and h.routes_here(5)
    for i in range(5):
        h.add(np.full((32, 8), i, np.int32), np.ones((32, 8), np.float32),
              np.ones(32, np.float32))
    assert h.rows == 64
    idx_rows, val_rows, labels = h.snapshot()
    assert len(labels) == 64 and len(idx_rows) == 64
    assert int(idx_rows[0][0]) == 3


class _StubEngine:
    def __init__(self, margins):
        self._m = np.asarray(margins, np.float32)

    def predict(self, instances):
        return self._m


def _snapshot(n=128, seed=0):
    r = np.random.RandomState(seed)
    return ([r.randint(0, DIMS, 8).astype(np.int64) for _ in range(n)],
            [r.rand(8).astype(np.float32) for _ in range(n)],
            np.where(r.rand(n) > 0.5, 1.0, -1.0).astype(np.float32))


def test_gate_first_publish_and_insufficient_holdout_and_regression():
    from hivemall_tpu_torch.pipeline import EvalGate

    gate = EvalGate(regression_tol_logloss=0.005, min_holdout_rows=64)
    snap = _snapshot()
    labels = snap[2]
    good = _StubEngine(labels * 3.0)
    bad = _StubEngine(-labels * 3.0)
    d = gate.evaluate("1", good, None, snap)
    assert d.published and d.reason == "first_publish"
    assert d.candidate_logloss is not None
    d0 = gate.evaluate("1", good, None, None)
    assert d0.published and d0.holdout_rows == 0
    tiny = (snap[0][:8], snap[1][:8], labels[:8])
    d1 = gate.evaluate("2", good, good, tiny, incumbent_version="1")
    assert not d1.published and d1.reason == "insufficient_holdout"
    d2 = gate.evaluate("2", bad, good, snap, incumbent_version="1")
    assert not d2.published and d2.reason == "regression"
    assert d2.candidate_logloss > d2.incumbent_logloss
    d3 = gate.evaluate("2", good, bad, snap, incumbent_version="1")
    assert d3.published and d3.reason == "improved_or_equal"


# --- the loop end to end -------------------------------------------------


def test_pipeline_first_publish_then_gated_swaps_with_lineage(tmp_path):
    from hivemall_tpu_torch.runtime.metrics import REGISTRY

    reg = _registry()
    p = _pipeline(reg, _stream().block, _cfg(tmp_path))
    rep = p.run(40)
    assert rep["fatal"] is None
    assert rep["publishes"] >= 2
    assert rep["decisions"][0]["reason"] == "first_publish"
    entry = reg.get("ctr")
    assert entry is not None
    assert entry.version == rep["published_versions"][-1]
    lineage = entry.describe()["lineage"]
    assert lineage and lineage[-1]["version"] == entry.version
    assert any(d["reason"] == "first_publish" for d in lineage)
    assert rep["freshness_events"] == rep["events"]
    assert rep["freshness"]["p99"] is not None
    hist = REGISTRY.histogram("pipeline.ctr.freshness_seconds")
    assert hist.count >= rep["freshness_samples"]
    reg.shutdown()


def test_gate_refuses_poisoned_cycle_and_old_version_keeps_serving(
        tmp_path):
    stream = _stream(label_flip_events=(1536, 2048))
    reg = _registry()
    p = _pipeline(reg, stream.block, _cfg(tmp_path))
    rep = p.run(48)
    refused = [d for d in rep["decisions"]
               if not d["published"] and d["reason"] == "regression"]
    assert refused, rep["decisions"]
    refused_versions = {d["version"] for d in refused}
    assert not refused_versions & set(rep["published_versions"])
    assert reg.get("ctr").version in rep["published_versions"]
    poisoned = [d for d in rep["decisions"]
                if d.get("trained_through_event") == 2047]
    assert poisoned and not poisoned[0]["published"]
    reg.shutdown()


def _bad_artifact(tmp_path, version, seed):
    """A degraded version: anti-correlated weights, frozen as ctr-v<N>.
    Returns (path, state)."""
    from hivemall_tpu_torch.core.state import init_linear_state
    from hivemall_tpu_torch.models.base import TrainedLinearModel
    from hivemall_tpu_torch.models.classifier import AROW
    from hivemall_tpu_torch.serving import artifact as serving_artifact

    bad_state = init_linear_state(
        DIMS, use_covariance=True,
        initial_weights=-np.asarray(
            np.random.RandomState(seed).randn(DIMS), np.float32),
        device="cpu")
    bad = TrainedLinearModel(state=bad_state, rule=AROW, dims=DIMS,
                             block_width=8)
    path = os.path.join(str(tmp_path), f"ctr-v{version}")
    serving_artifact.freeze(bad, path, name="ctr", version=version)
    return path, bad_state


def test_rollback_on_post_publish_health_degradation(tmp_path):
    from hivemall_tpu_torch.serving import artifact as serving_artifact

    reg = _registry()
    p = _pipeline(reg, _stream().block, _cfg(tmp_path))
    rep = p.run(24)
    assert rep["publishes"] >= 1
    good_version = reg.get("ctr").version
    bad_path, _ = _bad_artifact(tmp_path, "999", 0)
    reg.deploy("ctr", serving_artifact.load(bad_path), version="999")
    with p._lock:
        p._published.append({"version": "999", "path": bad_path,
                             "trained_through": rep["events"] - 1,
                             "gate_logloss": None})
    p._maybe_rollback(p.holdout.snapshot())
    st = p.status()
    assert st["rollbacks"] == 1
    assert reg.get("ctr").version == good_version
    assert st["decisions"][-1]["reason"] == "rollback"
    assert st["decisions"][-1]["rolled_back_version"] == "999"
    p._maybe_rollback(p.holdout.snapshot())
    assert p.status()["rollbacks"] == 1
    reg.shutdown()


def _chaos_plan(faults):
    return faults.FaultPlan(seed=3, faults=(
        faults.Fault("crash_mid_write", at_write=3),
        faults.Fault("corrupt", at_write=5),
        faults.Fault("transient_step", at_step=17),
    ))


def test_chaos_faults_mid_pipeline_self_heal_zero_lost_work(tmp_path):
    """crash_mid_write kills a checkpoint write, corrupt rots the next one
    and a transient fires right after: the loop restarts from the last
    VALID checkpoint (loud .prev fallback), replays the stream, publishes
    only verified artifacts, and ends step-identical to an uninterrupted
    run."""
    from hivemall_tpu_torch.io.checkpoint import load_elastic
    from hivemall_tpu_torch.runtime import faults
    from hivemall_tpu_torch.serving import artifact as serving_artifact

    stream = _stream()
    n_batches = 40
    reg = _registry()
    root = tmp_path / "chaos"
    p = _pipeline(reg, stream.block, _cfg(root))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with faults.inject(_chaos_plan(faults)) as injector:
            rep = p.run(n_batches)
    assert {f["kind"] for f in injector.fired} == {
        "crash_mid_write", "corrupt", "transient_step"}
    assert rep["restarts"] == 2
    assert set(rep["restart_causes"]) == {"CrashMidWrite",
                                          "TransientStepError"}
    assert any("falling back" in str(x.message) for x in w)
    for v in rep["published_versions"]:
        serving_artifact.load(os.path.join(str(root), f"ctr-v{v}"),
                              verify=True)
    assert reg.get("ctr") is not None
    reg2 = _registry()
    p2 = _pipeline(reg2, stream.block, _cfg(tmp_path / "base"))
    p2.run(n_batches)
    _, m_chaos = load_elastic(str(root / "ctr_pipeline_ckpt.npz"))
    _, m_base = load_elastic(str(tmp_path / "base" / "ctr_pipeline_ckpt.npz"))
    assert m_chaos["step"] == m_base["step"]
    assert m_chaos["events"] == m_base["events"] == n_batches * 64
    assert rep["replayed_batches"] > 0
    assert p.holdout.rows == p2.holdout.rows == 5 * 64
    reg.shutdown()
    reg2.shutdown()


def test_gate_never_publishes_a_rotted_artifact(tmp_path):
    from hivemall_tpu_torch.pipeline import loop as pipeline_loop

    rotted = []

    def rot_first(path):
        if not rotted:
            ap = os.path.join(path, "arrays.npz")
            size = os.path.getsize(ap)
            with open(ap, "r+b") as f:
                f.seek(size // 2)
                b = f.read(1)
                f.seek(size // 2)
                f.write(bytes([b[0] ^ 0xFF]))
            rotted.append(path)

    reg = _registry()
    p = _pipeline(reg, _stream().block, _cfg(tmp_path))
    orig = pipeline_loop.artifact_frozen
    pipeline_loop.artifact_frozen = rot_first
    try:
        rep = p.run(24)
    finally:
        pipeline_loop.artifact_frozen = orig
    assert rotted
    d0 = rep["decisions"][0]
    assert not d0["published"] and d0["reason"] == "artifact_corrupt"
    assert d0["version"] not in rep["published_versions"]
    assert rep["publishes"] >= 1
    assert reg.get("ctr").version != d0["version"]
    reg.shutdown()


def test_checkpoint_resume_continues_versions_and_republishes(tmp_path):
    from hivemall_tpu_torch.io.checkpoint import load_elastic

    stream = _stream()
    p1 = _pipeline(_registry(), stream.block, _cfg(tmp_path))
    rep1 = p1.run(24)
    assert rep1["publishes"] >= 1
    reg2 = _registry()
    p2 = _pipeline(reg2, stream.block, _cfg(tmp_path))
    rep2 = p2.run(48)
    assert rep2["published_versions"][:len(rep1["published_versions"])] \
        == rep1["published_versions"]
    assert len(rep2["published_versions"]) > len(rep1["published_versions"])
    assert any(d["reason"] == "resume_republish"
               for d in rep2["decisions"])
    assert reg2.get("ctr").version == rep2["published_versions"][-1]
    _, m = load_elastic(str(tmp_path / "ctr_pipeline_ckpt.npz"))
    assert m["block_step"] == 48 and m["events"] == 48 * 64
    p1.registry.shutdown()
    reg2.shutdown()


def test_crash_between_freeze_and_checkpoint_burns_the_version(tmp_path):
    from hivemall_tpu_torch.core.state import init_linear_state
    from hivemall_tpu_torch.models.base import TrainedLinearModel
    from hivemall_tpu_torch.models.classifier import AROW
    from hivemall_tpu_torch.serving import artifact as serving_artifact

    stream = _stream()
    p1 = _pipeline(_registry(), stream.block, _cfg(tmp_path))
    p1.run(4)
    model = TrainedLinearModel(
        state=init_linear_state(DIMS, use_covariance=True, device="cpu"),
        rule=AROW, dims=DIMS, block_width=8)
    serving_artifact.freeze(model, str(tmp_path / "ctr-v1"), name="ctr",
                            version="1")
    p2 = _pipeline(_registry(), stream.block, _cfg(tmp_path))
    rep = p2.run(16)
    assert rep["fatal"] is None and rep["publishes"] >= 1
    assert rep["decisions"][0]["version"] == "2"
    assert "1" not in [d["version"] for d in rep["decisions"]]
    assert os.path.exists(str(tmp_path / "ctr-v1"))
    p2.registry.shutdown()


def test_trusted_holdout_stream_keeps_poison_out_of_the_gate(tmp_path):
    stream = _stream(label_flip_events=(0, 10**9))
    p = _pipeline(_registry(), stream.block, _cfg(tmp_path),
                  holdout_stream_fn=stream.clean_block)
    p.run(10)
    idx_rows, val_rows, labels = p.holdout.snapshot()
    ci, cv, cl = stream.clean_block(1)
    np.testing.assert_array_equal(labels[:64], cl)
    np.testing.assert_array_equal(np.stack(idx_rows[:64]), ci)
    p.registry.shutdown()


def test_rollback_invalidates_the_revert_snapshot(tmp_path):
    from hivemall_tpu_torch.io.checkpoint import pack_linear_state
    from hivemall_tpu_torch.serving import artifact as serving_artifact

    reg = _registry()
    p = _pipeline(reg, _stream().block, _cfg(tmp_path))
    rep = p.run(24)
    assert p._publish_snapshot is not None
    bad_path, bad_state = _bad_artifact(tmp_path, "998", 1)
    reg.deploy("ctr", serving_artifact.load(bad_path), version="998")
    with p._lock:
        p._published.append({"version": "998", "path": bad_path,
                             "trained_through": rep["events"] - 1,
                             "gate_logloss": None})
    p._publish_snapshot = pack_linear_state(bad_state)
    p._maybe_rollback(p.holdout.snapshot())
    assert p.status()["rollbacks"] == 1
    assert p._publish_snapshot is None
    assert "998" in p._condemned
    p._maybe_rollback(p.holdout.snapshot())
    assert p.status()["rollbacks"] == 1
    reg.shutdown()


def test_pipelines_sharing_artifact_root_do_not_cross_resume(tmp_path):
    stream = _stream()
    pa = _pipeline(_registry(), stream.block, _cfg(tmp_path, name="ctr"))
    rep_a = pa.run(16)
    assert rep_a["publishes"] >= 1
    pb = _pipeline(_registry(), stream.block, _cfg(tmp_path, name="other"))
    rep_b = pb.run(16)
    assert rep_b["decisions"][0]["reason"] == "first_publish"
    assert rep_b["published_versions"][0] == "1"
    assert os.path.exists(str(tmp_path / "ctr_pipeline_ckpt.npz"))
    assert os.path.exists(str(tmp_path / "other_pipeline_ckpt.npz"))
    pa.registry.shutdown()
    pb.registry.shutdown()


def test_quantized_publish_serves_at_reduced_precision(tmp_path):
    reg = _registry()
    p = _pipeline(reg, _stream().block, _cfg(tmp_path, quantize="int8"))
    rep = p.run(16)
    assert rep["publishes"] >= 1
    assert reg.get("ctr").engine.weights_dtype == "int8"
    reg.shutdown()


def test_amplify_trains_x_times_the_observed_rows(tmp_path):
    from hivemall_tpu_torch.io.checkpoint import load_elastic

    stream = _stream()
    p1 = _pipeline(_registry(), stream.block,
                   _cfg(tmp_path / "a", name="ctr", amplify_x=2))
    rep = p1.run(8)
    assert rep["trained_rows"] == 7 * 64 * 2
    assert rep["events"] == 8 * 64
    p2 = _pipeline(_registry(), stream.block,
                   _cfg(tmp_path / "b", name="ctr", amplify_x=2))
    p2.run(8)
    a1, _ = load_elastic(str(tmp_path / "a" / "ctr_pipeline_ckpt.npz"))
    a2, _ = load_elastic(str(tmp_path / "b" / "ctr_pipeline_ckpt.npz"))
    np.testing.assert_array_equal(a1["weights"], a2["weights"])
    p1.registry.shutdown()
    p2.registry.shutdown()


def test_start_stop_thread_lifecycle(tmp_path):
    from hivemall_tpu_torch.io.checkpoint import load_elastic

    reg = _registry()
    p = _pipeline(reg, _stream().block, _cfg(tmp_path))
    p.start(10**6)
    with pytest.raises(RuntimeError, match="already running"):
        p.start(1)
    deadline = 50
    while p.status()["batches"] < 4 and deadline:
        deadline -= 1
        time.sleep(0.1)
    p.stop(timeout=60)
    st = p.status()
    assert not st["running"] and st["fatal"] is None
    assert st["batches"] >= 4
    _, m = load_elastic(str(tmp_path / "ctr_pipeline_ckpt.npz"))
    assert m["block_step"] == st["batches"]
    p.stop()
    rep = p.run(m["block_step"] + 4)
    assert rep["batches"] == m["block_step"] + 4 and rep["fatal"] is None
    reg.shutdown()


def test_pipeline_giveup_writes_crash_bundle(tmp_path):
    from hivemall_tpu_torch.runtime import faults
    from hivemall_tpu_torch.runtime.debug_bundle import SECTIONS

    plan = faults.FaultPlan(seed=9, faults=tuple(
        faults.Fault("transient_step", at_step=s) for s in (2, 3, 4)))
    root = tmp_path / "giveup"
    reg = _registry()
    p = _pipeline(reg, _stream().block,
                  _cfg(root, max_restarts=1, restart_backoff_s=0.0))
    with faults.inject(plan):
        with pytest.raises(faults.TransientStepError):
            p.run(20)
    crash = os.path.join(str(root), "ctr_crash_bundle.json")
    assert os.path.exists(crash), "give-up must leave a crash bundle"
    with open(crash, encoding="utf-8") as fh:
        bundle = json.load(fh, parse_constant=lambda s: pytest.fail(
            f"crash bundle is not strict JSON: emitted {s}"))
    assert all(s in bundle for s in SECTIONS)
    assert "gave up" in bundle["reason"]
    assert "TransientStepError" in bundle["reason"]
    assert bundle["health"] is not None
    assert bundle["device_set"]["platform"] in ("cpu", "gpu")
    reg.shutdown()


# --- the port's own contract ----------------------------------------------


def test_pipeline_device_must_be_the_registrys(tmp_path):
    """The trainer and the gate run on the registry's device; another
    device is refused, and with no CUDA device the default raises."""
    from hivemall_tpu_torch.pipeline import ContinuousPipeline

    reg = _registry()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ContinuousPipeline(reg, _stream().block, _cfg(tmp_path))
    with pytest.raises(ValueError, match="one device"):
        ContinuousPipeline(reg, _stream().block, _cfg(tmp_path),
                           device="meta")
    p = _pipeline(reg, _stream().block, _cfg(tmp_path))
    assert p.device == torch.device("cpu")
    assert p.RECOVERABLE[0].__name__ == "CrashMidWrite" and {
        c.__name__ for c in p.RECOVERABLE} == {
        "CrashMidWrite", "TransientStepError", "WorkerLost"}


def test_kept_snapshots_do_not_alias_the_live_state(tmp_path):
    """Make every training step rewrite the state's tensors IN PLACE (the
    port's step contract allows it): the revert snapshot taken at a
    publish and the frozen artifact must still hold the state of that
    moment after later batches train."""
    from hivemall_tpu_torch.io.checkpoint import pack_linear_state
    from hivemall_tpu_torch.serving import artifact as serving_artifact

    reg = _registry()
    p = _pipeline(reg, _stream().block,
                  _cfg(tmp_path, freeze_every_events=512,
                       checkpoint_every_events=10**9))
    step = p._step
    kept = {}

    def in_place_step(state, idx, val, lab):
        new, loss = step(state, idx, val, lab)
        state.weights.copy_(new.weights)
        state.covars.copy_(new.covars)
        state.touched.copy_(new.touched)
        return state.replace(step=new.step, globals=new.globals), loss

    p._step = in_place_step
    orig_cycle = p._cycle

    def cycle(state, trained_through):
        out = orig_cycle(state, trained_through)
        if p._publish_snapshot is not None and "first" not in kept:
            kept["first"] = {k: v.copy() for k, v in pack_linear_state(
                out).items()}
            kept["live"] = out  # the live tensors, rewritten from now on
            kept["snap"] = p._publish_snapshot
            kept["version"] = p.status()["published_versions"][-1]
        return out

    p._cycle = cycle
    p.run(24)  # cycles at batches 7, 15 and 23; training continues after
    assert "first" in kept
    # the live state moved on...
    assert not np.array_equal(kept["live"].weights.numpy(),
                              kept["first"]["weights"])
    # ...but the snapshot kept at the first publish did not
    for k in ("weights", "covars", "touched"):
        np.testing.assert_array_equal(kept["snap"][k], kept["first"][k])
    # and the artifact frozen then still holds that state's model rows
    art = serving_artifact.load(
        os.path.join(str(tmp_path), f"ctr-v{kept['version']}"))
    feats = np.nonzero(kept["first"]["touched"])[0]
    np.testing.assert_array_equal(art.arrays["feature"], feats)
    np.testing.assert_array_equal(art.arrays["weight"],
                                  kept["first"]["weights"][feats])
    reg.shutdown()


# --- the numpy copies against the JAX package's ---------------------------


@pytest.mark.parametrize("kw", [
    dict(seed=7, drift_every=10**9),
    dict(seed=3, drift_every=256, drift_angle=0.5,
         label_flip_events=(100, 300)),
], ids=["steady", "drift_and_flip"])
def test_drift_stream_blocks_and_holdouts_equal_jax(kw):
    from hivemall_tpu.dataset.lr_datagen import DriftStream as JDS

    j = JDS(DIMS, batch=64, width=8, **kw)
    t = DriftStream(DIMS, batch=64, width=8, **kw)
    for i in (0, 1, 5, 17):
        for fn in ("block", "clean_block"):
            for a, b in zip(getattr(t, fn)(i), getattr(j, fn)(i)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    for at in (0, 700):
        th, jh = t.holdout(at, n=256), j.holdout(at, n=256)
        np.testing.assert_array_equal(np.stack(th[0]), np.stack(jh[0]))
        np.testing.assert_array_equal(np.stack(th[1]), np.stack(jh[1]))
        np.testing.assert_array_equal(th[2], jh[2])
    np.testing.assert_array_equal(t.w_true(3), j.w_true(3))


def test_rand_amplify_order_equals_jax():
    from hivemall_tpu.ftvec.amplify import amplify as j_amplify
    from hivemall_tpu.ftvec.amplify import rand_amplify as j_rand
    from hivemall_tpu_torch.ftvec.amplify import amplify, rand_amplify

    for x, nb, n, seed in ((2, 4, 64, 11), (3, 2, 3000, 9_176 * 5 + 11)):
        assert list(rand_amplify(x, nb, range(n), seed=seed)) \
            == list(j_rand(x, nb, range(n), seed=seed))
    assert list(amplify(3, "ab")) == list(j_amplify(3, "ab"))


def test_auc_logloss_sigmoid_equal_jax():
    from hivemall_tpu.evaluation import metrics as JMet
    from hivemall_tpu.tools.math import sigmoid as j_sigmoid
    from hivemall_tpu_torch.evaluation import metrics as TMet
    from hivemall_tpu_torch.tools.math import sigmoid

    r = np.random.RandomState(4)
    scores = r.randn(500).astype(np.float32)
    scores[::7] = scores[0]  # ties
    labels = np.where(r.rand(500) > 0.4, 1.0, -1.0).astype(np.float32)
    assert TMet.auc(scores, labels) == JMet.auc(scores, labels)
    p = sigmoid(scores)
    np.testing.assert_array_equal(p, j_sigmoid(scores))
    assert sigmoid(0.3) == j_sigmoid(0.3)
    assert TMet.logloss(p, labels) == JMet.logloss(p, labels)
    assert TMet.logloss(p, labels > 0) == JMet.logloss(p, labels > 0)


# --- parity with the JAX package's pipeline --------------------------------

PARITY_COUNTERS = ("batches", "events", "trained_rows", "replayed_batches",
                   "restarts", "restart_causes", "publishes", "refusals",
                   "rollbacks", "checkpoints_written", "published_versions",
                   "freshness_events", "holdout_rows")
GATE_METRICS = ("candidate_logloss", "candidate_auc", "incumbent_logloss")


def _jax_pipeline(root, stream_kw, cfg_kw):
    from hivemall_tpu.dataset.lr_datagen import DriftStream as JDS
    from hivemall_tpu.models.classifier import AROW as JAROW
    from hivemall_tpu.pipeline import ContinuousPipeline as JCP
    from hivemall_tpu.pipeline import PipelineConfig as JPC
    from hivemall_tpu.serving.server import ModelRegistry as JReg

    stream = JDS(DIMS, batch=64, width=8, **stream_kw)
    cfg = dict(artifact_root=str(root), dims=DIMS, rule=JAROW,
               hyper={"r": 0.1}, name="ctr", freeze_every_events=512,
               checkpoint_every_events=256, min_holdout_rows=64)
    cfg.update(cfg_kw)
    reg = JReg(max_batch=64, max_delay_ms=1.0,
               engine_kwargs={"max_width": 32})
    return JCP(reg, stream.block, JPC(**cfg),
               holdout_stream_fn=stream.clean_block), reg


def _run_both(tmp_path, n_batches, stream_kw, cfg_kw=None, plan=None):
    """(port report, JAX report, port final arrays, JAX final arrays)."""
    import hivemall_tpu.runtime.faults as JF
    from hivemall_tpu.io.checkpoint import load_elastic as j_load
    from hivemall_tpu_torch.io.checkpoint import load_elastic
    from hivemall_tpu_torch.runtime import faults as TF

    cfg_kw = dict(cfg_kw or {})
    jp, jreg = _jax_pipeline(tmp_path / "jax", stream_kw, cfg_kw)
    stream = DriftStream(DIMS, batch=64, width=8, **stream_kw)
    treg = _registry()
    tp = _pipeline(treg, stream.block, _cfg(tmp_path / "port", **cfg_kw),
                   holdout_stream_fn=stream.clean_block)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if plan is None:
            jrep, trep = jp.run(n_batches), tp.run(n_batches)
        else:
            with JF.inject(plan(JF)):
                jrep = jp.run(n_batches)
            with TF.inject(plan(TF)):
                trep = tp.run(n_batches)
    jreg.shutdown()
    treg.shutdown()
    ta, _ = load_elastic(str(tmp_path / "port" / "ctr_pipeline_ckpt.npz"))
    ja, _ = j_load(str(tmp_path / "jax" / "ctr_pipeline_ckpt.npz"))
    return trep, jrep, ta, ja


def _assert_parity(trep, jrep, ta, ja):
    def lineage(rep):
        return [(d["version"], d["published"], d["reason"])
                for d in rep["decisions"]]

    assert lineage(trep) == lineage(jrep)
    for k in PARITY_COUNTERS:
        assert trep[k] == jrep[k], k
    for td, jd in zip(trep["decisions"], jrep["decisions"]):
        assert td.get("trained_through_event") \
            == jd.get("trained_through_event")
        assert td.get("holdout_rows") == jd.get("holdout_rows")
        for k in GATE_METRICS:
            assert (td.get(k) is None) == (jd.get(k) is None), k
            if td.get(k) is not None:
                np.testing.assert_allclose(td[k], jd[k], rtol=GATE_RTOL)
    rtol, atol = PARITY_RTOL
    for k in ("weights", "covars"):
        np.testing.assert_allclose(ta[k], ja[k], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(ta["touched"], ja["touched"])
    assert int(ta["step"]) == int(ja["step"])


def test_pipeline_parity_with_jax(tmp_path):
    """A drifting stream with a label-flip window over one freeze cadence:
    both packages publish, refuse the poisoned candidate for regression
    and revert alike."""
    trep, jrep, ta, ja = _run_both(
        tmp_path, 48, dict(seed=7, drift_every=1024, drift_angle=0.35,
                           label_flip_events=(1536, 2048)))
    assert trep["publishes"] >= 2
    assert any(d["reason"] == "regression" for d in trep["decisions"])
    _assert_parity(trep, jrep, ta, ja)


def test_pipeline_parity_with_jax_under_a_fault_plan(tmp_path):
    """The chaos plan (crash_mid_write, corrupt, transient_step): the same
    restarts, replays, decisions and final state in both packages."""
    trep, jrep, ta, ja = _run_both(
        tmp_path, 40, dict(seed=7, drift_every=10**9), plan=_chaos_plan)
    assert trep["restarts"] == 2 and trep["replayed_batches"] > 0
    _assert_parity(trep, jrep, ta, ja)


def test_elastic_checkpoint_of_the_port_resumes_a_jax_pipeline(tmp_path):
    """The pipeline's checkpoint is the JAX package's format: a JAX
    pipeline picks up where the port's stopped, version sequence and all."""
    stream = _stream()
    tp = _pipeline(_registry(), stream.block, _cfg(tmp_path))
    trep = tp.run(16)
    tp.registry.shutdown()
    jp, jreg = _jax_pipeline(tmp_path, dict(seed=7, drift_every=10**9), {})
    jrep = jp.run(24)
    jreg.shutdown()
    assert jrep["published_versions"][:len(trep["published_versions"])] \
        == trep["published_versions"]
    assert any(d["reason"] == "resume_republish"
               for d in jrep["decisions"])
    assert jrep["batches"] == 24
