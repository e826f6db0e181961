"""Continuous training: stream -> freeze -> eval gate -> hot-swap — the
port of `hivemall_tpu/pipeline/loop.py`.

A `ContinuousPipeline` owns a publisher state machine running over a
drifting event stream:

    TRAIN ──cadence──> FREEZE ──> GATE ──pass──> PUBLISH (atomic hot-swap)
      ^                            │ fail                │
      │<── revert-on-refuse ───────┘      ROLLBACK <─────┘ (health check)

- **TRAIN**: an online linear learner (core/engine.make_train_step,
  minibatch mode, on the pipeline's device) consumes observed event
  batches; every ``holdout_every``-th batch is routed to the rolling
  holdout instead (pipeline/holdout.py) so the gate always has unseen,
  current-concept data. The loop checkpoints through
  io/checkpoint.save_elastic on an event cadence, so fault plans
  (runtime/faults.py: crash_mid_write / corrupt / transient) fire through
  the same seams training uses — and recovery resumes from the last valid
  checkpoint (loud ``.prev`` fallback) and replays the deterministic
  stream from the checkpoint's ``block_step``.
- **FREEZE**: on an event cadence the live state freezes into an immutable
  versioned artifact (serving/artifact.freeze, optionally straight to
  bf16/int8). The ``artifact_frozen`` hook mirrors io/checkpoint's chaos
  seams: tests rot the artifact there and the gate must refuse it.
- **GATE**: the candidate is loaded back sha256-VERIFIED and scored through
  the serving path next to the live version (pipeline/gate.EvalGate) — a
  regression, an unmeasurable candidate, or a corrupt artifact refuses
  publication and the old version keeps serving. ``revert_on_refuse``
  additionally restores the trainer to the last-published state, so a
  bad-data window is quarantined instead of poisoning every later
  candidate.
- **PUBLISH**: serving/server.ModelRegistry.deploy — warm off to the side,
  one-assignment swap, old batcher drains; zero failed in-flight
  requests. The deploy carries version lineage (gate decisions) that
  /models surfaces.
- **ROLLBACK**: each cycle starts with a health check — if the LIVE
  version's holdout logloss degrades past ``rollback_tol_logloss`` vs the
  previously-published version on the CURRENT holdout, the previous
  artifact is redeployed (lineage records the rollback).

**Freshness** is the pipeline's headline metric: for every observed event
batch the loop records "event observed -> the first model version
published after the pipeline processed it is serving" latency into the
``pipeline.<name>.freshness_seconds`` histogram on /metrics (and keeps
raw samples for exact percentiles). "Processed" is deliberate: a
revert-on-refuse quarantine means the publishing model judged a bad
window and DISCARDED it — the pipeline's response to those events, not
incorporation of them (``trained_through_event`` on decisions is likewise
the observed-through watermark). Events covered by a REFUSED candidate
stay pending — their freshness keeps growing until a later version ships
them, so gate refusals show up in the p99 instead of vanishing.

Every stage runs under a span (``pipeline.cycle`` > ``pipeline.freeze`` /
``pipeline.gate`` / ``pipeline.publish`` / ``pipeline.revert``), so a slow
publish is attributable from the trace ring (runtime/tracing.py).

**Device.** Everything runs on one device, the registry's: ``device=``
(None: the CUDA device, or a RuntimeError without one) must equal
``registry.device``. The trainer's state, a cold start, a resume, a
revert and the gate's candidate engines all land there, passed
explicitly.

**Copies.** The port's steps update the state in place (core/engine.py),
where JAX arrays are immutable and the reference may keep ``state`` by
reference. So every snapshot the loop keeps is a host COPY: the
revert-on-refuse target (``_publish_snapshot``) is packed and copied, and
freeze writes the live state to disk before the next step runs.

Thread model: one worker thread (``start()``/``stop()``) owns the trainer
state, the stream cursor and the freshness ledger and drives the device;
the registry's batcher threads score on the same device. Everything
shared with other threads (decisions, published versions, counters,
freshness samples) goes through ``self._lock`` — and nothing blocking
ever runs under it. ``RECOVERABLE`` names the injected faults only: any
other error (a CUDA error included) reaches the caller.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field as dc_field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.batch import pad_to_bucket
from ..core.engine import Rule, make_train_step
from ..core.state import init_linear_state
from ..device import DeviceLike, resolve_device
from ..io.checkpoint import (PREV_SUFFIX, load_elastic, pack_linear_state,
                             save_elastic, unpack_linear_state)
from ..models.base import TrainedLinearModel
from ..runtime import faults
from ..runtime.metrics import REGISTRY
from ..runtime.tracing import TRACER
from ..serving import artifact as serving_artifact
from ..serving.engine import ServingEngine
from .gate import EvalGate, GateDecision, score_metrics
from .holdout import RollingHoldout

FAMILY = "pipeline_linear"

# freshness is seconds-scale (train cadence + gate + warm + swap), not the
# serving latency scale — buckets to 300s so a stuck publisher is visible
FRESHNESS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0,
                     120.0, 300.0)


def artifact_frozen(path: str) -> None:
    """No-op hook fired after freeze() lands a candidate artifact — the
    chaos seam mirroring io/checkpoint.checkpoint_written: tests patch it
    to rot the artifact, and the gate's verified reload must refuse to
    publish it (tests/test_pipeline.py)."""


@dataclass
class PipelineConfig:
    """Knobs of one continuous-training loop. ``artifact_root`` holds the
    versioned artifact dirs and (by default) the elastic checkpoint."""

    artifact_root: str
    dims: int
    rule: Rule
    hyper: dict = dc_field(default_factory=dict)
    name: str = "ctr"
    width: int = 8  # stream row nnz (engine width bucket floor)
    freeze_every_events: int = 512
    checkpoint_every_events: int = 256
    holdout_every: int = 8
    holdout_capacity_rows: int = 4096
    regression_tol_logloss: float = 0.005
    min_holdout_rows: int = 64
    rollback_tol_logloss: float = 0.05
    revert_on_refuse: bool = True
    health_check: bool = True
    quantize: Optional[str] = None  # freeze straight to "bf16" / "int8"
    amplify_x: int = 1  # ftvec/amplify multi-epoch substitute
    amplify_buffers: int = 4
    max_restarts: int = 8
    # linear backoff between recoverable restarts (sleep = backoff * n,
    # capped at 1 s): a persistently failing step must not spin the
    # restart path at CPU speed
    restart_backoff_s: float = 0.02
    checkpoint_path: Optional[str] = None
    # the gate's candidate engines (scoring only, never deployed; built on
    # the pipeline's device)
    gate_engine_kwargs: dict = dc_field(
        default_factory=lambda: {"max_batch": 256, "max_width": 32})

    def __post_init__(self):
        if self.checkpoint_path is None:
            # name-scoped: artifacts are already namespaced {name}-v{N},
            # which invites sharing one artifact_root between pipelines —
            # a shared checkpoint file would silently cross-resume them
            self.checkpoint_path = os.path.join(
                self.artifact_root, f"{self.name}_pipeline_ckpt.npz")


class ContinuousPipeline:
    """The publisher state machine over (registry, stream).

    ``stream_fn(i)`` returns observed batch ``i`` as ``(indices [B,K]
    int32, values [B,K] float32, labels [B] float32 in {-1,+1})`` and must
    be a pure function of ``i`` (dataset/lr_datagen.DriftStream.block is
    the reference implementation) — determinism is what makes crash
    recovery a REPLAY instead of data loss.

    ``holdout_stream_fn`` (optional, same contract) supplies the batches
    routed to the gate's holdout ring instead of ``stream_fn`` — the
    "trusted delayed ground truth" pattern: when evaluation labels come
    from a cleaner source than the training log (e.g. settled conversions
    vs the live click stream), a corrupted training window cannot bias
    the gate's ground truth toward the model that learned the corruption.
    Default None: the ring holds the observed stream as-is (label noise
    included — the honest default).

    ``device`` (None: the CUDA device, or a RuntimeError) is where the
    trainer runs and the gate scores; it must be the registry's."""

    RECOVERABLE = (faults.CrashMidWrite, faults.TransientStepError,
                   faults.WorkerLost)

    def __init__(self, registry, stream_fn: Callable[[int], tuple],
                 config: PipelineConfig,
                 holdout_stream_fn: Optional[Callable[[int], tuple]] = None,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        reg_dev = torch.device(registry.device)
        if (reg_dev.type, reg_dev.index or 0) != (self.device.type,
                                                  self.device.index or 0):
            raise ValueError(
                f"the pipeline runs on {self.device} but the registry "
                f"serves on {reg_dev}: both must be one device")
        self.registry = registry
        self.stream_fn = stream_fn
        self.holdout_stream_fn = holdout_stream_fn
        self.cfg = config
        self.gate = EvalGate(config.regression_tol_logloss,
                             config.min_holdout_rows)
        self.holdout = RollingHoldout(config.holdout_capacity_rows,
                                      config.holdout_every)
        self._step = make_train_step(config.rule, dict(config.hyper),
                                     mode="minibatch", device=self.device)
        os.makedirs(config.artifact_root, exist_ok=True)
        self._freshness_hist = REGISTRY.histogram(
            f"pipeline.{config.name}.freshness_seconds", FRESHNESS_BUCKETS)
        self._publishes = REGISTRY.counter("pipeline",
                                           f"{config.name}.publishes")
        self._refusals = REGISTRY.counter("pipeline",
                                          f"{config.name}.refusals")
        self._rollbacks = REGISTRY.counter("pipeline",
                                           f"{config.name}.rollbacks")
        # --- shared surface (any thread), guarded by _lock ---------------
        self._lock = threading.Lock()
        # bounded: a long-lived pipeline must not grow host memory per
        # cycle/batch — /metrics histograms and counters are the
        # unbounded-horizon views; these rings feed status()/lineage()
        # and exact recent-window percentiles
        self._decisions: deque = deque(maxlen=512)
        self._published: List[dict] = []  # oldest..newest; [-1] is live
        self._freshness_samples: deque = deque(maxlen=65536)  # (n, secs)
        self._stats = {"batches": 0, "events": 0, "trained_rows": 0,
                       "replayed_batches": 0,
                       "publishes": 0, "refusals": 0, "rollbacks": 0,
                       "restarts": 0, "restart_causes": [],
                       "checkpoints_written": 0,
                       "freshness_samples": 0, "freshness_events": 0,
                       "running": False, "done": False, "fatal": None}
        # --- worker-confined state (the run() thread only) ---------------
        # bounded: under a persistent gate-refusal pathology nothing
        # drains the ledger — overflow drops the OLDEST pending batches'
        # samples (their freshness was unbounded anyway) instead of
        # growing host memory per batch forever
        self._ledger: deque = deque(maxlen=1 << 17)  # (last_ev, ts, n)
        self._observed_through = -1  # newest event ever ledgered
        self._published_through = -1  # newest event a published model covers
        self._holdout_through = -1  # newest batch index already held out
        self._next_version = 1
        self._events_consumed = 0
        self._last_freeze_events = 0
        self._last_ckpt_events = 0
        self._publish_snapshot: Optional[dict] = None  # host state pack
        self._prev_engine: Optional[tuple] = None  # (version, art, engine)
        self._batch_high = 0  # high-water batch cursor (replay detection)
        self._condemned: set = set()  # versions a rollback has condemned
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self, n_batches: int) -> None:
        """Run the loop on a worker thread (the bench/serving deployment
        shape: traffic threads share the process)."""
        t = threading.Thread(target=self._run_guarded, args=(n_batches,),
                             daemon=True,
                             name=f"pipeline-{self.cfg.name}")
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                raise RuntimeError("pipeline is already running")
            self._thread = t
        self._stop.clear()  # threading.Event is its own synchronization
        t.start()

    def _run_guarded(self, n_batches: int) -> None:
        try:
            self.run(n_batches)
        except Exception as e:  # surfaced via status(), not a dead thread
            with self._lock:
                self._stats["fatal"] = f"{type(e).__name__}: {e}"
                self._stats["running"] = False

    def stop(self, timeout: float = 120.0) -> None:
        """Request a clean stop (the in-flight batch finishes, a final
        checkpoint lands) and wait for the worker. A stop() while nothing
        is running is a no-op — it must not leak into the NEXT run and
        silently truncate it to zero batches."""
        with self._lock:
            running = self._stats["running"]
            t = self._thread
        if running or (t is not None and t.is_alive()):
            self._stop.set()
        if t is not None:
            t.join(timeout)

    def join(self, timeout: Optional[float] = None) -> bool:
        with self._lock:
            t = self._thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    # -- the loop -------------------------------------------------------------

    def run(self, n_batches: int) -> dict:
        """Drive the loop to ``n_batches`` (or stop()), self-healing from
        recoverable faults: each restart reloads the last VALID checkpoint
        (`.prev` fallback on rot) and replays the stream from its
        block_step. Returns status()."""
        # a DIRECT run() (no worker thread) must shed any stale stop flag
        # a racing stop() left behind after the previous run's finally;
        # when run() executes ON the worker thread, start() already
        # cleared it and clearing again would lose a stop() issued
        # between start() and this line
        with self._lock:
            t = self._thread
        if t is None or not t.is_alive():
            self._stop.clear()
        with self._lock:
            self._stats["running"] = True
            self._stats["done"] = False
        try:
            with TRACER.span("pipeline.run",
                             args={"name": self.cfg.name,
                                   "n_batches": int(n_batches)}):
                while True:
                    state, start = self._resume()
                    self._ensure_serving()
                    try:
                        self._loop(state, start, n_batches)
                        break
                    except self.RECOVERABLE as e:
                        with self._lock:
                            self._stats["restarts"] += 1
                            self._stats["restart_causes"].append(
                                type(e).__name__)
                            restarts = self._stats["restarts"]
                        TRACER.instant("pipeline.restart",
                                       args={"cause": type(e).__name__})
                        if restarts > self.cfg.max_restarts:
                            # supervisor give-up: leave the postmortem
                            # artifact (flight recorder) next to the
                            # versioned artifacts BEFORE re-raising —
                            # write_crash_bundle never raises, so the
                            # original exception stays the signal
                            from ..runtime.debug_bundle import \
                                write_crash_bundle

                            write_crash_bundle(
                                os.path.join(
                                    self.cfg.artifact_root,
                                    f"{self.cfg.name}_crash_bundle.json"),
                                reason=(f"pipeline {self.cfg.name!r} gave "
                                        f"up after {restarts} restarts "
                                        f"(last cause: "
                                        f"{type(e).__name__}: {e})"),
                                registry=self.registry)
                            raise
                        time.sleep(min(
                            self.cfg.restart_backoff_s * restarts, 1.0))
        finally:
            with self._lock:
                self._stats["running"] = False
                self._stats["done"] = True
            # a stop() racing completion must not wedge a later run
            self._stop.clear()
        return self.status()

    def _resume(self):
        """(state, start_batch) from the newest valid checkpoint — loud
        ``.prev`` fallback via io/checkpoint.load_elastic — or a cold
        zeroed state. Publisher bookkeeping (version counter, published
        lineage, covered-events watermark) restores from the manifest so a
        FRESH process continues the version sequence instead of restarting
        at v1."""
        cfg = self.cfg
        path = cfg.checkpoint_path
        if not (os.path.exists(path) or os.path.exists(path + PREV_SUFFIX)):
            # true cold start — including a restart after a crash on the
            # very first checkpoint write: the stream replays from 0, so
            # the consumption cursors reset with it (the freshness ledger
            # does NOT — first-observation timestamps are the metric)
            self._events_consumed = 0
            self._last_freeze_events = 0
            self._last_ckpt_events = 0
            state = init_linear_state(
                cfg.dims, use_covariance=cfg.rule.use_covariance,
                slot_names=cfg.rule.slot_names,
                global_names=cfg.rule.global_names, device=self.device)
            return state, 0
        with TRACER.span("pipeline.resume", args={"path": path}):
            arrays, manifest = load_elastic(path)
            if manifest.get("family") != FAMILY:
                raise ValueError(
                    f"checkpoint {path} holds a "
                    f"{manifest.get('family')!r} model; cannot resume it "
                    f"as a {FAMILY} pipeline")
            if int(manifest.get("dims", cfg.dims)) != cfg.dims:
                raise ValueError(
                    f"checkpoint {path} was trained at dims "
                    f"{manifest['dims']} != configured {cfg.dims}")
            state = unpack_linear_state(arrays, device=self.device)
            start = int(manifest.get("block_step", 0))
            self._events_consumed = int(manifest.get("events", 0))
            # the freeze clock persists: resetting it to the checkpoint
            # cadence would slip every later publish by up to a full
            # freeze window after each recovery (and a recurring fault
            # could starve publishes entirely)
            self._last_freeze_events = int(
                manifest.get("last_freeze_events", self._events_consumed))
            self._last_ckpt_events = self._events_consumed
            self._published_through = int(
                manifest.get("published_through", self._published_through))
            self._next_version = max(self._next_version,
                                     int(manifest.get("next_version", 1)))
            self._condemned |= set(manifest.get("condemned", ()))
            with self._lock:
                if not self._published and manifest.get("published"):
                    self._published = list(manifest["published"])
        return state, start

    def _ensure_serving(self) -> None:
        """Cold-start republish: a fresh process resuming a pipeline whose
        registry lost its entries redeploys the last published version, so
        traffic is served from the first batch on."""
        with self._lock:
            last = self._published[-1] if self._published else None
        if last is None or self.registry.get(self.cfg.name) is not None:
            return
        try:
            art = serving_artifact.load(last["path"], verify=True)
        except Exception as e:
            # rotted artifact on disk: keep training, the next gated
            # publish re-establishes serving
            TRACER.instant("pipeline.republish_failed",
                           args={"version": last["version"],
                                 "error": type(e).__name__})
            return
        d = GateDecision(str(last["version"]), True, "resume_republish")
        self._record_decision(d)
        self.registry.deploy(self.cfg.name, art,
                             version=str(last["version"]),
                             lineage=self.lineage())

    def _loop(self, state, start: int, n_batches: int) -> None:
        cfg = self.cfg
        next_batch = start  # the batch a resume would process next
        for i in range(start, n_batches):
            if self._stop.is_set():
                break
            faults.step_hook(i)
            idx, val, lab = self.stream_fn(i)
            b = len(lab)
            last_ev = self._events_consumed + b - 1
            # first-observation timestamps survive replays: a restarted
            # loop re-trains these events but their freshness clock keeps
            # running from when they were FIRST seen
            if last_ev > self._observed_through:
                self._ledger.append((last_ev, time.monotonic(), b))
                self._observed_through = last_ev
            if self.holdout.routes_here(i):
                # a crash-replay re-observes batches the holdout already
                # holds — re-adding would double-weight those rows in
                # every later gate decision (training replays by design;
                # the holdout ring must not)
                if i > self._holdout_through:
                    if self.holdout_stream_fn is not None:
                        hidx, hval, hlab = self.holdout_stream_fn(i)
                        self.holdout.add(hidx, hval, hlab)
                    else:
                        self.holdout.add(idx, val, lab)
                    self._holdout_through = i
            else:
                state = self._train(state, i, idx, val, lab)
            self._events_consumed += b
            ev_now = self._events_consumed  # worker-confined; the locked
            next_batch = i + 1              # surface gets a plain copy
            replayed = i + 1 <= self._batch_high
            self._batch_high = max(self._batch_high, i + 1)
            with self._lock:
                # batches/events report the STREAM CURSOR (they rewind on
                # a restart and re-grow); replays are counted separately
                self._stats["batches"] = i + 1
                self._stats["events"] = ev_now
                if replayed:
                    self._stats["replayed_batches"] += 1
            if ev_now - self._last_freeze_events >= cfg.freeze_every_events:
                state = self._cycle(state, trained_through=last_ev)
                self._last_freeze_events = ev_now
            if (ev_now - self._last_ckpt_events
                    >= cfg.checkpoint_every_events):
                self._checkpoint(state, i + 1)
                self._last_ckpt_events = ev_now
        # final checkpoint: the stream cursor lands exactly where a later
        # run should pick up (stop() mid-run included)
        self._checkpoint(state, next_batch)

    def _train(self, state, i: int, idx, val, lab):
        """One (possibly amplified) training application of batch ``i``.
        ``amplify_x > 1`` replays the batch's rows through ftvec/amplify's
        seeded reservoir shuffle in x same-shape sub-blocks — Hivemall's
        multi-epoch substitute, deterministic per batch index."""
        cfg = self.cfg
        b = len(lab)
        with TRACER.span("pipeline.train", args={"batch": i, "rows": b}):
            if cfg.amplify_x <= 1:
                state, _loss = self._step(state, idx, val, lab)
                trained = b
            else:
                from ..ftvec.amplify import rand_amplify

                order = np.fromiter(
                    rand_amplify(cfg.amplify_x, cfg.amplify_buffers,
                                 range(b), seed=(i * 9_176 + 11) % (2**31)),
                    dtype=np.int64)
                for s in range(0, len(order), b):
                    sel = order[s:s + b]
                    if len(sel) < b:  # reservoir tail: same-shape pad by
                        sel = np.concatenate([sel, sel[:b - len(sel)]])
                    state, _loss = self._step(state, idx[sel], val[sel],
                                              lab[sel])
                trained = cfg.amplify_x * b
        with self._lock:
            self._stats["trained_rows"] += trained
        return state

    # -- freeze -> gate -> publish -> (rollback) ------------------------------

    def _cycle(self, state, trained_through: int):
        cfg = self.cfg
        with TRACER.span("pipeline.cycle",
                         args={"trained_through": int(trained_through)}):
            snapshot = self.holdout.snapshot()
            # the health check scores the live engine on this snapshot;
            # its numbers double as the gate's incumbent metrics below —
            # one predict pass per cycle, not two
            live_metrics = self._maybe_rollback(snapshot) \
                if cfg.health_check else None
            while True:
                version = str(self._next_version)
                self._next_version += 1  # never reused, refused or not
                path = os.path.join(cfg.artifact_root,
                                    f"{cfg.name}-v{version}")
                if not os.path.exists(
                        os.path.join(path, serving_artifact.MANIFEST_FILE)):
                    break
                # a crash between freeze vN and the next checkpoint left
                # vN frozen on disk but the resumed manifest still says
                # next_version=N — artifacts are immutable, so the replay
                # burns the number instead of dying on FileExistsError
                TRACER.instant("pipeline.version_burned",
                               args={"version": version})
            with TRACER.span("pipeline.freeze", args={"version": version}):
                # freeze writes the live tables to disk before the next
                # step can touch them: nothing of the state is kept
                model = TrainedLinearModel(
                    state=state, rule=cfg.rule, dims=cfg.dims,
                    block_width=pad_to_bucket(cfg.width))
                serving_artifact.freeze(model, path, name=cfg.name,
                                        version=version,
                                        quantize=cfg.quantize)
                artifact_frozen(path)
            incumbent = self.registry.get(cfg.name)
            art = None
            with TRACER.span("pipeline.gate", args={"version": version}):
                try:
                    # sha256-verified reload THROUGH the serving path: what
                    # the gate scores is exactly what production would run,
                    # and a rotted artifact refuses here — never published
                    art = serving_artifact.load(path, verify=True)
                    cand = ServingEngine(art, name=f"{cfg.name}-candidate",
                                         device=self.device,
                                         **cfg.gate_engine_kwargs)
                except Exception as e:
                    decision = GateDecision(
                        version, False, "artifact_corrupt",
                        extra={"error": f"{type(e).__name__}: {e}"})
                else:
                    try:
                        decision = self.gate.evaluate(
                            version, cand,
                            incumbent.engine if incumbent else None,
                            snapshot,
                            incumbent_version=incumbent.version
                            if incumbent else None,
                            incumbent_metrics=live_metrics)
                    except Exception as e:
                        # a scoring failure (incumbent predict hiccup,
                        # holdout shape error) is NOT artifact rot — name
                        # it honestly; never publish unmeasured
                        decision = GateDecision(
                            version, False, "gate_error",
                            extra={"error": f"{type(e).__name__}: {e}"})
                decision.trained_through_event = int(trained_through)
                TRACER.instant("pipeline.gate.decision",
                               args={"version": version,
                                     "published": decision.published,
                                     "reason": decision.reason})
            self._record_decision(decision)
            if decision.published:
                with TRACER.span("pipeline.publish",
                                 args={"version": version}):
                    self.registry.deploy(cfg.name, art, version=version,
                                         lineage=self.lineage())
                publish_ts = time.monotonic()
                info = {"version": version, "path": path,
                        "trained_through": int(trained_through),
                        "gate_logloss": decision.candidate_logloss}
                with self._lock:
                    self._published.append(info)
                    self._stats["publishes"] += 1
                self._publishes.increment()
                self._observe_freshness(int(trained_through), publish_ts)
                # host snapshot of the state that passed the gate — the
                # revert-on-refuse target. A copy: on the CPU a pack's
                # arrays share memory with the live tensors, which the
                # next in-place step would rewrite
                self._publish_snapshot = {
                    k: np.array(v, copy=True)
                    for k, v in pack_linear_state(state).items()}
            else:
                with self._lock:
                    self._stats["refusals"] += 1
                self._refusals.increment()
                # quarantine ONLY on a measured regression — the one
                # reason that is evidence the recent TRAINING hurt. An
                # unmeasurable candidate (corrupt artifact, starved
                # holdout, scoring hiccup) says nothing about the update,
                # and discarding a window of good training for it would
                # be pure loss
                if cfg.revert_on_refuse and decision.reason == "regression" \
                        and self._publish_snapshot is not None:
                    with TRACER.span("pipeline.revert",
                                     args={"refused_version": version}):
                        state = unpack_linear_state(self._publish_snapshot,
                                                    device=self.device)
        return state

    def _maybe_rollback(self, snapshot) -> Optional[dict]:
        """Post-publish health: if the LIVE version now regresses past
        ``rollback_tol_logloss`` against the previously-published version
        on the CURRENT holdout, redeploy the previous version (the gate's
        discipline applied retroactively — drift or a bad publish the gate
        missed is bounded by one cycle).

        Returns the score_metrics() of whatever version is live AFTER the
        check (None when nothing was scored) — the same cycle's gate
        reuses it as the incumbent's metrics instead of re-scoring the
        same engine on the same snapshot."""
        cfg = self.cfg
        live = self.registry.get(cfg.name)
        if live is None or snapshot is None \
                or len(snapshot[2]) < cfg.min_holdout_rows:
            return None
        with self._lock:
            if len(self._published) < 2 \
                    or self._published[-1]["version"] != live.version:
                return None
            prior = [dict(p) for p in self._published[:-1]]
        # the nearest prior version that is neither the live one nor one a
        # rollback already condemned — after [v1, v2, rollback-to-v1] the
        # candidate must not be v2, or two versions would ping-pong
        # gate-free forever
        prev = next((p for p in reversed(prior)
                     if p["version"] != live.version
                     and p["version"] not in self._condemned), None)
        if prev is None:
            return None
        idx_rows, val_rows, labels = snapshot
        try:
            # artifacts are immutable: the verified reload + engine build
            # for the previous version is cached by version, so the
            # almost-always-healthy cycle pays scoring only, not a full
            # table read + sha256 + engine construction every time
            if self._prev_engine is not None \
                    and self._prev_engine[0] == prev["version"]:
                prev_art, prev_engine = self._prev_engine[1:]
            else:
                prev_art = serving_artifact.load(prev["path"], verify=True)
                prev_engine = ServingEngine(prev_art,
                                            name=f"{cfg.name}-candidate",
                                            device=self.device,
                                            **cfg.gate_engine_kwargs)
                self._prev_engine = (prev["version"], prev_art, prev_engine)
            live_m = score_metrics(live.engine, idx_rows, val_rows, labels)
            prev_m = score_metrics(prev_engine, idx_rows, val_rows, labels)
        except Exception as e:  # unscoreable previous artifact: no rollback
            TRACER.instant("pipeline.rollback_skipped",
                           args={"error": type(e).__name__})
            return None
        if live_m["logloss"] <= prev_m["logloss"] + cfg.rollback_tol_logloss:
            return live_m
        d = GateDecision(
            str(prev["version"]), True, "rollback",
            holdout_rows=len(labels),
            candidate_logloss=prev_m["logloss"],
            incumbent_logloss=live_m["logloss"],
            incumbent_version=live.version,
            extra={"rolled_back_version": live.version})
        self._record_decision(d)
        with TRACER.span("pipeline.rollback",
                         args={"from": live.version,
                               "to": str(prev["version"])}):
            self.registry.deploy(cfg.name, prev_art,
                                 version=str(prev["version"]),
                                 lineage=self.lineage())
        with self._lock:
            self._published.append(prev)
            self._stats["rollbacks"] += 1
        self._rollbacks.increment()
        self._condemned.add(live.version)
        # the revert-on-refuse target held the state the rollback just
        # condemned — drop it (the artifact lacks optimizer slots, so the
        # previous version's TRAINER state is unrecoverable; refusals
        # fall back to continuing the live trainer until the next publish
        # re-establishes a known-good snapshot)
        self._publish_snapshot = None
        # the rolled-back-to version is live now; its metrics stand as
        # the incumbent's for this cycle's gate
        return prev_m

    # -- freshness ------------------------------------------------------------

    def _observe_freshness(self, through_event: int,
                           publish_ts: float) -> None:
        """Events up to ``through_event`` are now covered by a SERVING
        model: close their ledger entries as end-to-end freshness samples
        (event observed -> the first post-processing publish serving;
        a quarantined window counts as processed-by-discard, see the
        module docstring). Entries already covered by an earlier publish
        are skipped; entries covered only by a REFUSED candidate stayed
        open — their latency kept accruing, which is the honest cost of
        the refusal."""
        while self._ledger and self._ledger[0][0] <= through_event:
            last_ev, ts, n = self._ledger.popleft()
            if last_ev <= self._published_through:
                continue
            f = max(0.0, publish_ts - ts)
            self._freshness_hist.observe(f)
            with self._lock:
                self._freshness_samples.append((n, f))
                self._stats["freshness_samples"] += 1
                self._stats["freshness_events"] += n
        self._published_through = max(self._published_through,
                                      through_event)

    def freshness_percentiles(self, qs=(0.5, 0.99)) -> dict:
        """Event-weighted exact percentiles over the raw-sample ring (the
        last ~65k batch samples — benches fit entirely; for longer
        horizons the /metrics histogram is the always-on view)."""
        with self._lock:
            samples = list(self._freshness_samples)
        if not samples:
            return {f"p{int(q * 100)}": None for q in qs}
        vals = np.asarray([s for _, s in samples], np.float32)
        weights = np.asarray([n for n, _ in samples], np.float32)
        order = np.argsort(vals)
        vals, weights = vals[order], weights[order]
        cum = np.cumsum(weights)
        out = {}
        for q in qs:
            rank = q * cum[-1]
            out[f"p{int(q * 100)}"] = float(vals[np.searchsorted(cum, rank)])
        return out

    # -- bookkeeping ----------------------------------------------------------

    def _checkpoint(self, state, block_step: int) -> None:
        arrays = pack_linear_state(state)
        with self._lock:
            published = [dict(p) for p in self._published]
        manifest = {
            "family": FAMILY, "dims": int(self.cfg.dims),
            "rule": self.cfg.rule.name,
            "block_step": int(block_step),
            "events": int(self._events_consumed),
            "last_freeze_events": int(self._last_freeze_events),
            "published_through": int(self._published_through),
            "next_version": int(self._next_version),
            "published": published,
            # rollback-condemned versions: without persisting these, a
            # restart would forget the ping-pong guard and could redeploy
            # a condemned version gate-free
            "condemned": sorted(self._condemned),
            "step": int(arrays["step"]),
        }
        with TRACER.span("pipeline.checkpoint",
                         args={"block_step": int(block_step)}):
            save_elastic(self.cfg.checkpoint_path, arrays, manifest)
        with self._lock:
            self._stats["checkpoints_written"] += 1

    def _record_decision(self, decision: GateDecision) -> None:
        with self._lock:
            self._decisions.append(decision.as_record())

    def lineage(self, n: int = 20) -> List[dict]:
        """The last ``n`` gate decisions — what deploy() hands /models."""
        with self._lock:
            return [dict(d) for d in list(self._decisions)[-n:]]

    def status(self) -> dict:
        with self._lock:
            st = dict(self._stats)
            st["restart_causes"] = list(st["restart_causes"])
            st["decisions"] = [dict(d) for d in self._decisions]
            st["published_versions"] = [p["version"]
                                        for p in self._published]
        st["holdout_rows"] = self.holdout.rows
        st["freshness"] = self.freshness_percentiles()
        return st
