"""Failure detection and elastic restart (the port of
``hivemall_tpu/runtime/recovery.py``).

Under synchronous SPMD the failure unit is the JOB: a dead rank breaks the
collectives, the step errors, and recovery is restart-from-checkpoint on
whatever topology survives. The periodic checkpoint holds the COLLAPSED,
stripe-free model (a ``final_state()`` result) plus a manifest of the
striping the run had and a sha256 digest over the payload
(io/checkpoint.save_elastic, the JAX package's format: either package
resumes the other's files). Resume re-stripes N -> M through the trainers'
``init(from_state=...)`` (core.striping.restripe), so a run checkpointed on
4 ranks resumes on 2 or 8.

Usage (a manual training loop, in every rank):

    trainer, state = elastic_resume(AROW, {"r": 0.1}, dims, "ckpt.npz",
                                    family="sharded",
                                    mesh=make_elastic_mesh(devices))
    while blocks:
        state, loss = trainer.step(state, *next_blocks)
        if step % k == 0:
            checkpoint(trainer, state, "ckpt.npz", block_step=step)

Or let ``run_elastic`` drive. The JAX package runs it in one process over a
mesh of that process's devices. The port's ranks are processes
(``parallel/``), so:

- with one device ``run_elastic`` runs the loop in this process, in a
  ``torch.distributed`` world of one (``make_elastic_mesh`` forms it);
- with more it is a SUPERVISOR: each attempt ``parallel.mesh.spawn``s one
  rank per device; every rank builds its trainer with ``make_trainer``
  (which resumes from ``path``), replays ``data_fn`` from the checkpoint's
  ``block_step`` and checkpoints on the cadence. A recoverable failure ends
  the attempt (the failing ranks exit non-zero and ``spawn``'s join
  terminates the rest, so a rank left waiting in the checkpoint's barrier
  does not outlive it); the supervisor shrinks the device list on
  ``WorkerLost`` or keeps it, backs off and respawns. Ranks report their
  outcome — cause, completed and last-checkpointed steps, checkpoints
  written, the faults that fired — in a JSON file each, since
  ``torch.multiprocessing`` carries a rank's exception only as text. A
  device that repeats in ``devices`` makes the world gloo (NCCL refuses
  two ranks on one GPU).

The supervisor keeps the armed ``faults.Injector`` (``faults.inject``
around the call, as in JAX) and hands each attempt only the faults that
have not fired; step faults fire on every rank at the same global step.
SIGTERM is a collective decision: the supervisor's handler raises a flag
file, every rank reads it after each step and takes the MAX over the world,
so every rank checkpoints at the same step and returns.

``make_trainer`` and ``data_fn`` must be importable by name — module-level
functions or ``functools.partial`` of them — because ranks start by
``spawn``. Deviation from the JAX package: in the multi-rank case the
returned ``(trainer, state)`` is ``make_trainer(devices[:1])`` rebuilt in
this process from the final checkpoint (a world of one), so
``trainer.final_state(state)`` is the same collapsed model the ranks
wrote; the ranks' own states die with them.

Restarts are visible in the trace: ``recovery.run_elastic`` (root),
``recovery.restore`` per rebuild, ``train.step`` per step (in the
supervisor's process for a world of one, in each rank's otherwise), the
``recovery.restart`` / ``recovery.preempted`` instants, and the fault
harness's ``fault.injected`` instants (re-stamped by the supervisor for
faults that fired in a rank).

# graftcheck: serving-module
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import tempfile
import threading
import time
import traceback
import warnings
from dataclasses import asdict, is_dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..io.checkpoint import (PREV_SUFFIX, load_elastic, load_linear_state,
                             pack_linear_state, save_elastic,
                             unpack_linear_state)
from ..parallel.mix import MixConfig, MixTrainer
from . import faults
from .tracing import TRACER

FAMILIES = ("mix", "sharded", "sharded_2d", "fm_sharded", "ffm_sharded")

# Linear backoff between elastic restarts (sleep = backoff * restarts,
# capped at 1 s): a persistently failing step must not burn the whole
# max_restarts budget in microseconds or hammer a failing device.
RESTART_BACKOFF_S = 0.02

# The bound on one spawned attempt: its ranks are killed past it.
ATTEMPT_TIMEOUT_S = 600.0

_LINEAR = ("mix", "sharded", "sharded_2d")


def _hyper_jsonable(hyper) -> object:
    """Best-effort record of the run's hyperparameters for the manifest —
    documentation, not the resume source (the caller re-supplies rule and
    hyper, as elastic_resume always required)."""
    if is_dataclass(hyper) and not isinstance(hyper, type):
        hyper = asdict(hyper)
    try:
        json.dumps(hyper)
        return hyper
    except TypeError:  # graftcheck: disable=G028 (hyper is documentation: repr is the documented conversion)
        if isinstance(hyper, dict):
            return {k: v if _is_jsonable(v) else repr(v)
                    for k, v in hyper.items()}
        return repr(hyper)


def _is_jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


# --- family adapters ---------------------------------------------------------


def _family_of(trainer) -> str:
    from ..parallel.sharded_train import (FFMShardedTrainer, FMShardedTrainer,
                                          Sharded2DTrainer, ShardedTrainer)

    if isinstance(trainer, MixTrainer):
        return "mix"
    if isinstance(trainer, ShardedTrainer):
        return "sharded"
    if isinstance(trainer, Sharded2DTrainer):
        return "sharded_2d"
    if isinstance(trainer, FMShardedTrainer):
        return "fm_sharded"
    if isinstance(trainer, FFMShardedTrainer):
        return "ffm_sharded"
    raise TypeError(f"no elastic-checkpoint support for {type(trainer)}")


_FM_FIELDS = ("w0", "w", "v", "lambda_w0", "lambda_w", "lambda_v",
              "touched", "step")
_FFM_FIELDS = ("w0", "w", "z", "n", "v", "v_gg", "touched", "step")


def _pack_fields(host: dict, fields) -> dict:
    """The JAX package's FM / FFM payload: every field a numpy array,
    floats f32, ``touched`` int8, ``step`` an int32 scalar."""
    out = {}
    for k in fields:
        a = np.asarray(host[k])
        out[k] = a.astype(np.int8) if k == "touched" else (
            a.astype(np.int32) if k == "step" else a.astype(np.float32))
    return out


def _striping_manifest(trainer, family: str) -> dict:
    """The re-stripe metadata block: what grid the run was on. Resume does
    not need it to rebuild (the new trainer derives its own grid from its
    mesh); it validates dims and makes a degraded round attributable from
    the file alone."""
    m = {"family": family}
    for attr in ("dims", "dims_padded", "stripe", "n_shards", "n_replicas",
                 "stripe_w", "stripe_v", "nf_padded", "dv_padded"):
        if hasattr(trainer, attr):
            m[attr] = int(getattr(trainer, attr))
    if hasattr(trainer, "mesh"):
        m["n_devices"] = int(np.prod(list(trainer.mesh.shape.values())))
    if family == "sharded":
        m["n_shards"] = m["n_devices"]
    if family == "mix":
        m["n_replicas"] = int(trainer.n_dev)
    rule = getattr(trainer, "rule", None)
    if rule is not None:
        m["rule"] = getattr(rule, "name", repr(rule))
    m["hyper"] = _hyper_jsonable(getattr(trainer, "hyper", None))
    return m


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def checkpoint(trainer, state, path: str,
               block_step: Optional[int] = None) -> dict:
    """Atomically persist the COLLAPSED (mixed, replica-free, stripe-free)
    model — the form any future mesh size resumes from — plus a manifest
    with striping metadata and a payload digest (io/checkpoint.save_elastic:
    write-then-rename, the previous checkpoint rotated to ``.prev``).
    Covers MixTrainer, ShardedTrainer, Sharded2DTrainer, FMShardedTrainer
    and FFMShardedTrainer. ``block_step`` is the loop's completed-step
    count — run_elastic resumes its data stream there.

    A COLLECTIVE: every rank calls it (``final_state`` gathers), rank 0
    writes, and a trailing barrier keeps any rank from acting on "written"
    before the rename completed (the JAX package's multi-process branch).
    Returns the manifest (stamped with digest and format on rank 0)."""
    family = _family_of(trainer)
    manifest = _striping_manifest(trainer, family)
    if block_step is not None:
        manifest["block_step"] = int(block_step)
    merged = trainer.final_state(state)
    manifest["step"] = int(merged.step)
    if _rank() == 0:
        if family in _LINEAR:
            arrays = pack_linear_state(merged)
        elif family == "fm_sharded":
            from ..models.fm import fm_state_to_numpy

            arrays = _pack_fields(fm_state_to_numpy(merged), _FM_FIELDS)
        else:
            from ..models.ffm import ffm_state_to_numpy

            arrays = _pack_fields(ffm_state_to_numpy(merged), _FFM_FIELDS)
        manifest = save_elastic(path, arrays, manifest)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
    return manifest


def peek_manifest(path: str) -> Optional[dict]:
    """The newest valid checkpoint's manifest (falling back to ``.prev``
    like the resume path does), or None when no usable checkpoint exists."""
    try:
        _, manifest = load_elastic(path)
        return manifest
    except Exception:  # graftcheck: disable=G028 (peek probe: None is the documented no-usable-checkpoint answer)
        return None


def _load_for_resume(path: str, family: str):
    """(state, manifest) from the newest valid checkpoint, or (None, None)
    when none exists yet (cold start). The state is host-side: a CPU
    LinearState for the linear families, numpy fields for FM / FFM (the
    trainers' ``init(from_state=...)`` places it). Legacy pre-manifest
    checkpoints (a bare save_linear_state npz) still resume for the linear
    families, falling back — loudly — to a legacy ``.prev`` when the
    newest is unreadable. A checkpoint of another family is a hard
    error."""
    from ..io.checkpoint import NotElasticCheckpoint

    if not (os.path.exists(path) or os.path.exists(path + PREV_SUFFIX)):
        return None, None
    try:
        arrays, manifest = load_elastic(path)
    except NotElasticCheckpoint:
        if family not in _LINEAR:
            raise
        try:
            return load_linear_state(path, device="cpu"), None
        except Exception as e:
            prev = path + PREV_SUFFIX
            if not os.path.exists(prev):
                raise
            warnings.warn(
                f"elastic checkpoint {path} is unusable ({e}); falling "
                f"back to the previous legacy checkpoint {prev} — work "
                "since that checkpoint will be replayed", RuntimeWarning,
                stacklevel=3)
            return load_linear_state(prev, device="cpu"), None
    except FileNotFoundError:
        return None, None
    ck_family = manifest.get("family")
    compatible = (ck_family == family
                  or (ck_family in _LINEAR and family in _LINEAR))
    if not compatible:
        raise ValueError(f"checkpoint {path} holds a {ck_family!r}-family "
                         f"model; cannot resume it as {family!r}")
    if family in _LINEAR:
        return unpack_linear_state(arrays, device="cpu"), manifest
    fields = _FM_FIELDS if family == "fm_sharded" else _FFM_FIELDS
    host = {k: np.asarray(arrays[k]) for k in fields}
    host["step"] = int(host["step"])
    return host, manifest


def elastic_resume(rule, hyper, dims: int, path: str, mesh=None,
                   config: MixConfig = MixConfig(), mode: str = "minibatch",
                   family: str = "mix", **trainer_kwargs):
    """Build a trainer of ``family`` over this rank's mesh (``mesh``, or
    the trainers' default over the initialised world) and seed it from
    the checkpoint at ``path`` if a valid one exists, else from scratch.
    Returns (trainer, state).

    Families: ``mix`` (data-parallel MixTrainer), ``sharded``
    (feature-striped ShardedTrainer), ``sharded_2d`` (replicas x stripes —
    a 2-D mesh or n_replicas / n_shards kwargs), ``fm_sharded`` (hyper is
    an FMHyper; rule ignored), ``ffm_sharded`` (hyper is an FFMHyper; rule
    and dims ignored). The sharded families re-stripe the checkpoint N -> M
    for whatever rank count the mesh has, non-divisible dims included."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; one of {FAMILIES}")
    state, manifest = _load_for_resume(path, family)
    if manifest is not None and "dims" in manifest \
            and family != "ffm_sharded" and int(manifest["dims"]) != dims:
        raise ValueError(
            f"checkpoint {path} was trained at dims {manifest['dims']} != "
            f"requested {dims}; resume with the dims the model was trained "
            "at")
    if family == "mix":
        trainer = MixTrainer(rule, hyper, dims, mesh, config, mode=mode)
    else:
        from ..parallel.sharded_train import (FFMShardedTrainer,
                                              FMShardedTrainer,
                                              Sharded2DTrainer,
                                              ShardedTrainer)

        if family == "sharded":
            trainer = ShardedTrainer(rule, hyper, dims, mesh, mode=mode,
                                     **trainer_kwargs)
        elif family == "sharded_2d":
            trainer = Sharded2DTrainer(rule, hyper, dims, mesh, config=config,
                                       mode=mode, **trainer_kwargs)
        elif family == "fm_sharded":
            trainer = FMShardedTrainer(hyper, dims, mesh, mode=mode,
                                       **trainer_kwargs)
        else:
            trainer = FFMShardedTrainer(hyper, mesh, mode=mode,
                                        **trainer_kwargs)
    # the manifest this resume loaded (None on cold start or a legacy
    # checkpoint): run_elastic reads it instead of re-loading the payload
    trainer._elastic_manifest = manifest
    return trainer, trainer.init(from_state=state)


def make_elastic_mesh(devices: Sequence, n_devices: Optional[int] = None):
    """The default mesh rebuild for run_elastic factories: a 1-D mesh over
    exactly ``devices``, one per rank, this rank's tensors on
    ``devices[rank]``. In a process with no world yet (run_elastic's world
    of one, the supervisor's final rebuild) it forms a world of one on
    ``devices[0]`` (NCCL on a GPU, gloo on the CPU); the world stays for
    the trainer's collectives."""
    from ..parallel.mesh import init_distributed, make_mesh

    devices = [torch.device(d) for d in devices]
    if not dist.is_initialized():
        if len(devices) != 1:
            raise ValueError(
                f"a mesh over {len(devices)} devices spans {len(devices)} "
                "ranks: call this inside each rank (run_elastic spawns "
                "them)")
        init_distributed(device=devices[0])
    if dist.get_world_size() != len(devices):
        raise ValueError(f"{len(devices)} devices for a world of "
                         f"{dist.get_world_size()}")
    return make_mesh(n_devices=n_devices or len(devices),
                     device=devices[dist.get_rank()])


# --- the elastic training loop -----------------------------------------------

_PEEK = object()  # "factory did not come through elastic_resume" sentinel


def _restore(make_trainer, devices, path):
    """make_trainer(devices) and the step its data stream resumes at, with
    JAX's warning when an existing checkpoint carries no block_step."""
    with TRACER.span("recovery.restore",
                     args={"devices": len(devices)}) as sp:
        trainer, state = make_trainer(devices)
        manifest = getattr(trainer, "_elastic_manifest", _PEEK)
        if manifest is _PEEK:
            manifest = peek_manifest(path)
        start = int((manifest or {}).get("block_step", 0))
        if manifest is not None and "block_step" not in manifest \
                or manifest is None and (
                    os.path.exists(path)
                    or os.path.exists(path + PREV_SUFFIX)):
            warnings.warn(
                f"checkpoint at {path} carries no block_step — run_elastic "
                "will replay the data stream from step 0 on top of the "
                "seeded state (examples applied twice). Stamp checkpoints "
                "via run_elastic or checkpoint(..., block_step=...) to "
                "resume the stream where it stopped", RuntimeWarning,
                stacklevel=3)
        if sp is not None and hasattr(sp, "args"):
            sp.args["resumed_step"] = start
    return trainer, state, start


def run_elastic(make_trainer: Callable[[Sequence], Tuple[object, object]],
                data_fn: Callable[[object, int], tuple], n_steps: int,
                path: str, *, checkpoint_every: int = 8,
                max_restarts: int = 4,
                devices: Optional[Sequence] = None,
                recoverable: Optional[Tuple[type, ...]] = None,
                min_devices: int = 1) -> Tuple[object, object, dict]:
    """Worker-loss-tolerant training loop: run ``n_steps`` training steps with a
    checkpoint every ``checkpoint_every``, and on any recoverable step
    failure rebuild over the surviving devices and resume from the last
    valid checkpoint, replaying the steps since it.

    - ``devices``: one ``torch.device`` per rank (None: every CUDA device,
      raising without one). One device runs in this process; more run as
      spawned ranks under this process as supervisor (module docstring).
    - ``make_trainer(devices) -> (trainer, state)``: build the family over
      a mesh on exactly these devices and seed from ``path`` — typically
      ``elastic_resume(..., mesh=make_elastic_mesh(devices))``. A
      ``faults.WorkerLost`` shrinks the device list before the rebuild;
      any other recoverable error retries the same topology.
    - ``data_fn(trainer, i) -> step-args tuple`` for loop step ``i`` —
      the deterministic data stream, replayed after a restart from the
      checkpoint's ``block_step``.

    Preemption-aware: a SIGTERM handler (main thread only) makes the run
    checkpoint right after the in-flight step and return with
    ``report["preempted"] = True`` and ``report["preempted_at_step"]``; the
    previous handler is restored on exit.

    Returns ``(trainer, state, report)``; the report carries restarts,
    per-restart causes, lost (replayed) steps, checkpoints written,
    recovery seconds (rebuild time after a failure or a checkpoint: for
    spawned ranks from the attempt's start to rank 0's rebuilt trainer,
    spawn and rendezvous included), the preemption flag and the device
    counts — the JAX package's keys."""
    if recoverable is None:
        recoverable = (faults.WorkerLost, faults.TransientStepError,
                       faults.CrashMidWrite)
    if devices is None:
        from ..serving.placement import _cuda_devices

        devices = _cuda_devices()
    devices = [torch.device(d) for d in devices]
    report = {"restarts": 0, "causes": [], "lost_steps": 0,
              "checkpoints_written": 0, "recovery_s": 0.0,
              "preempted": False,
              "initial_devices": len(devices), "final_devices": len(devices)}
    term = threading.Event()
    work = None
    if len(devices) > 1:
        work = tempfile.mkdtemp(prefix=os.path.basename(path) + ".elastic.",
                                dir=os.path.dirname(os.path.abspath(path)))
    flag = None if work is None else os.path.join(work, "preempt")

    def on_term(signum, frame):
        term.set()
        if flag is not None:
            with open(flag, "w"):
                pass

    prev_handler = None
    if threading.current_thread() is threading.main_thread():
        try:
            prev_handler = signal.signal(signal.SIGTERM, on_term)
        except ValueError:  # embeddings where signal still refuses
            prev_handler = None
    try:
        with TRACER.span("recovery.run_elastic",
                         args={"n_steps": int(n_steps), "path": path,
                               "devices": len(devices)}):
            if work is None:
                return _run_in_process(make_trainer, data_fn, n_steps, path,
                                       checkpoint_every, max_restarts,
                                       devices, recoverable, min_devices,
                                       report, term)
            return _supervise(make_trainer, data_fn, n_steps, path,
                              checkpoint_every, max_restarts, devices,
                              recoverable, min_devices, report, work, flag)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        if work is not None:
            shutil.rmtree(work, ignore_errors=True)


def _give_up(path: str, report: dict, cause: str, message: str,
             devices: int, step: int) -> None:
    """Drop the flight-recorder bundle next to the checkpoint (never
    raises: the fatal exception stays the signal)."""
    from .debug_bundle import write_crash_bundle

    write_crash_bundle(
        path + ".crash_bundle.json",
        reason=(f"run_elastic gave up after {report['restarts']} restarts "
                f"(last cause: {cause}: {message}; devices={devices}, "
                f"step={step})"))


def _shrink(devices, n_lost: int, min_devices: int):
    survivors = devices[: max(min_devices, len(devices) - n_lost)]
    if len(survivors) == len(devices) and len(devices) > min_devices:
        survivors = devices[:-1]
    return survivors


def _train(trainer, state, start: int, n_steps: int, path: str,
           every: int, data_fn, preempted, progress: dict):
    """One attempt's steps ``start..n_steps`` with the checkpoint cadence,
    the loop every run_elastic attempt runs (in this process or in a
    rank). ``progress`` tracks ``completed`` (steps whose update landed),
    ``last_ckpt`` and ``ckpts`` (checkpoints written) as they happen, so a
    failure mid-attempt leaves them exact. ``preempted()`` is read after
    each step: on True the completed step is checkpointed at once and the
    attempt ends. Returns (state, preempted)."""
    for i in range(start, n_steps):
        faults.step_hook(i)
        with TRACER.span("train.step", args={"step": i}):
            state, _ = trainer.step(state, *data_fn(trainer, i))
        progress["completed"] = i + 1
        if preempted():
            checkpoint(trainer, state, path, block_step=i + 1)
            progress["ckpts"] += 1
            return state, True
        if (i + 1) % every == 0:
            checkpoint(trainer, state, path, block_step=i + 1)
            progress["ckpts"] += 1
            progress["last_ckpt"] = i + 1
    if n_steps % every != 0 or n_steps == 0:
        checkpoint(trainer, state, path, block_step=n_steps)
        progress["ckpts"] += 1
    return state, False


def _run_in_process(make_trainer, data_fn, n_steps, path, checkpoint_every,
                    max_restarts, devices, recoverable, min_devices, report,
                    term):
    """The JAX package's loop, in this process (a world of one)."""
    while True:
        t0 = time.monotonic()
        trainer, state, start = _restore(make_trainer, devices, path)
        if report["restarts"] or report["checkpoints_written"]:
            report["recovery_s"] += time.monotonic() - t0
        progress = {"completed": start, "last_ckpt": start, "ckpts": 0}
        try:
            state, preempted = _train(trainer, state, start, n_steps, path,
                                      checkpoint_every, data_fn,
                                      term.is_set, progress)
        except recoverable as e:
            report["checkpoints_written"] += progress["ckpts"]
            completed = progress["completed"]
            report["restarts"] += 1
            # every completed-but-not-checkpointed step is replayed
            report["lost_steps"] += max(0, completed - progress["last_ckpt"])
            report["causes"].append({"type": type(e).__name__,
                                     "step": completed,
                                     "devices": len(devices)})
            if report["restarts"] > max_restarts:
                _give_up(path, report, type(e).__name__, str(e),
                         len(devices), completed)
                raise
            time.sleep(min(RESTART_BACKOFF_S * report["restarts"], 1.0))
            if isinstance(e, faults.WorkerLost):
                devices = _shrink(devices, e.n_lost, min_devices)
            TRACER.instant("recovery.restart",
                           args={"cause": type(e).__name__,
                                 "devices": len(devices)})
            continue
        report["checkpoints_written"] += progress["ckpts"]
        report["final_devices"] = len(devices)
        if preempted:
            # SIGTERM: the completed step is checkpointed; control goes
            # back inside the grace period
            report["preempted"] = True
            report["preempted_at_step"] = progress["completed"]
            TRACER.instant("recovery.preempted",
                           args={"step": progress["completed"]})
        return trainer, state, report


# --- the spawned ranks --------------------------------------------------------


def _preempt_agreed(flag: str, trainer) -> bool:
    """Every rank's view of the preempt flag, MAX-reduced over the world:
    all ranks stop at the same step or none does."""
    dev = trainer.mesh.device if dist.get_backend() == "nccl" \
        else torch.device("cpu")
    x = torch.tensor([1.0 if os.path.exists(flag) else 0.0], device=dev)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return bool(x.item() > 0)


def _write_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


def _elastic_rank(rank: int, world: int, cfg: dict) -> None:
    """One rank of one supervised attempt (module docstring): restore,
    replay, checkpoint on the cadence; report to ``rank<r>.json``; a
    failure re-raises so the attempt ends."""
    import contextlib

    devices = [torch.device(d) for d in cfg["devices"]]
    res = {"rank": rank, "status": "error", "completed": None,
           "last_ckpt": None, "ckpts": 0}
    plan = cfg["plan"]
    armed = faults.inject(plan) if plan is not None \
        else contextlib.nullcontext()
    with armed as inj:
        if inj is not None:
            inj._done.update(cfg["done"])
            inj._writes = cfg["writes"]
        try:
            trainer, state, start = _restore(cfg["make_trainer"], devices,
                                             cfg["path"])
            res.update(restored_at=time.time(), completed=start,
                       last_ckpt=start)
            _, preempted = _train(
                trainer, state, start, cfg["n_steps"], cfg["path"],
                cfg["checkpoint_every"], cfg["data_fn"],
                lambda: _preempt_agreed(cfg["flag"], trainer), res)
            res["status"] = "preempted" if preempted else "done"
        except cfg["recoverable"] as e:
            res.update(status="failed", cause=type(e).__name__,
                       message=str(e), n_lost=getattr(e, "n_lost", 1))
            raise
        except BaseException as e:
            res.update(status="error", cause=type(e).__name__,
                       message=traceback.format_exc())
            raise
        finally:
            if inj is not None:
                res.update(fired=inj.fired, done=sorted(inj._done),
                           writes=inj._writes)
            _write_json(os.path.join(cfg["dir"], f"rank{rank}.json"), res)


def _read_outcome(attempt_dir: str, world: int) -> Optional[dict]:
    """Rank 0's report (the only writer of checkpoint files), else the
    first rank's that exists."""
    for r in range(world):
        p = os.path.join(attempt_dir, f"rank{r}.json")
        if os.path.exists(p):
            with open(p, encoding="utf-8") as fh:
                return json.load(fh)
    return None


def _rebuilt(recoverable, res: dict) -> BaseException:
    """The rank's recoverable exception, rebuilt from its report."""
    for cls in tuple(recoverable) + (faults.WorkerLost,):
        if cls.__name__ == res["cause"]:
            if issubclass(cls, faults.WorkerLost):
                return cls(n_lost=res["n_lost"], step=res["completed"])
            try:
                return cls(res["message"])
            except TypeError:  # graftcheck: disable=G028 (not degraded: a constructor without a message argument; the RuntimeError below names the cause and the message, and the caller raises it)
                break
    return RuntimeError(f"{res['cause']}: {res['message']}")


def _supervise(make_trainer, data_fn, n_steps, path, checkpoint_every,
               max_restarts, devices, recoverable, min_devices, report, work,
               flag):
    from ..parallel.mesh import spawn

    injector = faults.active()
    attempt = 0
    while True:
        attempt += 1
        adir = os.path.join(work, f"attempt{attempt}")
        os.makedirs(adir)
        cfg = {"make_trainer": make_trainer, "data_fn": data_fn,
               "n_steps": int(n_steps), "path": path,
               "checkpoint_every": int(checkpoint_every),
               "devices": [str(d) for d in devices],
               "recoverable": tuple(recoverable), "flag": flag, "dir": adir,
               "plan": None if injector is None else injector.plan,
               "done": [] if injector is None else sorted(injector._done),
               "writes": 0 if injector is None else injector._writes}
        # NCCL refuses two ranks on one GPU
        backend = "gloo" if len(set(devices)) < len(devices) else None
        t0 = time.time()
        try:
            # ranks on the CPU share its cores: one thread each
            spawn(_elastic_rank, len(devices), (cfg,),
                  init_file=os.path.join(adir, "rendezvous"),
                  backend=backend, device=devices,
                  threads=1 if devices[0].type == "cpu" else None,
                  timeout=ATTEMPT_TIMEOUT_S)
            failure = None
        except Exception as e:  # graftcheck: disable=G031 (a rank failed: its report says how; the loop is capped below, giving up and raising past max_restarts restarts, and sleeps min(RESTART_BACKOFF_S * restarts, 1 s) before each restart)
            failure = e
        res = _read_outcome(adir, len(devices))
        if res is None:
            raise RuntimeError(f"elastic attempt {attempt} on "
                               f"{len(devices)} ranks ended before any "
                               f"rank reported") from failure
        if injector is not None and "done" in res:
            injector._done.update(res["done"])
            injector._writes = res["writes"]
            for rec in res["fired"]:  # this attempt's
                injector.fired.append(rec)
                TRACER.instant("fault.injected", args=rec)
        if "restored_at" in res and (report["restarts"]
                                     or report["checkpoints_written"]):
            report["recovery_s"] += max(0.0, res["restored_at"] - t0)
        report["checkpoints_written"] += int(res["ckpts"])
        if res["status"] == "done" and failure is None:
            report["final_devices"] = len(devices)
            break
        if res["status"] == "preempted" and failure is None:
            report["preempted"] = True
            report["preempted_at_step"] = int(res["completed"])
            report["final_devices"] = len(devices)
            TRACER.instant("recovery.preempted",
                           args={"step": int(res["completed"])})
            break
        if res["status"] != "failed":
            raise RuntimeError(
                f"elastic attempt {attempt}: rank {res['rank']} failed "
                f"unrecoverably:\n{res.get('message')}") from failure
        completed = int(res["completed"])
        report["restarts"] += 1
        report["lost_steps"] += max(0, completed - int(res["last_ckpt"]))
        report["causes"].append({"type": res["cause"], "step": completed,
                                 "devices": len(devices)})
        if report["restarts"] > max_restarts:
            _give_up(path, report, res["cause"], res["message"],
                     len(devices), completed)
            raise _rebuilt(recoverable, res) from failure
        time.sleep(min(RESTART_BACKOFF_S * report["restarts"], 1.0))
        if res["cause"] == faults.WorkerLost.__name__:
            devices = _shrink(devices, int(res["n_lost"]), min_devices)
        TRACER.instant("recovery.restart",
                       args={"cause": res["cause"],
                             "devices": len(devices)})
    # the ranks' states died with them: rebuild the collapsed model here
    trainer, state, _ = _restore(make_trainer, devices[:1], path)
    return trainer, state, report
