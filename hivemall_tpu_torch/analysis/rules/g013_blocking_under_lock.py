"""G013 blocking-under-lock: device sync / IO / device dispatch while a lock is held.

On the serving hot path every request handler funnels through a handful
of locks (batcher CV, registry lock, metrics registry). A blocking call
made while one of them is held — a device sync (``torch.cuda.synchronize()``,
``Stream/Event.synchronize()``, a tensor's ``.item()`` or ``.cpu()``),
an engine's ``warmup()`` sweep, a predict or padded run (device
dispatch), CUDA-graph capture, file/socket IO, ``time.sleep``,
``Future.result()`` / ``set_result()`` / ``set_exception()`` (the last
two run done-callbacks synchronously), a thread ``join`` — serializes
every other thread behind that lock: the hot-swap-stall failure mode
where one deploy freezes all in-flight predictions. The tables are in
analysis/config.py (``BLOCKING_*``), with what the type-blind match
costs.

Scope: ``hivemall_tpu_torch/serving/``, ``pipeline/`` and
``runtime/{metrics,timeseries,slo}*`` (the configured hot path) plus
modules opting in with ``# graftcheck: serving-module``. ``cv.wait()`` on
the *held* condition variable is the sanctioned idiom (it releases the
lock) and is never flagged; lock acquisitions under a lock are G016's
subject, not G013's.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from .. import config
from ..concurrency import CallEv, get_model, in_g013_scope
from ..findings import Finding, Severity
from ..program import ProgramModel

RULE_ID = "G013"


def _receiver_lock(dotted: str) -> Optional[str]:
    """The self-lock field name for ``self.X.wait``-shaped callees."""
    parts = dotted.split(".")
    if parts[0] == "self" and len(parts) == 3:
        return parts[1]
    if len(parts) == 2:
        return "@" + parts[0]
    return None


def _blocking_reason(program: ProgramModel, path: str, ev: CallEv
                     ) -> Optional[str]:
    d = ev.dotted
    tail = d.rsplit(".", 1)[-1]
    root = d.split(".", 1)[0]
    if tail == "wait":
        rec = _receiver_lock(d)
        if rec is not None and rec in ev.held:
            return None  # waiting on the held CV releases it: the idiom
        return "a blocking wait() on an object whose lock this thread " \
               "does not hold"
    if tail in ("acquire", "notify", "notify_all", "release"):
        return None  # lock protocol; nesting is G016's subject
    if d == "open":
        return "file IO (open)"
    if tail in config.BLOCKING_DEVICE_TAILS:
        return f"a device synchronization ({tail})"
    if tail in config.BLOCKING_IO_TAILS and root not in \
            config.BLOCKING_SAFE_ROOTS:
        return f"blocking IO ({tail})"
    if "." in d and root not in config.BLOCKING_SAFE_ROOTS:
        if tail in config.BLOCKING_FUTURE_TAILS:
            if tail in ("set_result", "set_exception"):
                return f"Future.{tail}() — done-callbacks run " \
                       f"synchronously on this thread, under the lock"
            if tail == "result":
                return "Future.result() — blocks until another thread " \
                       "completes"
            if tail == "join":
                return "a thread join"
            return f"a blocking rendezvous ({tail})"
        if tail in config.JITTED_ATTR_CALLEES:
            return f"a device step dispatch ({tail})"
    if tail in config.BLOCKING_JIT_TAILS:
        return f"a device dispatch / warm-up trigger ({tail})"
    if "." not in d:
        got = program.resolve_fn(path, d, ev.node)
        if got is not None:
            t_model = program.modules.get(got[0])
            if t_model is not None and got[1] in t_model.traced:
                return f"a call to the traced/jitted function {d}()"
    return None


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    cm = get_model(program)
    seen: Set[Tuple[str, int, str]] = set()

    def flag(path: str, ev: CallEv, reason: str) -> None:
        key = (path, ev.line, reason)
        if key in seen:
            return
        seen.add(key)
        model = program.modules[path]
        locks = sorted(lk.lstrip("@") for lk in ev.held)
        findings.append(Finding(
            path, ev.line, RULE_ID, Severity.ERROR,
            f"{reason} while holding `{'`, `'.join(locks)}` — every thread "
            f"that needs the lock stalls behind this call; move it outside "
            f"the locked region (collect under the lock, act after "
            f"releasing)", model.snippet(ev.line)))

    def sweep(path: str, events) -> None:
        for ev in events:
            if not ev.held:
                continue
            reason = _blocking_reason(program, path, ev)
            if reason is not None:
                flag(path, ev, reason)

    for path in sorted(scanned):
        model = program.modules.get(path)
        if model is None or not in_g013_scope(path, model):
            continue
        for (c_path, _), cls in sorted(cm.classes.items()):
            if c_path == path:
                sweep(path, cls.eff_calls)
        sweep(path, (ev for f_path, _, ev in cm.fn_calls
                     if f_path == path))
    return findings
