"""Multi-model registry with atomic hot-swap + the /predict HTTP endpoint.

The port of the JAX package's `serving/server.py`. The registry keeps one
``(engine, batcher)`` pair per model name; ``deploy()`` builds and WARMS the
new version off to the side, then publishes it with one dict assignment
(atomic under the GIL — readers see either the old or the new entry, never
a partial one) and drains the old batcher so every request admitted before
the swap still completes: an in-flight v1 -> v2 swap fails zero requests.

HTTP surface (layered on runtime/metrics_http.py — same process, one port):

- ``POST /predict``  body ``{"model": name?, "instances": [...]}`` ->
  ``{"model", "version", "predictions": [...]}``. Requests may carry an
  ``x-priority`` header (high/normal/low, or body key ``priority``) and an
  ``x-deadline-ms`` budget (or body key ``deadline_ms``); a request that
  expires in the queue gets **504** (``reason: deadline``), an over-quota
  or shed request gets **503 + Retry-After** (``reason: quota`` /
  ``shed``); 404 unknown model, 400 bad payload. A client ``traceparent``
  header (W3C) is adopted as the request trace's root parent and echoed
  back on every response;
- ``POST /topk``     body ``{"model": name?, "queries": [...], "k"?,
  "probe"?}`` -> ``{"model", "version", "k", "results": [{"items",
  "scores"}, ...]}``. The top-K retrieval surface (serving/retrieval.py)
  — deploy() must have been given ``retrieval=`` options for the model
  (400 otherwise). Same priority/deadline/traceparent contract and error
  mapping as /predict, through the model's SEPARATE retrieval batcher;
- ``GET /models``    registry listing (name, version, family, dtype,
  table bytes, admission and placement state, and the publisher's
  lineage: the gate decisions a continuous pipeline deployed it with);
- ``GET /healthz``   overload-aware: reports ``degraded`` (still 200 —
  alive, shedding predictably) when any model's queue passes the depth
  threshold or an SLO pages (runtime/slo.py; the ``slo`` block); device
  fields from torch;
- ``GET /metrics`` / ``GET /trace?n=`` / ``GET /slo`` /
  ``GET /debug/bundle?n=`` — inherited from metrics_http (the bundle
  describes this server's registry).
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from ..runtime import metrics_http
from ..runtime.metrics import REGISTRY
from ..runtime.tracing import TRACER
from .admission import (PRIORITY_NAMES, DeadlineExpired, priority_class,
                        priority_name)
from .batcher import BatcherClosed, DynamicBatcher, QueueFull
from .engine import ServingEngine


class ModelEntry:
    """One deployed model version: engine + its batching front."""

    def __init__(self, name: str, version: str, engine: ServingEngine,
                 batcher: DynamicBatcher,
                 lineage: Optional[list] = None, cache=None,
                 retrieval_engine=None,
                 retrieval_batcher: Optional[DynamicBatcher] = None) -> None:
        self.name = name
        self.version = version
        self.engine = engine
        self.batcher = batcher
        # the hot-row score cache this entry's batcher fronts with —
        # owned by the REGISTRY and shared across this name's versions
        # (the version lives in the key; serving/cache.py). None = off.
        self.cache = cache
        # the top-K retrieval surface (serving/retrieval.py): present only
        # when deploy() was given ``retrieval=`` options and the family is
        # MF/FM. Its batcher is separate from the pointwise one, so a /topk
        # flood never takes /predict's dispatch slots
        self.retrieval_engine = retrieval_engine
        self.retrieval_batcher = retrieval_batcher
        self.deployed_unix = time.time()
        # version lineage: the publisher's recent gate decisions (publish /
        # refusal / rollback records, pipeline/loop.py) surfaced on
        # /models, so "why is v7 serving and where did v6 go" is
        # answerable from the serving endpoint alone. Immutable after
        # deploy.
        self.lineage = list(lineage or [])

    def close(self) -> None:
        """Drain and close this version's batchers."""
        self.batcher.close(drain=True)
        if self.retrieval_batcher is not None:
            self.retrieval_batcher.close(drain=True)

    def describe(self) -> dict:
        return {
            "name": self.name,
            "version": self.version,
            "family": self.engine.family,
            "deployed_unix": self.deployed_unix,
            "max_batch": self.engine.max_batch,
            "max_width": self.engine.max_width,
            # the precision surface: the dtype the tables serve at and the
            # resident bytes a request's gathers read (also the gauges
            # serving.<name>.table_bytes / .weights_bits on /metrics)
            "weights_dtype": self.engine.weights_dtype,
            "table_bytes": self.engine.table_bytes,
            "device": str(self.engine.device),
            "placement": self.engine.placement,
            # the overload surface: queue depth per priority class, quota
            # fractions, live AIMD window, drain-rate estimate and
            # shed/expiry/quota-reject counters
            "admission": self.batcher.overload_state(),
            # the hot-row cache surface: budget, resident bytes, hit/miss/
            # coalesced/evicted counters and the live hit ratio
            "cache": self.cache.stats() if self.cache is not None
            else {"enabled": False},
            # publisher lineage: recent gate decisions for this model's
            # version sequence (empty for hand-deployed models)
            "lineage": [dict(d) for d in self.lineage],
            # the top-K surface: catalog size, block/K geometry, index.
            # {"enabled": False} = /topk answers 400 for this model
            "retrieval": {"enabled": True,
                          **self.retrieval_engine.describe()}
            if self.retrieval_engine is not None else {"enabled": False},
        }


class ModelRegistry:
    """name -> ModelEntry with atomic version swap.

    Every model deploys on the registry's ``device`` (None: the CUDA
    device, or a RuntimeError when there is none; "cpu" only when asked).
    Reads (`get`) are lock-free dict lookups; writes serialize on a lock.
    A handler thread holds the ENTRY it resolved, not the name, so a swap
    never invalidates an in-flight request — the old batcher drains.
    """

    # serving-grade admission defaults: low-priority work quota-sheds at
    # 60% queue fill, normal at 85%, high keeps headroom to the cap;
    # adaptive caps stay equal to the bases (off) unless configured
    DEFAULT_QUOTA_FRACS = (1.0, 0.85, 0.6)

    def __init__(self, *, max_batch: int = 256, max_delay_ms: float = 2.0,
                 max_queue_rows: int = 4096, warmup: bool = True,
                 engine_kwargs: Optional[dict] = None,
                 max_delay_ms_cap: Optional[float] = None,
                 max_batch_cap: Optional[int] = None,
                 priority_quota_fracs: Optional[tuple] = None,
                 starvation_limit: int = 8,
                 express_high: bool = True,
                 degraded_depth_fraction: float = 0.75,
                 score_cache_bytes: Optional[int] = None,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self._entries: Dict[str, ModelEntry] = {}
        self._lock = threading.Lock()
        # hot-row score caches, one per model NAME, shared across that
        # name's versions (the version is in every key, so a hot-swap
        # invalidates atomically and old-version entries age out of the
        # byte budget — serving/cache.py). ``score_cache_bytes`` is the
        # registry-wide default budget; None/0 leaves caching OFF, a
        # deploy can override per model.
        self._caches: Dict[str, object] = {}
        self.score_cache_bytes = score_cache_bytes
        self.max_batch = max_batch
        self.max_delay_ms = max_delay_ms
        self.max_queue_rows = max_queue_rows
        self.warmup = warmup
        self.engine_kwargs = dict(engine_kwargs or {})
        self.max_delay_ms_cap = max_delay_ms_cap
        self.max_batch_cap = max_batch_cap
        self.priority_quota_fracs = tuple(
            priority_quota_fracs or self.DEFAULT_QUOTA_FRACS)
        self.starvation_limit = starvation_limit
        # high-priority requests get a dedicated drain lane by default
        self.express_high = express_high
        # /healthz flips to "degraded" when any model's queue fills past
        # this fraction
        self.degraded_depth_fraction = float(degraded_depth_fraction)
        self._swaps = REGISTRY.counter("serving", "registry.swaps")

    def deploy(self, name: str, source, version: Optional[str] = None,
               batcher_overrides: Optional[dict] = None,
               lineage: Optional[list] = None,
               score_cache_bytes: Optional[int] = None,
               retrieval: Optional[dict] = None,
               **engine_overrides) -> ModelEntry:
        """Deploy `source` (artifact dir path, Artifact, or trained model)
        as `name` on the registry's device; replaces any current version
        atomically AFTER the new engine is fully warmed. The version
        defaults to the artifact's manifest version; bare model objects
        auto-increment. ``batcher_overrides`` tunes this model's admission
        posture over the registry defaults. ``retrieval`` (a dict of
        RetrievalEngine kwargs, ``{}`` for the defaults) also stands up the
        top-K surface for this model — MF/FM only — on the registry's
        device, warmed, behind its OWN DynamicBatcher (``POST /topk``);
        None (default) means /topk answers 400 for this model.
        ``lineage`` attaches the publisher's gate-decision records to the
        entry (surfaced on /models; the continuous pipeline passes its
        recent publish / refusal / rollback history here).
        ``score_cache_bytes`` overrides the registry's hot-row cache
        budget for this model (None inherits the registry default — or,
        failing that, whatever cache an earlier deploy enabled for this
        name; an explicit 0 disables); the cache OBJECT persists across
        this name's versions — swap invalidation is the version key, not
        a flush."""
        from .artifact import Artifact, load as load_artifact

        if isinstance(source, str):
            source = load_artifact(source)
        if version is None and isinstance(source, Artifact):
            version = source.manifest.get("version")
        kw = dict(self.engine_kwargs)
        kw.update(engine_overrides)
        kw.setdefault("max_batch", self.max_batch)
        kw.setdefault("device", self.device)
        engine = ServingEngine(source, name=name, **kw)
        if version is None:
            with self._lock:
                old = self._entries.get(name)
            version = str(int(old.version) + 1) if old is not None \
                and old.version.isdigit() else "1"
        if self.warmup:
            engine.warmup()
        bkw = dict(max_batch=engine.max_batch,
                   max_delay_ms=self.max_delay_ms,
                   max_queue_rows=self.max_queue_rows,
                   max_delay_ms_cap=self.max_delay_ms_cap,
                   max_batch_cap=self.max_batch_cap,
                   priority_quota_fracs=self.priority_quota_fracs,
                   starvation_limit=self.starvation_limit,
                   express_high=self.express_high)
        bkw.update(batcher_overrides or {})
        cache_bytes = self.score_cache_bytes if score_cache_bytes is None \
            else score_cache_bytes
        cache = None
        if cache_bytes:
            from .cache import ScoreCache

            with self._lock:
                cache = self._caches.get(name)
                if cache is None or cache.max_bytes != int(cache_bytes):
                    cache = ScoreCache(int(cache_bytes), name=name)
                    self._caches[name] = cache
        elif score_cache_bytes is not None:
            with self._lock:  # explicit 0: caching OFF for this name
                self._caches.pop(name, None)
        else:
            # no override and no registry default: a cache an earlier
            # deploy enabled for this name SURVIVES the redeploy — the
            # object persisting across versions is the hot-swap story
            # (old-version entries age out of the byte budget)
            with self._lock:
                cache = self._caches.get(name)
        r_engine = r_batcher = None
        if retrieval is not None:
            from .retrieval import RetrievalEngine

            rkw = dict(retrieval)
            if kw.get("placement") is not None:
                rkw.setdefault("placement", kw.get("placement"))
            rkw.setdefault("device", self.device)
            r_engine = RetrievalEngine(source, name=name, **rkw)
            if self.warmup:
                r_engine.warmup()
            # no score cache / row keys: a top-K row is (query, k, probe)
            # and its result a ranking, not a score — the hot-row cache's
            # single-score contract doesn't apply
            r_batcher = DynamicBatcher(r_engine.topk_batch,
                                       name=f"{name}.topk",
                                       **{**bkw,
                                          "max_batch": r_engine.max_batch})
        batcher = DynamicBatcher(engine.predict, name=name, cache=cache,
                                 cache_version=str(version),
                                 row_key_fn=engine.row_keys, **bkw)
        entry = ModelEntry(name, str(version), engine, batcher,
                           lineage=lineage, cache=cache,
                           retrieval_engine=r_engine,
                           retrieval_batcher=r_batcher)
        with self._lock:
            old = self._entries.get(name)
            self._entries[name] = entry  # the atomic publish
        if old is not None:
            self._swaps.increment()
            # outside the lock: draining can take max_delay + a batch
            old.close()
        REGISTRY.set_gauge(f"serving.{name}.deployed_version",
                           float(version) if str(version).isdigit() else 0.0)
        return entry

    def get(self, name: Optional[str] = None) -> Optional[ModelEntry]:
        """Resolve a model by name; with one deployed model, name may be
        omitted (the single-model convenience)."""
        if name is not None:
            # designed lock-free read: a single dict .get() is atomic under
            # the GIL and deploy() publishes entries with one assignment —
            # readers see the old or new entry, never a partial one
            return self._entries.get(name)  # graftcheck: disable=G012 (reviewed lock-free read)
        with self._lock:  # a concurrent first deploy mutates the dict
            entries = list(self._entries.values())
        if len(entries) == 1:
            return entries[0]
        return None

    # each BatcherClosed means a full deploy landed between resolve and
    # submit; needing this many consecutive swaps inside one submit window
    # is not a reachable steady state
    _SWAP_RETRIES = 8

    def submit(self, name: Optional[str], instances, *,
               priority="normal", deadline_ms: Optional[float] = None):
        """Resolve + enqueue, retrying across hot swaps: a caller that
        resolved the OLD entry right before deploy() published the new one
        sees BatcherClosed from the draining batcher — re-resolving gets
        the new version, so a swap fails zero requests. Returns
        (entry, future); (None, None) means the name is unknown. QueueFull
        propagates (the caller's 503); BatcherClosed escapes only after
        _SWAP_RETRIES consecutive swap collisions (retryable, also 503)."""
        for _ in range(self._SWAP_RETRIES):
            entry = self.get(name)
            if entry is None:
                return None, None
            try:
                return entry, entry.batcher.submit(
                    instances, priority=priority, deadline_ms=deadline_ms)
            except BatcherClosed:  # graftcheck: disable=G031 (retry rebinds to the NEW batcher; waiting adds only latency)
                continue
        raise BatcherClosed(
            f"model {name!r}: {self._SWAP_RETRIES} consecutive version "
            f"swaps collided with this submit — retry")

    def submit_topk(self, name: Optional[str], rows, *,
                    priority="normal", deadline_ms: Optional[float] = None):
        """submit(), but into the model's RETRIEVAL batcher. ``rows`` is a
        list of ``(query, k, probe)`` tuples (RetrievalEngine.topk_batch).
        Returns (entry, future); (None, None) means the name is unknown;
        (entry, None) means the model is deployed without a retrieval
        surface (the caller's 400). Swap-retry semantics match submit()."""
        for _ in range(self._SWAP_RETRIES):
            entry = self.get(name)
            if entry is None:
                return None, None
            if entry.retrieval_batcher is None:
                return entry, None
            try:
                return entry, entry.retrieval_batcher.submit(
                    rows, priority=priority, deadline_ms=deadline_ms)
            except BatcherClosed:  # graftcheck: disable=G031 (retry rebinds to the NEW batcher; waiting adds only latency)
                continue
        raise BatcherClosed(
            f"model {name!r}: {self._SWAP_RETRIES} consecutive version "
            f"swaps collided with this submit — retry")

    def health(self) -> dict:
        """Overload-aware health: ``degraded`` (still alive — shedding
        predictably) when any model's queue fills past
        ``degraded_depth_fraction``; device fields from torch."""
        with self._lock:
            entries = list(self._entries.values())
        models, worst = {}, 0.0
        for e in entries:
            st = e.batcher.overload_state()
            worst = max(worst, st["depth_fraction"])
            models[e.name] = {
                "depth_fraction": st["depth_fraction"],
                "depth_rows": st["depth_rows"],
                "controller": st["controller"],
                "shed": st["shed"], "expired": st["expired"],
                "quota_rejected": st["quota_rejected"],
            }
        info = {
            "status": "degraded" if worst >= self.degraded_depth_fraction
            else "ok",
            "degraded_depth_fraction": self.degraded_depth_fraction,
            "worst_depth_fraction": round(worst, 4),
            "models": models,
            "device": str(self.device),
        }
        dev = metrics_http.device_info()
        info["process_index"] = dev["process_index"]
        info["local_devices"] = dev["local_devices"]
        return info

    def undeploy(self, name: str) -> bool:
        with self._lock:
            entry = self._entries.pop(name, None)
            self._caches.pop(name, None)
        if entry is None:
            return False
        entry.close()
        return True

    def list_models(self):
        with self._lock:  # a first deploy of a new name mutates the dict
            entries = list(self._entries.values())
        return [e.describe() for e in entries]

    def shutdown(self) -> None:
        with self._lock:
            entries = list(self._entries.values())
            self._entries = {}
            self._caches = {}
        for e in entries:
            e.close()


class _ServingHandler(metrics_http._Handler):
    """Extends the metrics handler with /predict, /topk, /models and the
    overload-aware /healthz. The registry rides on the server object
    (see serve())."""

    # persistent connections: every response carries Content-Length, so
    # keep-alive is safe
    protocol_version = "HTTP/1.1"
    # the headers and the body leave in two writes; with Nagle on, the
    # body waits for the client's delayed ACK of the headers (~40 ms on
    # Linux) on every keep-alive response
    disable_nagle_algorithm = True

    predict_timeout = 30.0

    def _send_json(self, code: int, payload: dict, extra_headers=()) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        for k, v in extra_headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - http.server API
        path = self.path.split("?")[0]
        if path == "/models":
            self._send_json(200, {"models": self.server.registry.list_models()})
            return
        if path == "/healthz":
            # queue depth is the instantaneous signal; the SLO engine's
            # burn state is the over-time one — a paging objective
            # degrades health even while the queue looks shallow
            from ..runtime.slo import ENGINE

            info = self.server.registry.health()
            slo_block = ENGINE.health_block()
            info["slo"] = slo_block
            if slo_block["paging"]:
                info["status"] = "degraded"
            self._send_json(200, info)
            return
        super().do_GET()

    def _drain_body(self) -> None:
        """Read and discard the request body so the keep-alive connection
        stays in sync on paths that never parse it (the door 503, the
        POST 404)."""
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:  # garbage header: nothing trustworthy to drain
            length = 0
        self.rfile.read(length)

    def do_POST(self):  # noqa: N802 - http.server API
        route = self.path.split("?")[0]
        if route not in ("/predict", "/topk"):
            self._drain_body()
            self._send_json(404, {"error": "not found"})
            return
        # concurrency admission, at the door: past the in-flight limit the
        # request is refused BEFORE its body is parsed; the body is still
        # drained so the keep-alive connection stays usable
        sem = getattr(self.server, "inflight", None)
        held = None
        if sem is not None:
            if sem.acquire(blocking=False):
                held = sem
            else:
                # requests whose x-priority HEADER says "high" may still
                # enter through the reserved slots
                hdr = (self.headers.get("x-priority") or "").strip().lower()
                reserve = getattr(self.server, "inflight_reserve", None)
                if hdr in ("high", "0") and reserve is not None \
                        and reserve.acquire(blocking=False):
                    held = reserve
            if held is None:
                self._drain_body()
                self.server.concurrency_rejected.increment()
                self._send_json(503,
                                {"error": "too many in-flight requests",
                                 "reason": "concurrency"},
                                extra_headers=(("Retry-After", "1"),))
                return
        try:
            self._topk() if route == "/topk" else self._predict()
        finally:
            if held is not None:
                held.release()

    def _predict(self) -> None:
        # the request's ROOT span: HTTP parse, queue wait, batched device
        # dispatch and the response write all land under it; a client W3C
        # traceparent is adopted as the root's parent and echoed back
        remote = TRACER.parse_traceparent(self.headers.get("traceparent"))
        with TRACER.span("server.predict", remote=remote) as root:
            tp = TRACER.format_traceparent(root)
            tp_hdr = (("traceparent", tp),) if tp else ()
            with TRACER.span("server.parse"):
                close_hdr = ()
                try:
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                    except ValueError:
                        # body length unknowable: close the socket with the
                        # 400
                        close_hdr = (("Connection", "close"),)
                        raise
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    instances = payload["instances"]
                    if not isinstance(instances, list):
                        raise TypeError("instances must be a list")
                    # body keys win over the x-priority / x-deadline-ms
                    # headers
                    cls = priority_class(
                        payload.get("priority",
                                    self.headers.get("x-priority")
                                    or "normal"))
                    deadline_ms = payload.get(
                        "deadline_ms", self.headers.get("x-deadline-ms"))
                    if deadline_ms is not None:
                        deadline_ms = float(deadline_ms)
                        if not math.isfinite(deadline_ms) \
                                or deadline_ms <= 0:
                            raise ValueError(
                                f"deadline_ms must be a positive number, "
                                f"got {deadline_ms}")
                except (KeyError, TypeError, ValueError) as e:
                    self._send_json(400, {"error": f"bad request: {e}"},
                                    extra_headers=tp_hdr + close_hdr)
                    root.set(status=400)
                    return
            root.set(instances=len(instances),
                     model=payload.get("model") or "",
                     priority=priority_name(cls),
                     **({"deadline_ms": deadline_ms}
                        if deadline_ms is not None else {}))
            t0 = time.perf_counter()
            try:
                entry, future = self.server.registry.submit(
                    payload.get("model"), instances,
                    priority=cls, deadline_ms=deadline_ms)
                if entry is None:
                    self._send_json(404,
                                    {"error": f"unknown model "
                                              f"{payload.get('model')!r}"},
                                    extra_headers=tp_hdr)
                    root.set(status=404)
                    return
                preds = future.result(timeout=self.predict_timeout)
            except DeadlineExpired as e:
                # expired IN the queue: no dispatch slot was spent on it
                self._send_json(504, {"error": str(e),
                                      "reason": "deadline"},
                                extra_headers=tp_hdr)
                root.set(status=504)
                return
            except (QueueFull, BatcherClosed) as e:
                # quota refusal, low-priority shed, or a swap-collision
                # storm — all retryable; Retry-After is priced from the
                # live drain-rate estimate
                ra = getattr(e, "retry_after_s", None) or 1.0
                self._send_json(
                    503, {"error": str(e),
                          "reason": getattr(e, "reason", "busy")},
                    extra_headers=tp_hdr + (
                        ("Retry-After", str(int(math.ceil(ra)))),))
                root.set(status=503)
                return
            except Exception as e:  # scoring bug — surface, don't hang
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"},
                                extra_headers=tp_hdr)
                root.set(status=500)
                return
            dt = time.perf_counter() - t0
            self.server.latency.observe(
                dt, trace_id=TRACER.exemplar_id(root))
            self.server.latency_by_class[cls].observe(dt)
            root.set(status=200, version=entry.version)
            self._send_json(200, {
                "model": entry.name,
                "version": entry.version,
                "predictions": [_jsonable(p) for p in preds],
            }, extra_headers=tp_hdr)


    def _topk(self) -> None:
        # /predict's twin for the retrieval surface: same root-span /
        # traceparent / priority / deadline / error-mapping contract, but
        # the rows are (query, k, probe) tuples into the model's SEPARATE
        # retrieval batcher and the answer is a ranking per query
        remote = TRACER.parse_traceparent(self.headers.get("traceparent"))
        with TRACER.span("server.topk", remote=remote) as root:
            tp = TRACER.format_traceparent(root)
            tp_hdr = (("traceparent", tp),) if tp else ()
            with TRACER.span("server.parse"):
                close_hdr = ()
                try:
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                    except ValueError:
                        close_hdr = (("Connection", "close"),)
                        raise
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    queries = payload["queries"]
                    if not isinstance(queries, list):
                        raise TypeError("queries must be a list")
                    k = payload.get("k")
                    if k is not None:
                        k = int(k)
                        if k < 1:
                            raise ValueError(f"k must be >= 1, got {k}")
                    probe = payload.get("probe")
                    if probe is not None:
                        probe = bool(probe)
                    cls = priority_class(
                        payload.get("priority",
                                    self.headers.get("x-priority")
                                    or "normal"))
                    deadline_ms = payload.get(
                        "deadline_ms", self.headers.get("x-deadline-ms"))
                    if deadline_ms is not None:
                        deadline_ms = float(deadline_ms)
                        if not math.isfinite(deadline_ms) \
                                or deadline_ms <= 0:
                            raise ValueError(
                                f"deadline_ms must be a positive number, "
                                f"got {deadline_ms}")
                except (KeyError, TypeError, ValueError) as e:
                    self._send_json(400, {"error": f"bad request: {e}"},
                                    extra_headers=tp_hdr + close_hdr)
                    root.set(status=400)
                    return
            root.set(queries=len(queries),
                     model=payload.get("model") or "",
                     priority=priority_name(cls),
                     **({"k": k} if k is not None else {}),
                     **({"deadline_ms": deadline_ms}
                        if deadline_ms is not None else {}))
            t0 = time.perf_counter()
            try:
                rows = [(q, k, probe) for q in queries]
                entry, future = self.server.registry.submit_topk(
                    payload.get("model"), rows,
                    priority=cls, deadline_ms=deadline_ms)
                if entry is None:
                    self._send_json(404,
                                    {"error": f"unknown model "
                                              f"{payload.get('model')!r}"},
                                    extra_headers=tp_hdr)
                    root.set(status=404)
                    return
                if future is None:
                    # deployed, but deploy() stood up no retrieval surface
                    self._send_json(
                        400, {"error": f"model {entry.name!r} has no "
                                       f"retrieval surface (deploy with "
                                       f"retrieval= to enable /topk)"},
                        extra_headers=tp_hdr)
                    root.set(status=400)
                    return
                results = future.result(timeout=self.predict_timeout)
            except DeadlineExpired as e:
                self._send_json(504, {"error": str(e),
                                      "reason": "deadline"},
                                extra_headers=tp_hdr)
                root.set(status=504)
                return
            except (QueueFull, BatcherClosed) as e:
                ra = getattr(e, "retry_after_s", None) or 1.0
                self._send_json(
                    503, {"error": str(e),
                          "reason": getattr(e, "reason", "busy")},
                    extra_headers=tp_hdr + (
                        ("Retry-After", str(int(math.ceil(ra)))),))
                root.set(status=503)
                return
            except Exception as e:  # scoring bug — surface, don't hang
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"},
                                extra_headers=tp_hdr)
                root.set(status=500)
                return
            dt = time.perf_counter() - t0
            self.server.latency.observe(
                dt, trace_id=TRACER.exemplar_id(root))
            self.server.latency_by_class[cls].observe(dt)
            root.set(status=200, version=entry.version)
            self._send_json(200, {
                "model": entry.name,
                "version": entry.version,
                "k": k if k is not None else entry.retrieval_engine.k,
                "results": list(results),
            }, extra_headers=tp_hdr)


def _jsonable(p):
    if isinstance(p, (np.generic,)):
        return p.item()
    if isinstance(p, np.ndarray):
        return p.tolist()
    return p


def serve(registry: ModelRegistry, port: int = 0, host: str = "127.0.0.1",
          max_concurrent_requests: Optional[int] = None
          ) -> ThreadingHTTPServer:
    """Start the serving endpoint on a daemon thread (stdlib only);
    ``server.server_address[1]`` is the bound port. The same server
    answers /predict, /models, /metrics, /healthz, /trace, /slo and
    /debug/bundle, and scores on the registry's device (/topk too, for
    models deployed with ``retrieval=``). Stop it with ``server.shutdown()`` and
    ``server.server_close()``, then ``registry.shutdown()``.

    ``max_concurrent_requests`` bounds in-flight /predict handlers: past
    the limit requests get an immediate 503 (``reason: concurrency``)
    before their body is parsed; a quarter of the limit again is reserved
    for requests whose ``x-priority`` header says high. None (default)
    leaves it unbounded."""
    server = ThreadingHTTPServer((host, port), _ServingHandler)
    server.registry = registry
    server.latency = REGISTRY.histogram("serving.http.latency_seconds")
    # the per-priority-class split of the same histogram (indexed by the
    # admission class int)
    server.latency_by_class = tuple(
        REGISTRY.histogram(f"serving.http.latency_seconds.{p}")
        for p in PRIORITY_NAMES)
    if max_concurrent_requests is None:
        server.inflight = server.inflight_reserve = None
    else:
        n = int(max_concurrent_requests)
        server.inflight = threading.BoundedSemaphore(n)
        server.inflight_reserve = threading.BoundedSemaphore(
            max(2, n // 4))
    server.concurrency_rejected = REGISTRY.counter(
        "serving", "http.concurrency_rejected")
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="hivemall-tpu-serving")
    t.start()
    return server
