"""Hot-row score cache + in-flight coalescing — the serving L0 fast path.
The port of the JAX package's `serving/cache.py`: host Python, the same
keys, counters, lock discipline and outcomes.

Production scoring traffic from millions of users is Zipfian: the same hot
rows arrive over and over (PAPERS.md ads-infra paper; "Randomized Hashing"
shows hashed-feature mass concentrates on few buckets). This module makes
repetition cheap, in front of the batcher:

- **score cache**: a per-model, byte-bounded LRU keyed by
  ``(model_version, row_key)`` over the canonical pre-parsed row form
  (serving/engine.py ``row_keys``), valued with the engine's own finalized
  per-row prediction. A request whose rows are ALL cached resolves its
  Future immediately — no queue capacity, no class quota, no batch slot
  (effective goodput rises under the overload machinery instead of
  fighting it). The staleness contract is *version-exact*: the version is
  in the key, so a hot-swap invalidates atomically for free and the old
  version's entries simply age out of the byte budget.
- **in-flight coalescing**: identical rows already queued share ONE
  computation. The first request carrying a new row key becomes that key's
  *leader*; a later request covered entirely by cache entries + in-flight
  leaders becomes a *follower* — it attaches to the leaders' Futures
  instead of enqueueing. The leader populates the cache on completion and
  resolves every follower; a leader whose dispatch FAILS (shed,
  deadline-expired, engine error, swap-drop) fails its followers with the
  same reason and populates nothing. Followers deliberately inherit the
  leader's FATE wholesale — its priority class's queue position, its
  effective deadline, its failure mode — not their own parameters: a
  follower consumed no admission resources, so the only honest answer it
  can carry is the shared computation's. Callers for whom that trade is
  wrong (a high-priority request that must not ride a low leader's
  outcome) should serve cache-off. Leadership registers only AFTER
  admission succeeds (``lead()``), so an admission-refused request never
  had followers — refusals stay synchronous where the registry's
  swap-retry can see them.
- a request with ANY uncovered row flows into the batcher unchanged (it
  computes every row itself, leading its new keys) — partial requests are
  never split, so batch assembly, ordering and admission semantics stay
  exactly the batcher's.
- **negative caching**: a leader whose ADMISSION is refused (quota shed)
  leaves a short-TTL negative entry per new key (``note_refusal``). A hot
  row hammering an overloaded server is then answered with the same
  refusal straight from the cache front (plan kind "refused") instead of
  re-entering — and re-losing — admission on every request, so the
  admission lock and shed scan stop burning CPU on traffic that cannot be
  served anyway. The TTL is deliberately tiny (default 50 ms — the same
  order as a batch dispatch): capacity recovers the moment the queue
  drains, and a successful computation or hot-swap clears the verdict
  early. Counters ``cache.negative.{stored,hit}`` on /metrics.

Substrate: `utils.collections.LRUMap` with the byte-cost eviction hook.
The cache deliberately wraps a PLAIN LRUMap under its own lock rather than
using `SynchronizedLRUMap`: lookup, insert, byte accounting, the inflight
table, and the hit/miss counters must commit atomically per request — a
per-op synchronized map would leave check-then-act windows between them.

Lock discipline: every mutable field is guarded by ``_lock``; Future
``set_result``/``set_exception`` ALWAYS run after release (done-callbacks
execute synchronously on the calling thread, and arbitrary callback code
must never run under the lock). The batcher calls ``admit`` before taking
``_cv`` and ``settle`` outside it, so the cache lock and the batcher CV
are never nested in either order.

Observability: per-model counters ``serving.<name>.cache.{hit,miss,
coalesced,evicted}`` (row granularity; hit ratio = hit / (hit + miss),
coalesced rows are neither — they share a leader's computation) plus
``serving.<name>.cache.resident_bytes`` / ``.entries`` gauges on
/metrics, a stats block on /models (server.py), and ``cache.hit`` /
``cache.coalesced`` instant events inside the request span (batcher.py).
"""

from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import Dict, List, Optional, Sequence, Tuple

from ..runtime.metrics import REGISTRY
from ..utils.collections import LRUMap

# Estimated host bytes one cache entry holds beyond key/value payload:
# the OrderedDict node + tuple key + float boxing. An order-of-magnitude
# budget honesty constant, not an exact allocator measurement — the byte
# budget bounds resident memory, it does not meter it to the byte.
ENTRY_OVERHEAD_BYTES = 120


def _entry_cost(key: Tuple[str, bytes], value) -> int:
    version, digest = key
    try:
        value_bytes = sys.getsizeof(value)
    except TypeError:  # exotic prediction object without a size: estimate
        value_bytes = 64
    return ENTRY_OVERHEAD_BYTES + len(version) + len(digest) + value_bytes


class _Follower:
    """One coalesced request: its Future resolves when every leader it
    depends on completes. ``values`` is prefilled with the cache hits
    captured at admission (so a later eviction or hot-swap cannot change
    an already-admitted request's answer); ``settled`` flips under the
    cache lock exactly once — the loser of a two-leader race (one fails,
    one completes) sees it and leaves the Future alone."""

    __slots__ = ("future", "values", "remaining", "settled")

    def __init__(self, future: Future, values: list, remaining: int) -> None:
        self.future = future
        self.values = values
        self.remaining = remaining
        self.settled = False


class _Inflight:
    """One in-flight row key: the followers waiting on it, each with the
    slot positions the key fills in that follower's request."""

    __slots__ = ("followers",)

    def __init__(self) -> None:
        self.followers: List[Tuple[_Follower, List[int]]] = []


class LeadToken:
    """Returned by ``admit`` for a request that must compute: the caller
    enqueues it unchanged, registers it with ``lead()`` once admission
    SUCCEEDS, and hands its Future's outcome back through ``settle``. A
    refused admission simply never registers — nothing to clean up."""

    __slots__ = ("version", "keys", "led")

    def __init__(self, version: str, keys: Sequence[bytes],
                 led: List[bytes]) -> None:
        self.version = version
        self.keys = list(keys)
        self.led = led  # the subset of keys this request computes FIRST


class CachePlan:
    """The admission decision: ``kind`` is "hit" (``values`` ready — the
    caller resolves the Future itself, outside any lock), "coalesced"
    (the cache owns the Future's resolution), "lead" (``token`` must
    be settled when the computed Future completes), or "refused" (a row
    key sits in the negative cache from a recent admission refusal —
    ``error`` carries that refusal; the caller raises it synchronously
    WITHOUT re-entering admission)."""

    __slots__ = ("kind", "values", "token", "hit_rows", "coalesced_rows",
                 "error")

    def __init__(self, kind: str, values=None, token=None,
                 hit_rows: int = 0, coalesced_rows: int = 0,
                 error: Optional[BaseException] = None) -> None:
        self.kind = kind
        self.values = values
        self.token = token
        self.hit_rows = hit_rows
        self.coalesced_rows = coalesced_rows
        self.error = error


class ScoreCache:
    """Byte-bounded, version-keyed score cache + in-flight coalescing
    table for one model NAME (shared across its versions — the point:
    swap invalidation is a key change, not a flush)."""

    def __init__(self, max_bytes: int, *, name: str = "default",
                 negative_ttl_s: float = 0.050) -> None:
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self.name = name
        self.negative_ttl_s = float(negative_ttl_s)
        self._lock = threading.Lock()
        # entry count is unbounded by design — the byte budget is the
        # bound; the hook keeps resident accounting exact on both the
        # capacity path (never taken) and the explicit budget evictions
        self._map: LRUMap = LRUMap(1 << 62, on_evict=self._on_evict_locked)
        self._inflight: Dict[Tuple[str, bytes], _Inflight] = {}
        # negative cache: key -> (monotonic expiry, the refusal error) —
        # a shed/quota-refused leader key stops re-entering admission for
        # negative_ttl_s (note_refusal / the "refused" plan kind)
        self._negative: Dict[Tuple[str, bytes],
                             Tuple[float, BaseException]] = {}
        self._resident = 0
        self._hit = REGISTRY.counter("serving", f"{name}.cache.hit")
        self._miss = REGISTRY.counter("serving", f"{name}.cache.miss")
        self._coalesced = REGISTRY.counter("serving",
                                           f"{name}.cache.coalesced")
        self._evicted = REGISTRY.counter("serving", f"{name}.cache.evicted")
        self._neg_stored = REGISTRY.counter(
            "serving", f"{name}.cache.negative.stored")
        self._neg_hit = REGISTRY.counter(
            "serving", f"{name}.cache.negative.hit")
        self._g_bytes = f"serving.{name}.cache.resident_bytes"
        self._g_entries = f"serving.{name}.cache.entries"

    # -- admission (called by DynamicBatcher.submit BEFORE its CV) ----------

    def admit(self, version: str, keys: Sequence[bytes],
              future: Future) -> CachePlan:
        """One atomic decision for a request whose per-row ``keys`` are
        known. Classification per row: cached / in-flight / new. Any new
        key -> "lead" (the whole request computes, unchanged; the caller
        registers the token with ``lead()`` ONLY after admission
        succeeds). No new keys + any in-flight -> "coalesced" (the cache
        resolves ``future`` when the leaders complete). All cached ->
        "hit" (``plan.values`` ready; caller resolves)."""
        n = len(keys)
        with self._lock:
            fulls = [(version, k) for k in keys]
            if self._negative:
                refusal = self._negative_hit_locked(fulls)
                if refusal is not None:
                    self._neg_hit.increment()
                    return CachePlan("refused", error=refusal)
            # classify with the no-rotation peek (dict.get): rows are only
            # promoted to MRU when actually SERVED from the cache below
            cached = [self._map.get(f) is not None or f in self._map
                      for f in fulls]
            new: List[bytes] = []
            seen = set()
            for f, c in zip(fulls, cached):
                if not c and f not in self._inflight and f not in seen:
                    seen.add(f)
                    new.append(f[1])
            if new:
                # miss rows are counted in lead(), i.e. only for requests
                # the batcher actually ADMITS — a quota/closed refusal (or
                # its swap retry) computes nothing and must not depress
                # the gated hit ratio
                return CachePlan("lead",
                                 token=LeadToken(version, keys, list(new)))
            values = [None] * n
            pending: Dict[Tuple[str, bytes], List[int]] = {}
            hits = 0
            for i, (f, c) in enumerate(zip(fulls, cached)):
                if c:
                    values[i] = self._map[f]  # serve: rotates to MRU
                    hits += 1
                else:
                    pending.setdefault(f, []).append(i)
            self._hit.increment(hits)
            if not pending:
                return CachePlan("hit", values=values, hit_rows=n)
            coal = n - hits
            self._coalesced.increment(coal)
            fol = _Follower(future, values, remaining=len(pending))
            for f, slots in pending.items():
                self._inflight[f].followers.append((fol, slots))
            return CachePlan("coalesced", hit_rows=hits, coalesced_rows=coal)

    def _negative_hit_locked(self, fulls) -> Optional[BaseException]:
        """The stored refusal when any requested key is negatively cached
        and unexpired; expired entries encountered on the way are dropped
        (the lazy half of expiry — note_refusal sweeps the rest)."""
        now = time.monotonic()
        for f in fulls:
            rec = self._negative.get(f)
            if rec is None:
                continue
            if rec[0] > now:
                return rec[1]
            del self._negative[f]
        return None

    def note_refusal(self, token: LeadToken, exc: BaseException) -> None:
        """Admission REFUSED this leader (quota shed). Its new keys enter
        short-TTL negative entries, so a hot row hammering an overloaded
        server is answered with the SAME refusal from the cache front for
        ``negative_ttl_s`` instead of re-entering admission (and losing
        the quota race again) on every request. Version is in the key, so
        a hot-swap clears a row's negative verdict atomically; a
        successful computation of the key (some twin leader admitted
        meanwhile) clears it too."""
        if self.negative_ttl_s <= 0 or not token.led:
            return
        expiry = time.monotonic() + self.negative_ttl_s
        with self._lock:
            if len(self._negative) > 4096:  # sweep: bound stale entries
                now = time.monotonic()
                self._negative = {f: r for f, r in self._negative.items()
                                  if r[0] > now}
            for k in token.led:
                full = (token.version, k)
                if full not in self._negative:
                    self._neg_stored.increment()
                self._negative[full] = (expiry, exc)

    def lead(self, token: LeadToken) -> None:
        """Register the token's new keys as in-flight — called by the
        batcher AFTER the leader is successfully admitted, so a follower
        can only ever attach to a leader that is actually QUEUED. An
        admission-refused leader (quota / closed batcher) therefore never
        had followers to strand: its refusal raises synchronously where
        the registry's swap-retry loop can see it, and no other request's
        Future fails asynchronously with an admission error it could have
        retried. The cost of deferring registration is a tiny window
        where an identical concurrent request classifies as a second
        leader and computes a duplicate — bit-identical scores, never a
        failure; keys a racing twin registered first (or that got cached
        meanwhile) drop out of this token's led set, and the twin's
        completion settles those followers."""
        with self._lock:
            # every row of an admitted lead request is computed, cached
            # or not — that is what the miss counter means (hit ratio =
            # served-from-cache / looked-up-by-admitted-requests)
            self._miss.increment(len(token.keys))
            led = []
            for k in token.led:
                full = (token.version, k)
                if full not in self._inflight and full not in self._map:
                    self._inflight[full] = _Inflight()
                    led.append(k)
            token.led = led

    # -- completion (leader Future done-callback, outside the batcher CV) ---

    def settle(self, token: LeadToken, future: Future) -> None:
        """The leader's Future completed. Success populates the cache for
        EVERY row of the leader (led keys and refreshes alike) and
        resolves followers; failure fails followers with the SAME reason
        and populates nothing."""
        if future.cancelled():
            self._fail(token, CancelledError("leader request cancelled"))
            return
        exc = future.exception()
        if exc is not None:
            self._fail(token, exc)
            return
        preds = future.result()
        ready: List[_Follower] = []
        with self._lock:
            by_key: Dict[Tuple[str, bytes], object] = {}
            for k, v in zip(token.keys, preds):
                full = (token.version, k)
                if full not in by_key:
                    by_key[full] = v
                self._put_locked(full, v)
            for k in token.led:
                rec = self._inflight.pop((token.version, k), None)
                if rec is None:
                    continue
                v = by_key.get((token.version, k))
                for fol, slots in rec.followers:
                    if fol.settled:
                        continue
                    for s in slots:
                        fol.values[s] = v
                    fol.remaining -= 1
                    if fol.remaining == 0:
                        fol.settled = True
                        ready.append(fol)
            self._export_gauges_locked()
        # outside the lock: set_result runs done-callbacks synchronously
        # (arbitrary callback code must never run under _lock)
        for fol in ready:
            if not fol.future.cancelled():
                fol.future.set_result(fol.values)

    def _fail(self, token: LeadToken, exc: BaseException) -> None:
        failed: List[_Follower] = []
        with self._lock:
            for k in token.led:
                rec = self._inflight.pop((token.version, k), None)
                if rec is None:
                    continue
                for fol, _slots in rec.followers:
                    if not fol.settled:
                        fol.settled = True
                        failed.append(fol)
        for fol in failed:  # outside the lock
            if not fol.future.cancelled():
                fol.future.set_exception(exc)

    # -- map + accounting (all under _lock) ---------------------------------

    def _on_evict_locked(self, key, value) -> None:
        # fires ONLY through _map.evict_oldest(), whose every call site
        # (_put_locked's budget loop, clear) holds _lock
        self._resident -= _entry_cost(key, value)
        self._evicted.increment()

    def _put_locked(self, full: Tuple[str, bytes], value) -> None:
        # a key that just computed successfully is admittable again —
        # its negative verdict (if any) is stale by proof
        self._negative.pop(full, None)
        old = self._map.get(full)
        if old is not None or full in self._map:
            self._resident -= _entry_cost(full, old)
        self._map[full] = value
        self._resident += _entry_cost(full, value)
        while self._resident > self.max_bytes and len(self._map):
            self._map.evict_oldest()

    def _export_gauges_locked(self) -> None:
        REGISTRY.set_gauge(self._g_bytes, float(self._resident))
        REGISTRY.set_gauge(self._g_entries, float(len(self._map)))

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """One consistent snapshot — the /models "cache" block."""
        with self._lock:
            entries = len(self._map)
            resident = self._resident
            inflight = len(self._inflight)
            negative = len(self._negative)
            hit, miss = self._hit.value, self._miss.value
            coalesced, evicted = self._coalesced.value, self._evicted.value
            neg_stored = self._neg_stored.value
            neg_hit = self._neg_hit.value
        looked = hit + miss
        return {
            "enabled": True,
            "budget_bytes": self.max_bytes,
            "resident_bytes": resident,
            "entries": entries,
            "inflight_keys": inflight,
            "hit_rows": hit,
            "miss_rows": miss,
            "coalesced_rows": coalesced,
            "evicted_entries": evicted,
            "hit_ratio": round(hit / looked, 4) if looked else 0.0,
            "negative_ttl_s": self.negative_ttl_s,
            "negative_keys": negative,
            "negative_stored": neg_stored,
            "negative_hits": neg_hit,
        }

    def clear(self) -> None:
        """Drop every cached entry (tests / operator reset). In-flight
        leadership is untouched — leaders still settle their followers."""
        with self._lock:
            while len(self._map):
                self._map.evict_oldest()
            self._negative.clear()
            self._export_gauges_locked()
