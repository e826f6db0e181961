"""Host-side collection substrate — the port's copy of the JAX package's
`utils/collections.py`, statement for statement.

The reference ships ~4k LoC of hand-written open-addressing maps and helper
structures (ref: SURVEY.md §2.17: OpenHashMap, Int2FloatOpenHashTable,
BoundedPriorityQueue, LRUMap, IndexedSet, SparseIntArray...). On the device
the *hot* lookups became feature-hashed dense arrays + segment ops; what
remains host-side maps to Python/numpy. These classes keep the same API
surface for the places that still want them (top-k, vocab interning, and
the serving score cache, serving/cache.py).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Generic, Iterator, List, \
    Optional, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


class BoundedPriorityQueue(Generic[T]):
    """Keep the k largest items (ref: utils/collections/BoundedPriorityQueue.java,
    used by each_top_k, tools/EachTopKUDTF.java:48-57)."""

    def __init__(self, k: int):
        if k <= 0:
            raise ValueError("k must be positive")
        self.k = k
        self._heap: List = []
        self._counter = itertools.count()

    def offer(self, priority: float, item: T = None) -> bool:
        entry = (priority, next(self._counter), item)
        if len(self._heap) < self.k:
            heapq.heappush(self._heap, entry)
            return True
        if entry[0] > self._heap[0][0]:
            heapq.heappushpop(self._heap, entry)
            return True
        return False

    def drain_descending(self) -> List:
        out = sorted(self._heap, key=lambda e: (e[0], e[1]), reverse=True)
        self._heap = []
        return [(p, item) for p, _, item in out]

    def __len__(self) -> int:
        return len(self._heap)


class LRUMap(OrderedDict):
    """Fixed-capacity LRU (ref: utils/collections/LRUMap.java).

    ``on_evict(key, value)`` is the cost-aware eviction hook: it fires for
    every entry the map drops to stay within ``capacity`` (and from
    explicit ``evict_oldest()`` calls), AFTER the entry is removed — a
    byte-budgeted wrapper (serving/cache.py) keeps its resident-cost
    accounting exact by decrementing in the hook, so capacity eviction and
    budget eviction share one accounting path. ``capacity <= 0`` is the
    degenerate "holds nothing" map: every insert is immediately evicted
    through the hook (a cache configured with a zero budget stays
    consistent instead of raising from an empty-iterator pop).

    NOT thread-safe: reads rotate the recency list, so even ``m[k]`` is a
    write (``dict.get`` stays a C-level peek and does NOT rotate — the
    documented escape hatch for lock-free inspection). Share across
    threads via `SynchronizedLRUMap`, or hold your own lock when map ops
    must be atomic with surrounding accounting (what serving/cache.py
    does).
    """

    def __init__(self, capacity: int,
                 on_evict: Optional[Callable[[Any, Any], None]] = None):
        super().__init__()
        self.capacity = capacity
        self.on_evict = on_evict

    def evict_oldest(self) -> Optional[Tuple[Any, Any]]:
        """Drop the least-recently-used entry, firing ``on_evict``;
        returns the ``(key, value)`` pair or None when empty. The value
        read bypasses the overridden ``__getitem__`` so eviction never
        rotates recency (and never trips the popitem re-entrancy below)."""
        if not self:
            return None
        oldest = next(iter(self))
        value = OrderedDict.__getitem__(self, oldest)
        super().__delitem__(oldest)
        if self.on_evict is not None:
            self.on_evict(oldest, value)
        return oldest, value

    def __setitem__(self, key, value):
        if key in self:
            # replacement: remove silently (no on_evict — the entry is not
            # leaving the map, it is being refreshed) then re-insert at MRU
            super().__delitem__(key)
        elif len(self) >= self.capacity:
            # not popitem(): the C implementation re-enters the overridden
            # __getitem__ after unlinking the node, and its move_to_end
            # then KeyErrors on the half-removed key
            self.evict_oldest()
        super().__setitem__(key, value)
        if self.capacity <= 0:
            self.evict_oldest()

    def __getitem__(self, key):
        value = super().__getitem__(key)
        self.move_to_end(key)
        return value

    def popitem(self, last: bool = True):
        # the C implementation re-enters the overridden __getitem__ after
        # unlinking the node, and its move_to_end then KeyErrors on the
        # half-removed key — pop through the non-rotating reads instead
        if not self:
            raise KeyError("popitem(): map is empty")
        key = next(reversed(self)) if last else next(iter(self))
        value = OrderedDict.__getitem__(self, key)
        super().__delitem__(key)
        return key, value


class SynchronizedLRUMap(LRUMap):
    """Thread-guarded LRUMap: item access, insertion, deletion, get/pop/
    popitem/setdefault/update/clear and eviction — reads included, since
    a hit rotates the recency order — run under one RLock (reentrant:
    ``__setitem__`` calls ``evict_oldest`` with the lock already held).
    Iteration and the keys/values/items views are NOT guarded: snapshot
    under your own coordination if the map is being mutated concurrently.

    This makes individual map operations safe to share across threads; it
    does NOT make compound check-then-act sequences atomic. A caller whose
    lookup, insert and side accounting must commit together (the serving
    score cache's byte budget + hit counters) still needs its own outer
    lock around a plain `LRUMap`.
    """

    def __init__(self, capacity: int,
                 on_evict: Optional[Callable[[Any, Any], None]] = None):
        super().__init__(capacity, on_evict)
        self._lock = threading.RLock()

    def evict_oldest(self):
        with self._lock:
            return super().evict_oldest()

    def __setitem__(self, key, value):
        with self._lock:
            super().__setitem__(key, value)

    def __getitem__(self, key):
        with self._lock:
            return super().__getitem__(key)

    def __delitem__(self, key):
        with self._lock:
            super().__delitem__(key)

    def __contains__(self, key):
        with self._lock:
            return super().__contains__(key)

    def __len__(self):
        with self._lock:
            return super().__len__()

    def get(self, key, default=None):
        with self._lock:
            return super().get(key, default)

    def pop(self, key, *default):
        with self._lock:
            return super().pop(key, *default)

    def popitem(self, last: bool = True):
        with self._lock:
            return super().popitem(last)

    def setdefault(self, key, default=None):
        with self._lock:
            return super().setdefault(key, default)

    def update(self, *args, **kwargs):
        with self._lock:
            super().update(*args, **kwargs)

    def clear(self):
        with self._lock:
            super().clear()


class IndexedSet(Generic[T]):
    """Intern values to dense int ids (ref: utils/collections/IndexedSet.java) —
    the string-vocabulary front end of the hashed feature space."""

    def __init__(self) -> None:
        self._map: Dict[T, int] = {}
        self._items: List[T] = []

    def add(self, item: T) -> int:
        idx = self._map.get(item)
        if idx is None:
            idx = len(self._items)
            self._map[item] = idx
            self._items.append(item)
        return idx

    def index_of(self, item: T) -> int:
        return self._map.get(item, -1)

    def get(self, idx: int) -> T:
        return self._items[idx]

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[T]:
        return iter(self._items)


class OpenHashMap(dict):
    """API-parity alias: Python dicts are already open-addressed hash maps
    (ref: utils/collections/OpenHashMap.java)."""


class SparseIntArray:
    """Sparse int->int array with dense export
    (ref: utils/collections/SparseIntArray.java)."""

    def __init__(self) -> None:
        self._map: Dict[int, int] = {}

    def put(self, idx: int, value: int) -> None:
        self._map[idx] = value

    def get(self, idx: int, default: int = 0) -> int:
        return self._map.get(idx, default)

    def increment(self, idx: int, by: int = 1) -> None:
        self._map[idx] = self._map.get(idx, 0) + by

    def to_dense(self, size: Optional[int] = None) -> np.ndarray:
        n = size if size is not None else (max(self._map) + 1 if self._map else 0)
        out = np.zeros(n, dtype=np.int64)
        for k, v in self._map.items():
            if k < n:
                out[k] = v
        return out


class ReservoirSampler(Generic[T]):
    """Uniform k-sample over a stream (ref: common/ReservoirSampler.java:32)."""

    def __init__(self, k: int, seed: int = 31):
        self.k = k
        self._rng = np.random.RandomState(seed)
        self._samples: List[T] = []
        self._seen = 0

    def add(self, item: T) -> None:
        self._seen += 1
        if len(self._samples) < self.k:
            self._samples.append(item)
        else:
            j = self._rng.randint(0, self._seen)
            if j < self.k:
                self._samples[j] = item

    @property
    def samples(self) -> List[T]:
        return list(self._samples)
