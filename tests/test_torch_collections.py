"""The port's collection substrate (hivemall_tpu_torch/utils/collections.py)
against the JAX package's copy, on one seeded script of operations per
structure: the same eviction order and byte costs, the same samples."""

import threading

import numpy as np
import pytest

from hivemall_tpu.utils import collections as J
from hivemall_tpu_torch.utils import collections as T


def _lru_script(mod, seed, capacity):
    """A mixed sequence of hits, peeks, inserts, replacements, deletes and
    explicit evictions; returns what the hook saw, the final order and the
    running byte cost the hook keeps."""
    rng = np.random.RandomState(seed)
    evicted, cost = [], [0]

    def on_evict(k, v):
        evicted.append((k, v))
        cost[0] -= len(k) + v

    m = mod.LRUMap(capacity, on_evict=on_evict)
    reads = []
    for step in range(600):
        key = f"k{int(rng.zipf(1.5)) % 40}"
        op = rng.randint(6)
        if op <= 1:
            v = int(rng.randint(1, 100))
            if key in m:
                cost[0] -= len(key) + _peek(m, key)
            m[key] = v
            cost[0] += len(key) + v
        elif op == 2 and key in m:
            reads.append(m[key])  # a hit: rotates to MRU
        elif op == 3:
            reads.append(m.get(key))  # the no-rotation peek
        elif op == 4 and step % 7 == 0:
            reads.append(m.evict_oldest())
        elif op == 5 and key in m and step % 5 == 0:
            cost[0] -= len(key) + _peek(m, key)
            del m[key]
    return evicted, list(m.items()), cost[0], reads


def _peek(m, key):
    return dict.get(m, key)


@pytest.mark.parametrize("seed,capacity", [(0, 8), (1, 3), (2, 1), (3, 0)])
def test_lru_map_eviction_order_and_costs_equal_jax(seed, capacity):
    got = _lru_script(T, seed, capacity)
    want = _lru_script(J, seed, capacity)
    assert got == want
    evicted, items, cost, _ = got
    assert cost == sum(len(k) + v for k, v in items)
    assert len(items) <= max(capacity, 0)
    if capacity:
        assert evicted


def test_lru_map_popitem_both_ends_equal_jax():
    out = {}
    for name, mod in (("jax", J), ("torch", T)):
        m = mod.LRUMap(4)
        m["a"], m["b"], m["c"] = 1, 2, 3
        _ = m["a"]
        seq = [m.popitem(), m.popitem(last=False)]
        with pytest.raises(KeyError):
            mod.LRUMap(2).popitem()
        out[name] = seq + list(m.items())
    assert out["torch"] == out["jax"] == [("a", 1), ("b", 2), ("c", 3)]


def test_synchronized_lru_map_concurrent_hammer():
    """Threads of mixed get/set never corrupt the map or exceed capacity."""
    m = T.SynchronizedLRUMap(32)
    errors = []

    def hammer(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(500):
                k = int(rng.randint(64))
                if rng.rand() < 0.5:
                    m[k] = k
                else:
                    assert m.get(k, k) == k
        except Exception as e:  # collected, asserted below
            errors.append(repr(e))

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(m) <= 32
    assert m.evict_oldest() is not None


@pytest.mark.parametrize("k,seed", [(3, 31), (10, 7), (1, 0)])
def test_reservoir_sampler_equals_jax(k, seed):
    rng = np.random.RandomState(seed + 100)
    stream = rng.randint(0, 10 ** 6, size=500).tolist()
    samples = []
    for mod in (J, T):
        rs = mod.ReservoirSampler(k, seed=seed)
        for x in stream:
            rs.add(x)
        samples.append(rs.samples)
    assert samples[0] == samples[1]
    assert len(samples[1]) == k


def test_bounded_priority_queue_indexed_set_sparse_array_equal_jax():
    rng = np.random.RandomState(5)
    prios = rng.randint(0, 20, size=60).tolist()
    words = [f"w{int(x)}" for x in rng.randint(0, 15, size=40)]
    cells = rng.randint(0, 30, size=(50, 2)).tolist()
    out = []
    for mod in (J, T):
        q = mod.BoundedPriorityQueue(5)
        offered = [q.offer(p, f"v{i}") for i, p in enumerate(prios)]
        s = mod.IndexedSet()
        ids = [s.add(w) for w in words]
        a = mod.SparseIntArray()
        for i, v in cells:
            a.increment(i, v)
        a.put(3, 77)
        out.append((offered, q.drain_descending(), ids, list(s),
                    s.index_of("w99"), a.get(3), a.to_dense().tolist(),
                    a.to_dense(10).tolist(), dict(mod.OpenHashMap(x=1))))
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        T.BoundedPriorityQueue(0)
