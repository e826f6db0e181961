"""Row amplification — the reference's substitute for multi-epoch training
(ref: ftvec/amplify/{AmplifierUDTF,RandomAmplifierUDTF}.java,
common/RandomizedAmplifier.java:27-120). A numpy copy of
`hivemall_tpu/ftvec/amplify.py`: the same seed gives the same order."""

from __future__ import annotations

from typing import Iterable, Iterator, List, Sequence, TypeVar

import numpy as np

T = TypeVar("T")


def amplify(xtimes: int, rows: Iterable[T]) -> Iterator[T]:
    """`amplify(xtimes, *)` — emit each row xtimes (ref: AmplifierUDTF.java:35-70)."""
    if xtimes < 1:
        raise ValueError(f"Illegal xtimes value: {xtimes}")
    for row in rows:
        for _ in range(xtimes):
            yield row


def rand_amplify(xtimes: int, num_buffers: int, rows: Iterable[T],
                 seed: int = 31) -> Iterator[T]:
    """`rand_amplify(xtimes, num_buffers, *)` — duplicate each row xtimes and
    shuffle through N reservoir buffers, emitting one random victim per insert
    once buffers fill (ref: RandomizedAmplifier.java:27-120; seed from jobconf
    `hivemall.amplify.seed`, RandomAmplifierUDTF.java:43-66)."""
    if xtimes < 1:
        raise ValueError(f"Illegal xtimes value: {xtimes}")
    rng = np.random.RandomState(seed)
    buffers: List[List[T]] = [[] for _ in range(max(1, num_buffers))]
    capacity = 1024
    for row in rows:
        for _ in range(xtimes):
            b = buffers[rng.randint(len(buffers))]
            if len(b) >= capacity:
                victim = rng.randint(len(b))
                yield b[victim]
                b[victim] = row
            else:
                b.append(row)
    for b in buffers:
        order = rng.permutation(len(b))
        for i in order:
            yield b[i]
