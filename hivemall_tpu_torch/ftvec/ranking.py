"""Ranking samplers (ref: ftvec/ranking/*.java)."""

from __future__ import annotations

from typing import Dict, Iterator, Sequence, Set, Tuple

import numpy as np


def bpr_sampling(user_items: Dict[int, Sequence[int]], max_item_id: int,
                 sampling_rate: float = 1.0, with_replacement: bool = True,
                 seed: int = 31) -> Iterator[Tuple[int, int, int]]:
    """Emit (user, pos_item, neg_item) BPR triples: for each user's positive
    item, sample a negative item uniformly from items the user has NOT
    interacted with (ref: ftvec/ranking/BprSamplingUDTF.java:51-205).
    `sampling_rate` scales how many triples per positive; without replacement
    each negative is used at most once per user."""
    rng = np.random.RandomState(seed)
    for u, items in user_items.items():
        pos = list(items)
        pos_set = set(pos)
        if len(pos_set) >= max_item_id + 1:
            continue  # no negatives exist
        n_samples = max(1, int(round(len(pos) * sampling_rate)))
        used: Set[int] = set()
        for _ in range(n_samples):
            i = pos[rng.randint(len(pos))]
            j = int(rng.randint(max_item_id + 1))
            tries = 0
            while j in pos_set or (not with_replacement and j in used):
                j = int(rng.randint(max_item_id + 1))
                tries += 1
                if tries > 100 * (max_item_id + 1):
                    break
            else:
                if not with_replacement:
                    used.add(j)
                yield u, i, j


def item_pairs_sampling(pos_items: Sequence[int], max_item_id: int,
                        sampling_rate: float = 1.0,
                        seed: int = 31) -> Iterator[Tuple[int, int]]:
    """Emit (pos_item, neg_item) pairs (ref: ftvec/ranking/ItemPairsSamplingUDTF.java)."""
    rng = np.random.RandomState(seed)
    pos_set = set(int(i) for i in pos_items)
    if len(pos_set) >= max_item_id + 1:
        return
    n = max(1, int(round(len(pos_items) * sampling_rate)))
    for _ in range(n):
        i = int(pos_items[rng.randint(len(pos_items))])
        j = int(rng.randint(max_item_id + 1))
        while j in pos_set:
            j = int(rng.randint(max_item_id + 1))
        yield i, j


def populate_not_in(items: Sequence[int], max_item_id: int) -> Iterator[int]:
    """Emit every item id in [0, max_item_id] not in `items`
    (ref: ftvec/ranking/PopulateNotInUDTF.java)."""
    have = set(int(i) for i in items)
    for j in range(max_item_id + 1):
        if j not in have:
            yield j
