"""Map UDFs (ref: hivemall/tools/map/*.java)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, Tuple


def map_get_sum(m: Dict, keys: Iterable) -> float:
    """Sum of values at keys (missing -> 0) (ref: tools/map/MapGetSumUDF.java)."""
    return float(sum(float(m.get(k, 0.0)) for k in keys))


def map_tail_n(m: Dict, n: int) -> Dict:
    """Last N entries by key order (ref: tools/map/MapTailNUDF.java)."""
    items = sorted(m.items(), key=lambda kv: kv[0])
    return dict(items[-n:])


def to_map(kv_pairs: Iterable[Tuple]) -> Dict:
    """Group rows (key, value) -> map (ref: tools/map/UDAFToMap.java)."""
    out: Dict = {}
    for k, v in kv_pairs:
        if k is not None:
            out[k] = v
    return out


def to_ordered_map(kv_pairs: Iterable[Tuple], reverse: bool = False) -> "OrderedDict":
    """Group rows -> key-ordered map (ref: tools/map/UDAFToOrderedMap.java)."""
    out = to_map(kv_pairs)
    return OrderedDict(sorted(out.items(), key=lambda kv: kv[0], reverse=reverse))
